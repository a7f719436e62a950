"""Rank-aware logging utilities.

Copy of ``deepspeed_tpu/utils/logging.py`` for the port: the rank comes
from ``torch.distributed`` when it is initialized, else from ``RANK``;
the level from ``DS_TPU_LOG_LEVEL``, as in the JAX package."""

import functools
import logging
import os
import sys

log_levels = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "critical": logging.CRITICAL,
}


class LoggerFactory:

    @staticmethod
    def create_logger(name=None, level=logging.INFO):
        if name is None:
            raise ValueError("name for logger cannot be None")
        formatter = logging.Formatter(
            "[%(asctime)s] [%(levelname)s] [%(filename)s:%(lineno)d:%(funcName)s] %(message)s")
        logger_ = logging.getLogger(name)
        logger_.setLevel(level)
        logger_.propagate = False
        if not logger_.handlers:
            ch = logging.StreamHandler(stream=sys.stdout)
            ch.setLevel(level)
            ch.setFormatter(formatter)
            logger_.addHandler(ch)
        return logger_


logger = LoggerFactory.create_logger(
    name="DeepSpeedTorch",
    level=log_levels.get(os.environ.get("DS_TPU_LOG_LEVEL", ""), logging.INFO))


@functools.lru_cache(None)
def warning_once(*args, **kwargs):
    logger.warning(*args, **kwargs)


logger.warning_once = warning_once


def _get_rank():
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("RANK", 0))


def log_dist(message, ranks=None, level=logging.INFO):
    """Log ``message`` only on the listed ranks (``None``/``[-1]`` = all)."""
    rank = _get_rank()
    if ranks is None or -1 in ranks or rank in ranks:
        logger.log(level, f"[Rank {rank}] {message}")


def print_rank_0(message, debug=False, force=False):
    if _get_rank() == 0 and (debug or force):
        logger.info(message)


def should_log_le(max_log_level_str):
    if not isinstance(max_log_level_str, str):
        raise ValueError("max_log_level_str must be a string")
    max_log_level_str = max_log_level_str.lower()
    if max_log_level_str not in log_levels:
        raise ValueError(f"{max_log_level_str} is not one of the `logging` levels")
    return logger.getEffectiveLevel() <= log_levels[max_log_level_str]
