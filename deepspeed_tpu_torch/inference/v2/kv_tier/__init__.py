"""Tiered KV cache: host-RAM spill tier for the radix prefix cache.

Port of ``deepspeed_tpu/inference/v2/kv_tier``. The device block pool is
tier-1, and blocks the prefix cache evicts under pressure DEMOTE into a
much larger host-RAM tier-2 (:class:`HostKVStore`) instead of being
dropped. A later prompt whose trie match continues into demoted chains
PROMOTES them back into the pool, and prefill starts after the restored
span. Storage is the pool dtype by default (bit-identical restore) and
int8 per-(layer, block)-grouped with ``quantize=True`` (kernel K7 on the
device), with the quantization error measured per block.

The config readers take the ``DS_KV_TIER*`` environment switches first
(``utils/env_registry.py``), as the JAX package's do.
"""

from deepspeed_tpu_torch.inference.v2.kv_tier.host_store import HostKVStore
from deepspeed_tpu_torch.inference.v2.kv_tier.quant import (dequantize_handle, handle_nbytes,
                                                            quantize_handle)
from deepspeed_tpu_torch.inference.v2.kv_tier.tier_manager import TierManager
from deepspeed_tpu_torch.utils.env_registry import env_int, env_opt_bool


def kv_tier_enabled(config) -> bool:
    """Config gate plus the ``DS_KV_TIER`` kill switch: when the env var
    is set it wins in BOTH directions (``0``/``false``/``off`` force the
    tier off, anything else forces it on); unset defers to
    ``config.enabled``."""
    forced = env_opt_bool("DS_KV_TIER")
    if forced is not None:
        return forced
    return bool(getattr(config, "enabled", False))


def kv_tier_bytes(config) -> int:
    """Host byte budget for tier-2: ``DS_KV_TIER_BYTES`` when set to a
    positive value, else the config's ``host_bytes``."""
    override = env_int("DS_KV_TIER_BYTES")
    if override > 0:
        return override
    return int(getattr(config, "host_bytes", 1 << 30))


def kv_tier_quantized(config) -> bool:
    """int8 tier-2 storage gate (``DS_KV_TIER_QUANT`` wins in both
    directions; unset defers to ``config.quantize``). Opt-in only: lossy
    storage is never a silent default."""
    forced = env_opt_bool("DS_KV_TIER_QUANT")
    if forced is not None:
        return forced
    return bool(getattr(config, "quantize", False))


__all__ = ["HostKVStore", "TierManager", "kv_tier_enabled", "kv_tier_bytes",
           "kv_tier_quantized", "quantize_handle", "dequantize_handle",
           "handle_nbytes"]
