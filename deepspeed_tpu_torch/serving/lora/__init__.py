"""Multi-tenant LoRA serving: many adapters on one base model.

Port of ``deepspeed_tpu/serving/lora``: per-request ``adapter_id`` flows
scheduler → engine → packed batch → model runner, where the segmented
LoRA kernel (:mod:`deepspeed_tpu_torch.ops.kernels.lora_matmul`) applies
every tenant's delta in one grouped pass per projection, and an
:class:`~deepspeed_tpu_torch.serving.lora.store.AdapterStore` pages
adapters between device slabs and host memory.

The helpers take the ``DS_LORA*`` environment overrides first
(``utils/env_registry.py``), as the JAX package's do. The store's disk
tier (``publish_root``) serves sha256-validated adapter publications
(:class:`AdapterPublisher`). ``lora.enabled = False`` builds the exact
pre-LoRA pipeline: no slot row packed, no delta computed."""

from deepspeed_tpu_torch.serving.lora.publisher import AdapterPublisher
from deepspeed_tpu_torch.serving.lora.store import (LORA_SITES, AdapterCapacityError,
                                                     AdapterStore, UnknownAdapterError)
from deepspeed_tpu_torch.utils.env_registry import env_int, env_opt_bool


def lora_serving_enabled(config) -> bool:
    """Config gate plus the ``DS_LORA`` kill switch: when the env var is
    set it wins in BOTH directions; unset defers to
    ``config.enabled``."""
    forced = env_opt_bool("DS_LORA")
    if forced is not None:
        return forced
    return bool(getattr(config, "enabled", False))


def lora_hot_set(config) -> int:
    """Hot adapter slots (slot 0, the base, comes on top):
    ``DS_LORA_HOT_SET`` when set to a positive value, else the config's
    ``hot_set``."""
    override = env_int("DS_LORA_HOT_SET")
    if override > 0:
        return override
    return int(getattr(config, "hot_set", 8))


def lora_max_rank(config) -> int:
    """The rank bucket every adapter is padded to: ``DS_LORA_MAX_RANK``
    when set to a positive value, else the config's ``max_rank``."""
    override = env_int("DS_LORA_MAX_RANK")
    if override > 0:
        return override
    return int(getattr(config, "max_rank", 16))


__all__ = ["AdapterPublisher", "AdapterStore", "AdapterCapacityError", "UnknownAdapterError",
           "LORA_SITES", "lora_serving_enabled", "lora_hot_set", "lora_max_rank"]
