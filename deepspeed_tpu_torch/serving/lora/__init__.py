"""Multi-tenant LoRA serving: many adapters on one base model.

Port of ``deepspeed_tpu/serving/lora``: per-request ``adapter_id`` flows
scheduler → engine → packed batch → model runner, where the segmented
LoRA kernel (:mod:`deepspeed_tpu_torch.ops.kernels.lora_matmul`) applies
every tenant's delta in one grouped pass per projection, and an
:class:`~deepspeed_tpu_torch.serving.lora.store.AdapterStore` pages
adapters between device slabs and host memory.

The helpers read the config only: the ``DS_LORA*`` environment overrides
wait with the other ``DS_*`` switches, and the disk tier
(``AdapterPublisher``, ``publish_root``) with the serving stack (ROADMAP.md,
port queue item 4). ``lora.enabled = False`` builds the exact pre-LoRA
pipeline: no slot row packed, no delta computed."""

from deepspeed_tpu_torch.serving.lora.store import (LORA_SITES, AdapterCapacityError,
                                                     AdapterStore, UnknownAdapterError)


def lora_serving_enabled(config) -> bool:
    return bool(getattr(config, "enabled", False))


def lora_hot_set(config) -> int:
    """Hot adapter slots (slot 0, the base, comes on top)."""
    return int(getattr(config, "hot_set", 8))


def lora_max_rank(config) -> int:
    """The rank bucket every adapter is padded to."""
    return int(getattr(config, "max_rank", 16))


__all__ = ["AdapterStore", "AdapterCapacityError", "UnknownAdapterError", "LORA_SITES",
           "lora_serving_enabled", "lora_hot_set", "lora_max_rank"]
