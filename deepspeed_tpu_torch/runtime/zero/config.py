"""ZeRO config section, as dataclasses.

Port of ``deepspeed_tpu/runtime/zero/config.py`` (a pydantic model there):
the same fields, defaults and ``stage3_*`` aliases, ``stage`` checked to be
0-3, and the deprecated ``cpu_offload*`` / ``stage3_gather_fp16_*`` keys
forwarded to their replacements as the JAX model does. Values ``"auto"``
are dropped, as the JAX base drops them.

On one device every stage computes the same thing (the engine's docstring
says why). Offloading is not ported: an ``offload_param`` or
``offload_optimizer`` device other than ``"none"`` raises in
``runtime/config.py``.
"""

import dataclasses
from typing import Optional

from deepspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigModel

ZERO_OPTIMIZATION = "zero_optimization"
OFFLOAD_DEVICES = ("none", "cpu", "nvme")


def _check_device(device):
    if device not in OFFLOAD_DEVICES:
        raise ValueError(f"offload device {device!r}: expected one of {OFFLOAD_DEVICES}")


@dataclasses.dataclass
class DeepSpeedZeroOffloadParamConfig(DeepSpeedConfigModel):
    """Where/how ZeRO-3 parameter shards are offloaded."""
    device: str = "none"
    nvme_path: Optional[str] = None
    buffer_count: int = 5
    buffer_size: int = int(1e8)
    max_in_cpu: int = int(1e9)
    pin_memory: bool = False

    def __post_init__(self):
        super().__post_init__()
        _check_device(self.device)


@dataclasses.dataclass
class DeepSpeedZeroOffloadOptimizerConfig(DeepSpeedConfigModel):
    """Where/how optimizer states (and fp32 master weights) are offloaded."""
    device: str = "none"
    nvme_path: Optional[str] = None
    buffer_count: int = 4
    pin_memory: bool = False
    pipeline_read: bool = False
    pipeline_write: bool = False
    fast_init: bool = False
    ratio: float = 1.0

    def __post_init__(self):
        super().__post_init__()
        _check_device(self.device)

    @property
    def pipeline(self):
        return self.pipeline_read or self.pipeline_write


_ALIASES = {
    "stage3_prefetch_bucket_size": "prefetch_bucket_size",
    "stage3_param_persistence_threshold": "param_persistence_threshold",
    "stage3_model_persistence_threshold": "model_persistence_threshold",
    "stage3_max_live_parameters": "max_live_parameters",
    "stage3_max_reuse_distance": "max_reuse_distance",
    "stage3_gather_16bit_weights_on_model_save": "gather_16bit_weights_on_model_save",
    "stage3_use_all_reduce_for_fetch_params": "use_all_reduce_for_fetch_params",
}


@dataclasses.dataclass
class DeepSpeedZeroConfig(DeepSpeedConfigModel):
    """``zero_optimization`` section. Build it from a ds_config dict with
    :meth:`from_dict`, which also takes the ``stage3_*`` aliases."""

    stage: int = 0
    contiguous_gradients: bool = True
    reduce_scatter: bool = True
    reduce_bucket_size: int = int(5e8)
    use_multi_rank_bucket_allreduce: bool = True
    allgather_partitions: bool = True
    allgather_bucket_size: int = int(5e8)
    overlap_comm: Optional[bool] = None
    load_from_fp32_weights: bool = True
    elastic_checkpoint: bool = False
    offload_param: Optional[DeepSpeedZeroOffloadParamConfig] = None
    offload_optimizer: Optional[DeepSpeedZeroOffloadOptimizerConfig] = None
    sub_group_size: int = int(1e9)
    # deprecated: forwarded to offload_param / offload_optimizer
    cpu_offload_param: Optional[bool] = None
    cpu_offload_use_pin_memory: Optional[bool] = None
    cpu_offload: Optional[bool] = None
    prefetch_bucket_size: int = int(5e7)
    param_persistence_threshold: int = int(1e5)
    model_persistence_threshold: int = 2**62
    max_live_parameters: int = int(1e9)
    max_reuse_distance: int = int(1e9)
    gather_16bit_weights_on_model_save: bool = False
    use_all_reduce_for_fetch_params: bool = False
    # deprecated: forwarded to gather_16bit_weights_on_model_save
    stage3_gather_fp16_weights_on_model_save: bool = False
    ignore_unused_parameters: bool = True
    legacy_stage1: bool = False
    round_robin_gradients: bool = False
    zero_hpz_partition_size: int = 1
    zero_quantized_weights: bool = False
    zero_quantized_nontrainable_weights: bool = False
    zero_quantized_gradients: bool = False
    mics_shard_size: int = -1
    mics_hierarchical_params_gather: bool = False
    memory_efficient_linear: bool = True
    pipeline_loading_checkpoint: bool = False
    override_module_apply: bool = True

    @classmethod
    def from_dict(cls, section):
        kwargs = {}
        for key, value in (section or {}).items():
            if value == "auto":
                continue
            kwargs[_ALIASES.get(key, key)] = value
        return cls(**kwargs)

    def __post_init__(self):
        super().__post_init__()
        if not isinstance(self.stage, int) or not 0 <= self.stage <= 3:
            raise ValueError(f"zero_optimization.stage must be 0, 1, 2 or 3, got {self.stage!r}")
        if isinstance(self.offload_param, dict):
            self.offload_param = DeepSpeedZeroOffloadParamConfig(**self.offload_param)
        if isinstance(self.offload_optimizer, dict):
            self.offload_optimizer = DeepSpeedZeroOffloadOptimizerConfig(**self.offload_optimizer)
        if self.cpu_offload_param and self.offload_param is None:
            self.offload_param = DeepSpeedZeroOffloadParamConfig(device="cpu")
        if self.cpu_offload and self.offload_optimizer is None:
            self.offload_optimizer = DeepSpeedZeroOffloadOptimizerConfig(device="cpu")
        if self.stage3_gather_fp16_weights_on_model_save:
            self.gather_16bit_weights_on_model_save = True
        if self.overlap_comm is None:
            self.overlap_comm = self.stage == 3

    def offload_optimizer_device(self):
        return "none" if self.offload_optimizer is None else self.offload_optimizer.device

    def offload_param_device(self):
        return "none" if self.offload_param is None else self.offload_param.device
