"""Top-level config: ``ds_config.json``/dict → typed sections.

Port of ``deepspeed_tpu/runtime/config.py`` for the single-device training
slice: the same JSON schema and the same table-driven parsing of the
scalars, mixed precision (bf16), optimizer and scheduler specs,
``gradient_clipping``, ``steps_per_print``, ``wall_clock_breakdown``,
``zero_optimization``, ``data_types.grad_accum_dtype`` and the raw
``sparse_attention`` section (``sparse_attention``, None when absent; the
model reads it through ``SparseAttentionUtils``), and the same
batch triple solve ``train_batch = micro_batch × grad_acc × dp_world``
with its consistency check. ``world_size`` is 1: the port trains on one
device (the JAX config reads it from a mesh, an mpu or ``WORLD_SIZE``).
An inconsistent or missing batch setting raises
:class:`DeepSpeedConfigError` with the JAX assertion's message.

A section this slice does not run raises ``NotImplementedError`` naming
its ``ROADMAP.md`` port-queue item instead of being ignored: fp16, amp, an
enabled monitor, nebula, data efficiency, curriculum learning, progressive
layer drop, elasticity, autotuning, the flops profiler, the hybrid engine,
``frozen_parameters``, a ``mesh`` axis above 1, ZeRO++ quantized
collectives and ``offload_param``/``offload_optimizer``.
"""

import base64
import binascii
import copy
import json
import os
from typing import Union

from deepspeed_tpu_torch.roadmap import not_ported
from deepspeed_tpu_torch.runtime.config_utils import (dict_raise_error_on_duplicate_keys,
                                                      get_scalar_param)
from deepspeed_tpu_torch.runtime.constants import (
    AMP, AMP_ENABLED, AMP_ENABLED_DEFAULT, BFLOAT16, BFLOAT16_ENABLED, BFLOAT16_ENABLED_DEFAULT,
    BFLOAT16_OLD, CHECKPOINT, CURRICULUM_LEARNING, DATA_TYPES,
    DEEPSPEED_OPTIMIZERS, DUMP_STATE, DUMP_STATE_DEFAULT, FP16, FP16_ENABLED, FP16_ENABLED_DEFAULT,
    FP16_INITIAL_SCALE_POWER_DEFAULT, FP16_LOSS_SCALE_DEFAULT,
    GRAD_ACCUM_DTYPE, GRAD_ACCUM_DTYPE_DEFAULT, GRADIENT_ACCUMULATION_STEPS,
    GRADIENT_ACCUMULATION_STEPS_DEFAULT, GRADIENT_CLIPPING, GRADIENT_CLIPPING_DEFAULT,
    GRADIENT_PREDIVIDE_FACTOR, GRADIENT_PREDIVIDE_FACTOR_DEFAULT, MAX_GRAD_NORM,
    MEMORY_BREAKDOWN, MEMORY_BREAKDOWN_DEFAULT, MESH, OPTIMIZER, OPTIMIZER_PARAMS,
    OPTIMIZER_TYPE_DEFAULT, PRESCALE_GRADIENTS, PRESCALE_GRADIENTS_DEFAULT, SCHEDULER,
    SCHEDULER_PARAMS, SCHEDULER_TYPE_DEFAULT, SPARSE_ATTENTION, STEPS_PER_PRINT, STEPS_PER_PRINT_DEFAULT,
    TRAIN_BATCH_SIZE, TRAIN_BATCH_SIZE_DEFAULT, TRAIN_MICRO_BATCH_SIZE_PER_GPU,
    TRAIN_MICRO_BATCH_SIZE_PER_GPU_DEFAULT, TYPE, WALL_CLOCK_BREAKDOWN,
    WALL_CLOCK_BREAKDOWN_DEFAULT)
from deepspeed_tpu_torch.runtime.zero.config import ZERO_OPTIMIZATION, DeepSpeedZeroConfig
from deepspeed_tpu_torch.utils.logging import logger


class DeepSpeedConfigError(ValueError):
    """The batch settings (or another checked value) are inconsistent."""


# attr name → (top-level ds_config key, default), read in one loop
_SCALAR_ATTRS = {
    "train_batch_size": (TRAIN_BATCH_SIZE, TRAIN_BATCH_SIZE_DEFAULT),
    "train_micro_batch_size_per_gpu": (TRAIN_MICRO_BATCH_SIZE_PER_GPU,
                                       TRAIN_MICRO_BATCH_SIZE_PER_GPU_DEFAULT),
    "gradient_accumulation_steps": (GRADIENT_ACCUMULATION_STEPS, GRADIENT_ACCUMULATION_STEPS_DEFAULT),
    "steps_per_print": (STEPS_PER_PRINT, STEPS_PER_PRINT_DEFAULT),
    "dump_state": (DUMP_STATE, DUMP_STATE_DEFAULT),
    "prescale_gradients": (PRESCALE_GRADIENTS, PRESCALE_GRADIENTS_DEFAULT),
    "gradient_predivide_factor": (GRADIENT_PREDIVIDE_FACTOR, GRADIENT_PREDIVIDE_FACTOR_DEFAULT),
    "gradient_clipping": (GRADIENT_CLIPPING, GRADIENT_CLIPPING_DEFAULT),
    "memory_breakdown": (MEMORY_BREAKDOWN, MEMORY_BREAKDOWN_DEFAULT),
}

# attr name → top-level section key; the attribute is the raw sub-dict
_SECTION_ATTRS = {
    "timers_config": "timers",
    "checkpoint_config": CHECKPOINT,
}

# sections with an "enabled" switch that this slice does not run → queue item
_OFF_SLICE_SECTIONS = {
    AMP: 6, "tensorboard": 6, "wandb": 6, "csv_monitor": 6, "comet": 6, "nebula": 6,
    "data_efficiency": 6, CURRICULUM_LEARNING: 6, "progressive_layer_drop": 6,
    "elasticity": 6, "autotuning": 6, "flops_profiler": 6, "hybrid_engine": 6,
}


def _bf16_section(param_dict):
    """The bf16 section under either its current or legacy key."""
    for key in (BFLOAT16, BFLOAT16_OLD):
        if key in param_dict:
            return param_dict[key]
    return None


def _typed_spec(param_dict, section, default_type, params_key):
    """Parse an {"type": ..., "params": {...}} section (optimizer and
    scheduler share this shape). → (type or default, params or None)."""
    spec = param_dict.get(section)
    if not spec or TYPE not in spec:
        return default_type, None
    return spec[TYPE], spec.get(params_key)


def _check_off_slice(param_dict, zero):
    for key, item in _OFF_SLICE_SECTIONS.items():
        if (param_dict.get(key) or {}).get("enabled", False):
            raise not_ported(f"the {key!r} config section", item)
    if param_dict.get("frozen_parameters"):
        raise not_ported("'frozen_parameters'", 6)
    for axis, size in (param_dict.get(MESH) or {}).items():
        if int(size) not in (-1, 1):
            raise not_ported(f"mesh.{axis} = {size} (the port trains on one device)",
                             7 if axis == "data_parallel_size" else 6)
    if zero.offload_param_device() != "none" or zero.offload_optimizer_device() != "none":
        raise not_ported("zero_optimization offload_param/offload_optimizer", 12)
    for flag in ("zero_quantized_weights", "zero_quantized_nontrainable_weights",
                 "zero_quantized_gradients"):
        if getattr(zero, flag):
            raise not_ported(f"zero_optimization.{flag}", 7)


class DeepSpeedConfig:
    """Parse a config dict/path into typed sections and the solved batch
    triple, for one device (``world_size`` 1)."""

    def __init__(self, config: Union[str, dict]):
        self._param_dict = self._load_param_dict(config)
        self.global_rank = 0
        self.world_size = 1
        self._initialize_params(copy.copy(self._param_dict))
        _check_off_slice(self._param_dict, self.zero_config)
        self._configure_train_batch_size()
        self._do_sanity_check()

    @staticmethod
    def _load_param_dict(config):
        """A dict, a path to a JSON file, or base64-encoded JSON."""
        if isinstance(config, dict):
            return copy.copy(config)
        if os.path.exists(config):
            with open(config) as f:
                return json.load(f, object_pairs_hook=dict_raise_error_on_duplicate_keys)
        try:
            return json.loads(base64.urlsafe_b64decode(config).decode("utf-8"))
        except (binascii.Error, UnicodeDecodeError, AttributeError, json.JSONDecodeError):
            raise ValueError(
                f"Expected a string path to an existing deepspeed config, or a dictionary "
                f"or a valid base64. Received: {config}")

    def _initialize_params(self, param_dict):
        for attr, (key, default) in _SCALAR_ATTRS.items():
            setattr(self, attr, get_scalar_param(param_dict, key, default))
        for attr, key in _SECTION_ATTRS.items():
            setattr(self, attr, param_dict.get(key, {}))

        self.zero_config = DeepSpeedZeroConfig.from_dict(param_dict.get(ZERO_OPTIMIZATION, {}))
        self.zero_optimization_stage = self.zero_config.stage
        self.zero_enabled = self.zero_optimization_stage > 0

        fp16 = param_dict.get(FP16, {})
        bf16 = _bf16_section(param_dict)
        self.fp16_enabled = bool(fp16.get(FP16_ENABLED, FP16_ENABLED_DEFAULT))
        self.bfloat16_enabled = bool(bf16.get(BFLOAT16_ENABLED, BFLOAT16_ENABLED_DEFAULT)) \
            if bf16 else False
        if self.fp16_enabled and self.bfloat16_enabled:
            raise DeepSpeedConfigError("bfloat16 and fp16 modes cannot be simultaneously enabled")
        if self.fp16_enabled:
            raise not_ported("fp16 training (loss scaling, runtime/fp16/loss_scaler.py)", 9)
        self.amp_enabled = param_dict.get(AMP, {}).get(AMP_ENABLED, AMP_ENABLED_DEFAULT)
        # the JAX config's values; bf16 and fp32 train unscaled (the engine's
        # scale is 1 without fp16)
        if self.bfloat16_enabled:
            self.loss_scale, scale_power = 1.0, 0
        else:
            self.loss_scale, scale_power = FP16_LOSS_SCALE_DEFAULT, FP16_INITIAL_SCALE_POWER_DEFAULT
        self.initial_dynamic_scale = 2**scale_power

        self.optimizer_name, self.optimizer_params = _typed_spec(
            param_dict, OPTIMIZER, OPTIMIZER_TYPE_DEFAULT, OPTIMIZER_PARAMS)
        if self.optimizer_name is not None and self.optimizer_name.lower() in DEEPSPEED_OPTIMIZERS:
            self.optimizer_name = self.optimizer_name.lower()
        self.scheduler_name, self.scheduler_params = _typed_spec(
            param_dict, SCHEDULER, SCHEDULER_TYPE_DEFAULT, SCHEDULER_PARAMS)
        self.wall_clock_breakdown = get_scalar_param(param_dict, WALL_CLOCK_BREAKDOWN,
                                                     WALL_CLOCK_BREAKDOWN_DEFAULT)
        self.sparse_attention = param_dict.get(SPARSE_ATTENTION, None)
        self.mesh_shape = param_dict.get(MESH, {})
        self.grad_accum_dtype = param_dict.get(DATA_TYPES, {}).get(GRAD_ACCUM_DTYPE,
                                                                   GRAD_ACCUM_DTYPE_DEFAULT)

    def batch_assertion(self):
        train = self.train_batch_size
        micro = self.train_micro_batch_size_per_gpu
        grad_acc = self.gradient_accumulation_steps
        for value, what in ((train, "train_batch_size"), (micro, "train_micro_batch_size_per_gpu"),
                            (grad_acc, "gradient_accumulation_steps")):
            if not value > 0:
                raise DeepSpeedConfigError(f"{what} must be positive, got {value}")
        if train != micro * grad_acc * self.world_size:
            raise DeepSpeedConfigError(
                f"batch parameters are inconsistent: train_batch_size {train} != "
                f"micro_batch {micro} × grad_acc {grad_acc} × dp_world {self.world_size}")

    def _set_batch_related_parameters(self):
        """Solve ``train_batch = micro_batch × grad_acc × dp_world`` for
        whichever of the three the ds_config left unset (grad accumulation
        defaults to 1 when under-determined); ``batch_assertion`` re-checks
        the identity, so inexact divisions raise."""
        train = self.train_batch_size
        micro = self.train_micro_batch_size_per_gpu
        grad_acc = self.gradient_accumulation_steps
        if train is None and micro is None:
            raise DeepSpeedConfigError(
                "Either train_batch_size or train_micro_batch_size_per_gpu needs to be provided")
        if grad_acc is None and (train is None or micro is None):
            grad_acc = 1
        if train is None:
            train = micro * grad_acc * self.world_size
        elif micro is None:
            micro = train // (grad_acc * self.world_size)
        elif grad_acc is None:
            grad_acc = train // (micro * self.world_size)
        self.train_batch_size = train
        self.train_micro_batch_size_per_gpu = micro
        self.gradient_accumulation_steps = grad_acc

    def _configure_train_batch_size(self):
        self._set_batch_related_parameters()
        self.batch_assertion()

    def _do_sanity_check(self):
        max_norm = (self.optimizer_params or {}).get(MAX_GRAD_NORM, 0)
        if max_norm > 0:
            logger.warning(
                f"DeepSpeedConfig: dropping optimizer {MAX_GRAD_NORM}={max_norm} — outside fp16 "
                f"mode gradient clipping belongs to the engine's gradient_clipping knob, not "
                f"the optimizer params")
            self.optimizer_params[MAX_GRAD_NORM] = 0.0
