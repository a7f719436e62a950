"""Training config and LR schedules in the PyTorch port vs the JAX package.

``DeepSpeedConfig`` over a table of ds_config dicts: the solved batch
triple and the parsed fields the training slice reads must equal the JAX
config's; where the JAX config raises (its assertions) the port raises
``DeepSpeedConfigError`` with the same message. (The JAX config is built
without a mesh and with ``WORLD_SIZE`` unset, so its data-parallel world
is 1, the port's.) Each LR schedule, driven 100 steps on a plain
``param_groups`` holder, must give exactly the JAX schedule's learning
rates (and OneCycle's momenta)."""

import pytest

from deepspeed_tpu.runtime import lr_schedules as jax_lr
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
from deepspeed_tpu_torch.runtime import lr_schedules as port_lr
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig, DeepSpeedConfigError

CONFIGS = {
    "train_only": {"train_batch_size": 8},
    "micro_only": {"train_micro_batch_size_per_gpu": 4},
    "train_micro": {"train_batch_size": 8, "train_micro_batch_size_per_gpu": 2},
    "train_gas": {"train_batch_size": 8, "gradient_accumulation_steps": 2},
    "micro_gas": {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 3},
    "all_three": {"train_batch_size": 12, "train_micro_batch_size_per_gpu": 3,
                  "gradient_accumulation_steps": 4},
    "bench_train_config": {"train_batch_size": 8, "train_micro_batch_size_per_gpu": 4,
                           "gradient_accumulation_steps": 2, "bf16": {"enabled": True},
                           "optimizer": {"type": "Adam", "params": {"lr": 1e-4}},
                           "zero_optimization": {"stage": 3}, "steps_per_print": 1000000},
    "full_sections": {"train_batch_size": 4, "gradient_clipping": 1.0,
                      "bfloat16": {"enabled": True}, "wall_clock_breakdown": True,
                      "optimizer": {"type": "AdamW", "params": {"lr": 3e-4, "betas": [0.9, 0.95],
                                                               "weight_decay": 0.1}},
                      "scheduler": {"type": "WarmupCosineLR",
                                    "params": {"total_num_steps": 100, "warmup_num_steps": 10}},
                      "zero_optimization": {"stage": 2, "stage3_prefetch_bucket_size": 1000,
                                            "stage3_param_persistence_threshold": "auto",
                                            "reduce_bucket_size": 123},
                      "data_types": {"grad_accum_dtype": "bf16"}},
    # errors
    "neither_batch_key": {"gradient_accumulation_steps": 2},
    "inexact_micro": {"train_batch_size": 8, "train_micro_batch_size_per_gpu": 3},
    "inconsistent": {"train_batch_size": 8, "train_micro_batch_size_per_gpu": 2,
                     "gradient_accumulation_steps": 3},
    "zero_gas": {"train_batch_size": 2, "train_micro_batch_size_per_gpu": 4},
    "zero_micro": {"train_batch_size": 8, "gradient_accumulation_steps": 16},
    "bf16_and_fp16": {"train_batch_size": 8, "bf16": {"enabled": True},
                      "fp16": {"enabled": True}},
}

FIELDS = ("train_batch_size", "train_micro_batch_size_per_gpu", "gradient_accumulation_steps",
          "gradient_clipping", "steps_per_print", "bfloat16_enabled", "fp16_enabled",
          "optimizer_name", "optimizer_params", "scheduler_name", "scheduler_params",
          "zero_optimization_stage", "zero_enabled", "wall_clock_breakdown", "grad_accum_dtype",
          "loss_scale", "prescale_gradients", "gradient_predivide_factor")
ZERO_FIELDS = ("stage", "prefetch_bucket_size", "param_persistence_threshold",
               "reduce_bucket_size", "overlap_comm", "contiguous_gradients")


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_matches_jax(name, monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    cfg = CONFIGS[name]
    try:
        want = JaxConfig(dict(cfg))
    except AssertionError as e:
        with pytest.raises(DeepSpeedConfigError) as got:
            DeepSpeedConfig(dict(cfg))
        assert str(got.value) == str(e)
        return
    got = DeepSpeedConfig(dict(cfg))
    for field in FIELDS:
        assert getattr(got, field) == getattr(want, field), field
    for field in ZERO_FIELDS:
        assert getattr(got.zero_config, field) == getattr(want.zero_config, field), field


class _Groups:
    """The ``param_groups`` an LR schedule drives."""

    def __init__(self):
        self.param_groups = [{"lr": 0.01, "betas": (0.9, 0.999)},
                             {"lr": 0.02, "betas": (0.85, 0.99)}]


SCHEDULES = {
    "LRRangeTest": dict(lr_range_test_min_lr=1e-4, lr_range_test_step_size=7,
                        lr_range_test_step_rate=2.0, lr_range_test_staircase=True),
    "OneCycle": dict(cycle_min_lr=1e-4, cycle_max_lr=1e-2, cycle_first_step_size=20,
                     cycle_second_step_size=30, decay_lr_rate=0.1, decay_step_size=5,
                     cycle_first_stair_count=3, decay_mom_rate=0.01),
    "WarmupLR": dict(warmup_min_lr=1e-5, warmup_max_lr=1e-3, warmup_num_steps=17),
    "WarmupLR_linear": dict(warmup_min_lr=0.0, warmup_max_lr=2e-3, warmup_num_steps=30,
                            warmup_type="linear"),
    "WarmupDecayLR": dict(total_num_steps=80, warmup_min_lr=1e-5, warmup_max_lr=1e-3,
                          warmup_num_steps=12),
    "WarmupCosineLR": dict(total_num_steps=90, warmup_min_ratio=0.1, warmup_num_steps=15,
                           cos_min_ratio=0.01),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_lr_schedule_sequence_matches_jax(name):
    cls_name = name.split("_")[0]
    seqs = []
    for mod in (jax_lr, port_lr):
        opt = _Groups()
        sched = getattr(mod, cls_name)(opt, **SCHEDULES[name])
        seq = []
        for _ in range(100):
            sched.step()
            seq.append([(g["lr"], tuple(g["betas"])) for g in opt.param_groups])
        seqs.append(seq)
    assert seqs[0] == seqs[1]
