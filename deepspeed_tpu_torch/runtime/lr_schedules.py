"""Learning-rate schedules.

Copy of ``deepspeed_tpu/runtime/lr_schedules.py`` (JAX-free): the same
schedule family and JSON parameter schema (LRRangeTest, OneCycle,
WarmupLR, WarmupDecayLR, WarmupCosineLR). Every schedule is a stateless
``step -> value`` curve; the scheduler classes write the curve's value
into the optimizer's ``param_groups``, here the port's
``ops/adam/fused_adam.py`` optimizers.
"""

import argparse
import math

from deepspeed_tpu_torch.utils.logging import logger

LR_SCHEDULE = "lr_schedule"
LR_RANGE_TEST = "LRRangeTest"
ONE_CYCLE = "OneCycle"
WARMUP_LR = "WarmupLR"
WARMUP_DECAY_LR = "WarmupDecayLR"
WARMUP_COSINE_LR = "WarmupCosineLR"
VALID_LR_SCHEDULES = [LR_RANGE_TEST, ONE_CYCLE, WARMUP_LR, WARMUP_DECAY_LR, WARMUP_COSINE_LR]

LR_RANGE_TEST_MIN_LR = "lr_range_test_min_lr"
LR_RANGE_TEST_STEP_RATE = "lr_range_test_step_rate"
LR_RANGE_TEST_STEP_SIZE = "lr_range_test_step_size"
LR_RANGE_TEST_STAIRCASE = "lr_range_test_staircase"

EDGE_VALUE = "edge_value"
MID_VALUE = "mid_value"

CYCLE_FIRST_STEP_SIZE = "cycle_first_step_size"
CYCLE_FIRST_STAIR_COUNT = "cycle_first_stair_count"
CYCLE_SECOND_STEP_SIZE = "cycle_second_step_size"
CYCLE_SECOND_STAIR_COUNT = "cycle_second_stair_count"
DECAY_STEP_SIZE = "decay_step_size"

CYCLE_MIN_LR = "cycle_min_lr"
CYCLE_MAX_LR = "cycle_max_lr"
DECAY_LR_RATE = "decay_lr_rate"

CYCLE_MIN_MOM = "cycle_min_mom"
CYCLE_MAX_MOM = "cycle_max_mom"
DECAY_MOM_RATE = "decay_mom_rate"

WARMUP_MIN_LR = "warmup_min_lr"
WARMUP_MAX_LR = "warmup_max_lr"
WARMUP_NUM_STEPS = "warmup_num_steps"
WARMUP_TYPE = "warmup_type"
WARMUP_LOG_RATE = "log"
WARMUP_LINEAR_RATE = "linear"

WARMUP_MIN_RATIO = "warmup_min_ratio"
COS_MIN_RATIO = "cos_min_ratio"

TOTAL_NUM_STEPS = "total_num_steps"


# ---------------------------------------------------------------------------
# Declarative CLI parameter table: family -> [(key, type, default, help)].
# argparse setup and config overrides are both generated from it.
# ---------------------------------------------------------------------------

_CLI_TABLE = {
    LR_RANGE_TEST: [
        (LR_RANGE_TEST_MIN_LR, float, 0.001, "starting LR for the range test"),
        (LR_RANGE_TEST_STEP_RATE, float, 1.0, "LR scaling rate per interval"),
        (LR_RANGE_TEST_STEP_SIZE, int, 1000, "steps per LR interval"),
        (LR_RANGE_TEST_STAIRCASE, bool, False, "discrete (staircase) intervals"),
    ],
    ONE_CYCLE: [
        (CYCLE_FIRST_STEP_SIZE, int, 1000, "steps in the rising half-cycle"),
        (CYCLE_FIRST_STAIR_COUNT, int, -1, "stairs in the rising half-cycle"),
        (CYCLE_SECOND_STEP_SIZE, int, -1, "steps in the falling half-cycle"),
        (CYCLE_SECOND_STAIR_COUNT, int, -1, "stairs in the falling half-cycle"),
        (DECAY_STEP_SIZE, int, 1000, "steps per post-cycle decay interval"),
        (CYCLE_MIN_LR, float, 0.01, "cycle LR floor"),
        (CYCLE_MAX_LR, float, 0.1, "cycle LR peak"),
        (DECAY_LR_RATE, float, 0.0, "post-cycle LR decay rate"),
        (CYCLE_MIN_MOM, float, 0.8, "cycle momentum floor"),
        (CYCLE_MAX_MOM, float, 0.9, "cycle momentum peak"),
        (DECAY_MOM_RATE, float, 0.0, "post-cycle momentum decay rate"),
    ],
    WARMUP_LR: [
        (WARMUP_MIN_LR, float, 0.0, "initial LR before warmup"),
        (WARMUP_MAX_LR, float, 0.001, "LR after warmup"),
        (WARMUP_NUM_STEPS, int, 1000, "warmup step count"),
        (WARMUP_TYPE, str, WARMUP_LOG_RATE, "warmup curve: log | linear"),
    ],
}


def add_tuning_arguments(parser):
    group = parser.add_argument_group("Convergence Tuning", "Convergence tuning configurations")
    group.add_argument(f"--{LR_SCHEDULE}", type=str, default=None, help="LR schedule for training.")
    for rows in _CLI_TABLE.values():
        for key, typ, default, help_text in rows:
            group.add_argument(f"--{key}", type=typ, default=default, help=help_text)
    group.add_argument("--cycle_momentum", default=False, action="store_true",
                       help="enable the OneCycle momentum schedule")
    return parser


def parse_arguments():
    parser = add_tuning_arguments(argparse.ArgumentParser())
    return parser.parse_known_args()


def _apply_cli_overrides(family, args, params):
    for key, _, _, _ in _CLI_TABLE[family]:
        value = getattr(args, key, None)
        if value is not None:
            params[key] = value


def override_lr_range_test_params(args, params):
    _apply_cli_overrides(LR_RANGE_TEST, args, params)


def override_1cycle_params(args, params):
    _apply_cli_overrides(ONE_CYCLE, args, params)


def override_warmupLR_params(args, params):
    _apply_cli_overrides(WARMUP_LR, args, params)


def override_params(args, params):
    for family in _CLI_TABLE:
        _apply_cli_overrides(family, args, params)


def get_config_from_args(args):
    """Build a scheduler config dict from parsed CLI args; returns
    (config, None) or (None, reason)."""
    name = getattr(args, LR_SCHEDULE, None)
    if name is None:
        return None, f"--{LR_SCHEDULE} not specified on command line"
    if name not in VALID_LR_SCHEDULES:
        return None, f"{name} is not supported LR schedule"
    family = name if name in _CLI_TABLE else WARMUP_LR  # warmup variants share params
    config = {"type": name, "params": {}}
    _apply_cli_overrides(family, args, config["params"])
    return config, None


def get_lr_from_config(config):
    """The schedule's nominal peak LR; returns (lr, '') or (None, reason)."""
    for key in ("type", "params"):
        if key not in config:
            return None, f"LR schedule {key} not defined in config"
    name, params = config["type"], config["params"]
    if name not in VALID_LR_SCHEDULES:
        return None, f"{name} is not a valid LR schedule"
    peak_key = {LR_RANGE_TEST: LR_RANGE_TEST_MIN_LR, ONE_CYCLE: CYCLE_MAX_LR}.get(name, WARMUP_MAX_LR)
    return params[peak_key], ""


# ---------------------------------------------------------------------------
# Pure curves (step -> scalar). The scheduler classes drive these.
# ---------------------------------------------------------------------------

def _warmup_fraction(step, num_steps, warmup_type):
    """Warmup progress in [0, 1]; log or linear ramp over ``num_steps``."""
    if step >= num_steps:
        return 1.0
    if warmup_type == WARMUP_LINEAR_RATE:
        return step / num_steps
    return math.log(step + 1) / math.log(num_steps)


def _triangle(step, up_steps, down_steps):
    """Periodic triangular wave in [0, 1]: up over ``up_steps``, down
    over ``down_steps``."""
    period = up_steps + down_steps
    t = step % period
    if t < up_steps:
        return t / up_steps
    return 1.0 - (t - up_steps) / down_steps


class _LRScheduler:
    """Stateful wrapper over a pure ``_lr_at(step) -> [lr per group]``
    curve. ``step()`` advances the counter and writes the new LRs into
    ``optimizer.param_groups``."""

    def __init__(self, optimizer, last_batch_iteration=-1):
        self.optimizer = optimizer
        self.last_batch_iteration = last_batch_iteration

    # subclasses implement the pure curve
    def _lr_at(self, step):
        raise NotImplementedError

    def get_lr(self):
        return self._lr_at(self.last_batch_iteration)

    def get_last_lr(self):
        assert getattr(self, "_last_lr", None) is not None, "need to call step() first"
        return self._last_lr

    def step(self, last_batch_iteration=None):
        self.last_batch_iteration = (self.last_batch_iteration + 1
                                     if last_batch_iteration is None else last_batch_iteration)
        lrs = self.get_lr()
        self._write_lrs(lrs)
        self._last_lr = lrs

    def _write_lrs(self, lrs):
        for group, lr in zip(self.optimizer.param_groups, lrs):
            group["lr"] = lr

    def _per_group(self, value, name="value"):
        """Broadcast a scalar (or check a list) across param groups."""
        n = len(self.optimizer.param_groups)
        if isinstance(value, (list, tuple)):
            if len(value) != n:
                raise ValueError(f"expected {n} values for {name}, got {len(value)}")
            return list(value)
        return [value] * n

    def state_dict(self):
        return {"last_batch_iteration": self.last_batch_iteration}

    def load_state_dict(self, sd):
        self.last_batch_iteration = sd["last_batch_iteration"]

    def as_schedule_fn(self):
        """Pure ``step -> lr`` (first param group) for jitted loops."""
        return lambda step: self._lr_at(int(step))[0]


class LRRangeTest(_LRScheduler):
    """Smith's LR range test: grow LR from the floor by ``step_rate``
    per interval, continuously or in stairs (reference lr_schedules.py:267)."""

    def __init__(self, optimizer, lr_range_test_min_lr=1e-3, lr_range_test_step_size=2000,
                 lr_range_test_step_rate=1.0, lr_range_test_staircase=False,
                 last_batch_iteration=-1):
        super().__init__(optimizer, last_batch_iteration)
        self.min_lr = self._per_group(lr_range_test_min_lr, LR_RANGE_TEST_MIN_LR)
        self.step_size = lr_range_test_step_size
        self.step_rate = lr_range_test_step_rate
        self.staircase = lr_range_test_staircase
        if last_batch_iteration == -1:
            self._write_lrs(self.min_lr)

    def _lr_at(self, step):
        interval = (step + 1) / self.step_size
        if self.staircase:
            interval = math.floor(interval)
        gain = 1 + self.step_rate * interval
        return [lr * gain for lr in self.min_lr]


class OneCycle(_LRScheduler):
    """1Cycle policy: triangular LR (and inverse momentum) cycle, then
    optional decay (reference lr_schedules.py:370)."""

    def __init__(self, optimizer, cycle_min_lr, cycle_max_lr, decay_lr_rate=0.0,
                 cycle_first_step_size=2000, cycle_second_step_size=None,
                 cycle_first_stair_count=0, cycle_second_stair_count=None,
                 decay_step_size=0, cycle_momentum=True, cycle_min_mom=0.8,
                 cycle_max_mom=0.9, decay_mom_rate=0.0, last_batch_iteration=-1):
        super().__init__(optimizer, last_batch_iteration)
        self.up_steps = float(cycle_first_step_size)
        self.down_steps = float(cycle_second_step_size
                                if cycle_second_step_size is not None else cycle_first_step_size)
        self.total_size = self.up_steps + self.down_steps
        self.step_ratio = self.up_steps / self.total_size
        self.first_stair_count = cycle_first_stair_count
        self.second_stair_count = (cycle_first_stair_count if cycle_second_stair_count is None
                                   else cycle_second_stair_count)
        self.decay_step_size = decay_step_size

        self.min_lrs = self._per_group(cycle_min_lr, CYCLE_MIN_LR)
        self.max_lrs = self._per_group(cycle_max_lr, CYCLE_MAX_LR)
        self.decay_lr_rate = decay_lr_rate
        if last_batch_iteration == -1:
            self._write_lrs(self.min_lrs)

        self.cycle_momentum = cycle_momentum
        if cycle_momentum:
            if "betas" not in getattr(optimizer, "defaults", {}):
                logger.warning(f"cycle_momentum disabled: optimizer {type(optimizer).__name__} "
                               "has no 'betas' default")
                self.cycle_momentum = False
            else:
                n_groups = len(self.optimizer.param_groups)
                self.min_moms = [(cycle_min_mom, 0.99)] * n_groups
                self.max_moms = [(cycle_max_mom, 0.99)] * n_groups
                self.decay_mom_rate = decay_mom_rate
                if last_batch_iteration == -1:
                    for group, betas in zip(optimizer.param_groups, self.min_moms):
                        group["betas"] = betas

    def _cycle_fraction(self, step):
        return _triangle(step + 1, self.up_steps, self.down_steps)

    def _decay_gain(self, step, rate):
        if not rate or not self.decay_step_size:
            return None
        past = step - self.total_size + 1
        return 1 + rate * past / self.decay_step_size

    def _lr_at(self, step):
        if step < self.total_size:
            frac = self._cycle_fraction(step)
            return [lo + (hi - lo) * frac for lo, hi in zip(self.min_lrs, self.max_lrs)]
        gain = self._decay_gain(step, self.decay_lr_rate)
        if gain is None:
            return list(self.min_lrs)
        return [lo / gain for lo in self.min_lrs]

    def get_mom(self):
        if not self.cycle_momentum:
            return None
        step = self.last_batch_iteration
        if step < self.total_size:
            # momentum runs counter to LR: high when LR is low
            frac = self._cycle_fraction(step)
            return [(hi[0] - (hi[0] - lo[0]) * frac, lo[1])
                    for lo, hi in zip(self.min_moms, self.max_moms)]
        gain = self._decay_gain(step, self.decay_mom_rate)
        if gain is None:
            return list(self.max_moms)
        return [(hi[0] * gain, hi[1]) for hi in self.max_moms]

    def step(self, batch_iteration=None):
        super().step(batch_iteration)
        if self.cycle_momentum:
            for group, betas in zip(self.optimizer.param_groups, self.get_mom()):
                group["betas"] = betas


class WarmupLR(_LRScheduler):
    """Ramp from min to max LR over warmup, then hold
    (reference lr_schedules.py:634)."""

    def __init__(self, optimizer, warmup_min_lr=0.0, warmup_max_lr=0.001,
                 warmup_num_steps=1000, warmup_type=WARMUP_LOG_RATE, last_batch_iteration=-1):
        super().__init__(optimizer, last_batch_iteration)
        self.min_lrs = self._per_group(warmup_min_lr, WARMUP_MIN_LR)
        self.max_lrs = self._per_group(warmup_max_lr, WARMUP_MAX_LR)
        self.delta_lrs = [hi - lo for lo, hi in zip(self.min_lrs, self.max_lrs)]
        self.warmup_num_steps = max(2, warmup_num_steps)
        if warmup_type not in (WARMUP_LOG_RATE, WARMUP_LINEAR_RATE):
            logger.warning(f"unknown warmup_type {warmup_type!r}; using '{WARMUP_LOG_RATE}'")
            warmup_type = WARMUP_LOG_RATE
        self.warmup_type = warmup_type
        self.inverse_log_warm_up = 1.0 / math.log(self.warmup_num_steps)
        if last_batch_iteration == -1:
            self._last_lr = [g["lr"] for g in self.optimizer.param_groups]
            self.step()

    def _post_warmup(self, step):
        return 1.0

    def _lr_at(self, step):
        if step < 0:
            logger.warning("LR requested before the scheduler's first step()")
            return [0.0]
        if step < self.warmup_num_steps:
            gamma = _warmup_fraction(step, self.warmup_num_steps, self.warmup_type)
        else:
            gamma = self._post_warmup(step)
        return [lo + d * gamma for lo, d in zip(self.min_lrs, self.delta_lrs)]


class WarmupDecayLR(WarmupLR):
    """Warmup then linear decay to zero by ``total_num_steps``
    (reference lr_schedules.py:723)."""

    def __init__(self, optimizer, total_num_steps, warmup_min_lr=0.0, warmup_max_lr=0.001,
                 warmup_num_steps=1000, warmup_type=WARMUP_LOG_RATE, last_batch_iteration=-1):
        self.total_num_steps = total_num_steps
        super().__init__(optimizer, warmup_min_lr, warmup_max_lr, warmup_num_steps,
                         warmup_type, last_batch_iteration)
        if total_num_steps < self.warmup_num_steps:
            logger.warning(f"total_num_steps {total_num_steps} < warmup_num_steps "
                           f"{self.warmup_num_steps}")

    def _post_warmup(self, step):
        decay_span = max(1.0, self.total_num_steps - self.warmup_num_steps)
        return max(0.0, (self.total_num_steps - step) / decay_span)


class WarmupCosineLR(_LRScheduler):
    """Warmup then cosine decay toward ``cos_min_ratio`` of the base LR
    (reference lr_schedules.py:774)."""

    def __init__(self, optimizer, total_num_steps, warmup_min_ratio=0.0,
                 warmup_num_steps=1000, cos_min_ratio=0.0001, warmup_type=WARMUP_LOG_RATE,
                 last_batch_iteration=-1):
        super().__init__(optimizer, last_batch_iteration)
        self.total_num_steps = total_num_steps
        self.warmup_min_ratio = warmup_min_ratio
        self.warmup_num_steps = max(2, warmup_num_steps)
        self.cos_min_ratio = cos_min_ratio
        self.warmup_type = warmup_type
        if total_num_steps < self.warmup_num_steps:
            logger.warning(f"total_num_steps {total_num_steps} < warmup_num_steps "
                           f"{self.warmup_num_steps}")
        self.org_lrs = [g["lr"] for g in self.optimizer.param_groups]
        if last_batch_iteration == -1:
            self._last_lr = list(self.org_lrs)
            self.step()

    def get_lr_ratio(self):
        return self._ratio_at(self.last_batch_iteration)

    def _ratio_at(self, step):
        if step < self.warmup_num_steps:
            ramp = _warmup_fraction(step, self.warmup_num_steps, self.warmup_type)
            return self.warmup_min_ratio + (1.0 - self.warmup_min_ratio) * ramp
        progress = (step - self.warmup_num_steps + 1) / (self.total_num_steps - self.warmup_num_steps)
        cos = (1 + math.cos(math.pi * progress)) / 2
        return max(0.0, self.cos_min_ratio + (1.0 - self.cos_min_ratio) * cos)

    def _lr_at(self, step):
        if step < 0:
            logger.warning("LR requested before the scheduler's first step()")
            return [0.0]
        ratio = self._ratio_at(step)
        return [lr * ratio for lr in self.org_lrs]
