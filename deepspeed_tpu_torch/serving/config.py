"""Serving gateway config (the ``serving`` ds_config block).

Port of ``deepspeed_tpu/serving/config.py``, whose models are pydantic, as
dataclasses (the port has no pydantic): every field, default, bound and
cross-field check of the JAX models, checked at construction. A value
out of its bound or a failed cross-field check raises ``ValueError``
(pydantic's ``ValidationError`` is one too); an unknown key raises
``TypeError`` (the dataclass constructor's own check, as every section of
the port's configs).
"""

from dataclasses import dataclass, field
from typing import Optional

from deepspeed_tpu_torch.inference.sampling import validate_sample_spec
from deepspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigModel

ADMISSION_POLICIES = ("reject", "shed", "block")


def get_serving_config(param_dict):
    """Extract + validate the ``serving`` block of a ds_config dict."""
    return ServingConfig(**param_dict.get("serving", {}))


def _bounded(section, name, kind, ge=None, gt=None, le=None):
    """Coerce ``section.name`` to ``kind`` (pydantic's lax mode: an int
    field takes an integral float or a numeric string) and check its
    bound."""
    value = getattr(section, name)
    try:
        coerced = kind(value)
        if kind is int and (isinstance(value, bool) or coerced != float(value)):
            raise ValueError
    except (TypeError, ValueError):
        raise ValueError(f"{type(section).__name__}.{name}={value!r}: not a valid "
                         f"{kind.__name__}") from None
    if ge is not None and coerced < ge:
        raise ValueError(f"{type(section).__name__}.{name}={value!r}: must be >= {ge}")
    if gt is not None and coerced <= gt:
        raise ValueError(f"{type(section).__name__}.{name}={value!r}: must be > {gt}")
    if le is not None and coerced > le:
        raise ValueError(f"{type(section).__name__}.{name}={value!r}: must be <= {le}")
    setattr(section, name, coerced)


@dataclass
class ServingAutotuneConfig(DeepSpeedConfigModel):
    """The online SLO controller's targets and hysteresis (the
    ``serving.autotune`` sub-block). ``enabled`` defers to the
    ``DS_AUTOTUNE`` tri-state knob — env set wins in both directions.

    Tick counts, not seconds, parameterize the hysteresis so the same
    config behaves identically under any ``interval_s``: a knob steps
    DOWN only after ``breach_ticks`` consecutive breached samples, UP
    only after ``clear_ticks`` consecutive healthy ones, every move is
    followed by a ``cooldown_ticks`` hold, and ``rollback_ticks``
    consecutive breaches trip the hard guard (defaults restored, the
    controller freezes). The controller itself is not ported yet: a
    gateway whose autotuning is on raises."""

    enabled: bool = False
    interval_s: float = 0.25          # > 0
    p99_ttft_slo_ms: float = 500.0    # > 0
    breach_ticks: int = 2             # >= 1
    clear_ticks: int = 4              # >= 1
    cooldown_ticks: int = 2           # >= 0
    rollback_ticks: int = 8           # >= 1
    min_token_budget: int = 0         # >= 0; 0 = one KV block
    min_queue_depth: int = 1          # >= 1
    min_draft_len: int = 1            # >= 1

    def __post_init__(self):
        super().__post_init__()
        _bounded(self, "interval_s", float, gt=0)
        _bounded(self, "p99_ttft_slo_ms", float, gt=0)
        for name, lo in (("breach_ticks", 1), ("clear_ticks", 1), ("cooldown_ticks", 0),
                         ("rollback_ticks", 1), ("min_token_budget", 0),
                         ("min_queue_depth", 1), ("min_draft_len", 1)):
            _bounded(self, name, int, ge=lo)
        if self.rollback_ticks < self.breach_ticks:
            raise ValueError(
                f"serving.autotune.rollback_ticks ({self.rollback_ticks}) "
                f"must be >= breach_ticks ({self.breach_ticks}) — rollback "
                f"is the guard behind stepping, not in front of it")


@dataclass
class ServingConfig(DeepSpeedConfigModel):
    """Request-level front-end knobs for :class:`ServingGateway`.

    ``admission_policy`` decides what ``submit()`` does when the wait
    queue is full:

    - ``"reject"``  — raise :class:`QueueFullError` immediately;
    - ``"shed"``    — evict the lowest-priority queued request (only if
      it is strictly lower priority than the new one, else reject);
    - ``"block"``   — block the submitting thread up to
      ``block_timeout_s``, then raise :class:`QueueFullError`.
    """

    # -- pool role (disaggregated serving) ---------------------------
    # "unified" serves prefill+decode; "prefill" gateways export a KV
    # handoff record when a request finishes; "decode" gateways import
    # peer records before admission. The fleet router sets this.
    role: str = "unified"

    # -- admission / backpressure ------------------------------------
    max_queue_depth: int = 256        # >= 1
    admission_policy: str = "reject"
    block_timeout_s: float = 30.0     # > 0
    # preempt (KV-suspend) the lowest-priority running request when a
    # strictly higher-priority one cannot otherwise be admitted
    allow_preemption: bool = True

    # -- scheduling --------------------------------------------------
    token_budget: int = 0             # >= 0; 0 = engine max_tokens
    max_burst: int = 16               # >= 1
    eos_token_id: Optional[int] = None
    sampling: Optional[dict] = None  # on-device stochastic sampling spec
    # tokenizer surface (token id -> string) for compiling raw
    # grammar/JSON-schema constraints at submit; None = only
    # precompiled CompiledSchema objects are accepted per request
    token_strings: Optional[list] = None
    default_max_new_tokens: int = 16  # >= 1
    default_priority: int = 0

    # -- lifecycle / pump --------------------------------------------
    drain_timeout_s: float = 120.0    # > 0
    idle_poll_s: float = 0.001        # > 0; pump wait when no work

    # -- autotuning --------------------------------------------------
    # online SLO controller (token budget / admission depth / spec
    # draft length adjusted live against p99 TTFT); the DS_AUTOTUNE
    # env knob overrides `enabled` in both directions
    autotune: ServingAutotuneConfig = field(default_factory=ServingAutotuneConfig)

    # -- metrics -----------------------------------------------------
    metrics_window: int = 1024        # >= 16; percentile reservoir size
    # publish metrics through monitor.write_events() every N engine
    # steps; 0 disables periodic publishing (snapshot() still works)
    metrics_interval_steps: int = 0   # >= 0

    def __post_init__(self):
        super().__post_init__()
        for name, lo in (("max_queue_depth", 1), ("token_budget", 0), ("max_burst", 1),
                         ("default_max_new_tokens", 1), ("metrics_window", 16),
                         ("metrics_interval_steps", 0)):
            _bounded(self, name, int, ge=lo)
        _bounded(self, "default_priority", int)
        for name in ("block_timeout_s", "drain_timeout_s", "idle_poll_s"):
            _bounded(self, name, float, gt=0)
        if self.eos_token_id is not None:
            _bounded(self, "eos_token_id", int)
        if self.role not in ("unified", "prefill", "decode"):
            raise ValueError(
                f"serving.role={self.role!r}: must be one of "
                f"('unified', 'prefill', 'decode')")
        if self.admission_policy not in ADMISSION_POLICIES:
            raise ValueError(
                f"serving.admission_policy={self.admission_policy!r}: must be one "
                f"of {ADMISSION_POLICIES}")
        if self.sampling is not None:
            validate_sample_spec(self.sampling)
