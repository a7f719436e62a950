"""Fleet router config (the ``fleet`` ds_config block).

Port of ``deepspeed_tpu/serving/fleet/config.py``, whose model is
pydantic, as a dataclass (the port has no pydantic), as
``serving/config.py`` is: every field, default and bound of the JAX
model and its cross-field checks, checked at construction. A value out of
its bound or a failed cross-field check raises ``ValueError`` (pydantic's
``ValidationError`` is one too). An unknown key is kept as an attribute,
as the JAX base model's ``extra="allow"`` keeps it.
"""

from dataclasses import MISSING, dataclass, field, fields
from typing import Dict

from deepspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigModel
from deepspeed_tpu_torch.serving.config import _bounded

_ROLES = ("prefill", "decode", "unified")


def get_fleet_config(param_dict):
    """Extract + validate the ``fleet`` block of a ds_config dict."""
    return FleetConfig(**param_dict.get("fleet", {}))


@dataclass(init=False)
class FleetConfig(DeepSpeedConfigModel):
    """Knobs for :class:`FleetRouter` and per-replica health tracking.

    Health model: ``degraded_after`` consecutive failures moves a
    replica HEALTHY -> DEGRADED (still routable, deprioritized);
    ``down_after`` — or any *fatal* failure (replica process death) —
    moves it to DOWN. A DOWN replica is probed half-open: after
    ``probe_backoff_s`` (doubling by ``probe_backoff_mult`` per failed
    probe, capped at ``probe_backoff_max_s``) one probe is sent;
    ``recovery_probes`` consecutive successes restore HEALTHY.

    Retry model: a request gets ``max_attempts`` placements total. Each
    failover waits ``retry_backoff_s * retry_backoff_mult**(attempt-1)``
    (capped at ``retry_backoff_max_s``) scaled by up to ``retry_jitter``
    relative jitter, and is abandoned with the *original* typed error
    semantics if the request deadline would be blown first.
    """

    # -- health state machine ----------------------------------------
    heartbeat_interval_s: float = 0.5   # > 0
    degraded_after: int = 2             # >= 1
    down_after: int = 4                 # >= 1
    probe_backoff_s: float = 0.25       # > 0
    probe_backoff_mult: float = 2.0     # >= 1
    probe_backoff_max_s: float = 30.0   # > 0
    recovery_probes: int = 2            # >= 1

    # -- failover / retry --------------------------------------------
    max_attempts: int = 4               # >= 1
    retry_backoff_s: float = 0.02       # >= 0
    retry_backoff_mult: float = 2.0     # >= 1
    retry_backoff_max_s: float = 2.0    # > 0
    retry_jitter: float = 0.25          # in [0, 1]
    # a live stream that produces nothing for this long is declared
    # stalled: the attempt is cancelled and failed over (hang detection)
    stream_token_timeout_s: float = 30.0  # > 0

    # -- placement ---------------------------------------------------
    prefix_routing: bool = True  # also gated by DS_FLEET_PREFIX_ROUTING

    # -- rolling restart ---------------------------------------------
    restart_drain_timeout_s: float = 120.0  # > 0

    # -- disaggregated prefill/decode serving ------------------------
    # also gated by DS_DISAGG (tri-state env override, wins both ways)
    disagg: bool = False
    # replica name -> pool role; replicas not listed here fall back to
    # the replica object's own ``role`` attribute ("unified" default)
    roles: Dict[str, str] = field(default_factory=dict)
    # tokens the prefill stage emits before handing off (>=1 so first-
    # token logits exist and the decode stage has a prefix to verify)
    prefill_max_tokens: int = 1         # >= 1
    # a published handoff the decode stage cannot claim within this
    # budget is expired and the request re-planned (DS_DISAGG_HANDOFF_
    # DEADLINE_S overrides when > 0)
    handoff_deadline_s: float = 5.0     # > 0
    # hysteresis: consecutive disagg failures before degrading to
    # unified mode / consecutive probe successes before recovering /
    # probe cadence while degraded
    disagg_fallback_after: int = 2      # >= 1
    disagg_recover_after: int = 2       # >= 1
    disagg_probe_every: int = 4         # >= 1

    # -- live weight refresh ------------------------------------------
    # canary gate: verify the first refreshed replica's greedy output
    # bit-identically against a cold-started engine on the new weights
    # before the rollout proceeds (DS_REFRESH_CANARY overrides, tri-
    # state, wins both ways)
    refresh_canary: bool = True
    # per-replica budget for a staged weight swap to land; a replica
    # that blows it is retried and eventually demoted, never rolled
    # back fleet-wide (DS_REFRESH_TIMEOUT_S overrides when > 0)
    refresh_timeout_s: float = 30.0     # > 0
    # consecutive refresh attempts a replica may fail to converge to
    # the target version before it is demoted through the health state
    # machine (fatal failure -> DOWN, half-open probing takes over)
    refresh_demote_after: int = 2       # >= 1
    # greedy tokens per canary prompt; small keeps the gate cheap,
    # but it must be >= 1 so divergence is observable at all
    refresh_canary_max_new: int = 8     # >= 1

    # -- request defaults (resolved at the ROUTER so every failover
    #    attempt replays with identical parameters even across replicas
    #    with different ServingConfig defaults) -----------------------
    default_max_new_tokens: int = 16    # >= 1
    default_priority: int = 0

    def __init__(self, **data):
        for f in fields(self):
            if f.name in data:
                value = data.pop(f.name)
            elif f.default_factory is not MISSING:
                value = f.default_factory()
            else:
                value = f.default
            setattr(self, f.name, value)
        for name, value in data.items():  # extra="allow"
            setattr(self, name, value)
        self.__post_init__()

    def __post_init__(self):
        super().__post_init__()
        for name in ("heartbeat_interval_s", "probe_backoff_s", "probe_backoff_max_s",
                     "retry_backoff_max_s", "stream_token_timeout_s",
                     "restart_drain_timeout_s", "handoff_deadline_s", "refresh_timeout_s"):
            _bounded(self, name, float, gt=0)
        for name in ("probe_backoff_mult", "retry_backoff_mult"):
            _bounded(self, name, float, ge=1.0)
        _bounded(self, "retry_backoff_s", float, ge=0)
        _bounded(self, "retry_jitter", float, ge=0, le=1.0)
        for name in ("degraded_after", "down_after", "recovery_probes", "max_attempts",
                     "prefill_max_tokens", "disagg_fallback_after", "disagg_recover_after",
                     "disagg_probe_every", "refresh_demote_after", "refresh_canary_max_new",
                     "default_max_new_tokens"):
            _bounded(self, name, int, ge=1)
        _bounded(self, "default_priority", int)
        if not isinstance(self.roles, dict) or \
                not all(isinstance(k, str) and isinstance(v, str) for k, v in self.roles.items()):
            raise ValueError(f"fleet.roles={self.roles!r}: must map replica names to roles")
        if self.degraded_after > self.down_after:
            raise ValueError(
                f"fleet.degraded_after ({self.degraded_after}) must be <= "
                f"fleet.down_after ({self.down_after}) — a replica cannot go "
                f"DOWN before it is DEGRADED")
        if self.probe_backoff_s > self.probe_backoff_max_s:
            raise ValueError(
                f"fleet.probe_backoff_s ({self.probe_backoff_s}) exceeds "
                f"fleet.probe_backoff_max_s ({self.probe_backoff_max_s})")
        for name, role in self.roles.items():
            if role not in _ROLES:
                raise ValueError(
                    f"fleet.roles[{name!r}] = {role!r} is not one of "
                    f"{_ROLES}")
