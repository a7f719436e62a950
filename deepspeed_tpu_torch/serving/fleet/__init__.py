"""Fault-tolerant multi-replica serving fleet (the MII/FastGen
deployment-layer analogue above :class:`ServingGateway`).

Port of ``deepspeed_tpu/serving/fleet``: the in-process fleet. The wire
protocol that puts replicas in processes of their own
(``deepspeed_tpu/serving/fleet/wire``) is not ported yet (ROADMAP.md,
port queue item 4).

- :class:`Replica` / :class:`GatewayReplica` — the engine-facing half of
  the serving stack as a restartable unit; single-replica mode is the
  N=1 case.
- :class:`FleetRouter` — health-checked routing (HEALTHY/DEGRADED/DOWN
  with half-open recovery probing), prefix-cache-aware placement,
  deadline-budgeted failover retries that replay mid-stream crashes on a
  surviving replica without double-emitting tokens, and rolling restart.
- :class:`FaultyReplica` — deterministic scripted fault injection
  (crash-at-token-k, hang, slow decode, reject bursts, dropped/torn/
  delayed KV handoffs) so every failure path above is tested.
- :class:`PoolScheduler` / :class:`HandoffManager` — disaggregated
  prefill/decode pool policy (hysteresis-gated unified fallback) and the
  deadline-bounded prefill→decode KV handoff ledger."""

from deepspeed_tpu_torch.serving.fleet.config import FleetConfig, get_fleet_config
from deepspeed_tpu_torch.serving.fleet.handoff import (HandoffFailedError, HandoffManager,
                                                       PoolScheduler)
from deepspeed_tpu_torch.serving.fleet.health import (DEGRADED, DOWN, HEALTHY, RESTARTING,
                                                      ReplicaHealth)
from deepspeed_tpu_torch.serving.fleet.replica import (FaultyReplica, GatewayReplica, Replica,
                                                       ReplicaDiedError, ReplicaRestartingError,
                                                       StreamStalledError)
from deepspeed_tpu_torch.serving.fleet.router import (FleetFailedError, FleetHandle, FleetRouter,
                                                      NoReplicaAvailableError,
                                                      ReplayDivergenceError)

__all__ = [
    "FleetRouter", "FleetHandle", "FleetConfig", "get_fleet_config",
    "Replica", "GatewayReplica", "FaultyReplica", "ReplicaHealth",
    "HEALTHY", "DEGRADED", "DOWN", "RESTARTING",
    "ReplicaDiedError", "ReplicaRestartingError", "StreamStalledError",
    "NoReplicaAvailableError", "FleetFailedError", "ReplayDivergenceError",
    "PoolScheduler", "HandoffManager", "HandoffFailedError",
]
