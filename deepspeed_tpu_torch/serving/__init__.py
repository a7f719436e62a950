"""The serving stack above the ragged engine.

Port of ``deepspeed_tpu/serving``: the request-level gateway
(:class:`ServingGateway`: submit from any thread, stream tokens through a
:class:`RequestHandle`, KV-aware admission with priority preemption,
drain, and the staged no-drain weight refresh), its config, admission
control and SLO metrics, the in-process fleet (:mod:`.fleet`: the router
with failover, rolling restart, prefix-aware and disaggregated placement
over gateway replicas), live weight refresh (:mod:`.refresh`: the
publisher and the fleet's rolling refresh controller with its canary),
and multi-tenant LoRA serving with its disk tier (:mod:`.lora`). The
fleet's wire protocol and the serving autotuner are not ported yet
(ROADMAP.md, port queue item 4)."""

from deepspeed_tpu_torch.serving.admission import (AdmissionQueue, CapacityGate,
                                                   DeadlineExceededError, GatewayClosedError,
                                                   GatewayFailedError, QueueFullError,
                                                   RequestCancelledError, RequestShedError,
                                                   RequestTooLargeError, ServingError)
from deepspeed_tpu_torch.serving.config import (ServingAutotuneConfig, ServingConfig,
                                                get_serving_config)
from deepspeed_tpu_torch.serving.fleet import (FaultyReplica, FleetConfig, FleetRouter,
                                               GatewayReplica, HandoffFailedError,
                                               HandoffManager, PoolScheduler, Replica,
                                               ReplicaHealth, get_fleet_config)
from deepspeed_tpu_torch.serving.gateway import RequestHandle, ServingGateway
from deepspeed_tpu_torch.serving.metrics import ServingMetrics
from deepspeed_tpu_torch.serving.refresh import (CanaryDivergenceError, FleetRefreshController,
                                                 WeightPublisher, WeightRefreshError)

__all__ = [
    "ServingGateway", "RequestHandle", "ServingConfig",
    "ServingAutotuneConfig", "get_serving_config",
    "ServingMetrics", "AdmissionQueue", "CapacityGate", "ServingError",
    "GatewayClosedError", "GatewayFailedError", "QueueFullError",
    "RequestTooLargeError", "RequestShedError", "RequestCancelledError",
    "DeadlineExceededError",
    "FleetRouter", "FleetConfig", "get_fleet_config", "Replica",
    "GatewayReplica", "FaultyReplica", "ReplicaHealth",
    "PoolScheduler", "HandoffManager", "HandoffFailedError",
    "WeightPublisher", "FleetRefreshController",
    "WeightRefreshError", "CanaryDivergenceError",
]
