"""Live weight refresh.

Port of ``deepspeed_tpu/serving/refresh``:

- :class:`WeightPublisher` — versioned, integrity-checked weight
  publications with chained content hashes (atomic commit; torn or
  forged publications rejected typed with nothing adopted). A gateway
  applies one with ``ServingGateway.refresh_weights``
  (``serving/gateway.py``) through the engine's ``swap_params``.
- :class:`FleetRefreshController` — rolling no-drain rollout across a
  serving fleet: per-replica in-place param swap with version-tagged KV
  invalidation, a bit-identical canary gate against a cold-started
  reference, automatic fleet-wide rollback, and health demotion for
  replicas that will not converge."""

from deepspeed_tpu_torch.serving.refresh.controller import (CanaryDivergenceError,
                                                            FleetRefreshController,
                                                            WeightRefreshError)
from deepspeed_tpu_torch.serving.refresh.publisher import WeightPublisher

__all__ = [
    "WeightPublisher", "FleetRefreshController",
    "WeightRefreshError", "CanaryDivergenceError",
]
