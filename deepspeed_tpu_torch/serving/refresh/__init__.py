"""Live weight refresh.

Port of ``deepspeed_tpu/serving/refresh``: :class:`WeightPublisher` —
versioned, integrity-checked weight publications with chained content
hashes (atomic commit; torn or forged publications rejected typed with
nothing adopted). A gateway applies one with
``ServingGateway.refresh_weights`` (``serving/gateway.py``) through the
engine's ``swap_params``. The fleet's rolling rollout
(``FleetRefreshController`` and its two error classes) waits for the fleet
(ROADMAP.md, port queue item 4, step 7)."""

from deepspeed_tpu_torch.serving.refresh.publisher import WeightPublisher

__all__ = ["WeightPublisher"]
