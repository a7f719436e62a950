"""Serving errors.

Port of ``ServingError`` from ``deepspeed_tpu/serving/admission.py``, copied
as it is; the admission queue and capacity gate are not ported yet
(ROADMAP.md, port queue item 4)."""


class ServingError(RuntimeError):
    """Base for all gateway-surfaced request errors.

    Every serving error is machine-readable so routing layers (the fleet
    router) can act on it without string matching:

    - ``reason`` — a stable snake_case identifier for the failure class;
    - ``retry_elsewhere`` — whether a *different* replica could
      plausibly serve this request (a full queue here is not a full
      queue everywhere) or the condition is fleet-wide / terminal
      (too large for the model, cancelled, deadline blown);
    - ``details`` — numeric hints attached at the raise site (queue
      depth, evictable KV blocks, estimated wait) that let a router
      pick between "retry elsewhere", "back off and retry here", and
      "shed fleet-wide".
    """

    reason = "serving_error"
    retry_elsewhere = False

    def __init__(self, message, **details):
        super().__init__(message)
        self.details = details
