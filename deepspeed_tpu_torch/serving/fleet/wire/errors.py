"""Typed wire-error taxonomy.

Port of ``deepspeed_tpu/serving/fleet/wire/errors.py``. The fleet's
routing decisions are driven by machine-readable error metadata —
``reason``, ``retry_elsewhere``, and the numeric hints in ``details``
(queue depth, estimated wait, evictable KV blocks). When a replica moves
out of process those errors cross the wire as data, and this module is
the round-trip: :func:`encode_error` flattens any raised exception into a
payload dict, :func:`decode_error` rebuilds the *same type* with the
*same message and hint fields* on the client, so
``FleetRouter._note_failure`` and the admission backoff logic behave
identically whether the replica was a local object or a process across
a socket.

Decoding is closed over an explicit registry (every ``ServingError``
subclass, plus the typed trust-boundary rejections the handoff and
refresh validators raise, plus ``TimeoutError`` for refresh deadlines).
An unknown code — a future peer speaking a newer taxonomy — maps to
:class:`WireProtocolError` with the remote code preserved in
``details``, never to a bare ``Exception``. The codes are class names,
so a port process and a JAX one understand each other's errors; the
port's registry holds one name the JAX registry lacks,
``SanitizerIndexError`` (the port's index check before a gather).
"""

from deepspeed_tpu_torch.serving.admission import ServingError


class WireProtocolError(ServingError):
    """The byte stream itself went wrong: torn frame, garbage header,
    version mismatch, or an error code this build does not know. The
    peer connection is suspect; the request may be retried elsewhere."""
    reason = "wire_protocol"
    retry_elsewhere = True


class WireTimeoutError(ServingError):
    """A unary wire call (probe / load / handoff claim / refresh ack)
    blew its I/O deadline (``DS_WIRE_TIMEOUT_S``). The replica may be
    alive but unreachable — the health layer decides; the request may
    be retried elsewhere."""
    reason = "wire_timeout"
    retry_elsewhere = True


_registry_cache = None


def _error_registry():
    """name → class for every error type the wire round-trips.

    Built lazily (the replica/router/refresh modules import the serving
    stack) and exhaustively: the recursive ``ServingError`` subclass
    walk picks up any error added to an already-imported serving module
    without this file changing.
    """
    global _registry_cache
    if _registry_cache is not None:
        return _registry_cache
    # import every module that defines ServingError subclasses so the
    # subclass walk is complete
    import deepspeed_tpu_torch.serving.admission  # noqa: F401
    import deepspeed_tpu_torch.serving.fleet.handoff  # noqa: F401
    import deepspeed_tpu_torch.serving.fleet.replica  # noqa: F401
    import deepspeed_tpu_torch.serving.fleet.router  # noqa: F401
    import deepspeed_tpu_torch.serving.lora.store  # noqa: F401
    import deepspeed_tpu_torch.serving.refresh.controller  # noqa: F401
    from deepspeed_tpu_torch.inference.structured.grammar import SchemaCompileError
    from deepspeed_tpu_torch.utils import sanitize as _sanitize

    registry = {}

    def walk(cls):
        registry[cls.__name__] = cls
        for sub in cls.__subclasses__():
            walk(sub)

    walk(ServingError)
    # trust-boundary rejections that cross the wire typed: the whole
    # SanitizerError family (a decode replica rejecting a forged
    # handoff record, a torn weight publication, a DS_SANITIZE worker
    # tripping an invariant mid-request), the structured-decoding
    # compile rejection (raised at remote submit — retry_elsewhere is
    # FALSE: a malformed schema is malformed fleet-wide), and
    # ``TimeoutError`` for refresh deadlines
    walk(_sanitize.SanitizerError)
    registry["SchemaCompileError"] = SchemaCompileError
    registry["TimeoutError"] = TimeoutError
    if _sanitize.sanitize_enabled():
        # asserted complete against the live subclass walk exactly once,
        # before the cache is published
        _sanitize.check_error_registry(registry, ServingError)
    _registry_cache = registry
    return registry


def encode_error(exc):
    """Exception → wire payload dict (codec-safe values only)."""
    if isinstance(exc, ServingError):
        return {"code": type(exc).__name__, "message": str(exc),
                "reason": exc.reason,
                "retry_elsewhere": bool(exc.retry_elsewhere),
                "details": dict(exc.details)}
    return {"code": type(exc).__name__, "message": str(exc),
            "reason": getattr(exc, "reason", "remote_error"),
            "retry_elsewhere": bool(getattr(exc, "retry_elsewhere", True)),
            "details": {}}


def decode_error(payload):
    """Wire payload dict → exception instance of the original type.

    Unknown codes come back as :class:`WireProtocolError` carrying the
    remote code/reason in ``details`` — typed, actionable, and safely
    retryable — never as a bare ``Exception``."""
    code = payload.get("code")
    message = payload.get("message", "")
    details = payload.get("details") or {}
    cls = _error_registry().get(code)
    if cls is None:
        return WireProtocolError(
            f"peer raised unknown error code {code!r}: {message}",
            remote_code=code, remote_reason=payload.get("reason"),
            remote_retry_elsewhere=payload.get("retry_elsewhere"),
            **details)
    if issubclass(cls, ServingError):
        return cls(message, **details)
    return cls(message)
