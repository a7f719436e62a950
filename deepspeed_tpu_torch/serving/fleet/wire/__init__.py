"""Cross-process fleet wire transport.

Port of ``deepspeed_tpu/serving/fleet/wire``. The fleet layer (router /
health / handoff / refresh) speaks to replicas through the
:class:`~deepspeed_tpu_torch.serving.fleet.replica.Replica` seam. This
package moves that seam across a process boundary without the fleet
noticing:

- :mod:`codec` — length-prefixed frames, msgpack-or-JSON payloads,
  bit-identical tensor and ndarray round-trips (the JAX package's
  frames);
- :mod:`errors` — the typed wire-error taxonomy (every
  ``ServingError`` crosses as data and rebuilds as the same type);
- :class:`ReplicaServer` — worker-side: a real ``ServingGateway``
  (via ``GatewayReplica``) served over a socket
  (``python -m deepspeed_tpu_torch.serving.fleet.wire.ds_replica`` is
  the process entry point);
- :class:`WireReplica` — router-side client: per-request relay,
  deadline-bounded I/O, reconnect with backoff;
- :class:`FleetSupervisor` — spawns/monitors/relaunches the replica
  processes (heartbeat watchdog, SIGTERM→grace→SIGKILL, failure
  budget).

``DS_FLEET_TRANSPORT`` selects the transport (default/unset and
``inproc`` build the exact in-process fleet; ``wire`` selects the
cross-process client).
"""

from deepspeed_tpu_torch.serving.fleet.wire.client import PublicationRef, WireReplica
from deepspeed_tpu_torch.serving.fleet.wire.errors import WireProtocolError, WireTimeoutError
from deepspeed_tpu_torch.serving.fleet.wire.server import ReplicaServer
from deepspeed_tpu_torch.serving.fleet.wire.supervisor import FleetSupervisor, ReplicaProcSpec
from deepspeed_tpu_torch.utils.env_registry import env_raw

__all__ = [
    "FleetSupervisor",
    "PublicationRef",
    "ReplicaProcSpec",
    "ReplicaServer",
    "WireProtocolError",
    "WireReplica",
    "WireTimeoutError",
    "make_replica",
    "transport_mode",
]


def transport_mode():
    """The fleet transport selected by ``DS_FLEET_TRANSPORT``:
    ``"inproc"`` (default — unset behaves identically) or ``"wire"``."""
    mode = env_raw("DS_FLEET_TRANSPORT") or "inproc"
    if mode not in ("inproc", "wire"):
        raise ValueError(
            f"DS_FLEET_TRANSPORT={mode!r}: expected 'inproc' or 'wire'")
    return mode


def make_replica(name, engine_factory=None, serving_config=None, *,
                 role=None, address=None, mode=None, **kwargs):
    """Transport-selected replica factory.

    ``inproc`` (the default / knob-off state) returns a plain
    :class:`~deepspeed_tpu_torch.serving.fleet.replica.GatewayReplica`
    built exactly as the in-process fleet builds it. ``wire`` returns a
    :class:`WireReplica` client for ``address`` (a replica server the
    :class:`FleetSupervisor` — or the caller — already launched)."""
    mode = mode or transport_mode()
    if mode == "inproc":
        if engine_factory is None:
            raise ValueError(
                "inproc transport builds the gateway locally: "
                "engine_factory is required")
        from deepspeed_tpu_torch.serving.fleet.replica import GatewayReplica
        return GatewayReplica(name, engine_factory, serving_config,
                              role=role, **kwargs)
    if address is None:
        raise ValueError("wire transport connects to a replica server: "
                         "address is required")
    return WireReplica(name, address, role=(role or "unified"), **kwargs)
