"""The ``Replica`` seam between the fleet router and serving gateways.

Port of ``deepspeed_tpu/serving/fleet/replica.py``, copied as it is but
for the serving config, a dataclass in the port (``dataclasses.replace``
for pydantic's ``model_copy``). An engine factory that serves from a
device param tree can hand every build the same tree: the engine's
``_place_params`` moves nothing that already lies on its device in its
dtype, so a restart on the card places no second copy of the weights.

A :class:`Replica` is the engine-facing half of the serving stack viewed
from above: something you can submit to, probe, measure, drain and
restart. :class:`GatewayReplica` is the real implementation — it owns a
:class:`ServingGateway` (and, via an injected factory, the engine under
it) and can rebuild the whole stack for rolling restarts.
Single-replica serving is just the N=1 case of the router over one of
these.

:class:`FaultyReplica` wraps any replica with *deterministic, scripted*
failures — crash on the k-th generated token, hang mid-stream, decode in
slow motion, reject a burst of submits — so every failover path in the
router is exercised by tests rather than hoped about. It composes with
the shared :class:`FaultInjector` harness (``hook=``) used by the nebula
checkpoint tests.
"""

import dataclasses
import queue as _queue
import threading
import time

from deepspeed_tpu_torch.serving.admission import QueueFullError, ServingError
from deepspeed_tpu_torch.serving.config import ServingConfig
from deepspeed_tpu_torch.serving.gateway import ServingGateway
from deepspeed_tpu_torch.utils.logging import logger
from deepspeed_tpu_torch.utils.sanitize import WeightPublicationError, tracked_lock


# ---------------------------------------------------------------------- errors
class ReplicaDiedError(ServingError):
    """The replica process/engine died; in-flight streams are torn."""
    reason = "replica_died"
    retry_elsewhere = True


class ReplicaRestartingError(ServingError):
    """The replica is being restarted; queued work was handed back."""
    reason = "replica_restarting"
    retry_elsewhere = True


class StreamStalledError(ServingError):
    """A live stream produced nothing for stream_token_timeout_s — the
    replica is presumed hung; the attempt is failed over."""
    reason = "stream_stalled"
    retry_elsewhere = True


# ----------------------------------------------------------------- interface
class Replica:
    """What the router needs from one serving replica. Implementations
    must be thread-safe: ``submit`` arrives from per-request relay
    threads while ``probe``/``load`` arrive from the heartbeat thread."""

    name = "replica"
    # disagg pool membership hint ("unified" | "prefill" | "decode");
    # FleetConfig.roles overrides per name at the router
    role = "unified"

    def submit(self, prompt_tokens, max_new_tokens=None, priority=None,
               deadline_ms=None, adapter_id=None, sample=None, schema=None):
        """→ a :class:`RequestHandle`-shaped streaming handle. Raises a
        :class:`ServingError` subclass when not accepted. ``sample``
        always arrives with its seed already resolved (the router
        derives it from the router uid) so every failover attempt
        draws the identical stream."""
        raise NotImplementedError

    def has_adapter(self, adapter_id):
        """True when this replica's hot adapter set holds ``adapter_id``
        (the adapter-affine placement signal). Must never create state."""
        return False

    def prefetch_adapter(self, adapter_id):
        """Fire-and-forget: warm ``adapter_id`` toward this replica's
        hot set so a follow-up placement finds it resident."""
        return None

    def take_handoff(self, uid):
        """Claim the exported KV handoff record for gateway-local
        ``uid`` (prefill role); None when none was published."""
        return None

    def import_handoff(self, record):
        """Adopt a peer's KV handoff record (decode role). → blocks
        adopted; validation errors propagate."""
        return 0

    def prefix_match_len(self, prompt_tokens):
        """Read-only: leading prompt tokens whose KV this replica
        already caches (the placement signal). Must never create state."""
        raise NotImplementedError

    def load(self):
        """Scalar load estimate (queued + active requests)."""
        raise NotImplementedError

    def alive(self):
        """Cheap liveness: is the replica accepting work right now?"""
        raise NotImplementedError

    def probe(self):
        """Active health probe (heartbeat / half-open recovery check)."""
        raise NotImplementedError

    def drain(self, timeout=None):
        raise NotImplementedError

    def shutdown(self):
        raise NotImplementedError

    def kill(self, error=None):
        """Simulated/forced ungraceful death (fails all in-flight)."""
        raise NotImplementedError

    def restart(self, timeout=None, shed_error=None):
        """Rolling-restart this replica: hand queued work back to the
        caller (typed retryable errors), drain active work, rebuild."""
        raise NotImplementedError

    def refresh(self, params, version, timeout=None):
        """Stage a live weight swap: adopt ``params`` as weight version
        ``version`` WITHOUT draining — in-flight streams finish on the
        old weights, queued requests wait out the swap, nothing is
        shed. Returns the adopted version; raises on failure with
        nothing adopted."""
        raise NotImplementedError

    def weight_version(self):
        """The weight version this replica currently serves (0 =
        as-built weights, never refreshed)."""
        return 0

    def stats(self):
        return {}


# ------------------------------------------------------------- gateway-backed
class GatewayReplica(Replica):
    """A :class:`ServingGateway` (plus the engine it owns) as a fleet
    replica. ``engine_factory`` is called for the initial build and for
    every restart — the nebula-style "resume from persistent state"
    hook lives inside the factory (build engine, restore weights/KV)."""

    def __init__(self, name, engine_factory, serving_config=None,
                 monitor=None, auto_start=True, role=None):
        self.name = name
        self._factory = engine_factory
        if role is not None:
            # the role must reach the GATEWAY too: a prefill gateway
            # exports its KV handoff at request finish (pump thread)
            base = serving_config or ServingConfig()
            serving_config = dataclasses.replace(base, role=str(role))
        self._serving_config = serving_config
        self.role = (serving_config.role if serving_config is not None
                     else "unified")
        self._monitor = monitor
        self._auto_start = auto_start
        self._lock = tracked_lock(threading.Lock(), "GatewayReplica._lock")
        self.gateway = None
        self.restarts = 0  # completed rebuilds, for snapshots/tests
        self._build()

    def _build(self):
        gw = ServingGateway(self._factory(), config=self._serving_config,
                            monitor=self._monitor,
                            auto_start=self._auto_start)
        with self._lock:
            self.gateway = gw

    # ------------------------------------------------------------ routing API
    def submit(self, prompt_tokens, max_new_tokens=None, priority=None,
               deadline_ms=None, adapter_id=None, sample=None, schema=None):
        return self.gateway.submit(prompt_tokens, max_new_tokens=max_new_tokens,
                                   priority=priority, deadline_ms=deadline_ms,
                                   adapter_id=adapter_id, sample=sample,
                                   schema=schema)

    def has_adapter(self, adapter_id):
        try:
            return bool(self.gateway.engine.has_adapter(adapter_id))
        except Exception:
            return False  # no LoRA store / broken replica → not a target

    def prefetch_adapter(self, adapter_id):
        try:
            self.gateway.engine.prefetch_adapter(adapter_id)
        except Exception:
            pass  # warm-up is best-effort; placement still works cold

    def take_handoff(self, uid):
        return self.gateway.take_handoff(uid)

    def import_handoff(self, record):
        return self.gateway.import_handoff(record)

    def prefix_match_len(self, prompt_tokens):
        try:
            return self.gateway.prefix_match_len(prompt_tokens)
        except Exception:
            return 0  # a broken replica just stops being a prefix target

    def load(self):
        counts = self.gateway.inflight()
        return counts["queued"] + counts["active"]

    def alive(self):
        return self.gateway._state == "running"

    def probe(self):
        """Liveness = accepting state AND (when threaded) a live pump.
        A dead pump with state still 'running' is exactly the wedged
        case heartbeats exist to catch."""
        gw = self.gateway
        if gw._state != "running":
            return False
        thread = gw._pump_thread
        return thread is None or thread.is_alive()

    # -------------------------------------------------------------- lifecycle
    def drain(self, timeout=None):
        self.gateway.drain(timeout=timeout)

    def shutdown(self):
        self.gateway.shutdown()

    def kill(self, error=None):
        self.gateway.kill(error or ReplicaDiedError(
            f"replica {self.name} killed"))

    def restart(self, timeout=None, shed_error=None):
        """Drain-and-rebuild. Queued (not yet running) requests are shed
        with a retryable typed error so the router replays them on peers
        immediately instead of waiting out the drain; active streams are
        allowed to finish; then the serving stack is rebuilt from the
        engine factory."""
        gw = self.gateway
        gw.shed_queued(shed_error or ReplicaRestartingError(
            f"replica {self.name} restarting — resubmit elsewhere"))
        try:
            gw.drain(timeout=timeout)
        except TimeoutError:
            # laggards get a retryable GatewayClosedError instead of
            # blocking the restart forever
            logger.warning("replica %s: drain timed out, forcing shutdown",
                           self.name)
            gw.shutdown()
        with self._lock:
            self.restarts += 1
        self._build()

    def refresh(self, params, version, timeout=None):
        return self.gateway.refresh_weights(params, version, timeout=timeout)

    def weight_version(self):
        return int(self.gateway.weight_version)

    def stats(self):
        out = dict(self.gateway.inflight())
        out["restarts"] = self.restarts
        out["state"] = self.gateway._state
        return out


# ------------------------------------------------------------ fault injection
class FaultyReplica(Replica):
    """Deterministic failure wrapper around any :class:`Replica`.

    Scripted faults (all optional, all exact — no randomness):

    - ``crash_at_token=k``: the first request to reach its k-th
      generated token kills the WHOLE replica mid-stream (every
      in-flight handle fails with :class:`ReplicaDiedError`) — the
      replica-process-death case.
    - ``hang_at_token=k``: streams stop producing at token k without
      dying — the wedged-pump case hang detection must catch.
    - ``slow_token_s=s``: every token is delayed by ``s`` — the
      slow-decode / degraded case.
    - ``reject_next=n``: the next ``n`` submits raise
      :class:`QueueFullError` (``injected=True`` in details) — the
      overload burst case.
    - ``crash_on_submit=n``: the n-th submit (1-based) kills the
      replica instead of accepting.
    Handoff faults (disaggregated prefill→decode serving), composable
    with all of the above:

    - ``drop_handoff=True``: ``take_handoff`` returns None — the
      published record was lost (network drop / outbox rotation).
    - ``handoff_delay_s=s``: ``take_handoff`` sleeps ``s`` before
      returning — set it past the router's handoff deadline to exercise
      expiry.
    - ``corrupt_handoff=True``: the returned record is torn (truncated
      entries + a mangled chain key) so the importer's chained-key
      re-derivation must reject it.
    - ``crash_after_publish=True``: the record IS returned, then the
      replica dies — the crash-after-publish-before-ack window.

    Live-weight-refresh faults (hybrid-engine rollout), composable
    with all of the above:

    - ``refresh_torn=True``: ``refresh`` raises
      :class:`WeightPublicationError` without adopting anything — the
      torn/forged publication reaching a replica.
    - ``crash_mid_swap=True``: ``refresh`` kills the replica mid-swap
      (old weights gone from the replica's point of view) — the
      controller must roll the fleet back.
    - ``lie_version=True``: ``refresh`` adopts NOTHING but
      ``weight_version()`` reports the requested version — the
      version-report lie only the canary gate can catch.
    - ``slow_adopt_s=s``: ``refresh`` sleeps ``s`` before delegating —
      set it past the refresh timeout to exercise demotion.

    - ``hook``: a ``FaultInjector``-shaped callable ``hook(point,
      detail)`` invoked at ``("submit", i)``, ``("token", j)``,
      ``("handoff", uid)``, ``("refresh", version)`` and
      ``("probe", None)``; anything it raises kills the replica. This
      is how the shared checkpoint fault harness drives serving faults.
    """

    def __init__(self, inner, crash_at_token=None, hang_at_token=None,
                 slow_token_s=0.0, reject_next=0, crash_on_submit=None,
                 drop_handoff=False, handoff_delay_s=0.0,
                 corrupt_handoff=False, crash_after_publish=False,
                 refresh_torn=False, crash_mid_swap=False,
                 lie_version=False, slow_adopt_s=0.0,
                 hook=None):
        self.inner = inner
        self.name = inner.name
        self.role = getattr(inner, "role", "unified")
        self.crash_at_token = crash_at_token
        self.hang_at_token = hang_at_token
        self.slow_token_s = float(slow_token_s)
        self.crash_on_submit = crash_on_submit
        self.drop_handoff = bool(drop_handoff)
        self.handoff_delay_s = float(handoff_delay_s)
        self.corrupt_handoff = bool(corrupt_handoff)
        self.crash_after_publish = bool(crash_after_publish)
        self.refresh_torn = bool(refresh_torn)
        self.crash_mid_swap = bool(crash_mid_swap)
        self.lie_version = bool(lie_version)
        self.slow_adopt_s = float(slow_adopt_s)
        self._claimed_version = None  # lie_version's fabricated report
        self.hook = hook
        self._lock = tracked_lock(threading.Lock(), "FaultyReplica._lock")
        self._killed = False
        self._reject_left = int(reject_next)
        self._submits = 0  # lifetime submit count (1-based in faults)

    def _die(self, why):
        """Simulate replica process death: fail everything in flight on
        the inner replica, then raise for the caller that tripped it."""
        err = ReplicaDiedError(f"replica {self.name} died: {why}")
        with self._lock:
            already = self._killed
            self._killed = True
        if not already:
            try:
                self.inner.kill(err)
            except Exception:
                logger.exception("FaultyReplica: inner kill failed")
        raise err

    # ------------------------------------------------------------ routing API
    def submit(self, prompt_tokens, max_new_tokens=None, priority=None,
               deadline_ms=None, adapter_id=None, sample=None, schema=None):
        with self._lock:
            if self._killed:
                raise ReplicaDiedError(f"replica {self.name} is dead")
            self._submits += 1
            nth = self._submits
            if self._reject_left > 0:
                self._reject_left -= 1
                raise QueueFullError(
                    f"replica {self.name}: injected admission rejection",
                    injected=True, queue_depth=0)
        if self.hook is not None:
            try:
                self.hook("submit", nth)
            except Exception as e:
                self._die(f"hook tripped at submit #{nth}: {e}")
        if self.crash_on_submit is not None and nth >= self.crash_on_submit:
            self._die(f"scripted crash on submit #{nth}")
        inner_handle = self.inner.submit(prompt_tokens,
                                         max_new_tokens=max_new_tokens,
                                         priority=priority,
                                         deadline_ms=deadline_ms,
                                         adapter_id=adapter_id,
                                         sample=sample, schema=schema)
        return _FaultyHandle(inner_handle, self)

    def has_adapter(self, adapter_id):
        return (not self._killed) and self.inner.has_adapter(adapter_id)

    def prefetch_adapter(self, adapter_id):
        if not self._killed:
            self.inner.prefetch_adapter(adapter_id)

    def take_handoff(self, uid):
        with self._lock:
            if self._killed:
                raise ReplicaDiedError(f"replica {self.name} is dead")
        if self.hook is not None:
            try:
                self.hook("handoff", uid)
            except Exception as e:
                self._die(f"hook tripped at handoff for uid {uid}: {e}")
        if self.drop_handoff:
            self.inner.take_handoff(uid)  # record consumed, then "lost"
            return None
        if self.handoff_delay_s:
            time.sleep(self.handoff_delay_s)
        record = self.inner.take_handoff(uid)
        if self.corrupt_handoff and record is not None:
            record = self._tear(record)
        if self.crash_after_publish:
            # the record is delivered, THEN the replica dies: the
            # crash-after-publish-before-ack window — decode must still
            # complete from the published record
            try:
                self._die("scripted crash after handoff publish")
            except ReplicaDiedError:
                pass
        return record

    @staticmethod
    def _tear(record):
        """Torn/truncated handoff: drop required fields from the last
        entry and mangle a chain key so validation MUST reject it."""
        torn = dict(record)
        entries = [dict(e) for e in record.get("entries", [])]
        if entries:
            entries[-1].pop("handle", None)
            entries[0] = dict(entries[0], key="torn")
        torn["entries"] = entries
        return torn

    def import_handoff(self, record):
        with self._lock:
            if self._killed:
                raise ReplicaDiedError(f"replica {self.name} is dead")
        return self.inner.import_handoff(record)

    def refresh(self, params, version, timeout=None):
        with self._lock:
            if self._killed:
                raise ReplicaDiedError(f"replica {self.name} is dead")
        if self.hook is not None:
            try:
                self.hook("refresh", version)
            except Exception as e:
                self._die(f"hook tripped at refresh to v{version}: {e}")
        if self.refresh_torn:
            raise WeightPublicationError(
                f"replica {self.name}: injected torn publication at "
                f"v{version} — nothing adopted")
        if self.crash_mid_swap:
            self._die(f"scripted crash mid-swap to v{version}")
        if self.slow_adopt_s:
            budget = self.slow_adopt_s if timeout is None else min(
                self.slow_adopt_s, timeout)
            time.sleep(budget)
            if timeout is not None and self.slow_adopt_s > timeout:
                raise TimeoutError(
                    f"replica {self.name}: adoption of v{version} still in "
                    f"flight after {timeout}s — nothing adopted")
        if self.lie_version:
            # adopt NOTHING, report everything: the replica still serves
            # the old weights but claims the target version
            with self._lock:
                self._claimed_version = int(version)
            return int(version)
        return self.inner.refresh(params, version, timeout=timeout)

    def weight_version(self):
        with self._lock:
            if self._claimed_version is not None:
                return self._claimed_version
        return self.inner.weight_version()

    def prefix_match_len(self, prompt_tokens):
        return 0 if self._killed else self.inner.prefix_match_len(prompt_tokens)

    def load(self):
        return self.inner.load()

    def alive(self):
        return (not self._killed) and self.inner.alive()

    def probe(self):
        if self._killed:
            return False
        if self.hook is not None:
            try:
                self.hook("probe", None)
            except Exception:
                return False
        return self.inner.probe()

    # -------------------------------------------------------------- lifecycle
    def drain(self, timeout=None):
        self.inner.drain(timeout=timeout)

    def shutdown(self):
        self.inner.shutdown()

    def kill(self, error=None):
        with self._lock:
            self._killed = True
        self.inner.kill(error)

    def restart(self, timeout=None, shed_error=None):
        """Restarting a faulty replica clears its scripted faults — the
        'process was replaced' semantics a real restart would have."""
        self.inner.restart(timeout=timeout, shed_error=shed_error)
        with self._lock:
            self._killed = False
        self.crash_at_token = None
        self.hang_at_token = None
        self.slow_token_s = 0.0
        self.crash_on_submit = None
        self.drop_handoff = False
        self.handoff_delay_s = 0.0
        self.corrupt_handoff = False
        self.crash_after_publish = False
        self.refresh_torn = False
        self.crash_mid_swap = False
        self.lie_version = False
        self.slow_adopt_s = 0.0
        with self._lock:
            self._claimed_version = None

    def stats(self):
        out = dict(self.inner.stats())
        out["killed"] = self._killed
        return out


class _FaultyHandle:
    """Streaming-handle proxy that applies per-token faults. Everything
    the router touches on a handle is forwarded; ``tokens()`` is where
    crash/hang/slow scripts fire, indexed by the number of tokens THIS
    handle has yielded (deterministic per request)."""

    def __init__(self, inner, replica):
        self._inner = inner
        self._replica = replica
        self._yielded = 0  # per-HANDLE, so fresh iterators (the wire
        # relay polls with one per round) see the same fault schedule

    def tokens(self, timeout=None):
        rep = self._replica
        it = self._inner.tokens(timeout=timeout)
        while True:
            idx = self._yielded
            if rep.hang_at_token is not None and idx >= rep.hang_at_token:
                # wedged pump: nothing arrives, nothing dies — surface
                # the same timeout the real stream would
                time.sleep(timeout if timeout is not None else 0.05)
                raise _queue.Empty()
            try:
                tok = next(it)
            except StopIteration:
                return
            if rep.hook is not None:
                try:
                    rep.hook("token", idx)
                except Exception as e:
                    rep._die(f"hook tripped at token {idx}: {e}")
            if rep.crash_at_token is not None and idx >= rep.crash_at_token:
                rep._die(f"scripted crash at token {idx}")
            if rep.slow_token_s:
                time.sleep(rep.slow_token_s)
            self._yielded += 1
            yield tok

    def cancel(self):
        self._inner.cancel()

    def result(self, timeout=None):
        return self._inner.result(timeout=timeout)

    @property
    def done(self):
        return self._inner.done

    @property
    def status(self):
        return self._inner.status

    @property
    def error(self):
        return self._inner.error

    @property
    def uid(self):
        return self._inner.uid

    @property
    def _collected(self):
        return self._inner._collected
