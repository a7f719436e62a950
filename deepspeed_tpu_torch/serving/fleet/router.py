"""Fleet router: health-checked, prefix-aware routing over N replicas.

Port of ``deepspeed_tpu/serving/fleet/router.py``, copied as it is
(host-side Python: relay threads over in-process replicas, no device
work of its own).

``FleetRouter.submit()`` looks exactly like ``ServingGateway.submit()``
— same arguments, same streaming :class:`RequestHandle` contract — but
behind it a per-request *relay thread* places the request on the best
replica and, when that replica fails mid-flight, **fails the request
over**: replays it from the prompt on a surviving replica and resumes
the client's stream where it left off. Greedy decoding is deterministic
and batch-composition independent (the gateway test suite proves it), so
the replay re-produces the already-streamed prefix token for token; the
relay swallows those replayed tokens instead of re-emitting them, and
treats any mismatch as :class:`ReplayDivergenceError` rather than ever
forking a client-visible stream.

Placement: among routable replicas (HEALTHY preferred over DEGRADED),
route to the one whose radix prefix cache reports the longest match for
the prompt (break ties on load); no match anywhere → least-loaded.
Health: per-replica :class:`ReplicaHealth` state machines driven by both
request outcomes and an active heartbeat (``tick()``), with half-open
probing to bring DOWN replicas back. Rolling restart:
``restart_replica()`` sheds a replica's queued work back through the
retry path, drains its active streams, rebuilds it from its engine
factory, and only marks it routable again after a readiness probe.
"""

import itertools
import queue as _queue
import random
import threading
import time

import numpy as np

from deepspeed_tpu_torch.inference.sampling import validate_sample_spec
from deepspeed_tpu_torch.inference.structured.prng import derive_seed
from deepspeed_tpu_torch.serving.admission import (DeadlineExceededError,
                                                   GatewayClosedError,
                                                   RequestCancelledError,
                                                   ServingError)
from deepspeed_tpu_torch.serving.fleet.config import FleetConfig
from deepspeed_tpu_torch.serving.fleet.handoff import (HandoffFailedError,
                                                       HandoffManager,
                                                       PoolScheduler)
from deepspeed_tpu_torch.serving.fleet.health import (DOWN, HEALTHY, RESTARTING,
                                                      ReplicaHealth)
from deepspeed_tpu_torch.serving.fleet.replica import StreamStalledError
from deepspeed_tpu_torch.serving.gateway import RequestHandle
from deepspeed_tpu_torch.utils.sanitize import tracked_lock
from deepspeed_tpu_torch.utils.env_registry import env_bool, env_int, env_opt_bool
from deepspeed_tpu_torch.utils.logging import logger

# relay-attempt outcomes
_OK = "ok"        # stream finished cleanly
_RETRY = "retry"  # replica-local failure; another replica may serve it
_FATAL = "fatal"  # request-terminal (cancelled / deadline / divergence)

_COUNTERS = ("submitted", "completed", "failed", "cancelled",
             "deadline_expired", "retries", "failovers", "restarts",
             "recoveries", "prefix_routed", "tokens_relayed",
             "disagg_requests", "disagg_completed", "unified_fallbacks",
             "handoff_failures", "refreshes", "refresh_rollbacks",
             "refresh_demotions", "canary_divergences",
             "adapter_routed", "adapter_misses")


# ---------------------------------------------------------------------- errors
class NoReplicaAvailableError(ServingError):
    """Every replica is DOWN/RESTARTING/dead — nothing can be placed."""
    reason = "no_replica"
    retry_elsewhere = False


class FleetFailedError(ServingError):
    """The retry budget (max_attempts) ran out without completion."""
    reason = "attempts_exhausted"
    retry_elsewhere = False


class ReplayDivergenceError(ServingError):
    """A failover replay produced different tokens than were already
    streamed to the client — the stream cannot be continued without
    forking it, so the request fails loudly instead."""
    reason = "replay_divergence"
    retry_elsewhere = False


class FleetHandle(RequestHandle):
    """A :class:`RequestHandle` whose producer is a router relay thread
    instead of a gateway pump. Adds the failover breadcrumbs tests and
    operators want: which replicas served it, how many attempts."""

    def __init__(self, uid, prompt, max_new_tokens, priority, deadline_s,
                 adapter_id=None, sample=None, schema=None):
        super().__init__(uid, prompt, max_new_tokens, priority, deadline_s,
                         adapter_id=adapter_id, sample=sample, schema=schema)
        self.replica_trail = []  # replica names, one per attempt
        self.attempts = 0
        self._cancelled = False
        self._inner = None  # current replica-level handle (if any)


class FleetRouter:
    """Routes requests over ``replicas`` (a list of :class:`Replica`).

    ``auto_heartbeat=False`` disables the background heartbeat thread;
    tests drive health explicitly via :meth:`tick`. ``now_fn``/``seed``
    make timing and jitter injectable."""

    def __init__(self, replicas, config=None, monitor=None, seed=0,
                 now_fn=None, auto_heartbeat=True):
        if not replicas:
            raise ValueError("FleetRouter needs at least one replica")
        self.replicas = {}
        for rep in replicas:
            if rep.name in self.replicas:
                raise ValueError(f"duplicate replica name {rep.name!r}")
            self.replicas[rep.name] = rep
        self.config = config or FleetConfig()
        self.monitor = monitor
        self._now = now_fn or time.monotonic
        self._seed = seed
        self.health = {name: ReplicaHealth(self.config, now_fn=self._now,
                                           name=name)
                       for name in self.replicas}
        self._failover_enabled = env_bool("DS_FLEET_FAILOVER")
        self._prefix_routing = (self.config.prefix_routing
                                and env_bool("DS_FLEET_PREFIX_ROUTING"))
        # disaggregated prefill/decode serving: DS_DISAGG wins in both
        # directions over config.disagg when set
        disagg_env = env_opt_bool("DS_DISAGG")
        self._disagg_enabled = (disagg_env if disagg_env is not None
                                else self.config.disagg)
        self._fallback_enabled = env_bool("DS_DISAGG_FALLBACK")
        self.pools = None
        self.handoffs = None
        if self._disagg_enabled:
            roles = {name: self.config.roles.get(
                         name, getattr(rep, "role", "unified"))
                     for name, rep in self.replicas.items()}
            deadline = (env_int("DS_DISAGG_HANDOFF_DEADLINE_S")
                        or self.config.handoff_deadline_s)
            self.pools = PoolScheduler(
                roles,
                fallback_after=self.config.disagg_fallback_after,
                recover_after=self.config.disagg_recover_after,
                probe_every=self.config.disagg_probe_every,
                now_fn=self._now)
            self.handoffs = HandoffManager(deadline_s=deadline,
                                           now_fn=self._now)
        self._uids = itertools.count()
        self._lock = tracked_lock(threading.Lock(), "FleetRouter._lock")
        self._counters = {k: 0 for k in _COUNTERS}
        self._relays = set()   # live per-request relay threads
        self._closed = False
        self._hb_stop = threading.Event()
        self._hb_thread = None
        if auto_heartbeat:
            self._hb_thread = threading.Thread(target=self._heartbeat_loop,
                                               name="ds-fleet-heartbeat",
                                               daemon=True)
            self._hb_thread.start()

    # ---------------------------------------------------------------- client
    def submit(self, prompt_tokens, max_new_tokens=None, priority=None,
               deadline_ms=None, adapter_id=None, sample=None, schema=None):
        """Gateway-compatible submit: → a streaming :class:`FleetHandle`.
        Placement, retries and failover all happen on a per-request
        relay thread; the caller just consumes ``handle.tokens()``.
        ``adapter_id`` routes the request through that LoRA adapter's
        weights (None = base) — placement prefers replicas whose hot
        set already holds the adapter. ``sample``/``schema`` ride along
        to whichever replica serves each attempt.

        Defaults resolve HERE (from :class:`FleetConfig`), not per
        replica — every failover attempt must replay with identical
        parameters or replay equivalence breaks. That includes the
        sampling seed: a spec without one gets a seed derived from the
        ROUTER uid, so a mid-stream replica kill replays the identical
        counter-keyed stream on the survivor."""
        prompt = [int(t) for t in np.atleast_1d(np.asarray(prompt_tokens))]
        max_new = int(max_new_tokens if max_new_tokens is not None
                      else self.config.default_max_new_tokens)
        prio = int(priority if priority is not None
                   else self.config.default_priority)
        if max_new < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new}")
        if deadline_ms is not None and deadline_ms <= 0:
            raise ValueError(f"deadline_ms must be > 0, got {deadline_ms}")
        if sample is not None:
            validate_sample_spec(sample)  # typed, before any placement
            sample = dict(sample)
        with self._lock:
            if self._closed:
                raise GatewayClosedError(
                    "fleet router is closed — not accepting requests")
        uid = next(self._uids)
        if sample is not None and "seed" not in sample:
            sample["seed"] = derive_seed(env_int("DS_SEED"), uid)
        handle = FleetHandle(uid, prompt, max_new, prio,
                             deadline_ms / 1e3 if deadline_ms is not None
                             else None, adapter_id=adapter_id,
                             sample=sample, schema=schema)
        handle._cancel_cb = self._request_cancel
        self._count("submitted")
        thread = threading.Thread(target=self._serve, args=(handle,),
                                  name=f"ds-fleet-relay-{handle.uid}",
                                  daemon=True)
        with self._lock:
            self._relays.add(thread)
        thread.start()
        return handle

    def _request_cancel(self, handle):
        handle._cancelled = True
        inner = handle._inner
        if inner is not None:
            try:
                inner.cancel()
            except Exception:
                pass

    # ----------------------------------------------------------------- relay
    def _serve(self, handle):
        """Relay-thread main. With disagg pools the request first rides
        the two-stage prefill→handoff→decode path; any disagg failure
        either finished the handle (typed) or gracefully degrades into
        the unified loop below — the replay verification in ``_attempt``
        makes the transition exact (tokens the prefill stage already
        emitted are verified, never re-emitted). Structured so NO exit
        path leaves the handle unfinished."""
        cfg = self.config
        excluded = set()  # replicas that already failed THIS request
        # backoff-jitter seed: derive_seed, NOT Python hash() — hash is
        # PYTHONHASHSEED-salted for str/bytes, so a uid type change
        # would silently desynchronize retry schedules across processes
        rng = random.Random(derive_seed(self._seed, handle.uid))
        try:
            if self.pools is not None:
                if self._serve_disagg(handle, rng, excluded):
                    return
                # graceful degradation: fall through to unified serving
                # (replicas that failed the disagg stages stay excluded)
            while True:
                handle.attempts += 1
                if handle._cancelled:
                    self._fail(handle, RequestCancelledError(
                        f"request {handle.uid} cancelled"))
                    return
                if handle.deadline is not None and \
                        self._now() >= handle.deadline:
                    self._fail(handle, DeadlineExceededError(
                        f"request {handle.uid} deadline expired before "
                        f"attempt {handle.attempts}"))
                    return
                replica = self._place(handle.prompt, excluded,
                                      adapter_id=handle.adapter_id)
                if replica is None and excluded:
                    # every un-failed replica is unroutable; a replica
                    # that failed this request earlier may have recovered
                    excluded.clear()
                    replica = self._place(handle.prompt, excluded,
                                          adapter_id=handle.adapter_id)
                if replica is None:
                    self._fail(handle, NoReplicaAvailableError(
                        f"no routable replica for request {handle.uid} "
                        f"(attempt {handle.attempts}/{cfg.max_attempts})"))
                    return
                handle.replica_trail.append(replica.name)
                outcome, err = self._attempt(handle, replica)
                if outcome is _OK:
                    if handle._finish("completed"):
                        self._count("completed")
                    return
                if outcome is _FATAL:
                    self._fail(handle, err)
                    return
                # _RETRY: replica-local failure
                if not self._failover_enabled:
                    self._fail(handle, err)
                    return
                excluded.add(replica.name)
                if handle.attempts >= cfg.max_attempts:
                    self._fail(handle, FleetFailedError(
                        f"request {handle.uid} failed on "
                        f"{len(set(handle.replica_trail))} replica(s) after "
                        f"{handle.attempts} attempts; last error: "
                        f"[{err.reason}] {err}", last_reason=err.reason))
                    return
                backoff = min(
                    cfg.retry_backoff_s *
                    cfg.retry_backoff_mult ** (handle.attempts - 1),
                    cfg.retry_backoff_max_s)
                backoff *= 1.0 + cfg.retry_jitter * rng.random()
                if handle.deadline is not None and \
                        self._now() + backoff >= handle.deadline:
                    self._fail(handle, DeadlineExceededError(
                        f"request {handle.uid}: deadline would expire "
                        f"during failover backoff; last error: "
                        f"[{err.reason}] {err}"))
                    return
                self._count("retries")
                if getattr(err, "retry_elsewhere", False):
                    self._count("failovers")
                time.sleep(backoff)
        except Exception as e:
            # relay bug — never hang the client
            logger.exception("fleet relay died for request %s", handle.uid)
            self._fail(handle, FleetFailedError(
                f"fleet relay crashed: {type(e).__name__}: {e}"))
        finally:
            with self._lock:
                self._relays.discard(threading.current_thread())

    def _serve_disagg(self, handle, rng, excluded):
        """Two-stage disaggregated serve: prefill-pool attempt (short
        burst) → KV handoff via the content-addressed export record →
        decode-pool continuation that verifies the emitted prefix.
        → True when the handle was finished here (completed or typed
        failure); False to gracefully degrade into the unified loop.
        ``excluded`` is the request-scoped failure set shared with the
        unified loop: a replica that dropped, tore, or stalled this
        request's handoff path is added so the fallback never lands on
        it (and cannot launder its health blame with an instant
        unified success).
        Every failure branch is pool-aware: a dead prefill re-prefills
        on a survivor, a saturated/stalled/DOWN pool degrades instead of
        queueing to death, and the PoolScheduler's hysteresis decides
        when to stop even trying."""
        cfg = self.config
        pools = self.pools
        if pools.decide() != "disagg":
            self._count("unified_fallbacks")
            return False
        self._count("disagg_requests")

        # ---- stage P: prefill a short burst, then claim the handoff.
        # The override must cover any previously emitted tokens so the
        # replay verification can consume them (re-prefill after a
        # mid-handoff crash replays, never re-emits).
        prefill_tokens = min(max(cfg.prefill_max_tokens,
                                 len(handle._collected)),
                             handle.max_new_tokens)
        excluded_p = set()
        record = None
        source = None
        for _ in range(cfg.max_attempts):
            if handle._cancelled:
                self._fail(handle, RequestCancelledError(
                    f"request {handle.uid} cancelled"))
                return True
            prefill = self._place(handle.prompt, excluded_p,
                                  roles=("prefill",))
            if prefill is None:
                pools.note_failure("prefill_pool_unroutable")
                return self._degrade(handle, "no routable prefill replica")
            handle.attempts += 1
            handle.replica_trail.append(prefill.name)
            outcome, err = self._attempt(handle, prefill,
                                         max_new_override=prefill_tokens,
                                         defer_success=True)
            if outcome is _FATAL:
                self._fail(handle, err)
                return True
            if outcome is _RETRY:
                if not self._failover_enabled:
                    self._fail(handle, err)
                    return True
                excluded_p.add(prefill.name)
                excluded.add(prefill.name)
                if getattr(err, "reason", "") == "queue_full" and \
                        err.details.get("pool") == "prefill":
                    # pool-aware hint: a saturated prefill gate means
                    # degrade or re-pool, never retry the same gate
                    pools.note_failure("prefill_pool_saturated")
                    return self._degrade(handle, "prefill pool saturated")
                if not self._backoff(handle, rng, err):
                    return True
                continue
            # _OK: the prefill burst finished
            if len(handle._collected) >= handle.max_new_tokens:
                # the whole request fit inside the prefill burst
                self.health[prefill.name].record_success()
                pools.note_success()
                if handle._finish("completed"):
                    self._count("completed")
                return True
            try:
                record = prefill.take_handoff(handle._inner.uid)
            except Exception as e:
                record = None
                self._note_failure(prefill, HandoffFailedError(
                    f"request {handle.uid}: handoff claim on "
                    f"{prefill.name} raised {type(e).__name__}: {e}"))
            if record is None:
                # dropped/never-published handoff: counts toward the
                # prefill replica's DEGRADED threshold (it prefills
                # fine but cannot publish) and we re-prefill elsewhere
                hf = HandoffFailedError(
                    f"request {handle.uid}: no handoff record from "
                    f"{prefill.name}")
                self._count("handoff_failures")
                self._note_failure(prefill, hf)
                excluded_p.add(prefill.name)
                excluded.add(prefill.name)
                pools.note_failure("handoff_dropped")
                if not self._backoff(handle, rng, hf):
                    return True
                continue
            source = prefill
            self.health[prefill.name].record_success()
            break
        if record is None or source is None:
            pools.note_failure("prefill_attempts_exhausted")
            return self._degrade(handle, "prefill attempts exhausted")
        self.handoffs.publish(handle.uid, record, source.name)

        # ---- stage D: deliver the record, continue on the decode pool
        excluded_d = set()
        for _ in range(cfg.max_attempts):
            if handle._cancelled:
                self.handoffs.fail(handle.uid, "cancelled")
                self._fail(handle, RequestCancelledError(
                    f"request {handle.uid} cancelled"))
                return True
            decode = self._place(handle.prompt, excluded_d,
                                 roles=("decode",))
            if decode is None:
                self.handoffs.fail(handle.uid, "decode_pool_unroutable")
                pools.note_failure("decode_pool_unroutable")
                return self._degrade(handle, "no routable decode replica")
            entry = self.handoffs.record(handle.uid)
            if entry is None:
                # published but expired past the handoff deadline —
                # re-plan instead of waiting on a record that may never
                # be claimable (delay-past-deadline fault mode)
                self._count("handoff_failures")
                pools.note_failure("handoff_expired")
                return self._degrade(handle, "handoff deadline expired")
            try:
                decode.import_handoff(entry["record"])
            except Exception as e:
                # torn/forged record rejected by the chained-key
                # re-derivation — blame the SOURCE that published it
                hf = HandoffFailedError(
                    f"request {handle.uid}: decode {decode.name} rejected "
                    f"the handoff from {source.name}: "
                    f"{type(e).__name__}: {e}")
                self._count("handoff_failures")
                self._note_failure(source, hf)
                excluded.add(source.name)
                self.handoffs.fail(handle.uid, "record_rejected")
                pools.note_failure("handoff_corrupt")
                return self._degrade(handle, "handoff record rejected")
            handle.attempts += 1
            handle.replica_trail.append(decode.name)
            outcome, err = self._attempt(handle, decode)
            if outcome is _OK:
                self.handoffs.ack(handle.uid)
                pools.note_success()
                self._count("disagg_completed")
                if handle._finish("completed"):
                    self._count("completed")
                return True
            if outcome is _FATAL:
                self.handoffs.fail(handle.uid, err.reason)
                self._fail(handle, err)
                return True
            if not self._failover_enabled:
                self.handoffs.fail(handle.uid, err.reason)
                self._fail(handle, err)
                return True
            excluded_d.add(decode.name)
            excluded.add(decode.name)
            if getattr(err, "reason", "") == "queue_full" and \
                    err.details.get("pool") == "decode":
                self.handoffs.fail(handle.uid, "decode_pool_saturated")
                pools.note_failure("decode_pool_saturated")
                return self._degrade(handle, "decode pool saturated")
            if not self._backoff(handle, rng, err):
                self.handoffs.fail(handle.uid, "deadline")
                return True
        self.handoffs.fail(handle.uid, "decode_attempts_exhausted")
        pools.note_failure("decode_pool_stalled")
        return self._degrade(handle, "decode attempts exhausted")

    def _degrade(self, handle, why):
        """The disagg path cannot serve this request. With fallback on
        (DS_DISAGG_FALLBACK, default) → False: the caller's unified
        loop takes over on any full replica, replaying/verifying
        whatever the prefill stage already emitted — zero lost
        requests, zero double-emits. With fallback off → the request
        fails with the typed handoff error (True)."""
        if self._fallback_enabled:
            self._count("unified_fallbacks")
            logger.warning("fleet: request %s degrading to unified "
                           "serving: %s", handle.uid, why)
            return False
        self._fail(handle, HandoffFailedError(
            f"request {handle.uid}: disaggregated serving failed ({why}) "
            f"and DS_DISAGG_FALLBACK is off"))
        return True

    def _backoff(self, handle, rng, err):
        """Seeded-jitter retry backoff shared by the disagg stages
        (same formula as the unified loop). → False when the handle was
        failed because the deadline would expire mid-backoff."""
        cfg = self.config
        backoff = min(cfg.retry_backoff_s *
                      cfg.retry_backoff_mult ** (handle.attempts - 1),
                      cfg.retry_backoff_max_s)
        backoff *= 1.0 + cfg.retry_jitter * rng.random()
        if handle.deadline is not None and \
                self._now() + backoff >= handle.deadline:
            self._fail(handle, DeadlineExceededError(
                f"request {handle.uid}: deadline would expire during "
                f"failover backoff; last error: [{err.reason}] {err}"))
            return False
        self._count("retries")
        if getattr(err, "retry_elsewhere", False):
            self._count("failovers")
        time.sleep(backoff)
        return True

    def _attempt(self, handle, replica, max_new_override=None,
                 defer_success=False):
        """One placement attempt on ``replica`` → (outcome, error).
        Replays ``handle._collected`` silently (failover continuation):
        tokens the client already saw are verified, never re-emitted.
        ``max_new_override`` caps the burst (the disagg prefill stage
        asks for a handful of tokens, not the full request).
        ``defer_success`` withholds the health credit for a clean burst
        — the disagg prefill stage only credits the replica once its
        handoff is claimed, so a replica that prefills fine but drops
        every handoff still accumulates consecutive failures."""
        cfg = self.config
        deadline_ms = None
        if handle.deadline is not None:
            remaining = handle.deadline - self._now()
            if remaining <= 0:
                return _FATAL, DeadlineExceededError(
                    f"request {handle.uid} deadline expired")
            deadline_ms = remaining * 1e3
        max_new = (max_new_override if max_new_override is not None
                   else handle.max_new_tokens)
        try:
            inner = replica.submit(handle.prompt,
                                   max_new_tokens=max_new,
                                   priority=handle.priority,
                                   deadline_ms=deadline_ms,
                                   adapter_id=handle.adapter_id,
                                   sample=handle.sample,
                                   schema=handle.schema)
        except ServingError as e:
            self._note_failure(replica, e)
            return (_RETRY if e.retry_elsewhere else _FATAL), e
        handle._inner = inner
        if handle._cancelled:  # raced with cancel during placement
            try:
                inner.cancel()
            except Exception:
                pass
            return _FATAL, RequestCancelledError(
                f"request {handle.uid} cancelled")
        replay = len(handle._collected)  # tokens the client already saw
        idx = 0
        stream = inner.tokens(timeout=cfg.stream_token_timeout_s)
        while True:
            try:
                tok = next(stream)
            except StopIteration:
                if idx < replay:
                    return _FATAL, ReplayDivergenceError(
                        f"request {handle.uid}: replay on {replica.name} "
                        f"ended after {idx} tokens but {replay} were "
                        f"already streamed")
                if not defer_success:
                    self.health[replica.name].record_success()
                return _OK, None
            except _queue.Empty:
                # hang detection: a live stream that went silent
                try:
                    inner.cancel()
                except Exception:
                    pass
                err = StreamStalledError(
                    f"request {handle.uid}: no token from {replica.name} "
                    f"for {cfg.stream_token_timeout_s}s (after {idx})",
                    tokens_seen=idx)
                self._note_failure(replica, err)
                return _RETRY, err
            except ServingError as e:
                self._note_failure(replica, e)
                return (_RETRY if e.retry_elsewhere else _FATAL), e
            if handle._cancelled:
                try:
                    inner.cancel()
                except Exception:
                    pass
                return _FATAL, RequestCancelledError(
                    f"request {handle.uid} cancelled after "
                    f"{len(handle._collected)} tokens")
            tok = int(tok)
            if idx < replay:
                if tok != handle._collected[idx]:
                    return _FATAL, ReplayDivergenceError(
                        f"request {handle.uid}: replay token {idx} on "
                        f"{replica.name} is {tok}, client already saw "
                        f"{handle._collected[idx]}")
            else:
                handle._emit(tok)
                self._count("tokens_relayed")
            idx += 1

    def _fail(self, handle, err):
        """Finish ``handle`` abnormally with the status/counter its
        error reason maps to (same vocabulary as the gateway)."""
        reason = getattr(err, "reason", "")
        if reason == "cancelled":
            status, counter = "cancelled", "cancelled"
        elif reason == "deadline":
            status, counter = "deadline", "deadline_expired"
        else:
            status, counter = "failed", "failed"
        if handle._finish(status, err):
            self._count(counter)

    def _note_failure(self, replica, err):
        """Map a request-attempt error onto the replica's health.
        Replica-death class → straight to DOWN; stalls count toward the
        degraded/down thresholds; administrative + load errors
        (restarting, closed, queue full, shed) carry NO health penalty —
        a full queue is a busy replica, not a sick one; everything else
        (too_large, deadline, cancelled) says nothing about the replica.
        Handoff failures count like stalls: a replica that prefills
        fine but cannot publish its KV must rotate out of the prefill
        pool via the same DEGRADED threshold."""
        reason = getattr(err, "reason", "")
        health = self.health[replica.name]
        if reason in ("replica_died", "gateway_failed"):
            health.record_failure(why=f"[{reason}] {err}", fatal=True)
        elif reason in ("stream_stalled", "handoff_failed"):
            health.record_failure(why=f"[{reason}] {err}")

    # ------------------------------------------------------------- placement
    def _place(self, prompt, excluded, roles=None, adapter_id=None):
        """Pick a replica for ``prompt``: routable + alive, HEALTHY
        preferred over DEGRADED, then adapter-affine (a replica whose
        hot set already holds ``adapter_id`` skips the promotion stall),
        then longest prefix-cache match (ties to lighter load), then
        least-loaded. A full adapter miss falls back to least-loaded
        and kicks that replica's adapter prefetch so the NEXT request
        for this tenant lands warm. ``roles`` restricts placement to
        the named disagg pool(s); None means any replica (unified
        serving and degraded-mode fallback)."""
        candidates = []
        for name, rep in self.replicas.items():
            if name in excluded or not self.health[name].routable:
                continue
            if roles is not None and self.pools is not None and \
                    self.pools.role_of(name) not in roles:
                continue
            try:
                if not rep.alive():
                    continue
            except Exception:
                continue
            candidates.append(rep)
        if not candidates:
            return None
        healthy = [r for r in candidates
                   if self.health[r.name].state == HEALTHY]
        pool = healthy or candidates
        if adapter_id:
            warm = []
            for rep in pool:
                try:
                    if rep.has_adapter(adapter_id):
                        warm.append(rep)
                except Exception:
                    pass
            if warm:
                self._count("adapter_routed")
                pool = warm  # prefix routing breaks remaining ties below
            else:
                self._count("adapter_misses")
                chosen = min(pool, key=self._load)
                try:
                    chosen.prefetch_adapter(adapter_id)
                except Exception:
                    pass
                return chosen
        if self._prefix_routing and len(prompt) > 1:
            best, best_key = None, None
            for rep in pool:
                try:
                    match = int(rep.prefix_match_len(prompt))
                except Exception:
                    match = 0
                key = (match, -self._load(rep))
                if best_key is None or key > best_key:
                    best, best_key = rep, key
            if best_key is not None and best_key[0] > 0:
                self._count("prefix_routed")
                return best
        return min(pool, key=self._load)

    def _load(self, rep):
        try:
            return int(rep.load())
        except Exception:
            return 1 << 30  # unmeasurable → last resort

    # ---------------------------------------------------------------- health
    def tick(self):
        """One heartbeat sweep: probe DOWN replicas whose half-open
        window is open; actively verify liveness of routable ones (a
        wedged pump with no traffic would otherwise never be noticed)."""
        for name, rep in self.replicas.items():
            health = self.health[name]
            state = health.state
            if state == RESTARTING:
                continue
            if state == DOWN:
                if health.probe_due():
                    if health.record_probe(self._probe(rep)):
                        self._count("recoveries")
                        logger.info("fleet: replica %s recovered", name)
                continue
            if not self._probe(rep):
                health.record_failure(why="heartbeat probe failed",
                                      fatal=True)
                logger.warning("fleet: replica %s failed heartbeat -> down",
                               name)

    def _probe(self, rep):
        try:
            return bool(rep.probe())
        except Exception:
            return False

    def _heartbeat_loop(self):
        while not self._hb_stop.wait(timeout=self.config.heartbeat_interval_s):
            try:
                self.tick()
            except Exception:
                logger.exception("fleet heartbeat sweep failed")

    # --------------------------------------------------------------- restart
    def restart_replica(self, name, timeout=None):
        """Rolling-restart one replica while the rest keep serving:
        mark RESTARTING (so drain noise is not misread as a crash), shed
        its queued work back through the failover path, drain + rebuild,
        then readmit only after a readiness probe. → True when the
        replica came back healthy."""
        replica = self.replicas[name]
        health = self.health[name]
        health.begin_restart()
        self._count("restarts")
        ok = False
        try:
            replica.restart(timeout=timeout if timeout is not None
                            else self.config.restart_drain_timeout_s)
            ok = self._probe(replica)
        finally:
            health.end_restart(ok)
        return ok

    def rolling_restart(self, timeout=None):
        """Restart every replica one at a time → {name: came_back_ok}."""
        return {name: self.restart_replica(name, timeout=timeout)
                for name in list(self.replicas)}

    # -------------------------------------------------------------- lifecycle
    def drain(self, timeout=None):
        """Stop admitting, let every relay finish (their requests
        complete or fail typed), then drain the replicas."""
        timeout = (self.config.restart_drain_timeout_s if timeout is None
                   else timeout)
        with self._lock:
            self._closed = True
            relays = list(self._relays)
        deadline = time.monotonic() + timeout
        for thread in relays:
            thread.join(timeout=max(0.0, deadline - time.monotonic()))
        stuck = [t.name for t in relays if t.is_alive()]
        if stuck:
            raise TimeoutError(
                f"fleet drain: {len(stuck)} relay(s) still running after "
                f"{timeout}s: {stuck}")
        self._stop_heartbeat()
        for rep in self.replicas.values():
            rep.drain(timeout=max(0.1, deadline - time.monotonic()))

    def shutdown(self):
        """Hard stop: replicas die first (their typed errors unblock any
        relays mid-stream), then relays are reaped."""
        with self._lock:
            self._closed = True
        self._stop_heartbeat()
        for rep in self.replicas.values():
            try:
                rep.shutdown()
            except Exception:
                logger.exception("fleet shutdown: replica %s", rep.name)
        with self._lock:
            relays = list(self._relays)
        for thread in relays:
            thread.join(timeout=30)

    def _stop_heartbeat(self):
        self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=5)
            self._hb_thread = None

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.drain()
        else:
            self.shutdown()
        return False

    # --------------------------------------------------------------- metrics
    def _count(self, key, n=1):
        with self._lock:
            self._counters[key] += n

    def snapshot(self):
        with self._lock:
            counters = dict(self._counters)
        replicas = {}
        for name, rep in self.replicas.items():
            try:
                stats = rep.stats()
            except Exception:
                stats = {}
            replicas[name] = {"health": self.health[name].snapshot(),
                              "load": self._load(rep), **stats}
        out = {"counters": counters, "replicas": replicas}
        if self.pools is not None:
            out["disagg"] = {"pools": self.pools.stats(),
                             "handoffs": self.handoffs.stats()}
        return out

    def write_events(self, monitor, step=0):
        snap = self.snapshot()
        events = [(f"Fleet/{k}", v, step)
                  for k, v in sorted(snap["counters"].items())]
        for name, info in sorted(snap["replicas"].items()):
            state = info["health"]["state"]
            events.append((f"Fleet/{name}/healthy",
                           1 if state == HEALTHY else 0, step))
            events.append((f"Fleet/{name}/load", info["load"], step))
        if self.pools is not None:
            for k, v in sorted(self.pools.stats().items()):
                if isinstance(v, (int, float)):
                    events.append((f"Serve/Disagg/{k}", v, step))
            for k, v in sorted(self.handoffs.stats().items()):
                if isinstance(v, (int, float)):
                    events.append((f"Serve/Disagg/handoff_{k}", v, step))
        monitor.write_events(events)
