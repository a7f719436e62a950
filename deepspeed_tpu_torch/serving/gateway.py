"""Request-level serving front-end over the v2 ragged engine.

Port of ``deepspeed_tpu/serving/gateway.py``, the module whole but for the
serving autotuner (the online SLO controller and ``DS_AUTOTUNE_CONFIG``'s
tuned-config overlay), which raises when it is turned on (ROADMAP.md,
port queue item 4). On a CUDA engine the pump thread first makes the
engine's device current (a new thread's current device is device 0), and
``drain``/``shutdown``/``kill`` destroy the engine, whose tensors go back
to the caching allocator: handing its cached blocks to the card
(``torch.cuda.empty_cache``, process-wide) is the process owner's call.

``ServingGateway`` owns an :class:`InferenceEngineV2` plus a
:class:`DynamicSplitFuseScheduler` and runs a **pump loop** in a
background thread: clients ``submit()`` at any time from any thread and
get back a :class:`RequestHandle` that streams tokens as the engine
produces them. The pump overlaps host-side work (admission, deadline
checks, queue management) with device decode bursts — the structural fix
for the host-sync cadence that dominates ragged-serving wall time.

Layering (everything engine-side stays single-threaded in the pump):

    client threads --submit()--> AdmissionQueue --pump--> scheduler --> engine
                   <--handle.tokens() stream-- on_token callback <--+

Admission is KV-block aware (:class:`CapacityGate`): a request enters
the scheduler only when its full worst-case footprint fits the pool next
to every other active request, so the engine's "KV pool exhausted" error
can never wedge the pump. Higher-priority requests may *preempt* running
lower-priority ones (KV suspended to host via ``engine.suspend``,
resumed when the pool has room again).

Lifecycle: ``drain()`` stops admission, finishes everything in flight,
stops the pump, and destroys the engine. A pump crash fails every
outstanding handle with :class:`GatewayFailedError` instead of hanging
clients.
"""

import itertools
import queue as _queue
import threading
import time
from collections import OrderedDict

import numpy as np
import torch

from deepspeed_tpu_torch.inference.sampling import validate_sample_spec
from deepspeed_tpu_torch.inference.structured.grammar import CompiledSchema
from deepspeed_tpu_torch.inference.structured.prng import derive_seed
from deepspeed_tpu_torch.inference.structured.store import schema_cache
from deepspeed_tpu_torch.inference.v2.scheduler import DynamicSplitFuseScheduler
from deepspeed_tpu_torch.roadmap import not_ported
from deepspeed_tpu_torch.serving.admission import (AdmissionQueue, CapacityGate,
                                                   DeadlineExceededError, GatewayClosedError,
                                                   GatewayFailedError, QueueFullError,
                                                   RequestCancelledError, RequestShedError,
                                                   ServingError)
from deepspeed_tpu_torch.serving.config import ServingConfig
from deepspeed_tpu_torch.serving.lora.store import UnknownAdapterError
from deepspeed_tpu_torch.serving.metrics import ServingMetrics
from deepspeed_tpu_torch.utils.env_registry import env_int, env_opt_bool, env_raw
from deepspeed_tpu_torch.utils.logging import logger
from deepspeed_tpu_torch.utils.sanitize import tracked_lock

_DONE = object()  # stream sentinel
_HANDOFF_OUTBOX = 64  # exported records kept (LRU) awaiting router pickup


def autotune_enabled(config) -> bool:
    """``DS_AUTOTUNE`` set wins in BOTH directions; unset defers to
    ``serving.autotune.enabled`` (the JAX package's gate, copied)."""
    forced = env_opt_bool("DS_AUTOTUNE")
    if forced is not None:
        return forced
    at = getattr(config, "autotune", None)
    return bool(getattr(at, "enabled", False)) if at is not None else False


def _apply_tuned_config(cfg):
    """``DS_AUTOTUNE_CONFIG`` names an offline tuner's config, whose
    serving-scope knobs the JAX gateway folds over ``cfg``. The tuner is
    not ported: set, it raises; unset — the common case — returns ``cfg``
    untouched."""
    path = env_raw("DS_AUTOTUNE_CONFIG")
    if path is None or not str(path).strip():
        return cfg
    raise not_ported(f"DS_AUTOTUNE_CONFIG={path!r} (the serving tuner's tuned config)", 4)


class RequestHandle:
    """Client-side view of one in-flight request.

    ``tokens()`` iterates generated token ids as they stream out of the
    engine; it raises the terminal :class:`ServingError` when the request
    ended abnormally (shed / cancelled / deadline / gateway failure).
    ``result()`` blocks to completion and returns the full token list.
    """

    def __init__(self, uid, prompt, max_new_tokens, priority, deadline_s,
                 spec=True, adapter_id=None, sample=None, schema=None):
        self.uid = uid
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.priority = priority
        # per-request speculative-decoding opt-out (engine support and
        # the DS_SPEC_DECODE kill switch still gate it globally)
        self.spec = bool(spec)
        # multi-tenant LoRA: serve this request through adapter_id's
        # weights (None = base model)
        self.adapter_id = adapter_id
        # on-device sampling spec (seed already resolved — replays and
        # failovers are uid-stable) and compiled constrained-decoding
        # schema; None/None = greedy unconstrained
        self.sample = sample
        self.schema = schema
        self.submitted_at = time.monotonic()
        self.deadline = (self.submitted_at + deadline_s
                         if deadline_s is not None else None)
        self.status = "queued"  # queued|running|completed|cancelled|shed|deadline|failed
        self.error = None
        self.ttft_s = None
        self.queue_wait_s = None
        self._stream = _queue.Queue()
        self._collected = []
        self._first_token_at = None
        self._last_token_at = None
        self._done = threading.Event()
        self._cancel_cb = None  # wired by the gateway

    # ------------------------------------------------------------- client API
    def tokens(self, timeout=None):
        """Yield token ids as they are generated. Raises the terminal
        error for abnormal endings after yielding what was produced."""
        while True:
            item = self._stream.get(timeout=timeout)
            if item is _DONE:
                if self.error is not None:
                    raise self.error
                return
            yield item

    def result(self, timeout=None):
        """Block until the request finishes; return all generated token
        ids (raises the terminal error for abnormal endings)."""
        if not self._done.wait(timeout=timeout):
            raise TimeoutError(f"request {self.uid} still running after {timeout}s")
        if self.error is not None:
            raise self.error
        return list(self._collected)

    def cancel(self):
        """Ask the gateway to stop this request (no-op once finished)."""
        if not self._done.is_set() and self._cancel_cb is not None:
            self._cancel_cb(self)

    @property
    def done(self):
        return self._done.is_set()

    # ------------------------------------------------------- gateway internals
    def _emit(self, token):
        self._collected.append(token)
        self._stream.put(token)

    def _finish(self, status, error=None):
        if self._done.is_set():
            return False
        self.status = status
        self.error = error
        self._done.set()
        self._stream.put(_DONE)
        return True


class ServingGateway:

    def __init__(self, engine, config=None, monitor=None, auto_start=True):
        """``engine``: an idle :class:`InferenceEngineV2` (the gateway
        takes ownership — ``drain()`` destroys it). ``monitor``: any
        object with the ``Monitor.write_events(event_list)`` interface;
        serving metrics are published through it every
        ``metrics_interval_steps`` engine steps."""
        self.engine = engine
        self.config = _apply_tuned_config(config or ServingConfig())
        self.monitor = monitor
        cfg = self.config
        self.scheduler = DynamicSplitFuseScheduler(
            engine,
            token_budget=cfg.token_budget or None,
            eos_token_id=cfg.eos_token_id,
            max_burst=cfg.max_burst,
            sampling=cfg.sampling,
            on_token=self._on_token)
        self.metrics = ServingMetrics(window=cfg.metrics_window)
        # disaggregated serving: a "prefill" gateway exports a KV
        # handoff record into a bounded outbox when a request finishes;
        # the fleet router claims it via take_handoff() and delivers it
        # to a "decode" gateway's import_handoff()
        self.role = cfg.role
        self._handoffs = OrderedDict()   # uid -> exported handoff record
        self._handoff_lock = tracked_lock(threading.Lock(),
                                          "ServingGateway._handoff_lock")
        self.gate = CapacityGate(engine, self.scheduler.budget, pool=cfg.role)
        self.queue = AdmissionQueue(cfg.max_queue_depth, cfg.admission_policy,
                                    cfg.block_timeout_s)
        self._uids = itertools.count()
        self._active = {}    # uid -> handle, admitted to the scheduler
        self._paused = []    # uids preempted (KV suspended), admission order
        self._finished = []  # uids completed during the current step
        self._cancels = []   # handles with a pending cancel request
        self._cancel_lock = tracked_lock(threading.Lock(),
                                         "ServingGateway._cancel_lock")
        self._state = "running"  # running|draining|stopped|failed
        self._state_lock = tracked_lock(threading.Lock(),
                                        "ServingGateway._state_lock")
        # live weight refresh: a staged swap the pump applies once the
        # engine is quiet (admission held, in-flight streams finish)
        self._pending_refresh = None
        self._refresh_lock = tracked_lock(threading.Lock(),
                                          "ServingGateway._refresh_lock")
        self._wake = threading.Event()
        # the CUDA device the pump thread makes current (an engine built on
        # "cuda" lives on the constructing thread's current device)
        device = getattr(engine, "device", None)
        self._cuda_index = None
        if isinstance(device, torch.device) and device.type == "cuda":
            self._cuda_index = (device.index if device.index is not None
                                else torch.cuda.current_device())
        self._pump_stop = False
        self._pump_thread = None
        # serving autotuner hooks: an optional traffic recorder (attach
        # via attach_recorder()) and the online SLO controller. Both off
        # is the default and costs one attribute check per submit — the
        # DS_AUTOTUNE=0 pipeline is otherwise byte-identical
        self._recorder = None
        self.controller = None
        if autotune_enabled(cfg):
            raise not_ported("the online SLO controller (serving.autotune.enabled / "
                             "DS_AUTOTUNE)", 4)
        if auto_start:
            self.start()

    # ---------------------------------------------------------------- client
    def submit(self, prompt_tokens, max_new_tokens=None, priority=None,
               deadline_ms=None, spec=True, adapter_id=None, sample=None,
               schema=None):
        """Accept a request from any thread → :class:`RequestHandle`.
        ``spec=False`` opts this request out of speculative decoding
        (it still rides in verify batches, just without drafts).
        ``adapter_id`` routes the request through that LoRA adapter's
        weights (None = base model). ``sample`` is a per-request
        on-device sampling spec (``{"temperature", "top_k", "top_p",
        "seed"}``, all optional); when it carries no ``seed`` one is
        derived deterministically from the request uid, so trace
        replays and fleet failovers draw the identical stream.
        ``schema`` constrains generation to a JSON schema (dict), a
        regex (str), or a precompiled
        :class:`~deepspeed_tpu_torch.inference.structured.grammar.CompiledSchema`;
        raw schemas compile through the process-wide schema cache over
        ``config.token_strings``.

        Raises :class:`RequestTooLargeError` when the request can never
        fit this engine, :class:`QueueFullError` per the admission
        policy, :class:`GatewayClosedError` after ``drain()`` began,
        ``UnknownAdapterError`` when no tier of the engine's adapter
        store can serve ``adapter_id``, and ``ValueError`` /
        ``SchemaCompileError`` for malformed sampling specs or schemas
        — all typed, all BEFORE the request queues.
        """
        prompt = [int(t) for t in np.atleast_1d(np.asarray(prompt_tokens))]
        max_new = int(max_new_tokens if max_new_tokens is not None
                      else self.config.default_max_new_tokens)
        prio = int(priority if priority is not None
                   else self.config.default_priority)
        if max_new < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new}")
        if deadline_ms is not None and deadline_ms <= 0:
            raise ValueError(f"deadline_ms must be > 0, got {deadline_ms}")
        if self._state in ("draining", "stopped"):
            raise GatewayClosedError("gateway is draining — not accepting requests")
        if self._state == "failed":
            raise GatewayFailedError("gateway pump died; rebuild the gateway")
        if adapter_id:
            # typed unknown-adapter rejection at the door — NOT a
            # mid-pump failure after the request already queued
            knows = getattr(self.engine, "knows_adapter", None)
            if knows is None or not knows(adapter_id):
                self.metrics.count("rejected_unknown_adapter")
                raise UnknownAdapterError(
                    f"adapter {adapter_id} is not registered with this "
                    f"replica (hot, host, or published)",
                    adapter_id=int(adapter_id))
        raw_schema = None
        if sample is not None:
            # typed pre-admission validation: a malformed spec fails at
            # the door, never mid-pump after the request already queued
            try:
                validate_sample_spec(sample)
            except ValueError:
                self.metrics.count("rejected_bad_sample")
                raise
            sample = dict(sample)
        if schema is not None:
            if getattr(self.engine, "structured", None) is None:
                self.metrics.count("rejected_schema")
                raise ValueError(
                    "schema given but constrained decoding is disabled on "
                    "this replica (config.structured.enabled / DS_CONSTRAINED)")
            if isinstance(schema, CompiledSchema):
                raw_schema = schema.schema
            else:
                # compile at the door through the process-wide cache:
                # repeat schemas hit; malformed ones raise typed here
                raw_schema = schema
                toks = self.config.token_strings
                if not toks:
                    self.metrics.count("rejected_schema")
                    raise ValueError(
                        "raw schema given but config.token_strings is unset — "
                        "pass a precompiled CompiledSchema or configure the "
                        "tokenizer surface")
                try:
                    schema = schema_cache().get_or_compile(
                        schema, toks, self.config.eos_token_id)
                except Exception:
                    self.metrics.count("rejected_schema")
                    raise
        try:
            self.gate.check_feasible(len(prompt), max_new)
        except Exception:
            self.metrics.count("rejected_too_large")
            raise
        uid = next(self._uids)
        if sample is not None and "seed" not in sample:
            # resolve the seed AT THE GATEWAY, derived from the request
            # uid: the recorder below sees the RESOLVED spec, so a trace
            # replay (or a failover resubmit reusing the uid) draws the
            # bit-identical stream
            sample["seed"] = derive_seed(env_int("DS_SEED"), uid)
        recorder = self._recorder
        if recorder is not None:
            # record OFFERED traffic (pre-admission): a replay must let
            # the candidate config make its own admission decisions
            recorder.record(prompt, max_new, prio, adapter_id=adapter_id,
                            sample=sample, schema=raw_schema)
        handle = RequestHandle(uid, prompt, max_new, prio,
                               deadline_ms / 1e3 if deadline_ms is not None else None,
                               spec=spec, adapter_id=adapter_id,
                               sample=sample, schema=schema)
        handle._cancel_cb = self._request_cancel
        try:
            shed = self.queue.push(handle)
        except Exception as e:
            if isinstance(e, QueueFullError):
                self.metrics.count("rejected_queue_full")
                # estimated-wait hints for routing layers: how deep the
                # line is, how much KV the prefix cache could give back,
                # and a rough wait guess from observed queue-wait times —
                # enough for a router to pick "retry elsewhere" over
                # "shed fleet-wide" without string-matching the message
                qw = self.metrics.queue_wait
                e.details.setdefault("queue_depth", len(self.queue))
                e.details.update(
                    pool=self.gate.pool,
                    evictable_blocks=int(getattr(self.engine,
                                                 "evictable_blocks", 0)),
                    active=self.gate.active,
                    est_wait_s=round(qw.total_ms / qw.count / 1e3, 4)
                    if qw.count else None)
                if adapter_id:
                    # adapter-miss hint: a router seeing hot=False should
                    # prefer a replica whose hot set already holds this
                    # adapter over re-queueing here behind a promotion
                    has = getattr(self.engine, "has_adapter", None)
                    e.details.update(
                        adapter_id=int(adapter_id),
                        adapter_hot=bool(has(adapter_id)) if has else False)
            raise
        self.metrics.count("submitted")
        self.metrics.gauge_peak("queue_depth_peak",
                                getattr(handle, "_depth_at_enqueue", 1))
        if shed is not None:
            self.metrics.count("shed")
            shed._finish("shed", RequestShedError(
                f"request {shed.uid} (priority {shed.priority}) evicted from a "
                f"full queue by request {handle.uid} (priority {prio})"))
        # KV-tier prefetch kick at ADMISSION, not at scheduling: the
        # tier's worker stages host→device copies of this prompt's
        # demoted prefix while the request waits in the queue, so the
        # copy is already on device when the pump acquires the prefix
        prefetch = getattr(self.engine, "prefetch_prefix", None)
        if prefetch is not None:
            prefetch(prompt)
        if adapter_id:
            # same overlap trick for cold adapters: stage the padded
            # slabs on the store's worker while the request queues
            pf = getattr(self.engine, "prefetch_adapter", None)
            if pf is not None:
                pf(adapter_id)
        self._wake.set()
        return handle

    def _request_cancel(self, handle):
        with self._cancel_lock:
            self._cancels.append(handle)
        self._wake.set()

    # ------------------------------------------------------ trace recording
    def attach_recorder(self, recorder):
        """Record every feasible ``submit()`` into ``recorder`` (anything
        with the JAX package's ``TraceRecorder.record`` interface) until
        :meth:`detach_recorder`. Returns the recorder for chaining."""
        self._recorder = recorder
        return recorder

    def detach_recorder(self):
        """Stop recording; returns the detached recorder (or None)."""
        recorder, self._recorder = self._recorder, None
        return recorder

    # ------------------------------------------------------------- lifecycle
    def start(self):
        if self._pump_thread is not None:
            return
        with self._state_lock:
            self._pump_stop = False
        self._pump_thread = threading.Thread(target=self._run, name="ds-serve-pump",
                                             daemon=True)
        self._pump_thread.start()
        if self.controller is not None:
            self.controller.start()

    def drain(self, timeout=None):
        """Stop admitting, finish everything in flight (queued requests
        included — they were accepted), then stop the pump and destroy
        the engine. Raises :class:`TimeoutError` if in-flight work does
        not finish in time (engine left alive for inspection)."""
        timeout = self.config.drain_timeout_s if timeout is None else timeout
        with self._state_lock:
            if self._state in ("stopped", "failed"):
                return
            self._state = "draining"
        if self.controller is not None:
            self.controller.stop()
        self.queue.close()
        self._wake.set()
        thread = self._pump_thread
        if thread is None:
            # manual-pump mode (auto_start=False): drive the pump inline
            deadline = time.monotonic() + timeout
            while self._active or len(self.queue) > 0:
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"drain: in-flight requests still running after "
                        f"{timeout}s ({len(self._active)} active, "
                        f"{len(self.queue)} queued)")
                self._pump_once()
        else:
            # the pump thread exits on its own once draining finds
            # nothing in flight (see _run)
            thread.join(timeout=timeout)
            if thread.is_alive():
                raise TimeoutError(
                    f"drain: in-flight requests still running after {timeout}s "
                    f"({len(self._active)} active, {len(self.queue)} queued)")
            self._pump_thread = None
        if self._state != "failed":
            with self._state_lock:
                self._state = "stopped"
            self.engine.destroy()

    def shutdown(self):
        """Hard stop: fail every outstanding request and destroy the
        engine. For aborts; prefer :meth:`drain` for clean exits."""
        with self._state_lock:
            if self._state == "stopped":
                return
            self._state = "draining"  # reject new submits while we tear down
        self.queue.close()
        self._stop_pump()
        self._fail_outstanding(GatewayClosedError("gateway shut down"))
        with self._state_lock:
            self._state = "stopped"
        self.engine.destroy()

    def kill(self, error=None):
        """Hard, ungraceful death — the fault-injection / fleet-crash
        primitive. Stops the pump, fails EVERY outstanding request with
        ``error`` (default :class:`GatewayFailedError`), marks the
        gateway ``failed`` (a killed replica is not a cleanly stopped
        one) and releases the engine's device memory. Unlike a real pump crash this is
        synchronous: when it returns, no handle is left hanging."""
        with self._state_lock:
            if self._state in ("stopped", "failed"):
                return
            self._state = "failed"
        self.queue.close()
        self._stop_pump()
        self._fail_outstanding(error or GatewayFailedError("gateway killed"))
        try:
            self.engine.destroy()
        except Exception:
            logger.exception("engine destroy failed during kill()")

    def shed_queued(self, error):
        """Fail every request still WAITING in the admission queue with
        the typed ``error``; active (streaming) requests are untouched.
        This is the queued-work half of a rolling-restart handoff: the
        fleet router sees a retry-elsewhere error and replays each shed
        request on a peer replica from its prompt (nothing was streamed
        yet, so nothing can double-emit). Returns the number shed."""
        n = 0
        for entry in self.queue.candidates():
            if self.queue.remove(entry) and entry._finish("failed", error):
                self.metrics.count("failed")
                n += 1
        return n

    # -------------------------------------------------------- weight refresh
    @property
    def weight_version(self):
        """The engine's adopted weight version (0 = as-built)."""
        engine = self.engine
        return int(getattr(engine, "weight_version", 0)) if engine is not None else 0

    def refresh_weights(self, params, version, timeout=None):
        """Live, no-drain weight refresh: stage ``params`` for the pump
        to swap in once the engine is quiet. Admission is HELD (queued
        requests wait, nothing is shed) while in-flight streams finish on
        the old weights; the pump then swaps the param tree in place —
        no engine rebuild, no recompilation — invalidates every trace of
        old-version KV (prefix trie, tier-2 store, handoff outbox), and
        re-opens admission on the new version. Blocks until applied.

        Raises the swap's error if it failed (the pump marks the gateway
        failed — a mid-swap crash must look like a crash, not a silently
        half-refreshed replica) and :class:`TimeoutError` when in-flight
        work does not quiesce in time (the staged swap is withdrawn and
        admission resumes on the old version — nothing was adopted)."""
        timeout = self.config.drain_timeout_s if timeout is None else timeout
        if self._state != "running":
            raise GatewayClosedError(
                f"weight refresh on a {self._state} gateway")
        pending = {"params": params, "version": int(version),
                   "done": threading.Event(), "error": None}
        with self._refresh_lock:
            if self._pending_refresh is not None:
                raise RuntimeError("a weight refresh is already in progress")
            self._pending_refresh = pending
        self._wake.set()
        if self._pump_thread is None:
            # manual-pump mode (auto_start=False): drive the pump inline
            deadline = time.monotonic() + timeout
            while not pending["done"].is_set() and time.monotonic() <= deadline:
                try:
                    self._pump_once()
                except BaseException as e:
                    with self._state_lock:
                        self._state = "failed"
                    self._fail_outstanding(GatewayFailedError(
                        f"pump died mid-refresh: {type(e).__name__}: {e}"))
                    break
        if not pending["done"].wait(timeout):
            with self._refresh_lock:
                if self._pending_refresh is pending:
                    self._pending_refresh = None  # withdraw; admission resumes
            raise TimeoutError(
                f"weight refresh to version {version}: in-flight requests "
                f"still running after {timeout}s — nothing adopted")
        if pending["error"] is not None:
            raise pending["error"]
        return int(version)

    def _maybe_refresh(self):
        """Pump-side half of :meth:`refresh_weights`: while a swap is
        staged, admission stays held; once the last in-flight request
        retires, swap in place and invalidate old-version KV."""
        with self._refresh_lock:
            pending = self._pending_refresh
        if pending is None:
            return False
        if self._active:
            return False  # in-flight streams finish on the old weights
        try:
            self.engine.swap_params(pending["params"], pending["version"])
        except BaseException as e:
            pending["error"] = e
            with self._refresh_lock:
                self._pending_refresh = None
            pending["done"].set()
            raise  # pump crash path: a mid-swap failure fails the replica
        with self._handoff_lock:
            self._handoffs.clear()  # exported records predate the new weights
        with self._refresh_lock:
            self._pending_refresh = None
        self.metrics.count("weight_refreshes")
        logger.info(f"serving: weights refreshed to version "
                    f"{pending['version']} in place")
        pending["done"].set()
        return True

    def prefix_match_len(self, prompt_tokens):
        """Read-only placement signal: leading tokens of
        ``prompt_tokens`` whose KV this gateway's engine already caches
        (0 when the prefix cache is off or the gateway is not running).
        Never creates a sequence, takes no leases, skews no hit-rate
        stats — safe for a router to call on every placement."""
        if self._state != "running":
            return 0
        engine = self.engine
        fn = getattr(engine, "prefix_match_len", None) if engine is not None \
            else None
        return int(fn(prompt_tokens)) if fn is not None else 0

    def inflight(self):
        """Request counts by stage — the router's least-loaded signal.
        Reads race the pump benignly (a load hint, not an invariant)."""
        return {"queued": len(self.queue),
                "active": len(self._active),
                "paused": len(self._paused)}

    def _stop_pump(self):
        if self.controller is not None:
            self.controller.stop()
        thread = self._pump_thread
        with self._state_lock:
            self._pump_stop = True
        self._wake.set()
        if thread is not None and thread is not threading.current_thread():
            thread.join(timeout=30)
        self._pump_thread = None

    def _fail_outstanding(self, error):
        with self._refresh_lock:
            pending, self._pending_refresh = self._pending_refresh, None
        if pending is not None:
            # never strand a refresh caller on a dead pump
            if pending.get("error") is None:
                pending["error"] = error
            pending["done"].set()
        for entry in self.queue.candidates():
            self.queue.remove(entry)
            if entry._finish("failed", error):
                self.metrics.count("failed")
        for uid, handle in list(self._active.items()):
            try:
                self.scheduler.cancel(uid)
            except Exception:
                pass
            if handle._finish("failed", error):
                self.metrics.count("failed")
        self._active.clear()
        self._paused = []

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.drain()
        else:
            self.shutdown()
        return False

    # ------------------------------------------------------------------ pump
    def _run(self):
        device = self._cuda_index
        while not self._pump_stop:
            try:
                if device is not None:
                    # a new thread's current device is device 0: the engine's
                    # kernels, streams and events must land on the engine's card
                    torch.cuda.set_device(device)
                    device = None
                did_work = self._pump_once()
            except Exception as e:  # crash-safe: never hang clients
                logger.exception("serving pump died")
                with self._state_lock:
                    self._state = "failed"
                self._fail_outstanding(GatewayFailedError(
                    f"serving pump died: {type(e).__name__}: {e}"))
                return
            in_flight = bool(self._active) or len(self.queue) > 0
            if not in_flight and self._state == "draining":
                return
            if not did_work:
                self._wake.wait(timeout=self.config.idle_poll_s if in_flight
                                else 0.05)
                self._wake.clear()

    def _pump_once(self):
        """One pump iteration; True when any request made progress."""
        did = False
        did |= self._process_cancels()
        did |= self._process_deadlines()
        did |= self._maybe_refresh()
        refreshing = self._pending_refresh is not None
        if not refreshing:  # admission held while a weight swap is staged
            did |= self._admit()
        did |= self._resume_paused()
        did |= self._step()
        self.metrics.gauge(
            queue_depth=len(self.queue),
            running=len(self._active) - len(self._paused),
            paused=len(self._paused),
            kv_free_blocks=int(self.engine.free_blocks),
            kv_occupancy=round(1.0 - self.engine.free_blocks /
                               max(self.gate.usable_blocks, 1), 4))
        prefix_cache = getattr(self.engine, "prefix_cache", None)
        if prefix_cache is not None:
            self.metrics.set_external("Serve/PrefixCache", prefix_cache.stats())
        kv_tier = getattr(self.engine, "kv_tier", None)
        if kv_tier is not None:
            self.metrics.set_external("Serve/KVTier", kv_tier.stats())
        spec = getattr(self.engine, "spec", None)
        if spec is not None:
            self.metrics.set_external("Serve/Spec", spec.stats())
        lora_store = getattr(self.engine, "lora_store", None)
        if lora_store is not None:
            self.metrics.set_external("Serve/LoRA", lora_store.stats())
        syncs = getattr(self.engine, "host_syncs", None)
        if syncs is not None:
            self.metrics.set_external("Serve/Engine", {
                "host_syncs": int(syncs),
                "tokens_emitted": int(self.engine.tokens_emitted),
                "syncs_per_token": self.engine.syncs_per_generated_token,
                "async_burst": int(getattr(self.engine, "async_burst", 0)),
            })
        interval = self.config.metrics_interval_steps
        if self.monitor is not None and interval and did:
            steps = self.metrics.snapshot()["counters"]["engine_steps"]
            if steps and steps % interval == 0:
                self.metrics.write_events(self.monitor, step=steps)
        return did

    def _process_cancels(self):
        with self._cancel_lock:
            cancels, self._cancels = self._cancels, []
        did = False
        for handle in cancels:
            if handle.done:
                continue
            did |= self._terminate(handle, "cancelled", RequestCancelledError(
                f"request {handle.uid} cancelled after "
                f"{len(handle._collected)} tokens"), "cancelled")
        return did

    def _process_deadlines(self):
        now = time.monotonic()
        did = False
        for entry in self.queue.expired(now):
            did |= self._terminate(entry, "deadline", DeadlineExceededError(
                f"request {entry.uid} expired in queue after "
                f"{(now - entry.submitted_at) * 1e3:.0f}ms"), "deadline_expired")
        for uid, handle in list(self._active.items()):
            if handle.deadline is not None and now >= handle.deadline:
                did |= self._terminate(handle, "deadline", DeadlineExceededError(
                    f"request {uid} exceeded its deadline mid-generation "
                    f"({len(handle._collected)} tokens generated)"),
                    "deadline_expired")
        return did

    def _terminate(self, handle, status, error, counter):
        """Stop a queued or active request with the given terminal state."""
        uid = handle.uid
        if uid in self._active:
            self.scheduler.cancel(uid)
            self.scheduler.retire(uid)
            self._release(handle)
        elif not self.queue.remove(handle):
            return False  # already finished concurrently
        if handle._finish(status, error):
            self.metrics.count(counter)
            return True
        return False

    def _release(self, handle):
        self.gate.release(len(handle.prompt), handle.max_new_tokens)
        self._active.pop(handle.uid, None)
        if handle.uid in self._paused:
            self._paused.remove(handle.uid)

    def _admit(self):
        """Move queued requests into the scheduler, highest priority
        first, while their full KV footprint fits; optionally preempt
        lower-priority running requests for the head of the queue."""
        did = False
        for entry in self.queue.candidates():
            plen, max_new = len(entry.prompt), entry.max_new_tokens
            while not self.gate.try_commit(plen, max_new):
                if not self.config.allow_preemption or not self._preempt_for(entry):
                    return did  # strict priority order: no skip-ahead
            if not self.queue.remove(entry):  # cancelled concurrently
                self.gate.release(plen, max_new)
                continue
            if entry.done:  # shed/failed between snapshot and now
                self.gate.release(plen, max_new)
                continue
            schema = getattr(entry, "schema", None)
            try:
                self.scheduler.add_request(entry.uid, entry.prompt,
                                           max_new_tokens=max_new,
                                           priority=entry.priority,
                                           spec=getattr(entry, "spec", True),
                                           adapter_id=getattr(entry, "adapter_id",
                                                              None),
                                           sample=getattr(entry, "sample", None),
                                           schema=schema)
            except Exception as e:
                # schema bind failures (every DFA slot leased by a live
                # sequence, state overflow) are per-request admission
                # failures just like typed adapter errors — fail THIS
                # request retryably, never the pump
                if not isinstance(e, ServingError) and schema is None:
                    raise
                # typed adapter failure at bind time (hot set saturated
                # with leased slots, publication vanished): fail THIS
                # request with the retryable error instead of killing
                # the pump — the fleet router fails it over
                self.gate.release(plen, max_new)
                if entry._finish("failed", e):
                    self.metrics.count("rejected_schema" if schema is not None
                                       else "rejected_adapter")
                did = True
                continue
            entry.status = "running"
            entry.queue_wait_s = time.monotonic() - entry.submitted_at
            self.metrics.observe_queue_wait(entry.queue_wait_s)
            self.metrics.count("admitted")
            self._active[entry.uid] = entry
            did = True
        return did

    def _preempt_for(self, entry):
        """Suspend the lowest-priority running request whose priority is
        strictly below ``entry``'s; False when no valid victim exists."""
        running = [(uid, h) for uid, h in self._active.items()
                   if uid not in self._paused]
        victims = [(uid, h) for uid, h in running if h.priority < entry.priority]
        if not victims:
            return False
        # lowest priority loses; youngest among ties (oldest keeps running)
        uid, handle = min(reversed(victims), key=lambda it: it[1].priority)
        try:
            self.scheduler.pause(uid)
        except ValueError:
            # the pipelined-burst drain inside pause() can discover the
            # victim already finished — nothing left to preempt; the
            # normal finish path releases its gate tokens
            return False
        self.gate.release(len(handle.prompt), handle.max_new_tokens)
        self._paused.append(uid)
        self.metrics.count("preemptions")
        logger.info(f"serving: preempted request {uid} (priority "
                    f"{handle.priority}) for request {entry.uid} (priority "
                    f"{entry.priority})")
        return True

    def _resume_paused(self):
        """Bring preempted requests back once the pool has room again
        (highest priority first; admitted queue entries take precedence
        because _admit runs before this)."""
        did = False
        for uid in sorted(self._paused, key=lambda u: -self._active[u].priority):
            handle = self._active[uid]
            if not self.gate.try_commit(len(handle.prompt), handle.max_new_tokens):
                break
            self.scheduler.unpause(uid)
            self._paused.remove(uid)
            self.metrics.count("resumes")
            did = True
        return did

    def _step(self):
        if not any(uid not in self._paused for uid in self._active):
            return False
        stepped = self.scheduler.step()
        self.metrics.count("engine_steps")
        if not stepped and not self._finished:
            # every live request is schedulable yet nothing ran — a real
            # stall would spin the pump forever; fail fast instead
            raise RuntimeError(
                f"scheduler stalled with {len(self._active)} active requests")
        for uid in self._finished:
            handle = self._active.get(uid)
            if handle is None:
                continue
            self.scheduler.retire(uid)
            self._release(handle)
            if self.role == "prefill":
                # retire first: the release path folds the request's
                # full blocks into the trie, which is what export walks
                self._export_handoff(handle)
            if handle._finish("completed"):
                self.metrics.count("completed")
        self._finished = []
        return True

    def _export_handoff(self, handle):
        """Prefill-role finish hook (pump thread only — the export
        gathers from the donated pool): serialize the request's cached
        prompt KV into the outbox for the router to claim via
        :meth:`take_handoff` and deliver to a decode replica. An export
        failure is contained — the router re-plans the request; it must
        never take down the pump."""
        exporter = getattr(self.engine, "export_prefix", None)
        if exporter is None:
            return
        try:
            record = exporter(handle.prompt)
        except Exception:
            logger.exception(
                f"handoff export failed for request {handle.uid}")
            return
        if record is None:
            return
        with self._handoff_lock:
            self._handoffs[handle.uid] = record
            while len(self._handoffs) > _HANDOFF_OUTBOX:
                self._handoffs.popitem(last=False)
        self.metrics.count("handoffs_exported")

    def take_handoff(self, uid):
        """Claim (pop) the exported handoff record for ``uid``; None
        when no export landed (tierless engine, export failure, or the
        outbox rotated it out). Safe from any thread."""
        with self._handoff_lock:
            return self._handoffs.pop(uid, None)

    def import_handoff(self, record):
        """Adopt a peer prefill replica's KV handoff record into this
        engine's spill tier (decode role). Validation errors propagate
        to the caller — a forged/torn record must fail the handoff, not
        be half-adopted. → blocks adopted. Safe from any thread."""
        importer = getattr(self.engine, "import_prefix", None)
        if importer is None or record is None:
            return 0
        n = int(importer(record))
        self.metrics.count("handoffs_imported")
        return n

    def _on_token(self, uid, token, done):
        """Streaming hook, called by the scheduler for every accepted
        token (pump thread)."""
        handle = self._active.get(uid)
        if handle is None:
            return
        now = time.monotonic()
        if handle._first_token_at is None:
            handle._first_token_at = now
            handle.ttft_s = now - handle.submitted_at
            self.metrics.observe_ttft(handle.ttft_s)
        else:
            self.metrics.observe_token_latency(now - handle._last_token_at)
        handle._last_token_at = now
        handle._emit(int(token))
        self.metrics.count("tokens_generated")
        if done:
            self._finished.append(uid)

    # ------------------------------------------------------------------ misc
    @property
    def state(self):
        return self._state

    def snapshot(self):
        """Metrics snapshot plus gateway state (tests / CLI)."""
        snap = self.metrics.snapshot()
        snap["state"] = self._state
        return snap
