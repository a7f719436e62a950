"""Admission control + backpressure for the serving gateway.

Port of ``deepspeed_tpu/serving/admission.py``, copied as it is (host-side
Python, no device work). Two layers sit between ``submit()`` and the
engine:

1. :class:`AdmissionQueue` — the bounded wait queue. When full, the
   configured policy decides: ``reject`` (typed error to the caller),
   ``shed`` (evict the lowest-priority *queued* request to make room for
   a strictly higher-priority one), or ``block`` (the submitting thread
   waits for room, bounded by a timeout).

2. :class:`CapacityGate` — KV-block and token-budget accounting. A
   request is only handed to the scheduler once its *full* footprint
   (prompt + max_new_tokens, rounded up to KV blocks) fits the pool
   alongside every other active request's committed footprint, so the
   engine's "KV pool exhausted" runtime error can never fire mid-flight
   and wedge the pump. Requests that could never fit — even on an idle
   engine — are rejected at ``submit()`` with an actionable
   :class:`RequestTooLargeError` instead of queueing forever.
"""

import threading
import time


# ---------------------------------------------------------------------- errors
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


class GatewayClosedError(ServingError):
    """submit() after drain()/shutdown() began."""
    reason = "gateway_closed"
    retry_elsewhere = True  # this replica is leaving; peers may accept


class QueueFullError(ServingError):
    """The admission queue is full and the policy could not make room.

    ``details`` carries ``queue_depth`` (entries waiting here) and — when
    raised through ``ServingGateway.submit`` — ``evictable_blocks`` and
    ``est_wait_s`` so a router can weigh waiting against rerouting."""
    reason = "queue_full"
    retry_elsewhere = True


class RequestTooLargeError(ServingError):
    """The request can never fit this engine's KV pool / context window.
    Fleet-wide shed for homogeneous replicas — retrying elsewhere cannot
    help."""
    reason = "too_large"
    retry_elsewhere = False


class RequestShedError(ServingError):
    """This queued request was evicted to admit a higher-priority one."""
    reason = "shed"
    retry_elsewhere = True


class RequestCancelledError(ServingError):
    """The client cancelled the request before completion."""
    reason = "cancelled"
    retry_elsewhere = False


class DeadlineExceededError(ServingError):
    """deadline_ms expired before the request completed."""
    reason = "deadline"
    retry_elsewhere = False


class GatewayFailedError(ServingError):
    """The pump thread died; the engine state is no longer trustworthy."""
    reason = "gateway_failed"
    retry_elsewhere = True


# ---------------------------------------------------------------- capacity
class CapacityGate:
    """Static feasibility + dynamic KV-block commitment accounting.

    ``usable_blocks`` is snapshotted from an idle engine at gateway
    construction; every admitted request commits its worst-case block
    footprint until it finishes. Commitment is deliberately conservative
    (EOS may finish a request early) — the price is a little pool
    headroom, the payoff is that admission can never over-subscribe the
    pool and crash the pump mid-step.
    """

    def __init__(self, engine, token_budget, pool="unified"):
        # which fleet pool this gate protects ("unified" | "prefill" |
        # "decode") — stamped into every rejection's details so the
        # router can steer (a saturated prefill pool means degrade or
        # re-pool, NOT retry the same gate)
        self.pool = str(pool)
        self.block_size = int(engine.block_size)
        # evictable prefix-cache blocks are RECLAIMABLE capacity: the
        # allocator takes them back (LRU) on demand, so a warm cache must
        # not shrink what admission believes the pool can hold — caching
        # trades idle space for hits, never admission headroom
        self.usable_blocks = int(engine.free_blocks) + \
            int(getattr(engine, "evictable_blocks", 0))
        self.max_ctx_tokens = int(engine.max_ctx_tokens)
        self.max_tracked = int(engine.state_manager.max_tracked_sequences)
        self.token_budget = int(token_budget)
        self.committed_blocks = 0
        self.active = 0  # requests currently holding a commitment

    def footprint(self, prompt_len, max_new_tokens):
        """Worst-case KV blocks a request will ever hold."""
        return -(-(prompt_len + max_new_tokens) // self.block_size)

    def check_feasible(self, prompt_len, max_new_tokens):
        """Raise :class:`RequestTooLargeError` when the request could not
        run even on an idle engine."""
        if prompt_len < 1:
            raise RequestTooLargeError("empty prompt can never be scheduled")
        total = prompt_len + max_new_tokens
        if total > self.max_ctx_tokens:
            raise RequestTooLargeError(
                f"prompt ({prompt_len}) + max_new_tokens ({max_new_tokens}) = "
                f"{total} tokens exceeds the engine context window "
                f"({self.max_ctx_tokens}); shorten the prompt or lower "
                f"max_new_tokens",
                total_tokens=total, max_ctx_tokens=self.max_ctx_tokens,
                pool=self.pool)
        need = self.footprint(prompt_len, max_new_tokens)
        if need > self.usable_blocks:
            raise RequestTooLargeError(
                f"request needs {need} KV blocks ({total} tokens at block size "
                f"{self.block_size}) but the pool only has {self.usable_blocks} "
                f"— raise num_kv_blocks or shrink the request",
                needed_blocks=need, usable_blocks=self.usable_blocks,
                pool=self.pool)

    def try_commit(self, prompt_len, max_new_tokens):
        """Reserve the request's footprint; False when it doesn't fit
        right now (caller keeps it queued)."""
        need = self.footprint(prompt_len, max_new_tokens)
        if self.committed_blocks + need > self.usable_blocks:
            return False
        if self.active + 1 > self.max_tracked:
            return False
        self.committed_blocks += need
        self.active += 1
        return True

    def release(self, prompt_len, max_new_tokens):
        need = self.footprint(prompt_len, max_new_tokens)
        self.committed_blocks -= need
        self.active -= 1
        assert self.committed_blocks >= 0 and self.active >= 0, \
            "capacity release without matching commit"


# ---------------------------------------------------------------- wait queue
class AdmissionQueue:
    """Bounded, priority-aware wait queue with a pluggable full-queue
    policy. Thread-safe; ``push`` runs on client threads, everything
    else on the pump thread."""

    def __init__(self, max_depth, policy, block_timeout_s=30.0):
        self.max_depth = int(max_depth)
        self.policy = policy
        self.block_timeout_s = float(block_timeout_s)
        self._entries = []  # arrival order; scheduling order is computed
        self._lock = threading.Lock()
        self._space = threading.Condition(self._lock)  # entry removed
        self._arrived = threading.Condition(self._lock)  # entry added
        self.closed = False

    def __len__(self):
        with self._lock:
            return len(self._entries)

    def close(self):
        with self._lock:
            self.closed = True
            self._space.notify_all()
            self._arrived.notify_all()

    def push(self, entry):
        """Admit ``entry`` to the wait queue, applying the full-queue
        policy. Returns the entry that was shed to make room (caller
        must fail it), or None. Raises :class:`QueueFullError` /
        :class:`GatewayClosedError`."""
        with self._lock:
            if self.closed:
                raise GatewayClosedError("gateway is draining — not accepting requests")
            if len(self._entries) < self.max_depth:
                self._entries.append(entry)
                entry._depth_at_enqueue = len(self._entries)
                self._arrived.notify_all()
                return None
            if self.policy == "reject":
                raise QueueFullError(
                    f"admission queue full ({self.max_depth} waiting); retry "
                    f"later or raise serving.max_queue_depth",
                    queue_depth=len(self._entries), policy=self.policy)
            if self.policy == "shed":
                # evict the LOWEST-priority queued entry, youngest among
                # ties (older requests of equal priority keep their spot)
                victim = min(reversed(self._entries),
                             key=lambda e: e.priority)
                if victim.priority >= entry.priority:
                    raise QueueFullError(
                        f"admission queue full ({self.max_depth} waiting) and no "
                        f"queued request has priority < {entry.priority}",
                        queue_depth=len(self._entries), policy=self.policy)
                self._entries.remove(victim)
                self._entries.append(entry)
                entry._depth_at_enqueue = len(self._entries)
                self._arrived.notify_all()
                return victim
            # block: wait for room (deadline-bounded)
            deadline = time.monotonic() + self.block_timeout_s
            while len(self._entries) >= self.max_depth:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise QueueFullError(
                        f"admission queue stayed full for {self.block_timeout_s}s "
                        f"(policy=block)",
                        queue_depth=len(self._entries), policy=self.policy)
                self._space.wait(timeout=remaining)
                if self.closed:
                    raise GatewayClosedError(
                        "gateway is draining — not accepting requests")
            self._entries.append(entry)
            entry._depth_at_enqueue = len(self._entries)
            self._arrived.notify_all()
            return None

    def candidates(self):
        """Snapshot in scheduling order: highest priority first, FIFO
        within a priority level."""
        with self._lock:
            return sorted(self._entries, key=lambda e: -e.priority)

    def remove(self, entry):
        """Take ``entry`` out (admitted, cancelled, or expired). False if
        someone else already removed it."""
        with self._lock:
            try:
                self._entries.remove(entry)
            except ValueError:
                return False
            self._space.notify_all()
            return True

    def expired(self, now):
        """Entries whose deadline passed (still queued; caller removes)."""
        with self._lock:
            return [e for e in self._entries
                    if e.deadline is not None and now >= e.deadline]

    def wait_for_work(self, timeout):
        """Pump idle-wait: returns once an entry arrives / close / timeout."""
        with self._lock:
            if self._entries or self.closed:
                return
            self._arrived.wait(timeout=timeout)
