"""Disaggregated-serving coordination: handoff tracking + pool policy.

Port of ``deepspeed_tpu/serving/fleet/handoff.py``, copied as it is.

Two small, independently testable pieces the two-stage FleetRouter
composes:

- :class:`HandoffManager` tracks in-flight prefill→decode KV handoffs:
  a record is *published* when the prefill replica exports it, *
  delivered* when a decode replica imports it, and *acked* once the
  decode continuation verified the emitted prefix. Every record carries
  a deadline — a handoff the decode stage cannot claim in time is
  expired, counted, and the request re-planned (re-prefill or unified
  fallback) instead of waiting forever on a record that may never land.

- :class:`PoolScheduler` is the per-request disagg/unified policy with
  hysteresis: consecutive handoff-path failures flip it to DEGRADED
  (every request serves unified on a single replica — the safe mode
  that cannot lose requests), and while degraded it probes the disagg
  path on every Nth request; only ``recover_after`` consecutive
  successes flip it back, so a flapping pool cannot thrash the router
  between modes.

Both classes guard shared state with ``self._lock`` (relay threads and
the router's heartbeat tick all touch them).
"""

import threading
import time

from deepspeed_tpu_torch.serving.admission import ServingError
from deepspeed_tpu_torch.utils.sanitize import tracked_lock


class HandoffFailedError(ServingError):
    """The prefill→decode KV handoff was dropped, torn, expired, or
    rejected by validation — the request is re-planned (re-prefill on a
    survivor or unified fallback), never silently continued."""
    reason = "handoff_failed"
    retry_elsewhere = True


class HandoffManager:
    """Deadline-bounded ledger of in-flight prefill→decode handoffs."""

    def __init__(self, deadline_s=5.0, now_fn=None):
        self.deadline_s = float(deadline_s)
        self._now = now_fn or time.monotonic
        self._lock = tracked_lock(threading.Lock(), "HandoffManager._lock")
        self._inflight = {}   # uid -> {record, source, published_at, deadline}
        self.published = 0
        self.delivered = 0
        self.acked = 0
        self.failed = 0
        self.expired = 0

    def publish(self, uid, record, source):
        """Register a freshly exported handoff record for ``uid`` from
        prefill replica ``source``; the decode stage must claim it
        before ``deadline_s`` elapses."""
        now = self._now()
        with self._lock:
            self._inflight[uid] = {"record": record, "source": source,
                                   "published_at": now,
                                   "deadline": now + self.deadline_s}
            self.published += 1

    def record(self, uid):
        """→ the published entry for ``uid`` if it is still within its
        deadline, else None (an expired entry is dropped and counted —
        the caller must re-plan, not wait)."""
        now = self._now()
        with self._lock:
            entry = self._inflight.get(uid)
            if entry is None:
                return None
            if now > entry["deadline"]:
                del self._inflight[uid]
                self.expired += 1
                return None
            self.delivered += 1
            return entry

    def ack(self, uid):
        """Decode continuation verified — the handoff is complete."""
        with self._lock:
            if self._inflight.pop(uid, None) is not None:
                self.acked += 1

    def fail(self, uid, why=""):
        """The handoff cannot complete (record dropped, validation
        rejected it, decode pool gave up) — drop the entry and count."""
        with self._lock:
            self._inflight.pop(uid, None)
            self.failed += 1

    def inflight(self):
        with self._lock:
            return len(self._inflight)

    def stats(self):
        with self._lock:
            return {"inflight": len(self._inflight),
                    "published": self.published,
                    "delivered": self.delivered,
                    "acked": self.acked,
                    "failed": self.failed,
                    "expired": self.expired,
                    "deadline_s": self.deadline_s}


class PoolScheduler:
    """Hysteresis-gated per-request choice between disaggregated and
    unified serving."""

    NORMAL = "normal"
    DEGRADED = "degraded"

    def __init__(self, roles, fallback_after=2, recover_after=2,
                 probe_every=4, now_fn=None):
        # roles: replica name -> "prefill" | "decode" | "unified"
        self.roles = dict(roles)
        self.fallback_after = int(fallback_after)
        self.recover_after = int(recover_after)
        self.probe_every = int(probe_every)
        self._now = now_fn or time.monotonic
        # _to() re-acquires under callers, hence RLock
        self._lock = tracked_lock(threading.RLock(), "PoolScheduler._lock")
        self.mode = self.NORMAL
        self._consecutive_failures = 0
        self._consecutive_successes = 0
        self._requests_while_degraded = 0
        self.degraded_entries = 0
        self.degraded_exits = 0
        self.transitions = []   # (monotonic time, new mode, why)

    def role_of(self, name):
        return self.roles.get(name, "unified")

    def pool(self, role):
        """Replica names registered under ``role``."""
        return [n for n, r in self.roles.items() if r == role]

    def decide(self):
        """Per-request policy: 'disagg' or 'unified'. NORMAL mode always
        tries the disagg path; DEGRADED mode serves unified but probes
        disagg on every ``probe_every``-th request so recovery needs no
        operator action."""
        with self._lock:
            if self.mode == self.NORMAL:
                return "disagg"
            self._requests_while_degraded += 1
            if self._requests_while_degraded % self.probe_every == 0:
                return "disagg"
            return "unified"

    def note_success(self):
        """A disagg-path request completed cleanly."""
        with self._lock:
            self._consecutive_failures = 0
            if self.mode == self.DEGRADED:
                self._consecutive_successes += 1
                if self._consecutive_successes >= self.recover_after:
                    self._to(self.NORMAL, "recovered")
                    self.degraded_exits += 1

    def note_failure(self, why=""):
        """A disagg-path request hit a handoff/pool failure (it still
        completed — via re-prefill or unified fallback — but the disagg
        machinery is suspect)."""
        with self._lock:
            self._consecutive_successes = 0
            self._consecutive_failures += 1
            if self.mode == self.NORMAL and \
                    self._consecutive_failures >= self.fallback_after:
                self._to(self.DEGRADED, why or "consecutive_failures")
                self.degraded_entries += 1

    def _to(self, mode, why):
        with self._lock:
            self.mode = mode
            self._consecutive_failures = 0
            self._consecutive_successes = 0
            self._requests_while_degraded = 0
            self.transitions.append((self._now(), mode, why))

    def snapshot(self):
        with self._lock:
            return {"mode": self.mode,
                    "roles": dict(self.roles),
                    "consecutive_failures": self._consecutive_failures,
                    "consecutive_successes": self._consecutive_successes}

    def stats(self):
        with self._lock:
            return {"mode": self.mode,
                    "degraded": int(self.mode == self.DEGRADED),
                    "degraded_entries": self.degraded_entries,
                    "degraded_exits": self.degraded_exits,
                    "prefill_replicas": sum(1 for r in self.roles.values()
                                            if r == "prefill"),
                    "decode_replicas": sum(1 for r in self.roles.values()
                                           if r == "decode")}
