"""Per-replica health state machine.

Port of ``deepspeed_tpu/serving/fleet/health.py``, copied as it is.

Four states, three signals::

           consecutive failures >= degraded_after
    HEALTHY ------------------------------------> DEGRADED
       ^  \\                                         |
       |   \\  fatal failure OR                      | more failures
       |    \\ consecutive >= down_after             v
       |     +------------------------------------> DOWN
       |                                             |
       |   recovery_probes consecutive OK probes     | probe fails:
       +---------------------------------------------+ backoff doubles
                     (half-open probing)

RESTARTING is an administrative overlay: the router sets it around
``restart_replica()`` so an intentional drain is never misread as a
crash (failures recorded while RESTARTING are ignored).

All transitions are appended to ``transitions`` — ``(t, from, to, why)``
tuples — because the first question after any fleet incident is "what
did the health tracker think was happening, and when".

Thread-safety: ``record_failure``/``record_success`` run on per-request
relay threads while the heartbeat thread runs ``probe_due``/
``record_probe`` — every mutation takes ``_lock`` (an RLock, so the
state helpers can re-enter).
"""

import threading
import time

from deepspeed_tpu_torch.serving.fleet.config import FleetConfig
from deepspeed_tpu_torch.utils.sanitize import tracked_lock

HEALTHY = "healthy"
DEGRADED = "degraded"
DOWN = "down"
RESTARTING = "restarting"


class ReplicaHealth:
    """Health tracker for one replica. Pure bookkeeping — it never
    touches the replica itself; the router feeds it outcomes and asks
    ``routable`` / ``probe_due()`` back."""

    def __init__(self, config=None, now_fn=None, name="replica"):
        self.config = config or FleetConfig()
        self.name = name
        self._now = now_fn or time.monotonic  # injectable for tests
        self._lock = tracked_lock(threading.RLock(), "ReplicaHealth._lock")
        self._state = HEALTHY
        self._consecutive_failures = 0
        self._half_open_ok = 0        # consecutive good probes while DOWN
        self._probe_backoff = 0.0     # current DOWN-probe backoff
        self._next_probe_at = None    # monotonic time of next allowed probe
        self.transitions = []         # (t, from_state, to_state, why)

    # ------------------------------------------------------------- signals
    def record_success(self):
        """A request attempt on this replica finished cleanly."""
        with self._lock:
            self._consecutive_failures = 0
            if self._state == DEGRADED:
                self._to(HEALTHY, "request succeeded")

    def record_failure(self, why="request failed", fatal=False):
        """A request attempt failed. ``fatal`` (replica process death,
        pump crash) short-circuits straight to DOWN; otherwise the
        consecutive-failure thresholds decide."""
        with self._lock:
            if self._state == RESTARTING:
                return  # intentional drain noise, not a crash signal
            self._consecutive_failures += 1
            if fatal or (self._state != DOWN and
                         self._consecutive_failures >= self.config.down_after):
                if self._state != DOWN:
                    self._enter_down(why)
                return
            if (self._state == HEALTHY and
                    self._consecutive_failures >= self.config.degraded_after):
                self._to(DEGRADED, why)

    def _enter_down(self, why):
        with self._lock:
            self._to(DOWN, why)
            self._half_open_ok = 0
            self._probe_backoff = self.config.probe_backoff_s
            self._next_probe_at = self._now() + self._probe_backoff

    # ------------------------------------------------------------- probing
    def probe_due(self):
        """True when a DOWN replica's half-open probe window is open."""
        with self._lock:
            return (self._state == DOWN and self._next_probe_at is not None
                    and self._now() >= self._next_probe_at)

    def record_probe(self, ok):
        """Outcome of one half-open probe (only meaningful while DOWN).
        → True when this probe completed recovery (DOWN -> HEALTHY)."""
        with self._lock:
            if self._state != DOWN:
                return False
            if ok:
                self._half_open_ok += 1
                if self._half_open_ok >= self.config.recovery_probes:
                    self._to(HEALTHY, f"{self._half_open_ok} probes succeeded")
                    self._consecutive_failures = 0
                    self._half_open_ok = 0
                    self._next_probe_at = None
                    return True
                # promising — allow the next confirmation probe immediately
                self._next_probe_at = self._now()
                return False
            self._half_open_ok = 0
            self._probe_backoff = min(
                self._probe_backoff * self.config.probe_backoff_mult,
                self.config.probe_backoff_max_s)
            self._next_probe_at = self._now() + self._probe_backoff
            return False

    # ------------------------------------------------------------- restart
    def begin_restart(self):
        with self._lock:
            self._to(RESTARTING, "administrative restart")

    def end_restart(self, ok):
        """Restart finished: HEALTHY when the post-restart probe passed,
        straight to DOWN (half-open probing takes over) when it didn't."""
        with self._lock:
            self._consecutive_failures = 0
            if ok:
                self._to(HEALTHY, "restart complete")
            else:
                self._enter_down("restart failed its readiness probe")

    # ------------------------------------------------------------- queries
    @property
    def state(self):
        with self._lock:
            return self._state

    @property
    def routable(self):
        """May the router place NEW work here? HEALTHY and DEGRADED
        yes (DEGRADED only as a fallback), DOWN / RESTARTING no."""
        with self._lock:
            return self._state in (HEALTHY, DEGRADED)

    def snapshot(self):
        with self._lock:
            return {"state": self._state,
                    "consecutive_failures": self._consecutive_failures,
                    "half_open_ok": self._half_open_ok,
                    "probe_backoff_s": self._probe_backoff,
                    "transitions": len(self.transitions)}

    def _to(self, new_state, why):
        with self._lock:
            if new_state == self._state:
                return
            self.transitions.append((self._now(), self._state, new_state, why))
            self._state = new_state
