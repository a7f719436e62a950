"""SLO metrics for the serving gateway.

Port of ``deepspeed_tpu/serving/metrics.py``, copied as it is but for two
counters the JAX gateway counts and the JAX table lacks
(``rejected_bad_sample``, ``rejected_schema``: there the count raises
``KeyError`` in place of the typed rejection). Counters +
latency distributions a serving operator actually pages on: TTFT (submit
-> first token), per-token decode latency, queue depth, KV occupancy,
admission outcomes, preemptions. Everything is exported two ways:
``snapshot()`` (a plain dict — tests and the CLI read it) and
``write_events(monitor)``, which routes ``(tag, value, step)`` tuples
through any object with the monitor backends' ``write_events(event_list)``
interface (the port's backends wait with the rest of the surface,
ROADMAP.md port queue item 6).

Thread-safe: ``submit()`` runs on client threads while the pump thread
records step/token events.
"""

import bisect
import threading
from collections import deque

# log-ish bucket upper bounds in milliseconds; the last bucket is +inf
LATENCY_BUCKETS_MS = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
                      100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0)


class _LatencyHistogram:
    """Fixed-bucket histogram + bounded reservoir for percentiles."""

    def __init__(self, window):
        self.buckets = [0] * (len(LATENCY_BUCKETS_MS) + 1)
        self.count = 0
        self.total_ms = 0.0
        self.max_ms = 0.0
        self._recent = deque(maxlen=window)

    def observe(self, ms):
        self.buckets[bisect.bisect_left(LATENCY_BUCKETS_MS, ms)] += 1
        self.count += 1
        self.total_ms += ms
        self.max_ms = max(self.max_ms, ms)
        self._recent.append(ms)

    def percentile(self, q):
        """q in [0, 100], over the recent window (exact, not bucketed)."""
        if not self._recent:
            return 0.0
        xs = sorted(self._recent)
        idx = min(len(xs) - 1, int(round(q / 100.0 * (len(xs) - 1))))
        return xs[idx]

    def to_dict(self):
        return {
            "count": self.count,
            "mean_ms": self.total_ms / self.count if self.count else 0.0,
            "p50_ms": self.percentile(50),
            "p95_ms": self.percentile(95),
            "p99_ms": self.percentile(99),
            "max_ms": self.max_ms,
            "bucket_bounds_ms": list(LATENCY_BUCKETS_MS),
            "buckets": list(self.buckets),
        }


class ServingMetrics:

    COUNTERS = ("submitted", "admitted", "completed", "cancelled",
                "rejected_queue_full", "rejected_too_large", "shed",
                "deadline_expired", "preemptions", "resumes",
                "tokens_generated", "engine_steps", "failed",
                "handoffs_exported", "handoffs_imported",
                "weight_refreshes", "rejected_unknown_adapter",
                "rejected_adapter", "rejected_bad_sample", "rejected_schema")

    def __init__(self, window=1024):
        self._lock = threading.Lock()
        self._counters = {name: 0 for name in self.COUNTERS}
        self.ttft = _LatencyHistogram(window)
        self.token_latency = _LatencyHistogram(window)  # inter-token gap
        self.queue_wait = _LatencyHistogram(window)     # submit -> admitted
        # gauges (last observed; *_peak are high-water marks)
        self._gauges = {"queue_depth": 0, "queue_depth_peak": 0, "running": 0,
                        "paused": 0, "kv_free_blocks": 0, "kv_occupancy": 0.0}
        # external gauge groups published under their own tag prefix
        # (e.g. "Serve/PrefixCache" -> {"hit_rate": ..., ...})
        self._external = {}

    # ---------------------------------------------------------------- events
    def count(self, name, n=1):
        with self._lock:
            self._counters[name] += n

    def observe_ttft(self, seconds):
        with self._lock:
            self.ttft.observe(seconds * 1e3)

    def observe_token_latency(self, seconds):
        with self._lock:
            self.token_latency.observe(seconds * 1e3)

    def observe_queue_wait(self, seconds):
        with self._lock:
            self.queue_wait.observe(seconds * 1e3)

    def gauge(self, **kwargs):
        with self._lock:
            self._gauges.update(kwargs)

    def gauge_peak(self, name, value):
        """High-water-mark gauge (e.g. queue_depth_peak)."""
        with self._lock:
            self._gauges[name] = max(self._gauges.get(name, 0), value)

    def set_external(self, tag_prefix, values):
        """Publish a subsystem's gauge dict under its own tag prefix —
        events come out as ``{tag_prefix}/{key}`` (the prefix-cache
        surface: ``Serve/PrefixCache/{hit_rate,tokens_saved,...}``)."""
        with self._lock:
            self._external[tag_prefix] = dict(values)

    # ---------------------------------------------------------------- export
    def snapshot(self):
        """Plain-dict view of everything (tests / CLI / debugging)."""
        with self._lock:
            return {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "external": {p: dict(v) for p, v in self._external.items()},
                "ttft": self.ttft.to_dict(),
                "token_latency": self.token_latency.to_dict(),
                "queue_wait": self.queue_wait.to_dict(),
            }

    def events(self, step=None):
        """Flatten to the monitor event wire format: (tag, value, step)."""
        snap = self.snapshot()
        step = snap["counters"]["engine_steps"] if step is None else step
        out = []
        for name, val in snap["counters"].items():
            out.append((f"serving/count/{name}", val, step))
        for name, val in snap["gauges"].items():
            out.append((f"serving/gauge/{name}", val, step))
        for prefix, vals in snap["external"].items():
            for name, val in vals.items():
                out.append((f"{prefix}/{name}", val, step))
        for hist in ("ttft", "token_latency", "queue_wait"):
            for stat in ("mean_ms", "p50_ms", "p95_ms", "p99_ms", "max_ms"):
                out.append((f"serving/{hist}/{stat}", snap[hist][stat], step))
        return out

    def write_events(self, monitor, step=None):
        """Publish through any object with the monitor backends'
        ``write_events(event_list)`` interface."""
        monitor.write_events(self.events(step))
