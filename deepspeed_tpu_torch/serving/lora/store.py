"""AdapterStore: the multi-tenant LoRA adapter pool (S-LoRA's paging).

Port of ``deepspeed_tpu/serving/lora/store.py``, with two tiers:

- **hot (device)** — the adapters currently servable, stacked into
  per-site rank-bucketed slabs ``A[site] [L, S, in, r]`` /
  ``B[site] [L, S, r, out]`` in the engine's dtype, on its device, plus
  ``scales [S]`` fp32 (alpha/true_rank per slot). Slot 0 is the base model
  (zero slabs, zero scale). Promotion, eviction and hot writes update the
  slabs IN PLACE on the current (serving) stream, where the JAX store
  builds new arrays: a write is ordered after every forward already
  dispatched on that stream, and the next forward reads the new rows, so
  the slabs' identity (and every shape) never changes.
- **host (RAM)** — cold adapters as numpy payloads under a byte-budget
  LRU; promotion pads the true rank to the bucket with zeros (exactly
  zero contribution: zero A columns x zero B rows), then rounds to the
  slab dtype (round-half-even, as the JAX store's numpy cast).

The disk tier (``publish_root``, :meth:`publish`, :meth:`adopt` and the
lazy adopt on promotion) is not ported yet: it raises, naming ROADMAP.md's
port queue item 4, which holds the serving stack it stands on.

Prefetch follows the JAX store: one daemon worker *stages* padded rows of
host payloads on the device and never writes the slabs. On CUDA it copies
from pinned memory on its own stream and records an event; the promotion
that consumes a staged copy makes the serving stream wait on that event
and marks the staged tensors as used there before their memory can be
reused. Slab writes happen on the calling thread, under the lock.

Leases: :meth:`bind` (admission) takes a per-uid refcount on the
adapter's slot and :meth:`release` (flush) drops it; eviction only ever
considers refcount-0 slots, so a slot is never repurposed under an
in-flight sequence (the structural half of tenant isolation; the
arithmetic half is the segmented kernel's row independence). The lock is
a plain ``threading.RLock`` (the JAX store's ``tracked_lock`` belongs to
the ``DS_SANITIZE`` audit, queue item 4).
"""

import threading
from collections import OrderedDict, deque

import numpy as np
import torch

from deepspeed_tpu_torch.device import resolve_device
from deepspeed_tpu_torch.roadmap import not_ported
from deepspeed_tpu_torch.serving.admission import ServingError

_MAX_STAGED = 8       # staged device copies kept (LRU) awaiting promotion
_MAX_INFLIGHT = 64    # prefetch fences kept for never-promoted kicks

# the attention projections the serving LoRA path targets (the classic
# LoRA site set; mlp sites would stack the same way)
LORA_SITES = ("q_proj", "k_proj", "v_proj", "o_proj")

_DISK_TIER = "the LoRA adapter disk tier (lora.publish_root, publish, adopt)"


class UnknownAdapterError(ServingError):
    """The request named an adapter no tier knows about — not hot, not
    host-resident. Terminal: no replica can serve it."""
    reason = "unknown_adapter"
    retry_elsewhere = False


class AdapterCapacityError(ServingError):
    """Every hot slot is leased by in-flight sequences, so the adapter
    cannot be promoted here right now. ``details`` carries the
    adapter-miss hint (``adapter_id``, ``hot_slots``, ``leased_slots``)
    so a router can retry on a replica whose hot set already holds the
    adapter."""
    reason = "adapter_capacity"
    retry_elsewhere = True


class AdapterStore:

    def __init__(self, dims, num_layers, *, n_hot=8, max_rank=16, host_bytes=1 << 30,
                 publish_root=None, prefetch=True, dtype=torch.float32, device=None):
        """``dims`` maps site name → ``(in_dim, out_dim)``; only sites
        present here are servable. ``n_hot`` counts ADAPTER slots — the
        slabs carry ``n_hot + 1`` rows (slot 0 = base). ``device=None`` is
        the GPU."""
        if publish_root:
            raise not_ported(_DISK_TIER, 4)
        self.dims = {str(k): (int(i), int(o)) for k, (i, o) in dims.items()}
        self.sites = tuple(sorted(self.dims))
        self.num_layers = int(num_layers)
        self.n_hot = max(1, int(n_hot))
        self.n_slots = self.n_hot + 1
        self.rank_bucket = max(1, int(max_rank))
        self.host_budget = int(host_bytes)
        self.prefetch_enabled = bool(prefetch)
        self.dtype = dtype
        self.device = resolve_device(device)

        L, S, r = self.num_layers, self.n_slots, self.rank_bucket
        self._a = {s: torch.zeros((L, S, self.dims[s][0], r), dtype=dtype, device=self.device)
                   for s in self.sites}
        self._b = {s: torch.zeros((L, S, r, self.dims[s][1]), dtype=dtype, device=self.device)
                   for s in self.sites}
        self._scales = torch.zeros((S,), dtype=torch.float32, device=self.device)

        self._hot = {}          # adapter_id -> slot
        self._slot_meta = {}    # slot -> {adapter_id, version, rank, alpha}
        self._refs = {}         # slot -> lease count (bound in-flight uids)
        self._uid_slot = {}     # uid -> slot (release bookkeeping)
        self._lru = OrderedDict()      # slot -> True (hot-set LRU)
        self._free = list(range(S - 1, 0, -1))  # pop() yields slot 1 first
        self._host = OrderedDict()     # adapter_id -> host payload
        self._host_bytes = 0
        self._staged = OrderedDict()   # adapter_id -> staged device copy
        self._inflight = OrderedDict()  # adapter_id -> fence Event
        self._queue = deque()
        self._queue_ready = threading.Condition()
        self._worker = None
        self._stage_stream = None
        self._shutdown = False

        self.registrations = 0
        self.promotions = 0
        self.evictions = 0
        self.host_evictions = 0
        self.hot_hits = 0
        self.hot_misses = 0
        self.swaps = 0          # in-place hot-swaps of a live slot (disk tier)
        self.prefetched = 0
        self.stage_hits = 0
        self.prefetch_errors = 0
        self.publish_rejects = 0  # rejected publications (disk tier)
        self._lock = threading.RLock()

    # --------------------------------------------------------------- helpers
    def _validate(self, adapter_id, layers, alpha):
        adapter_id = int(adapter_id)
        if adapter_id <= 0:
            raise ValueError(f"adapter_id must be positive (0 is the base "
                             f"slot), got {adapter_id}")
        if not layers:
            raise ValueError(f"adapter {adapter_id}: empty layer set")
        rank = None
        out = {}
        for site, (a, b) in layers.items():
            if site not in self.dims:
                raise ValueError(
                    f"adapter {adapter_id}: unknown site '{site}' "
                    f"(servable: {self.sites})")
            a = np.asarray(a)
            b = np.asarray(b)
            din, dout = self.dims[site]
            if a.shape != (self.num_layers, din, a.shape[-1]) or \
                    b.shape != (self.num_layers, a.shape[-1], dout):
                raise ValueError(
                    f"adapter {adapter_id} site '{site}': shapes "
                    f"{a.shape}/{b.shape} do not match [L={self.num_layers},"
                    f" in={din}, r]/[L, r, out={dout}]")
            r = int(a.shape[-1])
            if rank is None:
                rank = r
            elif r != rank:
                raise ValueError(
                    f"adapter {adapter_id}: sites disagree on rank "
                    f"({rank} vs {r} at '{site}')")
            out[site] = (a, b)
        if rank > self.rank_bucket:
            raise ValueError(
                f"adapter {adapter_id}: rank {rank} exceeds the store's "
                f"rank bucket {self.rank_bucket} (lora.max_rank)")
        return adapter_id, out, rank, float(alpha)

    @staticmethod
    def _payload_nbytes(layers):
        return int(sum(a.nbytes + b.nbytes for a, b in layers.values()))

    def _pad(self, arr, axis):
        """Zero-pad the rank axis up to the bucket (exactly zero delta)."""
        r = arr.shape[axis]
        if r == self.rank_bucket:
            return arr
        pad = [(0, 0)] * arr.ndim
        pad[axis] = (0, self.rank_bucket - r)
        return np.pad(arr, pad)

    def _rows(self, arr):
        """A numpy slab row → a host tensor in the slab dtype (one
        round-half-even cast, as the JAX store's ``astype``)."""
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.dtype)

    def _padded(self, payload):
        """Host payload → per-site rank-bucketed host slab rows in the slab
        dtype; a site the adapter does not touch gets zero rows."""
        L, r = self.num_layers, self.rank_bucket
        a, b = {}, {}
        for s in self.sites:
            din, dout = self.dims[s]
            if s in payload["layers"]:
                a[s] = self._rows(self._pad(payload["layers"][s][0], 2))
                b[s] = self._rows(self._pad(payload["layers"][s][1], 1))
            else:
                a[s] = torch.zeros((L, din, r), dtype=self.dtype)
                b[s] = torch.zeros((L, r, dout), dtype=self.dtype)
        return a, b

    # ---------------------------------------------------------- registration
    def register(self, adapter_id, layers, alpha, version=0):
        """Adopt an in-memory adapter straight into the host tier.
        ``layers`` is ``{site: (a [L, in, r], b [L, r, out])}``."""
        adapter_id, layers, rank, alpha = self._validate(adapter_id, layers, alpha)
        payload = {"layers": layers, "alpha": alpha, "rank": rank,
                   "version": int(version),
                   "nbytes": self._payload_nbytes(layers)}
        with self._lock:
            self._install_host_locked(adapter_id, payload)
            self.registrations += 1
        return rank

    def publish(self, adapter_id, layers, alpha, version=None):
        raise not_ported(_DISK_TIER, 4)

    def adopt(self, adapter_id, version=None):
        raise not_ported(_DISK_TIER, 4)

    def _install_host_locked(self, adapter_id, payload):
        with self._lock:  # re-entrant; caller already holds the RLock
            old = self._host.pop(adapter_id, None)
            if old is not None:
                self._host_bytes -= old["nbytes"]
            self._host[adapter_id] = payload
            self._host_bytes += payload["nbytes"]
            while self._host_bytes > self.host_budget and len(self._host) > 1:
                victim = next((aid for aid in self._host
                               if aid not in self._hot and aid != adapter_id),
                              None)
                if victim is None:
                    break  # everything cold enough to drop is hot or new
                dropped = self._host.pop(victim)
                self._host_bytes -= dropped["nbytes"]
                self.host_evictions += 1

    # ----------------------------------------------------------- hot slots
    def _write_slot_locked(self, slot, adapter_id, payload, staged=None):
        with self._lock:  # re-entrant; caller already holds the RLock
            if staged is not None and staged["version"] == payload["version"]:
                a_rows, b_rows = staged["a"], staged["b"]
                if staged["event"] is not None:
                    # the staged copies were made on the prefetch stream
                    stream = torch.cuda.current_stream(self.device)
                    stream.wait_event(staged["event"])
                    for t in (*a_rows.values(), *b_rows.values()):
                        t.record_stream(stream)
                self.stage_hits += 1
            else:
                a_rows, b_rows = self._padded(payload)
            for site in self.sites:
                self._a[site][:, slot].copy_(a_rows[site])
                self._b[site][:, slot].copy_(b_rows[site])
            self._scales[slot] = payload["alpha"] / float(payload["rank"])
            self._slot_meta[slot] = {"adapter_id": adapter_id,
                                     "version": payload["version"],
                                     "rank": payload["rank"],
                                     "alpha": payload["alpha"]}

    def _promote_locked(self, adapter_id):
        with self._lock:  # re-entrant; caller already holds the RLock
            payload = self._host.get(adapter_id)
            if payload is None:
                raise UnknownAdapterError(
                    f"adapter {adapter_id} is not registered in any tier",
                    adapter_id=adapter_id)
            slot = self._hot.get(adapter_id)
            if slot is not None:
                return slot
            if self._free:
                slot = self._free.pop()
            else:
                victim = next((s for s in self._lru
                               if self._refs.get(s, 0) == 0), None)
                if victim is None:
                    raise AdapterCapacityError(
                        f"no evictable hot slot for adapter {adapter_id}: all "
                        f"{self.n_hot} slots are leased by in-flight sequences",
                        adapter_id=adapter_id, hot_slots=self.n_hot,
                        leased_slots=sum(1 for r in self._refs.values() if r))
                self._evict_locked(victim)
                slot = self._free.pop()
            staged = self._staged.pop(adapter_id, None)
            self._write_slot_locked(slot, adapter_id, payload, staged=staged)
            self._hot[adapter_id] = slot
            self._lru[slot] = True
            self._lru.move_to_end(slot)
            self._host.move_to_end(adapter_id)
            self.promotions += 1
            return slot

    def _evict_locked(self, slot):
        with self._lock:  # re-entrant; caller already holds the RLock
            meta = self._slot_meta.pop(slot, None)
            if meta is not None:
                self._hot.pop(meta["adapter_id"], None)
            self._lru.pop(slot, None)
            self._refs.pop(slot, None)
            # defensive: a stale slot index can only ever contribute 0.0
            self._scales[slot] = 0.0
            self._free.append(slot)
            self.evictions += 1

    # --------------------------------------------------------------- leases
    def bind(self, uid, adapter_id):
        """Lease ``adapter_id``'s hot slot to sequence ``uid`` (promoting
        it first if cold) → slot index for batch packing. ``adapter_id``
        of None/0 is the base model: slot 0, no lease."""
        if adapter_id is None or int(adapter_id) == 0:
            return 0
        adapter_id = int(adapter_id)
        with self._lock:
            slot = self._hot.get(adapter_id)
            if slot is None:
                self.hot_misses += 1
                slot = self._promote_locked(adapter_id)
            else:
                self.hot_hits += 1
            prev = self._uid_slot.get(uid)
            if prev == slot:
                return slot  # re-bind of a live lease is idempotent
            if prev is not None:
                self._refs[prev] = max(0, self._refs.get(prev, 0) - 1)
            self._refs[slot] = self._refs.get(slot, 0) + 1
            self._uid_slot[uid] = slot
            self._lru[slot] = True
            self._lru.move_to_end(slot)
            self._host.move_to_end(adapter_id)
            return slot

    def release(self, uid):
        """Drop ``uid``'s lease (sequence flushed/retired/failed)."""
        with self._lock:
            slot = self._uid_slot.pop(uid, None)
            if slot is not None:
                self._refs[slot] = max(0, self._refs.get(slot, 0) - 1)

    def slot_of(self, uid):
        """The slot ``uid``'s lease pinned (0 = base / no lease)."""
        with self._lock:
            return self._uid_slot.get(uid, 0)

    # -------------------------------------------------------------- queries
    def has_adapter(self, adapter_id):
        """Is the adapter HOT (servable without a promotion)?"""
        if adapter_id is None or int(adapter_id) == 0:
            return True
        with self._lock:
            return int(adapter_id) in self._hot

    def known(self, adapter_id):
        """Is the adapter servable at all (any tier)?"""
        if adapter_id is None or int(adapter_id) == 0:
            return True
        adapter_id = int(adapter_id)
        with self._lock:
            return adapter_id in self._hot or adapter_id in self._host

    def hot_set(self):
        with self._lock:
            return sorted(self._hot)

    def version_of(self, adapter_id):
        with self._lock:
            slot = self._hot.get(int(adapter_id))
            if slot is not None:
                return self._slot_meta[slot]["version"]
            payload = self._host.get(int(adapter_id))
            return payload["version"] if payload else None

    def signature(self):
        """The static shape identity of the hot slabs: promotions,
        evictions and hot writes change slab VALUES only."""
        return (self.n_slots, self.rank_bucket, self.sites)

    def slabs(self):
        """The hot tier: ``(a, b, scales)`` with ``a[site] [L, S, in, r]``,
        ``b[site] [L, S, r, out]``, ``scales [S]`` fp32 — the live tensors,
        which later writes update in place."""
        with self._lock:
            return dict(self._a), dict(self._b), self._scales

    # ------------------------------------------------------------- prefetch
    def prefetch(self, adapter_id):
        """Fire-and-forget: stage this adapter's padded slab rows on the
        worker thread so the host→device copy overlaps queueing. Safe
        from any thread; never mutates the slabs."""
        if not self.prefetch_enabled or self._shutdown:
            return
        if adapter_id is None or int(adapter_id) == 0:
            return
        adapter_id = int(adapter_id)
        with self._lock:
            if adapter_id in self._hot or adapter_id in self._inflight:
                return
            if adapter_id not in self._host:
                return
            while len(self._inflight) >= _MAX_INFLIGHT:
                self._inflight.popitem(last=False)
            ev = threading.Event()
            self._inflight[adapter_id] = ev
            self._ensure_worker_locked()
        with self._queue_ready:
            self._queue.append((adapter_id, ev))
            self._queue_ready.notify()

    def _ensure_worker_locked(self):
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(target=self._worker_run,
                                            name="ds-lora-prefetch",
                                            daemon=True)
            self._worker.start()

    def _worker_run(self):
        while True:
            with self._queue_ready:
                while not self._queue and not self._shutdown:
                    self._queue_ready.wait()
                if self._shutdown:
                    return
                adapter_id, ev = self._queue.popleft()
            try:
                self._stage_adapter(adapter_id)
            except Exception:  # the promotion pads from the host payload instead
                with self._lock:
                    self.prefetch_errors += 1
            finally:
                ev.set()
                with self._lock:
                    self._inflight.pop(adapter_id, None)

    def _stage_adapter(self, adapter_id):
        with self._lock:
            payload = self._host.get(adapter_id)
            if payload is None or adapter_id in self._staged:
                return
            version = payload["version"]
        # pad, cast and copy outside the lock: the copy is the slow part
        a_rows, b_rows = self._padded(payload)
        event = None
        if self.device.type == "cuda":
            if self._stage_stream is None:
                self._stage_stream = torch.cuda.Stream(self.device)
            with torch.cuda.stream(self._stage_stream):
                a_dev = {s: t.pin_memory().to(self.device, non_blocking=True)
                         for s, t in a_rows.items()}
                b_dev = {s: t.pin_memory().to(self.device, non_blocking=True)
                         for s, t in b_rows.items()}
                event = torch.cuda.Event()
                event.record(self._stage_stream)
        else:
            a_dev, b_dev = a_rows, b_rows
        with self._lock:
            self._staged[adapter_id] = {"a": a_dev, "b": b_dev, "event": event,
                                        "version": version}
            self._staged.move_to_end(adapter_id)
            while len(self._staged) > _MAX_STAGED:
                self._staged.popitem(last=False)
            self.prefetched += 1

    # ------------------------------------------------------------ lifecycle
    def invalidate(self):
        """Drop every lease, hot slot, staged copy, and fence (base
        weight refresh: adapter deltas trained against the previous base
        must not be presumed valid under the new one). Host payloads
        stay — re-promotion is cheap."""
        with self._lock:
            for ev in self._inflight.values():
                ev.set()
            self._inflight.clear()
            self._staged.clear()
            for slot in list(self._slot_meta):
                self._evict_locked(slot)
            self._uid_slot.clear()
            self._refs.clear()
            self._scales.zero_()

    def shutdown(self):
        with self._lock:
            self._shutdown = True
        with self._queue_ready:
            self._queue_ready.notify_all()
        worker = self._worker
        if worker is not None and worker.is_alive():
            worker.join(timeout=2.0)
        with self._lock:
            for ev in self._inflight.values():
                ev.set()
            self._inflight.clear()
            self._staged.clear()
            self._host.clear()
            self._host_bytes = 0

    # -------------------------------------------------------------- metrics
    def stats(self):
        """Monitor-facing snapshot (``Serve/LoRA/*`` tags)."""
        with self._lock:
            binds = self.hot_hits + self.hot_misses
            return {
                "hot_adapters": len(self._hot),
                "hot_slots": self.n_hot,
                "rank_bucket": self.rank_bucket,
                "host_adapters": len(self._host),
                "host_bytes": self._host_bytes,
                "hot_hits": self.hot_hits,
                "hot_misses": self.hot_misses,
                "hot_hit_rate": round(self.hot_hits / binds, 4)
                if binds else 0.0,
                "promotions": self.promotions,
                "evictions": self.evictions,
                "host_evictions": self.host_evictions,
                "swaps": self.swaps,
                "prefetched": self.prefetched,
                "stage_hits": self.stage_hits,
                "prefetch_errors": self.prefetch_errors,
                "publish_rejects": self.publish_rejects,
                "leases": sum(self._refs.values()),
            }
