"""Tier orchestration: demotion, promotion, and async prefetch.

``TierManager`` sits between :class:`PrefixCacheManager` and
:class:`BlockedKVCache` and turns trie eviction into DEMOTION: when the
prefix cache reclaims ref-0 blocks under allocation pressure, their KV
is gathered on the device (one ``index_select`` per pool), quantized
there when the tier stores int8 (kernel K7), copied to host and adopted
by :class:`HostKVStore` before the pool ids are freed. The device→host
copy finishes before the ids are freed: it is a host sync, counted
through ``count_sync`` (the engine's ``count_host_sync``). A later prompt
whose trie match ends where a demoted chain begins PROMOTES the chain
back: the records are restored into freshly reserved pool blocks in
place and re-inserted as trie nodes, so prefill starts after the
restored span.

Async prefetch: ``prefetch(prompt)`` is kicked at admission (scheduler
``add_request``) and runs on a single daemon worker thread that must
NEVER touch the pool — the pool is written on the serving thread only.
The worker only *stages* host→device copies of matching tier-2 records:
on a CUDA pool, from pinned memory on the worker's own CUDA stream, with
an event recorded after the copies; the promotion that claims a staged
copy makes the serving stream wait on that event and marks the tensors
as used on it (``record_stream``), as the LoRA ``AdapterStore`` does.
The pool scatter happens on the serving thread inside ``acquire()``
behind ``wait_prefetch``, the completion fence before the sequence's
first forward.

Lock order (deadlock-free by construction): ``manager._lock`` →
``self._lock`` → ``store._lock``; ``wait_prefetch`` blocks BEFORE the
manager lock is taken, because the worker needs the manager lock for
its trie walk.

Port of ``deepspeed_tpu/inference/v2/kv_tier/tier_manager.py``; under
``DS_SANITIZE`` the locks are order-tracked (``tracked_lock``).
"""

import threading
import time
from collections import OrderedDict, deque

import torch

from deepspeed_tpu_torch.inference.v2.kv_tier.host_store import HostKVStore
from deepspeed_tpu_torch.inference.v2.kv_tier.quant import (handle_nbytes, quantize_handle,
                                                            split_blocks)
from deepspeed_tpu_torch.inference.v2.ragged.kv_cache import to_host
from deepspeed_tpu_torch.utils.sanitize import check_handoff_record, tracked_lock

_MAX_STAGED = 32      # staged device copies kept (LRU) awaiting promotion
_MAX_INFLIGHT = 256   # prefetch fences kept for never-acquired submits
_FENCE_TIMEOUT_S = 5.0


class TierManager:

    def __init__(self, manager, capacity_bytes, quantize=False,
                 quant_group_size=0, prefetch=True, count_sync=None):
        self.manager = manager          # PrefixCacheManager (owns the trie)
        self.kv_cache = manager.kv_cache
        self.block_size = int(manager.block_size)
        self.store = HostKVStore(capacity_bytes)
        self.quantize = bool(quantize)
        self.quant_group_size = int(quant_group_size)
        self.prefetch_enabled = bool(prefetch)
        self.device = self.kv_cache.device
        # called once per device->host copy the host waits for
        self._count_sync = count_sync or (lambda n=1: None)
        self._stage_stream = None
        # staged prefetch results: (parent_key, tokens) -> {"handle":
        # device arrays, "record": store record}; bounded LRU
        self._staged = OrderedDict()
        # prompt fingerprint -> fence Event the first acquire waits on
        self._inflight = OrderedDict()
        self._queue = deque()
        self._queue_ready = threading.Condition()
        self._worker = None
        self._shutdown = False
        # tier-level counters (store keeps its own table-level ones)
        self.demoted_blocks = 0
        self.promoted_blocks = 0
        self.prefetched_blocks = 0
        self.stage_hits = 0          # promotions served from a staged copy
        self.prefetch_waits = 0
        self.prefetch_wait_ms = 0.0
        self.prefetch_timeouts = 0
        self.prefetch_errors = 0
        self.quant_error_max = 0.0
        self.exported_blocks = 0
        self.imported_blocks = 0
        self.import_rejects = 0
        self._lock = tracked_lock(threading.RLock(), "TierManager._lock")

    # ------------------------------------------------------------- demotion
    def demote(self, victims):
        """Spill evicted trie blocks to tier-2. ``victims`` are
        ``(parent_key, tokens, block_id)`` tuples from
        ``RadixPrefixIndex.evict_nodes`` — identity captured before the
        unlink, gathered here BEFORE the caller frees the pool ids."""
        if not victims:
            return
        parts, errs = self._gather_host([b for _, _, b in victims])
        for (parent_key, tokens, _block), one, err in zip(victims, parts, errs):
            self.store.put(parent_key, tokens, one, handle_nbytes(one),
                           quant_error=err)
        with self._lock:
            self.demoted_blocks += len(victims)

    def _gather_host(self, blocks):
        """``blocks``' KV as one host handle per block, its k and v in a
        pinned buffer of its own (a record locks its own bytes): gathered on
        the device, int8 quantized there when the tier quantizes, then copied
        to host (one host sync) → (handles, per-block errors or Nones)."""
        dev = self.kv_cache.gather_device(blocks)
        errs = {}
        if self.quantize:
            dev = quantize_handle(dev, self.quant_group_size)
            errs = {"quant_error": dev.pop("quant_error")}
        *parts, errs = to_host(split_blocks(dev) + [errs])
        self._count_sync()
        if not self.quantize:
            return parts, [None] * len(parts)
        errs = errs["quant_error"].tolist()
        with self._lock:
            if errs:
                self.quant_error_max = max(self.quant_error_max, max(errs))
        return parts, errs

    # ------------------------------------------------------------ promotion
    def probe_chain(self, parent_key, tokens, start_block, max_blocks,
                    touch=False):
        """How many consecutive tier-2 blocks extend a trie match that
        ends at ``parent_key`` after ``start_block`` full chunks of
        ``tokens``. Read-only with ``touch=False`` (routing probes);
        ``touch=True`` refreshes store LRU (a real acquire path)."""
        bs = self.block_size
        n = 0
        pk = parent_key
        for i in range(start_block, max_blocks):
            chunk = tuple(int(t) for t in tokens[i * bs:(i + 1) * bs])
            rec = self.store.peek(pk, chunk, touch=touch)
            if rec is None:
                with self._lock:
                    staged = self._staged.get((pk, chunk))
                if staged is None:
                    break
                rec = staged["record"]
            pk = rec["key"]
            n += 1
        return n

    def claim(self, parent_key, tokens):
        """Take ownership of one tier-2 block for promotion — the staged
        device copy when the prefetch landed one (the H2D cost was
        already paid off-thread), else the store's host record. The
        store record is popped either way: a block lives in exactly one
        tier. A staged copy was made on the prefetch stream: the current
        (serving) stream waits on its event before anything reads it.
        → ``{"handle", "record"}`` or None."""
        key = (parent_key, tuple(int(t) for t in tokens))
        with self._lock:
            staged = self._staged.pop(key, None)
            if staged is not None:
                self.stage_hits += 1
        rec = self.store.pop(parent_key, key[1])
        if staged is not None:
            # the staged copy is content-complete even when the backing
            # record was LRU-dropped meanwhile (same chained key == same
            # exact token history == same KV by construction)
            if staged["event"] is not None:
                stream = torch.cuda.current_stream(self.device)
                stream.wait_event(staged["event"])
                for t in staged["handle"].values():
                    if isinstance(t, torch.Tensor):
                        t.record_stream(stream)
            return {"handle": staged["handle"], "record": staged["record"]}
        if rec is None:
            return None
        return {"handle": rec["handle"], "record": rec}

    def unclaim(self, item):
        """Return a claimed-but-unrestorable block to the store (pool
        had no room even after eviction)."""
        rec = item["record"]
        self.store.put(rec["parent_key"], rec["tokens"], rec["handle"],
                       rec["nbytes"], quant_error=rec["quant_error"])

    def note_promoted(self, n_blocks):
        with self._lock:
            self.promoted_blocks += int(n_blocks)

    # ----------------------------------------------------- handoff (export)
    def export_chain(self, prompt_tokens, max_blocks=None):
        """Build a process-portable handoff record for this prompt's
        cached prefix: the trie chain is gathered to host block by block
        and serialized with its chained-key identities, which are
        replica-independent (``_chunk_key`` hashes int tuples, immune to
        PYTHONHASHSEED), so a peer replica's ``import_chain`` re-derives
        and verifies the exact same keys. SERVING-THREAD ONLY — the gather
        reads the pool.
        Returns None when nothing block-aligned is cached."""
        prompt = [int(t) for t in prompt_tokens]
        bs = self.block_size
        mgr = self.manager
        with mgr._lock:
            limit = (len(prompt) - 1) // bs if max_blocks is None \
                else min(max_blocks, (len(prompt) - 1) // bs)
            path = mgr.index.match(prompt, limit)
            if not path:
                return None
            root_key = mgr.index.root.key
            idents = [(node.parent.key, node.tokens, node.key)
                      for node in path]
            parts, errs = self._gather_host([node.block_id for node in path])
        entries = []
        for (parent_key, tokens, key), one, err in zip(idents, parts, errs):
            entries.append({"key": key, "parent_key": parent_key,
                            "tokens": tuple(tokens), "handle": one,
                            "nbytes": handle_nbytes(one),
                            "quant_error": err})
        with self._lock:
            self.exported_blocks += len(entries)
        return {"version": 1, "block_size": bs, "root_key": root_key,
                "quantized": self.quantize, "entries": entries}

    def import_chain(self, record):
        """Adopt a peer replica's exported chain into the local tier-2
        store; a later acquire (or prefetch) promotes it into the pool,
        so prefill is skipped past the imported span. Thread-safe (store
        lock only; never touches the pool). The record crossed a process
        boundary, so it is ALWAYS validated — chained-key re-derivation,
        chain continuity, field presence — before any entry is adopted;
        a forged/torn record raises :class:`KVTierCorruptionError` and
        adopts nothing. Returns the number of blocks adopted."""
        try:
            check_handoff_record(record, block_size=self.block_size,
                                 root_key=self.manager.index.root.key)
        except Exception:
            with self._lock:
                self.import_rejects += 1
            raise
        n = 0
        for entry in record["entries"]:
            if self.store.put(entry["parent_key"], tuple(entry["tokens"]),
                              entry["handle"], entry["nbytes"],
                              quant_error=entry.get("quant_error")):
                n += 1
        with self._lock:
            self.imported_blocks += n
        return n

    # ------------------------------------------------------------- prefetch
    def prefetch(self, prompt_tokens):
        """Fire-and-forget: stage this prompt's tier-2 extension on the
        worker thread so the host→device copies overlap queueing. Safe
        from any thread; never touches the pool."""
        if not self.prefetch_enabled or self._shutdown:
            return
        key = tuple(int(t) for t in prompt_tokens)
        if len(key) <= self.block_size or len(self.store) == 0:
            return  # nothing block-aligned could be promoted
        with self._lock:
            if key in self._inflight:
                return
            while len(self._inflight) >= _MAX_INFLIGHT:
                # never-acquired fences (cancelled/shed requests); drop
                # oldest — a dropped fence only costs fence-less staging
                self._inflight.popitem(last=False)
            ev = threading.Event()
            self._inflight[key] = ev
            self._ensure_worker_locked()
        with self._queue_ready:
            # the event rides in the queue entry: wait_prefetch may pop
            # it from _inflight before the worker gets here, and the
            # worker must still be able to release that waiter
            self._queue.append((key, ev))
            self._queue_ready.notify()

    def wait_prefetch(self, prompt_tokens, timeout=_FENCE_TIMEOUT_S):
        """Completion fence: block until this prompt's staging pass is
        done (bounded). Called by ``acquire`` BEFORE the manager lock —
        the worker needs that lock, so fencing under it would deadlock."""
        if not self.prefetch_enabled:
            return
        key = tuple(int(t) for t in prompt_tokens)
        with self._lock:
            ev = self._inflight.pop(key, None)
        if ev is None:
            return
        t0 = time.perf_counter()
        done = ev.wait(timeout)
        waited_ms = (time.perf_counter() - t0) * 1e3
        with self._lock:
            self.prefetch_waits += 1
            self.prefetch_wait_ms += waited_ms
            if not done:
                self.prefetch_timeouts += 1

    def _ensure_worker_locked(self):
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(target=self._worker_run,
                                            name="ds-kv-tier-prefetch",
                                            daemon=True)
            self._worker.start()

    def _worker_run(self):
        while True:
            with self._queue_ready:
                while not self._queue and not self._shutdown:
                    self._queue_ready.wait()
                if self._shutdown:
                    return
                key, ev = self._queue.popleft()
            try:
                self._stage_prompt(key)
            except Exception:
                with self._lock:
                    self.prefetch_errors += 1
            finally:
                ev.set()

    def _stage_prompt(self, prompt):
        """Worker-side staging: walk the trie (under the manager lock,
        host-only and quick) to find where the cached prefix ends, then
        copy the store's extension records to device OUTSIDE any lock.
        The pool is never touched — staged buffers are fresh arrays the
        serving-side promotion scatters later, copied from pinned memory
        on the worker's own CUDA stream with an event after them."""
        bs = self.block_size
        mgr = self.manager
        with mgr._lock:
            max_blocks = (len(prompt) - 1) // bs
            path = mgr.index.match(prompt, max_blocks)
            pk = path[-1].key if path else mgr.index.root.key
            chain = []
            for i in range(len(path), max_blocks):
                chunk = tuple(int(t) for t in prompt[i * bs:(i + 1) * bs])
                rec = self.store.peek(pk, chunk)
                if rec is None:
                    break
                chain.append((pk, chunk, rec))
                pk = rec["key"]
        for pk, chunk, rec in chain:
            key = (pk, chunk)
            with self._lock:
                if key in self._staged:
                    continue
            handle = rec["handle"]
            names = [n for n in ("k", "v", "k_scales", "v_scales") if n in handle]
            event = None
            if self.device.type == "cuda":
                if self._stage_stream is None:
                    self._stage_stream = torch.cuda.Stream(self.device)
                with torch.cuda.stream(self._stage_stream):
                    dev = {n: handle[n].pin_memory().to(self.device, non_blocking=True)
                           for n in names}
                    event = torch.cuda.Event()
                    event.record(self._stage_stream)
            else:  # records are immutable: the host tensors are the staged copy
                dev = {n: handle[n] for n in names}
            if handle.get("quantized"):
                dev["quantized"] = True
            with self._lock:
                self._staged[key] = {"handle": dev, "record": rec, "event": event}
                self._staged.move_to_end(key)
                while len(self._staged) > _MAX_STAGED:
                    self._staged.popitem(last=False)
                self.prefetched_blocks += 1

    def invalidate(self):
        """Drop every tier-2 record, staged device copy, and prefetch
        fence (weight refresh: KV gathered under the previous weights
        must never extend a prompt under the new ones). Unlike
        :meth:`shutdown` the worker stays alive — only content goes."""
        with self._lock:
            for ev in self._inflight.values():
                ev.set()  # never strand an acquire on dropped staging
            self._inflight.clear()
            self._staged.clear()
        self.store.clear()

    def shutdown(self):
        """Stop the worker and drop staged/stored state (engine
        destroy)."""
        self._shutdown = True
        with self._queue_ready:
            self._queue_ready.notify_all()
        worker = self._worker
        if worker is not None and worker.is_alive():
            worker.join(timeout=2.0)
        with self._lock:
            for ev in self._inflight.values():
                ev.set()  # never strand an acquire on a dead worker
            self._inflight.clear()
            self._staged.clear()
        self.store.clear()

    # -------------------------------------------------------------- metrics
    def stats(self):
        """Monitor-facing snapshot (``Serve/KVTier/*`` tags)."""
        s = self.store.stats()
        with self._lock:
            waits = self.prefetch_waits
            s.update({
                "tier2_hit_rate": round(s["hits"] / s["lookups"], 4)
                if s["lookups"] else 0.0,
                "demoted_blocks": self.demoted_blocks,
                "promoted_blocks": self.promoted_blocks,
                "prefetched_blocks": self.prefetched_blocks,
                "stage_hits": self.stage_hits,
                "prefetch_waits": waits,
                "prefetch_wait_ms": round(self.prefetch_wait_ms / waits, 3)
                if waits else 0.0,
                "prefetch_timeouts": self.prefetch_timeouts,
                "prefetch_errors": self.prefetch_errors,
                "exported_blocks": self.exported_blocks,
                "imported_blocks": self.imported_blocks,
                "import_rejects": self.import_rejects,
                "quantized": int(self.quantize),
                "quant_error_max": self.quant_error_max,
            })
        return s
