"""Tier-2 KV block storage: host RAM under a byte budget.

``HostKVStore`` holds FULL, immutable KV blocks that the radix prefix
cache evicted from the HBM pool ("demotion"), each keyed by the SAME
chained content identity the trie uses: a record is addressed by
``(parent chain key, token chunk)``, where the parent chain key is the
trie node key of the block's prefix. Because the dict key carries the
exact token chunk (not just its hash), a tier-2 hit can only ever
restore KV whose entire token history matches the probing prompt —
hash collisions cannot cross-contaminate, mirroring the trie's
collision-bucket exact-token lookups.

Records hold opaque offload handles (pool-layout CPU tensors, or int8
carriers + scales when the tier quantizes) and are immutable once
stored — the async prefetch worker reads them without copying. The
store itself is an LRU over a byte budget (``kv_tier.host_bytes``):
inserting past the budget drops the least-recently-touched records.

Thread model: the serving thread (demote on allocation pressure, promote
at acquire), the tier's prefetch worker (peek + stage), and client
threads (stats) all touch the table — every mutation runs under the
store lock.

Port: a copy of ``deepspeed_tpu/inference/v2/kv_tier/host_store.py``
with a plain ``RLock`` and without the ``DS_SANITIZE`` audit after each
mutation (callers run ``utils.sanitize.check_kv_tier_store``).
"""

import threading
from collections import OrderedDict

from deepspeed_tpu_torch.inference.v2.prefix_cache.radix_index import _chunk_key


class HostKVStore:

    def __init__(self, capacity_bytes):
        self.capacity_bytes = int(capacity_bytes)
        # (parent_key, tokens) -> record; insertion/touch order == LRU
        self._records = OrderedDict()
        self.bytes_resident = 0
        self.demotions = 0   # blocks spilled in over the store's lifetime
        self.promotions = 0  # blocks popped for restore
        self.evictions = 0   # blocks dropped for the byte budget
        self.lookups = 0     # contains/peek probes
        self.hits = 0
        self._lock = threading.RLock()

    def __len__(self):
        return len(self._records)

    # ------------------------------------------------------------- writes
    def put(self, parent_key, tokens, handle, nbytes, quant_error=None):
        """Adopt one spilled block. → False when it can never fit (a
        single block larger than the whole budget); True otherwise.
        Re-inserting an existing key refreshes its content and LRU
        position."""
        tokens = tuple(int(t) for t in tokens)
        nbytes = int(nbytes)
        rec = {"key": _chunk_key(parent_key, tokens), "parent_key": parent_key,
               "tokens": tokens, "handle": handle, "nbytes": nbytes,
               "quant_error": quant_error}
        with self._lock:
            old = self._records.pop((parent_key, tokens), None)
            if old is not None:
                self.bytes_resident -= old["nbytes"]
            if nbytes > self.capacity_bytes:
                return False
            while self._records and \
                    self.bytes_resident + nbytes > self.capacity_bytes:
                _, victim = self._records.popitem(last=False)
                self.bytes_resident -= victim["nbytes"]
                self.evictions += 1
            self._records[(parent_key, tokens)] = rec
            self.bytes_resident += nbytes
            self.demotions += 1
            return True

    def pop(self, parent_key, tokens):
        """Remove and return the record for promotion back into the HBM
        pool (a block lives in exactly one tier), or None. Counts as a
        probe: the acquire-time claim IS the tier's traffic, so the
        hit rate reflects how often demoted content was asked back."""
        tokens = tuple(int(t) for t in tokens)
        with self._lock:
            self.lookups += 1
            rec = self._records.pop((parent_key, tokens), None)
            if rec is not None:
                self.hits += 1
                self.bytes_resident -= rec["nbytes"]
                self.promotions += 1
            return rec

    # ------------------------------------------------------------- reads
    def peek(self, parent_key, tokens, touch=True):
        """The record without removing it (prefetch staging). ``touch``
        refreshes its LRU position and counts a probe; ``touch=False``
        is the read-only routing probe (``match_len``) — a placement
        probe must not look like traffic."""
        tokens = tuple(int(t) for t in tokens)
        with self._lock:
            rec = self._records.get((parent_key, tokens))
            if touch:
                self.lookups += 1
                if rec is not None:
                    self.hits += 1
                    self._records.move_to_end((parent_key, tokens))
            return rec

    def contains(self, parent_key, tokens):
        return self.peek(parent_key, tokens, touch=False) is not None

    def clear(self):
        with self._lock:
            self._records.clear()
            self.bytes_resident = 0

    def stats(self):
        with self._lock:
            return {"bytes_resident": self.bytes_resident,
                    "blocks_resident": len(self._records),
                    "capacity_bytes": self.capacity_bytes,
                    "demotions": self.demotions,
                    "promotions": self.promotions,
                    "evictions": self.evictions,
                    "lookups": self.lookups,
                    "hits": self.hits}
