"""Schema-table stores: process-wide compile cache + per-engine slabs.

Port of ``deepspeed_tpu/inference/structured/store.py``. Two lifetimes,
two objects:

- :class:`SchemaCompilerCache` — ONE per process, thread-shared (client
  submit threads compile concurrently): token-DFA compilation is
  O(states x vocab) host work, so each (schema hash, vocab signature)
  pair compiles exactly once. Under ``DS_SANITIZE`` its lock is
  order-tracked (``tracked_lock``).
- :class:`StructuredStore` — one per engine, PUMP-THREAD ONLY (like the
  sequence descriptors it annotates): owns the device-resident DFA
  slabs (``masks`` bool / ``trans`` int32, ``[max_schemas + 1,
  max_states, vocab]`` on the engine's device, allocated once; installing
  a schema writes its slot's rows, one host→device copy a bind of a new
  schema, never one a step) and the per-sequence (slot, host DFA state)
  bookkeeping. Slot 0 is the trivial all-allow DFA, so unconstrained
  rows in a mixed batch gather a no-op mask.
"""

import threading
from collections import OrderedDict

import torch

from deepspeed_tpu_torch.device import resolve_device
from deepspeed_tpu_torch.inference.structured.grammar import (CompiledSchema,
                                                              SchemaCompileError,
                                                              schema_fingerprint,
                                                              vocab_signature)
from deepspeed_tpu_torch.utils.sanitize import tracked_lock


class SchemaCompilerCache:
    """Thread-shared LRU of :class:`CompiledSchema` tables.

    Thread-shared: client submit threads call :meth:`get_or_compile` at
    admission (schema compile errors must surface typed, pre-queue), so
    all mutations take the lock. The compile itself runs OUTSIDE the
    lock — it is pure host work on immutable inputs, and serializing
    multi-second compiles behind one lock would stall every submitter;
    a racing duplicate compile is wasted work, not corruption (last
    writer wins on an identical value)."""

    def __init__(self, cap=64):
        self._lock = tracked_lock(threading.Lock(), "SchemaCompilerCache._lock")
        self._cache = OrderedDict()  # (schema hash, vocab sig) -> CompiledSchema
        self._cap = max(1, int(cap))
        self.compiles = 0  # cache misses that ran the compiler
        self.hits = 0

    def get_or_compile(self, schema, token_strings, eos_token_id=None):
        """→ the cached :class:`CompiledSchema` for ``(schema,
        token_strings, eos_token_id)``, compiling on miss. Raises
        :class:`grammar.SchemaCompileError` for schemas the compiler
        rejects — typed, at the caller's submit site."""
        key = (schema_fingerprint(schema), vocab_signature(token_strings, eos_token_id))
        with self._lock:
            hit = self._cache.get(key)
            if hit is not None:
                self._cache.move_to_end(key)
                self.hits += 1
                return hit
        compiled = CompiledSchema(schema, token_strings, eos_token_id=eos_token_id)
        with self._lock:
            self.compiles += 1
            self._cache[key] = compiled
            while len(self._cache) > self._cap:
                self._cache.popitem(last=False)
            return self._cache[key]

    def stats(self):
        with self._lock:
            return {"entries": len(self._cache), "compiles": self.compiles, "hits": self.hits}

    def clear(self):
        """Drop every cached table (test isolation)."""
        with self._lock:
            self._cache.clear()
            self.compiles = 0
            self.hits = 0


_GLOBAL_CACHE = SchemaCompilerCache()


def schema_cache() -> SchemaCompilerCache:
    """The process-wide compiler cache all engines share."""
    return _GLOBAL_CACHE


class StructuredStore:
    """Per-engine device DFA slabs + per-sequence constraint state.

    PUMP-THREAD ONLY — called from inside engine ``put``/burst packing
    and the scheduler's accept loop; no lock, same discipline as the
    state manager. ``max_schemas`` bounds concurrently-installed schemas
    (slot 0 is reserved for the trivial DFA); ``max_states`` bounds any
    single schema's token DFA. Slots are leased per uid and recycled LRU
    once no live sequence holds them. ``device=None`` is the GPU."""

    def __init__(self, vocab_size, max_schemas=4, max_states=64, device=None):
        self.vocab_size = int(vocab_size)
        self.max_schemas = int(max_schemas) + 1  # + the trivial slot 0
        self.max_states = int(max_states)
        self.device = resolve_device(device)
        shape = (self.max_schemas, self.max_states, self.vocab_size)
        self._masks = torch.zeros(shape, dtype=torch.bool, device=self.device)
        self._trans = torch.zeros(shape, dtype=torch.int32, device=self.device)
        self._masks[0, 0, :] = True  # slot 0: one all-allow self-loop state
        self._slot_by_key = OrderedDict()  # CompiledSchema.key -> slot (LRU)
        self._schema_by_slot = {}      # slot -> CompiledSchema
        self._leases = {}              # uid -> slot
        self._state = {}               # uid -> host DFA state (authoritative)

    # ------------------------------------------------------- bindings
    def bind(self, uid, compiled: CompiledSchema):
        """Lease a slot for ``uid``'s schema (installing its tables on
        first use, possibly recycling an unleased LRU slot) and reset its
        DFA state to start. → the slot index."""
        if compiled.n_states > self.max_states:
            raise SchemaCompileError(
                f"schema needs {compiled.n_states} DFA states > "
                f"max_states={self.max_states} — raise "
                f"config.structured.max_states")
        if compiled.mask.shape[1] != self.vocab_size:
            raise SchemaCompileError(
                f"schema compiled over a {compiled.mask.shape[1]}-token "
                f"vocab, engine serves {self.vocab_size}")
        slot = self._slot_by_key.get(compiled.key)
        if slot is None:
            slot = self._free_slot()
            S = compiled.n_states
            self._masks[slot] = False
            self._trans[slot] = 0
            self._masks[slot, :S] = torch.from_numpy(compiled.mask).to(self.device)
            self._trans[slot, :S] = torch.from_numpy(compiled.trans).to(self.device)
            self._slot_by_key[compiled.key] = slot
            self._schema_by_slot[slot] = compiled
        self._slot_by_key.move_to_end(compiled.key)
        self._leases[uid] = slot
        self._state[uid] = compiled.start
        return slot

    def _free_slot(self):
        leased = set(self._leases.values())
        for slot in range(1, self.max_schemas):
            if slot not in self._schema_by_slot:
                return slot
        # recycle the LRU installed schema nobody is decoding with
        for key, slot in self._slot_by_key.items():
            if slot not in leased:
                del self._slot_by_key[key]
                del self._schema_by_slot[slot]
                return slot
        raise RuntimeError(
            f"all {self.max_schemas - 1} schema slots are leased by live "
            f"sequences — raise config.structured.max_schemas")

    def release(self, uid):
        """Drop ``uid``'s lease + state (engine ``flush`` path); the
        slot's tables stay installed for reuse until recycled."""
        self._leases.pop(uid, None)
        self._state.pop(uid, None)

    # ------------------------------------------------------ per-seq state
    def bound(self, uid) -> bool:
        return uid in self._leases

    def any_bound(self) -> bool:
        return bool(self._leases)

    def slot_of(self, uid) -> int:
        return self._leases.get(uid, 0)

    def state_of(self, uid) -> int:
        return self._state.get(uid, 0)

    def advance(self, uid, token) -> int:
        """Advance ``uid``'s host DFA state through one ACCEPTED token
        (the scheduler's accept loop) — the authoritative state the next
        batch packs, which is how EOS truncation and rewinds stay
        correct: discarded in-burst tokens simply never advance it."""
        slot = self._leases.get(uid)
        if slot is None:
            return 0
        compiled = self._schema_by_slot[slot]
        self._state[uid] = compiled.advance(self._state[uid], int(token))
        return self._state[uid]

    def accepting(self, uid) -> bool:
        slot = self._leases.get(uid)
        if slot is None:
            return True
        return self._schema_by_slot[slot].is_accepting(self._state.get(uid, 0))

    # ---------------------------------------------------------- device
    def slabs(self):
        """→ ``(masks, trans)``, the device slabs: fixed ``[max_schemas
        + 1, max_states, vocab]`` shapes whose rows a new schema's bind
        rewrites in place."""
        return self._masks, self._trans
