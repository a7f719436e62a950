"""Runtime sanitizers behind the ``DS_SANITIZE`` env knob.

Port of ``deepspeed_tpu/utils/sanitize.py`` (the wire-frame checks wait
for the fleet). Three layers, all OFF by default with zero hot-path cost:

- device-side: :func:`maybe_checkify` wraps an engine forward. Off, it
  returns the callable itself (no wrapper, no branch per call, no
  launch). On, it checks the packed batch's integer inputs against their
  ranges before the call (:class:`SanitizerIndexError`, where JAX's
  checkify reports an out-of-bounds gather) and every floating output
  for non-finite values after it (:class:`SanitizerNaNError`). The
  checks read device values on the host, so the checked form
  synchronizes: it is a debugging mode.
- host-side: the blocked allocator, the prefix-cache manager and the KV
  spill tier's store run the ``check_*`` invariant assertions after
  every mutation. Violations raise typed errors instead of silently
  corrupting block ownership. ``check_handoff_record`` runs on every
  ``TierManager.import_chain`` and ``check_weight_publication`` on every
  weight publication load whatever the switch says (both cross a trust
  boundary: they are untrusted input).
- locks: :func:`tracked_lock` wraps the named locks in an order-tracking
  proxy that raises :class:`LockOrderViolationError` on the first
  acquisition that closes a cycle in the process-wide lock graph.

Enablement is sampled once per object construction (engine, allocator,
manager, store), not per call, so flipping the env var mid-run does not
resurrect checks on live objects.
"""

import threading
import traceback

from deepspeed_tpu_torch.utils.env_registry import env_bool


class SanitizerError(RuntimeError):
    """Base class of the DS_SANITIZE failures. ``retry_elsewhere`` is
    False: an invariant trip is a bug, not a capacity signal."""
    reason = "sanitizer"
    retry_elsewhere = False


class SanitizerNaNError(SanitizerError):
    """A sanitized forward produced a non-finite value (or, through
    :class:`SanitizerIndexError`, was handed an out-of-range index)."""


class SanitizerIndexError(SanitizerNaNError):
    """A sanitized forward's integer input (token id, position, block
    id, sequence slot, adapter slot) lies outside the range the forward
    gathers from: checkify's index check, raised before the gather."""


class AllocatorCorruptionError(SanitizerError):
    """BlockedAllocator free-list/free-set mirror disagreement."""


class PrefixCacheCorruptionError(SanitizerError):
    """Radix trie refcount/reclaimable accounting disagreement."""


class KVTierCorruptionError(SanitizerError):
    """Host KV spill-tier record whose stored chained key no longer
    re-derives from its (parent_key, tokens) identity — promotion would
    graft wrong-content KV into the trie — or byte accounting drift."""


class WeightPublicationError(SanitizerError):
    """A weight publication manifest is torn, forged, or out of chain —
    adopting it could serve half-written or wrong-lineage weights. The
    publication is rejected typed and nothing is adopted."""


class LockOrderViolationError(SanitizerError):
    """An acquisition closed a cycle in the global lock-order graph
    (two threads can take the same two locks in opposite orders), or a
    non-reentrant lock was blocking-re-acquired by its holder. The
    message names both acquisition stacks: the current thread's and the
    recorded one that established the conflicting edge."""


def sanitize_enabled() -> bool:
    return env_bool("DS_SANITIZE")


def _tensors(out):
    """The tensors of a (nested tuple/list/dict) result, in order."""
    if isinstance(out, dict):
        for v in out.values():
            yield from _tensors(v)
    elif isinstance(out, (tuple, list)):
        for v in out:
            yield from _tensors(v)
    elif hasattr(out, "is_floating_point"):
        yield out


def check_finite(out, where="forward") -> None:
    """Raise :class:`SanitizerNaNError` when a floating tensor of ``out``
    holds a NaN or an Inf (checkify's float check)."""
    import torch
    for t in _tensors(out):
        if t.is_floating_point() and t.numel() and not bool(torch.isfinite(t).all()):
            bad = int((~torch.isfinite(t)).sum())
            raise SanitizerNaNError(f"{where}: {bad} non-finite value(s) in a "
                                    f"{tuple(t.shape)} {t.dtype} output")


def check_index(name, t, lo, hi) -> None:
    """Raise :class:`SanitizerIndexError` unless every entry of the
    integer tensor ``t`` lies in ``[lo, hi)`` (checkify's index check)."""
    if t.numel() == 0:
        return
    tmin, tmax = int(t.min()), int(t.max())
    if tmin < lo or tmax >= hi:
        raise SanitizerIndexError(f"{name} out of bounds: values span [{tmin}, {tmax}], "
                                  f"the gather admits [{lo}, {hi})")


def maybe_checkify(fn, check_inputs=None, enabled=None):
    """The torch counterpart of the JAX package's ``maybe_checkify_jit``.

    When ``enabled`` is falsy this returns ``fn`` ITSELF: no wrapper
    object, no per-call branch, no launch. When enabled, each call first
    runs ``check_inputs(*args, **kwargs)`` (when given: range checks of
    the integer inputs, raising :class:`SanitizerIndexError`), then
    ``fn``, then :func:`check_finite` over every floating output,
    raising :class:`SanitizerNaNError`."""
    if enabled is None:
        enabled = sanitize_enabled()
    if not enabled:
        return fn

    def run(*args, **kwargs):
        if check_inputs is not None:
            check_inputs(*args, **kwargs)
        out = fn(*args, **kwargs)
        check_finite(out, getattr(fn, "__qualname__", "forward"))
        return out

    run.__wrapped__ = fn
    run._ds_sanitized = True
    return run


def check_allocator(alloc) -> None:
    """Free-list vs free-set mirror: same length, same membership. A
    disagreement means a double free slipped past (or a free was lost)
    and block ownership is corrupt."""
    free, mirror = alloc._free, alloc._free_set
    if len(free) != len(mirror) or set(free) != mirror:
        raise AllocatorCorruptionError(
            f"free-list/free-set mirror out of sync: list has "
            f"{len(free)} entries, set has {len(mirror)} "
            f"(symmetric difference: {sorted(set(free) ^ mirror)[:8]})")


def check_kv_tier_store(store) -> None:
    """Re-derive every tier-2 record's chained content key through the
    SAME ``_chunk_key`` the radix trie uses and compare it to the key
    captured at demotion time; re-sum ``nbytes`` against the
    ``bytes_resident`` counter the LRU budget trusts."""
    # resolved at call time, so a monkeypatched hash (collision tests)
    # stays consistent with the trie's
    from deepspeed_tpu_torch.inference.v2.prefix_cache.radix_index import _chunk_key
    total = 0
    for (parent_key, tokens), rec in store._records.items():
        derived = _chunk_key(parent_key, tokens)
        if rec["key"] != derived:
            raise KVTierCorruptionError(
                f"tier-2 record for parent_key={parent_key!r} re-derives "
                f"chained key {derived!r} but stores {rec['key']!r} — "
                f"identity/content mismatch")
        total += rec["nbytes"]
    if total != store.bytes_resident:
        raise KVTierCorruptionError(
            f"tier-2 records sum to {total} bytes but bytes_resident "
            f"says {store.bytes_resident}")


def check_handoff_record(record, block_size=None, root_key=None) -> None:
    """Validate a cross-process KV handoff record (TierManager
    ``export_chain`` → ``import_chain``) BEFORE any entry is adopted: a
    torn or truncated write surfaces as missing fields, and a forged entry
    fails the chained-key re-derivation."""
    from deepspeed_tpu_torch.inference.v2.prefix_cache.radix_index import _chunk_key
    if not isinstance(record, dict) or "entries" not in record:
        raise KVTierCorruptionError(
            "handoff record is not a dict with an 'entries' list — "
            "torn or truncated handoff")
    if record.get("version") != 1:
        raise KVTierCorruptionError(
            f"handoff record version {record.get('version')!r} is not 1")
    if block_size is not None and record.get("block_size") != block_size:
        raise KVTierCorruptionError(
            f"handoff record block_size {record.get('block_size')!r} does "
            f"not match the importing pool's {block_size}")
    if root_key is not None and record.get("root_key") != root_key:
        raise KVTierCorruptionError(
            f"handoff record root_key {record.get('root_key')!r} does not "
            f"match the importing trie's {root_key!r}")
    pk = record.get("root_key")
    bs = record.get("block_size")
    for i, entry in enumerate(record["entries"]):
        if not isinstance(entry, dict):
            raise KVTierCorruptionError(
                f"handoff entry {i} is not a dict — torn record")
        missing = [f for f in ("key", "parent_key", "tokens", "handle",
                               "nbytes") if f not in entry]
        if missing:
            raise KVTierCorruptionError(
                f"handoff entry {i} is missing {missing} — torn or "
                f"truncated record")
        tokens = tuple(entry["tokens"])
        if bs is not None and len(tokens) != bs:
            raise KVTierCorruptionError(
                f"handoff entry {i} carries {len(tokens)} tokens, not a "
                f"full {bs}-token block — truncated record")
        if entry["parent_key"] != pk:
            raise KVTierCorruptionError(
                f"handoff entry {i} parent_key {entry['parent_key']!r} "
                f"breaks the chain (expected {pk!r})")
        derived = _chunk_key(pk, tokens)
        if entry["key"] != derived:
            raise KVTierCorruptionError(
                f"handoff entry {i} re-derives chained key {derived!r} "
                f"but claims {entry['key']!r} — forged or corrupt "
                f"identity/content pair")
        handle = entry["handle"]
        if not isinstance(handle, dict) or "k" not in handle \
                or "v" not in handle:
            raise KVTierCorruptionError(
                f"handoff entry {i} handle lacks k/v carriers — torn "
                f"record")
        pk = entry["key"]


def publication_chain_hash(parent_chain, files):
    """The chained content hash of one weight publication: sha256 over
    the parent publication's chain hash plus every payload file's
    identity (relpath, size, sha256) in sorted order. Chaining makes a
    publication's hash cover its entire version lineage, the same way a
    radix node's chained key covers its token history."""
    import hashlib
    h = hashlib.sha256()
    h.update((parent_chain or "").encode())
    for rel in sorted(files):
        info = files[rel]
        h.update(f"{rel}:{int(info['bytes'])}:{info['sha256']}".encode())
    return h.hexdigest()


def check_weight_publication(manifest, pub_dir=None, expect_version=None,
                             parent_chain=None, digests=None) -> None:
    """Validate a weight-publication manifest BEFORE anything is
    adopted. Unconditional (never gated on DS_SANITIZE): the manifest
    crossed a trust boundary — written by a train-side publisher,
    consumed by serving replicas — so it is untrusted input, exactly
    like a KV handoff record. A torn write surfaces as missing fields,
    a forged or half-written publication fails the chained-hash
    re-derivation, and on-disk payload corruption fails the per-file
    sha256 when ``pub_dir`` is given. ``digests`` maps a file to the
    ``(bytes, sha256)`` of the copy the caller already read: those files
    are checked by it, not read again, so what the caller adopts is what
    was verified. Raises :class:`WeightPublicationError`; nothing is
    adopted."""
    if not isinstance(manifest, dict) or "files" not in manifest:
        raise WeightPublicationError(
            "publication manifest is not a dict with a 'files' map — "
            "torn or truncated publication")
    if manifest.get("version") != 1:
        raise WeightPublicationError(
            f"publication manifest version {manifest.get('version')!r} "
            f"is not 1")
    wv = manifest.get("weight_version")
    if not isinstance(wv, int) or wv < 1:
        raise WeightPublicationError(
            f"publication weight_version {wv!r} is not a positive int")
    if expect_version is not None and wv != int(expect_version):
        raise WeightPublicationError(
            f"publication claims weight_version {wv}, expected "
            f"{expect_version}")
    files = manifest["files"]
    if not isinstance(files, dict) or not files:
        raise WeightPublicationError(
            "publication manifest lists no payload files — torn "
            "publication")
    for rel, info in files.items():
        if not isinstance(info, dict) or "bytes" not in info \
                or "sha256" not in info:
            raise WeightPublicationError(
                f"publication file entry '{rel}' lacks bytes/sha256 — "
                f"torn manifest")
    if parent_chain is not None and manifest.get("parent_chain") != parent_chain:
        raise WeightPublicationError(
            f"publication parent_chain {manifest.get('parent_chain')!r} "
            f"does not extend the adopted chain {parent_chain!r} — "
            f"wrong lineage")
    derived = publication_chain_hash(manifest.get("parent_chain"), files)
    if manifest.get("chain") != derived:
        raise WeightPublicationError(
            f"publication chain hash re-derives {derived[:12]}… but the "
            f"manifest claims {str(manifest.get('chain'))[:12]}… — forged "
            f"or half-written publication")
    import os
    from deepspeed_tpu_torch.nebula.service import file_sha256
    digests = digests or {}
    for rel, info in files.items():
        if rel in digests:
            actual, digest = digests[rel]
        elif pub_dir is None:
            continue
        else:
            full = os.path.join(pub_dir, rel)
            if not os.path.isfile(full):
                raise WeightPublicationError(
                    f"publication payload '{rel}' is missing on disk — "
                    f"torn publication")
            actual, digest = os.path.getsize(full), None
        if actual != int(info["bytes"]):
            raise WeightPublicationError(
                f"publication payload '{rel}' is {actual} bytes, "
                f"manifest says {info['bytes']} — truncated")
        if digest is None:
            digest = file_sha256(full)
        if digest != info["sha256"]:
            raise WeightPublicationError(
                f"publication payload '{rel}' hashes "
                f"sha256:{digest[:12]}…, manifest says "
                f"sha256:{info['sha256'][:12]}… — bit-level "
                f"corruption")


def check_prefix_index(index) -> None:
    """Walk the radix trie and re-derive the cached accounting: node
    count, ref-0 (reclaimable) count, and non-negative refcounts must
    all match the O(1) counters the hot path maintains."""
    nodes = 0
    ref0 = 0
    stack = [index.root]
    while stack:
        node = stack.pop()
        # children maps chained key -> [RadixNode] collision bucket
        for bucket in node.children.values():
            for child in bucket:
                nodes += 1
                if child.ref < 0:
                    raise PrefixCacheCorruptionError(
                        f"negative refcount {child.ref} on cached block "
                        f"{child.block_id}")
                if child.ref == 0:
                    ref0 += 1
                stack.append(child)
    if nodes != index.num_nodes:
        raise PrefixCacheCorruptionError(
            f"trie has {nodes} nodes but num_nodes counter says "
            f"{index.num_nodes}")
    if ref0 != index.evictable_blocks:
        raise PrefixCacheCorruptionError(
            f"trie has {ref0} ref-0 (reclaimable) blocks but the "
            f"evictable counter says {index.evictable_blocks}")


# -------------------------------------------------- lock-order sanitizer
# Runtime twin of the graft-lint ``lock-order`` rule: under DS_SANITIZE=1
# every registered lock is wrapped in an order-tracking proxy. Each
# acquisition while other tracked locks are held merges directed edges
# (held -> acquiring) into one process-global graph; the first
# acquisition that would close a cycle raises LockOrderViolationError
# BEFORE touching the underlying lock — naming the current thread's
# stack and the recorded stack of the conflicting edge — so the test
# suite reports the inversion instead of deadlocking on it.
#
# The graph is guarded by a plain (untracked) module lock and persists
# across objects: edges recorded by a TierManager in one test conflict
# with inversions from another, which is exactly what makes the tier-1
# suite a dynamic deadlock harness. Tests isolate via reset_lock_graph().

_LOCK_GRAPH_GUARD = threading.Lock()
_LOCK_GRAPH = {}  # src name -> {dst name: {"thread", "held", "stack"}}
_HELD = threading.local()  # .stack: list of (proxy, name) per thread


def reset_lock_graph() -> None:
    """Drop all recorded acquisition edges (test isolation)."""
    with _LOCK_GRAPH_GUARD:
        _LOCK_GRAPH.clear()


def lock_graph_snapshot():
    """{src: {dst: owning thread name}} copy of the global edge set."""
    with _LOCK_GRAPH_GUARD:
        return {src: {dst: info["thread"] for dst, info in dsts.items()}
                for src, dsts in _LOCK_GRAPH.items()}


def _held_stack():
    stack = getattr(_HELD, "stack", None)
    if stack is None:
        stack = _HELD.stack = []
    return stack


def _reaches(src, dst):
    """True if ``dst`` is reachable from ``src`` in _LOCK_GRAPH (caller
    holds _LOCK_GRAPH_GUARD)."""
    seen = set()
    frontier = [src]
    while frontier:
        node = frontier.pop()
        if node == dst:
            return True
        if node in seen:
            continue
        seen.add(node)
        frontier.extend(_LOCK_GRAPH.get(node, ()))
    return False


class _TrackedLock:
    """Order-tracking proxy around a Lock/RLock. Forwards everything to
    the wrapped lock; acquire/release additionally maintain the
    per-thread held stack and the global acquisition graph.

    Reentrancy: re-acquiring a lock already on this thread's held stack
    records no edges (an RLock holder re-entering is legal and must not
    self-edge); a BLOCKING re-acquire of a plain non-reentrant Lock is
    raised as a guaranteed self-deadlock instead of hanging.

    ``threading.Condition(tracked_plain_lock)`` is supported: Condition
    probes the lock for ``_release_save``/``_acquire_restore``, the
    proxy's ``__getattr__`` raises AttributeError for them (plain Locks
    have none), and Condition falls back to plain ``release()`` /
    ``acquire()`` — which keep the held stack correct across ``wait()``.
    Do NOT hand a tracked RLock to a Condition: the probe would find the
    real RLock's ``_release_save`` via forwarding and bypass tracking.
    """

    __slots__ = ("_inner", "_name")

    def __init__(self, inner, name):
        self._inner = inner
        self._name = name

    def acquire(self, blocking=True, timeout=-1):
        held = _held_stack()
        reentrant = any(entry[0] is self for entry in held)
        if reentrant:
            if blocking and isinstance(self._inner,
                                       type(threading.Lock())):
                raise LockOrderViolationError(
                    f"self-deadlock: thread "
                    f"{threading.current_thread().name!r} blocking-"
                    f"re-acquires non-reentrant {self._name} it already "
                    f"holds\n--- current stack ---\n"
                    + "".join(traceback.format_stack()))
        else:
            self._check_and_record(held)
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            held.append((self, self._name))
        elif not reentrant:
            # nothing was pushed; recorded edges stay — the ATTEMPTED
            # ordering is what matters for deadlock potential
            pass
        return ok

    def _check_and_record(self, held):
        if not held:
            return
        me = self._name
        held_names = [name for _proxy, name in held]
        with _LOCK_GRAPH_GUARD:
            for src in held_names:
                if src == me:
                    continue
                # would edge (src -> me) close a cycle? i.e. me -> src
                # already reachable through recorded edges
                if _reaches(me, src):
                    info = self._conflict_info(me, src)
                    raise LockOrderViolationError(
                        f"lock-order cycle: thread "
                        f"{threading.current_thread().name!r} acquires "
                        f"{me} while holding {held_names} but the "
                        f"reverse order {me} -> {src} is already on "
                        f"record (thread {info['thread']!r} held "
                        f"{info['held']})\n"
                        f"--- current acquisition stack ---\n"
                        f"{''.join(traceback.format_stack())}"
                        f"--- conflicting acquisition stack "
                        f"(thread {info['thread']!r}) ---\n"
                        f"{''.join(info['stack'])}")
            stack = traceback.format_stack()
            thread = threading.current_thread().name
            for src in held_names:
                if src == me:
                    continue
                _LOCK_GRAPH.setdefault(src, {}).setdefault(
                    me, {"thread": thread, "held": list(held_names),
                         "stack": stack})

    @staticmethod
    def _conflict_info(src, dst):
        """First recorded edge on some path src -> ... -> dst (caller
        holds the guard); falls back to the direct edge if present."""
        direct = _LOCK_GRAPH.get(src, {}).get(dst)
        if direct is not None:
            return direct
        seen = set()
        frontier = [(src, None)]
        while frontier:
            node, first = frontier.pop()
            if node in seen:
                continue
            seen.add(node)
            for nxt, info in _LOCK_GRAPH.get(node, {}).items():
                carried = first or info
                if nxt == dst:
                    return carried
                frontier.append((nxt, carried))
        return {"thread": "?", "held": [], "stack": []}

    def release(self):
        held = _held_stack()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] is self:
                del held[i]
                break
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        return self._inner.locked()

    def __getattr__(self, name):
        # _release_save/_acquire_restore/_is_owned must NOT forward to a
        # wrapped RLock (Condition would bypass held tracking); plain
        # Locks lack them, so AttributeError here preserves Condition's
        # documented fallback to acquire()/release()
        if name in ("_release_save", "_acquire_restore", "_is_owned"):
            raise AttributeError(name)
        return getattr(self._inner, name)

    def __repr__(self):
        return f"<_TrackedLock {self._name} wrapping {self._inner!r}>"


def tracked_lock(lock, name, enabled=None):
    """Wrap ``lock`` in an order-tracking proxy under DS_SANITIZE=1.

    Off-state returns ``lock`` VERBATIM: zero wrapper, zero per-acquire
    branch, same discipline as :func:`maybe_checkify`. ``name`` is the
    ``Class.attr`` key the JAX package gives the same lock, so reports
    from both packages speak the same language.
    """
    if enabled is None:
        enabled = sanitize_enabled()
    if not enabled:
        return lock
    return _TrackedLock(lock, name)
