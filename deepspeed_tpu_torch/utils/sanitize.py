"""Host-side invariant checks of the prefix cache and the KV spill tier.

Port of the part of ``deepspeed_tpu/utils/sanitize.py`` that the radix
prefix cache and the KV tier need: the typed errors and three checks.
``check_handoff_record`` runs on every ``TierManager.import_chain`` (a
handoff record is untrusted input); ``check_prefix_index`` and
``check_kv_tier_store`` are for callers and tests. The JAX package runs
those two after every mutation under ``DS_SANITIZE``; that switch, the
``checkify`` device checks and the lock-order tracker are not ported
(ROADMAP.md, port queue item 4).
"""


class SanitizerError(RuntimeError):
    """Base class of the invariant failures. ``retry_elsewhere`` is False:
    an invariant trip is a bug, not a capacity signal."""
    reason = "sanitizer"
    retry_elsewhere = False


class PrefixCacheCorruptionError(SanitizerError):
    """Radix trie refcount/reclaimable accounting disagreement."""


class KVTierCorruptionError(SanitizerError):
    """Host KV spill-tier record whose stored chained key no longer
    re-derives from its (parent_key, tokens) identity — promotion would
    graft wrong-content KV into the trie — or byte accounting drift."""


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
