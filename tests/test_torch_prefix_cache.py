"""The radix prefix cache: the port's manager vs the JAX package's.

One seeded trace of sequence lifetimes runs through a JAX
``DSStateManager`` + ``PrefixCacheManager`` and the port's, on equal
pools (fp32, 2 layers, block 4): sequences are created with prompts that
share a few system prefixes (``acquire``), allocate their prefill and
decode blocks, some under pool pressure (``reserve`` evicting unreferenced
cached blocks), retire into the trie (``release``) or rewind; routing probes
(``match_len``) run in between, and when no lease is out the cache is
invalidated for a new weight version (``invalidate_for_version``, which
re-keys the root). After every step the two must agree on each live
sequence's block ids and cached tokens, on the leases, on every trie node
(chained key, parent key, tokens, block id, refcount, promotion flag), on
``stats()`` and on the free list; ``check_prefix_index`` must pass on both.
The trace runs with no cap and with ``max_cached_blocks``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepspeed_tpu.inference.v2.prefix_cache import PrefixCacheManager as JaxPCM
from deepspeed_tpu.inference.v2.ragged import BlockedKVCache as JaxCache
from deepspeed_tpu.inference.v2.ragged import DSStateManager as JaxSM
from deepspeed_tpu.utils.sanitize import check_prefix_index as jax_check
from deepspeed_tpu_torch.inference.v2.prefix_cache import (PrefixCacheManager,
                                                           RadixPrefixIndex,
                                                           prefix_cache_enabled)
from deepspeed_tpu_torch.inference.v2.ragged import BlockedKVCache, DSStateManager
from deepspeed_tpu_torch.inference.v2.config_v2 import PrefixCacheConfig
from deepspeed_tpu_torch.utils.sanitize import PrefixCacheCorruptionError, check_prefix_index

torch.set_num_threads(1)  # the suite runs in parallel worker processes

BS, NB = 4, 24


def _stacks(max_cached):
    jc = JaxCache(2, NB, BS, 2, 4, dtype=jnp.float32)
    jm = JaxSM(jc, max_tracked_sequences=8)
    jp = JaxPCM(jc, max_cached_blocks=max_cached)
    jm.attach_prefix_cache(jp)
    tc = BlockedKVCache(2, NB, BS, 2, 4, dtype=torch.float32, device="cpu")
    tm = DSStateManager(tc, max_tracked_sequences=8)
    tp = PrefixCacheManager(tc, max_cached_blocks=max_cached)
    tm.attach_prefix_cache(tp)
    return (jc, jm, jp), (tc, tm, tp)


def _nodes(index):
    out, stack = [], [index.root]
    while stack:
        node = stack.pop()
        for bucket in node.children.values():
            for c in bucket:
                out.append((c.key, c.parent.key, c.tokens, c.block_id, c.ref, c.tier2))
                stack.append(c)
    return sorted(out)


def _state(cache, mgr, pc):
    seqs = {uid: (list(d.blocks), d.seen_tokens, d.cached_tokens, d.shared_blocks,
                  list(d.tokens)) for uid, d in mgr._seqs.items()}
    leases = {uid: [n.block_id for n in path] for uid, path in pc._leases.items()}
    return (seqs, leases, _nodes(pc.index), pc.index.root.key, pc.stats(),
            cache.free_blocks, sorted(cache._allocator._free))


def _trace(seed):
    """A list of (op, args) over uids 0..; prompts share 3 system prefixes."""
    rng = np.random.RandomState(seed)
    systems = [rng.randint(0, 50, size=n).tolist() for n in (8, 12, 5)]
    ops, live, uid = [], [], 0
    for step in range(60):
        r = rng.rand()
        if (r < 0.45 or not live) and len(live) < 6:
            sysp = systems[rng.randint(3)]
            prompt = sysp + rng.randint(0, 50, size=rng.randint(1, 9)).tolist()
            ops.append(("start", uid, prompt))
            live.append(uid)
            uid += 1
        elif r < 0.7:
            ops.append(("decode", live[rng.randint(len(live))], int(rng.randint(1, 7))))
        elif r < 0.75:
            ops.append(("rewind", live[rng.randint(len(live))], int(rng.randint(0, 3))))
        else:
            ops.append(("retire", live.pop(rng.randint(len(live))), None))
        if rng.rand() < 0.3:
            ops.append(("probe", None, systems[rng.randint(3)] + [1, 2, 3]))
        if step in (30, 59):
            ops += [("retire", u, None) for u in live] + [("invalidate", None, step)]
            live = []
    return ops


def _apply(op, uid, arg, cache, mgr, pc):
    """One trace step on one stack; → a result to compare (or None)."""
    if op == "start":
        d = mgr.get_or_create_sequence(uid, prompt_tokens=arg)
        new = len(arg) - d.seen_tokens
        if d.blocks_needed(new) > cache.free_blocks + pc.evictable_blocks:
            return "no-room"
        mgr.allocate_for(d, new)
        d.tokens.extend(arg[d.seen_tokens:])
        d.advance(new)
        return d.cached_tokens
    if op == "decode":
        d = mgr.query(uid)
        if d.blocks_needed(arg) > cache.free_blocks + pc.evictable_blocks:
            return "no-room"
        mgr.allocate_for(d, arg)
        d.tokens.extend(range(100 + d.seen_tokens, 100 + d.seen_tokens + arg))
        d.advance(arg)
        return None
    if op == "rewind":
        d = mgr.query(uid)
        n = min(arg, d.seen_tokens - d.cached_tokens)
        mgr.rewind_sequence(d, n)
        return d.seen_tokens
    if op == "retire":
        mgr.flush_sequence(uid)
        return None
    if op == "probe":
        return pc.match_len(arg)
    if op == "invalidate":
        pc.invalidate_for_version(arg)
        return None
    raise KeyError(op)


@pytest.mark.parametrize("max_cached", [0, 6])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_trace_equals_jax_step_for_step(seed, max_cached):
    jax_side, port_side = _stacks(max_cached)
    evicted = 0
    for i, (op, uid, arg) in enumerate(_trace(seed)):
        rj = _apply(op, uid, arg, *jax_side)
        rt = _apply(op, uid, arg, *port_side)
        assert rt == rj, f"step {i} {op}: port {rt} vs jax {rj}"
        sj, st = _state(*jax_side), _state(*port_side)
        assert st == sj, f"step {i} {op}({uid}) diverged"
        jax_check(jax_side[2].index)
        check_prefix_index(port_side[2].index)
        evicted = st[4]["evictions"]
    # the trace reached every path it is meant to hold
    stats = port_side[2].stats()
    assert stats["tokens_saved"] > 0 and evicted > 0 and stats["insertions"] > 0
    assert port_side[2].index.root.key == 59


def test_acquire_caps_one_short_and_leases_match():
    (jc, jm, jp), (tc, tm, tp) = _stacks(0)
    for cache, mgr in ((jc, jm), (tc, tm)):
        d = mgr.get_or_create_sequence(1, prompt_tokens=list(range(8)))
        mgr.allocate_for(d, 8)
        d.tokens.extend(range(8))
        d.advance(8)
        mgr.flush_sequence(1)
    for pc in (jp, tp):
        assert pc.match_len(list(range(8))) == 4   # capped one token short
        assert pc.match_len(list(range(9))) == 8
    assert tp.acquire(2, list(range(9))) == jp.acquire(2, list(range(9))) == ([1, 2], 8)
    assert tp.stats() == jp.stats()
    with pytest.raises(RuntimeError, match="lease"):
        tp.invalidate_for_version(3)


def test_config_gate_and_corruption_check():
    assert not prefix_cache_enabled(PrefixCacheConfig())
    assert prefix_cache_enabled(PrefixCacheConfig(enabled=True))
    index = RadixPrefixIndex(4)
    index.insert_child(index.root, (1, 2, 3, 4), 5)
    check_prefix_index(index)
    index._ref0 += 1  # accounting drift
    with pytest.raises(PrefixCacheCorruptionError, match="evictable"):
        check_prefix_index(index)
