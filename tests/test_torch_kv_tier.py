"""The KV offload surface and the host spill tier: the port vs the JAX package.

Pools are small (2 layers, block 4, 2 KV heads, head dim 4), in fp32 and
bf16, filled from the same numpy draws on both sides:

- the pool's ``gather``/``offload(keep=)``/``restore`` round trip is
  bitwise and equals the JAX pool's (same block ids, same contents), and
  ``_validate_handle`` refuses the same malformed handles;
- ``HostKVStore`` under a byte budget equals the JAX store record for
  record (keys, LRU order, bytes, counters) through a seeded sequence of
  puts, pops and peeks;
- ``TierManager``: demote → promote restores the blocks bit for bit in
  fp32 and bf16 and equals the JAX tier's stats; a promotion evicts other
  blocks for room; a partial promotion unclaims the tail; an int8 tier
  promotes exactly the JAX int8 tier's KV; prefetch stages the chain and
  the claim prefers the staged copy; fences are released when staging
  fails and on shutdown;
- ``export_chain`` → ``import_chain`` round trip is bitwise; a forged,
  torn or re-versioned record raises ``KVTierCorruptionError`` and adopts
  nothing; a record exported by the JAX tier imports into the port's
  through ``kv_handle_from_jax`` and one exported by the port imports into
  the JAX tier through ``kv_handle_to_jax``, and both promote the same KV.
"""

import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepspeed_tpu.inference.v2.kv_tier import HostKVStore as JaxStore
from deepspeed_tpu.inference.v2.kv_tier import TierManager as JaxTier
from deepspeed_tpu.inference.v2.prefix_cache import PrefixCacheManager as JaxPCM
from deepspeed_tpu.inference.v2.ragged import BlockedKVCache as JaxCache
from deepspeed_tpu.inference.v2.ragged import DSStateManager as JaxSM
from deepspeed_tpu.inference.v2.ragged import KVCacheHandleError as JaxHandleError
from deepspeed_tpu.utils.sanitize import KVTierCorruptionError as JaxCorruption
from deepspeed_tpu_torch.inference.v2.config_v2 import KVTierConfig
from deepspeed_tpu_torch.inference.v2.kv_tier import (HostKVStore, TierManager, kv_tier_bytes,
                                                      kv_tier_enabled, kv_tier_quantized)
from deepspeed_tpu_torch.inference.v2.prefix_cache import PrefixCacheManager
from deepspeed_tpu_torch.inference.v2.ragged import (BlockedKVCache, DSStateManager,
                                                     KVCacheHandleError)
from deepspeed_tpu_torch.models import kv_handle_from_jax, kv_handle_to_jax
from deepspeed_tpu_torch.utils.sanitize import KVTierCorruptionError, check_kv_tier_store

DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _pools(num_blocks=10, dtype="fp32"):
    jd, td = DTYPES[dtype]
    return (JaxCache(2, num_blocks, 4, 2, 4, dtype=jd),
            BlockedKVCache(2, num_blocks, 4, 2, 4, dtype=td, device="cpu"))


def _fill(jc, tc, blocks, seed=None):
    """Write the same random KV into ``blocks`` of both pools → the port's
    host copy of it."""
    shape = (jc.num_layers, len(blocks), jc.block_size, jc.n_kv_heads, jc.head_dim)
    rng = np.random.default_rng(sum(blocks) + len(blocks) if seed is None else seed)
    kv = {n: np.asarray(jnp.asarray(rng.standard_normal(shape).astype(np.float32), jc.dtype))
          for n in ("k", "v")}
    ids = jnp.asarray(blocks)
    jc.k = jc.k.at[:, ids].set(jnp.asarray(kv["k"]))
    jc.v = jc.v.at[:, ids].set(jnp.asarray(kv["v"]))
    t = kv_handle_from_jax(kv)
    idx = torch.tensor(blocks)
    tc.k[:, idx] = t["k"]
    tc.v[:, idx] = t["v"]
    return t


def _eq(t, a):
    """Port tensor ``t`` equals JAX numpy/array ``a`` bit for bit."""
    a = np.asarray(a)
    if t.dtype == torch.bfloat16:
        assert a.dtype.name == "bfloat16"
        np.testing.assert_array_equal(t.view(torch.int16).numpy(), a.view(np.int16))
    else:
        np.testing.assert_array_equal(t.numpy(), a)


def _same_pools(jc, tc):
    _eq(tc.k, jc.k)
    _eq(tc.v, jc.v)


# ------------------------------------------------------------------ the pool
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_gather_offload_restore_equal_jax_and_bitwise(dtype):
    jc, tc = _pools(dtype=dtype)
    jb, tb = [int(b) for b in jc.reserve(5)], [int(b) for b in tc.reserve(5)]
    assert jb == tb
    want = _fill(jc, tc, tb)
    g = tc.gather(tb)
    assert tc.free_blocks == jc.free_blocks  # gather frees nothing
    for n in ("k", "v"):
        assert torch.equal(g[n], want[n])
        _eq(g[n], jc.gather(jb)[n])
    keep = tb[:2]
    hj, ht = jc.offload(jb, keep=keep), tc.offload(tb, keep=keep)
    assert tc.free_blocks == jc.free_blocks == 10 - 1 - 2
    nj, nt = list(jc.restore(hj)), list(tc.restore(ht))
    assert nt == nj
    _same_pools(jc, tc)
    back = tc.gather(nt)
    for n in ("k", "v"):
        assert torch.equal(back[n], want[n])
    assert tc.restore({"k": ht["k"][:, :0], "v": ht["v"][:, :0]}) == []
    with pytest.raises(KVCacheHandleError, match="keep ids"):
        tc.offload(nt[:1], keep=[nt[1]])
    with pytest.raises(KVCacheHandleError, match="invalid block id"):
        tc.gather([10])


def _bad_handles(dtype):
    good = {"k": np.zeros((2, 1, 4, 2, 4), np.float32), "v": np.zeros((2, 1, 4, 2, 4), np.float32)}
    if dtype == "bf16":
        good = {n: np.asarray(jnp.asarray(a, jnp.bfloat16)) for n, a in good.items()}
    q = {"k": np.zeros((2, 1, 4, 2, 4), np.int8), "v": np.zeros((2, 1, 4, 2, 4), np.int8),
         "k_scales": np.ones((2, 1, 1), np.float32), "v_scales": np.ones((2, 1, 1), np.float32),
         "quantized": True}
    return {
        "good": good, "good_quantized": q,
        "missing_v": {"k": good["k"]},
        "wrong_layers": {n: np.concatenate([a, a]) for n, a in good.items()},
        "wrong_head_dim": {n: a[..., :2] for n, a in good.items()},
        "wrong_dtype": {n: a.astype(np.float64) for n, a in good.items()},
        "kv_disagree": {"k": good["k"], "v": np.concatenate([good["v"]] * 2, axis=1)},
        "quant_float_carrier": dict(q, k=good["k"], v=good["v"]),
        "quant_scales_shape": dict(q, k_scales=np.ones((2, 1, 3), np.float32)),
        "quant_scales_dtype": dict(q, v_scales=np.ones((2, 1, 1), np.float64)),
        "quant_missing_scales": {n: a for n, a in q.items() if n != "v_scales"},
    }


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_validate_handle_refusals_match_jax(dtype):
    jc, tc = _pools(dtype=dtype)
    for name, h in _bad_handles(dtype).items():
        try:
            jc._validate_handle(h)
            jax_ok = True
        except JaxHandleError:
            jax_ok = False
        try:
            tc._validate_handle(kv_handle_from_jax(h))
            port_ok = True
        except KVCacheHandleError:
            port_ok = False
        assert port_ok == jax_ok == name.startswith("good"), name


def test_quantized_restore_equals_jax():
    jc, tc = _pools(num_blocks=6)
    rng = np.random.default_rng(3)
    q = {"k": rng.integers(-127, 128, (2, 2, 4, 2, 4)).astype(np.int8),
         "v": rng.integers(-127, 128, (2, 2, 4, 2, 4)).astype(np.int8),
         "k_scales": rng.random((2, 2, 4)).astype(np.float32),
         "v_scales": rng.random((2, 2, 4)).astype(np.float32), "quantized": True}
    assert list(tc.restore(kv_handle_from_jax(q))) == list(jc.restore(q))
    _same_pools(jc, tc)


# ------------------------------------------------------------ the host store
def test_host_store_lru_equals_jax_record_for_record():
    rng = np.random.RandomState(5)
    js, ts = JaxStore(1000), HostKVStore(1000)
    keys = [(int(rng.randint(0, 3)), tuple(rng.randint(0, 9, size=4).tolist()))
            for _ in range(12)]
    for step in range(80):
        op = rng.randint(4)
        pk, toks = keys[rng.randint(len(keys))]
        if op == 0:
            nbytes = int(rng.choice([100, 250, 400, 1200]))
            assert ts.put(pk, toks, {"k": None}, nbytes) == js.put(pk, toks, {"k": None}, nbytes)
        elif op == 1:
            assert (ts.pop(pk, toks) is None) == (js.pop(pk, toks) is None)
        elif op == 2:
            touch = bool(rng.randint(2))
            assert (ts.peek(pk, toks, touch=touch) is None) == \
                (js.peek(pk, toks, touch=touch) is None)
        else:
            assert ts.contains(pk, toks) == js.contains(pk, toks)
        assert list(ts._records) == list(js._records), f"step {step}"
        assert [r["key"] for r in ts._records.values()] == \
            [r["key"] for r in js._records.values()]
        assert ts.stats() == js.stats()
        check_kv_tier_store(ts)
    assert ts.stats()["evictions"] > 0
    ts._records[next(iter(ts._records))]["key"] += 1  # a forged identity
    with pytest.raises(KVTierCorruptionError, match="identity/content"):
        check_kv_tier_store(ts)


# ------------------------------------------------------------ the tier
class _Stack:
    """A pool, state manager, prefix cache and tier on one side."""

    def __init__(self, side, num_blocks=10, dtype="fp32", quantize=False, tier_bytes=1 << 20,
                 group=0):
        jd, td = DTYPES[dtype]
        if side == "jax":
            self.cache = JaxCache(2, num_blocks, 4, 2, 4, dtype=jd)
            self.mgr = JaxSM(self.cache, max_tracked_sequences=4)
            self.pc = JaxPCM(self.cache)
            self.tier = JaxTier(self.pc, tier_bytes, quantize=quantize, quant_group_size=group,
                                prefetch=False)
        else:
            self.cache = BlockedKVCache(2, num_blocks, 4, 2, 4, dtype=td, device="cpu")
            self.mgr = DSStateManager(self.cache, max_tracked_sequences=4)
            self.pc = PrefixCacheManager(self.cache)
            self.tier = TierManager(self.pc, tier_bytes, quantize=quantize,
                                    quant_group_size=group, prefetch=False)
        self.mgr.attach_prefix_cache(self.pc)
        self.pc.attach_tier(self.tier)

    def retire(self, tokens, uid=1):
        d = self.mgr.get_or_create_sequence(uid)
        self.mgr.allocate_for(d, len(tokens))
        d.advance(len(tokens))
        d.tokens = list(tokens)
        full = len(tokens) // self.cache.block_size
        blocks = [int(b) for b in d.blocks[:full]]
        self.mgr.flush_sequence(uid)
        return blocks


def _pair(**kw):
    return _Stack("jax", **kw), _Stack("port", **kw)


def _retire_both(j, t, tokens, uid=1):
    bj, bt = j.retire(tokens, uid), t.retire(tokens, uid)
    assert bj == bt
    return _fill(j.cache, t.cache, bt)


def _tier_stats(tier):
    s = dict(tier.stats())
    s.pop("prefetch_wait_ms")
    return s


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_demote_promote_bitwise_and_equal_jax(dtype):
    j, t = _pair(dtype=dtype)
    want = _retire_both(j, t, list(range(12)))      # 3 cached blocks
    for s in (j, t):
        s.pc.ensure_free(s.cache.free_blocks + 3)   # pressure: all three demote
    assert _tier_stats(t.tier) == _tier_stats(j.tier)
    assert t.tier.stats()["demoted_blocks"] == 3 and t.pc.cached_blocks == 0
    assert t.pc.match_len(list(range(13))) == j.pc.match_len(list(range(13))) == 12
    rj, rt = j.pc.acquire(2, list(range(13))), t.pc.acquire(2, list(range(13)))
    assert rt == rj and rt[1] == 12
    got = t.cache.gather(rt[0])
    for n in ("k", "v"):
        assert torch.equal(got[n], want[n])  # bit-identical restore
    _same_pools(j.cache, t.cache)
    assert _tier_stats(t.tier) == _tier_stats(j.tier)
    assert t.pc.stats() == j.pc.stats() and t.pc.stats()["tier2_hits"] == 1
    check_kv_tier_store(t.tier.store)


def test_promotion_evicts_others_and_partial_promotion_unclaims_tail():
    j, t = _pair(num_blocks=5)                       # null + 4
    for s in (j, t):
        s.retire(list(range(12)))
        s.pc.ensure_free(s.cache.free_blocks + 3)   # all demoted
        s.retire(list(range(50, 62)), uid=2)        # refill the trie
    assert t.cache.free_blocks == j.cache.free_blocks == 1
    assert t.pc.acquire(3, list(range(13))) == j.pc.acquire(3, list(range(13)))
    assert t.tier.store.stats()["demotions"] >= 5   # seq 2's chain was displaced
    assert _tier_stats(t.tier) == _tier_stats(j.tier)

    j, t = _pair(num_blocks=5)
    for s in (j, t):
        s.retire(list(range(12)))
        s.pc.ensure_free(s.cache.free_blocks + 3)
        d = s.mgr.get_or_create_sequence(5)         # pin the pool: nothing evictable
        s.mgr.allocate_for(d, 12)
    rj, rt = j.pc.acquire(6, list(range(13))), t.pc.acquire(6, list(range(13)))
    assert rt == rj and rt[1] == 4                  # the head only
    assert len(t.tier.store) == len(j.tier.store) == 2  # the tail went back
    assert _tier_stats(t.tier) == _tier_stats(j.tier)


@pytest.mark.parametrize("group", [0, 8])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_int8_tier_promotes_the_jax_tiers_kv(dtype, group):
    j, t = _pair(dtype=dtype, quantize=True, group=group)
    want = _retire_both(j, t, list(range(12)))
    for s in (j, t):
        s.pc.ensure_free(s.cache.free_blocks + 3)
    assert _tier_stats(t.tier) == _tier_stats(j.tier)
    assert t.tier.stats()["quant_error_max"] > 0
    rj, rt = j.pc.acquire(2, list(range(13))), t.pc.acquire(2, list(range(13)))
    assert rt == rj and rt[1] == 12
    _same_pools(j.cache, t.cache)   # the same dequantized KV, bit for bit
    got = t.cache.gather(rt[0])
    assert not torch.equal(got["k"], want["k"])     # lossy, and measured
    bound = want["k"].float().abs().max() / 127 / 2 + 1e-2
    assert (got["k"].float() - want["k"].float()).abs().max() <= bound


def test_store_budget_and_config_readers():
    j, t = _pair(tier_bytes=1)
    for s in (j, t):
        s.retire(list(range(12)))
        s.pc.ensure_free(s.cache.free_blocks + 3)
        assert len(s.tier.store) == 0 and s.pc.acquire(2, list(range(13)))[1] == 0
    assert _tier_stats(t.tier) == _tier_stats(j.tier)
    cfg = KVTierConfig(enabled=True, host_bytes=123, quantize=True)
    assert kv_tier_enabled(cfg) and kv_tier_bytes(cfg) == 123 and kv_tier_quantized(cfg)
    assert not kv_tier_enabled(KVTierConfig()) and not kv_tier_quantized(KVTierConfig())


def test_prefetch_stages_and_claim_prefers_staged():
    t = _Stack("port")
    t.tier.prefetch_enabled = True
    t.retire(list(range(12)))
    t.pc.ensure_free(t.cache.free_blocks + 3)
    prompt = list(range(13))
    t.tier.prefetch([1, 2, 3])                      # <= block_size: nothing to stage
    assert len(t.tier._inflight) == 0
    t.tier.prefetch(prompt)
    t.tier.prefetch(prompt)                         # one fence, one pass
    t.tier.wait_prefetch(prompt, timeout=10.0)
    s = t.tier.stats()
    assert s["prefetched_blocks"] == 3 and s["prefetch_waits"] == 1
    assert s["prefetch_timeouts"] == 0
    assert t.pc.acquire(2, prompt)[1] == 12
    assert t.tier.stats()["stage_hits"] == 3
    t.tier.shutdown()


def test_fences_released_on_staging_error_and_on_shutdown():
    t = _Stack("port")
    t.tier.prefetch_enabled = True
    t.retire(list(range(12)))
    t.pc.ensure_free(t.cache.free_blocks + 3)
    t.tier._stage_prompt = lambda prompt: (_ for _ in ()).throw(RuntimeError("boom"))
    prompt = list(range(13))
    t.tier.prefetch(prompt)
    t.tier.wait_prefetch(prompt, timeout=10.0)
    s = t.tier.stats()
    assert s["prefetch_errors"] == 1 and s["prefetch_timeouts"] == 0
    ev = threading.Event()
    with t.tier._lock:
        t.tier._inflight[(99,)] = ev
    t.tier.shutdown()
    assert ev.is_set() and len(t.tier.store) == 0


# ---------------------------------------------------------------- handoff
PROBE = list(range(13))


@pytest.mark.parametrize("quantize", [False, True])
def test_export_import_round_trip_bitwise(quantize):
    a = _Stack("port", quantize=quantize)
    want = _fill(JaxCache(2, 10, 4, 2, 4, dtype=jnp.float32), a.cache, a.retire(list(range(12))))
    record = a.tier.export_chain(PROBE)
    assert len(record["entries"]) == 3 and record["quantized"] is quantize
    assert a.tier.stats()["exported_blocks"] == 3
    results = []
    for _ in range(2):
        b = _Stack("port", quantize=quantize)
        assert b.tier.import_chain(record) == 3 and b.pc.match_len(PROBE) == 12
        blocks, cached = b.pc.acquire(2, PROBE)
        assert cached == 12
        results.append(b.cache.gather(blocks))
    for n in ("k", "v"):
        assert torch.equal(results[0][n], results[1][n])  # replicas agree
        if not quantize:
            assert torch.equal(results[0][n], want[n])


def test_forged_torn_and_reversioned_records_adopt_nothing():
    a = _Stack("port")
    a.retire(list(range(12)))
    b = _Stack("port")
    forged = a.tier.export_chain(PROBE)
    forged["entries"][1]["tokens"] = (9, 9, 9, 9)
    torn = a.tier.export_chain(PROBE)
    del torn["entries"][2]["handle"]
    short = a.tier.export_chain(PROBE)
    short["entries"][0]["tokens"] = short["entries"][0]["tokens"][:2]
    gap = a.tier.export_chain(PROBE)
    del gap["entries"][1]
    for rec, match in ((forged, "forged or corrupt"), (torn, "torn or truncated"),
                       (short, "truncated"), (gap, "breaks the chain")):
        with pytest.raises(KVTierCorruptionError, match=match):
            b.tier.import_chain(rec)
    b.pc.invalidate_for_version(1)  # new weights: a version-0 record must not graft
    with pytest.raises(KVTierCorruptionError, match="root_key"):
        b.tier.import_chain(a.tier.export_chain(PROBE))
    assert len(b.tier.store) == 0 and b.tier.stats()["import_rejects"] == 5
    assert b.tier.stats()["imported_blocks"] == 0


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_records_cross_between_packages(dtype, quantize):
    j, t = _pair(dtype=dtype, quantize=quantize)
    _retire_both(j, t, list(range(12)))
    rec_j, rec_t = j.tier.export_chain(PROBE), t.tier.export_chain(PROBE)
    assert [e["key"] for e in rec_t["entries"]] == [e["key"] for e in rec_j["entries"]]
    # the JAX record into a port tier, the port's record into a JAX tier
    jb, tb = _pair(dtype=dtype, quantize=quantize)
    assert tb.tier.import_chain(kv_handle_from_jax(rec_j)) == 3
    assert jb.tier.import_chain(kv_handle_to_jax(rec_t)) == 3
    for ej, et in zip(rec_j["entries"], rec_t["entries"]):
        assert et["nbytes"] == ej["nbytes"]
        for name, arr in ej["handle"].items():
            if name != "quantized":
                _eq(et["handle"][name], arr)
    rj, rt = jb.pc.acquire(2, PROBE), tb.pc.acquire(2, PROBE)
    assert rt == rj and rt[1] == 12
    _same_pools(jb.cache, tb.cache)
    with pytest.raises(JaxCorruption):
        forged = kv_handle_to_jax(rec_t)
        forged["entries"][0]["key"] += 1
        jb.tier.import_chain(forged)
