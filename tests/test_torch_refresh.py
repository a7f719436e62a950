"""Live weight refresh on the port against the JAX package, on the CPU.

- ``swap_params``: after serving traffic on v0, an engine swapped to v1
  serves what a cold-started engine on v1 serves, bit for bit, and what
  the JAX engine serves after its own swap (fp32, and int8, where the
  swapped engine's carriers and scales equal the cold start's byte for
  byte); ``quantized_bytes`` and ``weight_version`` follow, and the
  messages of every refusal (live sequences, suspended ones, a pipelined
  burst left unfetched, a destroyed engine) are the JAX engine's.
- Invalidation: the prefix trie (and its spill tier) empties at the swap
  and re-keys its root with the version on both packages; a handoff
  record exported under v0 is rejected typed under v1 by both, and one
  exported under v1 adopts. The LoRA hot set is dropped on both.
- The gateway's staged refresh: every case of the JAX package's
  ``TestGatewayRefresh`` in lockstep over its ``VersionedEngine`` (streams
  in flight finish on the old weights, queued ones run on the new, the
  outbox cleared, a cross-version import rejected, a timeout withdrawing
  the swap with nothing adopted, a mid-swap crash failing the gateway
  typed, refusals), and the same protocol over the real engines: in-flight
  streams equal v0's, queued ones equal a cold v1 engine's, on both
  packages.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu import serving as jserving
from deepspeed_tpu.inference.v2 import (DSStateManagerConfig as JaxSM,
                                        DynamicSplitFuseScheduler as JaxSched,
                                        InferenceEngineV2 as JaxEngine,
                                        RaggedInferenceEngineConfig as JaxCfg)
from deepspeed_tpu.inference.v2.config_v2 import (KVTierConfig as JaxTier,
                                                  LoRAServingConfig as JaxLoRA,
                                                  PrefixCacheConfig as JaxPrefix)
from deepspeed_tpu.models import build_llama
from deepspeed_tpu.utils import sanitize as jsanitize
from deepspeed_tpu_torch import serving
from deepspeed_tpu_torch.inference.quantization import QuantizedWeight
from deepspeed_tpu_torch.inference.v2 import (DSStateManagerConfig, DynamicSplitFuseScheduler,
                                              InferenceEngineV2, KVTierConfig, LoRAServingConfig,
                                              PrefixCacheConfig, RaggedInferenceEngineConfig)
from chip_smoke import REFRESH_STEP
from deepspeed_tpu_torch.models import LlamaConfig, params_from_jax
from deepspeed_tpu_torch.utils import sanitize
from unit.inference.serving.test_refresh import BS, PROMPT, VersionedEngine, params_for, record_for

torch.set_num_threads(1)  # the suite runs in parallel worker processes

SM = dict(max_ragged_batch_size=64, max_ragged_sequence_count=4, max_tracked_sequences=6,
          max_context=64)
# the stand-in train step of chip_smoke.py's phase 30 (``stepped``) on numpy trees:
# p - STEP·p·z, z ~ N(0, 1) from a seed (the JAX bench's p - 1e-3·p is below half a bf16
# ulp, so it rounds to the identity in bf16, and a uniform scale leaves int8 carriers and
# greedy streams as they were)
STEP = REFRESH_STEP
PROMPTS = [(np.arange(11) * 7 + 3) % 120, (np.arange(4) * 5 + 1) % 120,
           (np.arange(17) * 3 + 2) % 120]


@pytest.fixture(scope="module")
def trees():
    """The debug model, its v0 tree and v1 = the stand-in train step
    on its floating leaves, numpy and port."""
    model = build_llama("debug", remat=False)
    v0 = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0),
                                             jnp.zeros((1, 8), jnp.int32))["params"])
    rng = np.random.default_rng(1)
    v1 = jax.tree.map(lambda x: (x - np.float32(STEP) * x * rng.standard_normal(
        x.shape, np.float32)).astype(x.dtype) if np.issubdtype(x.dtype, np.floating) else x, v0)
    return model, {0: v0, 1: v1}, {0: params_from_jax(v0), 1: params_from_jax(v1)}


def engines(trees, version=0, mode="none", prefix=False, lora=False, async_on=False):
    """A JAX and a port engine on ``version``'s weights, one config."""
    model, jtrees, ttrees = trees
    sections = dict(kv_block_size=BS, quantization={"quantization_mode": mode})
    lcfg = dict(enabled=lora, hot_set=2, max_rank=4, prefetch=False)
    jeng = JaxEngine(model=model, config=JaxCfg(
        **sections, state_manager=JaxSM(**SM), prefix_cache=JaxPrefix(enabled=prefix),
        kv_tier=JaxTier(enabled=prefix, quantize=False), lora=JaxLoRA(**lcfg)),
        params=jtrees[version], dtype=jnp.float32)
    teng = InferenceEngineV2(LlamaConfig(**dataclasses.asdict(model.config)),
                             RaggedInferenceEngineConfig(
                                 **sections, state_manager=DSStateManagerConfig(**SM),
                                 prefix_cache=PrefixCacheConfig(enabled=prefix),
                                 kv_tier=KVTierConfig(enabled=prefix, quantize=False),
                                 lora=LoRAServingConfig(**lcfg),
                                 async_burst={"enabled": async_on}),
                             params=ttrees[version], dtype=torch.float32, device="cpu")
    return jeng, teng


def run(eng, prompts=PROMPTS, max_new=8, uid0=0):
    cls = JaxSched if isinstance(eng, JaxEngine) else DynamicSplitFuseScheduler
    sched = cls(eng, token_budget=48, max_burst=4)
    for i, p in enumerate(prompts):
        sched.add_request(uid0 + i, p.astype(np.int32), max_new_tokens=max_new)
    out = sched.run_to_completion()
    return [out[uid0 + i] for i in range(len(prompts))]


def leaves(tree):
    """A port param tree → [(name, tensor)], carriers as their parts."""
    out = []
    for k, v in sorted(tree.items()):
        for n, w in (sorted(v.items()) if isinstance(v, dict) else [("", v)]):
            if isinstance(w, QuantizedWeight):
                out += [(f"{k}/{n}/values", w.values), (f"{k}/{n}/scales", w.scales)]
            else:
                out.append((f"{k}/{n}", w))
    return out


# ---------------------------------------------------------------------- swap_params
@pytest.mark.parametrize("mode", ["none", "int8"])
def test_swap_equals_cold_start_and_jax_swap(trees, mode):
    jeng, teng = engines(trees, 0, mode)
    v0 = run(teng)
    assert v0 == run(jeng)
    bytes0 = teng.quantized_bytes
    assert jeng.swap_params(trees[1][1], 1) == teng.swap_params(trees[2][1], 1) == 1
    assert teng.weight_version == jeng.weight_version == 1
    _, cold = engines(trees, 1, mode)
    got = run(teng, uid0=100)
    assert got == run(cold, uid0=100) == run(jeng, uid0=100)
    assert got != v0
    assert teng.quantized_bytes == cold.quantized_bytes == bytes0
    swapped, fresh = leaves(teng.params), leaves(cold.params)
    assert [n for n, _ in swapped] == [n for n, _ in fresh]
    for (name, a), (_, b) in zip(swapped, fresh):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    if mode == "int8":
        assert isinstance(teng.params["layers"]["wq"], QuantizedWeight)


def test_swap_refusals_match_jax(trees):
    jeng, teng = engines(trees, 0)
    msgs = []
    for eng in (jeng, teng):
        eng.put([1], [PROMPTS[0].astype(np.int32)])
        with pytest.raises(RuntimeError, match="1 live sequence") as live:
            eng.swap_params(eng.params, 1)
        eng.suspend(1)
        with pytest.raises(RuntimeError, match="1 suspended sequence") as suspended:
            eng.swap_params(eng.params, 1)
        eng.flush(1)
        msgs.append((str(live.value), str(suspended.value)))
        eng.destroy()
        with pytest.raises(RuntimeError, match="destroyed engine"):
            eng.swap_params({}, 1)
    assert msgs[0] == msgs[1]
    assert teng.weight_version == 0


def test_swap_refused_while_a_pipelined_burst_is_unfetched(trees):
    _, teng = engines(trees, 0, async_on=True)
    uids = [1, 2]
    first = teng.put(uids, [p.astype(np.int32) for p in PROMPTS[:2]], sample="greedy")
    h = teng.decode_burst_async(uids, [[int(t)] for t in first], 4)
    with pytest.raises(RuntimeError, match="2 live sequence"):
        teng.swap_params(teng.params, 1)
    assert h._toks is None  # the refusal fetched nothing
    toks = h.fetch()
    for uid in uids:
        teng.flush(uid)
    assert teng.swap_params(teng.params, 1) == 1
    assert toks.shape == (4, 2)


def test_prefix_trie_and_handoff_versioned_on_both(trees):
    pair = engines(trees, 0, prefix=True)
    prompt = (np.arange(24) * 5 + 1) % 120
    records = []
    for eng in pair:
        run(eng, [prompt], max_new=2)
        assert eng.prefix_match_len(prompt) > 0
        records.append(eng.export_prefix(prompt))
    assert records[1]["root_key"] == records[0]["root_key"] == 0
    assert [e["key"] for e in records[1]["entries"]] == [e["key"] for e in records[0]["entries"]]
    for eng, tree in zip(pair, (trees[1][1], trees[2][1])):
        eng.swap_params(tree, 1)
        assert eng.prefix_match_len(prompt) == 0
        assert eng.prefix_cache.stats()["cached_blocks"] == 0
    for eng, record, err in zip(pair, records, (jsanitize.KVTierCorruptionError,
                                                sanitize.KVTierCorruptionError)):
        with pytest.raises(err, match="root_key"):
            eng.import_prefix(record)
    # a record exported under v1 adopts on both
    fresh = []
    for eng in pair:
        run(eng, [prompt], max_new=2, uid0=50)
        fresh.append(eng.export_prefix(prompt))
    assert fresh[1]["root_key"] == fresh[0]["root_key"] == 1
    assert [e["key"] for e in fresh[1]["entries"]] == [e["key"] for e in fresh[0]["entries"]]
    assert pair[1].import_prefix(fresh[0]) == pair[0].import_prefix(fresh[0])


def test_lora_hot_set_dropped_on_both(trees):
    pair = engines(trees, 0, lora=True)
    st = pair[1].lora_store
    rs = np.random.RandomState(3)
    layers = {s: (rs.randn(st.num_layers, din, 2).astype(np.float32) * 0.05,
                  rs.randn(st.num_layers, 2, dout).astype(np.float32) * 0.05)
              for s, (din, dout) in st.dims.items()}
    for eng, tree in zip(pair, (trees[1][1], trees[2][1])):
        eng.register_adapter(5, layers, alpha=4.0)
        eng.bind_adapter(9, 5)
        eng.lora_store.release(9)
        assert eng.has_adapter(5)
        eng.swap_params(tree, 1)
        assert not eng.has_adapter(5) and eng.lora_store.hot_set() == []
        assert eng.knows_adapter(5)  # host payloads stay
    assert pair[1].lora_store.stats() == pair[0].lora_store.stats()


# ---------------------------------------------------------------------- the gateway's refresh
def refresh_engine(check):
    """The JAX test's ``VersionedEngine`` wearing the handoff surface,
    version-tagged, validated by ``check`` (each package its own)."""
    eng = VersionedEngine()
    eng.export_prefix = lambda prompt, max_blocks=None: record_for(prompt, eng.weight_version)

    def _imp(record):
        check(record, block_size=BS, root_key=eng.weight_version)
        return len(record["entries"])
    eng.import_prefix = _imp
    return eng


class Pair:
    """A JAX and a port gateway over their own engines, driven alike."""

    def __init__(self, jeng, teng, **cfg):
        cfg.setdefault("max_burst", 1)
        self.j = jserving.ServingGateway(jeng, config=jserving.ServingConfig(**cfg),
                                         auto_start=False)
        self.t = serving.ServingGateway(teng, config=serving.ServingConfig(**cfg),
                                        auto_start=False)

    @property
    def gws(self):
        return (self.j, self.t)

    def submit(self, *args, **kwargs):
        return tuple(gw.submit(*args, **kwargs) for gw in self.gws)

    def pump_until(self, cond, n=400):
        for _ in range(n):
            if cond(self.t):
                assert cond(self.j)
                return
            assert self.t._pump_once() == self.j._pump_once()
            self.check()
        raise AssertionError(f"condition not reached in {n} pumps")

    def check(self):
        def view(gw):
            c = gw.snapshot()["counters"]
            return ({k: c[k] for k in jserving.ServingMetrics.COUNTERS}, gw.inflight(),
                    gw.state, gw.weight_version, gw._pending_refresh is None)
        assert view(self.t) == view(self.j)


def fake_pair(**cfg):
    return Pair(refresh_engine(jsanitize.check_handoff_record),
                refresh_engine(sanitize.check_handoff_record), **cfg)


def test_staged_swap_drops_nothing_and_versions_streams():
    p = fake_pair()
    h1 = p.submit(PROMPT, max_new_tokens=4)
    p.pump_until(lambda gw: gw.inflight()["active"] == 1)
    h2 = p.submit(list(range(21, 27)), max_new_tokens=3)
    for gw in p.gws:
        assert gw.refresh_weights(params_for(1), 1, timeout=5.0) == 1
    p.check()
    assert [gw.engine.swaps for gw in p.gws] == [[1], [1]]
    for h in h1:
        assert list(h.tokens(timeout=5.0)) == VersionedEngine.stream(12, 4, 0)
    p.pump_until(lambda gw: sum(gw.inflight().values()) == 0)
    for h in h2:
        assert list(h.tokens(timeout=5.0)) == VersionedEngine.stream(6, 3, 1)
    assert p.t.metrics.snapshot()["counters"]["weight_refreshes"] == 1
    assert p.t.metrics.snapshot()["counters"]["failed"] == 0


def test_outbox_cleared_and_cross_version_import_rejected():
    p = fake_pair(role="prefill")
    hs = p.submit(PROMPT, max_new_tokens=2)
    p.pump_until(lambda gw: sum(gw.inflight().values()) == 0)
    for h in hs:
        list(h.tokens(timeout=5.0))
    assert len(p.t._handoffs) == len(p.j._handoffs) == 1
    stale = record_for(PROMPT, 0)
    assert [gw.import_handoff(stale) for gw in p.gws] == [1, 1]
    for gw, err in zip(p.gws, (jsanitize.KVTierCorruptionError,
                               sanitize.KVTierCorruptionError)):
        gw.refresh_weights(params_for(1), 1, timeout=5.0)
        assert gw._handoffs == {}
        with pytest.raises(err, match="root_key"):
            gw.import_handoff(stale)
        assert gw.import_handoff(record_for(PROMPT, 1)) == 1
    p.check()


def test_timeout_withdraws_staged_swap_nothing_adopted():
    class SlowEngine(VersionedEngine):
        def put(self, uids, chunks, sample=None):
            time.sleep(0.02)
            return super().put(uids, chunks, sample=sample)

    p = Pair(SlowEngine(), SlowEngine())
    hs = p.submit(PROMPT, max_new_tokens=30)
    p.pump_until(lambda gw: gw.inflight()["active"] == 1)
    for gw in p.gws:
        with pytest.raises(TimeoutError, match="nothing adopted"):
            gw.refresh_weights(params_for(1), 1, timeout=0.05)
        assert gw.weight_version == 0 and gw.engine.swaps == [] and gw._pending_refresh is None
    p.pump_until(lambda gw: sum(gw.inflight().values()) == 0)
    for h in hs:
        assert list(h.tokens(timeout=5.0)) == VersionedEngine.stream(12, 30, 0)
    assert [gw.refresh_weights(params_for(1), 1, timeout=5.0) for gw in p.gws] == [1, 1]


def test_mid_swap_crash_fails_replica_typed():
    p = fake_pair()

    def boom(params, version):
        raise RuntimeError("donated buffer torn mid-swap")
    hs = p.submit(PROMPT, max_new_tokens=4)
    for gw, mod in zip(p.gws, (jserving, serving)):
        gw.engine.swap_params = boom
        with pytest.raises(RuntimeError, match="mid-swap"):
            gw.refresh_weights(params_for(1), 1, timeout=5.0)
        assert gw.state == "failed"
        with pytest.raises(mod.GatewayFailedError):
            gw.submit(PROMPT, max_new_tokens=1)
    for h, mod in zip(hs, (jserving, serving)):
        with pytest.raises(mod.GatewayFailedError):
            list(h.tokens(timeout=5.0))
    p.check()


def test_refresh_rejected_off_running():
    p = fake_pair()
    for gw, mod in zip(p.gws, (jserving, serving)):
        gw.drain()
        with pytest.raises(mod.GatewayClosedError):
            gw.refresh_weights(params_for(1), 1, timeout=1.0)


def test_double_refresh_rejected():
    p = fake_pair()
    hs = p.submit(PROMPT, max_new_tokens=50)
    p.pump_until(lambda gw: gw.inflight()["active"] == 1)
    for gw in p.gws:
        gw._pending_refresh = {"params": params_for(1), "version": 1,
                               "done": threading.Event(), "error": None}
        with pytest.raises(RuntimeError, match="already in progress"):
            gw.refresh_weights(params_for(2), 2, timeout=0.5)
        gw._pending_refresh = None
    for h in hs:
        h.cancel()
    for gw in p.gws:
        gw.shutdown()


def test_real_engines_refresh_under_traffic_lockstep(trees):
    """In-flight requests finish on v0 (their v0 streams), a request queued
    behind the staged swap runs on v1 (a cold v1 engine's stream), on
    both packages; the probe's stream changes."""
    p = Pair(*engines(trees, 0), token_budget=48, max_burst=4)
    want0 = run(engines(trees, 0)[1], uid0=500)
    want1 = run(engines(trees, 1)[1], uid0=600)
    inflight = [p.submit(pr.astype(np.int32), max_new_tokens=8) for pr in PROMPTS]
    p.pump_until(lambda gw: gw.inflight()["active"] == 3)
    for gw, tree in zip(p.gws, (trees[1][1], trees[2][1])):
        # stage without blocking: the manual pump applies it below
        gw._pending_refresh = {"params": tree, "version": 1, "done": threading.Event(),
                               "error": None}
    queued = [p.submit(pr.astype(np.int32), max_new_tokens=8) for pr in PROMPTS]
    p.pump_until(lambda gw: sum(gw.inflight().values()) == 0)
    for hs, want in ((inflight, want0), (queued, want1)):
        for (jh, th), w in zip(hs, want):
            assert th.result(timeout=1) == jh.result(timeout=1) == w
    assert want0 != want1
    assert [gw.weight_version for gw in p.gws] == [1, 1]
    assert p.t.snapshot()["counters"]["weight_refreshes"] == 1
    for gw in p.gws:
        gw.drain(timeout=10)
