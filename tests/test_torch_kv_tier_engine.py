"""The engine with the prefix cache, the KV spill tier and suspend/resume:
the port vs the JAX package.

Both engines serve the ``debug`` preset in fp32 on the CPU from the same
weights (the JAX tree through ``params_from_jax``).

- ``bench.py:bench_serving_2b_kv_tier``'s three-phase trace, scaled to the
  debug model with the bench's proportions (4 requests a phase, a 16-block
  system prompt + 1 block of suffix, block 4, 8 new tokens, budget prompt +
  4, bursts of 16, ``num_kv_blocks`` = 4 x 19 + 5 as the bench sizes it):
  fleet A shares the system prompt and retires into the trie, fleet B
  (disjoint prompts) overflows the pool and evicts A's chain, fleet A'
  (new suffixes) returns. It runs with the tier off, in the pool dtype and
  int8, prefetch off (so the tier's counters do not depend on the worker's
  timing). In every mode the greedy streams, each request's
  ``prefix_cached_tokens``, the tier's and the prefix cache's stats equal
  the JAX engine's, and the logits of one more request over the promoted
  prefix agree within 1e-5 relative to their max-abs (the two frameworks'
  fp32 matmuls sum in other orders). Unquantized tier-on streams equal
  tier-off streams, and the tier saves at least twice the A'-phase prefill
  tokens of the tier-off run (as the bench asserts on the TPU). With
  prefetch on, the streams are the same and the promotion takes staged
  copies.
- Suspend mid-decode → resume continues the uninterrupted stream and
  equals the JAX engine's, with a shared prefix in the suspended table; so
  do the scheduler's ``pause``/``unpause``; ``flush`` of a suspended
  sequence returns every block.
- ``export_prefix``/``import_prefix`` between two port engines continue the
  exporter's stream with the prefill skipped past the imported span.
- A tier without a prefix cache warns and is skipped.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.inference.v2 import (DSStateManagerConfig as JaxSM,
                                        DynamicSplitFuseScheduler as JaxSched,
                                        InferenceEngineV2 as JaxEngine, KVTierConfig as JaxTierCfg,
                                        PrefixCacheConfig as JaxPrefixCfg,
                                        RaggedInferenceEngineConfig as JaxCfg)
from deepspeed_tpu.models import build_llama
from deepspeed_tpu_torch.inference.v2 import (DSStateManagerConfig, DynamicSplitFuseScheduler,
                                              InferenceEngineV2, KVTierConfig, PrefixCacheConfig,
                                              RaggedInferenceEngineConfig)
from deepspeed_tpu_torch.inference.v2 import engine_v2 as port_engine_module
from deepspeed_tpu_torch.models import LlamaConfig, params_from_jax

BS, N_REQ, SYS, SFX, NEW, BURST = 4, 4, 64, 4, 8, 16
PROMPT = SYS + SFX
BUDGET = PROMPT + N_REQ
PER_SEQ = -(-(PROMPT + NEW) // BS)
NUM_KV_BLOCKS = N_REQ * PER_SEQ + 1 + 4  # bench.py's sizing: B must evict A's chain
MODES = {"off": None, "on": dict(quantize=False), "int8": dict(quantize=True)}


@pytest.fixture(scope="module")
def weights():
    model = build_llama("debug", remat=False)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    params = jax.tree.map(np.asarray, params)
    return model, params, params_from_jax(params)


def _engines(weights, mode, prefetch=False, num_kv_blocks=NUM_KV_BLOCKS, prefix=True,
             max_seqs=N_REQ, budget=BUDGET, max_context=PROMPT + NEW):
    model, jparams, tparams = weights
    tier = MODES[mode]
    sm = dict(max_ragged_batch_size=budget, max_ragged_sequence_count=max_seqs,
              max_tracked_sequences=max_seqs, max_context=max_context)
    tier_kw = dict(enabled=tier is not None, host_bytes=1 << 32, prefetch=prefetch,
                   **(tier or {}))
    jeng = JaxEngine(model=model, config=JaxCfg(
        kv_block_size=BS, num_kv_blocks=num_kv_blocks, prefix_cache=JaxPrefixCfg(enabled=prefix),
        kv_tier=JaxTierCfg(**tier_kw), state_manager=JaxSM(**sm)),
        params=jparams, dtype=jnp.float32)
    teng = InferenceEngineV2(LlamaConfig(**dataclasses.asdict(model.config)),
                             RaggedInferenceEngineConfig(
                                 kv_block_size=BS, num_kv_blocks=num_kv_blocks,
                                 prefix_cache=PrefixCacheConfig(enabled=prefix),
                                 kv_tier=KVTierConfig(**tier_kw),
                                 state_manager=DSStateManagerConfig(**sm)),
                             params=tparams, dtype=torch.float32, device="cpu")
    return jeng, teng


def _traffic(vocab):
    rng = np.random.RandomState(0)
    system = rng.randint(0, vocab, size=SYS).astype(np.int32)
    suffixes = [rng.randint(0, vocab, size=SFX).astype(np.int32) for _ in range(2 * N_REQ)]
    disjoint = [rng.randint(0, vocab, size=PROMPT).astype(np.int32) for _ in range(N_REQ)]
    phase_a = [np.concatenate([system, s]) for s in suffixes[:N_REQ]]
    phase_back = [np.concatenate([system, s]) for s in suffixes[N_REQ:]]
    return system, phase_a, disjoint, phase_back


def _fleet(engine, sched_cls, uid0, prompts):
    sched = sched_cls(engine, token_budget=BUDGET, max_burst=BURST)
    for i, p in enumerate(prompts):
        sched.add_request(uid0 + i, p, max_new_tokens=NEW)
    out = sched.run_to_completion(max_steps=10_000)
    cached = [sched.requests[uid0 + i].prefix_cached_tokens for i in range(len(prompts))]
    return [out[uid0 + i] for i in range(len(prompts))], cached


def _run_trace(engine, sched_cls, vocab):
    system, phase_a, disjoint, phase_back = _traffic(vocab)
    out_a, _ = _fleet(engine, sched_cls, 0, phase_a)
    out_b, _ = _fleet(engine, sched_cls, 100, disjoint)
    out_back, cached = _fleet(engine, sched_cls, 200, phase_back)
    # one more request over the (promoted) system prompt: its prefill logits
    probe = np.concatenate([system, np.arange(1, 1 + SFX, dtype=np.int32)])
    got = engine.prefix_match(300, probe)
    logits = np.asarray(engine.put([300], [probe[got:]]))
    engine.flush(300)
    return {"streams": out_a + out_b + out_back, "cached": cached, "probe_cached": got,
            "logits": logits}


def _stats(engine):
    tier = dict(engine.kv_tier.stats()) if engine.kv_tier is not None else {}
    tier.pop("prefetch_wait_ms", None)
    return tier, dict(engine.prefix_cache.stats())


@pytest.fixture(scope="module")
def traces(weights):
    out = {}
    for mode in MODES:
        jeng, teng = _engines(weights, mode)
        vocab = teng.model_config.vocab_size
        out[mode] = {"jax": (_run_trace(jeng, JaxSched, vocab), _stats(jeng)),
                     "port": (_run_trace(teng, DynamicSplitFuseScheduler, vocab), _stats(teng)),
                     "free": (jeng.free_blocks + jeng.evictable_blocks,
                              teng.free_blocks + teng.evictable_blocks)}
        jeng.destroy()
        teng.destroy()
    return out


@pytest.mark.parametrize("mode", sorted(MODES))
def test_three_phase_trace_equals_jax(traces, mode):
    (tj, (tier_j, pc_j)), (tt, (tier_t, pc_t)) = traces[mode]["jax"], traces[mode]["port"]
    assert tt["streams"] == tj["streams"]
    assert all(len(s) == NEW for s in tt["streams"])
    assert tt["cached"] == tj["cached"] and tt["probe_cached"] == tj["probe_cached"]
    # the int8 tier's measured error is taken on each engine's own KV, which
    # the two frameworks' fp32 matmuls give ~1e-7 apart: 1e-4 relative
    qt, qj = tier_t.pop("quant_error_max", 0), tier_j.pop("quant_error_max", 0)
    assert abs(qt - qj) <= 1e-4 * qj
    assert tier_t == tier_j and pc_t == pc_j
    scale = np.abs(tj["logits"]).max()
    assert np.abs(tt["logits"] - tj["logits"]).max() <= 1e-5 * scale
    free_j, free_t = traces[mode]["free"]
    assert free_t == free_j == NUM_KV_BLOCKS - 1  # nothing leaked
    if mode != "off":
        assert tier_t["demoted_blocks"] > 0 and tier_t["promoted_blocks"] > 0
        assert pc_t["tier2_hits"] > 0
    if mode == "int8":
        assert tier_t["quantized"] == 1 and qt > 0


def test_tier_saves_prefill_and_keeps_streams(traces):
    off, on = traces["off"]["port"][0], traces["on"]["port"][0]
    assert on["streams"] == off["streams"]  # restored KV is the evicted KV
    assert sum(on["cached"]) >= 2 * sum(off["cached"]) > 0
    assert on["probe_cached"] == SYS


def test_prefetch_on_serves_the_same_streams_from_staged_copies(weights, traces):
    _, teng = _engines(weights, "on", prefetch=True)
    got = _run_trace(teng, DynamicSplitFuseScheduler, teng.model_config.vocab_size)
    assert got["streams"] == traces["on"]["port"][0]["streams"]
    assert got["cached"] == traces["on"]["port"][0]["cached"]
    s = teng.kv_tier.stats()
    assert s["prefetched_blocks"] > 0 and s["stage_hits"] > 0 and s["prefetch_timeouts"] == 0
    teng.destroy()
    assert teng.kv_tier is None


def _greedy(engine, uid, tokens, n):
    out = [int(engine.put([uid], [tokens], sample="greedy")[0])]
    for _ in range(n - 1):
        out.append(int(engine.put([uid], [[out[-1]]], sample="greedy")[0]))
    return out


@pytest.mark.parametrize("mode", ["off", "int8"])
def test_suspend_resume_mid_decode_equals_uninterrupted_and_jax(weights, mode):
    rng = np.random.RandomState(3)
    shared = rng.randint(0, 256, size=12).astype(np.int32)
    first = np.concatenate([shared, rng.randint(0, 256, size=5).astype(np.int32)])
    second = np.concatenate([shared, rng.randint(0, 256, size=3).astype(np.int32)])
    streams = {}
    for side, eng in zip(("jax", "port"), _engines(weights, mode, num_kv_blocks=24,
                                                   budget=32, max_context=64)):
        ref = _greedy(eng, 1, first, 6)
        eng.flush(1)                                  # retires `first` into the trie
        cached = eng.prefix_match(2, second)          # shares 3 blocks with the trie
        assert cached == 12
        out = _greedy(eng, 2, second[cached:], 3)
        eng.suspend(2)
        assert eng.is_suspended(2) and eng.query(2) is None
        assert eng.suspended_blocks(2) == -(-(len(second) + 2) // BS)
        other = _greedy(eng, 3, first, 2)             # reuses the freed blocks
        eng.flush(3)
        assert eng.resume(2) == len(second) + 2
        for _ in range(3):
            out.append(int(eng.put([2], [[out[-1]]], sample="greedy")[0]))
        eng.flush(2)
        # the uninterrupted stream of the same request
        cached = eng.prefix_match(4, second)
        plain = _greedy(eng, 4, second[cached:], 6)
        eng.flush(4)
        eng.prefix_match(5, first)
        eng.suspend(5)                                # flush of a suspended sequence
        eng.flush(5)
        assert not eng.is_suspended(5)
        assert eng.free_blocks + eng.evictable_blocks == 23
        streams[side] = (ref, out, other, plain)
        eng.destroy()
    assert streams["port"] == streams["jax"]
    _, out, _, plain = streams["port"]
    assert out == plain


def test_scheduler_pause_unpause_equals_jax(weights):
    rng = np.random.RandomState(4)
    prompts = [rng.randint(0, 256, size=n).astype(np.int32) for n in (9, 14, 6)]
    result = {}
    for side, eng, sched_cls in zip(("jax", "port"), _engines(weights, "on", budget=32,
                                                              num_kv_blocks=24, max_context=64),
                                    (JaxSched, DynamicSplitFuseScheduler)):
        sched = sched_cls(eng, token_budget=32, max_burst=1)
        for i, p in enumerate(prompts):
            sched.add_request(i, p, max_new_tokens=8)
        for _ in range(3):
            sched.step()
        assert sched.pause(1) is True and eng.is_suspended(1)
        for _ in range(4):
            sched.step()
        sched.unpause(1)
        result[side] = sched.run_to_completion()
        assert eng.free_blocks + eng.evictable_blocks == 23
        eng.destroy()
    assert result["port"] == result["jax"]
    solo = {}
    _, eng = _engines(weights, "off", budget=32, num_kv_blocks=24, max_context=64)
    sched = DynamicSplitFuseScheduler(eng, token_budget=32, max_burst=1)
    for i, p in enumerate(prompts):
        sched.add_request(i, p, max_new_tokens=8)
    solo = sched.run_to_completion()
    assert result["port"] == solo  # pausing changed nothing but the timing
    eng.destroy()


def test_export_import_prefix_between_port_engines(weights):
    _, a = _engines(weights, "on", max_context=64, budget=32)
    _, b = _engines(weights, "on", max_context=64, budget=32)
    prompt = np.arange(3, 3 + 21, dtype=np.int32)
    want = _greedy(a, 1, prompt, 4)
    a.flush(1)
    record = a.export_prefix(prompt)
    assert len(record["entries"]) == (len(prompt) - 1) // BS == 5
    assert b.import_prefix(record) == 5 and b.prefix_match_len(prompt) == 20
    cached = b.prefix_match(7, prompt)
    assert cached == 20
    assert _greedy(b, 7, prompt[cached:], 4) == want  # prefill skipped the span
    assert b.kv_tier.stats()["imported_blocks"] == 5
    a.destroy()
    b.destroy()


def test_tier_without_prefix_cache_warns_and_is_skipped(weights, monkeypatch):
    said = []
    monkeypatch.setattr(port_engine_module.logger, "warning", said.append)
    _, eng = _engines(weights, "on", prefix=False)
    assert eng.kv_tier is None and eng.prefix_cache is None
    assert any("prefix cache is off" in m for m in said)
    assert eng.prefix_match(1, [1, 2, 3]) == 0 and eng.export_prefix([1, 2, 3]) is None
    eng.destroy()
