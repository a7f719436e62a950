"""Pipelined decode bursts (``async_burst``, ``DS_ASYNC_BURST``): the port
against the JAX package.

Both engines serve the same weights (the JAX tree through
``params_from_jax``) in fp32 on the CPU, ``DS_SEED`` 42, the pipeline at
depth 2 unless a case says otherwise:

- greedy, sampled, schema-constrained, LoRA and int8 MoE traffic: the
  port's pipelined scheduler steps in lockstep with the JAX package's
  (the same stepped uids and free blocks after every step), emits the
  same streams and counts the same host syncs, and its streams equal the
  port's synchronous engine's; the pipeline engaged (async bursts ran);
- speculative decoding under the pipeline, on traffic that drafts: the
  verify runs (``verify_steps > 0`` in both engines, the same spec
  statistics) and the streams equal the spec-off synchronous ones;
- a seeded sampled request replays bit for bit on fresh pipelined and
  synchronous engines (failover replay);
- the prefix cache's trie, built at retire from token logs that lived as
  pending device segments, matches the synchronous engine's and JAX's;
- EOS found one burst late: the drain rewinds the dispatched tail, and
  the free blocks equal the JAX engine's at every step and the pool's
  start after the run; ``max_new_tokens`` is exact, and a cancel
  mid-pipeline drains without touching the survivor's stream;
- typed errors: unfenced ``TokenLog`` reads and writes (as the JAX
  package's), a broken chain (uid order, greedy → sampled);
- ``DS_ASYNC_BURST`` wins over the config in both directions, as the JAX
  gate does;
- ``host_syncs`` equal to the JAX engine's with the pipeline off and on,
  and syncs per decoded token dropping at least 4x;
- ``_burst_layout`` equal to the JAX engine's.

Tokens are compared exactly: the logits agree within 1e-4
(``test_torch_engine_v2.py``), so a token can differ only at a near-tie,
which no case here meets."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.inference.structured import grammar as jgrammar
from deepspeed_tpu.inference.v2 import (DSStateManagerConfig as JaxSM,
                                        DynamicSplitFuseScheduler as JaxSched,
                                        InferenceEngineV2 as JaxEngine,
                                        PrefixCacheConfig as JaxPrefix,
                                        RaggedInferenceEngineConfig as JaxCfg,
                                        SpecDecodeConfig as JaxSpecCfg,
                                        StructuredConfig as JaxStructured)
from deepspeed_tpu.inference.v2.config_v2 import (AsyncBurstConfig as JaxAsync,
                                                  LoRAServingConfig as JaxLoRA)
from deepspeed_tpu.inference.v2.engine_v2 import (_burst_layout as jax_burst_layout,
                                                  async_burst_enabled as jax_async_enabled)
from deepspeed_tpu.inference.v2.ragged.sequence_descriptor import (
    TokenLog as JaxTokenLog, UnfencedTokenLogError as JaxUnfenced)
from deepspeed_tpu.models import build_llama
from deepspeed_tpu_torch.inference.structured.grammar import CompiledSchema, byte_vocab
from deepspeed_tpu_torch.inference.v2 import (AsyncBurstConfig, DSStateManagerConfig,
                                              DynamicSplitFuseScheduler, InferenceEngineV2,
                                              LoRAServingConfig, PrefixCacheConfig,
                                              RaggedInferenceEngineConfig, SpecDecodeConfig,
                                              StructuredConfig)
from deepspeed_tpu_torch.inference.v2.engine_v2 import _burst_layout, async_burst_enabled
from deepspeed_tpu_torch.inference.v2.ragged.sequence_descriptor import (TokenLog,
                                                                         UnfencedTokenLogError)
from deepspeed_tpu_torch.models import LlamaConfig, params_from_jax

torch.set_num_threads(1)  # the suite runs in parallel worker processes

BS = 8
SM = dict(max_ragged_batch_size=64, max_ragged_sequence_count=4, max_tracked_sequences=6,
          max_context=128)
EOS = 2
SCHEMA = {"type": "object",
          "properties": {"ok": {"type": "boolean"}, "mode": {"enum": ["fast", "safe"]}},
          "required": ["ok", "mode"]}
PROMPT = (np.arange(1, 17) % 250).astype(np.int32)          # 16 tokens
REPETITIVE = np.tile(np.array([7, 8, 9, 10], np.int32), 6)  # 24 tokens
ADAPTERS = {101: (1, 2, 4.0), 103: (3, 4, 8.0)}  # id: (seed, rank, alpha)
SPECS = [{"temperature": 0.9 + 0.2 * i, "top_k": 20 + 10 * i, "seed": 100 + i}
         for i in range(3)]
# sampled traffic that drafts on the debug model: near-greedy draws
DRAFTING_SPECS = [{"temperature": 0.05, "top_k": 24, "seed": 50}, {"top_k": 1, "seed": 51},
                  {"temperature": 0.05, "top_k": 24, "seed": 52}]


def _jax(preset, seed=0):
    model = build_llama(preset, remat=False)
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    return model, jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def debug():
    return _jax("debug")


def _sections(async_on, depth, spec, structured, prefix, lora, mode, sm):
    return dict(kv_block_size=BS, quantization={"quantization_mode": mode},
                async_burst=dict(enabled=async_on, depth=depth),
                spec_decode=dict(enabled=spec, draft_len=4),
                structured=dict(enabled=structured), prefix_cache=dict(enabled=prefix),
                lora=dict(enabled=lora, hot_set=4, max_rank=4, prefetch=False), sm=sm)


def _jax_engine(model, params, async_on=True, depth=2, spec=False, structured=False,
                prefix=False, lora=False, mode="none", sm=SM):
    s = _sections(async_on, depth, spec, structured, prefix, lora, mode, sm)
    return JaxEngine(model=model, config=JaxCfg(
        kv_block_size=BS, quantization=s["quantization"],
        async_burst=JaxAsync(**s["async_burst"]), spec_decode=JaxSpecCfg(**s["spec_decode"]),
        structured=JaxStructured(**s["structured"]), prefix_cache=JaxPrefix(**s["prefix_cache"]),
        lora=JaxLoRA(**s["lora"]), state_manager=JaxSM(**sm)), params=params, dtype=jnp.float32)


def _port_engine(model, params, async_on=True, depth=2, spec=False, structured=False,
                 prefix=False, lora=False, mode="none", sm=SM, port_params=None):
    s = _sections(async_on, depth, spec, structured, prefix, lora, mode, sm)
    eng = InferenceEngineV2(
        LlamaConfig(**dataclasses.asdict(model.config)),
        RaggedInferenceEngineConfig(
            kv_block_size=BS, quantization=s["quantization"],
            async_burst=AsyncBurstConfig(**s["async_burst"]),
            spec_decode=SpecDecodeConfig(**s["spec_decode"]),
            structured=StructuredConfig(**s["structured"]),
            prefix_cache=PrefixCacheConfig(**s["prefix_cache"]),
            lora=LoRAServingConfig(**s["lora"]), state_manager=DSStateManagerConfig(**sm)),
        params=port_params or params_from_jax(params), dtype=torch.float32, device="cpu")
    if lora:
        _register_adapters(eng)
    return eng


def _register_adapters(*engines):
    """The same adapters, in the same order, in every engine."""
    st = engines[-1].lora_store
    for aid, (seed, r, alpha) in ADAPTERS.items():
        rs = np.random.RandomState(seed)
        layers = {site: (rs.randn(st.num_layers, din, r).astype(np.float32) * 0.05,
                         rs.randn(st.num_layers, r, dout).astype(np.float32) * 0.05)
                  for site, (din, dout) in st.dims.items()}
        for eng in engines:
            eng.register_adapter(aid, layers, alpha=alpha)


def _add(sched, reqs, max_new, uid0=0):
    """reqs: [(prompt, sample, schema, adapter)]."""
    for i, (p, sample, schema, adapter) in enumerate(reqs):
        sched.add_request(uid0 + i, p, max_new_tokens=max_new, sample=sample, schema=schema,
                          adapter_id=adapter)


def _lockstep(jeng, teng, reqs, jreqs=None, max_new=20, eos=None, budget=48, max_burst=8,
              uid0=0):
    """The JAX and the port scheduler over the same traffic, step by step:
    the same stepped uids and free blocks after every step → streams."""
    scheds = [cls(eng, token_budget=budget, max_burst=max_burst, eos_token_id=eos)
              for cls, eng in ((JaxSched, jeng), (DynamicSplitFuseScheduler, teng))]
    _add(scheds[0], jreqs or reqs, max_new, uid0)
    _add(scheds[1], reqs, max_new, uid0)
    steps = 0
    while scheds[0].has_work or scheds[1].has_work:
        assert scheds[1].step() == scheds[0].step()
        assert teng.free_blocks == jeng.free_blocks
        steps += 1
        assert steps < 300
    got = {u: list(r.generated) for u, r in scheds[1].requests.items()}
    assert got == {u: list(r.generated) for u, r in scheds[0].requests.items()}
    return got


def _run(eng, reqs, max_new=20, eos=None, budget=48, max_burst=8, uid0=0):
    sched = DynamicSplitFuseScheduler(eng, token_budget=budget, max_burst=max_burst,
                                      eos_token_id=eos)
    _add(sched, reqs, max_new, uid0)
    return {u - uid0: toks for u, toks in sched.run_to_completion().items()}


@pytest.fixture(scope="module")
def trio(debug):
    """A pipelined JAX engine, a pipelined and a synchronous port engine,
    constrained decoding on in all three, shared by the cases that run
    plain traffic (each run flushes what it began; a request without a
    schema takes the unconstrained path)."""
    model, params = debug
    return (_jax_engine(model, params, structured=True),
            _port_engine(model, params, structured=True),
            _port_engine(model, params, async_on=False, structured=True))


def _schemas(vocab_size):
    vocab = byte_vocab(vocab_size)
    return (CompiledSchema(SCHEMA, vocab, eos_token_id=EOS),
            jgrammar.CompiledSchema(SCHEMA, vocab, eos_token_id=EOS))


def _traffic(kind, vocab_size):
    """→ (port requests, JAX requests, max_new, eos)."""
    if kind == "greedy":
        reqs = [(PROMPT + u % 5, None, None, None) for u in (1, 2, 3)]
        return reqs, reqs, 21, None
    if kind == "sampled":
        reqs = [(PROMPT + i, SPECS[i], None, None) for i in range(3)]
        return reqs, reqs, 18, None
    compiled, jcompiled = _schemas(vocab_size)
    specs = [{"temperature": 1.2, "top_k": 30, "seed": 50 + i} for i in range(3)]
    return ([(PROMPT + i, specs[i], compiled, None) for i in range(3)],
            [(PROMPT + i, specs[i], jcompiled, None) for i in range(3)], 64, EOS)


@pytest.mark.parametrize("kind", ["greedy", "sampled", "constrained"])
def test_streams_match_jax_and_sync(debug, trio, kind):
    """The pipelined port in lockstep with the pipelined JAX engine; its
    streams equal the synchronous port's. Constrained lanes end at EOS
    mid-pipeline, and the drain gives every block back."""
    model, _ = debug
    jeng, teng, sync = trio
    reqs, jreqs, max_new, eos = _traffic(kind, model.config.vocab_size)
    free0 = teng.free_blocks
    before = [(e.host_syncs, e.tokens_emitted, dict(e.bursts)) for e in (teng, sync)]
    j0 = (jeng.host_syncs, jeng.tokens_emitted)
    got = _lockstep(jeng, teng, reqs, jreqs, max_new=max_new, eos=eos, uid0=100)
    got = {u - 100: toks for u, toks in got.items()}
    assert teng.bursts["async"] > before[0][2]["async"] and teng.bursts["sync"] == 0
    assert (teng.host_syncs - before[0][0], teng.tokens_emitted - before[0][1]) == \
        (jeng.host_syncs - j0[0], jeng.tokens_emitted - j0[1])
    assert teng.syncs_per_generated_token == jeng.syncs_per_generated_token
    assert teng.free_blocks == free0
    assert _run(sync, reqs, max_new=max_new, eos=eos, uid0=200) == got
    assert sync.bursts["async"] == 0 and sync.bursts["sync"] > before[1][2]["sync"]
    if kind == "constrained":
        assert all(toks[-1] == EOS and len(toks) < max_new for toks in got.values())
    else:
        assert all(len(toks) == max_new for toks in got.values())


def test_lora_streams_match_jax_and_sync(debug):
    model, params = debug
    jeng = _jax_engine(model, params, lora=True)
    teng = _port_engine(model, params, lora=True)
    _register_adapters(jeng)
    reqs = [(PROMPT, None, None, 101), (PROMPT + 1, None, None, None),
            (PROMPT + 2, SPECS[2], None, 103)]
    got = _lockstep(jeng, teng, reqs, max_new=21)
    assert teng.bursts["async"] > 0
    assert teng.lora_store.stats() == jeng.lora_store.stats()
    assert teng.host_syncs == jeng.host_syncs
    assert _run(_port_engine(model, params, async_on=False, lora=True), reqs, 21) == got


def test_int8_moe_streams_match_jax_and_sync():
    model, params = _jax("mixtral-debug", seed=1)
    jeng = _jax_engine(model, params, mode="int8")
    carriers = params_from_jax(jeng.params)  # the JAX engine's carriers
    teng = _port_engine(model, params, mode="int8", port_params=carriers)
    vocab = model.config.vocab_size
    reqs = [(PROMPT % vocab, None, None, None), ((PROMPT + 3) % vocab, SPECS[1], None, None)]
    got = _lockstep(jeng, teng, reqs, max_new=13)
    assert teng.bursts["async"] > 0
    assert teng.host_syncs == jeng.host_syncs
    sync = _port_engine(model, params, async_on=False, mode="int8",
                        port_params=params_from_jax(jeng.params))
    assert _run(sync, reqs, 13) == got


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_spec_decode_under_pipeline_verifies_and_matches(debug, sampled):
    """Spec decoding on an async engine: verify steps run between drained
    pipelines, on traffic that drafts (the repetitive prompts; near-greedy
    draws when sampled); the statistics equal JAX's and the streams equal
    the spec-off synchronous engine's."""
    model, params = debug
    specs = DRAFTING_SPECS if sampled else [None] * 3
    reqs = [(p, s, None, None) for p, s in zip([REPETITIVE, PROMPT, REPETITIVE + 3], specs)]
    jeng = _jax_engine(model, params, spec=True)
    teng = _port_engine(model, params, spec=True)
    got = _lockstep(jeng, teng, reqs)
    assert teng.spec.stats() == jeng.spec.stats()
    assert teng.spec.stats()["verify_steps"] > 0 and teng.spec.stats()["tokens_drafted"] > 0
    assert teng.bursts["async"] > 0
    assert teng.host_syncs == jeng.host_syncs
    assert _run(_port_engine(model, params, async_on=False), reqs) == got


def test_failover_replay_reproduces_streams(debug):
    """A fresh pipelined engine and a synchronous one rebuild a seeded
    sampled stream from (seed, position) alone."""
    model, params = debug
    reqs = [(PROMPT, {"temperature": 1.3, "top_k": 40, "seed": 777}, None, None)]
    original = _run(_port_engine(model, params), reqs, 24)
    for async_on in (True, False):
        assert _run(_port_engine(model, params, async_on=async_on), reqs, 24) == original


def test_prefix_cache_token_log_from_device_segments(debug):
    """The trie is built from the token log at retire; under the pipeline
    that log lived as pending device segments. The cached prefix matches
    the synchronous engine's and JAX's."""
    model, params = debug
    reqs = [(REPETITIVE, None, None, None)]
    jeng = _jax_engine(model, params, prefix=True)
    teng = _port_engine(model, params, prefix=True)
    out = _lockstep(jeng, teng, reqs)[0]
    hist = list(REPETITIVE) + out
    sync = _port_engine(model, params, async_on=False, prefix=True)
    assert _run(sync, reqs)[0] == out
    matches = [e.prefix_match_len(hist) for e in (jeng, teng, sync)]
    assert matches[0] == matches[1] == matches[2] > 0
    assert teng.prefix_cache.cached_blocks == jeng.prefix_cache.cached_blocks == \
        sync.prefix_cache.cached_blocks > 0


def test_mid_pipeline_eos_drains_with_jax_accounting(trio):
    """Greedy EOS found one burst late: the scheduler rewinds the
    dispatched tail and flushes at the drain; the free blocks equal
    JAX's after every step and the pool's start at the end, and the
    streams stop where the synchronous engine's stop."""
    jeng, teng, sync = trio
    probe = _run(sync, [(PROMPT, None, None, None)], 21, uid0=300)[0]
    eos = probe[11]  # lands inside the second or third burst
    reqs = [(PROMPT, None, None, None), (PROMPT + 1, None, None, None)]
    free0 = teng.free_blocks
    got = _lockstep(jeng, teng, reqs, max_new=21, eos=eos)
    assert got[0] == probe[:probe.index(eos) + 1]
    assert teng.free_blocks == jeng.free_blocks == free0
    assert _run(sync, reqs, 21, eos=eos, uid0=400) == got


def test_max_new_exact_under_pipeline(trio):
    eng = trio[1]
    n0 = eng.bursts["async"]
    out = _run(eng, [(PROMPT + u, None, None, None) for u in (1, 2)], 13, uid0=500)
    assert all(len(toks) == 13 for toks in out.values())
    assert eng.bursts["async"] > n0


def test_cancel_mid_pipeline_drains_and_survivor_matches(debug):
    model, params = debug
    want = _run(_port_engine(model, params, async_on=False),
                [(PROMPT + 2, None, None, None)], 21)[0]
    eng = _port_engine(model, params)
    free0 = eng.free_blocks
    sched = DynamicSplitFuseScheduler(eng, token_budget=48, max_burst=8)
    for uid in (1, 2):
        sched.add_request(uid, PROMPT + uid, max_new_tokens=21)
    for _ in range(4):  # prefill, then fill the pipeline
        sched.step()
    assert sched._pipeline  # bursts genuinely in flight
    sched.cancel(1)         # drains; no mid-flight state is torn
    assert not sched._pipeline
    assert sched.run_to_completion()[2] == want
    assert eng.free_blocks == free0


@pytest.mark.parametrize("cls,err", [(TokenLog, UnfencedTokenLogError),
                                     (JaxTokenLog, JaxUnfenced)], ids=["port", "jax"])
def test_unfenced_token_log_reads_are_typed_errors(cls, err):
    """Every host read and write of a log with a pending device segment
    raises, in the port's copy as in the JAX package's; ``fence`` lands
    the segments in order."""
    log = cls([1, 2, 3])
    log.append_device(lambda: [4, 5])
    log.append_device(lambda: [6])
    assert log.pending
    for op in (lambda: len(log), lambda: list(log), lambda: log[0], lambda: log + [9],
               lambda: log.append(7), lambda: log.extend([7]), lambda: log.__delitem__(0)):
        with pytest.raises(err):
            op()
    assert log.fence() is log and not log.pending
    assert list(log) == [1, 2, 3, 4, 5, 6]


def test_engine_descriptor_log_fences_through_flush(debug):
    eng = _port_engine(*debug, prefix=True)
    t = int(eng.put([7], [PROMPT], sample="greedy")[0])
    handle = eng.decode_burst_async([7], [[t]], 4)
    desc = eng.state_manager.query(7)
    with pytest.raises(UnfencedTokenLogError):
        len(desc.tokens)  # a host read while the burst is in flight
    syncs = eng.host_syncs
    toks = handle.fetch()
    assert toks.shape == (4, 1) and eng.host_syncs == syncs + 1
    assert handle.fetch() is toks and eng.host_syncs == syncs + 1  # idempotent
    assert desc.tokens.pending
    handle.fence_logs()  # lands the burst's segment in every log it touched
    assert not desc.tokens.pending
    # KV content over the burst = the entry token and the first k-1 outputs
    assert list(desc.tokens)[-4:] == [t] + [int(x) for x in toks[:-1, 0]]
    eng.flush(7)  # retires the fenced log into the trie
    assert eng.prefix_cache.cached_blocks > 0


def test_chain_validation_is_typed(debug):
    eng = _port_engine(*debug)
    t1 = int(eng.put([1], [PROMPT], sample="greedy")[0])
    t2 = int(eng.put([2], [PROMPT + 1], sample="greedy")[0])
    h = eng.decode_burst_async([1, 2], [[t1], [t2]], 2)
    with pytest.raises(ValueError, match="uid order"):
        eng.decode_burst_async([2, 1], None, 2, prev=h)
    with pytest.raises(ValueError, match="greedy handle"):
        eng.decode_burst_async([1, 2], None, 2, prev=h,
                               sample=[{"temperature": 1.0, "seed": 3}] * 2)
    h2 = eng.decode_burst_async([1, 2], None, 2, prev=h)  # a valid chain
    assert h2.fetch().shape == (2, 2)
    # the chained entries are the first burst's last outputs
    np.testing.assert_array_equal(h2.entry_values(), h.fetch()[-1])
    for uid in (1, 2):
        eng.flush(uid)


def test_chained_bursts_equal_one_sync_burst(debug):
    """Two chained async bursts of 4 emit the tokens one synchronous burst
    of 8 emits, greedy and sampled, with the same KV positions written."""
    model, params = debug
    spec = {"temperature": 1.1, "top_k": 30, "seed": 9}
    for sample in (None, [spec]):
        engines = [_port_engine(model, params, async_on=a) for a in (False, True)]
        ts = [int(e.put([5], [PROMPT], sample=sample or "greedy")[0]) for e in engines]
        want = engines[0].decode_burst([5], [[ts[0]]], 8, sample=sample)
        h = engines[1].decode_burst_async([5], [[ts[1]]], 4, sample=sample)
        h2 = engines[1].decode_burst_async([5], None, 4, sample=sample, prev=h)
        got = np.concatenate([h.fetch(), h2.fetch()])
        np.testing.assert_array_equal(got, want)
        assert engines[1].query(5) == engines[0].query(5)
        # a put's 2, then 1 entry + 1 fetch against 2 fetches
        assert engines[1].host_syncs == engines[0].host_syncs == 4
        assert engines[1].tokens_emitted == engines[0].tokens_emitted == 9


def test_kill_switch_wins_both_ways(debug, monkeypatch):
    model, params = debug
    monkeypatch.setenv("DS_ASYNC_BURST", "0")
    eng = _port_engine(model, params, async_on=True)  # the config says on
    assert not eng.async_burst
    _run(eng, [(PROMPT, None, None, None)], 12)
    assert eng.bursts["async"] == 0 and eng.bursts["sync"] > 0
    monkeypatch.setenv("DS_ASYNC_BURST", "1")
    eng = _port_engine(model, params, async_on=False)  # the config says off
    assert eng.async_burst
    _run(eng, [(PROMPT, None, None, None)], 12)
    assert eng.bursts["async"] > 0 and eng.bursts["sync"] == 0
    for raw in ("0", "off", "false", " No ", "", "1", "on", "yes", "junk", None):
        if raw is None:
            monkeypatch.delenv("DS_ASYNC_BURST")
        else:
            monkeypatch.setenv("DS_ASYNC_BURST", raw)
        for enabled in (False, True):
            assert async_burst_enabled(AsyncBurstConfig(enabled=enabled)) == \
                jax_async_enabled(JaxAsync(enabled=enabled)), (raw, enabled)


def test_host_syncs_match_jax_both_states_and_drop_4x(debug):
    """The synchronous burst path pays n + 1 host syncs a k-step burst (n
    entry tokens and the fetch), the pipeline one: 6 sequences, bursts of
    8. Prefill syncs alike on both paths, so the drop is measured over
    the decode phase. Each state's counts equal the JAX engine's."""
    model, params = debug
    sm = dict(SM, max_ragged_sequence_count=8, max_tracked_sequences=8)
    ratios, counts = {}, {}
    for async_on in (False, True):
        for make in (_jax_engine, _port_engine):
            eng = make(model, params, async_on=async_on, sm=sm)
            sched = (JaxSched if make is _jax_engine else DynamicSplitFuseScheduler)(
                eng, token_budget=48, max_burst=8)
            for u in range(1, 7):
                sched.add_request(u, PROMPT + u % 5, max_new_tokens=33)
            while any(r.next_token is None for r in sched.requests.values()):
                sched.step()  # prefill and the first tokens, through put()
            syncs0, toks0 = eng.host_syncs, eng.tokens_emitted
            sched.run_to_completion()
            decoded = eng.tokens_emitted - toks0
            assert decoded >= 6 * 28
            counts[make, async_on] = (eng.host_syncs, eng.tokens_emitted, decoded)
            ratios[make, async_on] = (eng.host_syncs - syncs0) / decoded
        assert counts[_port_engine, async_on] == counts[_jax_engine, async_on]
    assert ratios[_port_engine, False] / ratios[_port_engine, True] >= 4.0


@pytest.mark.parametrize("lora", [False, True])
@pytest.mark.parametrize("sampled", [False, True])
@pytest.mark.parametrize("async_entry", [False, True])
def test_burst_layout_matches_jax(lora, sampled, async_entry):
    for ms, mb in ((4, 16), (8, 3)):
        assert _burst_layout(ms, mb, lora=lora, sampled=sampled, async_entry=async_entry) == \
            jax_burst_layout(ms, mb, lora=lora, sampled=sampled, async_entry=async_entry)
