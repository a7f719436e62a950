"""Self-speculative decoding on the ragged engine: the port against the JAX package.

Both engines serve the same weights (the JAX tree through
``params_from_jax``) in fp32 on the CPU, ``DS_SEED`` 42:

- the n-gram drafter's cases, the accept-rate EMA (auto-disable, forget,
  draft-free rows) and the ``DS_SPEC_DECODE`` / ``DS_SPEC_DRAFT_LEN``
  switches in both directions give what the JAX package's give;
- ``verify_burst`` with forced drafts (all correct, one wrong, all
  wrong; greedy and sampled; LoRA on): the same tokens, accept counts,
  host syncs, token logs, block ids and free blocks, and a packed verify
  vector byte-equal to the one the JAX engine hands its program;
- a sampled verify over drafts taken from a spec-off sampled stream
  accepts them all, stops at an altered one, and emits that stream;
- ``rewind`` and ``release_unused_blocks`` leave the same state;
- schedulers in lockstep with spec on, greedy and sampled (traffic that
  drafts: ``tokens_drafted > 0`` asserted in both engines), dense
  (debug, gqa_d128), LoRA on and int8 MoE: the same stepped uids and
  free blocks every step, the same streams, spec statistics and host
  syncs, and streams equal to the spec-off run's;
- EOS among an accepted run, ``max_new_tokens`` exact, the prefix
  cache's token log after partial accepts, the validation shared with
  ``can_burst``, and a disabled engine's refusals, as the JAX engine's.

Tokens are compared exactly: the logits agree within 1e-4
(``test_torch_engine_v2.py``), so a token can differ only at a near-tie,
which no case here meets."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.inference.v2 import (DSStateManagerConfig as JaxSM,
                                        DynamicSplitFuseScheduler as JaxSched,
                                        InferenceEngineV2 as JaxEngine,
                                        PrefixCacheConfig as JaxPrefix,
                                        RaggedInferenceEngineConfig as JaxCfg,
                                        SpecDecodeConfig as JaxSpecCfg)
from deepspeed_tpu.inference.v2.config_v2 import LoRAServingConfig as JaxLoRA
from deepspeed_tpu.inference.v2.spec import (NGramDrafter as JaxDrafter,
                                             SpecDecodeState as JaxSpecState,
                                             spec_decode_enabled as jax_spec_enabled)
from deepspeed_tpu.models import build_llama
from deepspeed_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from deepspeed_tpu_torch.inference.v2 import (DSStateManagerConfig, DynamicSplitFuseScheduler,
                                              InferenceEngineV2, LoRAServingConfig,
                                              PrefixCacheConfig, RaggedInferenceEngineConfig,
                                              SpecDecodeConfig)
from deepspeed_tpu_torch.inference.v2.engine_v2 import _verify_layout
from deepspeed_tpu_torch.inference.v2.spec import (NGramDrafter, SpecDecodeState,
                                                   spec_decode_enabled)
from deepspeed_tpu_torch.models import LlamaConfig, params_from_jax

BS = 8
SM = dict(max_ragged_batch_size=64, max_ragged_sequence_count=4, max_tracked_sequences=6,
          max_context=128)
GQA = JaxLlamaConfig(vocab_size=128, hidden_size=512, intermediate_size=256,
                     num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                     max_position_embeddings=128)
PROMPT = (np.arange(1, 17) % 250).astype(np.int32)          # 16 tokens
REPETITIVE = np.tile(np.array([7, 8, 9, 10], np.int32), 6)  # 24 tokens
ADAPTERS = {101: (1, 2, 4.0), 103: (3, 4, 8.0)}  # id: (seed, rank, alpha)
# sampled traffic that drafts on the debug model: near-greedy draws
SPECS = [{"temperature": 0.05, "top_k": 24, "seed": 50}, {"top_k": 1, "seed": 51},
         {"temperature": 0.05, "top_k": 24, "seed": 52}]


def _jax(preset, seed=0):
    model = build_llama(preset, remat=False)
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    return model, jax.tree.map(np.asarray, params)


def _port_engine(model, params, spec=True, prefix=False, lora=False, mode="none", sm=SM,
                 port_params=None, **spec_kw):
    """The port's engine over the JAX tree's weights."""
    return InferenceEngineV2(LlamaConfig(**dataclasses.asdict(model.config)),
                             RaggedInferenceEngineConfig(
                                 kv_block_size=BS, quantization={"quantization_mode": mode},
                                 state_manager=DSStateManagerConfig(**sm),
                                 spec_decode=SpecDecodeConfig(enabled=spec, draft_len=4,
                                                              **spec_kw),
                                 prefix_cache=PrefixCacheConfig(enabled=prefix),
                                 lora=LoRAServingConfig(enabled=lora, hot_set=4, max_rank=4,
                                                        prefetch=False)),
                             params=port_params or params_from_jax(params),
                             dtype=torch.float32, device="cpu")


def _register_adapters(engines):
    """The same adapters, in the same order, in every engine."""
    st = engines[-1].lora_store
    for aid, (seed, r, alpha) in ADAPTERS.items():
        rs = np.random.RandomState(seed)
        layers = {site: (rs.randn(st.num_layers, din, r).astype(np.float32) * 0.05,
                         rs.randn(st.num_layers, r, dout).astype(np.float32) * 0.05)
                  for site, (din, dout) in st.dims.items()}
        for eng in engines:
            eng.register_adapter(aid, layers, alpha=alpha)


def _engines(model, params, spec=True, prefix=False, lora=False, mode="none", sm=SM,
             port_params=None, **spec_kw):
    """A JAX and a port engine over the same weights (adapters registered
    in both when LoRA is on)."""
    jeng = JaxEngine(model=model, config=JaxCfg(
        kv_block_size=BS, quantization={"quantization_mode": mode}, state_manager=JaxSM(**sm),
        spec_decode=JaxSpecCfg(enabled=spec, draft_len=4, **spec_kw),
        prefix_cache=JaxPrefix(enabled=prefix),
        lora=JaxLoRA(enabled=lora, hot_set=4, max_rank=4, prefetch=False)),
        params=params, dtype=jnp.float32)
    teng = _port_engine(model, params, spec, prefix, lora, mode, sm, port_params, **spec_kw)
    if lora:
        _register_adapters([jeng, teng])
    return jeng, teng


@pytest.fixture(scope="module")
def debug():
    return _jax("debug")


@pytest.fixture(scope="module")
def pair(debug):
    """One spec-on engine pair over the debug weights, shared (every
    sequence is flushed when its test ends)."""
    return _engines(*debug)


def _greedy_rollout(eng, uid, prompt, n):
    t = int(eng.put([uid], [prompt], sample="greedy")[0])
    out = [t]
    for _ in range(n - 1):
        t = int(eng.put([uid], [[t]], sample="greedy")[0])
        out.append(t)
    return out


def _state(eng, uid):
    desc = eng.state_manager.query(uid)
    return desc.seen_tokens, list(desc.blocks), list(desc.tokens), eng.free_blocks


# -------------------------------------------------------------------- drafter
DRAFTER_CASES = [
    (3, [5, 1, 2, 3, 9, 1, 2, 3, 7, 1, 2, 3], 2),   # most recent longest match wins
    (3, [1, 2, 42, 9, 9, 42], 3),                    # falls back to the 1-gram
    (3, [1, 2, 3, 4], 4), (3, [1], 4), (3, [1, 1, 1], 0),  # no match, too short, no budget
    (2, [1, 2, 3, 1, 2], 8),                         # truncated at the history's end
]


@pytest.mark.parametrize("case", range(len(DRAFTER_CASES)))
def test_drafter_matches_jax(case):
    n, hist, cap = DRAFTER_CASES[case]
    got = NGramDrafter(max_ngram=n).propose(hist, cap)
    assert got == JaxDrafter(max_ngram=n).propose(hist, cap)
    assert got == [[7, 1], [9, 9, 42], [], [], [], [3, 1, 2]][case]
    with pytest.raises(ValueError):
        NGramDrafter(max_ngram=0)


def test_drafter_random_histories_match_jax():
    rs = np.random.RandomState(0)
    for _ in range(200):
        hist = rs.randint(0, 6, size=rs.randint(0, 30)).tolist()
        n, cap = rs.randint(1, 5), rs.randint(0, 6)
        assert NGramDrafter(max_ngram=n).propose(hist, cap) == \
            JaxDrafter(max_ngram=n).propose(hist, cap)


# ----------------------------------------------------------- state, switches
NOTES = {"disable": [(1, 0, 4)] * 3, "good": [(1, 3, 4)] * 20, "draft_free": [(1, 0, 0)] * 10,
         "mixed": [(1, 4, 4), (2, 0, 4), (1, 1, 4), (2, 0, 4), (2, 3, 4), (1, 0, 2)]}


@pytest.mark.parametrize("name", sorted(NOTES))
def test_spec_state_matches_jax(name):
    """The EMA auto-disable and its counters, then ``forget``."""
    states = [cls(cfg(enabled=True, draft_len=4, warmup_steps=3, disable_below=0.25))
              for cls, cfg in ((JaxSpecState, JaxSpecCfg), (SpecDecodeState, SpecDecodeConfig))]
    for uid, acc, drafted in NOTES[name]:
        for st in states:
            st.note(uid, accepted=acc, drafted=drafted)
        assert states[1].draft_len(uid) == states[0].draft_len(uid)
    assert states[1].stats() == states[0].stats()
    if name == "disable":
        assert states[1].draft_len(1) == 0 and states[1].draft_len(2) == 4
        for st in states:
            st.forget(1)
        assert states[1].draft_len(1) == states[0].draft_len(1) == 4
    if name == "good":
        assert states[1].stats()["accepted_per_step"] == 4.0


@pytest.mark.parametrize("env,config_on", [(None, True), (None, False), ("0", True),
                                           ("1", False), ("off", True), ("yes", False),
                                           ("", True)])
def test_spec_switch_matches_jax(monkeypatch, env, config_on):
    if env is None:
        monkeypatch.delenv("DS_SPEC_DECODE", raising=False)
    else:
        monkeypatch.setenv("DS_SPEC_DECODE", env)
    want = jax_spec_enabled(JaxSpecCfg(enabled=config_on))
    assert spec_decode_enabled(SpecDecodeConfig(enabled=config_on)) == want
    assert want == (config_on if env is None else env not in ("0", "off", ""))


@pytest.mark.parametrize("env,want", [(None, 4), ("7", 7), ("0", 4), ("junk", 4)])
def test_draft_len_switch_matches_jax(monkeypatch, env, want):
    if env is None:
        monkeypatch.delenv("DS_SPEC_DRAFT_LEN", raising=False)
    else:
        monkeypatch.setenv("DS_SPEC_DRAFT_LEN", env)
    port = SpecDecodeState(SpecDecodeConfig(enabled=True, draft_len=4))
    ref = JaxSpecState(JaxSpecCfg(enabled=True, draft_len=4))
    assert port.draft_len(1) == ref.draft_len(1) == want


def test_env_switch_builds_or_drops_the_spec_state(debug, monkeypatch):
    monkeypatch.setenv("DS_SPEC_DECODE", "0")
    jeng, teng = _engines(*debug)  # the config says enabled
    assert teng.spec is None and jeng.spec is None
    assert teng.propose_drafts([1], [[5]]) == [[]]
    teng.put([1], [PROMPT], sample="greedy")
    with pytest.raises(RuntimeError, match="disabled"):
        teng.verify_burst([1], [[1]], [[2]])
    monkeypatch.setenv("DS_SPEC_DECODE", "1")
    jeng, teng = _engines(*debug, spec=False)
    assert teng.spec is not None and jeng.spec is not None


# --------------------------------------------------------------- verify burst
def _capture_jax_verify(jeng):
    """Record the metadata vector the JAX engine hands its verify programs."""
    seen = []
    get = jeng._get_burst_fn

    def get_burst(key, make):
        fn = get(key, make)
        if key[0] != "verify":
            return fn

        def call(*args):
            seen.append(np.array(args[3]))
            return fn(*args)
        return call
    jeng._get_burst_fn = get_burst
    return seen


def _capture_port(teng):
    seen = []
    upload = teng._upload

    def recorded(arrays):
        seen.append(np.array(arrays))
        return upload(arrays)
    teng._upload = recorded
    return seen


def _drafts(kind, ref):
    """Drafts for the entry ``ref[0]`` given the greedy continuation ``ref``."""
    return {"correct": [ref[1:4]], "partial": [[ref[1], ref[2], (ref[3] + 1) % 250]],
            "none": [[(ref[1] + 1) % 250] + [3] * 6]}[kind]


@pytest.mark.parametrize("kind,want_acc", [("correct", 3), ("partial", 2), ("none", 0)])
def test_forced_verify_matches_jax(pair, kind, want_acc):
    jeng, teng = pair
    ref = _greedy_rollout(teng, 1, PROMPT, 9)
    assert ref == _greedy_rollout(jeng, 1, PROMPT, 9)
    for eng in pair:
        eng.flush(1)
    jmeta, tmeta = _capture_jax_verify(jeng), _capture_port(teng)
    free0 = teng.free_blocks
    outs = []
    for eng in pair:
        t0 = int(eng.put([2], [PROMPT], sample="greedy")[0])
        syncs, emitted = eng.host_syncs, eng.tokens_emitted
        toks, acc = eng.verify_burst([2], [[t0]], _drafts(kind, ref))
        outs.append((np.asarray(toks), np.asarray(acc), eng.host_syncs - syncs, _state(eng, 2),
                     eng.tokens_emitted - emitted, eng.spec.stats()))
    for want, got in zip(*outs):
        if isinstance(want, np.ndarray):
            np.testing.assert_array_equal(got, want)
        else:
            assert got == want
    toks, acc = outs[1][:2]
    assert acc[0] == want_acc and list(toks[0, :want_acc + 1]) == ref[1:want_acc + 2]
    assert toks.dtype == np.int32 and acc.dtype == np.int64
    seen, blocks = outs[1][3][0], outs[1][3][1]
    assert seen == len(PROMPT) + 1 + want_acc
    assert len(blocks) == -(-seen // BS)  # the unaccepted tail's blocks went back
    assert outs[1][2] == 3  # the entry token, and the tokens with the accept counts
    # the packed verify vector, byte for byte
    assert len(jmeta) == 1
    got = tmeta[-1]
    assert got.dtype == np.int32 and got.tobytes() == np.asarray(jmeta[0], np.int32).tobytes()
    d = len(_drafts(kind, ref)[0])
    assert got.shape[0] == _verify_layout(4, teng.max_blocks_per_seq, d)["tables"][1]
    # continuing after the verify gives the uninterrupted stream
    t = int(toks[0, want_acc])
    for eng in pair:  # both, so the engines' block histories stay equal
        cont = [t] + [int(x) for x in eng.decode_burst([2], [[t]], 3)[:, 0]]
        assert cont == ref[want_acc + 1:want_acc + 5]
    for eng in pair:
        eng.flush(2)
    assert teng.free_blocks == jeng.free_blocks == free0


def test_forced_verify_two_rows_and_pad_rows_match_jax(debug):
    """Two sequences of different draft counts (one draft-free) and two
    pad rows in one verify; then the same sequences' blocks after a
    ``rewind`` and a ``release_unused_blocks``."""
    pair = _engines(*debug)
    for eng in pair:
        ref = {u: _greedy_rollout(eng, u, p, 6) for u, p in ((1, PROMPT), (2, REPETITIVE))}
        eng.flush(1)
        eng.flush(2)
    outs = []
    for eng in pair:
        first = eng.put([1, 2], [PROMPT, REPETITIVE], sample="greedy")
        toks, acc = eng.verify_burst([1, 2], [[first[0]], [first[1]]],
                                     [ref[1][1:5], []])
        after = [_state(eng, u) for u in (1, 2)]
        eng.rewind(1, 2)
        desc = eng.state_manager.query(2)
        eng.state_manager.allocate_for(desc, 3 * BS)
        eng.state_manager.release_unused_blocks(desc)
        outs.append((toks, acc, after, [_state(eng, u) for u in (1, 2)], eng.free_blocks))
        eng.flush(1)
        eng.flush(2)
    assert outs[1][0].tolist() == outs[0][0].tolist()
    assert outs[1][1].tolist() == outs[0][1].tolist() == [4, 0]
    assert outs[1][2:] == outs[0][2:]
    assert outs[1][0][1, 0] == ref[2][1]  # the draft-free row's own next token


@pytest.mark.parametrize("lora", [False, True])
def test_sampled_verify_emits_the_spec_off_stream(debug, lora):
    """Drafts taken from a spec-off sampled stream: all accepted, an
    altered one at j stops the run at j, and every emitted token equals
    the stream; the sampled verify vector is byte-equal to JAX's."""
    jeng, teng = _engines(*debug, lora=lora)
    spec = {"temperature": 1.1, "top_k": 24, "seed": 77}
    for eng in (jeng, teng):
        if lora:
            eng.bind_adapter(1, 101)
            eng.bind_adapter(2, 103)
    stream = [int(teng.put([1], [REPETITIVE], sample=spec)[0])]
    stream += [int(t) for t in teng.decode_burst([1], [[stream[0]]], 8, sample=spec)[:, 0]]
    jstream = [int(jeng.put([1], [REPETITIVE], sample=spec)[0])]
    jstream += [int(t) for t in jeng.decode_burst([1], [[jstream[0]]], 8, sample=spec)[:, 0]]
    assert stream == jstream
    jmeta, tmeta = _capture_jax_verify(jeng), _capture_port(teng)
    for j, drafts in ((4, stream[1:5]), (2, stream[1:3] + [(stream[3] + 1) % 250, stream[4]])):
        outs = []
        for eng in (jeng, teng):
            uid = 2 + j
            if lora:
                eng.bind_adapter(uid, 101)  # the stream's adapter
            t0 = int(eng.put([uid], [REPETITIVE], sample=spec)[0])
            assert t0 == stream[0]
            toks, acc = eng.verify_burst([uid], [[t0]], [drafts], sample=spec)
            outs.append((toks.tolist(), acc.tolist(), _state(eng, uid)))
            eng.flush(uid)
        assert outs[1] == outs[0]
        assert outs[1][1] == [j] and outs[1][0][0][:j + 1] == stream[1:j + 2]
    assert len(jmeta) == 2
    for want, got in zip(jmeta, tmeta[-3::2]):
        assert got.tobytes() == np.asarray(want, np.int32).tobytes()
    assert tmeta[-1].shape[0] == sum(e - s for s, e in _verify_layout(
        4, teng.max_blocks_per_seq, 4, lora=lora, sampled=True).values())


def test_validation_shared_with_can_burst(debug):
    jeng, teng = _tight_pair(debug)
    errors = []
    for eng in (jeng, teng):
        got = []
        with pytest.raises(ValueError, match="no prefilled context") as e:
            eng.verify_burst([99], [[1]], [[2]])
        got.append(str(e.value))
        assert not eng.can_burst([99], 2)
        eng.put([1], [PROMPT], sample="greedy")
        assert not eng.can_burst([1], 64)
        with pytest.raises(ValueError, match="exceed") as e:
            eng.verify_burst([1], [[1]], [[2] * 63])
        got.append(str(e.value))
        assert not eng.can_burst([1], 16)
        with pytest.raises(RuntimeError, match="KV pool exhausted") as e:
            eng.verify_burst([1], [[1]], [[2] * 15])
        got.append(str(e.value))
        with pytest.raises(ValueError, match="at least one draft") as e:
            eng.verify_burst([1], [[1]], [[]])
        got.append(str(e.value))
        with pytest.raises(ValueError, match="uids vs") as e:
            eng.verify_burst([1], [[1]], [[2], [3]])
        got.append(str(e.value))
        assert eng.can_burst([1], 2)
        errors.append(got)
    assert errors[1] == errors[0]


def _tight_pair(debug):
    """A 4-block pool and a 64-token context (the JAX test's shape)."""
    model, params = debug
    sm = dict(SM, max_context=64)
    spec = dict(enabled=True, draft_len=4)
    jeng = JaxEngine(model=model, config=JaxCfg(kv_block_size=BS, num_kv_blocks=4,
                                                state_manager=JaxSM(**sm),
                                                spec_decode=JaxSpecCfg(**spec)),
                     params=params, dtype=jnp.float32)
    teng = InferenceEngineV2(LlamaConfig(**dataclasses.asdict(model.config)),
                             RaggedInferenceEngineConfig(
                                 kv_block_size=BS, num_kv_blocks=4,
                                 state_manager=DSStateManagerConfig(**sm),
                                 spec_decode=SpecDecodeConfig(**spec)),
                             params=params_from_jax(params), dtype=torch.float32, device="cpu")
    return jeng, teng


# ----------------------------------------------------------------- scheduler
def _lockstep(scheds, jeng, teng):
    steps = 0
    while scheds[0].has_work or scheds[1].has_work:
        assert scheds[1].step() == scheds[0].step()
        assert teng.free_blocks == jeng.free_blocks
        steps += 1
        assert steps < 300
    got = {u: list(r.generated) for u, r in scheds[1].requests.items()}
    assert got == {u: list(r.generated) for u, r in scheds[0].requests.items()}
    return got


def _spec_fleet(jeng, teng, prompts, specs=None, spec=True, max_new=20, max_burst=8,
                eos=None, adapters=None, uid0=0):
    scheds = [cls(eng, token_budget=48, max_burst=max_burst, eos_token_id=eos)
              for cls, eng in ((JaxSched, jeng), (DynamicSplitFuseScheduler, teng))]
    for s in scheds:
        for i, p in enumerate(prompts):
            s.add_request(uid0 + i, p, max_new_tokens=max_new, spec=spec,
                          sample=specs[i] if specs else None,
                          adapter_id=adapters[i] if adapters else None)
    return _lockstep(scheds, jeng, teng)


def _port_fleet(teng, prompts, specs=None, adapters=None):
    """:func:`_spec_fleet`'s traffic on a port engine alone."""
    sched = DynamicSplitFuseScheduler(teng, token_budget=48, max_burst=8)
    for i, p in enumerate(prompts):
        sched.add_request(i, p, max_new_tokens=20, sample=specs[i] if specs else None,
                          adapter_id=adapters[i] if adapters else None)
    return sched.run_to_completion()


PRESETS = {"debug": "debug", "gqa_d128": GQA}


@pytest.fixture(scope="module")
def presets(debug):
    """Per preset: the weights, a spec-on engine pair and a spec-off port
    engine, shared by the scheduler cases (each flushes its requests)."""
    out = {}
    for name, preset in PRESETS.items():
        model, params = debug if name == "debug" else _jax(preset)
        out[name] = (model, _engines(model, params), _port_engine(model, params, spec=False))
    return out


@pytest.mark.parametrize("preset,sampled", [("debug", False), ("debug", True),
                                            ("gqa_d128", False), ("gqa_d128", True)])
def test_scheduler_streams_match_jax_and_spec_off(presets, preset, sampled):
    model, (jeng, teng), off = presets[preset]
    vocab = model.config.vocab_size
    prompts = [REPETITIVE % vocab, PROMPT % vocab, (REPETITIVE + 3) % vocab]
    specs = SPECS if sampled else None
    stats0 = teng.spec.stats()
    syncs0 = (jeng.host_syncs, teng.host_syncs, jeng.tokens_emitted, teng.tokens_emitted)
    got = _spec_fleet(jeng, teng, prompts, specs)
    assert teng.spec.stats() == jeng.spec.stats()
    assert teng.spec.stats()["tokens_drafted"] > stats0["tokens_drafted"]
    assert teng.spec.stats()["verify_steps"] > stats0["verify_steps"]
    assert teng.host_syncs - syncs0[1] == jeng.host_syncs - syncs0[0]
    assert teng.tokens_emitted - syncs0[3] == jeng.tokens_emitted - syncs0[2]
    assert _port_fleet(off, prompts, specs) == got
    assert all(len(s) == 20 for s in got.values())


def test_lora_spec_streams_match_jax(debug):
    jeng, teng = _engines(*debug, lora=True)
    prompts = [REPETITIVE, PROMPT, REPETITIVE + 3]
    got = _spec_fleet(jeng, teng, prompts, adapters=(101, None, 103))
    assert teng.spec.stats() == jeng.spec.stats()
    assert teng.spec.stats()["verify_steps"] > 0
    assert teng.lora_store.stats() == jeng.lora_store.stats()
    off = _port_engine(*debug, spec=False, lora=True)
    _register_adapters([off])
    assert _port_fleet(off, prompts, adapters=(101, None, 103)) == got


def test_int8_moe_spec_streams_match_jax():
    model, params = _jax("mixtral-debug", seed=1)
    jeng, _ = _engines(model, params, mode="int8")
    jeng, teng = _engines(model, params, mode="int8",
                          port_params=params_from_jax(jeng.params))  # the JAX carriers
    vocab = model.config.vocab_size
    prompts = [REPETITIVE % vocab, (REPETITIVE + 5) % vocab]
    _spec_fleet(jeng, teng, prompts, SPECS[:2], max_new=16)
    assert teng.spec.stats() == jeng.spec.stats()
    assert teng.spec.stats()["tokens_drafted"] > 0


def test_eos_among_accepted_run_matches_jax(pair):
    jeng, teng = pair
    probe = _spec_fleet(jeng, teng, [REPETITIVE], max_new=12, uid0=1)[1]
    free0 = teng.free_blocks
    out = _spec_fleet(jeng, teng, [REPETITIVE], max_new=24, eos=probe[4], uid0=2)[2]
    assert out == probe[:probe.index(probe[4]) + 1]
    assert teng.free_blocks == jeng.free_blocks == free0


def test_max_new_tokens_exact_with_spec(pair):
    out = _spec_fleet(*pair, [REPETITIVE], max_new=7, uid0=30)[30]
    assert len(out) == 7


def test_prefix_cache_token_log_after_partial_accepts(debug):
    """Partial accepts leave the token log equal to the KV content, so
    the trie built at retire equals JAX's and the spec-off engine's."""
    jeng, teng = _engines(*debug, prefix=True)
    out = _spec_fleet(jeng, teng, [REPETITIVE])[0]
    hist = list(REPETITIVE) + out
    assert teng.spec.stats() == jeng.spec.stats()
    assert 0 < teng.spec.stats()["tokens_accepted"] < teng.spec.stats()["tokens_drafted"]
    assert teng.prefix_cache.cached_blocks == jeng.prefix_cache.cached_blocks > 0
    assert teng.prefix_match_len(hist) == jeng.prefix_match_len(hist) > 0
    off = _port_engine(*debug, spec=False, prefix=True)
    assert _port_fleet(off, [REPETITIVE])[0] == out
    assert off.prefix_cache.cached_blocks == teng.prefix_cache.cached_blocks
    assert off.prefix_match_len(hist) == teng.prefix_match_len(hist)


def test_ema_auto_disables_losing_sequences_as_jax(debug):
    jeng, teng = _engines(*debug, warmup_steps=2, disable_below=0.25)
    for eng in (jeng, teng):  # drafts that never match the argmax
        eng.spec.drafter.propose = lambda h, cap: [251, 252, 253][:cap]
    scheds = [cls(eng, token_budget=48, max_burst=1)
              for cls, eng in ((JaxSched, jeng), (DynamicSplitFuseScheduler, teng))]
    for s in scheds:
        s.add_request(1, PROMPT, max_new_tokens=12)
    _lockstep(scheds, jeng, teng)
    assert teng.spec.stats() == jeng.spec.stats()
    assert teng.spec.stats()["disabled_sequences"] == 1
    assert teng.spec.stats()["tokens_accepted"] == 0


def test_sampled_traffic_of_the_jax_spec_test_never_drafts(debug):
    """Why the JAX package's ``TestRejectionSampledSpec`` fails with "spec
    decode never drafted": under its traffic (REPETITIVE + i at
    temperature 1.1, top_k 24, bursts of 4) the speculative path is tried
    6 times and every ``propose_drafts`` call returns empty drafts, in the
    JAX engine and the port alike; the same prompts decoded greedily do
    draft. The engines are not at fault; that traffic never reaches the
    sampled verify (the tests above use traffic that does)."""
    jeng, teng = _engines(*debug)
    calls = {}
    for eng in (jeng, teng):
        inner = eng.propose_drafts

        def propose(uids, toks, max_lens=None, inner=inner, eng=eng):
            out = inner(uids, toks, max_lens)
            calls.setdefault(id(eng), []).append((list(max_lens), [len(d) for d in out]))
            return out
        eng.propose_drafts = propose
    scheds = [cls(eng, max_burst=4)
              for cls, eng in ((JaxSched, jeng), (DynamicSplitFuseScheduler, teng))]
    for s in scheds:
        for i in range(3):
            s.add_request(i, REPETITIVE + i, max_new_tokens=12,
                          sample={"temperature": 1.1, "top_k": 24, "seed": 50 + i})
    _lockstep(scheds, jeng, teng)
    want = [([9, 9, 10], [0, 0, 0]), ([5, 5, 6], [0, 0, 0]), ([1, 1, 2], [0, 0, 0]), ([0], [0])]
    assert calls[id(jeng)] == calls[id(teng)] == want
    assert jeng.spec.drafted == teng.spec.drafted == 0
    scheds = [cls(eng, max_burst=4)
              for cls, eng in ((JaxSched, jeng), (DynamicSplitFuseScheduler, teng))]
    for s in scheds:
        for i in range(3):
            s.add_request(10 + i, REPETITIVE + i, max_new_tokens=12)
    _lockstep(scheds, jeng, teng)
    assert teng.spec.stats() == jeng.spec.stats()
    assert (teng.spec.drafted, teng.spec.accepted) == (14, 8)
