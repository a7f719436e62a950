"""Constrained (grammar / JSON-schema) decoding: the port against the JAX package.

- The compiler: for several JSON schemas and regexes over a one-char and a
  multi-char vocab, the token DFA's transition table and mask are
  array-equal to JAX's, and its start, accepting set, pattern and cache key
  equal; fingerprints and vocab signatures are string-equal; the same
  errors are raised (dead end, illegal token, unsupported construct), and
  the process cache compiles once.
- The store: a sequence of binds (recycling a slot), advances and
  releases gives the same slots, states, leases and acceptance as JAX's
  store, and the device slabs equal its slabs.
- ``apply_dfa_mask``, the in-burst DFA advance and ``pack_sample_meta``'s
  DFA rows equal JAX's.
- Engines (debug, fp32 on the CPU, spec decoding on too, as the JAX
  test builds them): schedulers in lockstep over constrained traffic —
  sampled, greedy, a replay per seed, and a batch mixing constrained and
  unconstrained rows — give the same streams, free blocks and host
  syncs; every constrained lane ends at EOS with schema-valid JSON; the
  mixed batch never enters a verify while a constrained row is live;
  the packed put and burst vectors with DFA rows are byte-equal to JAX's.
- The ``DS_CONSTRAINED`` switch in both directions, the disabled
  engine's and scheduler's refusals, the raw-logits refusal, and the
  lease ``flush`` drops, as JAX's."""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.inference.structured import constrained_enabled as jax_constrained_enabled
from deepspeed_tpu.inference.structured import grammar as jgrammar
from deepspeed_tpu.inference.structured.sampling import (apply_dfa_mask as jax_apply_dfa_mask,
                                                         pack_sample_meta as jax_pack_meta)
from deepspeed_tpu.inference.structured.store import StructuredStore as JaxStore
from deepspeed_tpu.inference.v2 import (DSStateManagerConfig as JaxSM,
                                        DynamicSplitFuseScheduler as JaxSched,
                                        InferenceEngineV2 as JaxEngine,
                                        RaggedInferenceEngineConfig as JaxCfg,
                                        SpecDecodeConfig as JaxSpecCfg,
                                        StructuredConfig as JaxStructCfg)
from deepspeed_tpu.models import build_llama
from deepspeed_tpu_torch.inference import structured
from deepspeed_tpu_torch.inference.structured import grammar
from deepspeed_tpu_torch.inference.structured.grammar import (CompiledSchema, SchemaCompileError,
                                                              byte_vocab, detokenize)
from deepspeed_tpu_torch.inference.structured.sampling import apply_dfa_mask, pack_sample_meta
from deepspeed_tpu_torch.inference.structured.store import SchemaCompilerCache, StructuredStore
from deepspeed_tpu_torch.inference.v2 import (DSStateManagerConfig, DynamicSplitFuseScheduler,
                                              InferenceEngineV2, RaggedInferenceEngineConfig,
                                              SpecDecodeConfig, StructuredConfig)
from deepspeed_tpu_torch.models import LlamaConfig, params_from_jax

torch.set_num_threads(1)  # the suite runs in parallel worker processes

EOS = 2
SCHEMA = {"type": "object",
          "properties": {"ok": {"type": "boolean"}, "mode": {"enum": ["fast", "safe"]}},
          "required": ["ok", "mode"]}
SCHEMAS = {
    "object": SCHEMA,
    "nested": {"type": "object", "properties": {
        "n": {"type": "integer"}, "xs": {"type": "array", "items": {"type": "number"},
                                         "minItems": 1, "maxItems": 2},
        "tag": {"const": "v1"}, "z": {"type": "null"}}},
    "string": {"type": "object", "properties": {"name": {"type": "string"}}},
    "enum_mixed": {"enum": [1, "two", None, True]},
    "empty_object": {"type": "object", "properties": {}},
    "regex_number": r"-?[0-9]{1,3}(\.[0-9]+)?",
    "regex_alt": r"(yes|no|maybe)+!?",
    "regex_class": r"[a-c][^a-c ]*[x-z]",
}
# a vocab of multi-char surfaces beside single chars: an empty token, a
# non-ASCII one, and strings crossing the schema's own tokens
MULTI = byte_vocab(100) + ["true", "false", '{"', '":', '"fast"', "fa", "", "é", "12", ".5",
                           '"}', "null", "ok", ',"'] + [chr(65 + i) * 2 for i in range(8)]
VOCABS = {"byte128": byte_vocab(128), "multi": MULTI}
PROMPT = (np.arange(1, 17) % 250).astype(np.int32)
SM = dict(max_ragged_batch_size=64, max_ragged_sequence_count=4, max_tracked_sequences=6,
          max_context=128)


# -------------------------------------------------------------------- grammar
@pytest.mark.parametrize("vocab", sorted(VOCABS))
@pytest.mark.parametrize("name", sorted(SCHEMAS))
def test_compiled_tables_equal_jax(name, vocab):
    toks = VOCABS[vocab]
    want = jgrammar.CompiledSchema(SCHEMAS[name], toks, eos_token_id=EOS)
    got = CompiledSchema(SCHEMAS[name], toks, eos_token_id=EOS)
    np.testing.assert_array_equal(got.trans, want.trans)
    np.testing.assert_array_equal(got.mask, want.mask)
    assert got.trans.dtype == np.int32 and got.mask.dtype == bool
    assert (got.n_states, got.start, got.accepting, got.pattern, got.key, got.eos_token_id) == \
        (want.n_states, want.start, want.accepting, want.pattern, want.key, want.eos_token_id)
    assert got.mask[sorted(got.accepting), EOS].all() and got.mask.sum() >= got.n_states


@pytest.mark.parametrize("name", sorted(SCHEMAS))
def test_fingerprints_and_regex_lowering_equal_jax(name):
    schema = SCHEMAS[name]
    assert grammar.json_schema_to_regex(schema) == jgrammar.json_schema_to_regex(schema)
    assert grammar.schema_fingerprint(schema) == jgrammar.schema_fingerprint(schema)
    if isinstance(schema, dict):  # key order does not move the fingerprint
        shuffled = json.loads(json.dumps(dict(reversed(list(schema.items())))))
        assert grammar.schema_fingerprint(shuffled) == grammar.schema_fingerprint(schema)
    for toks in VOCABS.values():
        for eos in (None, EOS, 7):
            assert grammar.vocab_signature(toks, eos) == jgrammar.vocab_signature(toks, eos)


def test_host_walk_and_errors_match_jax():
    toks = byte_vocab(128)
    c, jc = (mod.CompiledSchema(SCHEMA, toks, eos_token_id=EOS) for mod in (grammar, jgrammar))
    st = jst = c.start
    for ch in '{"ok":true,"mode":"fast"}':
        t = _tok(toks, ch)
        st, jst = c.advance(st, t), jc.advance(jst, t)
        assert st == jst
    assert c.is_accepting(st) and c.mask[st, EOS] and not c.mask[c.start, EOS]
    assert c.matches('{"ok":false,"mode":"safe"}') and not c.matches('{"ok":1}')
    for args, kw, match in [((SCHEMA, [ch for ch in toks if ch != "}"]), dict(eos_token_id=EOS),
                             "dead-end"),
                            (({"type": "tuple"}, toks), {},
                             "unsupported"),
                            ((SCHEMA, toks), dict(eos_token_id=500), "outside vocab"),
                            (("(ab", toks), {}, "end of pattern")]:
        errors = []
        for mod in (grammar, jgrammar):
            with pytest.raises(mod.SchemaCompileError, match=match) as e:
                mod.CompiledSchema(*args, **kw)
            errors.append(str(e.value))
        assert errors[0] == errors[1]
    with pytest.raises(SchemaCompileError, match="not legal"):
        c.advance(c.start, toks.index("x"))
    assert issubclass(SchemaCompileError, ValueError)
    assert detokenize([91, 93], toks) == jgrammar.detokenize([91, 93], toks) == "{}"
    assert byte_vocab(300) == jgrammar.byte_vocab(300)


def test_compiler_cache_compiles_once():
    cache = SchemaCompilerCache()
    toks = byte_vocab(128)
    a = cache.get_or_compile(SCHEMA, toks, eos_token_id=EOS)
    assert cache.get_or_compile(SCHEMA, toks, eos_token_id=EOS) is a
    assert cache.stats() == {"entries": 1, "compiles": 1, "hits": 1}
    cache.get_or_compile(SCHEMA, byte_vocab(200), eos_token_id=EOS)  # another vocab
    cache.get_or_compile(SCHEMA, toks, eos_token_id=3)               # another EOS
    assert cache.compiles == 3
    cache.clear()
    assert cache.stats() == {"entries": 0, "compiles": 0, "hits": 0}


def _tok(toks, ch):
    """The first token id that spells ``ch`` (never EOS, whose content
    column the compiler clears)."""
    return next(i for i, s in enumerate(toks) if s == ch and i != EOS)


# ---------------------------------------------------------------------- store
def test_store_matches_jax():
    """Binds over two slots (the third schema recycles the LRU unleased
    slot; a fourth while both are leased raises), advances, releases."""
    toks = byte_vocab(128)
    compiled = {n: (CompiledSchema(SCHEMAS[n], toks, eos_token_id=EOS),
                    jgrammar.CompiledSchema(SCHEMAS[n], toks, eos_token_id=EOS))
                for n in ("object", "nested", "string")}
    stores = (StructuredStore(128, max_schemas=2, max_states=64, device="cpu"),
              JaxStore(128, max_schemas=2, max_states=64))
    text = {"object": '{"ok":true,"mode":"safe"}', "nested": '{"n":-12,"xs":[0.5],"tag":"v1"',
            "string": '{"name":"ab'}

    def both(op, *args):
        got = [getattr(s, op)(*(a[i] if isinstance(a, tuple) else a for a in args))
               for i, s in enumerate(stores)]
        assert got[0] == got[1], (op, args, got)
        return got[0]

    def check():
        masks, trans = stores[0].slabs()
        assert masks.device.type == "cpu" and trans.dtype == torch.int32
        np.testing.assert_array_equal(masks.numpy(), stores[1]._masks)
        np.testing.assert_array_equal(trans.numpy(), stores[1]._trans)
        assert stores[0]._leases == stores[1]._leases and stores[0]._state == stores[1]._state

    assert both("bind", 1, compiled["object"]) == 1
    assert both("bind", 2, compiled["nested"]) == 2
    assert both("bind", 3, compiled["object"]) == 1  # shared slot
    check()
    for uid, name in ((1, "object"), (2, "nested")):
        for ch in text[name]:
            both("advance", uid, _tok(toks, ch))
        both("accepting", uid)
    assert both("accepting", 1) and not both("accepting", 2)
    both("release", 1)
    both("release", 3)
    assert both("bind", 4, compiled["string"]) == 1  # recycles the unleased slot
    check()
    for ch in text["string"]:
        both("advance", 4, _tok(toks, ch))
    for q in ("bound", "slot_of", "state_of", "accepting"):
        for u in (2, 4, 9):
            both(q, u)
    assert both("advance", 9, 5) == 0 and both("accepting", 9)
    with pytest.raises(RuntimeError, match="schema slots are leased"):
        stores[0].bind(5, compiled["object"][0])
    big = CompiledSchema(SCHEMAS["nested"], toks, eos_token_id=EOS)
    with pytest.raises(SchemaCompileError, match="max_states"):
        StructuredStore(128, max_states=big.n_states - 1, device="cpu").bind(1, big)
    with pytest.raises(SchemaCompileError, match="vocab"):
        StructuredStore(256, device="cpu").bind(1, big)
    check()


# ------------------------------------------------------------- device pieces
def test_dfa_mask_and_advance_match_jax():
    toks = byte_vocab(128)
    stores = (StructuredStore(128, device="cpu"), JaxStore(128))
    for s, mod in zip(stores, (grammar, jgrammar)):
        s.bind(1, mod.CompiledSchema(SCHEMA, toks, eos_token_id=EOS))
        s.bind(2, mod.CompiledSchema(SCHEMAS["regex_number"], toks))
    masks, trans = stores[0].slabs()
    jmasks, jtrans = stores[1].slabs()
    rs = np.random.RandomState(0)
    slots = np.array([0, 1, 1, 2, 2, 0], np.int32)
    states = np.array([0, 0, 3, 0, 2, 0], np.int32)
    logits = rs.randn(6, 128).astype(np.float32)
    got = apply_dfa_mask(torch.from_numpy(logits), masks, torch.from_numpy(slots),
                         torch.from_numpy(states))
    want = np.asarray(jax_apply_dfa_mask(jnp.asarray(logits), jmasks, slots, states))
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.isinf(want).any() and np.isfinite(want[0]).all()
    picks = got.argmax(dim=-1).to(torch.int32)
    nxt = trans[torch.from_numpy(slots).long(), torch.from_numpy(states).long(), picks.long()]
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(jtrans[slots, states, picks.numpy()]))
    specs = [{"temperature": 0.9, "seed": 5}, None, {"top_k": 3, "top_p": 0.5, "seed": 7}]
    dfa = [(1, 4), (0, 0), (2, 3)]
    assert pack_sample_meta(specs, 4, dfa=dfa).tobytes() == \
        np.asarray(jax_pack_meta(specs, 4, dfa=dfa), np.int32).tobytes()


# -------------------------------------------------------------------- engines
@pytest.fixture(scope="module")
def debug():
    model = build_llama("debug", remat=False)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    return model, jax.tree.map(np.asarray, params)


def _engines(model, params, structured=True, spec=True):
    jeng = JaxEngine(model=model, config=JaxCfg(
        kv_block_size=8, state_manager=JaxSM(**SM), spec_decode=JaxSpecCfg(enabled=spec),
        structured=JaxStructCfg(enabled=structured)), params=params, dtype=jnp.float32)
    teng = InferenceEngineV2(LlamaConfig(**dataclasses.asdict(model.config)),
                             RaggedInferenceEngineConfig(
                                 kv_block_size=8, state_manager=DSStateManagerConfig(**SM),
                                 spec_decode=SpecDecodeConfig(enabled=spec),
                                 structured=StructuredConfig(enabled=structured)),
                             params=params_from_jax(params), dtype=torch.float32, device="cpu")
    return jeng, teng


@pytest.fixture(scope="module")
def pair(debug):
    return _engines(*debug)


def _lockstep(scheds, jeng, teng):
    steps = 0
    while scheds[0].has_work or scheds[1].has_work:
        assert scheds[1].step() == scheds[0].step()
        assert teng.free_blocks == jeng.free_blocks
        steps += 1
        assert steps < 400
    got = {u: list(r.generated) for u, r in scheds[1].requests.items()}
    assert got == {u: list(r.generated) for u, r in scheds[0].requests.items()}
    for s in scheds:
        for u in list(s.requests):
            s.retire(u)
    return got


def _fleet(jeng, teng, sample_specs, uid0=0, schemas=None, prompts=None, max_burst=4):
    vocab = byte_vocab(teng.model_config.vocab_size)
    compiled = (jgrammar.CompiledSchema(SCHEMA, vocab, eos_token_id=EOS),
                CompiledSchema(SCHEMA, vocab, eos_token_id=EOS))
    schemas = schemas or [True] * len(sample_specs)
    scheds = [cls(eng, max_burst=max_burst, eos_token_id=EOS)
              for cls, eng in ((JaxSched, jeng), (DynamicSplitFuseScheduler, teng))]
    for k, s in enumerate(scheds):
        for i, spec in enumerate(sample_specs):
            s.add_request(uid0 + i, prompts[i] if prompts else PROMPT + i, max_new_tokens=64,
                          sample=spec, schema=compiled[k] if schemas[i] else None)
    return _lockstep(scheds, jeng, teng), vocab


def _valid(toks, vocab):
    assert toks[-1] == EOS, f"lane never terminated: {toks}"
    doc = json.loads(detokenize(toks[:-1], vocab))
    assert set(doc) == {"ok", "mode"}
    assert isinstance(doc["ok"], bool) and doc["mode"] in ("fast", "safe")


@pytest.mark.parametrize("kind", ["sampled", "greedy", "mixed_greedy_sampled"])
def test_constrained_streams_match_jax_and_are_valid_json(pair, kind):
    jeng, teng = pair
    specs = {"sampled": [{"temperature": 1.2, "top_k": 30, "seed": 7 + i} for i in range(3)],
             "greedy": [None],
             "mixed_greedy_sampled": [None, {"temperature": 1.4, "top_k": 40, "seed": 99},
                                      {"temperature": 0.8, "top_p": 0.9, "seed": 3}]}[kind]
    free0, syncs0 = teng.free_blocks, (jeng.host_syncs, teng.host_syncs)
    out, vocab = _fleet(jeng, teng, specs, uid0=10)
    assert len(out) == len(specs)
    for toks in out.values():
        _valid(toks, vocab)
    assert teng.free_blocks == free0
    assert teng.host_syncs - syncs0[1] == jeng.host_syncs - syncs0[0]
    assert not teng.structured.any_bound()


def test_constrained_replays_per_seed(pair):
    spec = {"temperature": 1.4, "top_k": 40, "seed": 99}
    a, _ = _fleet(*pair, [spec], uid0=20)
    b, _ = _fleet(*pair, [spec], uid0=20)
    assert a == b


def test_mixed_batch_with_spec_takes_plain_bursts(debug):
    """Constrained and unconstrained rows in one batch on a spec engine:
    no verify while a constrained row is live, and the same streams and
    spec statistics as JAX's."""
    jeng, teng = _engines(*debug)
    verified, bound = [], []
    inner = teng.verify_burst

    def verify(uids, *args, **kwargs):
        verified.append(list(uids))
        bound.append(any(teng.structured.bound(u) for u in uids))
        return inner(uids, *args, **kwargs)
    teng.verify_burst = verify
    rep = np.tile(np.array([7, 8, 9, 10], np.int32), 6)
    prompts = [PROMPT, rep, PROMPT + 2, rep + 1]
    specs = [{"temperature": 1.1, "top_k": 40, "seed": 500}, None, None, None]
    out, vocab = _fleet(jeng, teng, specs, schemas=[True, False, True, False], prompts=prompts,
                        max_burst=8)
    _valid(out[0], vocab)
    _valid(out[2], vocab)
    assert not any(bound)
    assert teng.spec.stats() == jeng.spec.stats()


def test_packed_vectors_with_dfa_rows_byte_equal(debug):
    jeng, teng = _engines(*debug)
    puts, bursts, seen = [], [], []
    step, get, upload = jeng._step_sampled, jeng._get_burst_fn, teng._upload

    def sampled(*args):
        puts.append(np.array(args[3]))
        return step(*args)

    def get_burst(key, make):
        fn = get(key, make)

        def call(*args):
            bursts.append(np.array(args[3]))
            return fn(*args)
        return call

    def recorded(arrays):
        seen.append(np.array(arrays))
        return upload(arrays)
    jeng._step_sampled, jeng._get_burst_fn, teng._upload = sampled, get_burst, recorded
    vocab = byte_vocab(256)
    for eng, mod in ((jeng, jgrammar), (teng, grammar)):
        eng.bind_schema(1, mod.CompiledSchema(SCHEMA, vocab, eos_token_id=EOS))
        eng.bind_schema(3, SCHEMAS["regex_alt"], token_strings=vocab, eos_token_id=EOS)  # through the cache
        first = eng.put([1, 2, 3], [PROMPT, PROMPT + 1, PROMPT + 2], sample="greedy")
        for uid, tok in zip((1, 3), first[[0, 2]]):
            eng.advance_schema(uid, int(tok))
        eng.decode_burst([1, 2, 3], [[int(t)] for t in first], 3,
                         sample=[None, {"temperature": 0.5, "seed": 4}, None])
    assert len(puts) == 1 and len(bursts) == 1 and len(seen) == 2
    for want, got in zip(puts + bursts, seen):
        assert got.tobytes() == np.asarray(want, np.int32).tobytes()
    dfa_rows = seen[1][-8:]  # slot and state rows of the burst, max_seqs 4
    assert list(dfa_rows[:4]) == [1, 0, 2, 0] and dfa_rows[4] > 0 and dfa_rows[6] > 0


# --------------------------------------------------------------- switches
@pytest.mark.parametrize("env,config_on", [(None, True), (None, False), ("0", True),
                                           ("1", False), ("no", True)])
def test_constrained_switch_matches_jax(monkeypatch, env, config_on):
    if env is None:
        monkeypatch.delenv("DS_CONSTRAINED", raising=False)
    else:
        monkeypatch.setenv("DS_CONSTRAINED", env)
    want = jax_constrained_enabled(JaxStructCfg(enabled=config_on))
    assert structured.constrained_enabled(StructuredConfig(enabled=config_on)) == want
    assert want == (config_on if env is None else env == "1")


def test_disabled_engine_and_scheduler_refuse(debug, monkeypatch):
    monkeypatch.setenv("DS_CONSTRAINED", "0")
    jeng, teng = _engines(*debug)  # the config says enabled
    assert teng.structured is None and jeng.structured is None
    errors = []
    for eng, sched in ((jeng, JaxSched), (teng, DynamicSplitFuseScheduler)):
        with pytest.raises(RuntimeError, match="constrained") as e:
            eng.bind_schema(1, SCHEMA)
        with pytest.raises(ValueError, match="constrained") as e2:
            sched(eng).add_request(0, PROMPT, schema=SCHEMA)
        errors.append((str(e.value), str(e2.value)))
        assert eng.advance_schema(1, 5) == 0 and eng.schema_accepting(1)
    assert errors[1] == errors[0]


def test_raw_logits_refused_and_flush_releases_the_lease(pair):
    jeng, teng = pair
    vocab = byte_vocab(256)
    errors = []
    for eng, mod in ((jeng, jgrammar), (teng, grammar)):
        eng.bind_schema(77, mod.CompiledSchema(SCHEMA, vocab, eos_token_id=EOS))
        assert eng.structured.bound(77)
        with pytest.raises(RuntimeError, match="raw-logits") as e:
            eng.put([77], [PROMPT])
        errors.append(str(e.value))
        with pytest.raises(ValueError, match="token_strings"):
            eng.bind_schema(78, SCHEMA)
        eng.put([77], [PROMPT], sample={"temperature": 1.0, "seed": 1})
        eng.flush(77)
        assert not eng.structured.bound(77)
    assert errors[1] == errors[0]
