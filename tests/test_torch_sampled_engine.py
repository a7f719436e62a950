"""On-device sampling on the ragged engine: the port against the JAX package.

Both engines serve the same weights (the JAX tree through
``params_from_jax``) in fp32 on the CPU with the default ``DS_SEED`` (42),
so the counter keys and the ``draw_seed`` stream are the same:

- a mixed-spec ``put`` (sampled and greedy rows, seeded and not) and a
  sampled ``decode_burst`` give the same tokens and host-sync counts;
- schedulers in lockstep with ``sampling=`` or per-request ``sample=``,
  with and without seeds, at ``max_burst`` 1 and 4: the same stepped uids
  and free blocks after every step, the same streams and host syncs;
- ``bench_serving_2b_sampled(debug=True)``'s protocol (6 requests x
  16-token prompts x 24 new tokens, its six specs, bursts of 8): greedy and
  sampled streams equal JAX's, and the sampled trace replayed under fresh
  uids gives the same streams;
- the packed put vector and the burst metadata vector of sampled calls
  are byte-equal to JAX's, LoRA off and on (the adapter row, then the six
  sampling rows);
- a LoRA-on sampled stream, and an int8 ``mixtral-debug`` one (the port
  given the JAX engine's own carriers), equal JAX's;
- both engines refuse the same invalid ``sample=`` arguments with the
  same ``ValueError``.

Tokens are compared exactly: the logits agree within 1e-4
(``test_torch_engine_v2.py``) and the sampler within the bounds of
``test_torch_sampling.py``, so a token can differ only at a near-tie,
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
                                        RaggedInferenceEngineConfig as JaxCfg)
from deepspeed_tpu.inference.v2.config_v2 import LoRAServingConfig as JaxLoRA
from deepspeed_tpu.models import build_llama
from deepspeed_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from deepspeed_tpu_torch.inference.v2 import (DSStateManagerConfig, DynamicSplitFuseScheduler,
                                              InferenceEngineV2, LoRAServingConfig,
                                              RaggedInferenceEngineConfig)
from deepspeed_tpu_torch.models import LlamaConfig, params_from_jax

SM = dict(max_ragged_batch_size=32, max_ragged_sequence_count=4, max_tracked_sequences=6,
          max_context=64)
PRESETS = {
    "debug": "debug",
    "gqa_d128": JaxLlamaConfig(vocab_size=128, hidden_size=512, intermediate_size=256,
                               num_hidden_layers=2, num_attention_heads=4,
                               num_key_value_heads=2, max_position_embeddings=128),
}
PROMPTS = [(np.arange(11) * 7 + 3) % 120, (np.arange(4) * 5 + 1) % 120,
           (np.arange(17) * 3 + 2) % 120, (np.arange(9) * 11 + 5) % 120]
SPECS = [{"temperature": 0.8, "top_k": 20, "seed": 5}, None,
         {"temperature": 1.2, "top_p": 0.9}, {"temperature": 0.6, "top_k": 1}]
ADAPTERS = {101: (1, 2, 4.0), 103: (3, 4, 8.0)}  # id: (seed, rank, alpha)


def _jax(preset, seed=0):
    model = build_llama(preset, remat=False)
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    return model, jax.tree.map(np.asarray, params)


def _engines(model, params, sm=SM, block=8, lora=False, mode="none", port_params=None):
    """A JAX and a port engine over the same weights (adapters registered
    in both when LoRA is on)."""
    lora_kw = dict(enabled=lora, hot_set=4, max_rank=4, prefetch=False)
    jeng = JaxEngine(model=model, config=JaxCfg(
        kv_block_size=block, state_manager=JaxSM(**sm), lora=JaxLoRA(**lora_kw),
        quantization={"quantization_mode": mode}), params=params, dtype=jnp.float32)
    teng = InferenceEngineV2(LlamaConfig(**dataclasses.asdict(model.config)),
                             RaggedInferenceEngineConfig(
                                 kv_block_size=block, state_manager=DSStateManagerConfig(**sm),
                                 lora=LoRAServingConfig(**lora_kw),
                                 quantization={"quantization_mode": mode}),
                             params=port_params or params_from_jax(params),
                             dtype=torch.float32, device="cpu")
    if lora:
        st = teng.lora_store
        for aid, (seed, r, alpha) in ADAPTERS.items():
            rs = np.random.RandomState(seed)
            layers = {site: (rs.randn(st.num_layers, din, r).astype(np.float32) * 0.05,
                             rs.randn(st.num_layers, r, dout).astype(np.float32) * 0.05)
                      for site, (din, dout) in st.dims.items()}
            for eng in (jeng, teng):
                eng.register_adapter(aid, layers, alpha=alpha)
    return jeng, teng


@pytest.fixture(scope="module")
def engines():
    """One engine pair per preset, shared (every request is flushed when
    it finishes, so the pools return to empty between tests)."""
    return {name: _engines(*_jax(preset)) for name, preset in PRESETS.items()}


def _flush(engs, uids):
    for eng in engs:
        for uid in uids:
            eng.flush(uid)


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_put_and_burst_match_jax(engines, preset):
    jeng, teng = engines[preset]
    prompts = [p.astype(np.int32) for p in PROMPTS[:3]]
    outs, syncs = [], []
    for eng in (jeng, teng):
        s0 = eng.host_syncs
        first = eng.put([1, 2, 3], prompts, sample=SPECS[:3])
        nxt = eng.put([1, 2, 3], [[int(t)] for t in first],
                      sample={"temperature": 0.9, "top_p": 0.8})  # seeds drawn
        burst = eng.decode_burst([1, 2, 3], [[int(t)] for t in nxt], 4, sample=SPECS[1:4])
        greedy = eng.decode_burst([1, 2, 3], [[int(t)] for t in burst[-1]], 2)
        outs.append((first, nxt, burst, greedy))
        syncs.append(eng.host_syncs - s0)
    for want, got in zip(*outs):
        np.testing.assert_array_equal(got, want)
    assert outs[1][0].dtype == np.int32 and outs[1][2].shape == (4, 3)
    assert syncs[1] == syncs[0]
    assert teng.query(1) == jeng.query(1)
    _flush((jeng, teng), (1, 2, 3))
    assert teng.free_blocks == jeng.free_blocks


def _lockstep(scheds, jeng, teng):
    steps = 0
    while scheds[0].has_work or scheds[1].has_work:
        assert scheds[1].step() == scheds[0].step()
        assert teng.free_blocks == jeng.free_blocks
        steps += 1
        assert steps < 200
    got = {u: list(r.generated) for u, r in scheds[1].requests.items()}
    assert got == {u: list(r.generated) for u, r in scheds[0].requests.items()}
    return got


@pytest.mark.parametrize("preset,max_burst,how", [
    ("debug", 1, "sampling"), ("debug", 4, "sampling"), ("debug", 1, "sample"),
    ("debug", 4, "sample"), ("gqa_d128", 4, "sample")])
def test_scheduler_streams_match_jax(engines, preset, max_burst, how):
    """``sampling=`` (no seed: the engine draws one per row per call) or
    per-request ``sample=`` (seeded, unseeded: drawn at admission, greedy)."""
    jeng, teng = engines[preset]
    free0, syncs0 = teng.free_blocks, (jeng.host_syncs, teng.host_syncs)
    kw = {"sampling": {"temperature": 0.9, "top_k": 30}} if how == "sampling" else {}
    scheds = [cls(eng, token_budget=16, max_burst=max_burst, **kw)
              for cls, eng in ((JaxSched, jeng), (DynamicSplitFuseScheduler, teng))]
    for s in scheds:
        for uid, p in enumerate(PROMPTS):
            s.add_request(100 + uid, p.astype(np.int32), max_new_tokens=6 + 2 * uid,
                          sample=SPECS[uid] if how == "sample" else None)
    got = _lockstep(scheds, jeng, teng)
    assert [len(got[100 + i]) for i in range(4)] == [6, 8, 10, 12]
    assert teng.free_blocks == free0
    assert teng.host_syncs - syncs0[1] == jeng.host_syncs - syncs0[0]


def test_bench_serving_sampled_protocol_debug():
    """``bench_serving_2b_sampled(debug=True)``'s protocol on both engines:
    greedy, then the six specs, then the specs again under fresh uids."""
    n_req, prompt_len, new_tokens, block, vocab = 6, 16, 24, 8, 250
    budget = prompt_len + n_req
    sm = dict(max_ragged_batch_size=budget, max_ragged_sequence_count=n_req,
              max_tracked_sequences=n_req, max_context=prompt_len + new_tokens + 8)
    jeng, teng = _engines(*_jax("debug"), sm=sm, block=block)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, vocab, size=prompt_len).astype(np.int32) for _ in range(n_req)]
    specs = [{"temperature": 0.7 + 0.2 * (i % 3), "top_k": 16 + 16 * (i % 2),
              "top_p": (0.9 if i % 2 else None), "seed": 1000 + i} for i in range(n_req)]
    specs = [{k: v for k, v in s.items() if v is not None} for s in specs]

    def fleet(uid0, sample_specs):
        scheds = [cls(eng, token_budget=budget, max_burst=8)
                  for cls, eng in ((JaxSched, jeng), (DynamicSplitFuseScheduler, teng))]
        for s in scheds:
            for i, p in enumerate(prompts):
                s.add_request(uid0 + i, p, max_new_tokens=new_tokens,
                              sample=sample_specs[i] if sample_specs else None)
        out = _lockstep(scheds, jeng, teng)
        return [out[uid0 + i] for i in range(n_req)]

    greedy = fleet(0, None)
    sampled = fleet(100, specs)
    assert fleet(200, specs) == sampled
    assert sampled != greedy and all(len(s) == new_tokens for s in sampled)
    assert teng.host_syncs == jeng.host_syncs
    assert teng.tokens_emitted == jeng.tokens_emitted


def _capture_jax(jeng):
    """Record the packed vector of JAX's sampled puts and the metadata
    vector of its bursts."""
    puts, bursts = [], []
    step = jeng._step_sampled

    def sampled(*args):
        puts.append(np.array(args[3]))
        return step(*args)
    jeng._step_sampled = sampled
    get = jeng._get_burst_fn

    def get_burst(key, make):
        fn = get(key, make)

        def call(*args):
            bursts.append(np.array(args[3]))
            return fn(*args)
        return call
    jeng._get_burst_fn = get_burst
    return puts, bursts


def _capture_port(teng):
    seen = []
    upload = teng._upload

    def recorded(arrays):
        seen.append(np.array(arrays))
        return upload(arrays)
    teng._upload = recorded
    return seen


@pytest.mark.parametrize("lora", [False, True])
def test_packed_vectors_byte_equal(lora):
    jeng, teng = _engines(*_jax("debug"), lora=lora)
    puts, bursts = _capture_jax(jeng)
    seen = _capture_port(teng)
    for eng in (jeng, teng):
        if lora:
            eng.bind_adapter(1, 101)
            eng.bind_adapter(3, 103)
        eng.put([1, 2, 3], [p.astype(np.int32) for p in PROMPTS[:3]], sample=SPECS[:3])
        eng.put([3, 1], [[7], [8]], sample=[None, {"top_p": 0.5, "seed": 2 ** 31 - 1}])
        eng.decode_burst([1, 2, 3], [[4], [5], [6]], 3, sample={"temperature": 0.5})
    assert len(puts) == 2 and len(bursts) == 1 and len(seen) == 3
    for want, got in zip(puts + bursts, seen):
        assert got.dtype == np.int32
        assert got.tobytes() == np.asarray(want, np.int32).tobytes()
    ms, mb = teng.max_seqs, teng.max_blocks_per_seq
    assert seen[2].shape[0] == 3 * ms + (ms + 1) * mb + ((ms + 1) if lora else 0) + 6 * ms
    seeds = seen[2][-3 * ms:-2 * ms]  # the burst's seed row: drawn, the pad row 0
    assert seeds[3] == 0 and all(0 < s < 2 ** 31 - 1 for s in seeds[:3])


def test_lora_sampled_stream_matches_jax():
    jeng, teng = _engines(*_jax("debug"), lora=True)
    free0 = teng.free_blocks
    scheds = [cls(eng, token_budget=16, max_burst=4)
              for cls, eng in ((JaxSched, jeng), (DynamicSplitFuseScheduler, teng))]
    for s in scheds:
        for uid, (p, aid) in enumerate(zip(PROMPTS, (101, None, 103, 101))):
            s.add_request(100 + uid, p.astype(np.int32), max_new_tokens=8, adapter_id=aid,
                          sample=SPECS[uid])
    _lockstep(scheds, jeng, teng)
    assert teng.free_blocks == free0
    assert teng.lora_store.stats() == jeng.lora_store.stats()


def test_int8_moe_sampled_stream_matches_jax():
    model, params = _jax("mixtral-debug", seed=1)
    jeng, _ = _engines(model, params, mode="int8")
    jeng, teng = _engines(model, params, mode="int8",
                          port_params=params_from_jax(jeng.params))  # the JAX carriers
    assert teng.params["layers"]["wq"].scheme == "int8"
    scheds = [cls(eng, token_budget=16, max_burst=4)
              for cls, eng in ((JaxSched, jeng), (DynamicSplitFuseScheduler, teng))]
    for s in scheds:
        for uid, p in enumerate(PROMPTS[:3]):
            s.add_request(100 + uid, p.astype(np.int32), max_new_tokens=8, sample=SPECS[uid])
    _lockstep(scheds, jeng, teng)


BAD = [{"temperature": 0}, {"top_k": -1, "seed": 1}, {"temp": 1.0}, [None, {"top_p": 0}],
       [None], [None, 3], "sampled", 0.5]


@pytest.mark.parametrize("sample", BAD, ids=[repr(b) for b in BAD])
def test_invalid_sample_raises_as_jax(engines, sample):
    jeng, teng = engines["debug"]
    errors = []
    for eng in (jeng, teng):
        free = eng.free_blocks
        with pytest.raises(ValueError) as put_err:
            eng.put([1, 2], [[3, 4], [5]], sample=sample)
        assert eng.query(1) is None and eng.free_blocks == free  # nothing mutated
        with pytest.raises(ValueError) as burst_err:
            eng.decode_burst([1, 2], [[3], [5]], 2, sample=sample)
        errors.append((str(put_err.value), str(burst_err.value)))
    assert errors[1] == errors[0]
