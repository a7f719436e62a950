"""Multi-tenant LoRA serving: the port's ragged engine vs the JAX package's.

Both engines serve the ``debug`` preset in fp32 on the CPU from the same
weights (the JAX tree through ``params_from_jax``) with the same three
adapters, of ranks 2, 3 and 4 padded to the rank bucket 4, registered from
the same numpy arrays:

- the packed batch vector of a mixed put and the decode-burst metadata
  vector with LoRA on equal the JAX engine's byte for byte (the adapter
  row appended); with LoRA off they equal the JAX engine's pre-LoRA ones,
  which is what the port packed before;
- ``DynamicSplitFuseScheduler(adapter_id=)`` requests, mixed with base
  requests, give equal greedy streams, and last-token logits of a mixed
  put agree within 1e-4 (``test_torch_engine_v2.py``'s bound: the two
  frameworks' fp32 matmuls sum in other orders);
- a request's prefill logits and decode stream are bit-identical whether
  it shares its batches with other tenants or runs alone (the JAX
  package's ``test_mixed_batch_bit_identical_to_solo``);
- ``flush`` releases the lease; with a hot set of 2 and 3 adapters,
  promotion evicts only unleased slots and raises
  ``AdapterCapacityError`` when every slot is leased;
- ``mixtral-debug`` under int8 with LoRA on (the delta on a quantized
  base): the port given the JAX engine's own carriers gives its logits
  within 1e-5 relative to their max-abs and equal burst tokens, as
  ``test_torch_quant_engine.py`` holds the quantized engines without
  LoRA.
"""

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
from deepspeed_tpu.serving.lora import AdapterCapacityError as JaxCapacityError
from deepspeed_tpu_torch.inference.v2 import (DSStateManagerConfig, DynamicSplitFuseScheduler,
                                              InferenceEngineV2, LoRAServingConfig,
                                              RaggedInferenceEngineConfig)
from deepspeed_tpu_torch.models import LlamaConfig, params_from_jax
from deepspeed_tpu_torch.serving.lora import AdapterCapacityError

torch.set_num_threads(1)  # the suite runs in parallel worker processes

SM = dict(max_ragged_batch_size=32, max_ragged_sequence_count=4, max_tracked_sequences=6,
          max_context=64)
ADAPTERS = {101: (1, 2, 4.0), 102: (2, 3, 6.0), 103: (3, 4, 8.0)}  # id: (seed, rank, alpha)
PROMPTS = [(np.arange(11) * 7 + 3) % 120, (np.arange(4) * 5 + 1) % 120,
           (np.arange(17) * 3 + 2) % 120, (np.arange(9) * 11 + 5) % 120]


def _adapter(dims, L, seed, r):
    rs = np.random.RandomState(seed)
    return {site: (rs.randn(L, din, r).astype(np.float32) * 0.05,
                   rs.randn(L, r, dout).astype(np.float32) * 0.05)
            for site, (din, dout) in dims.items()}


def _jax(preset, seed=0):
    model = build_llama(preset, remat=False)
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    return model, jax.tree.map(np.asarray, params)


def _engines(model, params, lora=True, hot_set=4, mode="none", port_params=None):
    """A JAX and a port engine with the same LoRA config, the adapters
    registered in both when LoRA is on. ``port_params="jax"`` gives the
    port the JAX engine's own carriers."""
    lora_kw = dict(enabled=lora, hot_set=hot_set, max_rank=4, prefetch=False)
    jeng = JaxEngine(model=model, config=JaxCfg(
        kv_block_size=8, state_manager=JaxSM(**SM), lora=JaxLoRA(**lora_kw),
        quantization={"quantization_mode": mode}), params=params, dtype=jnp.float32)
    if port_params == "jax":  # the JAX engine's own carriers
        port_params = params_from_jax(jeng.params)
    teng = InferenceEngineV2(LlamaConfig(**dataclasses.asdict(model.config)),
                             RaggedInferenceEngineConfig(
                                 kv_block_size=8, state_manager=DSStateManagerConfig(**SM),
                                 lora=LoRAServingConfig(**lora_kw),
                                 quantization={"quantization_mode": mode}),
                             params=port_params or params_from_jax(params),
                             dtype=torch.float32, device="cpu")
    if lora:
        st = teng.lora_store
        for aid, (seed, r, alpha) in ADAPTERS.items():
            layers = _adapter(st.dims, st.num_layers, seed, r)
            for eng in (jeng, teng):
                eng.register_adapter(aid, layers, alpha=alpha)
    return jeng, teng


@pytest.fixture(scope="module")
def debug():
    return _jax("debug")


def _capture(eng):
    """Record what ``eng._batch.finalize_packed`` returns."""
    seen = []
    inner = eng._batch.finalize_packed

    def wrapped(*a, **k):
        out = inner(*a, **k)
        seen.append(np.array(out))
        return out
    eng._batch.finalize_packed = wrapped
    return seen


def _burst_meta_jax(jeng):
    seen = []
    inner = jeng._get_burst_fn

    def get(key, make):
        fn = inner(key, make)

        def call(*args):
            seen.append(np.array(args[3]))
            return fn(*args)
        return call
    jeng._get_burst_fn = get
    return seen


def _burst_meta_port(teng):
    """The port's whole burst metadata vector, read back through the
    storage its ``token_seq`` view shares."""
    seen = []
    inner = teng._forward

    def forward(batch):
        if "num_tokens" not in batch and not seen:  # a burst step, not a put
            storage = batch["token_seq"].untyped_storage()
            whole = torch.empty(0, dtype=torch.int32).set_(storage, 0,
                                                           (storage.nbytes() // 4,))
            seen.append(whole.numpy().copy())
        return inner(batch)
    teng._forward = forward
    return seen


@pytest.mark.parametrize("lora", [True, False])
def test_packed_vectors_byte_equal(debug, lora):
    model, params = debug
    jeng, teng = _engines(model, params, lora=lora)
    packed = [_capture(e) for e in (jeng, teng)]
    metas = [_burst_meta_jax(jeng), _burst_meta_port(teng)]
    adapters = (101, None, 103) if lora else (None, None, None)
    for eng in (jeng, teng):
        for uid, aid in zip((1, 2, 3), adapters):
            if aid:
                eng.bind_adapter(uid, aid)
        eng.put([1, 2, 3], [p.astype(np.int32) for p in PROMPTS[:3]])   # prefill bucket
        eng.put([3, 1], [[7], [8]])                                      # decode bucket
        eng.decode_burst([1, 2, 3], [[4], [5], [6]], 3)
    assert len(packed[0]) == len(packed[1]) == 2
    for want, got in zip(*packed):
        assert got.dtype == want.dtype == np.int32
        assert got.tobytes() == want.tobytes()
    assert len(metas[0]) == len(metas[1]) == 1
    assert metas[1][0].tobytes() == np.asarray(metas[0][0], np.int32).tobytes()
    ms, mb = teng.max_seqs, teng.max_blocks_per_seq
    assert metas[1][0].shape[0] == 3 * ms + (ms + 1) * mb + ((ms + 1) if lora else 0)
    if lora:  # the adapter row: slots 1 and 2 for the bound uids, base for uid 2, pad row 0
        assert list(metas[1][0][-(ms + 1):]) == [1, 0, 2, 0, 0]


def _run(sched_cls, eng, max_burst, adapters):
    sched = sched_cls(eng, token_budget=16, max_burst=max_burst)
    for uid, (p, aid) in enumerate(zip(PROMPTS, adapters)):
        sched.add_request(100 + uid, p.astype(np.int32), max_new_tokens=6 + 2 * uid,
                          adapter_id=aid)
    return sched


@pytest.mark.parametrize("max_burst", [1, 4])
def test_streams_match_jax(debug, max_burst):
    model, params = debug
    jeng, teng = _engines(model, params)
    adapters = (101, None, 102, 103)
    free0 = teng.free_blocks
    scheds = [_run(JaxSched, jeng, max_burst, adapters),
              _run(DynamicSplitFuseScheduler, teng, max_burst, adapters)]
    assert teng.lora_store.stats() == jeng.lora_store.stats()
    steps = 0
    while scheds[0].has_work or scheds[1].has_work:
        assert scheds[1].step() == scheds[0].step()
        assert teng.free_blocks == jeng.free_blocks
        steps += 1
        assert steps < 200
    got = {u: list(r.generated) for u, r in scheds[1].requests.items()}
    assert got == {u: list(r.generated) for u, r in scheds[0].requests.items()}
    assert teng.free_blocks == free0
    # every lease went with its request's flush
    assert teng.lora_store.stats() == jeng.lora_store.stats()
    assert teng.lora_store.stats()["leases"] == 0

    # last-token logits of a mixed put (two adapters, one base row)
    for eng in (jeng, teng):
        eng.bind_adapter(7, 102)
        eng.bind_adapter(9, 101)
    toks = [PROMPTS[0].astype(np.int32), PROMPTS[2].astype(np.int32), PROMPTS[3][:4]]
    want = jeng.put([7, 8, 9], toks)
    out = teng.put([7, 8, 9], toks)
    np.testing.assert_allclose(out, want, rtol=1e-4, atol=1e-4)


def _solo(model, params, uid, aid, prompt, k):
    _, eng = _engines(model, params)
    if aid:
        eng.bind_adapter(uid, aid)
    logits = eng.put([uid], [prompt])
    burst = eng.decode_burst([uid], [[int(np.argmax(logits[0]))]], k)
    return logits[0], burst[:, 0]


def test_mixed_batch_bit_identical_to_solo(debug):
    model, params = debug
    _, eng = _engines(model, params)
    eng.bind_adapter(11, 101)
    eng.bind_adapter(12, 103)
    p1 = (np.arange(10, dtype=np.int32) % 250) + 1
    p2 = ((np.arange(10) * 3) % 250 + 1).astype(np.int32)
    # uid 10 = base, 11 -> the rank-2 adapter, 12 -> the rank-4 adapter
    mixed = eng.put([10, 11, 12], [p1, p1, p2])
    burst = eng.decode_burst([10, 11, 12], [[int(np.argmax(m))] for m in mixed], 4)
    for i, (uid, aid, prompt) in enumerate([(10, 0, p1), (11, 101, p1), (12, 103, p2)]):
        logits, toks = _solo(model, params, uid, aid, prompt, 4)
        assert np.array_equal(mixed[i], logits), f"prefill logits differ for row {i}"
        assert np.array_equal(burst[:, i], toks), f"decode stream differs for row {i}"
    # and the adapter changed the output against the base row
    assert not np.array_equal(mixed[0], mixed[1])


def test_flush_releases_and_capacity(debug):
    model, params = debug
    jeng, teng = _engines(model, params, hot_set=2)
    for eng in (jeng, teng):
        assert eng.bind_adapter(1, 101) == 1
        assert eng.bind_adapter(2, 102) == 2
        eng.put([1, 2], [PROMPTS[0][:5], PROMPTS[1]])
        with pytest.raises(AdapterCapacityError if eng is teng else JaxCapacityError) as err:
            eng.bind_adapter(3, 103)  # both slots leased
        assert err.value.details == {"adapter_id": 103, "hot_slots": 2, "leased_slots": 2}
        eng.flush(1)
        assert eng.lora_store.slot_of(1) == 0
        assert eng.bind_adapter(3, 103) == 1  # evicts 101, the only unleased slot
        assert eng.lora_store.hot_set() == [102, 103]
        assert eng.lora_store.slot_of(2) == 2
    assert teng.lora_store.stats() == jeng.lora_store.stats()
    a_j, b_j, s_j = jeng.lora_store.slabs()
    a_t, b_t, s_t = teng.lora_store.slabs()
    assert np.array_equal(np.asarray(s_j), s_t.numpy())
    for site in a_t:
        assert np.array_equal(np.asarray(a_j[site]), a_t[site].numpy())
        assert np.array_equal(np.asarray(b_j[site]), b_t[site].numpy())


def test_int8_moe_lora_matches_jax():
    model, params = _jax("mixtral-debug", seed=1)
    jeng, teng = _engines(model, params, mode="int8", port_params="jax")  # the JAX carriers
    outs = []
    for eng in (jeng, teng):
        eng.bind_adapter(1, 102)
        eng.bind_adapter(3, 101)
        first = eng.put([1, 2], [PROMPTS[0].astype(np.int32), PROMPTS[1].astype(np.int32)])
        mixed = eng.put([1, 2, 3], [[5], [6], PROMPTS[2].astype(np.int32)])
        burst = eng.decode_burst([1, 2, 3], [[7], [8], [9]], 4)
        outs.append((first, mixed, burst))
    for want, got in zip(outs[0][:2], outs[1][:2]):
        assert np.abs(got - want).max() / np.abs(want).max() <= 1e-5
    np.testing.assert_array_equal(outs[1][2], outs[0][2])
    assert teng.params["layers"]["wq"].scheme == "int8"


def test_adapter_api_surface(debug):
    """The engine's adapter queries answer as the JAX engine's; adopting a
    publication without a publish root raises as the JAX engine does; an
    engine with LoRA off refuses adapter routing."""
    model, params = debug
    jeng, teng = _engines(model, params)
    for eng in (jeng, teng):
        assert eng.knows_adapter(101) and not eng.knows_adapter(999)
        assert not eng.has_adapter(101)
        eng.bind_adapter(1, 101)
        assert eng.has_adapter(101)
        eng.prefetch_adapter(102)  # prefetch is off in this config: a no-op
    assert teng.lora_store.stats() == jeng.lora_store.stats()
    for eng in (jeng, teng):
        with pytest.raises(ValueError, match="no publish_root configured"):
            eng.adopt_adapter(101)
    teng.destroy()
    assert teng.lora_store is None
    _, off = _engines(model, params, lora=False)
    assert off.lora_store is None and off.bind_adapter(1, None) == 0
    with pytest.raises(RuntimeError, match="LoRA serving"):
        off.bind_adapter(1, 101)
    with pytest.raises(RuntimeError, match="LoRA serving is disabled"):
        off.register_adapter(101, {}, alpha=1.0)
