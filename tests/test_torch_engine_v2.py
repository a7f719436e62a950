"""The PyTorch port's ragged engine + scheduler vs the JAX package's.

Both engines serve the same weights (the JAX tree, converted by
``params_from_jax``) in fp32 on the CPU, each driven by its own
``DynamicSplitFuseScheduler`` in lockstep: three requests of unequal
prompt length, greedy on the device. After every step the stepped uids
and the free KV block counts must be equal; at the end the generated
streams must be identical, token for token. ``max_burst=1`` runs the
stepwise ``put`` path only; ``max_burst=4`` adds decode bursts."""

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
from deepspeed_tpu.models import build_llama
from deepspeed_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from deepspeed_tpu_torch.inference.v2 import (DSStateManagerConfig, DynamicSplitFuseScheduler,
                                              InferenceEngineV2, RaggedInferenceEngineConfig)
from deepspeed_tpu_torch.models import LlamaConfig, params_from_jax

SM = dict(max_ragged_batch_size=32, max_ragged_sequence_count=4, max_tracked_sequences=4,
          max_context=64)
PRESETS = {
    "debug": "debug",
    "gqa_d128": JaxLlamaConfig(vocab_size=128, hidden_size=512, intermediate_size=256,
                               num_hidden_layers=2, num_attention_heads=4,
                               num_key_value_heads=2, max_position_embeddings=128),
}
PROMPTS = [(np.arange(11) * 7 + 3) % 120, (np.arange(4) * 5 + 1) % 120,
           (np.arange(17) * 3 + 2) % 120]
MAX_NEW = [9, 12, 6]


@pytest.fixture(scope="module")
def engines():
    """One engine pair per preset, shared (every request is flushed when
    it finishes, so the pools return to empty between tests)."""
    out = {}
    for name, preset in PRESETS.items():
        model = build_llama(preset, remat=False)
        params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
        params = jax.tree.map(np.asarray, params)
        jeng = JaxEngine(model=model, config=JaxCfg(kv_block_size=8, state_manager=JaxSM(**SM)),
                         params=params, dtype=jnp.float32)
        teng = InferenceEngineV2(LlamaConfig(**dataclasses.asdict(model.config)),
                                 RaggedInferenceEngineConfig(
                                     kv_block_size=8, state_manager=DSStateManagerConfig(**SM)),
                                 params=params_from_jax(params), dtype=torch.float32,
                                 device="cpu")
        out[name] = (jeng, teng)
    return out


@pytest.mark.parametrize("preset,max_burst", [("debug", 1), ("debug", 4), ("gqa_d128", 4)])
def test_greedy_streams_identical(engines, preset, max_burst):
    jeng, teng = engines[preset]
    assert teng.attn_impl_name == "torch_gather"
    free0 = teng.free_blocks
    assert free0 == jeng.free_blocks
    scheds = [cls(eng, token_budget=16, max_burst=max_burst)
              for cls, eng in ((JaxSched, jeng), (DynamicSplitFuseScheduler, teng))]
    for s in scheds:
        for uid, (p, n) in enumerate(zip(PROMPTS, MAX_NEW)):
            s.add_request(100 + uid, p.astype(np.int32), max_new_tokens=n)
    bursts0 = teng.forward_steps
    syncs0 = (jeng.host_syncs, teng.host_syncs)
    steps = 0
    while scheds[0].has_work or scheds[1].has_work:
        assert scheds[1].step() == scheds[0].step()
        assert teng.free_blocks == jeng.free_blocks
        steps += 1
        assert steps < 200
    want = {u: list(r.generated) for u, r in scheds[0].requests.items()}
    got = {u: list(r.generated) for u, r in scheds[1].requests.items()}
    assert got == want
    assert [len(got[100 + i]) for i in range(3)] == MAX_NEW
    assert teng.free_blocks == free0
    # the same host-sync sites run as often: one packed copy each way per
    # put or burst (plus the per-burst entry-token reads)
    assert teng.host_syncs - syncs0[1] == jeng.host_syncs - syncs0[0]
    if max_burst > 1:  # bursts ran: more forwards than scheduler steps
        assert teng.forward_steps - bursts0 > steps


def test_put_logits_and_burst_match_jax(engines):
    jeng, teng = engines["debug"]
    prompts = [PROMPTS[0].astype(np.int32), PROMPTS[2].astype(np.int32)]
    want = jeng.put([7, 8], prompts)
    got = teng.put([7, 8], prompts)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    nxt = [[int(np.argmax(r))] for r in want]
    np.testing.assert_array_equal(teng.decode_burst([7, 8], nxt, 4),
                                  jeng.decode_burst([7, 8], nxt, 4))
    assert teng.query(7) == jeng.query(7)
    for uid in (7, 8):
        assert teng.rewind(uid, 2) == jeng.rewind(uid, 2)
        teng.flush(uid)
        jeng.flush(uid)
    assert teng.free_blocks == jeng.free_blocks
    with pytest.raises(KeyError):
        teng.flush(7)
