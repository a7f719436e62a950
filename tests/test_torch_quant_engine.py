"""The port's ragged engine serving MoE and weight-only quantized models
vs the JAX package's engine, fp32 on the CPU, the same weights on both
sides (the JAX tree through ``params_from_jax``).

- ``mixtral-debug`` unquantized: last-token logits within 2e-4 (the
  bound the JAX package holds its engine to against its dense forward,
  ``test_inference_v2.py``), and equal greedy streams when each engine's
  ``DynamicSplitFuseScheduler`` serves the same requests in lockstep.
- ``debug`` and ``mixtral-debug`` under int8, fp8 and fp6: the port's
  engine given the JAX engine's own resident carriers (a tree of JAX
  ``QuantizedWeight`` leaves, converted leaf by leaf and kept as they
  are) gives the JAX quantized engine's logits within 1e-5 relative to
  their max-abs, for a prefill put, a mixed put and a decode burst: both
  dequantize the same carriers and take plain matmuls on the CPU.
- The port quantizing the raw tree itself makes the JAX package's eager
  ``_quantize_grouped`` carriers (``test_torch_quantization.py``). The
  JAX engine quantizes under ``jax.jit``, where XLA turns ``absmax /
  fmax`` into ``absmax * (1 / fmax)``: some scales sit one fp32 rounding
  apart, and at a rounding boundary an fp6 code moves. Against the JAX
  engine the port's self-quantized logits are then within 1e-4 relative.
- Placement keeps the carriers: ``float8_e4m3fn`` values stay fp8 (a
  cast of every floating leaf would destroy them), the resident bytes
  fall below half of the fp32 tree, and ``init_quantized_params`` draws
  a servable quantized tree directly.
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
from deepspeed_tpu.models import build_llama
from deepspeed_tpu_torch.inference.quantization import QuantizedWeight, quantized_bytes
from deepspeed_tpu_torch.inference.v2 import (DSStateManagerConfig, DynamicSplitFuseScheduler,
                                              InferenceEngineV2, RaggedInferenceEngineConfig)
from deepspeed_tpu_torch.models import LlamaConfig, params_from_jax
from deepspeed_tpu_torch.models.llama import (count_params, init_params,
                                              init_quantized_params, llama_config)

SM = dict(max_ragged_batch_size=32, max_ragged_sequence_count=4, max_tracked_sequences=4,
          max_context=64)
PROMPTS = [(np.arange(11) * 7 + 3) % 120, (np.arange(4) * 5 + 1) % 120,
           (np.arange(17) * 3 + 2) % 120]
MAX_NEW = [9, 12, 6]
SCHEMES = ("int8", "fp8", "fp6")


def _jax(preset, seed=0):
    model = build_llama(preset, remat=False)
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    return model, jax.tree.map(np.asarray, params)


def _jax_engine(model, params, mode="none"):
    return JaxEngine(model=model, config=JaxCfg(kv_block_size=8, state_manager=JaxSM(**SM),
                                                quantization={"quantization_mode": mode}),
                     params=params, dtype=jnp.float32)


def _port_engine(model, params, mode="none"):
    return InferenceEngineV2(LlamaConfig(**dataclasses.asdict(model.config)),
                             RaggedInferenceEngineConfig(
                                 kv_block_size=8, state_manager=DSStateManagerConfig(**SM),
                                 quantization={"quantization_mode": mode}),
                             params=params, dtype=torch.float32, device="cpu")


def _drive(jeng, teng):
    """A prefill put, a mixed put (decodes and a fresh prompt) and a
    4-step decode burst on both engines → (logit pairs, burst pair)."""
    toks = [p.astype(np.int32) for p in PROMPTS]
    pairs = [(eng.put([1, 2], toks[:2]), ) for eng in (jeng, teng)]
    nxt = [[int(np.argmax(r))] for r in pairs[0][0]]
    for eng, out in zip((jeng, teng), pairs):
        out += (eng.put([1, 2, 3], nxt + [toks[2]]),)
    bursts = [eng.decode_burst([1, 2], [[5], [6]], 4) for eng in (jeng, teng)]
    for eng in (jeng, teng):
        for uid in (1, 2, 3):
            eng.flush(uid)
    return list(zip(pairs[0], pairs[1])), bursts


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.fixture(scope="module")
def mixtral():
    model, params = _jax("mixtral-debug")
    return model, params, _jax_engine(model, params), _port_engine(model,
                                                                    params_from_jax(params))


def test_moe_engine_logits_match_jax(mixtral):
    _, _, jeng, teng = mixtral
    logits, bursts = _drive(jeng, teng)
    for want, got in logits:
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(bursts[1], bursts[0])
    assert teng.free_blocks == jeng.free_blocks


@pytest.mark.parametrize("max_burst", [1, 4])
def test_moe_greedy_streams_identical(mixtral, max_burst):
    _, _, jeng, teng = mixtral
    free0 = teng.free_blocks
    scheds = [cls(eng, token_budget=16, max_burst=max_burst)
              for cls, eng in ((JaxSched, jeng), (DynamicSplitFuseScheduler, teng))]
    for s in scheds:
        for uid, (p, n) in enumerate(zip(PROMPTS, MAX_NEW)):
            s.add_request(100 + uid, p.astype(np.int32), max_new_tokens=n)
    steps = 0
    while scheds[0].has_work or scheds[1].has_work:
        assert scheds[1].step() == scheds[0].step()
        assert teng.free_blocks == jeng.free_blocks
        steps += 1
        assert steps < 200
    got = {u: list(r.generated) for u, r in scheds[1].requests.items()}
    assert got == {u: list(r.generated) for u, r in scheds[0].requests.items()}
    assert [len(got[100 + i]) for i in range(3)] == MAX_NEW
    assert teng.free_blocks == free0


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("preset", ["debug", "mixtral-debug"])
def test_quantized_engine_matches_jax(preset, scheme):
    model, params = _jax(preset, seed=1)
    jeng = _jax_engine(model, params, scheme)
    converted = params_from_jax(jeng.params)  # the JAX engine's own carriers
    teng = _port_engine(model, converted, scheme)
    for name in ("wq", "wo"):
        a, b = converted["layers"][name], teng.params["layers"][name]
        assert isinstance(b, QuantizedWeight) and b.values is a.values  # kept, not redone
    logits, bursts = _drive(jeng, teng)
    for want, got in logits:
        assert _rel(got, want) <= 1e-5
    np.testing.assert_array_equal(bursts[1], bursts[0])

    # the port quantizing the raw tree itself (eager carriers, see above)
    own = _port_engine(model, params_from_jax(params), scheme)
    logits, _ = _drive(_jax_engine(model, params, scheme), own)
    for want, got in logits:
        assert _rel(got, want) <= 1e-4
    raw = sum(np.asarray(x).nbytes for x in jax.tree.leaves(params))
    assert quantized_bytes(own.params) == own.quantized_bytes < 0.5 * raw
    wq = own.params["layers"]["wq"]
    assert wq.values.dtype == {"int8": torch.int8, "fp8": torch.float8_e4m3fn,
                               "fp6": torch.uint8}[scheme]
    assert own.params["layers"]["input_norm"].dtype == torch.float32


@pytest.mark.parametrize("scheme", SCHEMES)
def test_init_quantized_params_serves(scheme):
    cfg = llama_config("mixtral-debug")
    q = init_quantized_params(cfg, scheme, device="cpu", dtype=torch.float32,
                              generator=torch.Generator().manual_seed(0))
    dense = init_params(cfg, "cpu", torch.float32, torch.Generator().manual_seed(0))
    assert count_params(q) == count_params(dense)
    for name in ("experts_w1", "experts_w2", "gate_wg", "wk"):
        assert isinstance(q["layers"][name], QuantizedWeight), name
    assert isinstance(q["embed_tokens"], QuantizedWeight)
    eng = InferenceEngineV2(cfg, RaggedInferenceEngineConfig(
        kv_block_size=8, state_manager=DSStateManagerConfig(**SM),
        quantization={"quantization_mode": scheme}), dtype=torch.float32, device="cpu")
    assert isinstance(eng.params["layers"]["experts_w3"], QuantizedWeight)
    toks = eng.put([1], [PROMPTS[0].astype(np.int32)], sample="greedy")
    burst = eng.decode_burst([1], [toks], 3)
    assert burst.shape == (3, 1) and (0 <= burst).all() and (burst < cfg.vocab_size).all()


def test_unknown_quantization_mode_raises():
    with pytest.raises(ValueError, match="quantization_mode"):
        InferenceEngineV2("debug", RaggedInferenceEngineConfig(
            quantization={"quantization_mode": "int4"}), dtype=torch.float32, device="cpu")
