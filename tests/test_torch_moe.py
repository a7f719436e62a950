"""The port's dropless MoE FFN vs the JAX package's, at ``mixtral-debug``
width (D=64, I=128, E=4), fp32 on the CPU, with dense and int8, fp8 and
fp6 expert stacks (the same carriers on both sides).

- ``moe_grouped_mlp`` (the card's routing and tile layout, through the
  kernels' plain versions on the CPU) against the JAX package's default
  paths: fewer rows than experts (its gathered path), an expert with no
  rows and top-1 rows over every expert (its ragged path);
- the same against the JAX Pallas branch in interpret mode
  (``grouped_gemm.FORCE_INTERPRET``, restored in ``finally``), at row
  tiles 8 and 16;
- ``dropless_moe_ffn`` with top-2 gate weights, and the router's top-k:
  ties go to the lowest expert index, as ``jax.lax.top_k`` sends them;
- ``sort_by_expert`` and ``dense_reference_mlp``.

Tolerance 1e-5 relative to the output's max-abs: both sides compute
each expert product in fp32 and differ by summation order only."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu.ops.grouped_gemm as jgg
from deepspeed_tpu.inference.quantization.quantization import (
    _quantize_grouped as jax_quantize_grouped)
from deepspeed_tpu_torch.inference.v2.model_runner import top_k
from deepspeed_tpu_torch.models.convert import carrier_from_jax
from deepspeed_tpu_torch.ops import grouped_gemm as tgg

E, D, I = 4, 64, 128
RTOL = 1e-5


def _stacks(seed, scheme):
    """(JAX stacks, the port's same stacks): gate/up [E, D, I], down [E, I, D]."""
    rng = np.random.RandomState(seed)
    ws = [rng.randn(E, D, I), rng.randn(E, D, I), rng.randn(E, I, D)]
    ws = [(w * 0.1).astype(np.float32) for w in ws]
    if scheme == "none":
        return [jnp.asarray(w) for w in ws], [torch.from_numpy(w) for w in ws]
    jw = [jax_quantize_grouped(jnp.asarray(w), scheme, 32, dequant_dtype=jnp.float32)
          for w in ws]
    return jw, [carrier_from_jax(w) for w in jw]


def _close(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= RTOL * np.abs(want).max()


CASES = {"t_lt_e": np.array([2, 0, 2], np.int32),
         "empty_expert": np.array([0, 3, 3, 0, 1, 0, 3, 1, 0, 1], np.int32),
         "every_expert": np.arange(24, dtype=np.int32) % E}


@pytest.mark.parametrize("scheme", ["none", "int8", "fp8", "fp6"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_grouped_mlp_matches_jax(scheme, case):
    idx = CASES[case]
    jw, tw = _stacks(len(idx), scheme)
    x = np.random.RandomState(1).randn(len(idx), D).astype(np.float32)
    want = jgg.moe_grouped_mlp(jnp.asarray(x), jnp.asarray(idx), *jw, E)
    _close(tgg.moe_grouped_mlp(torch.from_numpy(x), torch.from_numpy(idx), *tw, E), want)


@pytest.mark.parametrize("scheme", ["none", "int8", "fp6"])
def test_tiled_path_matches_jax_pallas(scheme):
    idx = CASES["empty_expert"]
    jw, tw = _stacks(5, scheme)
    x = np.random.RandomState(2).randn(len(idx), D).astype(np.float32)
    jgg.GMM_STATS.reset()
    jgg.FORCE_INTERPRET = True
    try:
        want = jgg.moe_grouped_mlp(jnp.asarray(x), jnp.asarray(idx), *jw, E)
    finally:
        jgg.FORCE_INTERPRET = False
    assert jgg.GMM_STATS.snapshot().get("pallas" if scheme == "none" else "pallas_quant")
    for tm in (8, 16):
        got = tgg.moe_grouped_mlp(torch.from_numpy(x), torch.from_numpy(idx), *tw, E, tm=tm)
        _close(got, want)


def test_dropless_top2_and_dense_reference():
    rng = np.random.RandomState(3)
    T, k = 9, 2
    jw, tw = _stacks(9, "none")
    x = rng.randn(T, D).astype(np.float32)
    gates = jax.nn.softmax(jnp.asarray(rng.randn(T, E).astype(np.float32)), -1)
    vals, idx = jax.lax.top_k(gates, k)
    vals = vals / jnp.maximum(vals.sum(-1, keepdims=True), 1e-9)
    want = jgg.dropless_moe_ffn(jnp.asarray(x), idx, vals, *jw, num_experts=E)
    got = tgg.dropless_moe_ffn(torch.from_numpy(x), torch.from_numpy(np.array(idx)),
                               torch.from_numpy(np.array(vals)), *tw, num_experts=E)
    _close(got, want)
    flat = np.asarray(idx)[:, 0]
    _close(tgg.dense_reference_mlp(torch.from_numpy(x), torch.from_numpy(flat), *tw),
           jgg.dense_reference_mlp(jnp.asarray(x), jnp.asarray(flat), *jw))
    with pytest.raises(NotImplementedError, match="port queue item 5"):
        tgg.dropless_moe_ffn(torch.from_numpy(x), torch.from_numpy(np.asarray(idx)),
                             torch.from_numpy(np.asarray(vals)), *tw, num_experts=E, mesh=1)


def test_top_k_ties_and_sort_by_expert():
    gates = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.4, 0.1], [0.3, 0.2, 0.3, 0.2],
                      [0.0, 0.0, 1.0, 0.0]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(gates), 2)
    tv, ti = top_k(torch.from_numpy(gates), 2)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    idx = np.array([3, 1, 1, 0, 3, 2, 1], np.int32)
    x = np.arange(7 * 2, dtype=np.float32).reshape(7, 2)
    want = jgg.sort_by_expert(jnp.asarray(x), jnp.asarray(idx), 5)
    got = tgg.sort_by_expert(torch.from_numpy(x), torch.from_numpy(idx), 5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
