"""The plain versions of K5's backward kernels in the PyTorch port vs the
JAX package, fp32 on the CPU, inputs made with numpy:

- ``gmm_dw_ref`` against the TPU kernel ``_gmm_dw_raw`` in interpret mode
  and against ``jax.grad`` through ``ops/grouped_gemm.grouped_gemm``
  (``lax.ragged_dot``) in the expert weights;
- ``gmm_transposed_ref`` (``gmm``'s input gradient) against ``jax.grad``
  of the same in the rows;
- ``gmm_quant_dx_ref`` for int8, fp8 and fp6 carriers (the same bytes on
  both sides) against ``_gmm_quant_dx_raw`` in interpret mode and against
  ``jax.grad`` through ``_ragged_qdot`` (the frozen-base VJP);

over layouts with an empty expert, with every row on one expert, and with
``used_tiles`` below the tile count (the port then ignores the tiles past
it, garbage and all). Tolerance: the largest difference within 1e-5 of
the largest magnitude (fp32 sums in another order), and each comparison
must reject the port's output with one tile zeroed (its error then
reads 1e-2 or more)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu.ops.grouped_gemm as jgg
from deepspeed_tpu.inference.quantization.quantization import (
    _quantize_grouped as jax_quantize_grouped)
from deepspeed_tpu.ops.pallas import grouped_matmul as jgm
from deepspeed_tpu_torch.models.convert import carrier_from_jax
from deepspeed_tpu_torch.ops.kernels import grouped_matmul as gm

torch.set_num_threads(1)  # the suite runs in parallel worker processes

RTOL = 1e-5
CASES = {  # name: (rows per expert, K, N, tm)
    "empty_expert": ((5, 0, 17, 9), 64, 48, 8),
    "one_expert": ((0, 0, 30, 0), 32, 64, 16),
    "every_expert": ((8, 3, 12, 1, 7), 48, 32, 8),
}


def _err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def _check(got, want, tile):
    """``got`` within RTOL of ``want``, and not with ``tile`` (an index
    into ``got``) zeroed."""
    bad = np.array(got, copy=True)
    bad[tile] = 0
    err = _err(got, want)
    assert err <= RTOL and _err(bad, want) >= 1e-2, (err, _err(bad, want))


def _layout(sizes, K, N, tm, seed):
    """Group-sorted rows and their tile layout on both sides →
    (xs [T, K], gs [T, N], sizes, dst, te, Mp)."""
    rng = np.random.RandomState(seed)
    T = int(sum(sizes))
    xs = rng.randn(T, K).astype(np.float32)
    gs = rng.randn(T, N).astype(np.float32)
    dst, te, Mp = gm.pad_groups_to_tiles(torch.tensor(sizes), T, tm)
    jdst, jte, jMp = jgm.pad_groups_to_tiles(jnp.asarray(sizes, jnp.int32), T, tm)
    np.testing.assert_array_equal(dst.numpy(), np.asarray(jdst))
    np.testing.assert_array_equal(te.numpy(), np.asarray(jte))
    assert Mp == jMp
    return xs, gs, np.asarray(sizes, np.int32), dst.long(), te, Mp


def _pad(rows, dst, Mp):
    out = torch.zeros((Mp, rows.shape[1]), dtype=torch.float32)
    out[dst] = torch.from_numpy(rows)
    return out


def _busiest(sizes):
    return int(np.argmax(sizes))


@pytest.mark.parametrize("case", sorted(CASES))
def test_dw_matches_interpret_kernel_and_ragged_grad(case):
    sizes, K, N, tm = CASES[case]
    E = len(sizes)
    xs, gs, sz, dst, te, Mp = _layout(sizes, K, N, tm, 1)
    xp, dyp = _pad(xs, dst, Mp), _pad(gs, dst, Mp)
    got = gm.gmm_dw_ref(xp, dyp, te, E, tm).numpy()
    for e, n in enumerate(sizes):
        if n == 0:
            assert not got[e].any()
    tile = (_busiest(sizes), slice(0, 8), slice(0, 8))
    kernel = jgm._gmm_dw_raw(jnp.asarray(xp.numpy()), jnp.asarray(dyp.numpy()),
                             jnp.asarray(te.numpy()), E, K, N, interpret=True)
    _check(got, kernel, tile)
    w = np.random.RandomState(2).randn(E, K, N).astype(np.float32)
    dw = jax.grad(lambda w_: (jgg.grouped_gemm(jnp.asarray(xs), w_, jnp.asarray(sz))
                              * jnp.asarray(gs)).sum())(jnp.asarray(w))
    _check(got, dw, tile)


@pytest.mark.parametrize("case", sorted(CASES))
def test_dw_ignores_tiles_past_used(case):
    sizes, K, N, tm = CASES[case]
    E = len(sizes)
    xs, gs, sz, dst, te, Mp = _layout(sizes, K, N, tm, 3)
    xp, dyp = _pad(xs, dst, Mp), _pad(gs, dst, Mp)
    used = gm.used_tiles(torch.tensor(sizes), tm)
    assert int(used) < Mp // tm
    want = gm.gmm_dw_ref(xp, dyp, te, E, tm).numpy()
    n_used = int(used) * tm
    xp[n_used:], dyp[n_used:] = 7.0, -3.0  # rows past the used tiles: never read
    got = gm.gmm_dw_ref(xp, dyp, te, E, tm, used).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_dx_of_gmm_matches_ragged_grad(case):
    sizes, K, N, tm = CASES[case]
    E = len(sizes)
    xs, gs, sz, dst, te, Mp = _layout(sizes, K, N, tm, 4)
    w = np.random.RandomState(5).randn(E, K, N).astype(np.float32)
    used = gm.used_tiles(torch.tensor(sizes), tm)
    got = gm.gmm_transposed_ref(_pad(gs, dst, Mp), torch.from_numpy(w), te, tm, used)
    assert not got[int(used) * tm:].any()
    dx = jax.grad(lambda x_: (jgg.grouped_gemm(x_, jnp.asarray(w), jnp.asarray(sz))
                              * jnp.asarray(gs)).sum())(jnp.asarray(xs))
    rows = got[dst].numpy()
    start = int(np.cumsum(sizes)[_busiest(sizes)] - sizes[_busiest(sizes)])
    _check(rows, dx, slice(start, start + min(tm, max(sizes))))


@pytest.mark.parametrize("scheme", ["int8", "fp8", "fp6"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_quant_dx_matches_interpret_kernel_and_frozen_base_grad(scheme, case):
    sizes, K, N, tm = CASES[case]
    E = len(sizes)
    xs, gs, sz, dst, te, Mp = _layout(sizes, K, N, tm, 6)
    w = np.random.RandomState(7).randn(E, K, N).astype(np.float32) * 0.1
    jq = jax_quantize_grouped(jnp.asarray(w), scheme, 16, dequant_dtype=jnp.float32)
    tq = carrier_from_jax(jq)
    dyp = _pad(gs, dst, Mp)
    used = gm.used_tiles(torch.tensor(sizes), tm)
    got = gm.gmm_quant_dx_ref(dyp, tq.values, tq.scales, te, scheme, torch.float32, tm, used)
    assert got.shape == (Mp, K) and not got[int(used) * tm:].any()
    start = int(np.cumsum(sizes)[_busiest(sizes)] - sizes[_busiest(sizes)])
    tile = slice(start, start + min(tm, max(sizes)))
    kernel = jgm._gmm_quant_dx_raw(jnp.asarray(dyp.numpy()), jq.values, jq.scales,
                                   jnp.asarray(te.numpy()), scheme, jnp.float32, tm, 512, 256,
                                   interpret=True)
    _check(got[dst].numpy(), np.asarray(kernel)[dst.numpy()], tile)
    dx = jax.grad(lambda x_: (jgg._ragged_qdot(x_, jq.values, jq.scales, jnp.asarray(sz),
                                               scheme, jnp.dtype(jnp.float32))
                              * jnp.asarray(gs)).sum())(jnp.asarray(xs))
    _check(got[dst].numpy(), dx, tile)
