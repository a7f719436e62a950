"""The plain versions of the port's K4 and K5 kernels vs the JAX
package's Pallas kernels, run in interpret mode on the CPU, and the
tile-layout integers.

- ``quant_matmul_ref`` against ``_qmm_pallas(..., interpret=True)`` (the
  TPU ``_qmm_kernel``) for int8, fp8 and fp6 carriers: with an fp32
  ``dequant_dtype`` within 1e-5 relative (both see the same fp32 weights
  and sum in another order), with bf16 x and ``dequant_dtype`` within 2
  units of ``row_scaled_err`` (both round the same bf16 weights; the
  outputs are bf16 on both sides, at most one rounding apart each).
- ``gmm_ref`` / ``gmm_quant_ref`` against ``gmm`` / ``gmm_quant`` in
  interpret mode on the same tile-aligned layout, an expert without rows
  among the groups, fp32, within 1e-5 relative; the tail tiles are zero
  on both sides, and a ``used_tiles`` count changes nothing.
- ``tile_layout`` and ``pad_groups_to_tiles`` give the JAX functions'
  integers; on CPU tensors the wrappers take the plain versions and count
  no launch.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepspeed_tpu.inference.quantization.quantization import (
    _quantize_grouped as jax_quantize_grouped)
from deepspeed_tpu.ops.pallas import grouped_matmul as jgm
from deepspeed_tpu.ops.pallas.fused_quant_matmul import _qmm_pallas
from deepspeed_tpu_torch.models.convert import carrier_from_jax
from deepspeed_tpu_torch.ops.kernels import grouped_matmul as tgm
from deepspeed_tpu_torch.ops.kernels.flash_attention import row_scaled_err
from deepspeed_tpu_torch.ops.kernels.fused_quant_matmul import quant_matmul, quant_matmul_ref

torch.set_num_threads(1)  # the suite runs in parallel worker processes

SCHEMES = ("int8", "fp8", "fp6")
RTOL = 1e-5


def _carriers(rng, shape, scheme, group):
    """(JAX carrier, the port's same carrier) of a random weight."""
    w = rng.randn(*shape).astype(np.float32) * 0.1
    jw = jax_quantize_grouped(jnp.asarray(w), scheme, group, dequant_dtype=jnp.float32)
    return jw, carrier_from_jax(jw)


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return np.abs(np.asarray(got, np.float32) - want).max() / np.abs(want).max()


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("M,K,N,group", [(8, 128, 256, 64), (37, 256, 128, 128),
                                         (1, 64, 512, 512)])
def test_quant_matmul_ref_matches_pallas_fp32(scheme, M, K, N, group):
    rng = np.random.RandomState(M + K + N)
    jw, tw = _carriers(rng, (K, N), scheme, group)
    x = rng.randn(M, K).astype(np.float32)
    want = _qmm_pallas(jnp.asarray(x), jw.values, jw.scales, scheme, jnp.float32,
                       jnp.float32, interpret=True)
    assert want is not None  # the kernel ran, not the jnp fallback
    got = quant_matmul_ref(torch.from_numpy(x), tw.values, tw.scales, scheme, torch.float32)
    assert got.dtype == torch.float32 and tuple(got.shape) == (M, N)
    assert _rel(got.numpy(), want) <= RTOL


@pytest.mark.parametrize("scheme", SCHEMES)
def test_quant_matmul_ref_matches_pallas_bf16(scheme):
    rng = np.random.RandomState(7)
    M, K, N = 16, 256, 256
    jw, tw = _carriers(rng, (K, N), scheme, 128)
    x = rng.randn(M, K).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    want = _qmm_pallas(jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16), jw.values,
                       jw.scales, scheme, jnp.bfloat16, jnp.bfloat16, interpret=True)
    got = quant_matmul(xb, tw.values, tw.scales, scheme)  # CPU: the plain version
    assert got.dtype == torch.bfloat16
    err = row_scaled_err(got, torch.from_numpy(np.asarray(want, np.float32)))
    assert err <= 2.0, err


def _layout(sizes, tm, K, rng):
    """Rows sorted by expert and placed by the JAX ``pad_groups_to_tiles``
    → (x padded [Mp, K] fp32 numpy, tile_experts int32 numpy)."""
    sizes = np.asarray(sizes, np.int32)
    n = int(sizes.sum())
    dst, te, Mp = jgm.pad_groups_to_tiles(jnp.asarray(sizes), n, tm)
    xp = np.zeros((Mp, K), np.float32)
    xp[np.asarray(dst)] = rng.randn(n, K).astype(np.float32)
    return xp, np.array(te)


@pytest.mark.parametrize("sizes,tm", [((5, 0, 17, 3), 8), ((16,), 16), ((1, 9, 0, 0), 8)])
def test_gmm_ref_matches_pallas(sizes, tm):
    rng = np.random.RandomState(len(sizes) + tm)
    K, N = 64, 128
    xp, te = _layout(sizes, tm, K, rng)
    w = rng.randn(len(sizes), K, N).astype(np.float32)
    want = np.asarray(jgm.gmm(jnp.asarray(xp), jnp.asarray(w), jnp.asarray(te), tm, 512, 256,
                              True))
    before = tgm.gmm.launches
    got = tgm.gmm(torch.from_numpy(xp), torch.from_numpy(w), torch.from_numpy(te), tm)
    assert tgm.gmm.launches == before  # the CPU takes the plain version
    assert _rel(got.numpy(), want) <= RTOL
    used = tgm.used_tiles(torch.tensor(sizes), tm)
    np.testing.assert_array_equal(
        tgm.gmm_ref(torch.from_numpy(xp), torch.from_numpy(w), torch.from_numpy(te), tm,
                    used).numpy(), got.numpy())
    assert not got[int(used) * tm:].any()


@pytest.mark.parametrize("scheme", SCHEMES)
def test_gmm_quant_ref_matches_pallas(scheme):
    rng = np.random.RandomState(11)
    sizes, tm, K, N = (6, 0, 13, 2), 8, 128, 128
    xp, te = _layout(sizes, tm, K, rng)
    jw, tw = _carriers(rng, (len(sizes), K, N), scheme, 32)
    assert jgm.gmm_quant_supported(jw.values, jw.scales, scheme)
    assert tgm.gmm_quant_supported(tw.values, tw.scales, scheme)
    want = np.asarray(jgm.gmm_quant(jnp.asarray(xp), jw.values, jw.scales, jnp.asarray(te),
                                    scheme, jnp.float32, tm, 512, 256, True))
    before = tgm.gmm_quant.launches
    got = tgm.gmm_quant(torch.from_numpy(xp), tw.values, tw.scales, torch.from_numpy(te),
                        scheme, torch.float32, tm)
    assert tgm.gmm_quant.launches == before
    assert _rel(got.numpy(), want) <= RTOL


@pytest.mark.parametrize("sizes,tm", [((5, 0, 17, 3), 8), ((0, 0, 0, 40), 16),
                                      ((3, 1, 4, 1, 5, 9, 2, 6), 16), ((2, 0), 64)])
def test_tile_layout_integers(sizes, tm):
    n = int(sum(sizes))
    js = jnp.asarray(np.asarray(sizes, np.int32))
    ts = torch.tensor(sizes, dtype=torch.int64)
    jstarts, jte, jmp = jgm.tile_layout(js, n, tm)
    starts, te, mp = tgm.tile_layout(ts, n, tm)
    assert mp == jmp
    np.testing.assert_array_equal(starts.numpy(), np.asarray(jstarts))
    np.testing.assert_array_equal(te.numpy(), np.asarray(jte))
    jdst, jte2, _ = jgm.pad_groups_to_tiles(js, n, tm)
    dst, te2, _ = tgm.pad_groups_to_tiles(ts, n, tm)
    np.testing.assert_array_equal(dst.numpy(), np.asarray(jdst))
    np.testing.assert_array_equal(te2.numpy(), np.asarray(jte2))
    assert int(tgm.used_tiles(ts, tm)) == sum(-(-s // tm) for s in sizes)


def test_carrier_checks():
    """What the kernels refuse is refused before any launch (the shape
    checks run on the host; CPU carriers stand in for the card's)."""
    from deepspeed_tpu_torch.ops.kernels.fused_quant_matmul import check_carriers
    rng = np.random.RandomState(0)
    _, tw = _carriers(rng, (32, 64), "fp6", 32)
    cpu = torch.device("cpu")
    assert check_carriers(tw.values, tw.scales, "fp6", cpu, stacked=False) == (32, 64, 2)
    with pytest.raises(TypeError):
        check_carriers(tw.values.view(torch.int8), tw.scales, "fp6", cpu, stacked=False)
    with pytest.raises(ValueError):
        check_carriers(tw.values, tw.scales, "fp6", cpu, stacked=True)
    with pytest.raises(ValueError):
        check_carriers(tw.values[:, :45].contiguous(), tw.scales, "fp6", cpu, stacked=False)
    with pytest.raises(ValueError):
        check_carriers(tw.values.t().contiguous().t(), tw.scales, "fp6", cpu, stacked=False)
