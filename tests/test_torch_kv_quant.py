"""Group-wise int8 quantization (kernel K7's plain versions) and the KV
tier's quantized handles: the port vs the JAX package.

- ``quantize_int8``/``dequantize_int8`` on CPU tensors (the plain
  versions) equal the JAX package's eager path (``use_pallas()`` false
  here) bit for bit, values and scales, from fp32 and bf16 inputs: the KV
  pool layout [L, n, bs, H, D] with groups of 64, 256, 2048 and one
  (layer, block) slab, a length that is not a group multiple (padding),
  all-zero groups, values at exactly ±127·scale, and values crafted to sit
  on k + 0.5 ties (half to even). Dequantization is bit for bit in fp32
  and bf16.
- Against the Pallas kernel in interpret mode the port is held within one
  fp32 ulp of each scale and one code of each value (XLA may fold
  ``absmax / 127`` into a product with a reciprocal inside the kernel; the
  port follows the eager path), and the count of differences is reported
  in the assertion message.
- Stochastic rounding (the TPU's hardware PRNG is not carried over) is
  held in distribution, on both packages: over 2^20 values every code is
  the floor or the ceiling of x / scale, and the mean rounding error is
  zero within 4 sigma.
- ``quantize_handle``, ``dequantize_handle``, ``slice_handle``,
  ``concat_handles`` and ``handle_nbytes`` equal the JAX functions (and
  ``split_blocks``, the tier's per-block records, equals the slices),
  ``quant_error`` (fp32) exactly and byte counts equal (the store's LRU
  budget depends on them).
- A CPU tensor takes the plain version and launches nothing.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepspeed_tpu.inference.v2.kv_tier import quant as jquant
from deepspeed_tpu.ops.pallas import quantization as jq
from deepspeed_tpu_torch.inference.v2.kv_tier import quant as tquant
from deepspeed_tpu_torch.models import kv_handle_from_jax
from deepspeed_tpu_torch.ops.kernels import quantization as tq

torch.set_num_threads(1)  # the suite runs in parallel worker processes


def _pair(x, dtype):
    """numpy fp32 ``x`` → (the JAX side's numpy array, the port's CPU tensor)
    holding the same values in ``dtype``."""
    if dtype == "bf16":
        xj = np.asarray(jnp.asarray(x, jnp.bfloat16))
        return xj, kv_handle_from_jax({"k": xj})["k"]
    return x, torch.from_numpy(x.copy())


def _ties(gs, scale):
    """A group whose absmax is 127·scale and whose other values sit at
    exact (k + 0.5)·scale ties, both signs."""
    k = np.arange(gs, dtype=np.float32) % 126
    x = (k + 0.5) * scale * np.where(np.arange(gs) % 2, -1, 1)
    x[0], x[1] = 127 * scale, -127 * scale
    return x.astype(np.float32)


def _case(name):
    rng = np.random.RandomState(CASES.index(name))
    if name.startswith("pool_g"):  # [L, n, bs, H, D], slab 32 * 8 * 128 = 32768
        gs = {"pool_g64": 64, "pool_g256": 256, "pool_g2048": 2048, "pool_gslab": 32768}[name]
        return (rng.randn(2, 3, 32, 8, 128) * 3).astype(np.float32), gs
    if name == "padded":
        return (rng.randn(1000) * 5).astype(np.float32), 256
    if name == "zero_groups":
        x = (rng.randn(8, 64) * 2).astype(np.float32)
        x[[1, 4, 7]] = 0.0
        return x, 64
    if name == "exact_127":
        x = (rng.rand(4, 64) * 2 - 1).astype(np.float32)
        x[:, 3], x[:, 9] = 1.0, -1.0  # absmax 1: these are exactly ±127·scale
        return x, 64
    if name == "ties":
        return np.stack([_ties(128, 1.0), _ties(128, 2.0), _ties(128, 0.25)]), 128
    raise KeyError(name)


CASES = ("pool_g64", "pool_g256", "pool_g2048", "pool_gslab", "padded", "zero_groups",
         "exact_127", "ties")


def _bits(a):
    return np.asarray(a).view(np.int32)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case", CASES)
def test_plain_quantize_equals_jax_eager_bitwise(case, dtype):
    x, gs = _case(case)
    xj, xt = _pair(x, dtype)
    vj, sj, shj = jq.quantize_int8(xj, group_size=gs)
    vt, st, sht = tq.quantize_int8(xt, group_size=gs)
    assert tuple(sht) == tuple(shj)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(_bits(st.numpy()), _bits(np.asarray(sj, np.float32)))
    if case == "ties":  # the half-to-even contract is visible
        assert (vt.numpy()[:2, 2:] % 2 == 0).all()
    for jd, td in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        dj = np.asarray(jq.dequantize_int8(vj, sj, shj, dtype=jd).astype(jnp.float32))
        dt = tq.dequantize_int8(vt, st, sht, dtype=td)
        assert dt.dtype == td and tuple(dt.shape) == x.shape
        np.testing.assert_array_equal(_bits(dt.float().numpy()), _bits(dj))


@pytest.mark.parametrize("case", ["pool_g64", "padded", "zero_groups", "exact_127", "ties"])
def test_plain_quantize_vs_interpret_mode(case):
    x, gs = _case(case)
    vj, sj, _ = jq.quantize_int8(x, group_size=gs, interpret=True)
    vt, st, _ = tq.quantize_int8(torch.from_numpy(x), group_size=gs)
    sj = np.asarray(sj, np.float32)
    scale_ulps = np.abs(_bits(st.numpy()).astype(np.int64) - _bits(sj))
    code_steps = np.abs(vt.numpy().astype(np.int32) - np.asarray(vj, np.int32))
    msg = (f"{case}: {int((scale_ulps > 0).sum())} of {sj.size} scales and "
           f"{int((code_steps > 0).sum())} of {code_steps.size} codes differ from interpret mode")
    assert scale_ulps.max() <= 1 and code_steps.max() <= 1, msg


def _floor_ceil_and_mean(codes, scaled):
    """codes within {floor, ceil} of ``scaled`` (clipped) → (ok, mean error
    in sigmas)."""
    lo = np.clip(np.floor(scaled), -127, 127)
    hi = np.clip(np.ceil(scaled), -127, 127)
    ok = bool(np.all((codes == lo) | (codes == hi)))
    frac = scaled - np.floor(scaled)
    sigma = np.sqrt(np.sum(frac * (1 - frac))) / codes.size
    return ok, float(np.mean(codes - scaled) / sigma)


@pytest.mark.parametrize("seed", [0, 7])
def test_stochastic_rounding_in_distribution(seed):
    rng = np.random.RandomState(11)
    x = (rng.randn(512, 2048) * 0.7).astype(np.float32)  # 2^20 values
    scales = np.abs(x).max(axis=1, keepdims=True) / np.float32(127)
    scaled = (x / scales).astype(np.float64)
    vt, st, _ = tq.quantize_int8(torch.from_numpy(x), 2048, stochastic=True, seed=seed)
    vj, _, _ = jq.quantize_int8(x, 2048, stochastic=True, seed=seed)
    np.testing.assert_array_equal(st.numpy(), scales[:, 0])
    for name, codes in (("port", vt.numpy()), ("jax", np.asarray(vj))):
        ok, z = _floor_ceil_and_mean(codes.astype(np.float64), scaled)
        assert ok, f"{name}: a stochastic code is neither floor nor ceil of x / scale"
        assert abs(z) < 4.0, f"{name}: mean rounding error {z:.2f} sigma"
    # the rounding really is stochastic, and the seed moves it
    det = tq.quantize_int8(torch.from_numpy(x), 2048)[0]
    other = tq.quantize_int8(torch.from_numpy(x), 2048, stochastic=True, seed=seed + 1)[0]
    assert (vt != det).float().mean() > 0.1 and (vt != other).any()
    again = tq.quantize_int8(torch.from_numpy(x), 2048, stochastic=True, seed=seed)[0]
    assert torch.equal(vt, again)


def _rand_handle(n=3, seed=0, L=2, bs=4, H=2, D=4, scale=10.0):
    rng = np.random.default_rng(seed)
    shape = (L, n, bs, H, D)
    return {"k": (rng.standard_normal(shape) * scale).astype(np.float32),
            "v": (rng.standard_normal(shape) * scale).astype(np.float32)}


def _same(t, a):
    a = np.asarray(a)
    if t.dtype == torch.bfloat16:
        np.testing.assert_array_equal(t.view(torch.int16).numpy(), a.view(np.int16))
    else:
        assert t.numpy().dtype == a.dtype, (t.dtype, a.dtype)
        np.testing.assert_array_equal(t.numpy(), a)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("group_size", [0, 8, 16])
def test_quant_handles_equal_jax(group_size, dtype):
    h = _rand_handle(seed=group_size + 1)
    if dtype == "bf16":
        h = {k: np.asarray(jnp.asarray(v, jnp.bfloat16)) for k, v in h.items()}
    ht = kv_handle_from_jax(h)
    qj = jquant.quantize_handle(h, group_size)
    qt = tquant.quantize_handle(ht, group_size)
    assert qt["quantized"] is True and set(qt) == set(qj)
    for name in ("k", "v", "k_scales", "v_scales", "quant_error"):
        _same(qt[name], qj[name])
    assert tquant.handle_nbytes(qt) == jquant.handle_nbytes(qj)
    assert tquant.handle_nbytes(ht) == jquant.handle_nbytes(h)
    for jd, td in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        dj, dt = jquant.dequantize_handle(qj, jd), tquant.dequantize_handle(qt, td)
        for name in ("k", "v"):
            _same(dt[name], dj[name])
    # slicing and concatenation keep the format, bytes and values
    parts_j = [jquant.slice_handle(qj, i, i + 1) for i in range(3)]
    parts_t = [tquant.slice_handle(qt, i, i + 1) for i in range(3)]
    for pj, pt in zip(parts_j, parts_t):
        assert tquant.handle_nbytes(pt) == jquant.handle_nbytes(pj)
        _same(pt["quant_error"], pj["quant_error"])
    # the tier's per-block records: the slices, each contiguous, without the error
    for pj, pt in zip(parts_j, tquant.split_blocks(qt)):
        assert set(pt) == set(pj) - {"quant_error"}
        assert tquant.handle_nbytes(pt) == jquant.handle_nbytes(pj)
        for name in ("k", "v", "k_scales", "v_scales"):
            assert pt[name].is_contiguous()
            _same(pt[name], np.asarray(pj[name]))
    cj, ct = jquant.concat_handles(parts_j[1:]), tquant.concat_handles(parts_t[1:])
    assert set(ct) == set(cj)
    for name in ("k", "v", "k_scales", "v_scales"):
        _same(ct[name], np.asarray(cj[name]))
    plain = tquant.concat_handles([tquant.slice_handle(ht, 0, 1), tquant.slice_handle(ht, 2, 3)])
    assert "quantized" not in plain and plain["k"].shape[1] == 2


def test_quant_handle_edges_equal_jax():
    zero = {"k": np.zeros((2, 2, 4, 2, 4), np.float32), "v": np.zeros((2, 2, 4, 2, 4), np.float32)}
    qj, qt = jquant.quantize_handle(zero), tquant.quantize_handle(kv_handle_from_jax(zero))
    for name in ("k", "v", "k_scales", "v_scales", "quant_error"):
        _same(qt[name], qj[name])
    assert (qt["k_scales"] == 1.0).all()
    empty = {"k": np.zeros((2, 0, 4, 2, 4), np.float32), "v": np.zeros((2, 0, 4, 2, 4), np.float32)}
    qj, qt = jquant.quantize_handle(empty), tquant.quantize_handle(kv_handle_from_jax(empty))
    assert tuple(qt["k_scales"].shape) == qj["k_scales"].shape == (2, 0, 1)
    assert tquant.handle_nbytes(qt) == jquant.handle_nbytes(qj)
    with pytest.raises(ValueError, match="does not divide"):
        tquant.quantize_handle(kv_handle_from_jax(_rand_handle()), group_size=12)


def test_cpu_tensors_take_the_plain_version():
    tq.quantize_int8.launches = tq.dequantize_int8.launches = 0
    v, s, shape = tq.quantize_int8(torch.randn(4, 64), 64)
    tq.dequantize_int8(v, s, shape)
    tq.dequantize_int8_rows(v, s, torch.zeros(6, 64), torch.tensor([3, 0, 2, 1]))
    tquant.quantize_handle({"k": torch.randn(2, 1, 4, 2, 4), "v": torch.randn(2, 1, 4, 2, 4)})
    assert tq.quantize_int8.launches == 0 and tq.dequantize_int8.launches == 0


def test_dequantize_rows_writes_only_its_rows():
    x = torch.randn(3, 64)
    v, s, _ = tq.quantize_int8(x, 64)
    out = torch.full((5, 64), 7.0)
    tq.dequantize_int8_rows(v, s, out, torch.tensor([4, 0, 2]))
    want = tq.dequantize_int8_ref(v, s, torch.float32)
    assert torch.equal(out[[4, 0, 2]], want)
    assert (out[[1, 3]] == 7.0).all()
