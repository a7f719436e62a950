"""The port's weight-only quantization vs the JAX package's, bit for bit.

- fp6 e3m2 codes: decode of all 64 codes, encode over a sweep of
  magnitudes (every code's value, every midpoint between neighbours,
  where round-half-even decides, and values past the 28 clip), and
  pack/unpack, equal to ``deepspeed_tpu/ops/fp_quantizer/quantize.py``.
- ``_quantize_grouped``: int8, fp8 and fp6 carriers and scales equal byte
  for byte at last dims 8 (the Mixtral router's group), 64, 128, 1024 and
  500, and a last dim with no legal fp6 group falls through unchanged on
  both sides; the decoded weights are equal too.
- ``quantize_params_tree`` over a whole ``mixtral-debug`` serving tree
  equals the JAX package's (eager) on every leaf, and a JAX tree of
  ``QuantizedWeight`` leaves converts to the port's carriers unchanged.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.inference.quantization.quantization import (
    QuantizedWeight as JaxQW, _quantize_grouped as jax_quantize_grouped,
    quantize_params_tree as jax_quantize_params_tree)
from deepspeed_tpu.models import build_llama
from deepspeed_tpu.ops.fp_quantizer import quantize as jq
from deepspeed_tpu_torch.inference.quantization.quantization import (
    QuantizedWeight, _pick_group, _quantize_grouped, quantize_params_tree,
    quantized_bytes)
from deepspeed_tpu_torch.models import params_from_jax
from deepspeed_tpu_torch.ops.fp_quantizer import quantize as tq

torch.set_num_threads(1)  # the suite runs in parallel worker processes

SCHEMES = ("int8", "fp8", "fp6")


def _bytes(t):
    """A carrier's raw bytes (fp8 through a uint8 view) as numpy."""
    if isinstance(t, torch.Tensor):
        return (t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t).numpy()
    a = np.asarray(t)
    return a.view(np.uint8) if a.dtype.name == "float8_e4m3fn" else a


def _f32_bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


def test_e3m2_decode_all_codes():
    codes = np.arange(64, dtype=np.uint8)
    want = np.asarray(jq._decode_e3m2(jnp.asarray(codes)))
    got = tq._decode_e3m2(torch.from_numpy(codes)).numpy()
    np.testing.assert_array_equal(_f32_bits(got), _f32_bits(want))


def test_e3m2_encode_sweep_with_ties():
    values = np.asarray(jq._decode_e3m2(jnp.arange(64, dtype=jnp.uint8)))
    pos = np.sort(np.unique(np.abs(values)))
    mids = (pos[:-1] + pos[1:]) / 2  # exact in fp32: round-half-even decides
    x = np.concatenate([np.linspace(-40, 40, 40001), values, mids, -mids,
                        np.array([0.0, -0.0, 28.0, 29.0, -1e6, 1e-9])]).astype(np.float32)
    want = np.asarray(jq._encode_e3m2(jnp.asarray(x)))
    got = tq._encode_e3m2(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


def test_fp6_pack_unpack():
    codes = np.random.RandomState(0).randint(0, 64, (5, 3, 32)).astype(np.uint8)
    packed = tq.pack_fp6(torch.from_numpy(codes))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jq.pack_fp6(jnp.asarray(codes))))
    np.testing.assert_array_equal(tq.unpack_fp6(packed).numpy(), codes)
    with pytest.raises(ValueError):
        tq.pack_fp6(torch.zeros(2, 6, dtype=torch.uint8))
    with pytest.raises(ValueError):
        tq.unpack_fp6(torch.zeros(2, 4, dtype=torch.uint8))


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("last", [8, 64, 128, 1024, 500, 6])
def test_grouped_carriers_byte_for_byte(scheme, last):
    rng = np.random.RandomState(last)
    x = (rng.randn(2, 24, last) * rng.choice([0.02, 1.0, 40.0], (2, 24, 1))).astype(np.float32)
    x[0, 0] = 0.0  # an all-zero group takes scale 1.0
    want = jax_quantize_grouped(jnp.asarray(x), scheme, 512, dequant_dtype=jnp.float32)
    got = _quantize_grouped(torch.from_numpy(x), scheme, 512, dequant_dtype=torch.float32)
    if not isinstance(want, JaxQW):  # fp6 at last dim 6: no multiple-of-4 group
        assert scheme == "fp6" and _pick_group(last, 512, 4) is None
        assert torch.equal(got, torch.from_numpy(x))
        return
    assert isinstance(got, QuantizedWeight) and got.layout == "grouped"
    assert tuple(got.values.shape) == want.values.shape
    assert got.values.dtype == {"int8": torch.int8, "fp8": torch.float8_e4m3fn,
                                "fp6": torch.uint8}[scheme]
    np.testing.assert_array_equal(_bytes(got.values), _bytes(want.values))
    np.testing.assert_array_equal(_f32_bits(got.scales.numpy()), _f32_bits(want.scales))
    np.testing.assert_array_equal(_f32_bits(got.dequantized(torch.float32).numpy()),
                                  _f32_bits(want.dequantized(jnp.float32)))
    assert got.nbytes() == want.nbytes()


@pytest.fixture(scope="module")
def mixtral_tree():
    model = build_llama("mixtral-debug", remat=False)
    params = model.init(jax.random.PRNGKey(3), jnp.zeros((1, 8), jnp.int32))["params"]
    return jax.tree.map(np.asarray, params)


def _walk(a, b, name=""):
    if isinstance(a, dict):
        assert set(a) == set(b), name
        for k in a:
            yield from _walk(a[k], b[k], f"{name}.{k}")
    else:
        yield name, a, b


@pytest.mark.parametrize("scheme", SCHEMES)
def test_params_tree_and_conversion(mixtral_tree, scheme):
    """The port quantizing the converted tree equals the JAX package's
    eager quantization converted by ``params_from_jax``, leaf for leaf."""
    jtree = jax_quantize_params_tree(jax.tree.map(jnp.asarray, mixtral_tree), scheme,
                                     dequant_dtype=jnp.float32)
    converted = params_from_jax(jtree)
    ours = quantize_params_tree(params_from_jax(mixtral_tree), scheme,
                                dequant_dtype=torch.float32)
    n_carriers = 0
    for name, a, b in _walk(converted, ours):
        assert type(a) is type(b), name
        if isinstance(a, QuantizedWeight):
            n_carriers += 1
            assert a.scheme == b.scheme == scheme and a.shape == b.shape, name
            np.testing.assert_array_equal(_bytes(a.values), _bytes(b.values), err_msg=name)
            np.testing.assert_array_equal(_f32_bits(a.scales.numpy()),
                                          _f32_bits(b.scales.numpy()), err_msg=name)
        else:  # norm scales: cast, not quantized
            assert a.dtype == b.dtype == torch.float32 and torch.equal(a, b), name
    # embed, head, q/k/v/o, router and three expert stacks
    assert n_carriers == 10
    router = ours["layers"]["gate_wg"]
    assert router.shape[-1] == 4 and router.scales.shape[-1] == 1  # one group of E
    raw = sum(np.asarray(x).nbytes for x in jax.tree.leaves(mixtral_tree))
    assert quantized_bytes(ours) < 0.5 * raw
