"""Paged decode attention in the PyTorch port vs the JAX package.

The port's plain version ``paged_attention_ref`` (what the CUDA kernel is
held against on the card) must compute what ``xla_paged_attention`` and
the Pallas kernel (interpret mode on the CPU) compute, on the same inputs
made with numpy from a seed, in fp32. Tolerance atol 1e-5: fp32 sums taken
in another order. The CUDA kernel itself is tested in ``test_torch_gpu.py``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepspeed_tpu.ops.pallas.paged_attention import (paged_decode_attention as jax_pallas,
                                                      xla_paged_attention)
from deepspeed_tpu_torch.ops.kernels.paged_attention import (paged_attention_ref,
                                                             paged_decode_attention)

ATOL = 1e-5


def make_case(seed, T, H, Hkv, Dh, bs, NB, MB, pos, pad_rows=0):
    """Random q/pool; token t owns a private table of real blocks (no
    null block), the last ``pad_rows`` rows are pad rows (all-null table,
    position 0) as the engine packs them."""
    rng = np.random.RandomState(seed)
    q = rng.randn(T, H, Dh).astype(np.float32)
    kc = rng.randn(NB, bs, Hkv, Dh).astype(np.float32)
    vc = rng.randn(NB, bs, Hkv, Dh).astype(np.float32)
    tabs = np.stack([rng.permutation(np.arange(1, NB))[:MB] for _ in range(T)]).astype(np.int32)
    pos = np.asarray(pos, np.int32)
    if pad_rows:
        tabs[-pad_rows:] = 0
        pos[-pad_rows:] = 0
    return q, kc, vc, tabs, pos


CASES = {
    # name: (T, H, Hkv, Dh, bs, NB, MB, positions, pad rows)
    "mha_d16": (4, 4, 4, 16, 8, 12, 4, [0, 7, 8, 31], 0),
    "gqa_d16": (5, 8, 2, 16, 8, 12, 4, [0, 7, 8, 15, 0], 1),
    "gqa_d128_edges": (6, 8, 2, 128, 8, 10, 3, [0, 7, 8, 16, 23, 0], 1),
    "mha_d128_past_table": (3, 2, 2, 128, 8, 10, 2, [15, 16, 40], 0),
}


def _torch(arrs):
    return [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("name", sorted(CASES))
def test_ref_matches_xla_reference(name):
    case = make_case(0, *CASES[name])
    want = np.asarray(xla_paged_attention(*[jnp.asarray(a) for a in case]))
    got = paged_attention_ref(*_torch(case)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_ref_matches_pallas_interpret(name):
    case = make_case(1, *CASES[name])
    want = np.asarray(jax_pallas(*[jnp.asarray(a) for a in case], interpret=True))
    got = paged_attention_ref(*_torch(case)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_position_zero_attends_only_first_slot():
    q, kc, vc, tabs, pos = make_case(2, *CASES["gqa_d16"])
    got = paged_attention_ref(*_torch((q, kc, vc, tabs, pos))).numpy()
    # GQA: query head h reads KV head h // (H / Hkv)
    want = np.repeat(vc[tabs[0, 0], 0], 4, axis=0)
    np.testing.assert_allclose(got[0], want, atol=ATOL, rtol=0)


def test_wrapper_takes_plain_version_on_cpu():
    case = _torch(make_case(3, *CASES["gqa_d128_edges"]))
    before = paged_decode_attention.launches
    got = paged_decode_attention(*case)
    assert paged_decode_attention.launches == before  # no kernel launched
    torch.testing.assert_close(got, paged_attention_ref(*case), atol=0, rtol=0)
