"""The port's segmented LoRA delta (plain version and layout) vs the JAX
package's ``ops/pallas/lora_matmul.py``, on the CPU.

- The port's ``lora_delta_ref`` (what a CPU tensor takes) against JAX's
  ``lora_delta_ref`` and its Pallas kernel run in interpret mode, on the
  JAX tests' ``_rand_case`` shapes (T 13, K 16, N 24, G 4, r 3), a rank
  below the bucket (zero-padded slab columns and rows), all-base slots and
  bf16 inputs. fp32 within 1e-6 (the JAX test's own bound: the frameworks
  sum in other orders); bf16 within one bf16 ulp of each element's
  magnitude (both round the same fp32 result once, and a rounding may
  fall the other way).
- ``segment_tokens`` gives the JAX integers (order, dst, tile_groups, Mp)
  for tm 4, 8 and 16, and ``lora_layout`` puts every token in exactly one
  padded row of a tile owned by its slot, with the tiles past the used
  count empty.
- Slot 0 gives exact zeros and reads no slab (garbage in slab 0 changes
  nothing).
- Row independence, bit for bit: each row computed alone, and every
  prefix of the batch, equals the same row of the mixed batch (the JAX
  reference's ``einsum`` is not row independent on the CPU).
- A CPU tensor takes the plain version and counts no kernel launch.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepspeed_tpu.ops.pallas import lora_matmul as jlora
from deepspeed_tpu_torch.ops.kernels.lora_matmul import (apply_lora_delta, lora_delta,
                                                         lora_delta_ref, lora_layout,
                                                         segment_tokens)

torch.set_num_threads(1)  # the suite runs in parallel worker processes


def _rand_case(seed=0, T=13, K=16, N=24, G=4, r=3, bucket=None):
    """The JAX tests' case (slot 0 = base: zero slabs and scale); with
    ``bucket`` the rank is zero-padded to it, as the store pads."""
    rs = np.random.RandomState(seed)
    x = rs.randn(T, K).astype(np.float32)
    slots = rs.randint(0, G, T).astype(np.int32)
    a = rs.randn(G, K, r).astype(np.float32) * 0.1
    b = rs.randn(G, r, N).astype(np.float32) * 0.1
    scales = rs.rand(G).astype(np.float32) + 0.5
    a[0], b[0], scales[0] = 0.0, 0.0, 0.0
    if bucket:
        a = np.pad(a, ((0, 0), (0, 0), (0, bucket - r)))
        b = np.pad(b, ((0, 0), (0, bucket - r), (0, 0)))
    return x, slots, a, b, scales


CASES = {
    "rand_case": dict(),
    "rank_below_bucket": dict(seed=1, r=3, bucket=8),
    "all_base": dict(seed=2),
    "wide": dict(seed=4, T=37, K=64, N=40, G=9, r=8),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_jax_fp32(name):
    x, slots, a, b, scales = _rand_case(**CASES[name])
    if name == "all_base":
        slots[:] = 0
    args = tuple(map(jnp.asarray, (x, slots, a, b, scales)))
    want_ref = np.asarray(jlora.lora_delta_ref(*args))
    want_pallas = np.asarray(jlora.lora_delta_pallas(*args, tm=8, interpret=True))
    got = lora_delta_ref(*map(torch.from_numpy, (x, slots, a, b, scales))).numpy()
    np.testing.assert_allclose(got, want_ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, want_pallas, rtol=1e-6, atol=1e-6)
    if name == "all_base":
        assert not got.any()


def test_plain_matches_jax_bf16():
    x, slots, a, b, scales = _rand_case(seed=5, T=21, K=32, N=48, G=5, r=4)
    jargs = (jnp.asarray(x, jnp.bfloat16), jnp.asarray(slots), jnp.asarray(a, jnp.bfloat16),
             jnp.asarray(b, jnp.bfloat16), jnp.asarray(scales))
    targs = (torch.from_numpy(x).bfloat16(), torch.from_numpy(slots),
             torch.from_numpy(a).bfloat16(), torch.from_numpy(b).bfloat16(),
             torch.from_numpy(scales))
    got = lora_delta_ref(*targs)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    for want in (jlora.lora_delta_ref(*jargs), jlora.lora_delta_pallas(*jargs, tm=8,
                                                                       interpret=True)):
        want = np.asarray(want).astype(np.float32)
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
        assert (np.abs(got - want) <= ulp).all()


@pytest.mark.parametrize("tm", [4, 8, 16])
def test_segment_tokens_matches_jax(tm):
    rs = np.random.RandomState(tm)
    for slots, G in (([2, 0, 1, 2, 0, 2], 3), (rs.randint(0, 9, 37), 9),
                     ([0] * 5, 4), ([3, 3, 1], 5)):
        slots = np.asarray(slots, np.int32)
        want = jlora.segment_tokens(jnp.asarray(slots), G, tm)
        got = segment_tokens(torch.from_numpy(slots), G, tm)
        for w, g in zip(want[:3], got[:3]):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert got[3] == want[3]


@pytest.mark.parametrize("tm", [8, 16])
def test_layout_places_every_token_once(tm):
    slots = np.random.RandomState(7).randint(0, 6, 53).astype(np.int32)
    lay = lora_layout(torch.from_numpy(slots), 6, tm)
    rows, groups, used = lay.rows.numpy(), lay.tile_groups.numpy(), int(lay.used[0])
    assert sorted(rows[rows >= 0].tolist()) == list(range(53))
    assert used == sum(-(-int((slots == g).sum()) // tm) for g in range(6))
    for t in range(rows.size // tm):
        tile = rows[t * tm:(t + 1) * tm]
        if t >= used:
            assert (tile == -1).all()
        else:
            assert (slots[tile[tile >= 0]] == groups[t]).all() and (tile >= 0).any()


def test_base_slot_is_exactly_zero_and_reads_no_slab():
    x, slots, a, b, scales = _rand_case(seed=3)
    a[0], b[0], scales[0] = 7.0, -3.0, 2.0  # slot 0's slabs are never read
    got = lora_delta_ref(*map(torch.from_numpy, (x, slots, a, b, scales))).numpy()
    assert (slots == 0).any() and not got[slots == 0].any()
    assert got[slots != 0].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,K,N,G,r", [(13, 16, 24, 4, 3), (37, 4096, 1024, 9, 8)])
def test_plain_rows_bitwise_independent(dtype, T, K, N, G, r):
    x, slots, a, b, scales = (torch.from_numpy(v) for v in _rand_case(11, T, K, N, G, r))
    x, a, b = x.to(dtype), a.to(dtype), b.to(dtype)
    mixed = lora_delta_ref(x, slots, a, b, scales)
    for t in range(T):
        solo = lora_delta_ref(x[t:t + 1], slots[t:t + 1], a, b, scales)
        assert torch.equal(solo[0], mixed[t]), f"row {t} differs"
    for n in (2, 5, T - 1):
        assert torch.equal(lora_delta_ref(x[:n], slots[:n], a, b, scales), mixed[:n])


def test_cpu_tensors_take_the_plain_version():
    x, slots, a, b, scales = (torch.from_numpy(v) for v in _rand_case(6))
    before = lora_delta.launches
    y0 = torch.from_numpy(np.random.RandomState(0).randn(13, 24).astype(np.float32))
    y = y0.clone()
    out = lora_delta(x, y, a, b, scales, lora_layout(slots, 4))
    assert out is y  # in place
    assert torch.equal(y, y0 + lora_delta_ref(x, slots, a, b, scales))
    assert torch.equal(apply_lora_delta(x, slots, a, b, scales),
                       lora_delta_ref(x, slots, a, b, scales))
    assert lora_delta.launches == before
