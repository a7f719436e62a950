"""K7's quantize designs (``csrc/quantization.cu``) on the CPU: which
design a group takes, how the cluster design cuts a group, and its
arithmetic.

The CUDA kernels run only on the card. ``k7_design`` names the design
from the group size, the dtype, the group count and the alignment: a warp
a group up to 1024 values; the cluster design for aligned groups of 4097
to 65536 values in whole 8-value units, where the groups' blocks run in
one wave (4 an SM: a KV tier demotion's 64 slabs on 132 SMs); else one
block a group in two passes. The cluster design splits a group over a
thread block cluster of ``k7_cluster_size`` blocks (a power of two from 2
to 8, at most 16 values a thread below the largest cluster), block r the
r-th of equal slices of the group's 8-value units, each thread its units r
* per + t + u * 256 (``k7_slices``, as ``quant_cluster_kernel`` reads
them). For the slab of ``chip_smoke.py``'s K7 cases and for groups whose
units the cluster's slices do not divide, every value is read by exactly
one thread of one block, and no thread holds more than 32 values (its
registers).

The arithmetic is emulated over that cut: each block's maximum of |x| over
its threads' values, the group's absmax the maximum of the blocks', scale
= absmax / 127 (1 for an all-zero group) as a true division, codes
round-half-to-even of x / scale clipped at ±127. It equals the plain
version ``quantize_int8_ref`` bit for bit, and the JAX package's eager
``quantize_int8`` bit for bit (the contract the plain version holds, in
``test_torch_kv_quant.py``), in fp32 and bf16."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepspeed_tpu.ops.pallas import quantization as jq
from deepspeed_tpu_torch.models import kv_handle_from_jax
from deepspeed_tpu_torch.ops.kernels import quantization as tq

torch.set_num_threads(1)  # the suite runs in parallel worker processes

SLAB = 32 * 8 * 128  # one Mistral-7B (layer, block) slab: chip_smoke's K7 slab groups
SMS = 132            # the H100's SMs
# the slab, then groups whose 8-value units do not divide into the cluster's
# slices (8200: 1025 units over 4 blocks; 40008: 5001 over 8; 4104: 513 over
# 2), and the largest cluster group
GROUPS = (SLAB, 8200, 40008, 65536, 4104)


def k7_slices(gs):
    """The cluster design's cut of one group → [[value indices of a thread]
    for each block, thread]: block r takes the r-th of the cluster's equal
    slices of the group's 8-value units, thread t the units r * per + t + u
    * 256 below the slice's end, as ``quant_cluster_kernel`` reads them."""
    cs, units = tq.k7_cluster_size(gs), gs // 8
    per = -(-units // cs)
    out = []
    for r in range(cs):
        u0, u1 = r * per, min(units, (r + 1) * per)
        out.append([[i for unit in range(u0 + t, u1, tq.CLUSTER_THREADS)
                     for i in range(8 * unit, 8 * unit + 8)]
                    for t in range(tq.CLUSTER_THREADS)])
    return out


@pytest.mark.parametrize("gs", GROUPS)
def test_cluster_slices_cover_a_group_once(gs):
    slices = k7_slices(gs)
    cs = tq.k7_cluster_size(gs)
    assert len(slices) == cs and cs in (1, 2, 4, 8)
    assert all(len(block) == tq.CLUSTER_THREADS for block in slices)
    seen = np.zeros(gs, np.int64)
    for block in slices:
        for thread in block:
            assert len(thread) <= 32  # kUnits 8-value units
            seen[thread] += 1
    assert (seen == 1).all()
    if cs < tq.MAX_CLUSTER:
        assert max(len(t) for block in slices for t in block) <= 16


def test_cluster_sizes_and_uneven_slices():
    assert {gs: tq.k7_cluster_size(gs) for gs in GROUPS} == {
        SLAB: 8, 8200: 4, 40008: 8, 65536: 8, 4104: 2}
    for gs in (8200, 40008, 4104):  # the last block's slice is shorter
        sizes = [sum(len(t) for t in block) for block in k7_slices(gs)]
        assert sum(sizes) == gs and sizes[-1] < sizes[0]


# chip_smoke.py's K7 cases: (blocks n of [32, n, 32, 8, 128], group size)
K7_CASES = [(n, gs) for n in (1, 2, 12, 16) for gs in (SLAB, 2048)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k7_design_by_shape(dtype):
    """A demotion's slabs (n 1 or 2: 32 or 64 groups, 256 or 512 blocks)
    take the cluster design; 12 or 16 blocks' slabs (384, 512 groups) fill
    the card with one block a group and take the two-pass design, as do
    groups of 2048."""
    got = {(n, gs): tq.k7_design(gs, dtype, 32 * n * 32 * 8 * 128 // gs, SMS)
           for n, gs in K7_CASES}
    assert got == {(n, gs): "cluster" if gs == SLAB and n <= 2 else "two_pass"
                   for n, gs in K7_CASES}
    assert [tq.k7_design(gs, dtype, 1, SMS) for gs in (64, 1000, 1024)] == ["warp"] * 3
    assert [tq.k7_design(gs, dtype, 2, SMS) for gs in GROUPS] == ["cluster"] * len(GROUPS)
    assert tq.k7_design(SLAB, dtype, 66, SMS) == "cluster"   # 528 blocks: 4 an SM
    assert tq.k7_design(SLAB, dtype, 67, SMS) == "two_pass"
    assert tq.k7_design(4096, dtype, 2, SMS) == "two_pass"   # one block's group
    assert tq.k7_design(65544, dtype, 2, SMS) == "two_pass"  # past the largest cluster
    assert tq.k7_design(8196, dtype, 2, SMS) == "two_pass"   # not whole 8-value units
    assert tq.k7_design(SLAB, dtype, 2, SMS, aligned=False) == "two_pass"
    assert tq.k7_design(SLAB, torch.float16, 2, SMS) == "two_pass"
    assert tq.cluster_takes(SLAB, dtype) and not tq.cluster_takes(2048, dtype)


def cluster_quantize(groups):
    """The cluster design's arithmetic on [G, gs] (fp32 or bf16) → (int8
    codes, fp32 scales): block maxima over ``k7_slices``, their maximum,
    then the codes from each value, a zero's code 0 without a division."""
    x = groups.float()
    G, gs = x.shape
    block_max = torch.stack([torch.stack([x[:, t].abs().amax(1) if t else torch.zeros(G)
                                          for t in block]).amax(0)
                             for block in k7_slices(gs)])          # [cs, G]
    absmax = block_max.amax(0)
    scales = torch.where(absmax == 0, torch.ones_like(absmax),
                         absmax / torch.full_like(absmax, 127.0))
    # a zero's code is 0 without its division (``code`` in the source)
    scaled = torch.where(x == 0, scales[:, None], x) / scales[:, None]
    codes = torch.where(x == 0, 0.0, torch.round(scaled).clamp(-127, 127)).to(torch.int8)
    return codes, scales


def _groups(gs, dtype, G=3, seed=0):
    """numpy fp32 [G, gs] (the JAX side's values in ``dtype``) and the same
    values as the port's tensor: random, an all-zero group, and ±127 and
    k + 0.5 ties against the first group's scale."""
    rng = np.random.RandomState(seed + gs)
    x = (rng.randn(G, gs) * 3).astype(np.float32)
    x[1] = 0.0
    x[0, :2] = [6.35, -6.35]                       # absmax 6.35: scale 0.05
    x[0, 2:40] = (np.arange(38) % 7 + 0.5) * 0.05  # ties (k + 0.5) scale
    if dtype == torch.bfloat16:
        xj = np.asarray(jnp.asarray(x, jnp.bfloat16))
        return xj, kv_handle_from_jax({"k": xj})["k"]
    return x, torch.from_numpy(x.copy())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("gs", GROUPS)
def test_cluster_arithmetic_equals_plain_and_jax_eager_bitwise(gs, dtype):
    xj, xt = _groups(gs, dtype)
    codes, scales = cluster_quantize(xt)
    rv, rs = tq.quantize_int8_ref(xt)
    assert torch.equal(codes, rv)
    assert torch.equal(scales.view(torch.int32), rs.view(torch.int32))
    vj, sj, _ = jq.quantize_int8(xj, group_size=gs)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(scales.numpy().view(np.int32),
                                  np.asarray(sj, np.float32).reshape(-1).view(np.int32))
    assert scales[1].item() == 1.0 and not codes[1].any()
