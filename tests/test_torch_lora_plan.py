"""The mma design of K6 (``csrc/lora_matmul.cu``'s ``lora_mma_kernel``),
on the CPU: the predicate that chooses it (``lora_design``), its cut of
K, and its arithmetic.

On the card a cluster of blocks takes one 16-row tile, each block a
range of output columns. Phase 1 computes h = x_tile @ A_g on mma.sync:
K is cut into 16 contiguous slices by K alone, shared by the cluster's
blocks; a warp walks a slice from zero in 16-deep mma steps, each step one
fixed-order fp32 sum of 16 exact bf16 products added into its
accumulators, and every block adds the 16 slices' sums in slice order. Phase 2
sums h[i][j] B_g[j][c] over j in order with fp32 FMAs and writes
``round(y + round(sum * scale))``. The emulation here runs the same cut
and orders in fp32, one element at a time, and is held against the JAX
package's ``lora_delta_pallas(..., interpret=True)`` on fp32 inputs made
with numpy from a seed, within 1e-5 of each output's scale (the frameworks
sum in other orders), and a row's emulated delta is bitwise equal alone
and in any batch: the cut and the orders depend on K, not on T."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepspeed_tpu.ops.pallas import lora_matmul as jlora
from deepspeed_tpu_torch.ops.kernels import lora_matmul as lm

SLICES = 16  # the K cut
STEP = 16   # k an mma step sums


def k_cut(K):
    """The mma design's K slices: 16 contiguous ranges of K / 16."""
    s = K // SLICES
    return [(w * s, (w + 1) * s) for w in range(SLICES)]


def emulate(x, slots, a, b, scales):
    """The mma design's delta [T, N] fp32 (slot-0 rows zero)."""
    T, K = x.shape
    N = b.shape[2]
    s = slots.long()
    A, B = a[s].float(), b[s].float()           # each row's own slabs
    X = x.float()
    h = None
    for k0, k1 in k_cut(K):
        part = torch.zeros(T, A.shape[2])
        for j0 in range(k0, k1, STEP):
            step = torch.zeros(T, A.shape[2])
            for k in range(j0, j0 + STEP):
                step = step + X[:, k:k + 1] * A[:, k]
            part = part + step
        h = part if h is None else h + part
    out = torch.zeros(T, N)
    for j in range(A.shape[2]):
        out = torch.addcmul(out, h[:, j:j + 1], B[:, j])
    d = out * scales.float()[s][:, None]
    return torch.where((s != 0)[:, None], d, torch.zeros(()))


def make_case(seed, T, K, N, S, r):
    rng = np.random.RandomState(seed)
    x = rng.randn(T, K).astype(np.float32)
    a = (rng.randn(S, K, r) * 0.05).astype(np.float32)
    b = (rng.randn(S, r, N) * 0.05).astype(np.float32)
    a[0], b[0] = 0, 0
    scales = rng.uniform(0.5, 2.0, S).astype(np.float32)
    scales[0] = 0
    slots = rng.randint(0, S, T).astype(np.int32)
    return x, slots, a, b, scales


@pytest.mark.parametrize("dtype,K,N,r,ptrs,design", [
    (torch.bfloat16, 4096, 4096, 8, (0, 16, 32, 48, 4096, 4096), "mma"),
    (torch.bfloat16, 4096, 1024, 16, (0, 16, 32, 48, 4096, 1024), "mma"),
    (torch.bfloat16, 4096, 4096, 64, (0, 16, 32, 48, 4096, 4096), "mma"),
    (torch.float32, 4096, 4096, 8, (0, 16, 32, 48, 4096, 4096), "general"),
    (torch.bfloat16, 4096, 4096, 8, (2, 16, 32, 48, 4096, 4096), "general"),   # x off 16 bytes
    (torch.bfloat16, 4096, 4096, 8, (0, 16, 32, 48, 4100, 4096), "general"),   # ldx % 8
    (torch.bfloat16, 4000, 4096, 8, (0, 16, 32, 48, 4000, 4096), "general"),   # K % 512
    (torch.bfloat16, 256, 4096, 8, (0, 16, 32, 48, 256, 4096), "general"),
    (torch.bfloat16, 4096, 4100, 8, (0, 16, 32, 48, 4096, 4100), "general"),   # N % 8
    (torch.bfloat16, 4096, 4096, 5, (0, 16, 32, 48, 4096, 4096), "general"),   # r % 8
])
def test_lora_design_by_shape(dtype, K, N, r, ptrs, design):
    assert lm.lora_design(dtype, K, N, r, *ptrs) == design


@pytest.mark.parametrize("K", [512, 1024, 4096])
def test_the_k_cut_covers_k_once_in_whole_steps_whatever_t(K):
    cut = k_cut(K)
    assert cut[0][0] == 0 and cut[-1][1] == K
    assert all(a1 == b0 for (_, a1), (b0, _) in zip(cut, cut[1:]))
    assert all((k1 - k0) % 32 == 0 for k0, k1 in cut)  # whole 32-k ring steps


@pytest.mark.parametrize("T,K,N,S,r", [(13, 512, 24, 4, 8), (40, 1024, 64, 9, 16)])
def test_emulation_matches_pallas_interpret(T, K, N, S, r):
    x, slots, a, b, scales = make_case(0, T, K, N, S, r)
    want = np.asarray(jlora.lora_delta_pallas(jnp.asarray(x), jnp.asarray(slots), jnp.asarray(a),
                                              jnp.asarray(b), jnp.asarray(scales),
                                              tm=16, interpret=True))
    got = emulate(*[torch.from_numpy(v) for v in (x, slots, a, b, scales)]).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=1e-5 * scale, rtol=0)


def test_emulated_rows_are_bitwise_independent_of_the_batch():
    x, slots, a, b, scales = [torch.from_numpy(v) for v in make_case(1, 37, 512, 48, 9, 8)]
    mixed = emulate(x, slots, a, b, scales)
    for t in (0, 5, 36):
        assert torch.equal(emulate(x[t:t + 1], slots[t:t + 1], a, b, scales)[0], mixed[t])
    perm = torch.randperm(37, generator=torch.Generator().manual_seed(0))
    assert torch.equal(emulate(x[perm], slots[perm], a, b, scales), mixed[perm])


def test_wrapper_counts_no_design_on_cpu():
    x, slots, a, b, scales = [torch.from_numpy(v) for v in make_case(2, 9, 512, 16, 4, 8)]
    before = dict(lm.lora_design_launches)
    y = torch.zeros(9, 16)
    lm.lora_delta(x, y, a, b, scales, lm.lora_layout(slots, 4))
    assert lm.lora_design_launches == before
    assert torch.equal(y, lm.lora_delta_ref(x, slots, a, b, scales))
