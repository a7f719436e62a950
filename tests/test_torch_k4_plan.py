"""The Hopper designs of K4 (``quant_matmul`` over carriers and
``dense_matmul`` over a bf16 weight), on the CPU: the predicate that
chooses a design (``k4_design``), the cut of K that makes ``dense_matmul``
batch-invariant (``k4_split``, the same at every row count), and a tiled
fp32 emulation of each design against the JAX kernel.

On the card, the decode design (M <= 16, ``csrc/ring_gemm.cuh``'s stream
body) takes each 256-column block and split of K on its own: the product
swapped, out^T = W^T x^T, one 64-N box of the weight at a time, 16-deep
slices in order; with more than one split, each split's fp32 sums are
added in split order (s = 0, s += p[0], ...). The prefill design (M > 16)
takes 128-row items: over carriers, 256 columns a block, K split over
blocks only to fill the card; over a bf16 weight (the dense ring), BN
columns a block and the decode design's chunks, its accumulators
restarted at each chunk and added into totals in chunk order. Here each
wgmma slice is one fixed-order sum of 16 products, the same function in
both emulations, so the emulations compare the designs' chunking and
orders, and each matches the JAX package's ``quant_matmul(...,
interpret=True)`` (or ``x @ w`` for bf16) within 1e-5 of its largest
magnitude; and a row's fp32 result is the same bits in the decode and
prefill designs at ``dense_matmul``'s chunks, the property its batch
invariance rests on."""

import functools
import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepspeed_tpu.inference.quantization.quantization import (
    _quantize_grouped as jax_quantize_grouped)
from deepspeed_tpu.ops.pallas import fused_quant_matmul as jfq
from deepspeed_tpu_torch.models.convert import carrier_from_jax
from deepspeed_tpu_torch.ops.kernels import fused_quant_matmul as fq

torch.set_num_threads(1)  # the suite runs in parallel worker processes

INV_GEMMS = ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096), (4096, 32000))
K = 512
ROWS = (1, 7, 16, 37, 264)
RTOL = 1e-5


# ---------------------------------------------------------------- predicate
@pytest.mark.parametrize("instance,M,K_,N,design", [
    ("bf16", 1, 4096, 4096, "stream"), ("bf16", 16, 4096, 14336, "stream"),
    ("bf16", 17, 4096, 4096, "wgmma"), ("bf16", 512, 4096, 32000, "wgmma"),
    ("int8", 8, 4096, 4096, "stream"), ("fp8", 264, 14336, 4096, "wgmma"),
    ("fp6", 8, 4096, 32000, "stream"), ("fp6", 37, 512, 1000, "general"),  # 750-byte rows
    ("int8", 37, 512, 1000, "general"), ("fp8", 8, 512, 1024, "stream"),
    ("fp6", 8, 96, 36, "general"), ("fp6", 264, 256, 96, "general"),  # rows of 27, 72 bytes
    ("int8", 8, 256, 520, "general"),                                 # rows of 520 bytes
    ("bf16", 8, 100, 72, "general"), ("int8", 264, 100, 512, "general"),  # K % 8
    ("bf16", 512, 4096, 1028, "general"),                             # rows of 2056 bytes
])
def test_k4_design_by_shape(instance, M, K_, N, design):
    assert fq.k4_design(instance, M, K_, N, 0, 256) == design


@pytest.mark.parametrize("ptrs", [(8, 0), (0, 4), (2, 2)])
@pytest.mark.parametrize("instance", ("bf16", "int8", "fp6"))
@pytest.mark.parametrize("M", (8, 512))
def test_k4_design_needs_aligned_bases(ptrs, instance, M):
    assert fq.k4_design(instance, M, 4096, 4096, *ptrs) == "general"


def test_k4_design_reads_the_row_bucket_only():
    """The predicate's inputs are the instance, M, K, N and the bases, and
    M enters through its bucket (<= 16 or not)."""
    assert list(inspect.signature(fq.k4_design).parameters) == ["instance", "M", "K", "N",
                                                               "ptrs"]
    assert {fq.k4_design("int8", M, 4096, 4096, 0, 0) for M in range(1, 17)} == {"stream"}
    assert {fq.k4_design("int8", M, 4096, 4096, 0, 0)
            for M in range(17, 4097, 13)} == {"wgmma"}


@pytest.mark.parametrize("K_,N", INV_GEMMS)
def test_dense_split_is_the_same_at_every_row_count(K_, N):
    """dense_matmul's chunks (count and length) at every M from 1 to 4096,
    in the Hopper designs and in the general one; the chunks tile K in
    steps of 64 and fill the decode design's grid."""
    hopper = {fq.k4_plan("bf16", M, K_, N, 0, 0)[1:3] for M in range(1, 4097)}
    general = {fq.k4_plan("bf16", M, K_, N, 0, 0, design="general")[1:3]
               for M in range(1, 4097)}
    assert hopper == {fq.k4_split(N, K_)} and len(general) == 1
    splits, chunk = fq.k4_split(N, K_)
    assert chunk % 64 == 0 and (splits - 1) * chunk < K_ <= splits * chunk
    assert splits * -(-N // 256) <= fq.NUM_SMS


def test_quant_decode_split_comes_from_the_shape():
    """The decode design over carriers cuts K by (N, K) alone too, aiming
    at twice dense_matmul's blocks."""
    for K_, N in INV_GEMMS:
        for M in range(1, 17):
            assert fq.k4_plan("int8", M, K_, N, 0, 0)[1:3] == \
                fq.k4_split(N, K_, fq.CARRIER_BLOCKS)


# ---------------------------------------------------------------- emulation
def _slice(xs, ws):
    """One wgmma slice: the 16 products x[m, k] w[k, n] (fp32, exact for
    bf16 operands) summed by a fixed pairwise tree → [M, N]. Both
    emulations call it, the decode design with its operands swapped."""
    p = xs.T[:, :, None] * ws[:, None, :]  # [16, M, N]
    while p.shape[0] > 1:
        p = p[0::2] + p[1::2]
    return p[0]


def _chunk_sum(x, w, k_begin, k_end):
    """A chunk's fp32 sums: 16-deep slices in order from a fresh start
    (each chunk's first wgmma overwrites its accumulators)."""
    acc = None
    for k in range(k_begin, k_end, 16):
        s = _slice(x[:, k:k + 16], w[k:k + 16])
        acc = s if acc is None else acc + s
    return acc


def _in_order(parts):
    """The chunks added in split order, as the kernels do: s = 0, s += p[0], ..."""
    if len(parts) == 1:
        return parts[0]
    s = np.zeros_like(parts[0])
    for p in parts:
        s = s + p
    return s


def _pad(x, w):
    """x and w zero-padded along K to a whole 64-step (TMA's zero fill)."""
    kp = -(-x.shape[1] // 64) * 64
    return (np.pad(x, ((0, 0), (0, kp - x.shape[1]))),
            np.pad(w, ((0, kp - w.shape[0]), (0, 0))))


def emulate_stream(x, w, splits, chunk):
    """The decode design: per 256-column block and split, each 64-N box's
    out^T = W^T x^T over the split's steps; the splits in order."""
    x, w = _pad(x, w)
    M, N = x.shape[0], w.shape[1]
    out = np.zeros((M, N), np.float32)
    for c0 in range(0, N, 256):
        for n0 in range(c0, min(N, c0 + 256), 64):
            cols = slice(n0, min(N, n0 + 64))
            # out^T [64 N][M]: the weight's box as the left operand, x^T as the right
            parts = [_chunk_sum(w[:, cols].T, x.T, z * chunk, min(x.shape[1], (z + 1) * chunk))
                     for z in range(splits)]
            out[:, cols] = _in_order(parts).T
    return out


def emulate_ring(x, w, splits, chunk, bn):
    """The prefill design: per 128-row item (two consumers of 64 rows) and
    bn-column block, each chunk of K from a fresh start, the chunks added
    in order (in registers over a bf16 weight, through memory over
    carriers: the same operations)."""
    x, w = _pad(x, w)
    M, N = x.shape[0], w.shape[1]
    out = np.zeros((M, N), np.float32)
    for r0 in range(0, M, 128):
        for h in range(r0, min(M, r0 + 128), 64):
            rows = slice(h, min(M, h + 64))
            for c0 in range(0, N, bn):
                cols = slice(c0, min(N, c0 + bn))
                parts = [_chunk_sum(x[rows], w[:, cols], z * chunk,
                                    min(x.shape[1], (z + 1) * chunk)) for z in range(splits)]
                out[rows, cols] = _in_order(parts)
    return out


def emulate(instance, x, w):
    """The design and cut of K that k4_plan names for x's row count."""
    M, K_ = x.shape
    N = w.shape[1]
    design, splits, chunk, tile = fq.k4_plan(instance, M, K_, N, 0, 0)
    assert design != "general"
    if design == "stream":
        return emulate_stream(x, w, splits, chunk)
    return emulate_ring(x, w, splits, chunk, tile or 256)


@functools.lru_cache(maxsize=None)
def _case(instance, N, group):
    """Seeded bf16-valued x [264, K] and weight → (x, bf16 weight as fp32,
    the JAX result at 264 rows, fp32)."""
    rng = np.random.RandomState(13)
    x = torch.from_numpy(rng.randn(max(ROWS), K).astype(np.float32)).bfloat16().float().numpy()
    w = rng.randn(K, N).astype(np.float32) * 0.05
    if instance == "bf16":
        wq = torch.from_numpy(w).bfloat16().float().numpy()
        want = np.asarray(jnp.matmul(jnp.asarray(x), jnp.asarray(wq)), np.float32)
        return x, wq, want
    jq = jax_quantize_grouped(jnp.asarray(w), instance, group, dequant_dtype=jnp.bfloat16)
    tq = carrier_from_jax(jq)
    wq = fq.dequantize_grouped(tq.values, tq.scales, instance, torch.bfloat16).float().numpy()
    want = np.asarray(jfq.quant_matmul(jnp.asarray(x), jq.values, jq.scales, instance,
                                       dequant_dtype=jnp.bfloat16, interpret=True), np.float32)
    return x, wq, want


# group 64 (one scale a 64-column box) and 240 (one an element: the head's 500 is not a
# multiple of 64 either), and a bf16 weight
CASES = [(s, N, g) for s in ("int8", "fp8", "fp6") for N, g in ((512, 64), (960, 240))] + \
    [("bf16", 1000, 1)]


@pytest.mark.parametrize("instance,N,group", CASES)
def test_design_emulation_matches_jax_interpret(instance, N, group):
    """Each row count's design (the decode design at 1, 7 and 16 rows, the
    prefill design at 37 and 264) within 1e-5 of the JAX kernel; a zeroed
    64-column slice is seen."""
    x, wq, want = _case(instance, N, group)
    for M in ROWS:
        got, ref = emulate(instance, x[:M], wq), want[:M]
        err = np.abs(got - ref).max() / np.abs(ref).max()
        assert err <= RTOL, (M, err)
    bad = got.copy()
    bad[:, 64:128] = 0
    assert np.abs(bad - ref).max() / np.abs(ref).max() > 1e-2


@pytest.mark.parametrize("N", (1000, 512))
def test_dense_rows_equal_bitwise_across_designs(N):
    """At dense_matmul's chunks (here 2 of 256 and 1 of 512, both designs,
    every row count) a row's fp32 sums are the same bits in the decode and
    prefill emulations: the chunks and their order are the designs' only
    freedom, and they agree."""
    x, wq, _ = _case("bf16", 1000, 1)
    wq = wq[:, :N]
    for splits, chunk in ((2, 256), (1, 512)):
        rows = emulate_stream(x[:16], wq, splits, chunk)
        for bn in (64, 128):
            ring = emulate_ring(x, wq, splits, chunk, bn)
            assert np.array_equal(ring[:16], rows)
    # and through k4_plan's own cut at each row count
    rows = {M: emulate("bf16", x[:M], wq) for M in ROWS}
    assert all(np.array_equal(r[:1], rows[1]) for r in rows.values())
