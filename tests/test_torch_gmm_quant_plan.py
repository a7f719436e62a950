"""The Hopper designs of K5's forward through quantized carriers
(``gmm_quant``), on the CPU: the predicate that chooses them
(``quant_design``), the layouts their decoder reads and writes, and a
tiled fp32 emulation of each design against the JAX kernel.

On the card, ``csrc/grouped_matmul.cu``'s ``decode_fwd_stage`` decodes each
[64 K][256 N] stage of carriers into four MN-major [64 K][64 N] bf16 boxes
with TMA's 128-byte swizzle, which wgmma reads through ``sw128_mn_desc``.
Its address maps are replicated here: every weight (k, n) is written once,
at the byte the descriptor reads for it (the one-hot pin of the layout),
the raw bytes it reads are those TMA lands for the same weight, and each
quarter warp's 16-byte accesses fall on distinct bank groups.

The emulations run the designs' work through the plan (``gmm_plan``, as
the kernels take it): the forward ring (64-row tiles) multiplies each
item's x rows by [64 K][256 N] stages read back through the descriptor
map, two 64-row consumers, 16-deep slices; the decode design (16-row
tiles) takes the swapped product W^T x^T per 64-N box. Each matches the
JAX package's
``gmm_quant(..., interpret=True)`` (fp32 x, bf16 weights) within 1e-5 of
its largest magnitude, at E 4, K 256, N 512, group 128, for int8, fp8 and
fp6, over a routing with an empty expert."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepspeed_tpu.inference.quantization.quantization import (
    _quantize_grouped as jax_quantize_grouped)
from deepspeed_tpu.ops.pallas import grouped_matmul as jgm
from deepspeed_tpu_torch.models.convert import carrier_from_jax
from deepspeed_tpu_torch.ops.kernels import grouped_matmul as gm
from deepspeed_tpu_torch.ops.kernels.fused_quant_matmul import dequantize_grouped

BOX = 64 * 64 * 2  # one [64 K][64 N] bf16 box: 8 KB (csrc RING_BOX)
SIZES = (40, 0, 23, 57)  # rows per expert: expert 1 empty
E, K, N, G = 4, 256, 512, 128
RTOL = 1e-5


# ---------------------------------------------------------------- predicate
@pytest.mark.parametrize("scheme,tm,K,N,design", [
    ("int8", 64, 4096, 14336, "wgmma"), ("int8", 16, 4096, 14336, "stream"),  # Mixtral w1
    ("fp8", 64, 14336, 4096, "wgmma"), ("fp8", 16, 14336, 4096, "stream"),   # and w2
    ("fp6", 64, 4096, 14336, "wgmma"), ("fp6", 16, 14336, 4096, "stream"),
    ("int8", 16, 256, 512, "stream"), ("fp6", 64, 8, 64, "wgmma"),
    ("int8", 64, 128, 200, "general"), ("fp8", 16, 256, 520, "general"),      # rows not 16 bytes
    ("fp6", 16, 96, 36, "general"), ("fp6", 64, 256, 96, "general"),          # fp6 rows of 27, 72
    ("int8", 64, 100, 512, "general"), ("fp8", 16, 4, 4096, "general"),       # x rows not 16 bytes
    ("int8", 32, 4096, 4096, "general"),                                       # no such tile
])
def test_quant_design_by_shape(scheme, tm, K, N, design):
    """The forward ring at 64-row tiles, the decode design at 16, where TMA
    can read x (K % 8) and the carriers (int8/fp8 N % 16, fp6 N % 64)."""
    assert gm.quant_design(scheme, tm, K, N, 0, 256) == design


@pytest.mark.parametrize("ptrs", [(8, 0), (0, 4), (2, 2)])
@pytest.mark.parametrize("tm", (16, 64))
def test_quant_design_needs_aligned_bases(ptrs, tm):
    assert gm.quant_design("int8", tm, 4096, 4096, *ptrs) == "general"


def test_quant_design_ignores_rows_and_routing():
    """The predicate takes no row count or routing: the same shape names
    the same design for any batch."""
    import inspect
    assert list(inspect.signature(gm.quant_design).parameters) == ["scheme", "tm", "K", "N",
                                                                   "ptrs"]


# ---------------------------------------------------------------- layouts
def _swizzle(addr):
    """The 128-byte swizzle on shared-memory byte addresses (TMA's writes
    and wgmma's reads alike, bases 1024-aligned): the 16-byte chunk bits
    4-6 XOR the row bits 7-9."""
    return addr ^ (((addr >> 7) & 7) << 4)


def _descriptor_reads():
    """Byte address wgmma reads for weight (k, n) of a stage through
    ``sw128_mn_desc(stage, BOX)`` plus 128 (k // 16) (16-deep slice k // 16,
    2048 bytes on): the next 64 N one leading-byte offset (BOX) on, the
    next 8 K rows one stride-byte offset (1024) on, K row r of an 8-row
    group at 128 r, then swizzled → int [64, 256]."""
    k, n = np.meshgrid(np.arange(64), np.arange(256), indexing="ij")
    linear = (k // 16) * 2048 + (n // 64) * BOX + ((k % 16) // 8) * 1024 + (k % 8) * 128 \
        + (n % 64) * 2
    return _swizzle(linear)


def _task(ct, stream):
    """``fwd_task``: the W row and box consumer thread ct (0 .. 255)
    decodes; a quarter warp takes 8 consecutive rows of one box, a warp 8
    rows of all four boxes (the forward ring) or 16 rows of its
    consumer's two boxes (the decode design)."""
    lane, w = ct % 32, ct // 32
    if stream:
        return 16 * (w % 4) + 8 * (lane // 16) + lane % 8, 2 * (w // 4) + (lane // 8) % 2
    return 8 * w + lane % 8, lane // 8


def _decoder_writes(stream):
    """Byte address ``decode_fwd_stage`` stores weight (k, n) at, and the
    quarter-warp groups of its 16-byte stores: thread ct takes row k and
    box b (:func:`_task`); chunk t's 16 values go out as two 16-byte
    stores at chunks 2t ^ (k % 8) and (2t + 1) ^ (k % 8) of row k of box b
    → (int [64, 256], {store: [[16-byte slot of each thread of a quarter
    warp], ...]})."""
    addr = np.full((64, 256), -1)
    stores = {}
    for ct in range(256):
        k, b = _task(ct, stream)
        for t in range(4):
            for half in range(2):
                base = b * BOX + k * 128 + (((2 * t + half) ^ (k % 8)) << 4)
                stores.setdefault((t, half), []).append(base // 16)
                for u in range(8):
                    addr[k, 64 * b + 16 * t + 8 * half + u] = base + 2 * u
    return addr, stores


def _raw_lands(scheme):
    """Byte address where TMA lands the code of weight (k, n) of a stage:
    int8/fp8 as two [64][128-byte] boxes, 128-byte swizzled; fp6 as one
    plain [64][192-byte] box, code n in the 24-bit word n // 4 → int [64,
    256] (fp6: the word's first byte)."""
    k, n = np.meshgrid(np.arange(64), np.arange(256), indexing="ij")
    if scheme == "fp6":
        return k * 192 + (n // 4) * 3
    return (n // 128) * BOX + _swizzle(k * 128 + n % 128)


def _decoder_reads(scheme, stream):
    """Byte address ``load_fwd_chunks`` reads the code of weight (k, n) at
    (fp6: its word's first byte), and the quarter-warp groups of its
    16-byte loads → (int [64, 256], {load: [[slot, ...], ...]})."""
    addr = np.full((64, 256), -1)
    loads = {}
    for ct in range(256):
        k, b = _task(ct, stream)
        if scheme == "fp6":  # 48 bytes from k * 192 + 48 b: three 16-byte loads
            for j in range(3):
                loads.setdefault(j, []).append((k * 192 + 48 * b + 16 * j) // 16)
            for q in range(64):
                addr[k, 64 * b + q] = k * 192 + 48 * b + (q // 4) * 3
        else:
            for t in range(4):
                base = (b >> 1) * BOX + k * 128 + (((4 * (b & 1) + t) ^ (k & 7)) << 4)
                loads.setdefault(t, []).append(base // 16)
                for u in range(16):
                    addr[k, 64 * b + 16 * t + u] = base + u
    return addr, loads


def _quarter_warps(slots):
    return [slots[i:i + 8] for i in range(0, len(slots), 8)]


@pytest.mark.parametrize("stream", (False, True))
def test_decoded_stage_one_hot_lands_where_the_descriptor_reads(stream):
    """A one-hot stage (weight (k, n) alone nonzero), for every (k, n):
    the decoder writes it to exactly one bf16 slot of the 32 KB stage, and
    that is the slot wgmma reads for B[k][n] (the forward ring) and for
    A[n][k] of box n // 64 (the decode design, A MN-major at the box's
    base): the map is a bijection onto the stage and equals the
    descriptor's."""
    writes, _ = _decoder_writes(stream)
    reads = _descriptor_reads()
    image = np.zeros(4 * BOX // 2)
    for k in range(64):
        for n in range(256):
            image[writes[k, n] // 2] = 1.0
            assert np.flatnonzero(image).tolist() == [reads[k, n] // 2], (k, n)
            image[writes[k, n] // 2] = 0.0
    assert sorted(writes.reshape(-1).tolist()) == list(range(0, 4 * BOX, 2))
    np.testing.assert_array_equal(writes, reads)


@pytest.mark.parametrize("stream", (False, True))
@pytest.mark.parametrize("scheme", ("int8", "fp8", "fp6"))
def test_decoder_reads_the_codes_tma_lands(scheme, stream):
    """The decoder's raw reads find each weight's code where TMA put it,
    and cover the stage's raw bytes once."""
    got, loads = _decoder_reads(scheme, stream)
    np.testing.assert_array_equal(got, _raw_lands(scheme))
    slots = sorted(s for v in loads.values() for s in v)
    assert slots == list(range((192 if scheme == "fp6" else 256) * 64 // 16))


@pytest.mark.parametrize("stream", (False, True))
@pytest.mark.parametrize("scheme", ("int8", "fp8"))
def test_decoder_accesses_are_free_of_bank_conflicts(scheme, stream):
    """Each quarter warp's 16-byte stores to the decoded stage, and (int8,
    fp8) its loads from the raw stage, touch 8 distinct 16-byte bank
    groups."""
    _, stores = _decoder_writes(stream)
    _, loads = _decoder_reads(scheme, stream)
    for accesses in (stores, loads):
        for slots in accesses.values():
            for q in _quarter_warps(slots):
                assert len({s % 8 for s in q}) == 8, q


@pytest.mark.parametrize("stream,rows", [(False, 8), (True, 16)])
def test_a_warp_spans_few_rows(stream, rows):
    """A warp's scale loads touch one cache line a row (a row's scales lie
    4 ng bytes apart): 8 rows a warp in the forward ring, 16 in the decode
    design, whose consumer cw decodes only boxes 2 cw and 2 cw + 1 (the
    boxes its own wgmma reads)."""
    tasks = [_task(ct, stream) for ct in range(256)]
    assert sorted(tasks) == [(k, b) for k in range(64) for b in range(4)]
    for w in range(8):
        assert len({k for k, _ in tasks[32 * w:32 * w + 32]}) == rows
    if stream:
        for ct, (_, b) in enumerate(tasks):
            assert b // 2 == ct // 128


# ---------------------------------------------------------------- emulation
def _read_map():
    """Flat index of the decoded stage's bf16 slots, as the descriptor reads
    them, for weight (k, n) → int [64 * 256]."""
    return torch.from_numpy(_descriptor_reads().reshape(-1) // 2)


def _write_map():
    return torch.from_numpy(_decoder_writes(False)[0].reshape(-1) // 2)


@functools.lru_cache(maxsize=None)
def _case(scheme):
    """Seeded x rows and carriers (quantized by the JAX package, converted)
    → (xs [T, K] fp32, jax carriers, port carriers, their bf16 weights)."""
    rng = np.random.RandomState(12)
    xs = rng.randn(sum(SIZES), K).astype(np.float32)
    w = rng.randn(E, K, N).astype(np.float32) * 0.05
    jq = jax_quantize_grouped(jnp.asarray(w), scheme, G, dequant_dtype=jnp.bfloat16)
    tq = carrier_from_jax(jq)
    wq = dequantize_grouped(tq.values, tq.scales, scheme, torch.bfloat16)
    return xs, jq, tq, wq


def _layout(tm):
    sizes = torch.tensor(SIZES)
    n = int(sizes.sum())
    dst, te, Mp = gm.pad_groups_to_tiles(sizes, n, tm)
    return dst.long(), te, gm.used_tiles(sizes, tm), Mp


@functools.lru_cache(maxsize=None)
def _jax_out(scheme, tm):
    """The JAX kernel in interpret mode on the same layout → [Mp, N]."""
    xs, jq, _, _ = _case(scheme)
    dst, te, _, Mp = _layout(tm)
    xp = np.zeros((Mp, K), np.float32)
    xp[dst.numpy()] = xs
    out = jgm.gmm_quant(jnp.asarray(xp), jq.values, jq.scales, jnp.asarray(te.numpy()), scheme,
                        jnp.bfloat16, tm, 512, 256, interpret=True)
    return np.asarray(out, np.float32)


def _stage(wq, e, k0, c0):
    """Weights k0 .. k0 + 63, c0 .. c0 + 255 of expert e as the decoder
    leaves them (zeros past K and N), written through the decoder's map
    and read back through the descriptor's → fp32 [64, 256]."""
    stage = torch.zeros(64, 256, dtype=torch.bfloat16)
    part = wq[e, k0:k0 + 64, c0:c0 + 256]
    stage[:part.shape[0], :part.shape[1]] = part
    image = torch.zeros(4 * BOX // 2, dtype=torch.bfloat16)
    image[_write_map()] = stage.reshape(-1)
    return image[_read_map()].reshape(64, 256).float()


def _x_stage(xp, row0, rows, k0, width):
    """``width`` x rows from row0, columns k0 .. k0 + 63 (zeros past K), the
    rows past the item's zeroed (their outputs are not stored)."""
    xs = torch.zeros(width, 64)
    part = xp[row0:row0 + min(rows, width), k0:k0 + 64]
    xs[:part.shape[0], :part.shape[1]] = part
    return xs


def _emulate_ring(xp, wq, plan, Mp):
    """The forward ring: an item's 128 rows (two consumers of 64) by 256
    columns a block, K in stages of 64 and wgmma slices of 16, fp32."""
    out = torch.zeros(Mp, N)
    for row0, rows, e, _, _ in plan.tolist():
        if e < 0:
            continue  # the zero fill
        for c0 in range(0, N, 256):
            acc = torch.zeros(128, 256)
            for k0 in range(0, K, 64):
                w = _stage(wq, e, k0, c0)
                xs = _x_stage(xp, row0, rows, k0, 128)
                for cw in range(2):
                    for kk in range(0, 64, 16):
                        acc[64 * cw:64 * cw + 64] += \
                            xs[64 * cw:64 * cw + 64, kk:kk + 16] @ w[kk:kk + 16]
            cols = min(256, N - c0)
            out[row0:row0 + rows, c0:c0 + cols] = acc[:rows, :cols]
    return out


def _emulate_stream(xp, wq, plan, Mp):
    """The decode design: an item's 16 NT rows by 256 columns a block (two
    consumers of two 64-N boxes), the product swapped, out^T = W^T x^T per
    box and 16-deep slice, K in stages of 64."""
    out = torch.zeros(Mp, N)
    for row0, rows, e, _, _ in plan.tolist():
        if e < 0:
            continue
        nt = next(t for t in (1, 2, 4, 8) if 16 * t >= rows)
        for c0 in range(0, N, 256):
            acc = torch.zeros(256, 16 * nt)
            for k0 in range(0, K, 64):
                w = _stage(wq, e, k0, c0)
                xs = _x_stage(xp, row0, rows, k0, 16 * nt)
                for box in range(4):
                    for kk in range(0, 64, 16):
                        acc[64 * box:64 * box + 64] += \
                            w[kk:kk + 16, 64 * box:64 * box + 64].t() @ xs[:, kk:kk + 16].t()
            cols = min(256, N - c0)
            out[row0:row0 + rows, c0:c0 + cols] = acc[:cols, :rows].t()
    return out


@pytest.mark.parametrize("scheme", ("int8", "fp8", "fp6"))
@pytest.mark.parametrize("tm", (64, 16))
def test_design_emulation_matches_jax_interpret(scheme, tm):
    xs, _, _, wq = _case(scheme)
    dst, te, used, Mp = _layout(tm)
    design = gm.quant_design(scheme, tm, K, N, 0, 256)
    assert design == ("wgmma" if tm == 64 else "stream")
    xp = torch.zeros(Mp, K)
    xp[dst] = torch.from_numpy(xs)
    plan = gm.gmm_plan(te, used, tm, E)
    got = _emulate_ring(xp, wq, plan, Mp) if design == "wgmma" else \
        _emulate_stream(xp, wq, plan, Mp)
    want = _jax_out(scheme, tm)
    assert not got[int(used) * tm:].any()
    rows, ref = got[dst].numpy(), want[dst.numpy()]
    err = np.abs(rows - ref).max() / np.abs(ref).max()
    assert err <= RTOL, err
    # a zeroed 64-column slice of the busiest expert's rows is seen
    bad = rows.copy()
    start = SIZES[0] + SIZES[1] + SIZES[2]  # expert 3, the busiest, follows experts 0-2
    bad[start:start + 16, 256:320] = 0
    assert np.abs(bad - ref).max() / np.abs(ref).max() > 1e-2
