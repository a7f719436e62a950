"""Fused dequantize-matmul over grouped weight carriers.

Port of ``deepspeed_tpu/ops/pallas/fused_quant_matmul.py`` (its
forward: serving needs no backward). For a ``[K, N]`` weight the grouped
layout keeps int8 or ``float8_e4m3fn`` carriers ``values [K, N]``, or
packed fp6 e3m2 carriers ``values [K, 3N/4]`` uint8, beside fp32
``scales [K, ng]``: weight ``(k, n)`` is ``decode(values) * scales[k,
n // g]`` with ``g = N / ng``, rounded to ``dequant_dtype``.

:func:`quant_matmul` is what the serving path calls. A CUDA tensor
launches the CUDA C++ kernels of ``csrc/fused_quant_matmul.cu`` (its
header says what bounds them and what each design does about that),
built by ``ops/kernels/build.py`` and called through ctypes; it takes
bf16 ``x`` and bf16 ``dequant_dtype`` and raises on anything else. A CPU
tensor takes the plain version :func:`quant_matmul_ref`: dequantize with
:func:`dequantize_grouped` (the one canonical decode), then matmul. The
TPU kernel's VMEM budget and tile ladder do not carry over: the kernels
take any K, any N and any group width the layout allows.

:func:`dense_matmul` is the same kernels over a bf16 weight: the serving
path's dense projections. It cuts the K loop by ``(N, K)`` alone, never
by the row count, so a token's output bits do not depend on the batch it
runs in (cuBLAS picks its algorithm, split-K among them, by M).

Each call takes one of three designs, named before the launch by
:func:`k4_design` from the instance, the row bucket, K, N and alignment:
"stream" (M <= 16: the weight's bytes streamed through a TMA ring, K
split over blocks by :func:`k4_split`), "wgmma" (M > 16: 128-row tiles on
wgmma) and "general" (what TMA cannot read). ``k4_design_launches``
counts them by instance; :func:`k4_plan` gives a call's launch
parameters.
"""

import ctypes
import threading

import torch

from deepspeed_tpu_torch.ops.fp_quantizer.quantize import _decode_e3m2, unpack_fp6

_SOURCE = "fused_quant_matmul.cu"
SCHEMES = ("int8", "fp8", "fp6")
# the kernels' scheme codes (csrc/quant_gemm.cuh); 0 is a bf16 weight
SCHEME_CODE = {"int8": 1, "fp8": 2, "fp6": 3}
BF16_CODE = 0
CARRIER_DTYPE = {"int8": torch.int8, "fp8": torch.float8_e4m3fn, "fp6": torch.uint8}
NUM_SMS = 132  # H100 SXM


def carrier_cols(values, scheme):
    """N, the weight's last dim, from the carriers (fp6 packs 4 codes
    into 3 bytes)."""
    return values.shape[-1] * 4 // 3 if scheme == "fp6" else values.shape[-1]


def dequantize_grouped(values, scales, scheme, dtype=torch.bfloat16):
    """Grouped-layout dequantize. Shapes come from the carriers, so one
    layer's (or one expert's) slice of a stacked leaf decodes as is: the
    layout has no padding, the last dim is ``ng * g`` codes."""
    ng = scales.shape[-1]
    grouped = values.reshape(values.shape[:-1] + (ng, values.shape[-1] // ng))
    if scheme == "fp6":
        vals = _decode_e3m2(unpack_fp6(grouped))
    else:
        vals = grouped.float()
    out = vals * scales.float()[..., None]
    return out.reshape(out.shape[:-2] + (-1,)).to(dtype)


def quant_matmul_ref(x, values, scales, scheme, dequant_dtype=torch.bfloat16,
                     out_dtype=None):
    """Plain version: ``x[..., K] @ dequantize_grouped(...)`` in the
    promoted type of x and ``dequant_dtype`` → ``[..., N]`` in
    ``out_dtype`` (that promoted type when None)."""
    ct = torch.promote_types(x.dtype, dequant_dtype)
    w = dequantize_grouped(values, scales, scheme, dequant_dtype).to(ct)
    return (x.to(ct) @ w).to(out_dtype or ct)


_ENTRY = []  # the C entry, loaded (and built) on first use


def _entry():
    if not _ENTRY:
        from deepspeed_tpu_torch.ops.kernels.build import load
        fn = load(_SOURCE).ds_quant_matmul
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _ENTRY.append(fn)
    return _ENTRY[0]


def check_carriers(values, scales, scheme, device, stacked):
    """Raise unless ``values``/``scales`` are grouped carriers of
    ``scheme`` the kernels take: contiguous, on ``device``, fp32 scales,
    ``[K, N]`` (``[E, K, N]`` when ``stacked``) with a group width that
    divides N (a multiple of 4 for fp6). → (K, N, ng)."""
    if scheme not in SCHEMES:
        raise ValueError(f"unknown scheme {scheme!r}: the kernels take {SCHEMES}")
    dims = 3 if stacked else 2
    if values.dim() != dims or scales.dim() != dims:
        raise ValueError(f"want {dims}-D carriers, got values {tuple(values.shape)} and "
                         f"scales {tuple(scales.shape)}")
    if values.dtype != CARRIER_DTYPE[scheme]:
        raise TypeError(f"{scheme} carriers must be {CARRIER_DTYPE[scheme]}, got {values.dtype}")
    if scales.dtype != torch.float32:
        raise TypeError(f"scales must be float32, got {scales.dtype}")
    if scheme == "fp6" and values.shape[-1] % 3:
        raise ValueError(f"packed fp6 rows of {values.shape[-1]} bytes do not hold whole "
                         f"3-byte words")
    K, N, ng = values.shape[-2], carrier_cols(values, scheme), scales.shape[-1]
    if tuple(scales.shape[:-1]) != tuple(values.shape[:-1]) or ng < 1 or N % ng:
        raise ValueError(f"scales {tuple(scales.shape)} are not groups of values "
                         f"{tuple(values.shape)} ({scheme}, N={N})")
    if scheme == "fp6" and (N // ng) % 4:
        raise ValueError(f"fp6 group width {N // ng} is not a multiple of 4")
    for name, t in (("values", values), ("scales", scales)):
        if t.device != device:
            raise ValueError(f"{name} must be on {device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return K, N, ng


def cdiv(a, b):
    return -(-a // b)


def k_splits(tiles, K, bk=32, min_chunk=256):
    """→ (splits, k_chunk) of the general design: split the K loop over
    blocks when the output tiles alone would leave SMs idle (decode),
    keeping each block at least ``min_chunk`` rows of K; ``k_chunk`` is a
    multiple of ``bk``."""
    splits = max(1, min(cdiv(2 * NUM_SMS, tiles), K // min_chunk))
    chunk = cdiv(cdiv(K, splits), bk) * bk
    return cdiv(K, chunk), chunk


def row_tile(M):
    """The general design's row tile: 16 rows (one MMA row block, all four
    warps across the columns) for decode-sized batches, else 64."""
    return 16 if M <= 16 else 64


DESIGNS = ("stream", "wgmma", "general")
_DESIGN_CODE = {"general": 0, "stream": 1, "wgmma": 2}
RING_ROWS, RING_COLS, RING_STEP = 128, 256, 64  # the Hopper designs' tiles (csrc/ring_gemm.cuh)
# launches by instance ("dense": dense_matmul, "quant": quant_matmul) and design
k4_design_launches = {inst: dict.fromkeys(DESIGNS, 0) for inst in ("dense", "quant")}


def weight_row_bytes(instance, N):
    """Bytes of one row of a [K, N] weight: bf16, int8/fp8 codes, or fp6's
    4 codes in 3 bytes."""
    return 2 * N if instance == "bf16" else N * 3 // 4 if instance == "fp6" else N


def k4_design(instance, M, K, N, *ptrs):
    """The design a K4 call takes, from its instance (``"bf16"`` for
    :func:`dense_matmul`, else the carriers' scheme), its row bucket, K, N
    and the base addresses of x and the weight: "stream" (the decode
    design, M <= 16) or "wgmma" (the prefill design) where TMA can read x
    and the weight (16-byte aligned bases, rows of x and of the weight a
    multiple of 16 bytes: K % 8, bf16 N % 8, int8/fp8 N % 16, fp6 N % 64),
    else "general". The group width chooses nothing: both Hopper designs
    decode every group the layout allows. This is the one predicate; the
    C entry only refuses a forced design that would read out of bounds."""
    if K % 8 or weight_row_bytes(instance, N) % 16 or any(p % 16 for p in ptrs):
        return "general"
    return "stream" if M <= 16 else "wgmma"


# the decode design's blocks k4_split aims at: a block's 4-stage ring streams
# faster than a 132nd of the HBM rate, so half the SMs fill it for a bf16
# weight; carriers decode on the way in and want every SM (each measured on
# an H100 over Mistral-7B's and Mixtral's shapes, PERF.md)
DENSE_BLOCKS, CARRIER_BLOCKS = 64, 128


def k4_split(N, K, blocks=DENSE_BLOCKS):
    """→ (splits, chunk): the Hopper designs' cut of K, from (N, K) alone,
    never from M: splits enough for about ``blocks`` of the decode
    design's 256-column blocks, at least 8 steps of 64 a chunk, ``chunk``
    a multiple of 64. dense_matmul sums every row over these chunks, in
    order, in both designs, so a row's bits do not depend on the batch."""
    splits = max(1, min(blocks // cdiv(N, RING_COLS), K // (8 * RING_STEP)))
    chunk = cdiv(cdiv(K, splits), RING_STEP) * RING_STEP
    return cdiv(K, chunk), chunk


def k4_plan(instance, M, K, N, *ptrs, design=None):
    """→ (design, splits, chunk, tile) of a K4 call: ``design`` (None:
    :func:`k4_design`); the K chunks and their length; the general
    design's row tile, or the bf16 prefill design's column block
    (:func:`dense_tile`). dense_matmul's chunks come from (N,
    K) alone in every design; the decode design through carriers cuts K
    by (N, K) too, for more blocks; the prefill design through carriers
    splits K over blocks only to fill the card, by M."""
    design = design or k4_design(instance, M, K, N, *ptrs)
    if design == "general":
        bm = row_tile(M)
        tiles = cdiv(N, 64) if instance == "bf16" else cdiv(M, bm) * cdiv(N, 64)
        return (design, *k_splits(tiles, K), bm)
    if design == "stream" or instance == "bf16":
        splits, chunk = k4_split(N, K, DENSE_BLOCKS if instance == "bf16" else CARRIER_BLOCKS)
        return design, splits, chunk, dense_tile(M, N, K, splits) if design == "wgmma" else 0
    splits, chunk = fill_split(M, N, K)
    return design, splits, chunk, 0


def dense_tile(M, N, K, splits):
    """The bf16 prefill design's column block, each choice measured the
    fastest at Mistral-7B's projections on an H100 (PERF.md): 256, the
    carriers' ring over the bf16 weight (128 x 256 tiles; K's chunks split
    over blocks and summed in order by the last to arrive, as in the
    decode design), where K is one chunk or long (over 4096: a narrow
    tile's K loop is long); else the dense ring, which sums K's chunks in
    registers (totals beside the accumulators fit up to 128 columns): 128
    where its tiles fill three quarters of the SMs, else 64."""
    if splits == 1 or (K > 4096 and cdiv(M, RING_ROWS) * cdiv(N, 128) < NUM_SMS * 3 // 4):
        return 256
    return 128 if cdiv(M, RING_ROWS) * cdiv(N, 128) >= NUM_SMS * 3 // 4 else 64


def fill_split(M, N, K):
    """→ (splits, chunk) of the prefill design through carriers: K split
    over blocks only while the 128 x 256 tiles leave SMs idle, at least 8
    steps of 64 a split."""
    blocks = cdiv(M, RING_ROWS) * cdiv(N, RING_COLS)
    splits = max(1, min(NUM_SMS // blocks, K // (8 * RING_STEP)))
    chunk = cdiv(cdiv(K, splits), RING_STEP) * RING_STEP
    return cdiv(K, chunk), chunk


_WORKSPACE = {}  # (device index, raw stream) → (fp32 partial sums, int32 arrival counts)
# Held from _workspace to the enqueue of the launch that reads its buffers. Two
# threads (two engines serving in one process) share a set: without it, one could
# replace a buffer that is too small, and the caching allocator hand the freed
# block out again, between the other's read of the old pointer and its launch.
# A block freed after its launch is enqueued is reused only after it, in stream order.
WORKSPACE_LOCK = threading.Lock()


def _workspace(device, stream, partials, arrivals):
    """Views of a cached fp32 buffer of at least ``partials`` elements and
    of a zeroed int32 buffer of at least ``arrivals`` (every launch leaves
    the counts zero), one set for each (device, stream): the calls that
    share a set run in stream order, so no two of them overlap. The caller
    holds :data:`WORKSPACE_LOCK` until its launch is enqueued. (A kernel
    that faults mid-launch could leave a count raised, but a fault on the
    card ends the CUDA context, and with it every later launch.)"""
    key = device.index, stream
    part, arr = _WORKSPACE.get(key, (None, None))
    if part is None or part.numel() < partials:
        part = torch.empty(max(partials, 1 << 20), dtype=torch.float32, device=device)
    if arr is None or arr.numel() < arrivals:
        arr = torch.zeros(max(arrivals, 1 << 12), dtype=torch.int32, device=device)
    _WORKSPACE[key] = part, arr
    return part, arr


def _launch(x2, w, scales, M, K, N, ng, scheme_code, plan):
    """One K4 call on the card (shapes checked by the caller) → out [M, N]
    bf16. Host µs count: the serving decode forward is host-bound."""
    design, splits, chunk, tile = plan
    dev = x2.get_device()
    if dev != torch._C._cuda_getDevice():  # torch.cuda.current_device without its checks
        with torch.cuda.device(dev):
            return _launch(x2, w, scales, M, K, N, ng, scheme_code, plan)
    stream = torch._C._cuda_getCurrentRawStream(dev)
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x2.device)
    part = arr = None
    with WORKSPACE_LOCK:
        if splits > 1 and not (design == "wgmma" and scheme_code == BF16_CODE and tile != 256):
            part, arr = _workspace(x2.device, stream, splits * M * N,
                                   2 * cdiv(M, RING_ROWS) * cdiv(N, RING_COLS))
            part, arr = part.data_ptr(), arr.data_ptr()
        rc = _entry()(x2.data_ptr(), w.data_ptr(),
                      None if scales is None else scales.data_ptr(), out.data_ptr(), part, arr,
                      M, K, N, ng, scheme_code, _DESIGN_CODE[design], splits, chunk, tile,
                      stream)
    if rc != 0:
        raise RuntimeError(f"K4 kernel ({design} design) failed to launch: cudaError {rc}")
    return out


def _check_design(design, instance, M, K, N, ptrs):
    """Raise unless ``design`` (a caller's choice) can take the case."""
    if design not in DESIGNS:
        raise ValueError(f"unknown design {design!r}: K4 has {DESIGNS}")
    if design != "general" and k4_design(instance, M, K, N, *ptrs) == "general":
        raise ValueError(f"the {design} design cannot read this case (TMA needs 16-byte "
                         f"aligned bases and rows): K={K}, N={N}, {instance}")


def quant_matmul(x, values, scales, scheme, dequant_dtype=torch.bfloat16, out_dtype=None,
                 design=None):
    """``x[..., K] @ dequant(values, scales) → [..., N]``; the output
    dtype defaults to the promoted type of x and ``dequant_dtype``, as
    the JAX entry's does. CUDA tensors launch the design :func:`k4_design`
    names (bf16 x, bf16 ``dequant_dtype`` and output, 2-D carriers), or
    ``design`` where it can take the case (a measurement's or a test's
    choice), or raise; CPU tensors take :func:`quant_matmul_ref`."""
    if not x.is_cuda:
        return quant_matmul_ref(x, values, scales, scheme, dequant_dtype, out_dtype)
    out_dtype = out_dtype or torch.promote_types(x.dtype, dequant_dtype)
    if x.dtype != torch.bfloat16 or dequant_dtype != torch.bfloat16 or \
            out_dtype != torch.bfloat16:
        raise TypeError(f"the kernel takes bf16 x, dequant_dtype and output, got "
                        f"{x.dtype}, {dequant_dtype}, {out_dtype}")
    K, N, ng = check_carriers(values, scales, scheme, x.device, stacked=False)
    if x.shape[-1] != K:
        raise ValueError(f"x [..., {x.shape[-1]}] does not contract with carriers [K={K}, N]")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, K).contiguous()
    M = x2.shape[0]
    if M == 0:
        return torch.empty(lead + (N,), dtype=torch.bfloat16, device=x.device)
    ptrs = (x2.data_ptr(), values.data_ptr())
    if design is not None:
        _check_design(design, scheme, M, K, N, ptrs)
    plan = k4_plan(scheme, M, K, N, *ptrs, design=design)
    out = _launch(x2, values, scales, M, K, N, ng, SCHEME_CODE[scheme], plan)
    quant_matmul.launches += 1
    k4_design_launches["quant"][plan[0]] += 1
    return out.reshape(lead + (N,))


quant_matmul.launches = 0


def dense_matmul_ref(x, w):
    """Plain version of :func:`dense_matmul`: ``x @ w``."""
    return x @ w


def dense_matmul(x, w, design=None):
    """``x[..., K] @ w [K, N]`` for a bf16 weight, batch-invariant on the
    card: every design sums a row over the chunks of K that
    :func:`k4_split` takes from ``(N, K)`` alone, each chunk in the same
    16-deep steps, the chunks added in order, so each output row is the
    same bits at every row count. CUDA tensors (bf16 x and w, w
    contiguous) launch the design :func:`k4_design` names, or ``design``
    where it can take the case, or raise; CPU tensors take
    :func:`dense_matmul_ref`."""
    if not x.is_cuda:
        return dense_matmul_ref(x, w)
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"the kernel takes bf16 x and w, got {x.dtype}, {w.dtype}")
    if w.dim() != 2 or not w.is_contiguous() or w.get_device() != x.get_device():
        raise ValueError(f"w must be a contiguous [K, N] tensor on {x.device}, got "
                         f"{tuple(w.shape)} on {w.device}")
    K, N = w.shape
    if x.shape[-1] != K:
        raise ValueError(f"x [..., {x.shape[-1]}] does not contract with w [{K}, {N}]")
    flat = x.dim() == 2 and x.is_contiguous()  # the serving path's case: no reshapes
    x2 = x if flat else x.reshape(-1, K).contiguous()
    M = x2.shape[0]
    if M == 0:
        return torch.empty(x.shape[:-1] + (N,), dtype=torch.bfloat16, device=x.device)
    ptrs = (x2.data_ptr(), w.data_ptr())
    if design is not None:
        _check_design(design, "bf16", M, K, N, ptrs)
    plan = k4_plan("bf16", M, K, N, *ptrs, design=design)
    out = _launch(x2, w, None, M, K, N, 1, BF16_CODE, plan)
    dense_matmul.launches += 1
    k4_design_launches["dense"][plan[0]] += 1
    return out if flat else out.reshape(x.shape[:-1] + (N,))


dense_matmul.launches = 0
