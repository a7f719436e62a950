"""Fused dequantize-matmul over grouped weight carriers.

Port of ``deepspeed_tpu/ops/pallas/fused_quant_matmul.py`` (its
forward: serving needs no backward). For a ``[K, N]`` weight the grouped
layout keeps int8 or ``float8_e4m3fn`` carriers ``values [K, N]``, or
packed fp6 e3m2 carriers ``values [K, 3N/4]`` uint8, beside fp32
``scales [K, ng]``: weight ``(k, n)`` is ``decode(values) * scales[k,
n // g]`` with ``g = N / ng``, rounded to ``dequant_dtype``.

:func:`quant_matmul` is what the serving path calls. A CUDA tensor
launches the CUDA C++ kernel ``csrc/fused_quant_matmul.cu`` (its header
says what bounds it and what the design does about that), built by
``ops/kernels/build.py`` and called through ctypes; it takes bf16 ``x``
and bf16 ``dequant_dtype`` and raises on anything else. A CPU tensor
takes the plain version :func:`quant_matmul_ref`: dequantize with
:func:`dequantize_grouped` (the one canonical decode), then matmul. The
TPU kernel's VMEM budget and tile ladder do not carry over: the kernel
takes any K, any N and any group width the layout allows.

:func:`dense_matmul` is the same kernel over a bf16 weight: the serving
path's dense projections. It splits the K loop by ``(N, K)`` alone, never
by the row count, so a token's output bits do not depend on the batch it
runs in (cuBLAS picks its algorithm, split-K among them, by M).
"""

import ctypes

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


def _fn(name, n_ptr, n_int):
    from deepspeed_tpu_torch.ops.kernels.build import load
    fn = getattr(load(_SOURCE), name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


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
    """→ (splits, k_chunk): split the K loop over blocks when the output
    tiles alone would leave SMs idle (decode), keeping each block at
    least ``min_chunk`` rows of K; ``k_chunk`` is a multiple of ``bk``."""
    splits = max(1, min(cdiv(2 * NUM_SMS, tiles), K // min_chunk))
    chunk = cdiv(cdiv(K, splits), bk) * bk
    return cdiv(K, chunk), chunk


def row_tile(M):
    """The kernels' row tile: 16 rows (one MMA row block, all four warps
    across the columns) for decode-sized batches, else 64."""
    return 16 if M <= 16 else 64


def quant_matmul(x, values, scales, scheme, dequant_dtype=torch.bfloat16, out_dtype=None):
    """``x[..., K] @ dequant(values, scales) → [..., N]``; the output
    dtype defaults to the promoted type of x and ``dequant_dtype``, as
    the JAX entry's does. CUDA tensors launch the kernel (bf16 x, bf16
    ``dequant_dtype`` and output, 2-D carriers) or raise; CPU tensors
    take :func:`quant_matmul_ref`."""
    if x.device.type == "cpu":
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
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    if M == 0:
        return out.reshape(lead + (N,))
    bm = row_tile(M)
    splits, chunk = k_splits(cdiv(M, bm) * cdiv(N, 64), K)
    partial = (torch.empty((splits, M, N), dtype=torch.float32, device=x.device)
               if splits > 1 else None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _fn("ds_quant_matmul", 5, 8)(
            x2.data_ptr(), values.data_ptr(), scales.data_ptr(), out.data_ptr(),
            None if partial is None else partial.data_ptr(), M, K, N, ng,
            SCHEME_CODE[scheme], bm, splits, chunk, stream)
    if rc != 0:
        raise RuntimeError(f"quant_matmul kernel failed to launch: cudaError {rc}")
    quant_matmul.launches += 1
    return out.reshape(lead + (N,))


quant_matmul.launches = 0


def dense_matmul_ref(x, w):
    """Plain version of :func:`dense_matmul`: ``x @ w``."""
    return x @ w


def dense_matmul(x, w):
    """``x[..., K] @ w [K, N]`` for a bf16 weight, batch-invariant on the
    card: the K loop splits by ``(N, K)`` alone (the tile count of a
    decode-sized batch), and the splits are added in a fixed order, so
    each output row is the same bits at every row count. CUDA tensors
    (bf16 x and w, w contiguous) launch the kernel or raise; CPU tensors
    take :func:`dense_matmul_ref`."""
    if x.device.type == "cpu":
        return dense_matmul_ref(x, w)
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"the kernel takes bf16 x and w, got {x.dtype}, {w.dtype}")
    if w.dim() != 2 or not w.is_contiguous() or w.device != x.device:
        raise ValueError(f"w must be a contiguous [K, N] tensor on {x.device}, got "
                         f"{tuple(w.shape)} on {w.device}")
    K, N = w.shape
    if x.shape[-1] != K:
        raise ValueError(f"x [..., {x.shape[-1]}] does not contract with w [{K}, {N}]")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, K).contiguous()
    M = x2.shape[0]
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    if M == 0:
        return out.reshape(lead + (N,))
    splits, chunk = k_splits(cdiv(N, 64), K)  # from (N, K) only
    partial = (torch.empty((splits, M, N), dtype=torch.float32, device=x.device)
               if splits > 1 else None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _fn("ds_quant_matmul", 5, 8)(
            x2.data_ptr(), w.data_ptr(), None, out.data_ptr(),
            None if partial is None else partial.data_ptr(), M, K, N, 1, BF16_CODE,
            row_tile(M), splits, chunk, stream)
    if rc != 0:
        raise RuntimeError(f"dense_matmul kernel failed to launch: cudaError {rc}")
    dense_matmul.launches += 1
    return out.reshape(lead + (N,))


dense_matmul.launches = 0
