"""Grouped (per-expert) matmul on a tile-aligned row layout: the MoE
expert GEMM, over bf16 expert stacks or grouped quantized carriers.

Port of the forward kernels of ``deepspeed_tpu/ops/pallas/grouped_matmul.py``:
rows are sorted by expert and each expert's group is padded with zero
rows to a multiple of the row tile ``tm`` (:func:`tile_layout`,
:func:`pad_groups_to_tiles`, the same integers as the JAX functions for
the same ``tm``), so every row tile belongs to one expert,
``tile_experts[i]``.

- :func:`gmm`: ``x [Mp, K] @ w[tile_experts] [E, K, N]`` in bf16 with
  fp32 accumulation (the TPU ``_gmm_kernel``);
- :func:`gmm_quant`: the same over grouped quantized expert carriers,
  each tile dequantized on the way into the product exactly as
  ``dequantize_grouped`` does (the TPU ``_gmm_quant_kernel``).

A CUDA tensor launches the CUDA C++ kernel ``csrc/grouped_matmul.cu``
(its header says what bounds it and what the design does about that) or
raises; a CPU tensor takes the plain version (:func:`gmm_ref`,
:func:`gmm_quant_ref`). ``used_tiles``, an int32 device tensor of one
element, tells the kernel how many leading tiles hold rows: the layout
is sized for the worst case (``Mp`` is static), the count comes from the
routing on the device, and the kernel writes zeros to the tiles past it
without reading any weight. The TPU kernels' scalar prefetch, tile
ladder and VMEM budget do not carry over: a block reads its own tile's
expert. The backward kernels (``_gmm_dw_kernel``,
``_gmm_quant_dx_kernel``) are not ported yet (ROADMAP.md, port queue
item 17).
"""

import ctypes

import torch

from deepspeed_tpu_torch.ops.kernels.fused_quant_matmul import (SCHEME_CODE, carrier_cols,
                                                                 check_carriers,
                                                                 dequantize_grouped)

_SOURCE = "grouped_matmul.cu"
ROW_TILES = (16, 64)  # the row tiles the kernel is built for


def tile_layout(sizes, num_rows, tm):
    """``sizes`` [E] (rows per expert, summing to ``num_rows``) →
    ``(padded_starts [E], tile_experts [Mp/tm] int32, Mp)``: each group's
    first padded row, each row tile's expert (tiles past the last group
    take the final expert: their rows are zero), and the static padded
    row count, every group padded to a tile multiple in the worst case
    (``ceil(num_rows / tm) * tm + E * tm``). Computed on ``sizes``'s
    device with no host sync."""
    E = sizes.shape[0]
    Mp = -(-num_rows // tm) * tm + E * tm
    tiles = (sizes.long() + tm - 1) // tm
    padded = tiles * tm
    padded_starts = torch.cumsum(padded, 0) - padded
    j = torch.arange(Mp // tm, device=sizes.device)
    tile_experts = torch.searchsorted(torch.cumsum(tiles, 0), j, right=True)
    return padded_starts, tile_experts.clamp(max=E - 1).to(torch.int32), Mp


def used_tiles(sizes, tm):
    """int32 [1] on ``sizes``'s device: the tiles that hold rows."""
    return ((sizes.long() + tm - 1) // tm).sum().reshape(1).to(torch.int32)


def pad_groups_to_tiles(sizes, num_rows, tm):
    """Layout of group-SORTED rows → ``(dst [num_rows], tile_experts, Mp)``,
    ``dst`` mapping the j-th sorted row to its padded position."""
    padded_starts, tile_experts, Mp = tile_layout(sizes, num_rows, tm)
    ends = torch.cumsum(sizes.long(), 0)
    starts = ends - sizes.long()
    row = torch.arange(num_rows, device=sizes.device)
    expert_of_row = torch.searchsorted(ends, row, right=True)
    dst = padded_starts[expert_of_row] + (row - starts[expert_of_row])
    return dst.to(torch.int32), tile_experts, Mp


def _grouped_ref(x, tile_experts, tm, used, weight_of, out_cols, ct):
    """Each used row tile of ``x`` times its expert's ``weight_of(e)``
    [K, N] in ``ct``, → [Mp, N] in x's dtype, zeros past ``used`` tiles."""
    Mp = x.shape[0]
    te = tile_experts.long()
    n_used = Mp // tm if used is None else int(used.reshape(-1)[0])
    out = torch.zeros((Mp, out_cols), dtype=x.dtype, device=x.device)
    for e in torch.unique(te[:n_used]).tolist():
        tiles = (te[:n_used] == e).nonzero().reshape(-1)
        rows = (tiles[:, None] * tm + torch.arange(tm, device=x.device)).reshape(-1)
        out[rows] = (x[rows].to(ct) @ weight_of(e).to(ct)).to(x.dtype)
    return out


def gmm_ref(x, w, tile_experts, tm, used_tiles=None):
    """Plain version of :func:`gmm`."""
    return _grouped_ref(x, tile_experts, tm, used_tiles, lambda e: w[e], w.shape[-1],
                        torch.promote_types(x.dtype, w.dtype))


def gmm_quant_ref(x, values, scales, tile_experts, scheme, dequant_dtype=torch.bfloat16,
                  tm=64, used_tiles=None):
    """Plain version of :func:`gmm_quant`: each used expert's carriers
    dequantized with ``dequantize_grouped``, then the tile products."""
    return _grouped_ref(
        x, tile_experts, tm, used_tiles,
        lambda e: dequantize_grouped(values[e], scales[e], scheme, dequant_dtype),
        carrier_cols(values, scheme), torch.promote_types(x.dtype, dequant_dtype))


def gmm_quant_supported(values, scales, scheme):
    """Whether ``values``/``scales`` are stacked grouped carriers the
    kernel takes (any K; the group width must divide N, and be a
    multiple of 4 for fp6)."""
    if values.dim() != 3 or scales.dim() != 3 or scheme not in SCHEME_CODE:
        return False
    ng = scales.shape[-1]
    N = carrier_cols(values, scheme)
    if ng == 0 or N % ng or (scheme == "fp6" and ((N // ng) % 4 or values.shape[-1] % 3)):
        return False
    return True


def _lib():
    from deepspeed_tpu_torch.ops.kernels.build import load
    fn = load(_SOURCE).ds_grouped_matmul
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _launch(x, w, scales, tile_experts, used_tiles, N, ng, E, scheme_code, tm):
    """Check the layout operands, then launch → [Mp, N] bf16."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"x must be bf16 for the kernel, got {x.dtype}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous [Mp, K] tensor, got {tuple(x.shape)}")
    if tm not in ROW_TILES:
        raise ValueError(f"row tile {tm}: the kernel is built for {ROW_TILES}")
    Mp, K = x.shape
    if Mp % tm or tuple(tile_experts.shape) != (Mp // tm,):
        raise ValueError(f"x rows {Mp} and tile_experts {tuple(tile_experts.shape)} are not a "
                         f"layout of {tm}-row tiles")
    if used_tiles is None:
        used_tiles = torch.full((1,), Mp // tm, dtype=torch.int32, device=x.device)
    for name, t in (("tile_experts", tile_experts), ("used_tiles", used_tiles)):
        if t.dtype != torch.int32 or t.device != x.device or not t.is_contiguous():
            raise TypeError(f"{name} must be a contiguous int32 tensor on {x.device}")
    if used_tiles.numel() != 1:
        raise ValueError(f"used_tiles must hold one count, got {tuple(used_tiles.shape)}")
    out = torch.empty((Mp, N), dtype=torch.bfloat16, device=x.device)
    if Mp == 0 or N == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib()(x.data_ptr(), w.data_ptr(), None if scales is None else scales.data_ptr(),
                    tile_experts.data_ptr(), used_tiles.data_ptr(), out.data_ptr(), Mp, K, N,
                    ng, E, scheme_code, tm, stream)
    if rc != 0:
        raise RuntimeError(f"grouped matmul kernel failed to launch: cudaError {rc}")
    return out


def gmm(x, w, tile_experts, tm, used_tiles=None):
    """Grouped matmul: ``x`` [Mp, K] with rows tile-aligned by expert,
    ``w`` [E, K, N], ``tile_experts`` [Mp/tm] int32 → [Mp, N] in x's
    dtype. CUDA tensors (bf16, contiguous, tm 16 or 64) launch the kernel
    or raise; CPU tensors take :func:`gmm_ref`."""
    if x.device.type == "cpu":
        return gmm_ref(x, w, tile_experts, tm, used_tiles)
    if w.dtype != torch.bfloat16 or w.dim() != 3 or not w.is_contiguous() or \
            w.device != x.device:
        raise ValueError(f"w must be a contiguous bf16 [E, K, N] stack on {x.device}, got "
                         f"{w.dtype} {tuple(w.shape)} on {w.device}")
    if w.shape[1] != x.shape[-1]:
        raise ValueError(f"x [Mp, {x.shape[-1]}] does not contract with w {tuple(w.shape)}")
    out = _launch(x, w, None, tile_experts, used_tiles, w.shape[2], 1, w.shape[0], 0, tm)
    gmm.launches += 1
    return out


def gmm_quant(x, values, scales, tile_experts, scheme, dequant_dtype=torch.bfloat16, tm=64,
              used_tiles=None):
    """:func:`gmm` over grouped quantized expert carriers ``values``
    [E, K, N] (int8 / fp8; packed fp6 [E, K, 3N/4] uint8) and ``scales``
    [E, K, ng] fp32, each weight dequantized to ``dequant_dtype`` before
    the product. CUDA tensors (bf16 x and ``dequant_dtype``) launch the
    kernel or raise; CPU tensors take :func:`gmm_quant_ref`."""
    if x.device.type == "cpu":
        return gmm_quant_ref(x, values, scales, tile_experts, scheme, dequant_dtype, tm,
                             used_tiles)
    if dequant_dtype != torch.bfloat16:
        raise TypeError(f"the kernel dequantizes to bf16, got {dequant_dtype}")
    K, N, ng = check_carriers(values, scales, scheme, x.device, stacked=True)
    if K != x.shape[-1]:
        raise ValueError(f"x [Mp, {x.shape[-1]}] does not contract with carriers "
                         f"{tuple(values.shape)}")
    out = _launch(x, values, scales, tile_experts, used_tiles, N, ng, values.shape[0],
                  SCHEME_CODE[scheme], tm)
    gmm_quant.launches += 1
    return out


gmm.launches = 0
gmm_quant.launches = 0
