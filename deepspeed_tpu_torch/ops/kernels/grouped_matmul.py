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
  ``dequantize_grouped`` does (the TPU ``_gmm_quant_kernel``);

and the backward kernels:

- :func:`gmm_dw`: ``dW[e] = Σ x_tileᵀ dy_tile`` over expert e's row tiles,
  fp32 sums rounded once to the weight's dtype (the TPU ``_gmm_dw_kernel``);
- :func:`gmm_transposed`: ``dy @ w[tile_experts]ᵀ``, the input gradient of
  :func:`gmm`, reading the stack as stored (the TPU package runs its
  forward kernel on ``w.swapaxes(1, 2)``); its launches count as ``gmm``'s;
- :func:`gmm_quant_dx`: ``dy @ dequant(carriers[tile_experts])ᵀ``, the input
  gradient through a frozen quantized stack (the TPU
  ``_gmm_quant_dx_kernel``).

A CUDA tensor launches the CUDA C++ kernel ``csrc/grouped_matmul.cu``
(its header says what bounds it and what the design does about that) or
raises; a CPU tensor takes the plain version (:func:`gmm_ref`,
:func:`gmm_quant_ref`). ``used_tiles``, an int32 device tensor of one
element, tells the kernel how many leading tiles hold rows: the layout
is sized for the worst case (``Mp`` is static), the count comes from the
routing on the device, and the kernel writes zeros to the tiles past it
without reading any weight. The TPU kernels' scalar prefetch, tile
ladder and VMEM budget do not carry over: a block reads its own tile's
expert or its work item, built on the device.

The bf16 GEMMs have two designs each, chosen by shape before the launch
and never by the routing, and counted by design:

- the input gradients (:func:`dx_design`, ``gmm_dx_design_launches``):
  where TMA can read dy and the stack, wgmma on 128 x 256 tiles of dx fed
  by a TMA ring, over a work list built on the device (:func:`gmm_plan`);
- the forward over a bf16 stack (``gmm_fwd_design_launches``) and the
  weight gradient (``gmm_dw_design_launches``), both by
  :func:`wgmma_design`: at 64-row tiles where TMA can read both operands,
  the same ring with the stack's rows read across (the forward, over the
  same work list) or 128 x 256 tiles of dW over each expert's run of rows,
  which each block finds among the used tiles (:func:`gmm_dw_runs_ref`);

else the first, general design (a bf16 stack at decode's 16-row tiles
keeps it: it runs near its byte bound there). The forward through
carriers (``gmm_quant``) has three, by :func:`quant_design`, counted in
``gmm_quant_design_launches``: at 64-row tiles the forward ring, its
carrier stages decoded into the boxes wgmma reads; at 16-row tiles the
decode design, which streams the carriers through the same decoder and
swaps the operands (64 weight columns by the item's 16-row x tiles);
where TMA cannot read x or the carriers, the first design.
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


def _lib_fn(name, argtypes):
    """The library's entry ``name`` with its argument types (and the stream
    last), building the library on first use."""
    from deepspeed_tpu_torch.ops.kernels.build import load
    fn = getattr(load(_SOURCE), name)
    if fn.argtypes is None:
        fn.argtypes = list(argtypes) + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn



def _check_layout(x, tile_experts, used_tiles, tm, name="x"):
    """Raise unless ``x`` is a contiguous bf16 [Mp, ·] tile layout the
    kernels take → used_tiles (all tiles when None)."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name} must be bf16 for the kernel, got {x.dtype}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 2-D tensor, got {tuple(x.shape)}")
    if tm not in ROW_TILES:
        raise ValueError(f"row tile {tm}: the kernel is built for {ROW_TILES}")
    Mp = x.shape[0]
    if Mp % tm or tuple(tile_experts.shape) != (Mp // tm,):
        raise ValueError(f"{name} rows {Mp} and tile_experts {tuple(tile_experts.shape)} are "
                         f"not a layout of {tm}-row tiles")
    if used_tiles is None:
        used_tiles = torch.full((1,), Mp // tm, dtype=torch.int32, device=x.device)
    for n, t in (("tile_experts", tile_experts), ("used_tiles", used_tiles)):
        if t.dtype != torch.int32 or t.device != x.device or not t.is_contiguous():
            raise TypeError(f"{n} must be a contiguous int32 tensor on {x.device}")
    if used_tiles.numel() != 1:
        raise ValueError(f"used_tiles must hold one count, got {tuple(used_tiles.shape)}")
    return used_tiles


def _launch(x, w, scales, tile_experts, used_tiles, N, ng, E, scheme, tm):
    """Check the layout operands, choose the design by shape, then launch
    → [Mp, N] bf16."""
    used_tiles = _check_layout(x, tile_experts, used_tiles, tm)
    Mp, K = x.shape
    out = torch.empty((Mp, N), dtype=torch.bfloat16, device=x.device)
    if Mp == 0 or N == 0:
        return out
    ptrs = x.data_ptr(), w.data_ptr()
    design = wgmma_design(tm, K, N, *ptrs) if scheme == "bf16" else \
        quant_design(scheme, tm, K, N, *ptrs)
    plan = gmm_plan(tile_experts, used_tiles, tm, E) if design != "general" else None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        fn = _lib_fn("ds_grouped_matmul", [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 +
                     [ctypes.c_void_p, ctypes.c_int])
        rc = fn(*ptrs, None if scales is None else scales.data_ptr(), tile_experts.data_ptr(),
                used_tiles.data_ptr(), out.data_ptr(), Mp, K, N, ng, E, SCHEME_CODE.get(scheme, 0),
                tm, None if plan is None else plan.data_ptr(),
                0 if plan is None else plan.shape[0], stream)
    if rc != 0:
        raise RuntimeError(f"grouped matmul kernel ({design} design) failed to launch: "
                           f"cudaError {rc}")
    (gmm_fwd_design_launches if scheme == "bf16" else gmm_quant_design_launches)[design] += 1
    return out


def gmm(x, w, tile_experts, tm, used_tiles=None):
    """Grouped matmul: ``x`` [Mp, K] with rows tile-aligned by expert,
    ``w`` [E, K, N], ``tile_experts`` [Mp/tm] int32 → [Mp, N] in x's
    dtype. CUDA tensors (bf16, contiguous, tm 16 or 64) launch the kernel,
    on the design :func:`wgmma_design` names (counted in
    ``gmm_fwd_design_launches``), or raise; CPU tensors take
    :func:`gmm_ref`."""
    if x.device.type == "cpu":
        return gmm_ref(x, w, tile_experts, tm, used_tiles)
    if w.dtype != torch.bfloat16 or w.dim() != 3 or not w.is_contiguous() or \
            w.device != x.device:
        raise ValueError(f"w must be a contiguous bf16 [E, K, N] stack on {x.device}, got "
                         f"{w.dtype} {tuple(w.shape)} on {w.device}")
    if w.shape[1] != x.shape[-1]:
        raise ValueError(f"x [Mp, {x.shape[-1]}] does not contract with w {tuple(w.shape)}")
    out = _launch(x, w, None, tile_experts, used_tiles, w.shape[2], 1, w.shape[0], "bf16", tm)
    gmm.launches += 1
    return out


def gmm_quant(x, values, scales, tile_experts, scheme, dequant_dtype=torch.bfloat16, tm=64,
              used_tiles=None):
    """:func:`gmm` over grouped quantized expert carriers ``values``
    [E, K, N] (int8 / fp8; packed fp6 [E, K, 3N/4] uint8) and ``scales``
    [E, K, ng] fp32, each weight dequantized to ``dequant_dtype`` before
    the product. CUDA tensors (bf16 x and ``dequant_dtype``) launch the
    kernel, on the design :func:`quant_design` names (counted in
    ``gmm_quant_design_launches``), or raise; CPU tensors take
    :func:`gmm_quant_ref`."""
    if x.device.type == "cpu":
        return gmm_quant_ref(x, values, scales, tile_experts, scheme, dequant_dtype, tm,
                             used_tiles)
    if dequant_dtype != torch.bfloat16:
        raise TypeError(f"the kernel dequantizes to bf16, got {dequant_dtype}")
    K, N, ng = check_carriers(values, scales, scheme, x.device, stacked=True)
    if K != x.shape[-1]:
        raise ValueError(f"x [Mp, {x.shape[-1]}] does not contract with carriers "
                         f"{tuple(values.shape)}")
    out = _launch(x, values, scales, tile_experts, used_tiles, N, ng, values.shape[0], scheme,
                  tm)
    gmm_quant.launches += 1
    return out


gmm.launches = 0
gmm_quant.launches = 0


def gmm_transposed_ref(dy, w, tile_experts, tm, used_tiles=None):
    """Plain version of :func:`gmm_transposed`."""
    return gmm_ref(dy, w.transpose(1, 2), tile_experts, tm, used_tiles)


def gmm_quant_dx_ref(dy, values, scales, tile_experts, scheme, dequant_dtype=torch.bfloat16,
                     tm=64, used_tiles=None):
    """Plain version of :func:`gmm_quant_dx`: each used expert's carriers
    dequantized with ``dequantize_grouped``, then ``dy_tile @ wᵀ``."""
    return _grouped_ref(
        dy, tile_experts, tm, used_tiles,
        lambda e: dequantize_grouped(values[e], scales[e], scheme, dequant_dtype).t(),
        values.shape[-2], torch.promote_types(dy.dtype, dequant_dtype))


def gmm_dw_ref(x, dy, tile_experts, num_experts, tm, used_tiles=None, out_dtype=None):
    """Plain version of :func:`gmm_dw`: per expert, the sum of ``x_tileᵀ @
    dy_tile`` over its used row tiles in fp32 (or wider inputs' type), in
    ``out_dtype`` (x's dtype when None); experts with no tile get zeros."""
    Mp, K = x.shape
    ct = torch.promote_types(torch.promote_types(x.dtype, dy.dtype), torch.float32)
    te = tile_experts.long()
    n_used = Mp // tm if used_tiles is None else int(used_tiles.reshape(-1)[0])
    out = torch.zeros((num_experts, K, dy.shape[1]), dtype=ct, device=x.device)
    for e in torch.unique(te[:n_used]).tolist():
        tiles = (te[:n_used] == e).nonzero().reshape(-1)
        rows = (tiles[:, None] * tm + torch.arange(tm, device=x.device)).reshape(-1)
        out[e] = x[rows].to(ct).t() @ dy[rows].to(ct)
    return out.to(out_dtype or x.dtype)


PLAN_ROWS = 128  # output rows a block of the wgmma forward and dx designs (csrc RING_ROWS)
gmm_dx_design_launches = {"wgmma": 0, "general": 0}
gmm_fwd_design_launches = {"wgmma": 0, "general": 0}  # gmm over a bf16 stack
gmm_dw_design_launches = {"wgmma": 0, "general": 0}
gmm_quant_design_launches = {"wgmma": 0, "stream": 0, "general": 0}  # gmm_quant


def dx_design(scheme, N, *ptrs):
    """The dx design the kernel takes for a contraction of ``N`` over a
    ``scheme`` stack ("bf16", "int8", "fp8", "fp6"), dy and the stack at
    device addresses ``ptrs``: "wgmma" where TMA can read both (16-byte
    aligned bases, and rows of dy and W a multiple of 16 bytes: N % 8 for
    bf16, N % 16 for int8 and fp8, N % 64 for fp6's 3N/4-byte rows), else
    "general", the first design, which takes every shape."""
    row = {"bf16": 2 * N, "int8": N, "fp8": N, "fp6": 3 * N // 4}[scheme]  # W's row bytes
    ok = (2 * N) % 16 == 0 and row % 16 == 0 and all(p % 16 == 0 for p in ptrs)
    return "wgmma" if ok else "general"


def wgmma_design(tm, K, N, *ptrs):
    """The design the forward over a bf16 stack (x [Mp, K] @ w [E, K, N])
    and the weight gradient (x [Mp, K], dy [Mp, N]) take, their two
    operands at device addresses ``ptrs``: "wgmma" at 64-row tiles where
    TMA can read both (16-byte aligned bases, K % 8 and N % 8: rows a
    multiple of 16 bytes), else "general", the first design, which takes
    every shape. It depends on the tile, the shape and the alignment,
    never on the row count or the routing."""
    ok = tm == 64 and K % 8 == 0 and N % 8 == 0 and all(p % 16 == 0 for p in ptrs)
    return "wgmma" if ok else "general"


def quant_design(scheme, tm, K, N, *ptrs):
    """The design the forward through ``scheme`` carriers ("int8", "fp8",
    "fp6"; x [Mp, K] @ carriers [E, K, N]) takes, x and the carriers at
    device addresses ``ptrs``. Where TMA can read both (16-byte aligned
    bases, x's rows K % 8, the carriers' rows a multiple of 16 bytes: N %
    16 for int8 and fp8, N % 64 for fp6's 3N/4 bytes): "wgmma" at 64-row
    tiles (the forward ring: [64 K][256 N] carrier stages decoded for
    wgmma), "stream" at 16-row tiles (the decode design, operands
    swapped: 64 N of decoded carriers times the item's x tiles); else
    "general", the first design, which takes every shape. It depends on
    the scheme, the tile, the shape and the alignment, never on the row
    count or the routing."""
    row = {"int8": N, "fp8": N, "fp6": 3 * N // 4}[scheme]  # the carriers' row bytes
    if K % 8 or row % 16 or (scheme == "fp6" and N % 4) or any(p % 16 for p in ptrs):
        return "general"
    return {64: "wgmma", 16: "stream"}.get(tm, "general")


def _plan_bound(T, tm, num_experts):
    return min(T, -(-T // (PLAN_ROWS // tm)) + num_experts)


def gmm_plan_ref(tile_experts, used_tiles, tm, num_experts):
    """Plain version of :func:`gmm_plan`, in torch ops on ``tile_experts``'s
    device with no host sync → int32 [bound, 5], ``bound = min(T,
    ceil(T / P) + num_experts)`` for T = Mp / tm tiles and P = 128 / tm
    tiles an item.

    An item is up to P consecutive used tiles of one run of equal
    ``tile_experts``: (first row, rows, expert, the run's first item, the
    run's item count). The kernel gives a block one item and one 256-wide
    column block of the output, and the blocks of a run take its column
    blocks in turn, so the run's rows and each W column block stay in L2
    while they are read. The slots past the last item form one more
    group, with expert -1 and first row ``used_tiles * tm``: their blocks
    write the zeros of the rows past the used tiles. The bound holds when
    each expert's used tiles are one run, as :func:`tile_layout` makes
    them."""
    T = tile_experts.shape[0]
    P = PLAN_ROWS // tm
    bound = _plan_bound(T, tm, num_experts)
    dev = tile_experts.device
    t = torch.arange(T, device=dev)
    te = tile_experts.long()
    used = used_tiles.reshape(()).long()
    valid = t < used
    new_run = valid.clone()
    new_run[1:] &= te[1:] != te[:-1]
    run_start = torch.cummax(torch.where(new_run, t, 0), 0).values
    starts = valid & ((t - run_start) % P == 0)  # tiles that begin an item
    item = torch.cumsum(starts, 0) - 1           # each used tile's item
    n_items = starts.sum()
    one = torch.ones_like(t)

    def per_item(index, src, op):  # slot `bound` takes what belongs to no item
        buf = torch.zeros(bound + 1, dtype=torch.long, device=dev)
        return getattr(buf, op)(0, index, src)[:bound]

    first_tile = per_item(torch.where(starts, item, bound), t, "scatter_")
    tiles = per_item(torch.where(valid, item, bound), one, "scatter_add_")
    run_first = item[run_start]                  # each used tile's run's first item
    group_first = run_first[first_tile]
    group_count = per_item(torch.where(starts, run_first, bound), one, "scatter_add_")[
        group_first.clamp(0, bound - 1)]
    live = t[:bound] < n_items
    plan = torch.stack([torch.where(live, first_tile * tm, used * tm),
                        torch.where(live, tiles * tm, 0),
                        torch.where(live, te[first_tile], -1),
                        torch.where(live, group_first, n_items),
                        torch.where(live, group_count, bound - n_items)], 1)
    return plan.to(torch.int32)


def gmm_dw_runs_ref(tile_experts, used_tiles, tm, num_experts):
    """Plain version of the run each block of the wgmma dW design finds
    for its expert before its ring starts, in torch ops on
    ``tile_experts``'s device with no host sync → int32 [num_experts, 2]:
    each expert's first row and rows among the used tiles (0, 0 for an
    expert with none; tiles whose expert is out of range count for none).
    Each expert's used tiles must be one run, as :func:`tile_layout`
    makes them."""
    T = tile_experts.shape[0]
    dev = tile_experts.device
    t = torch.arange(T, device=dev)
    te = tile_experts.long()
    valid = (t < used_tiles.reshape(()).long()) & (te >= 0) & (te < num_experts)
    slot = torch.where(valid, te, num_experts)  # slot num_experts takes the rest
    tiles = torch.zeros(num_experts + 1, dtype=torch.long, device=dev).scatter_add_(
        0, slot, torch.ones_like(t))[:num_experts]
    first = torch.full((num_experts + 1,), T, dtype=torch.long, device=dev).scatter_reduce_(
        0, slot, t, "amin")[:num_experts]
    return torch.stack([torch.where(tiles > 0, first * tm, 0), tiles * tm], 1).to(torch.int32)


def gmm_plan(tile_experts, used_tiles, tm, num_experts):
    """The work list of the wgmma forward and dx designs (the items and
    groups :func:`gmm_plan_ref` describes, the same integers). On CUDA
    tensors (contiguous int32) one launch of a one-thread kernel builds it
    (counted in ``gmm_plan.launches``; the plain version is ~45 small ops,
    which set the pace at serving sizes); CPU tensors take
    :func:`gmm_plan_ref`."""
    if tile_experts.device.type == "cpu":
        return gmm_plan_ref(tile_experts, used_tiles, tm, num_experts)
    bound = _plan_bound(tile_experts.shape[0], tm, num_experts)
    out = torch.empty((bound, 5), dtype=torch.int32, device=tile_experts.device)
    with torch.cuda.device(tile_experts.device):
        fn = _lib_fn("ds_gmm_plan", [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        rc = fn(tile_experts.data_ptr(), used_tiles.data_ptr(), tile_experts.shape[0], tm, bound,
                out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ds_gmm_plan failed to launch: cudaError {rc}")
    gmm_plan.launches += 1
    return out


gmm_plan.launches = 0


def _launch_dx(dy, w, scales, tile_experts, used_tiles, K, ng, E, scheme, tm):
    """Check the layout, choose the design by shape, launch → [Mp, K] bf16."""
    used_tiles = _check_layout(dy, tile_experts, used_tiles, tm, "dy")
    Mp, N = dy.shape
    out = torch.empty((Mp, K), dtype=torch.bfloat16, device=dy.device)
    if Mp == 0 or K == 0:
        return out
    design = dx_design(scheme, N, dy.data_ptr(), w.data_ptr())
    plan = gmm_plan(tile_experts, used_tiles, tm, E) if design == "wgmma" else None
    with torch.cuda.device(dy.device):
        stream = torch.cuda.current_stream().cuda_stream
        fn = _lib_fn("ds_gmm_dx", [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 +
                     [ctypes.c_void_p, ctypes.c_int])
        rc = fn(dy.data_ptr(), w.data_ptr(), None if scales is None else scales.data_ptr(),
                tile_experts.data_ptr(), used_tiles.data_ptr(), out.data_ptr(), Mp, K, N, ng,
                E, SCHEME_CODE.get(scheme, 0), tm, None if plan is None else plan.data_ptr(),
                0 if plan is None else plan.shape[0], stream)
    if rc != 0:
        raise RuntimeError(f"grouped dx kernel ({design} design) failed to launch: cudaError {rc}")
    gmm_dx_design_launches[design] += 1
    return out


def gmm_transposed(dy, w, tile_experts, tm, used_tiles=None):
    """``dy [Mp, N] @ w[tile_experts]ᵀ`` for a stack ``w`` [E, K, N] →
    [Mp, K] in dy's dtype: :func:`gmm`'s input gradient, reading ``w`` as
    stored (no transposed copy). CUDA tensors (bf16, contiguous) launch
    the kernel, counted in ``gmm.launches``, or raise; CPU tensors take
    :func:`gmm_transposed_ref`."""
    if dy.device.type == "cpu":
        return gmm_transposed_ref(dy, w, tile_experts, tm, used_tiles)
    if w.dtype != torch.bfloat16 or w.dim() != 3 or not w.is_contiguous() or \
            w.device != dy.device:
        raise ValueError(f"w must be a contiguous bf16 [E, K, N] stack on {dy.device}, got "
                         f"{w.dtype} {tuple(w.shape)} on {w.device}")
    if w.shape[2] != dy.shape[-1]:
        raise ValueError(f"dy [Mp, {dy.shape[-1]}] does not contract with w {tuple(w.shape)}")
    out = _launch_dx(dy, w, None, tile_experts, used_tiles, w.shape[1], 1, w.shape[0], "bf16",
                     tm)
    gmm.launches += 1
    return out


def gmm_quant_dx(dy, values, scales, tile_experts, scheme, dequant_dtype=torch.bfloat16,
                 tm=64, used_tiles=None):
    """``dy [Mp, N] @ dequant(values, scales)[tile_experts]ᵀ`` → [Mp, K] in
    dy's dtype: the input gradient of :func:`gmm_quant` through frozen
    carriers (int8 / fp8 [E, K, N]; packed fp6 [E, K, 3N/4]; fp32 scales
    [E, K, ng]). CUDA tensors (bf16 dy and ``dequant_dtype``) launch the
    kernel or raise; CPU tensors take :func:`gmm_quant_dx_ref`."""
    if dy.device.type == "cpu":
        return gmm_quant_dx_ref(dy, values, scales, tile_experts, scheme, dequant_dtype, tm,
                                used_tiles)
    if dequant_dtype != torch.bfloat16:
        raise TypeError(f"the kernel dequantizes to bf16, got {dequant_dtype}")
    K, N, ng = check_carriers(values, scales, scheme, dy.device, stacked=True)
    if N != dy.shape[-1]:
        raise ValueError(f"dy [Mp, {dy.shape[-1]}] does not contract with carriers "
                         f"{tuple(values.shape)}")
    out = _launch_dx(dy, values, scales, tile_experts, used_tiles, K, ng, values.shape[0],
                     scheme, tm)
    gmm_quant_dx.launches += 1
    return out


def gmm_dw(x, dy, tile_experts, num_experts, tm, used_tiles=None, out_dtype=None):
    """Per-expert weight gradient on the tile layout: ``x`` [Mp, K], ``dy``
    [Mp, N] (pad rows zero in both) → [E, K, N], each expert the fp32 sum
    of ``x_tileᵀ @ dy_tile`` over its used row tiles rounded once to
    ``out_dtype`` (x's dtype when None); experts with no tile get zeros.
    Deterministic. CUDA tensors (bf16, contiguous, each expert's tiles
    contiguous as :func:`tile_layout` makes them) launch the kernel, on
    the design :func:`wgmma_design` names (counted in
    ``gmm_dw_design_launches``), or raise; CPU tensors take
    :func:`gmm_dw_ref`."""
    if x.device.type == "cpu":
        return gmm_dw_ref(x, dy, tile_experts, num_experts, tm, used_tiles, out_dtype)
    if (out_dtype or x.dtype) != torch.bfloat16:
        raise TypeError(f"the kernel writes bf16, got {out_dtype}")
    used_tiles = _check_layout(x, tile_experts, used_tiles, tm)
    _check_layout(dy, tile_experts, used_tiles, tm, "dy")
    if dy.device != x.device or dy.shape[0] != x.shape[0]:
        raise ValueError(f"dy {tuple(dy.shape)} on {dy.device} is not x's rows")
    Mp, K = x.shape
    N = dy.shape[1]
    out = torch.empty((num_experts, K, N), dtype=torch.bfloat16, device=x.device)
    if out.numel() == 0:
        return out
    design = wgmma_design(tm, K, N, x.data_ptr(), dy.data_ptr())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        fn = _lib_fn("ds_gmm_dw", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6)
        rc = fn(x.data_ptr(), dy.data_ptr(), tile_experts.data_ptr(), used_tiles.data_ptr(),
                out.data_ptr(), Mp, K, N, num_experts, tm, int(design == "wgmma"), stream)
    if rc != 0:
        raise RuntimeError(f"grouped dW kernel ({design} design) failed to launch: cudaError {rc}")
    gmm_dw_design_launches[design] += 1
    gmm_dw.launches += 1
    return out


gmm_dw.launches = 0
gmm_quant_dx.launches = 0
