"""Segmented multi-tenant LoRA delta: every tenant's adapter in one pass.

Port of ``deepspeed_tpu/ops/pallas/lora_matmul.py``. A batch that mixes
many tenants' adapters is a grouped matmul over per-token adapter slots:
the tokens are sorted by slot and each slot's group is padded to a
multiple of the row tile ``tm`` (:func:`segment_tokens`, the same
integers as the JAX function for the same ``tm``, through the MoE
layout's :func:`pad_groups_to_tiles`), so every row tile belongs to one
slot, and for a token ``t`` of slot ``g``::

    delta[t] = ((x[t] @ A[g]) @ B[g]) * scales[g]

with both products in fp32 (the rank-r intermediate stays fp32), the
scaled result rounded to x's dtype. Slot 0 is the base model: its rows
get exactly nothing. Each row's delta depends on that row alone, so a
token's delta is bit-identical whether it shares the batch with other
tenants or runs solo (the arithmetic half of tenant isolation).

:func:`lora_delta` is the kernel wrapper the serving path calls: it adds
the delta into the base projection ``y`` in place, in x's dtype. A CUDA
tensor launches the CUDA C++ kernel ``csrc/lora_matmul.cu`` (its header
says what bounds it and what the design does about that) or raises; a
CPU tensor takes the plain version :func:`lora_delta_ref`. The layout is
built once per forward by :func:`lora_layout`, on the device and with
no host sync (``Mp`` is the static worst case, and the count of tiles
that hold rows stays on the device), and serves all 4 x L calls of that
forward. :func:`apply_lora_delta` is the JAX module's entry: the delta
alone.

Not carried over: ``_fit_tile`` (the kernel masks a ragged column edge
itself), the scalar-prefetch grid (a block reads its own tile's slot),
and the ``FORCE_INTERPRET`` switch (the device of the tensors decides).
"""

import ctypes
from typing import NamedTuple

import torch

from deepspeed_tpu_torch.ops.kernels.grouped_matmul import pad_groups_to_tiles, used_tiles

_SOURCE = "lora_matmul.cu"
TM = 16                 # the row tile the kernel is built for
MAX_RANK = 64           # the largest rank bucket the kernel is built for
_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}


def _slot_sizes(slots, num_groups):
    """Tokens per slot, [G] int64 on ``slots``'s device, by a scatter-add
    into a fixed [G] (``bincount`` on CUDA reads its maximum back)."""
    sizes = torch.zeros(num_groups, dtype=torch.int64, device=slots.device)
    return sizes.scatter_add_(0, slots.long(), torch.ones_like(slots, dtype=torch.int64))


def _segment(slots, num_groups, tm):
    sizes = _slot_sizes(slots, num_groups)
    order = torch.argsort(slots, stable=True).to(torch.int32)
    dst, tile_groups, Mp = pad_groups_to_tiles(sizes, slots.shape[0], tm)
    return sizes, order, dst, tile_groups, Mp


def segment_tokens(slots, num_groups, tm):
    """``slots`` [T] int32 adapter slot per token (0 = base) →
    ``(order, dst, tile_groups, Mp)``: the stable slot-sort permutation,
    each sorted row's padded destination, the slot owning each row tile
    (tiles past the last group take the last slot: their rows are
    padding), and the static padded row count."""
    return _segment(slots, num_groups, tm)[1:]


class LoraLayout(NamedTuple):
    """One forward's segmentation of its tokens by adapter slot."""
    slots: torch.Tensor        # [T] int32 slot of each token (the plain version's input)
    rows: torch.Tensor         # [Mp] int32 token at each padded row, -1 for padding
    tile_groups: torch.Tensor  # [Mp / tm] int32 slot owning each row tile
    used: torch.Tensor         # [1] int32 leading tiles that hold rows
    tm: int


def lora_layout(slots, num_groups, tm=TM):
    """The kernel's layout of ``slots`` [T] over ``num_groups`` slots,
    computed on ``slots``'s device with no host sync."""
    slots = slots.to(torch.int32)
    sizes, order, dst, tile_groups, Mp = _segment(slots, num_groups, tm)
    rows = torch.full((Mp,), -1, dtype=torch.int32, device=slots.device)
    rows.scatter_(0, dst.long(), order)
    return LoraLayout(slots, rows, tile_groups, used_tiles(sizes, tm), tm)


def lora_delta_ref(x, slots, a, b, scales):
    """Plain version: ``x`` [T, K], ``slots`` [T], ``a`` [G, K, r], ``b``
    [G, r, N], ``scales`` [G] fp32 → the delta [T, N] in x's dtype, slot-0
    rows exactly zero. Each token's own slabs are gathered, and both
    products are elementwise fp32 products summed over the contracted
    dim, so a row's arithmetic does not depend on T: the CPU sum runs
    each output's reduction in one fixed order (it splits a reduction
    across threads only when there is one output). A batched matmul
    (``bmm``, or the JAX ``einsum`` over all slots) is not bitwise row
    independent on the CPU: BLAS picks its blocking by the batch."""
    s = slots.long()
    h = (x.float()[:, :, None] * a[s].float()).sum(1)
    d = (h[:, :, None] * b[s].float()).sum(1) * scales.float()[s][:, None]
    return torch.where((s != 0)[:, None], d, torch.zeros((), device=d.device)).to(x.dtype)


def _lib():
    from deepspeed_tpu_torch.ops.kernels.build import load
    fn = load(_SOURCE).ds_lora_delta
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong]
                       + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(x, y, a, b, scales, layout):
    """Raise unless the operands are what the kernel takes → (K, N, r)."""
    dt = x.dtype
    if dt not in _DTYPE_CODE:
        raise TypeError(f"the kernel takes bf16 or fp32 x, got {dt}")
    if x.dim() != 2 or y.dim() != 2 or x.shape[0] != y.shape[0]:
        raise ValueError(f"want x [T, K] and y [T, N], got {tuple(x.shape)} and "
                         f"{tuple(y.shape)}")
    if a.dim() != 3 or b.dim() != 3 or a.shape[0] != b.shape[0] or a.shape[2] != b.shape[1]:
        raise ValueError(f"want slabs a [S, K, r] and b [S, r, N], got {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")
    S, K, r = a.shape
    N = b.shape[2]
    if x.shape[1] != K or y.shape[1] != N:
        raise ValueError(f"x {tuple(x.shape)} and y {tuple(y.shape)} do not match slabs "
                         f"[S, {K}, r] / [S, r, {N}]")
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"rank bucket {r}: the kernel is built for ranks 1-{MAX_RANK}")
    for name, t in (("y", y), ("a", a), ("b", b)):
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt} like x, got {t.dtype}")
    for name, t in (("x", x), ("y", y)):
        if t.stride(1) != 1 or t.stride(0) < t.shape[1]:
            raise ValueError(f"{name} must have unit column stride and non-overlapping rows, "
                             f"got strides {t.stride()}")
    for name, t in (("a", a), ("b", b)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if scales.dtype != torch.float32 or tuple(scales.shape) != (S,) or \
            not scales.is_contiguous():
        raise TypeError(f"scales must be a contiguous float32 [{S}], got {scales.dtype} "
                        f"{tuple(scales.shape)}")
    if layout.tm != TM:
        raise ValueError(f"row tile {layout.tm}: the kernel is built for {TM}")
    Mp = layout.rows.shape[0]
    if Mp % TM or tuple(layout.tile_groups.shape) != (Mp // TM,) or \
            tuple(layout.used.shape) != (1,) or layout.slots.shape[0] != x.shape[0]:
        raise ValueError(f"layout rows {Mp}, tile_groups {tuple(layout.tile_groups.shape)}, "
                         f"used {tuple(layout.used.shape)} and slots "
                         f"{tuple(layout.slots.shape)} are not a {TM}-row layout of "
                         f"{x.shape[0]} tokens")
    for name, t in (("y", y), ("a", a), ("b", b), ("scales", scales), ("rows", layout.rows),
                    ("tile_groups", layout.tile_groups), ("used", layout.used)):
        if t.device != x.device:
            raise ValueError(f"{name} must be on {x.device}, got {t.device}")
    for name in ("rows", "tile_groups", "used"):
        t = getattr(layout, name)
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise TypeError(f"layout {name} must be a contiguous int32 tensor")
    return K, N, r


def lora_delta(x, y, a, b, scales, layout):
    """``y += delta`` in place and → ``y``: ``x`` [T, K] (rows may be a
    strided view), ``y`` [T, N] the base projection in x's dtype, ``a``
    [S, K, r] / ``b`` [S, r, N] one layer's hot slabs in x's dtype,
    ``scales`` [S] fp32, ``layout`` from :func:`lora_layout`. Each
    element becomes ``round(y + round(delta))`` in x's dtype, as the JAX
    runner's ``y + apply_lora_delta(...)``. CUDA tensors launch the
    kernel (bf16 or fp32, rank buckets 1-64, row tile 16) or raise; CPU
    tensors take :func:`lora_delta_ref`."""
    if x.device.type == "cpu":
        return y.add_(lora_delta_ref(x, layout.slots, a, b, scales))
    K, N, r = _check(x, y, a, b, scales, layout)
    T, Mp = x.shape[0], layout.rows.shape[0]
    if T == 0 or N == 0:
        return y
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib()(x.data_ptr(), x.stride(0), y.data_ptr(), y.stride(0), a.data_ptr(),
                    b.data_ptr(), scales.data_ptr(), layout.rows.data_ptr(),
                    layout.tile_groups.data_ptr(), layout.used.data_ptr(), Mp, K, N, r,
                    _DTYPE_CODE[x.dtype], TM, stream)
    if rc != 0:
        raise RuntimeError(f"LoRA delta kernel failed to launch: cudaError {rc}")
    lora_delta.launches += 1
    return y


def apply_lora_delta(x, slots, a, b, scales, tm=TM):
    """The per-token LoRA delta [T, N] in x's dtype (the JAX entry's
    contract): :func:`lora_delta` into zeros, through the kernel on CUDA
    tensors and the plain version on CPU tensors."""
    y = torch.zeros((x.shape[0], b.shape[-1]), dtype=x.dtype, device=x.device)
    return lora_delta(x, y, a, b, scales, lora_layout(slots, a.shape[0], tm))


lora_delta.launches = 0
