"""Block-sparse attention, forward and backward, on [B, S, H, D] tensors.

Port of ``deepspeed_tpu/ops/pallas/block_sparse_attention.py``: attention
restricted to the key blocks a ``SparsityConfig`` layout admits, skipping
the others. The kernels are CUDA C++ for Hopper,
``csrc/block_sparse_attention.cu`` (its header says what bounds them and
what the design does about that), built by ``ops/kernels/build.py`` and
called through ctypes:

- :func:`block_sparse_fwd` launches the forward (the TPU ``_fwd_kernel``)
  → the output and the fp32 logsumexp [B, H, S];
- :func:`block_sparse_dq` and :func:`block_sparse_dkv` launch the backward
  kernels (``_dq_kernel``, ``_dkv_kernel``), which recompute the
  probabilities from the saved logsumexp.

Each of the three has two designs, named by :func:`bsa_design` from the
block and head dim alone and counted in ``bsa_design_launches``: "wgmma"
(blocks of 64 and 128: a persistent grid whose blocks take one query block
(forward, dQ) or key block (dK/dV) at a time, its 64-row tiles on wgmma,
fed by a TMA ring over its admitted list; the forward's online softmax in
registers between its two products, as K1's forward) and "first" (blocks
of 16 and 32, which give no 64-row tile of one list: mma.sync over
synchronous loads). ``design=`` forces one that can take the call; a CUDA
call that no design takes raises.

:func:`block_sparse_attention` is what ``SparseSelfAttention`` calls: a
``torch.autograd.Function`` over those three on CUDA tensors (bf16, head
dim 64 or 128, block 16, 32, 64 or 128, S a multiple of the block), and on
CPU tensors the plain version :func:`block_sparse_attention_ref`, whose
autograd gives the reference gradients. Masking is block-granular: a row
with no admitted block outputs zeros and lse ``NEG_INF``, and a key block
no query admits gets zero dK and dV (the masked-dense path of
``SparseSelfAttention`` gives such a row a uniform softmax instead).

The layout is host data. :func:`layout_to_indices` compresses it into the
per-row admitted-block lists, bit for bit the JAX function, cached by
layout content; the kernels' device copy of the lists (with each head's
rows ordered longest list first) is made once per (layout, device), so a
step copies nothing from the host. :func:`block_sparse_fwd_ref`,
:func:`block_sparse_dq_ref` and :func:`block_sparse_dkv_ref` are the plain
versions of each kernel (fp32, with the kernels' bf16 roundings of p and
ds in the backward), for ``chip_smoke.py`` and the GPU tests; they expand
the layout to a dense mask.
"""

import ctypes
import math

import numpy as np
import torch

from deepspeed_tpu_torch.ops.kernels.flash_attention import flash_delta

NEG_INF = -1e30  # the TPU kernel's NEG_INF
HEAD_DIMS = (64, 128)
BLOCKS = (16, 32, 64, 128)
WGMMA_BLOCKS = (64, 128)  # a wgmma tile is 64 rows of one block's list
DESIGNS = ("wgmma", "first")
_SOURCE = "block_sparse_attention.cu"

# launches of the three kernels by design
bsa_design_launches = {"block_sparse_fwd": dict.fromkeys(DESIGNS, 0),
                       "block_sparse_dq": dict.fromkeys(DESIGNS, 0),
                       "block_sparse_dkv": dict.fromkeys(DESIGNS, 0)}


def bsa_design(block, D):
    """The design a launch takes, from its block and head dim: "wgmma" at
    blocks of 64 and 128 (head dims 64 and 128), "first" at 16 and 32,
    whose 64-row tiles would span four or two lists."""
    return "wgmma" if block in WGMMA_BLOCKS and D in HEAD_DIMS else "first"

_INDICES_CACHE = {}
_DEVICE_CACHE = {}


def layout_to_indices(layout):
    """[H, nq, nk] bool → (k_idx [H, nq, A], k_nnz [H, nq], q_idx [H, nk,
    Aq], q_nnz [H, nk]) int32 numpy arrays: per-(head, row) admitted-column
    lists (zero-padded) and their true lengths; the ``q_*`` pair is the
    transpose, for the dK/dV pass. Cached by layout content."""
    layout = np.asarray(layout, bool)
    key = (layout.shape, layout.tobytes())
    hit = _INDICES_CACHE.get(key)
    if hit is not None:
        return hit

    def compress(lay):  # [H, R, C] → idx [H, R, A], nnz [H, R]
        nnz = lay.sum(-1)
        a = max(int(nnz.max()), 1)
        idx = np.zeros((lay.shape[0], lay.shape[1], a), np.int32)
        for h in range(lay.shape[0]):
            for r in range(lay.shape[1]):
                cols = np.nonzero(lay[h, r])[0]
                idx[h, r, :len(cols)] = cols
        return idx, nnz.astype(np.int32)

    k_idx, k_nnz = compress(layout)
    q_idx, q_nnz = compress(layout.transpose(0, 2, 1))
    if len(_INDICES_CACHE) > 64:  # layouts are few; guard pathological use
        _INDICES_CACHE.clear()
    _INDICES_CACHE[key] = (k_idx, k_nnz, q_idx, q_nnz)
    return k_idx, k_nnz, q_idx, q_nnz


def grid_fraction(layout):
    """Fraction of the dense (H x nq x nk) block-pair count the kernels'
    inner loops execute: the layout density."""
    return float(np.asarray(layout, bool).mean())


def full_layout(layout, H, S, block):
    """A [1 or H, nq, nk] layout as [H, S / block, S / block] bool numpy."""
    layout = np.asarray(layout, bool)
    if layout.shape[0] == 1 and H > 1:
        layout = np.broadcast_to(layout, (H,) + layout.shape[1:])
    if layout.shape != (H, S // block, S // block) or S % block:
        raise ValueError(f"layout {layout.shape} vs heads {H}, seq {S}, block {block}")
    return layout


def block_mask(layout, block, device=None):
    """[H, nb, nb] layout → [H, nb * block, nb * block] bool tensor."""
    lay = torch.from_numpy(np.ascontiguousarray(np.asarray(layout, bool))).to(device)
    return lay.repeat_interleave(block, 1).repeat_interleave(block, 2)


def _scores(q, k, layout, block, sm_scale):
    """fp32 scores [B, H, S, S] and the layout's mask [H, S, S]."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    return s, block_mask(layout, block, q.device)


def block_sparse_fwd_ref(q, k, v, layout, block, sm_scale=None):
    """Plain version of the forward kernel → (o in q's dtype, lse fp32
    [B, H, S]): a softmax over the admitted keys in fp32; a row with none
    gives o = 0 and lse = ``NEG_INF``. Differentiable."""
    B, S, H, D = q.shape
    layout = full_layout(layout, H, S, block)
    sm_scale = 1.0 / math.sqrt(D) if sm_scale is None else sm_scale
    s, mask = _scores(q, k, layout, block, sm_scale)
    s = s.masked_fill(~mask, NEG_INF)
    live = mask.any(-1)[None, :, :, None]                  # [1, H, S, 1]
    p = torch.where(live, torch.softmax(s, dim=-1), torch.zeros((), device=q.device))
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
    lse = torch.where(live[..., 0], torch.logsumexp(s, dim=-1),
                      torch.full((), NEG_INF, device=q.device))
    return o, lse


def block_sparse_attention_ref(q, k, v, layout, block, sm_scale=None):
    """Plain version of :func:`block_sparse_attention` (autograd through
    :func:`block_sparse_fwd_ref`)."""
    return block_sparse_fwd_ref(q, k, v, layout, block, sm_scale)[0]


def _p_ds(q, k, v, do, lse, delta, layout, block, sm_scale):
    """The backward kernels' shared terms: p = admitted ? exp(s - lse) : 0
    and ds = p (dp - delta) sm_scale, each rounded to q's dtype as the
    kernels round them before their products, then widened to fp32."""
    B, S, H, D = q.shape
    layout = full_layout(layout, H, S, block)
    sm_scale = 1.0 / math.sqrt(D) if sm_scale is None else sm_scale
    s, mask = _scores(q, k, layout, block, sm_scale)
    p = torch.where(mask, torch.exp(s - lse[..., None]), torch.zeros((), device=q.device))
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = p * (dp - delta[..., None]) * sm_scale
    return p.to(q.dtype).float(), ds.to(q.dtype).float()


def block_sparse_dq_ref(q, k, v, do, lse, delta, layout, block, sm_scale=None):
    """Plain version of the dQ kernel → dq in q's dtype."""
    _, ds = _p_ds(q, k, v, do, lse, delta, layout, block, sm_scale)
    return torch.einsum("bhqk,bkhd->bqhd", ds, k.float()).to(q.dtype)


def block_sparse_dkv_ref(q, k, v, do, lse, delta, layout, block, sm_scale=None):
    """Plain version of the dK/dV kernel → (dk, dv) in q's dtype."""
    p, ds = _p_ds(q, k, v, do, lse, delta, layout, block, sm_scale)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    return dk.to(q.dtype), dv.to(q.dtype)


LEAD_FACTOR = 4  # a rank leads where its longest list is this many times the mean


def lead_ranks(nnz):
    """How many ranks of every head-row the wgmma designs take before their
    head groups: the leading ranks whose longest list (over heads) is at
    least LEAD_FACTOR times the mean list, such as BigBird's global row and
    column. Started first, a long list does not end after the rest."""
    longest = -np.sort(-np.asarray(nnz), axis=-1).max(0)  # by rank, over heads
    short = longest < LEAD_FACTOR * float(np.mean(nnz))
    return int(np.argmax(short)) if short.any() else 0


class Schedule:
    """The kernels' index lists for one [H, nq, nk] ``layout`` on one device:
    for the forward and dQ the query rows' lists (``k_idx`` [H, nq, A],
    ``k_nnz``, ``k_order``), for dK/dV the key rows' (``q_*``); ``*_order``
    [H, rows] lists each head's rows longest first, the order the grid
    starts them in. ``k_ranked`` and ``q_ranked`` are the same lists in that
    order (row r of head h is the list of row ``order[h, r]``), which the
    wgmma designs read, so that a block's reads of its row, its count and
    its list do not wait on each other; ``k_lead`` and ``q_lead`` are
    their :func:`lead_ranks`."""

    def __init__(self, layout, device):
        k_idx, k_nnz, q_idx, q_nnz = layout_to_indices(layout)

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

        def order(nnz):  # stable, so equal rows keep their index order
            return np.argsort(-nnz, axis=-1, kind="stable")

        def ranked(idx, nnz):
            o = order(nnz)
            return (dev(np.take_along_axis(idx, o[..., None], 1)),
                    dev(np.take_along_axis(nnz, o, 1)), dev(o), idx.shape[-1])

        self.layout = layout
        self.shape = layout.shape
        self.k = (dev(k_idx), dev(k_nnz), dev(order(k_nnz)), k_idx.shape[-1])
        self.q = (dev(q_idx), dev(q_nnz), dev(order(q_nnz)), q_idx.shape[-1])
        self.k_ranked = ranked(k_idx, k_nnz)
        self.q_ranked = ranked(q_idx, q_nnz)
        self.k_lead = lead_ranks(k_nnz)
        self.q_lead = lead_ranks(q_nnz)


def schedule(layout, device):
    """The :class:`Schedule` of an [H, nq, nk] layout on ``device``, made
    once per (layout content, device)."""
    layout = np.asarray(layout, bool)
    key = (layout.shape, layout.tobytes(), str(device))
    hit = _DEVICE_CACHE.get(key)
    if hit is None:
        if len(_DEVICE_CACHE) > 64:
            _DEVICE_CACHE.clear()
        hit = _DEVICE_CACHE[key] = Schedule(layout, device)
    return hit


def _fn(name, n_ptr, n_int):
    from deepspeed_tpu_torch.ops.kernels.build import load
    fn = getattr(load(_SOURCE), name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(block, sched, **tensors):
    """bf16 [B, S, H, D] q/k/v/do (one shape, D in HEAD_DIMS, S a multiple
    of ``block``), fp32 [B, H, S] lse/delta, every tensor contiguous,
    16-byte aligned and on q's device, ``sched`` for [H, S / block, S /
    block] → (B, S, H, D)."""
    q = tensors["q"]
    if not q.is_cuda:
        raise ValueError("the block-sparse launchers take CUDA tensors; CPU tensors go "
                         "through block_sparse_attention's plain version")
    if q.dim() != 4:
        raise ValueError(f"want q [B, S, H, D], got {tuple(q.shape)}")
    B, S, H, D = q.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D}: the kernels take {HEAD_DIMS}")
    if block not in BLOCKS:
        raise ValueError(f"block {block}: the kernels take {BLOCKS}")
    if sched.shape != (H, S // block, S // block) or S % block:
        raise ValueError(f"layout {sched.shape} vs heads {H}, seq {S}, block {block}")
    for name, x in tensors.items():
        shp, dtype = {"lse": ((B, H, S), torch.float32),
                      "delta": ((B, H, S), torch.float32)}.get(name, (q.shape, torch.bfloat16))
        if tuple(x.shape) != tuple(shp):
            raise ValueError(f"{name} must have shape {tuple(shp)}, got {tuple(x.shape)}")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if x.device != q.device:
            raise ValueError(f"{name} must be on {q.device}, got {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    return B, S, H, D


def _launch(name, ptrs, lists, dims, sm_scale, device, what, scratch=(), ints=()):
    """One C entry: ``ptrs``, the lists' three arrays, ``scratch``, then
    ``dims``, the lists' width and ``ints``."""
    idx, nnz, order, A = lists
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _fn(name, len(ptrs) + 3 + len(scratch), len(dims) + 1 + len(ints))(
            *[t.data_ptr() for t in ptrs], idx.data_ptr(), nnz.data_ptr(), order.data_ptr(),
            *[t.data_ptr() for t in scratch], *dims, A, *ints, sm_scale, stream)
    if rc != 0:
        raise RuntimeError(f"block-sparse {what} kernel failed to launch: cudaError {rc}")


def _scale(D, sm_scale):
    return 1.0 / math.sqrt(D) if sm_scale is None else float(sm_scale)


def _sched(layout, q, block):
    if isinstance(layout, Schedule):
        return layout
    return schedule(full_layout(layout, q.shape[2], q.shape[1], block), q.device)


def _counter(device):
    """The wgmma designs' work counter: one int32 zero, which their
    persistent grid counts its items off."""
    return torch.zeros(1, dtype=torch.int32, device=device)


def _design(block, D, design):
    named = bsa_design(block, D)
    if design is None:
        return named
    if design not in DESIGNS or (design == "wgmma" and named != "wgmma"):
        raise ValueError(f"design {design!r} cannot take block {block}, head dim {D}: the "
                         f"wgmma design takes blocks {WGMMA_BLOCKS}")
    return design


def block_sparse_fwd(q, k, v, layout, block, sm_scale=None, design=None):
    """Launch the forward kernel of the design :func:`bsa_design` names (or
    ``design``) → (o bf16 [B, S, H, D], lse fp32 [B, H, S]). ``layout``:
    [1 or H, nq, nk] bool, or its :class:`Schedule`."""
    sched = _sched(layout, q, block)
    B, S, H, D = _check(block, sched, q=q, k=k, v=v)
    design = _design(block, D, design)
    o = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    if design == "wgmma":
        _launch("ds_bsa_fwd_wgmma_bf16", [q, k, v, o, lse], sched.k_ranked, (B, H, S, D, block),
                _scale(D, sm_scale), q.device, "forward (wgmma design)", (_counter(q.device),),
                (sched.k_lead,))
    else:
        _launch("ds_bsa_fwd_bf16", [q, k, v, o, lse], sched.k, (B, H, S, D, block),
                _scale(D, sm_scale), q.device, "forward (first design)")
    block_sparse_fwd.launches += 1
    bsa_design_launches["block_sparse_fwd"][design] += 1
    return o, lse


def block_sparse_dq(q, k, v, do, lse, delta, layout, block, sm_scale=None, design=None):
    """Launch the dQ kernel of the design :func:`bsa_design` names (or
    ``design``) → dq bf16 [B, S, H, D]."""
    sched = _sched(layout, q, block)
    B, S, H, D = _check(block, sched, q=q, k=k, v=v, do=do, lse=lse, delta=delta)
    design = _design(block, D, design)
    dq = torch.empty_like(q)
    if design == "wgmma":
        _launch("ds_bsa_dq_wgmma_bf16", [q, k, v, do, lse, delta, dq], sched.k_ranked,
                (B, H, S, D, block), _scale(D, sm_scale), q.device, "dQ (wgmma design)",
                (_counter(q.device),), (sched.k_lead,))
    else:
        _launch("ds_bsa_dq_bf16", [q, k, v, do, lse, delta, dq], sched.k, (B, H, S, D, block),
                _scale(D, sm_scale), q.device, "dQ (first design)")
    block_sparse_dq.launches += 1
    bsa_design_launches["block_sparse_dq"][design] += 1
    return dq


def block_sparse_dkv(q, k, v, do, lse, delta, layout, block, sm_scale=None, design=None):
    """Launch the dK/dV kernel of the design :func:`bsa_design` names (or
    ``design``) → (dk, dv) bf16 [B, S, H, D]."""
    sched = _sched(layout, q, block)
    B, S, H, D = _check(block, sched, q=q, k=k, v=v, do=do, lse=lse, delta=delta)
    design = _design(block, D, design)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if design == "wgmma":
        _launch("ds_bsa_dkv_wgmma_bf16", [q, k, v, do, lse, delta, dk, dv], sched.q_ranked,
                (B, H, S, D, block), _scale(D, sm_scale), q.device, "dK/dV (wgmma design)",
                (_counter(q.device),), (sched.q_lead,))
    else:
        _launch("ds_bsa_dkv_bf16", [q, k, v, do, lse, delta, dk, dv], sched.q,
                (B, H, S, D, block), _scale(D, sm_scale), q.device, "dK/dV (first design)")
    block_sparse_dkv.launches += 1
    bsa_design_launches["block_sparse_dkv"][design] += 1
    return dk, dv


block_sparse_fwd.launches = 0
block_sparse_dq.launches = 0
block_sparse_dkv.launches = 0


class _BlockSparseAttention(torch.autograd.Function):
    """The forward kernel, saving lse; the backward runs the dQ and dK/dV
    kernels (the TPU ``_sparse`` custom VJP)."""

    @staticmethod
    def forward(ctx, q, k, v, sched, block):
        o, lse = block_sparse_fwd(q, k, v, sched, block)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.sched, ctx.block = sched, block
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = flash_delta(o, do)
        dq = block_sparse_dq(q, k, v, do, lse, delta, ctx.sched, ctx.block)
        dk, dv = block_sparse_dkv(q, k, v, do, lse, delta, ctx.sched, ctx.block)
        return dq, dk, dv, None, None


def block_sparse_attention(q, k, v, layout, block):
    """Layout-sparse attention on [B, S, H, D] tensors → [B, S, H, D].

    ``layout``: [H or 1, S/block, S/block] boolean host array (a
    ``SparsityConfig.make_layout`` product). Admitted blocks attend
    bidirectionally at block granularity. CUDA tensors run the kernels
    (bf16, contiguous) or raise; CPU tensors take
    :func:`block_sparse_attention_ref`."""
    if q.device.type == "cpu":
        return block_sparse_attention_ref(q, k, v, layout, block)
    return _BlockSparseAttention.apply(q, k, v, _sched(layout, q, block), block)
