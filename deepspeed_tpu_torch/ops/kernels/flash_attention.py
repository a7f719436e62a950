"""Flash attention, forward and backward, on [B, S, H, D] tensors.

Port of ``deepspeed_tpu/ops/pallas/flash_attention.py``. The kernels are
CUDA C++ for Hopper, ``csrc/flash_attention.cu`` (its header says what
bounds them and what the design does about that), built by
``ops/kernels/build.py`` and called through ctypes:

- :func:`flash_fwd` launches the forward (the TPU ``_fwd_kernel``) and
  returns the output and the fp32 logsumexp [B, H, S];
- :func:`flash_bwd_dkv` and :func:`flash_bwd_dq` launch the two backward
  kernels (``_dkv_kernel``, ``_dq_kernel``), which recompute the
  probabilities from the saved logsumexp.

:func:`flash_attention` is what the model calls: a
``torch.autograd.Function`` over those three on CUDA tensors (bf16, head
dim 64 or 128, q/k/v with the same head count: the model expands GQA
heads with ``repeat_kv`` first, as the JAX model does). A CUDA tensor
launches the kernels or raises; a CPU tensor takes the plain version
:func:`flash_attention_ref` (``_reference``'s math in fp32), whose
autograd gives the reference gradients. ``bias=`` computes through the
plain version on every device, as the JAX package sends it to
``_reference`` even on the TPU: an additive [S, S] operand leaves nothing
for blocking to save. The TPU kernel's 1024-row blocks, 128-lane
replication of lse/delta/segment ids and [BH, S, D] transposes do not
carry over.

:func:`flash_fwd_ref`, :func:`flash_bwd_dkv_ref` and
:func:`flash_bwd_dq_ref` are the plain versions of each kernel, in fp32
with the kernels' bf16 roundings of p and ds, and :func:`row_scaled_err`
the measure they are compared by, for ``chip_smoke.py`` and the GPU
tests.
"""

import ctypes
import math

import torch

NEG_INF = -1e30  # the TPU kernel's finite mask value
HEAD_DIMS = (64, 128)
_SOURCE = "flash_attention.cu"


def _valid_mask(S_q, S_k, causal, segment_ids, device):
    """[B or 1, 1, Sq, Sk] bool: causal by global index (bottom-right
    aligned as ``_reference``), and equal segment ids."""
    valid = torch.ones(S_q, S_k, dtype=torch.bool, device=device)
    if causal:
        valid = valid.tril(diagonal=S_k - S_q)
    valid = valid[None, None]
    if segment_ids is not None:
        seg = segment_ids.to(device)
        valid = valid & (seg[:, None, :, None] == seg[:, None, None, :])
    return valid


def flash_attention_ref(q, k, v, causal=True, sm_scale=None, segment_ids=None, bias=None):
    """Plain version of :func:`flash_attention`: ``_reference``'s math on
    [B, S, H, D] (q, k, v with equal head counts), scores, softmax and the
    weighted sum of v in fp32, output cast to q's dtype. ``segment_ids``
    [B, S]; ``bias`` additive, broadcastable to [B, H, Sq, Sk]."""
    return flash_fwd_ref(q, k, v, segment_ids, causal, sm_scale, bias)[0]


def _scores(q, k, causal, sm_scale, segment_ids, bias=None):
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    if bias is not None:
        s = s + bias.float()
    valid = _valid_mask(s.shape[-2], s.shape[-1], causal, segment_ids, q.device)
    return s, valid


def flash_fwd_ref(q, k, v, segment_ids=None, causal=True, sm_scale=None, bias=None):
    """Plain version of the forward kernel → (o in q's dtype, lse fp32
    [B, H, S])."""
    sm_scale = 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None else sm_scale
    s, valid = _scores(q, k, causal, sm_scale, segment_ids, bias)
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
    return o, torch.logsumexp(s, dim=-1)


def row_scaled_err(got, ref):
    """How far a kernel's output is from its plain version, element by
    element, in units of 2^-8 (a bf16 half-ulp, relative) of the scale the
    element lives at: ``max |got - ref| / (2^-8 (|ref| + rms(ref's row) +
    rms(ref) / 16))``, rows over the last dim. Rounding an output to bf16
    costs at most 1 unit against an fp32 reference and 2 against a bf16
    one; a bf16 rounding of the terms a row sums (the forward's p in P·V)
    adds about 0.3 units per sigma. The ``rms(ref) / 16`` floor covers rows
    whose reference cancels to ~0 (a query that sees one key has
    dp - delta = 0). A zeroed tile, or a gradient off by a factor of 1.5,
    reads as 100 units or more."""
    ref = ref.float()
    row = ref.square().mean(-1, keepdim=True).sqrt()
    scale = ref.abs() + row + ref.square().mean().sqrt() / 16
    return ((got.float() - ref).abs() / (2.0 ** -8 * scale)).max().item()


def _p_ds(q, k, v, do, lse, delta, segment_ids, causal, sm_scale):
    """The backward kernels' shared terms: p = valid ? exp(s - lse) : 0 and
    ds = p (dp - delta) sm_scale, each rounded to q's dtype as the kernels
    round them before their products, then widened to fp32."""
    s, valid = _scores(q, k, causal, sm_scale, segment_ids)
    p = torch.where(valid, torch.exp(s - lse[..., None]), torch.zeros_like(s))
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = p * (dp - delta[..., None]) * sm_scale
    return p.to(q.dtype).float(), ds.to(q.dtype).float()


def flash_bwd_dkv_ref(q, k, v, do, lse, delta, segment_ids=None, causal=True, sm_scale=None):
    """Plain version of the dK/dV kernel → (dk, dv) in q's dtype."""
    sm_scale = 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None else sm_scale
    p, ds = _p_ds(q, k, v, do, lse, delta, segment_ids, causal, sm_scale)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    return dk.to(q.dtype), dv.to(q.dtype)


def flash_bwd_dq_ref(q, k, v, do, lse, delta, segment_ids=None, causal=True, sm_scale=None):
    """Plain version of the dQ kernel → dq in q's dtype."""
    sm_scale = 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None else sm_scale
    _, ds = _p_ds(q, k, v, do, lse, delta, segment_ids, causal, sm_scale)
    return torch.einsum("bhqk,bkhd->bqhd", ds, k.float()).to(q.dtype)


def flash_delta(o, do):
    """delta = sum(do * o) over the head dim, fp32 [B, H, S] (the TPU
    ``_bwd_impl``'s delta, without its lane replication)."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def _fn(name, n_ptr, n_int):
    from deepspeed_tpu_torch.ops.kernels.build import load
    fn = getattr(load(_SOURCE), name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(device, **tensors):
    """bf16 [B, S, H, D] q/k/v/o/do (all one shape, D in HEAD_DIMS), fp32
    [B, H, S] lse/delta, int32 [B, S] segment ids, every tensor contiguous,
    16-byte aligned and on ``device``."""
    shape = tensors["q"].shape
    if len(shape) != 4:
        raise ValueError(f"want q [B, S, H, D], got {tuple(shape)}")
    B, S, H, D = shape
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D}: the kernels take {HEAD_DIMS}")
    want = {"lse": ((B, H, S), torch.float32), "delta": ((B, H, S), torch.float32),
            "segment_ids": ((B, S), torch.int32)}
    for name, x in tensors.items():
        if x is None:
            continue
        shp, dtype = want.get(name, (shape, torch.bfloat16))
        if tuple(x.shape) != tuple(shp):
            raise ValueError(f"{name} must have shape {tuple(shp)} (q is {tuple(shape)}: equal "
                             f"head counts, expand GQA heads first), got {tuple(x.shape)}")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if x.device != device:
            raise ValueError(f"{name} must be on {device}, got {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    return B, S, H, D


def _launch(fn, args, what):
    with torch.cuda.device(args[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*[a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args], stream)
    if rc != 0:
        raise RuntimeError(f"flash attention {what} kernel failed to launch: cudaError {rc}")


def _cuda_only(q, what):
    if not q.is_cuda:
        raise ValueError(f"flash_{what} launches the CUDA kernel and takes CUDA tensors; "
                         f"CPU tensors go through flash_attention's plain version")


def flash_fwd(q, k, v, segment_ids=None, causal=True, sm_scale=None):
    """Launch the forward kernel → (o bf16 [B, S, H, D], lse fp32 [B, H, S])."""
    _cuda_only(q, "fwd")
    B, S, H, D = _check(q.device, q=q, k=k, v=v, segment_ids=segment_ids)
    sm_scale = 1.0 / math.sqrt(D) if sm_scale is None else float(sm_scale)
    o = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    seg = segment_ids.data_ptr() if segment_ids is not None else None
    _launch(_fn("ds_flash_fwd_bf16", 6, 4),
            [q, k, v, seg, o, lse, B, H, S, D, sm_scale, int(causal)], "forward")
    flash_fwd.launches += 1
    return o, lse


def flash_bwd_dkv(q, k, v, do, lse, delta, segment_ids=None, causal=True, sm_scale=None):
    """Launch the dK/dV kernel → (dk, dv) bf16 [B, S, H, D]."""
    _cuda_only(q, "bwd_dkv")
    B, S, H, D = _check(q.device, q=q, k=k, v=v, do=do, lse=lse, delta=delta,
                        segment_ids=segment_ids)
    sm_scale = 1.0 / math.sqrt(D) if sm_scale is None else float(sm_scale)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    seg = segment_ids.data_ptr() if segment_ids is not None else None
    _launch(_fn("ds_flash_bwd_dkv_bf16", 9, 4),
            [q, k, v, do, lse, delta, seg, dk, dv, B, H, S, D, sm_scale, int(causal)], "dK/dV")
    flash_bwd_dkv.launches += 1
    return dk, dv


def flash_bwd_dq(q, k, v, do, lse, delta, segment_ids=None, causal=True, sm_scale=None):
    """Launch the dQ kernel → dq bf16 [B, S, H, D]."""
    _cuda_only(q, "bwd_dq")
    B, S, H, D = _check(q.device, q=q, k=k, v=v, do=do, lse=lse, delta=delta,
                        segment_ids=segment_ids)
    sm_scale = 1.0 / math.sqrt(D) if sm_scale is None else float(sm_scale)
    dq = torch.empty_like(q)
    seg = segment_ids.data_ptr() if segment_ids is not None else None
    _launch(_fn("ds_flash_bwd_dq_bf16", 8, 4),
            [q, k, v, do, lse, delta, seg, dq, B, H, S, D, sm_scale, int(causal)], "dQ")
    flash_bwd_dq.launches += 1
    return dq


flash_fwd.launches = 0
flash_bwd_dkv.launches = 0
flash_bwd_dq.launches = 0


class _FlashAttention(torch.autograd.Function):
    """The forward kernel, saving lse; the backward runs the dK/dV and dQ
    kernels (the TPU ``_flash`` custom VJP)."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, causal, sm_scale):
        o, lse = flash_fwd(q, k, v, segment_ids, causal, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse, segment_ids)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, seg = ctx.saved_tensors
        do = do.contiguous()
        delta = flash_delta(o, do)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, seg, ctx.causal, ctx.sm_scale)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, seg, ctx.causal, ctx.sm_scale)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal=True, sm_scale=None, segment_ids=None, bias=None):
    """Blocked flash attention on [B, S, H, D] tensors (equal head counts).

    CUDA tensors run the kernels (bf16, head_dim 64 or 128, contiguous) or
    raise; CPU tensors take :func:`flash_attention_ref`. ``segment_ids``
    [B, S] int: packed sequences attend only within equal ids (composes with
    ``causal``). ``bias`` (additive, [B, 1 or H, Sq, Sk]) always takes the
    plain version."""
    if bias is not None or q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal, sm_scale, segment_ids, bias)
    if segment_ids is not None:
        segment_ids = segment_ids.to(device=q.device, dtype=torch.int32).contiguous()
    sm_scale = 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None else float(sm_scale)
    return _FlashAttention.apply(q, k, v, segment_ids, bool(causal), sm_scale)
