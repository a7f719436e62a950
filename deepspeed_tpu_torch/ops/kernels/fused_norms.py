"""Fused RMSNorm and LayerNorm: CUDA forward kernels and closed-form
backwards.

Port of ``deepspeed_tpu/ops/pallas/fused_norms.py``. The forward kernels
are CUDA C++ for Hopper, ``csrc/fused_norms.cu`` (its header says what
bounds them and what the design does about that), built by
``ops/kernels/build.py`` and called through ctypes by :func:`rms_norm_fwd`
(the TPU ``_rms_fwd_kernel``) and :func:`layer_norm_fwd`
(``_ln_fwd_kernel``).

:func:`fused_rms_norm` and :func:`fused_layer_norm` are what the models
call: ``torch.autograd.Function``s whose forward is the kernel on CUDA
tensors (bf16 or fp32, last dim a multiple of 8, contiguous; anything
else raises) and the plain version (:func:`rms_norm_ref`,
:func:`layer_norm_ref`) on CPU tensors, and whose backward is the closed
form (``_rms_bwd``, ``_ln_bwd``) in PyTorch ops on both, as the JAX
package leaves it to XLA. No fp32 activation is saved beyond the inputs.
LayerNorm's variance is the two-pass mean of squared deviations, as
``_ln_fwd_kernel`` computes it (flax's ``nn.LayerNorm`` takes E[x²] −
E[x]² instead; ROADMAP.md queue 3 records the difference).
"""

import ctypes

import torch

_SOURCE = "fused_norms.cu"
_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}


def rms_norm_ref(x, scale, eps=1e-5):
    """Plain version: RMSNorm over the last dim, fp32 statistics, output
    in x's dtype (``_rms_fwd``'s math)."""
    x32 = x.float()
    rstd = torch.rsqrt(x32.square().mean(-1, keepdim=True) + eps)
    return (x32 * rstd * scale.float()).to(x.dtype)


def rms_norm_bwd(x, scale, g, eps=1e-5):
    """``_rms_bwd``'s closed form → (dx in x's dtype, dscale in scale's)."""
    x32, g32, s32 = x.float(), g.float(), scale.float()
    d = x.shape[-1]
    rstd = torch.rsqrt(x32.square().mean(-1, keepdim=True) + eps)
    gs = g32 * s32
    dx = rstd * gs - x32 * (rstd ** 3 / d) * (gs * x32).sum(-1, keepdim=True)
    dscale = (g32 * x32 * rstd).reshape(-1, d).sum(0)
    return dx.to(x.dtype), dscale.to(scale.dtype)


def layer_norm_ref(x, scale, bias, eps=1e-5):
    """Plain version: LayerNorm over the last dim, fp32 two-pass mean and
    variance, output in x's dtype (``_ln_fwd``'s XLA branch)."""
    x32 = x.float()
    xc = x32 - x32.mean(-1, keepdim=True)
    rstd = torch.rsqrt(xc.square().mean(-1, keepdim=True) + eps)
    return (xc * rstd * scale.float() + bias.float()).to(x.dtype)


def layer_norm_bwd(x, scale, g, eps=1e-5):
    """``_ln_bwd``'s closed form → (dx in x's dtype, dscale and dbias in
    scale's)."""
    x32, g32, s32 = x.float(), g.float(), scale.float()
    d = x.shape[-1]
    xc = x32 - x32.mean(-1, keepdim=True)
    rstd = torch.rsqrt(xc.square().mean(-1, keepdim=True) + eps)
    xhat = xc * rstd
    gs = g32 * s32
    dx = rstd * (gs - gs.mean(-1, keepdim=True) - xhat * (gs * xhat).mean(-1, keepdim=True))
    dscale = (g32 * xhat).reshape(-1, d).sum(0)
    dbias = g32.reshape(-1, d).sum(0)
    return dx.to(x.dtype), dscale.to(scale.dtype), dbias.to(scale.dtype)


def _fn(name, n_ptr):
    from deepspeed_tpu_torch.ops.kernels.build import load
    fn = getattr(load(_SOURCE), name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 2 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _launch(name, what, x, params, eps):
    """Check x [..., D] and its [D] parameters (one dtype, bf16 or fp32,
    contiguous, 16-byte aligned, D a multiple of 8), then launch → out."""
    if not x.is_cuda:
        raise ValueError(f"{what}_fwd launches the CUDA kernel and takes CUDA tensors; "
                         f"CPU tensors go through fused_{what}'s plain version")
    D = x.shape[-1]
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x must be bf16 or fp32 for the kernel, got {x.dtype}")
    if D % 8:
        raise ValueError(f"last dim {D}: the kernel reads 16-byte vectors, so it takes "
                         f"multiples of 8")
    for pname, t in params.items():
        if t.dtype != x.dtype:
            raise TypeError(f"{pname} must be {x.dtype} like x, got {t.dtype}")
        if tuple(t.shape) != (D,):
            raise ValueError(f"{pname} must have shape ({D},), got {tuple(t.shape)}")
    for pname, t in (("x", x), *params.items()):
        if t.device != x.device:
            raise ValueError(f"{pname} must be on {x.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{pname} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{pname} must be 16-byte aligned")
    out = torch.empty_like(x)
    ptrs = [x.data_ptr(), *(t.data_ptr() for t in params.values()), out.data_ptr()]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _fn(name, len(ptrs))(*ptrs, x.numel() // D, D, float(eps), _DTYPE_CODE[x.dtype],
                                  stream)
    if rc != 0:
        raise RuntimeError(f"{what} kernel failed to launch: cudaError {rc}")
    return out


def rms_norm_fwd(x, scale, eps=1e-5):
    """Launch the RMSNorm kernel on CUDA tensors: x [..., D] and scale [D],
    one dtype (bf16 or fp32), contiguous, D a multiple of 8."""
    out = _launch("ds_rms_norm_fwd", "rms_norm", x, {"scale": scale}, eps)
    rms_norm_fwd.launches += 1
    return out


def layer_norm_fwd(x, scale, bias, eps=1e-5):
    """Launch the LayerNorm kernel on CUDA tensors: x [..., D], scale and
    bias [D], one dtype (bf16 or fp32), contiguous, D a multiple of 8."""
    out = _launch("ds_layer_norm_fwd", "layer_norm", x, {"scale": scale, "bias": bias}, eps)
    layer_norm_fwd.launches += 1
    return out


rms_norm_fwd.launches = 0
layer_norm_fwd.launches = 0


class _FusedRMSNorm(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        if x.device.type == "cpu":
            return rms_norm_ref(x, scale, eps)
        return rms_norm_fwd(x, scale, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx, dscale = rms_norm_bwd(x, scale, g, ctx.eps)
        return dx, dscale, None


def fused_rms_norm(x, scale, eps=1e-5):
    """RMSNorm over the last dim; fp32 statistics, x's dtype out."""
    return _FusedRMSNorm.apply(x, scale, eps)


class _FusedLayerNorm(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        if x.device.type == "cpu":
            return layer_norm_ref(x, scale, bias, eps)
        return layer_norm_fwd(x, scale, bias, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx, dscale, dbias = layer_norm_bwd(x, scale, g, ctx.eps)
        return dx, dscale, dbias, None


def fused_layer_norm(x, scale, bias, eps=1e-5):
    """LayerNorm over the last dim; fp32 statistics, x's dtype out."""
    return _FusedLayerNorm.apply(x, scale, bias, eps)
