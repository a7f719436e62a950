"""Fused RMSNorm: a CUDA forward kernel and a closed-form backward.

Port of the RMS half of ``deepspeed_tpu/ops/pallas/fused_norms.py``. The
forward kernel is CUDA C++ for Hopper, ``csrc/fused_norms.cu`` (its header
says what bounds it and what the design does about that), built by
``ops/kernels/build.py`` and called through ctypes by :func:`rms_norm_fwd`.

:func:`fused_rms_norm` is what the model calls: a
``torch.autograd.Function`` whose forward is the kernel on CUDA tensors
(bf16 or fp32, last dim a multiple of 8, contiguous; anything else
raises) and the plain version :func:`rms_norm_ref` on CPU tensors, and
whose backward is ``_rms_bwd``'s closed form in PyTorch ops on both, as
the JAX package leaves it to XLA. No fp32 activation is saved beyond the
inputs.
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


def _lib():
    from deepspeed_tpu_torch.ops.kernels.build import load
    fn = load(_SOURCE).ds_rms_norm_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def rms_norm_fwd(x, scale, eps=1e-5):
    """Launch the forward kernel on CUDA tensors: x [..., D] and scale [D],
    one dtype (bf16 or fp32), contiguous, D a multiple of 8."""
    if not x.is_cuda:
        raise ValueError("rms_norm_fwd launches the CUDA kernel and takes CUDA tensors; "
                         "CPU tensors go through fused_rms_norm's plain version")
    D = x.shape[-1]
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x must be bf16 or fp32 for the kernel, got {x.dtype}")
    if scale.dtype != x.dtype:
        raise TypeError(f"scale must be {x.dtype} like x, got {scale.dtype}")
    if tuple(scale.shape) != (D,):
        raise ValueError(f"scale must have shape ({D},), got {tuple(scale.shape)}")
    if D % 8:
        raise ValueError(f"last dim {D}: the kernel reads 16-byte vectors, so it takes "
                         f"multiples of 8")
    for name, t in (("x", x), ("scale", scale)):
        if t.device != x.device:
            raise ValueError(f"{name} must be on {x.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    out = torch.empty_like(x)
    rows = x.numel() // D
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib()(x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, D, float(eps),
                    _DTYPE_CODE[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"rms norm kernel failed to launch: cudaError {rc}")
    rms_norm_fwd.launches += 1
    return out


rms_norm_fwd.launches = 0


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
