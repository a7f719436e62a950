"""Paged decode attention: one query token against a block-tabled KV.

Port of ``deepspeed_tpu/ops/pallas/paged_attention.py``. The kernel is
CUDA C++ for Hopper, ``csrc/paged_attention.cu`` (its header says what
bounds it and what the design does about that), built by
``ops/kernels/build.py`` and called through ctypes.

:func:`paged_decode_attention` is the wrapper the ragged model runner
calls. A CUDA tensor launches the kernel or raises; a CPU tensor takes
the plain version :func:`paged_attention_ref`, which follows
``xla_paged_attention``'s math and is also what the tests and
``chip_smoke.py`` compare the kernel with. The TPU kernel's layout limits
(``head_dim % 128``, ``block_size % 8``, the scalar-memory budget) do not
apply here: the kernel takes any ``head_dim`` that is a multiple of 8 up
to 256 and any block size.
"""

import ctypes
import math

import torch

from deepspeed_tpu_torch.models.llama import repeat_kv

NEG_INF = torch.finfo(torch.float32).min
MAX_HEAD_DIM = 256
_SOURCE = "paged_attention.cu"


def paged_attention_ref(q, kc, vc, block_tables, token_pos):
    """Plain version. q: [T, H, Dh]; kc/vc: [NB, bs, Hkv, Dh];
    block_tables: [T, MB] (per TOKEN, already indexed by its sequence);
    token_pos: [T] → [T, H, Dh] in q's dtype, attending to positions
    <= token_pos. Gathers every token's whole table, so it is for
    checking, not serving.

    ``xla_paged_attention``'s math, computed in fp32 whatever the input
    dtype, as the kernel computes it: scores, probabilities and the
    weighted sum of V stay fp32 and only the output is cast. (The XLA
    version rounds scores and probabilities to q's dtype on the way; in
    fp32 the two agree.)"""
    T, H, Dh = q.shape
    _, bs, Hkv, _ = kc.shape
    tab = block_tables.long()
    ks = kc[tab].reshape(T, -1, Hkv, Dh).float()
    vs = vc[tab].reshape(T, -1, Hkv, Dh).float()
    if Hkv != H:
        ks, vs = repeat_kv(ks, vs, H // Hkv)
    scale = 1.0 / math.sqrt(Dh)
    scores = torch.einsum("thd,tchd->thc", q.float(), ks) * scale
    k_idx = torch.arange(ks.shape[1], device=q.device)
    mask = (k_idx[None, :] <= token_pos.long()[:, None])[:, None, :]
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("thc,tchd->thd", probs, vs).to(q.dtype)


def _lib():
    from deepspeed_tpu_torch.ops.kernels.build import load
    lib = load(_SOURCE)
    fn = lib.ds_paged_decode_attention_bf16
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(q, kc, vc, block_tables, token_pos):
    if q.dim() != 3 or kc.dim() != 4 or kc.shape != vc.shape:
        raise ValueError(f"want q [T, H, Dh] and kc/vc [NB, bs, Hkv, Dh], got "
                         f"{tuple(q.shape)}, {tuple(kc.shape)}, {tuple(vc.shape)}")
    T, H, Dh = q.shape
    _, _, Hkv, Dk = kc.shape
    if Dk != Dh or Hkv < 1 or H % Hkv:
        raise ValueError(f"q heads {H} x {Dh} do not group over KV heads {Hkv} x {Dk}")
    if Dh % 8 or Dh > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {Dh}: the kernel takes multiples of 8 up to "
                         f"{MAX_HEAD_DIM}")
    if block_tables.dim() != 2 or block_tables.shape[0] != T or \
            token_pos.shape != (T,):
        raise ValueError(f"want block_tables [T={T}, MB] and token_pos [T], got "
                         f"{tuple(block_tables.shape)}, {tuple(token_pos.shape)}")
    # q/kc/vc are read as 16-byte vectors; the int32 tables and positions
    # are read one scalar at a time, so they need only their own alignment
    # (``token_pos`` is a view into the packed batch vector at 8 x bucket
    # bytes, which an odd bucket leaves 8 bytes off a 16-byte boundary)
    for name, x, dtype, align in (("q", q, torch.bfloat16, 16), ("kc", kc, torch.bfloat16, 16),
                                  ("vc", vc, torch.bfloat16, 16),
                                  ("block_tables", block_tables, torch.int32, 4),
                                  ("token_pos", token_pos, torch.int32, 4)):
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if not x.is_cuda or x.device != q.device:
            raise ValueError(f"{name} must be on {q.device}, got {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.data_ptr() % align:
            raise ValueError(f"{name} must be {align}-byte aligned")


def paged_decode_attention(q, kc, vc, block_tables, token_pos):
    """Same contract as :func:`paged_attention_ref`. CUDA tensors (bf16
    q/kc/vc, int32 tables/positions, contiguous) launch the kernel;
    CPU tensors take the plain version."""
    if q.device.type == "cpu":
        return paged_attention_ref(q, kc, vc, block_tables, token_pos)
    _check(q, kc, vc, block_tables, token_pos)
    T, H, Dh = q.shape
    _, bs, Hkv, _ = kc.shape
    out = torch.empty_like(q)
    fn = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), kc.data_ptr(), vc.data_ptr(), block_tables.data_ptr(),
                token_pos.data_ptr(), out.data_ptr(), T, H, Hkv, Dh, bs,
                block_tables.shape[1], stream)
    if rc != 0:
        raise RuntimeError(f"paged decode attention kernel failed to launch: "
                           f"cudaError {rc}")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
