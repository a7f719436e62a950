"""Paged attention: query tokens against a block-tabled KV.

Port of ``deepspeed_tpu/ops/pallas/paged_attention.py``. The kernels are
CUDA C++ for Hopper, ``csrc/paged_attention.cu`` (its header says what
bounds them and what each design does about that), built by
``ops/kernels/build.py`` and called through ctypes.

:func:`paged_decode_attention` is the wrapper the ragged model runner
calls. A CUDA tensor launches one of two designs or raises; a CPU tensor
takes the plain version :func:`paged_attention_ref`, which follows
``xla_paged_attention``'s math and is also what the tests and
``chip_smoke.py`` compare the kernels with. :func:`paged_design` names
the design from the shape alone: "tiled" (query tiles of consecutive
tokens on tensor cores, long contexts split over blocks by fixed chunks
of :data:`CHUNK` positions) takes head dims that are multiples of 32 up
to 256, 1-8 query heads a KV head and block sizes that are multiples of
8; "token" (one block a token, fp32 on CUDA cores) takes the rest: any
head dim that is a multiple of 8 up to 256 and any block size.
``paged_design_launches`` counts the launches by design.
:func:`paged_tiles_ref` is the plain version of how the tiled kernel
cuts the tokens into tiles. The TPU kernel's layout limits
(``head_dim % 128``, the scalar-memory budget) do not apply here.
"""

import ctypes
import math

import numpy as np
import torch

from deepspeed_tpu_torch.models.llama import repeat_kv

NEG_INF = torch.finfo(torch.float32).min
MAX_HEAD_DIM = 256
_SOURCE = "paged_attention.cu"
DESIGNS = ("tiled", "token")
TILE_ROWS = 64   # the tiled design's product rows a block: tokens x query heads a KV head
CHUNK = 512      # positions a tiled block walks: long contexts split at multiples of it
MAX_GROUP = 8    # query heads a KV head the tiled design takes

paged_design_launches = dict.fromkeys(DESIGNS, 0)


def paged_design(H, Hkv, Dh, bs):
    """The design a call takes, from its shape alone: "tiled" where the
    head dim is a multiple of 32 up to 256, there are 1-8 query heads a
    KV head and the block size is a multiple of 8, else "token"."""
    ok = (Dh % 32 == 0 and 32 <= Dh <= MAX_HEAD_DIM and Hkv >= 1 and H % Hkv == 0
          and 1 <= H // Hkv <= MAX_GROUP and bs % 8 == 0 and bs > 0)
    return "tiled" if ok else "token"


def kv_tile(Dh):
    """KT: the KV rows a tiled block stages at a time (``Cfg<D>::KT`` in
    the kernel); each of the 4 warps that share a 16-row tile scores a
    quarter of them."""
    return 64 if Dh <= 128 else 32


def tile_tokens(G):
    """TQ: the most tokens a tiled block takes at ``G`` query heads a KV
    head; tiles are cut where a position is a multiple of it."""
    return TILE_ROWS // G


def paged_tiles_ref(block_tables, token_pos, G, bs):
    """Plain version of the tiled kernel's cut of the tokens → [(first
    token, tokens)]: token t continues token t - 1's tile when its position
    is the next one, is not a multiple of TQ (:func:`tile_tokens`), and the
    blocks token t - 1 reads are the same in both tables; a decode token or
    a pad row is a tile of one. The kernel reads the tile's last token's
    table for all of them (each reads a prefix of it)."""
    tab = np.asarray(block_tables.cpu() if torch.is_tensor(block_tables) else block_tables)
    pos = np.asarray(token_pos.cpu() if torch.is_tensor(token_pos) else token_pos)
    T, MB = tab.shape
    TQ = tile_tokens(G)
    tiles = []
    for t in range(T):
        p = int(pos[t])
        nb = min((p - 1) // bs + 1, MB)
        if t and p % TQ and int(pos[t - 1]) == p - 1 and (tab[t - 1, :nb] == tab[t, :nb]).all():
            tiles[-1][1] += 1
        else:
            tiles.append([t, 1])
    return [tuple(x) for x in tiles]


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


_ENTRIES = {}  # design → the C entry, loaded (and built) on first use


def _entry(design):
    fn = _ENTRIES.get(design)
    if fn is None:
        from deepspeed_tpu_torch.ops.kernels.build import load
        lib = load(_SOURCE)
        if design == "tiled":
            fn = lib.ds_paged_attention_tiled_bf16
            fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        else:
            fn = lib.ds_paged_decode_attention_bf16
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _ENTRIES[design] = fn
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


def paged_decode_attention(q, kc, vc, block_tables, token_pos, design=None):
    """Same contract as :func:`paged_attention_ref`. CUDA tensors (bf16
    q/kc/vc, int32 tables/positions, contiguous) launch the design
    :func:`paged_design` names, or ``design`` where it can take the shape
    (a measurement's or a test's choice), or raise; CPU tensors take the
    plain version."""
    if q.device.type == "cpu":
        return paged_attention_ref(q, kc, vc, block_tables, token_pos)
    _check(q, kc, vc, block_tables, token_pos)
    T, H, Dh = q.shape
    _, bs, Hkv, _ = kc.shape
    MB = block_tables.shape[1]
    named = paged_design(H, Hkv, Dh, bs)
    if design is None:
        design = named
    elif design not in DESIGNS or (design == "tiled" and named != "tiled"):
        raise ValueError(f"design {design!r} cannot take H={H}, Hkv={Hkv}, Dh={Dh}, bs={bs}: "
                         f"the tiled design takes Dh % 32, 1-{MAX_GROUP} query heads a KV "
                         f"head and bs % 8")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        args = (q.data_ptr(), kc.data_ptr(), vc.data_ptr(), block_tables.data_ptr(),
                token_pos.data_ptr(), out.data_ptr())
        if design == "tiled":
            chunks = -(-MB * bs // CHUNK)
            if chunks > 1:  # fp32 partials (m, l, acc) a row and chunk; arrivals a tile
                from deepspeed_tpu_torch.ops.kernels.fused_quant_matmul import (
                    WORKSPACE_LOCK, _workspace)
                with WORKSPACE_LOCK:
                    ws, counts = _workspace(q.device, stream, T * H * chunks * (Dh + 2),
                                            T * Hkv)
                    rc = _entry("tiled")(*args, ws.data_ptr(), counts.data_ptr(), T, H, Hkv,
                                         Dh, bs, MB, stream)
            else:
                rc = _entry("tiled")(*args, None, None, T, H, Hkv, Dh, bs, MB, stream)
        else:
            rc = _entry("token")(*args, T, H, Hkv, Dh, bs, MB, stream)
    if rc != 0:
        raise RuntimeError(f"paged attention kernel ({design} design) failed to launch: "
                           f"cudaError {rc}")
    paged_decode_attention.launches += 1
    paged_design_launches[design] += 1
    return out


paged_decode_attention.launches = 0
