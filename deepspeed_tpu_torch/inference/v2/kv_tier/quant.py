"""Quantized KV offload handles: int8, per-(layer, block)-grouped.

Port of ``deepspeed_tpu/inference/v2/kv_tier/quant.py``. Tier-2 blocks
are stored in the pool dtype by default (bit-identical restore); with
``kv_tier.quantize`` the spill tier stores int8 carriers instead, roughly
half the host bytes of bf16 per block. Quantization is the group-wise
int8 of ``ops/kernels/quantization.py`` (kernel K7): symmetric, one fp32
scale per group, where a group defaults to one whole (layer, block) slab
— ``block_size * n_kv_heads * head_dim`` values — so scales index exactly
``[num_layers, n_blocks]`` and a batched handle can be sliced and
concatenated along the block axis without re-grouping.

A handle holds tensors. :func:`quantize_handle` runs where the handle
lives: on a device handle (the tier's gathered blocks) K7 quantizes and
measures on the device, so only the int8 carriers, the scales and the
per-block error cross to the host, half the bytes of a bf16 handle. The
JAX package copies the bf16 blocks to the host first. Quantization error
is measured at demotion time (max |dequant - orig| per block, in fp32,
over layers and both k and v) and reported through the tier's stats:
lossy storage is never silent.
"""

import torch

from deepspeed_tpu_torch.ops.kernels.quantization import dequantize_int8, quantize_int8

_ARRAYS = ("k", "v", "k_scales", "v_scales")


def _quant_one(arr, group_size):
    """int8-quantize one pool-layout tensor ``[L, n, bs, H, D]`` →
    (values int8 same shape, scales fp32 [L, n, groups_per_block],
    max-abs-error per block [n]), all on ``arr``'s device."""
    L, n, bs, H, D = arr.shape
    slab = bs * H * D
    gs = int(group_size) or slab
    if slab % gs != 0:
        raise ValueError(f"quant group size {gs} does not divide the "
                         f"{slab}-value (layer, block) slab")
    per_block = slab // gs
    if n == 0:
        return (torch.zeros(arr.shape, dtype=torch.int8, device=arr.device),
                torch.zeros((L, 0, per_block), dtype=torch.float32, device=arr.device),
                torch.zeros((0,), dtype=torch.float32, device=arr.device))
    values, scales, shape = quantize_int8(arr, group_size=gs)
    # flattening order is [L, n, bs, H, D], so group g maps to
    # (layer, block, within-block group) = divmod chains — reshape only
    back = dequantize_int8(values, scales, shape, dtype=torch.float32)
    err = (back.reshape(L, n, slab) - arr.reshape(L, n, slab).float()).abs()
    return (values.reshape(L, n, bs, H, D), scales.reshape(L, n, per_block),
            err.amax(dim=(0, 2)))


def quantize_handle(handle, group_size=0):
    """→ a quantized offload handle: ``{"k", "v"}`` become
    int8 tensors in the pool layout, ``{"k_scales", "v_scales"}`` carry
    the per-group fp32 scales, ``"quantized": True`` marks the format for
    ``BlockedKVCache._validate_handle``/``restore``, and
    ``"quant_error"`` holds the measured max-abs error per block
    ``[n_blocks]`` (max over k/v). Computed, and returned, where
    ``handle`` lives."""
    kq, ks, kerr = _quant_one(handle["k"], group_size)
    vq, vs, verr = _quant_one(handle["v"], group_size)
    return {"k": kq, "v": vq, "k_scales": ks, "v_scales": vs,
            "quant_error": torch.maximum(kerr, verr), "quantized": True}


def dequantize_handle(handle, dtype):
    """Inverse of :func:`quantize_handle` (the restore path dequantizes
    into the pool instead)."""
    out = {}
    for name in ("k", "v"):
        vals = handle[name].to(torch.float32)
        scales = handle[f"{name}_scales"].to(torch.float32)
        L, n, bs, H, D = vals.shape
        per_block = scales.shape[-1]
        gs = (bs * H * D) // per_block
        deq = vals.reshape(L, n, per_block, gs) * scales[..., None]
        out[name] = deq.reshape(L, n, bs, H, D).to(dtype)
    return out


def handle_nbytes(handle) -> int:
    """Host bytes one offload handle occupies (arrays only)."""
    return int(sum(handle[k].nbytes for k in handle if k in _ARRAYS))


def slice_handle(handle, i, j):
    """Blocks ``[i, j)`` of a batched handle, preserving the format (views)."""
    out = {name: handle[name][:, i:j] for name in _ARRAYS if name in handle}
    if handle.get("quantized"):
        out["quantized"] = True
        if "quant_error" in handle:
            out["quant_error"] = handle["quant_error"][i:j]
    return out


def split_blocks(handle):
    """A batched handle → one handle per block, each array a contiguous
    ``[L, 1, ...]`` tensor of its own where ``handle`` lies (the tier's host
    records: one pinned buffer each, see ``kv_cache.to_host``). The per-block
    ``quant_error`` is left out: the store keeps it as a number."""
    names = [name for name in _ARRAYS if name in handle]
    major = {name: handle[name].transpose(0, 1).contiguous() for name in names}
    out = []
    for i in range(handle["k"].shape[1]):
        one = {name: major[name][i].unsqueeze(1) for name in names}
        if handle.get("quantized"):
            one["quantized"] = True
        out.append(one)
    return out


def concat_handles(handles, device=None):
    """Concatenate per-block handles (same format) along the block axis,
    on ``device`` when given (staged prefetch copies already on the card
    ride next to host-resident records), else where the first lies. Each
    part moves on its own (from pinned memory, asynchronously) and the
    parts are joined there."""
    if not handles:
        raise ValueError("concat_handles needs at least one handle")
    quant = bool(handles[0].get("quantized"))
    names = ("k", "v") + (("k_scales", "v_scales") if quant else ())
    device = handles[0]["k"].device if device is None else torch.device(device)
    out = {}
    for name in names:
        out[name] = torch.cat([h[name].to(device, non_blocking=True) for h in handles], dim=1)
    if quant:
        out["quantized"] = True
    return out
