"""Blocked (paged) KV cache.

Port of ``deepspeed_tpu/inference/v2/ragged/kv_cache.py``: a pool of
fixed-size KV blocks shared by all sequences, fronted by
:class:`BlockedAllocator`. The pool is two device tensors
``[num_layers, num_blocks, block_size, n_kv_heads, head_dim]``. Block 0
is reserved as the null block — padding tokens scatter there and no
live sequence ever owns it.

The JAX pool is functional: the engine donates it through the jitted
step and XLA reuses the buffer. Here the model runner writes new K/V
into these tensors in place, so there is one pool and no copy.

Host offload and restore serve suspend/resume and the KV spill tier:
``gather`` copies blocks to host memory (one ``index_select`` per pool on
the device, then device→host copies into pinned memory, :func:`to_host`),
``offload`` gathers and frees, and ``restore`` writes a handle into freshly
reserved blocks in place (``index_copy_``). A quantized handle (int8 carriers and per-group fp32
scales, ``kv_tier/quant.py``) goes to the device as int8 and is
dequantized by the int8 dequantize kernel straight into the reserved
pool blocks (the JAX package's ``_dequant_blocks`` inside its jitted
scatter computes the same function)."""

import torch

from deepspeed_tpu_torch.inference.v2.ragged.blocked_allocator import BlockedAllocator
from deepspeed_tpu_torch.ops.kernels.quantization import dequantize_int8_rows

NULL_BLOCK = 0


_PINNED_MIN_BYTES = 1 << 16


def to_host(handles):
    """A list of handles (``{name: tensor}``) → the same handles on the
    host, complete on return. Each handle's CUDA tensors of at least 64 KiB
    share one pinned buffer of their own (16-byte aligned views): a host
    record keeps its buffer alive and no other's, and the caching host
    allocator's power-of-two rounding costs nothing where the buffer is a
    power of two (k and v of whole Mistral-7B blocks). Those copies are
    queued on the current stream, then smaller tensors (scales, errors) are
    copied to pageable memory, which waits for the queue. A device→host copy
    of a large tensor into fresh pageable memory runs at a small fraction of
    the link's rate (PERF.md, on an H100 80GB HBM3 at 700 W), and pinned
    host tensors go back to the card asynchronously. CPU tensors and other
    values are returned as they are."""
    out, small, stream = [], [], None
    for handle in handles:
        cuda = {name: t for name, t in handle.items() if torch.is_tensor(t) and t.is_cuda}
        host = {name: t for name, t in handle.items() if name not in cuda}
        large = {name: t for name, t in cuda.items() if t.nbytes >= _PINNED_MIN_BYTES}
        small += [(host, name, t) for name, t in cuda.items() if name not in large]
        sizes = [-(-t.nbytes // 16) * 16 for t in large.values()]
        buf = torch.empty(sum(sizes), dtype=torch.uint8, pin_memory=True) if large else None
        offset = 0
        for (name, t), size in zip(large.items(), sizes):
            host[name] = buf[offset:offset + t.nbytes].view(t.dtype).view(t.shape)
            host[name].copy_(t, non_blocking=True)
            stream = torch.cuda.current_stream(t.device)
            offset += size
        out.append(host)
    for host, name, t in small:
        host[name] = t.cpu()
    if stream is not None:
        stream.synchronize()
    return [{name: host[name] for name in handle} for handle, host in zip(handles, out)]


class KVCacheHandleError(ValueError):
    """An offload handle does not match this pool's layout — raised on
    the host BEFORE anything is written to the pool."""


class BlockedKVCache:

    def __init__(self, num_layers, num_blocks, block_size, n_kv_heads, head_dim,
                 dtype=torch.bfloat16, device="cpu"):
        if num_blocks < 2:
            raise ValueError("need at least one real block beyond the null block")
        self.num_layers = num_layers
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.n_kv_heads = n_kv_heads
        self.head_dim = head_dim
        self.dtype = dtype
        self.device = torch.device(device)
        shape = (num_layers, num_blocks, block_size, n_kv_heads, head_dim)
        self.k = torch.zeros(shape, dtype=dtype, device=device)
        self.v = torch.zeros(shape, dtype=dtype, device=device)
        self._allocator = BlockedAllocator(num_blocks)
        self._allocator.allocate(1)  # pin the null block forever

    @property
    def free_blocks(self) -> int:
        return self._allocator.free_blocks

    def reserve(self, num_blocks):
        return self._allocator.allocate(num_blocks)

    def free(self, blocks):
        blocks = list(blocks)  # any iterable, generators included
        if blocks:
            self._allocator.free(blocks)

    def bytes(self) -> int:
        return 2 * self.k.numel() * self.k.element_size()

    # ------------------------------------------------------------------
    # Host offload / restore
    # ------------------------------------------------------------------
    def _check_ids(self, blocks):
        blocks = [int(b) for b in blocks]
        for b in blocks:
            if b < 0 or b >= self.num_blocks:
                raise KVCacheHandleError(f"invalid block id {b} for a "
                                         f"{self.num_blocks}-block pool")
        return blocks

    def gather_device(self, blocks):
        """``blocks``' KV as new tensors on the pool's device, without
        freeing them → ``{"k", "v"}`` in the pool layout ``[L, n, bs, H,
        D]`` (the spill tier quantizes these before the host copy)."""
        blocks = self._check_ids(blocks)
        ids = torch.tensor(blocks, dtype=torch.int64, device=self.device)
        return {"k": self.k.index_select(1, ids), "v": self.v.index_select(1, ids)}

    def gather(self, blocks):
        """Copy ``blocks``' KV to host memory WITHOUT freeing them →
        offload handle (the read half of :meth:`offload`; the KV-tier
        demotion path gathers before the trie's ids are freed)."""
        return to_host([self.gather_device(blocks)])[0]

    def offload(self, blocks, keep=()):
        """Move ``blocks``' KV to host memory and free them for reuse.
        → opaque handle for :meth:`restore`. Blocks listed in ``keep``
        are copied into the handle but NOT freed — the prefix-cache
        suspend path, where a shared prefix block stays owned by the
        radix trie while the suspended sequence carries its own copy.
        ``keep`` must be a subset of ``blocks``: an id outside the
        offload set would silently stay allocated with nobody holding
        it (a permanent pool leak), so it raises instead."""
        blocks = [int(b) for b in blocks]
        keep = {int(b) for b in keep}
        extra = keep - set(blocks)
        if extra:
            raise KVCacheHandleError(
                f"keep ids {sorted(extra)} are not in the offloaded block "
                f"set — each kept block must be part of this offload")
        handle = self.gather(blocks)
        self.free(b for b in blocks if b not in keep)
        return handle

    def _validate_handle(self, handle):
        """Shape/dtype-check an offload handle against the pool layout
        (raises :class:`KVCacheHandleError`). Accepts both plain
        (pool-dtype) handles and quantized ones (``"quantized": True`` —
        int8 k/v carriers plus per-group fp32 ``k_scales`` / ``v_scales``
        of shape ``[num_layers, n, groups_per_block]``)."""
        if not isinstance(handle, dict) or "k" not in handle or "v" not in handle:
            raise KVCacheHandleError("offload handle must be a dict with "
                                     "'k' and 'v' arrays")
        quantized = bool(handle.get("quantized"))
        k, v = handle["k"], handle["v"]
        want = (self.num_layers, None, self.block_size, self.n_kv_heads,
                self.head_dim)
        want_dtype = torch.int8 if quantized else self.dtype
        for name, arr in (("k", k), ("v", v)):
            shape = tuple(arr.shape) if isinstance(arr, torch.Tensor) else None
            if shape is None or len(shape) != 5 or any(
                    w is not None and s != w for s, w in zip(shape, want)):
                raise KVCacheHandleError(
                    f"handle['{name}'] shape {shape} does not match pool "
                    f"layout [num_layers={self.num_layers}, n, "
                    f"block_size={self.block_size}, n_kv_heads="
                    f"{self.n_kv_heads}, head_dim={self.head_dim}]")
            if arr.dtype != want_dtype:
                raise KVCacheHandleError(
                    f"handle['{name}'] dtype {arr.dtype} does not match "
                    f"{'quantized carrier' if quantized else 'pool'} dtype "
                    f"{want_dtype}")
        if k.shape != v.shape:
            raise KVCacheHandleError(
                f"handle k/v shapes disagree: {tuple(k.shape)} vs {tuple(v.shape)}")
        if quantized:
            slab = self.block_size * self.n_kv_heads * self.head_dim
            n = k.shape[1]
            for name in ("k_scales", "v_scales"):
                scales = handle.get(name)
                shape = tuple(scales.shape) if isinstance(scales, torch.Tensor) else None
                if shape is None or len(shape) != 3 or \
                        shape[0] != self.num_layers or shape[1] != n or \
                        shape[2] < 1 or (n and slab % shape[2] != 0):
                    raise KVCacheHandleError(
                        f"quantized handle['{name}'] shape {shape} does not "
                        f"match [num_layers={self.num_layers}, n={n}, "
                        f"groups_per_block dividing {slab}]")
                if scales.dtype != torch.float32:
                    raise KVCacheHandleError(
                        f"quantized handle['{name}'] dtype {scales.dtype} "
                        f"must be float32")

    def restore(self, handle):
        """Bring offloaded KV back into freshly reserved blocks (ids may
        differ from the original ones — callers re-point their block
        tables), written into the pool in place. A quantized handle's
        int8 carriers and scales go to the device and are dequantized
        straight into the reserved blocks. An empty handle (``n == 0``)
        is a no-op returning ``[]``."""
        self._validate_handle(handle)
        n = handle["k"].shape[1]
        if n == 0:
            return []
        blocks = self.reserve(n)
        ids = torch.tensor(blocks, dtype=torch.int64, device=self.device)
        if handle.get("quantized"):
            L, NB = self.num_layers, self.num_blocks
            per_block = handle["k_scales"].shape[2]
            gs = self.block_size * self.n_kv_heads * self.head_dim // per_block
            # group (l, b, j) of the handle -> row (l, ids[b], j) of the pool as [L*NB*pb, gs]
            rows = ((torch.arange(L, device=self.device)[:, None, None] * NB
                     + ids[None, :, None]) * per_block
                    + torch.arange(per_block, device=self.device)[None, None, :])
            for name, pool in (("k", self.k), ("v", self.v)):
                vals = handle[name].to(self.device, non_blocking=True).reshape(-1, gs)
                scales = handle[f"{name}_scales"].to(self.device, non_blocking=True).reshape(-1)
                dequantize_int8_rows(vals, scales, pool.view(-1, gs), rows.reshape(-1))
        else:
            for name, pool in (("k", self.k), ("v", self.v)):
                pool.index_copy_(1, ids, handle[name].to(self.device, non_blocking=True))
        return blocks
