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
Host offload/restore (``gather``, ``offload``, ``restore``) belongs to
the suspend and KV-tier features and is not ported yet (ROADMAP.md)."""

import torch

from deepspeed_tpu_torch.inference.v2.ragged.blocked_allocator import BlockedAllocator

NULL_BLOCK = 0


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
