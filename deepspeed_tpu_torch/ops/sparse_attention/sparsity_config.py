"""Sparsity layout configs.

A copy of ``deepspeed_tpu/ops/sparse_attention/sparsity_config.py`` (numpy
only; the port keeps its own copy and imports nothing of the JAX package).
Each config builds a block-level boolean LAYOUT ``[heads, S/block,
S/block]`` saying which key blocks each query block attends, bit for bit
the JAX package's: the same loops, the same ``RandomState(seed)`` draws in
the same order. ``BigBirdSparsityConfig`` keeps that generator, so each
``make_layout`` call on one instance draws new random blocks; a model that
wants the reference's layout asks a fresh instance once (``models/bert.py``).
The layouts feed :mod:`deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention`."""

import numpy as np


class SparsityConfig:

    def __init__(self, num_heads, block=16, different_layout_per_head=False):
        self.num_heads = num_heads
        self.block = block
        self.different_layout_per_head = different_layout_per_head

    def setup_layout(self, seq_len):
        if seq_len % self.block != 0:
            raise ValueError(f"seq_len {seq_len} must be a multiple of block {self.block}")
        num_blocks = seq_len // self.block
        return np.zeros((self.num_heads, num_blocks, num_blocks), dtype=bool)

    def check_and_propagate_first_head_layout(self, layout):
        if not self.different_layout_per_head:
            layout[1:] = layout[0]
        return layout

    def make_layout(self, seq_len):
        raise NotImplementedError


class DenseSparsityConfig(SparsityConfig):
    """Everything attends everything (reference :63) — the debug config."""

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        layout[:] = True
        return layout


class FixedSparsityConfig(SparsityConfig):
    """Local windows + fixed global blocks (reference :95): each query
    block sees its own local window of ``num_local_blocks`` and the last
    ``num_global_blocks`` of every preceding window (when attention is
    unidirectional, summaries of the past)."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_local_blocks=4, num_global_blocks=1, attention="bidirectional",
                 horizontal_global_attention=False, num_different_global_patterns=1):
        super().__init__(num_heads, block, different_layout_per_head)
        if attention not in ("unidirectional", "bidirectional"):
            raise NotImplementedError(f"attention {attention}")
        self.num_local_blocks = num_local_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        n = layout.shape[1]
        for q in range(n):
            win = q // self.num_local_blocks
            lo = win * self.num_local_blocks
            hi = min(lo + self.num_local_blocks, n)
            layout[0, q, lo:hi] = True  # local window
            # global: the trailing blocks of every window
            for w_end in range(self.num_local_blocks - 1, n, self.num_local_blocks):
                g_lo = max(w_end - self.num_global_blocks + 1, 0)
                if self.horizontal_global_attention:
                    layout[0, g_lo:w_end + 1, :] = True
                layout[0, q, g_lo:w_end + 1] = True
        if self.attention == "unidirectional":
            layout[0] &= np.tril(np.ones((n, n), bool))
        return self.check_and_propagate_first_head_layout(layout)


class VariableSparsityConfig(FixedSparsityConfig):
    """Reference :239 — fixed layout with per-head variation hooks; the
    TPU layout generation shares FixedSparsityConfig's pattern."""


class BigBirdSparsityConfig(SparsityConfig):
    """Random + sliding window + global blocks (reference :411)."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_random_blocks=1, num_sliding_window_blocks=3, num_global_blocks=1,
                 attention="bidirectional", seed=0):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention
        self.seed = seed  # kept public so instances round-trip to sections
        self._rng = np.random.RandomState(seed)

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        n = layout.shape[1]
        w = self.num_sliding_window_blocks // 2
        # per-head random blocks when different_layout_per_head (reference
        # loops over num_layout_heads, :439)
        heads = self.num_heads if self.different_layout_per_head else 1
        for h in range(heads):
            for q in range(n):
                layout[h, q, max(0, q - w):min(n, q + w + 1)] = True  # sliding window
                rand = self._rng.choice(n, size=min(self.num_random_blocks, n),
                                        replace=False)
                layout[h, q, rand] = True  # random blocks
            layout[h, :, :self.num_global_blocks] = True  # global columns
            layout[h, :self.num_global_blocks, :] = True  # global rows
            if self.attention == "unidirectional":
                layout[h] &= np.tril(np.ones((n, n), bool))
        return self.check_and_propagate_first_head_layout(layout)


class BSLongformerSparsityConfig(SparsityConfig):
    """Sliding window + selected global block indices (reference :546)."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_sliding_window_blocks=3, global_block_indices=(0,),
                 global_block_end_indices=None, attention="bidirectional"):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.global_block_indices = list(global_block_indices)
        self.global_block_end_indices = (list(global_block_end_indices)
                                         if global_block_end_indices else None)
        self.attention = attention

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        n = layout.shape[1]
        w = self.num_sliding_window_blocks // 2
        for q in range(n):
            layout[0, q, max(0, q - w):min(n, q + w + 1)] = True
        if self.global_block_end_indices is None:
            for g in self.global_block_indices:
                if g < n:
                    layout[0, :, g] = True
                    layout[0, g, :] = True
        else:
            for g, e in zip(self.global_block_indices, self.global_block_end_indices):
                layout[0, :, g:e] = True
                layout[0, g:e, :] = True
        if self.attention == "unidirectional":
            layout[0] &= np.tril(np.ones((n, n), bool))
        return self.check_and_propagate_first_head_layout(layout)
