"""Sparse self-attention over a block layout.

Port of ``deepspeed_tpu/ops/sparse_attention/sparse_self_attention.py``:
attention restricted to the key blocks a :class:`SparsityConfig` layout
admits. Two paths, as in the JAX package:

- **block-sparse kernels** (``ops/kernels/block_sparse_attention.py``):
  with no mask and a sequence that is a multiple of the block, the layout
  compresses to admitted-block lists and the kernels walk only those, on
  CUDA tensors; CPU tensors take the kernels' plain version;
- **masked dense**: the layout expands to a score mask on
  ``einsum_attention``, composed with a key-padding or attention mask
  (element-wise masks are not block-granular, so the kernels cannot honour
  them). A row that admits nothing gets a uniform softmax there, where the
  kernel path gives zeros; the port keeps both, as the JAX package does.
"""

import torch

from deepspeed_tpu_torch.models.llama import einsum_attention
from deepspeed_tpu_torch.ops.kernels import block_sparse_attention as bsa
from deepspeed_tpu_torch.ops.sparse_attention.sparsity_config import (DenseSparsityConfig,
                                                                      SparsityConfig)


def layout_to_mask(layout, block, seq_len):
    """[H, nb, nb] block layout → [H, S, S] boolean mask (CPU tensor)."""
    return bsa.block_mask(layout, block)[:, :seq_len, :seq_len]


class SparseSelfAttention:

    def __init__(self, sparsity_config: SparsityConfig = None, key_padding_mask_mode="add",
                 attn_mask_mode="mul", max_seq_length=2048, force_kernel=None):
        self.sparsity_config = sparsity_config or DenseSparsityConfig(num_heads=1)
        self.max_seq_length = max_seq_length
        self.key_padding_mask_mode = key_padding_mask_mode
        self.attn_mask_mode = attn_mask_mode
        self.force_kernel = force_kernel  # None = auto, True/False pin
        self._mask_cache = {}
        self._layout_cache = {}

    @staticmethod
    def _as_keep_mask(mask, mode):
        """Reference mask conventions → boolean keep-mask: 'mul' masks are
        1/0 (or bool) multipliers; 'add' masks are 0 (keep) /
        large-negative (drop) additive biases."""
        mask = torch.as_tensor(mask)
        if mode == "add" and mask.is_floating_point():
            return mask >= 0
        return mask.bool()

    def _layout(self, seq_len):
        if seq_len not in self._layout_cache:
            self._layout_cache[seq_len] = self.sparsity_config.make_layout(seq_len)
        return self._layout_cache[seq_len]

    def _mask(self, seq_len, device):
        key = (seq_len, str(device))
        if key not in self._mask_cache:
            self._mask_cache[key] = layout_to_mask(
                self._layout(seq_len), self.sparsity_config.block, seq_len).to(device)
        return self._mask_cache[key]

    def _use_kernel(self, seq_len):
        if self.force_kernel is not None:
            return self.force_kernel
        return seq_len % self.sparsity_config.block == 0

    def __call__(self, q, k, v, key_padding_mask=None, attn_mask=None):
        """q/k/v: [B, S, H, D] → [B, S, H, D]; the layout mask composes
        with an optional [B, S] key padding mask and an optional [S, S] /
        [B, S, S] attention mask. Element-wise masks take the masked-dense
        path."""
        B, S, H, D = q.shape
        if key_padding_mask is None and attn_mask is None and self._use_kernel(S):
            return bsa.block_sparse_attention(q, k, v, self._layout(S),
                                              self.sparsity_config.block)
        mask = self._mask(S, q.device)[None]  # [1, H or 1, S, S]
        if key_padding_mask is not None:
            kp = self._as_keep_mask(key_padding_mask, self.key_padding_mask_mode).to(q.device)
            mask = mask & kp[:, None, None, :]  # [B, 1, 1, S]
        if attn_mask is not None:
            am = self._as_keep_mask(attn_mask, self.attn_mask_mode).to(q.device)
            am = am[None, None] if am.dim() == 2 else am[:, None]  # → [B or 1, 1, S, S]
            mask = mask & am
        return einsum_attention(q, k, v, causal=False, mask=mask)
