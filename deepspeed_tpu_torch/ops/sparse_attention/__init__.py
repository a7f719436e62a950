"""Sparse attention (port of ``deepspeed_tpu/ops/sparse_attention/``)."""

from deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention import (SparseSelfAttention,
                                                                             layout_to_mask)
from deepspeed_tpu_torch.ops.sparse_attention.sparse_attention_utils import (
    SparseAttentionUtils, build_sparse_self_attention, get_sparse_attention_config)
from deepspeed_tpu_torch.ops.sparse_attention.sparsity_config import (BigBirdSparsityConfig,
                                                                       BSLongformerSparsityConfig,
                                                                       DenseSparsityConfig,
                                                                       FixedSparsityConfig,
                                                                       SparsityConfig,
                                                                       VariableSparsityConfig)

__all__ = ["SparseSelfAttention", "layout_to_mask", "SparsityConfig", "DenseSparsityConfig",
           "FixedSparsityConfig", "VariableSparsityConfig", "BigBirdSparsityConfig",
           "BSLongformerSparsityConfig", "SparseAttentionUtils",
           "get_sparse_attention_config", "build_sparse_self_attention"]
