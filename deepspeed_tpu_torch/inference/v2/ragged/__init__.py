from deepspeed_tpu_torch.inference.v2.ragged.blocked_allocator import BlockedAllocator
from deepspeed_tpu_torch.inference.v2.ragged.kv_cache import NULL_BLOCK, BlockedKVCache
from deepspeed_tpu_torch.inference.v2.ragged.ragged_manager import DSStateManager
from deepspeed_tpu_torch.inference.v2.ragged.ragged_wrapper import RaggedBatchWrapper
from deepspeed_tpu_torch.inference.v2.ragged.sequence_descriptor import DSSequenceDescriptor

__all__ = ["BlockedAllocator", "BlockedKVCache", "NULL_BLOCK",
           "DSStateManager", "RaggedBatchWrapper", "DSSequenceDescriptor"]
