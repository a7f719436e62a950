"""Inference v2: ragged (FastGen-style) serving on PyTorch and CUDA.

Port of ``deepspeed_tpu/inference/v2``: the engine, the ragged state
(block allocator, sequence descriptors, blocked KV cache, ragged batch)
and the Dynamic SplitFuse continuous-batching scheduler."""

from deepspeed_tpu_torch.inference.v2.config_v2 import (AsyncBurstConfig, DSStateManagerConfig,
                                                        KVTierConfig, LoRAServingConfig,
                                                        PrefixCacheConfig, QuantizationConfig,
                                                        RaggedInferenceEngineConfig,
                                                        SpecDecodeConfig, StructuredConfig)
from deepspeed_tpu_torch.inference.v2.engine_v2 import InferenceEngineV2
from deepspeed_tpu_torch.inference.v2.scheduler import DynamicSplitFuseScheduler

__all__ = ["InferenceEngineV2", "RaggedInferenceEngineConfig", "DSStateManagerConfig",
           "QuantizationConfig", "PrefixCacheConfig", "KVTierConfig", "SpecDecodeConfig",
           "LoRAServingConfig", "StructuredConfig", "AsyncBurstConfig",
           "DynamicSplitFuseScheduler"]
