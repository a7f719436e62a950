"""v2 inference engine config.

Port of ``deepspeed_tpu/inference/v2/config_v2.py`` as dataclasses with
the same field names and defaults. Sections may be given as dicts. The
port's engine serves dense and MoE models, in bf16 or with weight-only
quantized weights (``quantization.quantization_mode`` ``"int8"``,
``"fp8"`` or ``"fp6"``), with or without multi-tenant LoRA (``lora``,
its disk tier under ``lora.publish_root`` included), the prefix cache and
its KV tier, speculative decoding (``spec_decode``), constrained decoding
(``structured``) and pipelined decode bursts (``async_burst``); it raises
``NotImplementedError`` at construction for a config that turns on a
feature outside that (parallel degrees above 1; see
``engine_v2.unported_features``)."""

from dataclasses import dataclass, field

from deepspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigModel


@dataclass
class DSStateManagerConfig(DeepSpeedConfigModel):
    max_tracked_sequences: int = 2048
    max_ragged_batch_size: int = 768
    max_ragged_sequence_count: int = 512
    max_context: int = 8192
    memory_config_mode: str = "reserve"  # "reserve" | "allocate"
    memory_reserve_percentage: int = 90
    offload_kv: bool = False


@dataclass
class QuantizationConfig(DeepSpeedConfigModel):
    quantization_mode: str = "none"


@dataclass
class PrefixCacheConfig(DeepSpeedConfigModel):
    enabled: bool = False
    max_cached_blocks: int = 0


@dataclass
class KVTierConfig(DeepSpeedConfigModel):
    enabled: bool = False
    host_bytes: int = 1 << 30
    quantize: bool = False
    quant_group_size: int = 0
    prefetch: bool = True


@dataclass
class SpecDecodeConfig(DeepSpeedConfigModel):
    enabled: bool = False
    draft_len: int = 4
    max_ngram: int = 3
    min_ngram: int = 1
    ema_alpha: float = 0.4
    disable_below: float = 0.25
    warmup_steps: int = 3


@dataclass
class LoRAServingConfig(DeepSpeedConfigModel):
    enabled: bool = False
    hot_set: int = 8
    max_rank: int = 16
    host_bytes: int = 1 << 30
    prefetch: bool = True
    publish_root: str = ""


@dataclass
class StructuredConfig(DeepSpeedConfigModel):
    enabled: bool = False
    max_schemas: int = 4
    max_states: int = 64


@dataclass
class AsyncBurstConfig(DeepSpeedConfigModel):
    enabled: bool = False
    depth: int = 2


@dataclass
class RaggedInferenceEngineConfig(DeepSpeedConfigModel):
    tensor_parallel_degree: int = 1
    expert_parallel_degree: int = 1
    # pin a registry implementation by op, e.g. {"attention": "torch_gather"}
    implementation_overrides: dict = field(default_factory=dict)
    kv_block_size: int = 16
    num_kv_blocks: int = 0  # 0 = derive from max_context * max sequences
    state_manager: DSStateManagerConfig = field(default_factory=DSStateManagerConfig)
    quantization: QuantizationConfig = field(default_factory=QuantizationConfig)
    prefix_cache: PrefixCacheConfig = field(default_factory=PrefixCacheConfig)
    kv_tier: KVTierConfig = field(default_factory=KVTierConfig)
    spec_decode: SpecDecodeConfig = field(default_factory=SpecDecodeConfig)
    lora: LoRAServingConfig = field(default_factory=LoRAServingConfig)
    structured: StructuredConfig = field(default_factory=StructuredConfig)
    async_burst: AsyncBurstConfig = field(default_factory=AsyncBurstConfig)
    burst_fn_cache_cap: int = 48
