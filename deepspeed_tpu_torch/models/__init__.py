from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.models.llama import (LLAMA_CONFIGS, LlamaConfig, init_params,
                                              llama_config)

__all__ = ["LLAMA_CONFIGS", "LlamaConfig", "init_params", "llama_config", "params_from_jax"]
