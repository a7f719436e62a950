from deepspeed_tpu_torch.models.convert import (kv_handle_from_jax, kv_handle_to_jax,
                                                load_jax_params, params_from_jax, params_to_jax)
from deepspeed_tpu_torch.models.llama import (LLAMA_CONFIGS, LlamaConfig, LlamaForCausalLM,
                                              build_llama, init_params, llama_config)

__all__ = ["LLAMA_CONFIGS", "LlamaConfig", "LlamaForCausalLM", "build_llama", "init_params",
           "llama_config", "kv_handle_from_jax", "kv_handle_to_jax", "load_jax_params",
           "params_from_jax", "params_to_jax"]
