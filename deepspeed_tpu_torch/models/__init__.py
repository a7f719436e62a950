from deepspeed_tpu_torch.models.convert import (bert_params_from_jax, bert_params_to_jax,
                                                kv_handle_from_jax, kv_handle_to_jax,
                                                load_bert_params, load_jax_params,
                                                params_from_jax, params_to_jax)
from deepspeed_tpu_torch.models.llama import (LLAMA_CONFIGS, LlamaConfig, LlamaForCausalLM,
                                              build_llama, init_params, llama_config)
from deepspeed_tpu_torch.models.bert import (BERT_CONFIGS, BertConfig, BertForMaskedLM,
                                             BertForSequenceClassification, build_bert)

__all__ = ["LLAMA_CONFIGS", "LlamaConfig", "LlamaForCausalLM", "build_llama", "init_params",
           "llama_config", "kv_handle_from_jax", "kv_handle_to_jax", "load_jax_params",
           "params_from_jax", "params_to_jax", "BERT_CONFIGS", "BertConfig", "BertForMaskedLM",
           "BertForSequenceClassification", "build_bert", "bert_params_from_jax",
           "bert_params_to_jax", "load_bert_params"]
