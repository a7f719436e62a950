"""Weight-only quantization of serving params (grouped carriers)."""

from deepspeed_tpu_torch.inference.quantization.quantization import (QuantizedWeight,
                                                                     matmul_any,
                                                                     quantize_params_tree,
                                                                     quantized_bytes)

__all__ = ["QuantizedWeight", "matmul_any", "quantize_params_tree", "quantized_bytes"]
