"""Mixture of experts: gating, the MoE layer and its dispatch
(``moe/sharded_moe.py``, ``moe/layer.py``), on one device."""

from deepspeed_tpu_torch.moe.layer import MoE
from deepspeed_tpu_torch.moe.sharded_moe import (MOELayer, TopKGate, gshard_aux_loss,
                                                 multiplicative_jitter, top1gating, top2gating,
                                                 topkgating)

__all__ = ["MoE", "MOELayer", "TopKGate", "gshard_aux_loss", "multiplicative_jitter",
           "top1gating", "top2gating", "topkgating"]
