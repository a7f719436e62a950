"""Fused Adam/AdamW on fp32 master tensors.

Port of ``deepspeed_tpu/ops/adam/fused_adam.py`` (XLA fuses the per-leaf
chain there). The same update, leaf by leaf, in fp32:

    m = beta1 m + (1 - beta1) g          v = beta2 v + (1 - beta2) g^2
    denom = sqrt(v / bc2) + eps          update = (m / bc1) / denom
    p -= lr (update + wd p)              (adam_w_mode: decoupled decay)
    g += wd p before the moments         (adam_w_mode False: L2 decay)

with ``bc1 = 1 - beta1^step``, ``bc2 = 1 - beta2^step`` when
``bias_correction`` (else 1). It is not a TPU kernel: the leaves are
updated with PyTorch's multi-tensor ``torch._foreach_*`` ops, in groups of
about 64M elements so that the one fp32 scratch (the denominator) stays
small beside the state.
"""

import torch

from deepspeed_tpu_torch.ops.op_base import DeepSpeedOptimizer

_GROUP_NUMEL = 1 << 26


def _groups(n_leaves, numels):
    start, size = 0, 0
    for i in range(n_leaves):
        size += numels[i]
        if size >= _GROUP_NUMEL or i == n_leaves - 1:
            yield slice(start, i + 1)
            start, size = i + 1, 0


class FusedAdam(DeepSpeedOptimizer):
    """Adam/AdamW with bias correction. ``adam_w_mode=True`` applies
    decoupled weight decay (AdamW)."""

    def __init__(self,
                 params=None,
                 lr=1e-3,
                 bias_correction=True,
                 betas=(0.9, 0.999),
                 eps=1e-8,
                 adam_w_mode=True,
                 weight_decay=0.0,
                 amsgrad=False,
                 set_grad_none=True):
        if amsgrad:
            raise RuntimeError("FusedAdam does not support the AMSGrad variant.")
        super().__init__(params=params, lr=lr, betas=betas, eps=eps, weight_decay=weight_decay,
                         bias_correction=bias_correction, adam_w_mode=adam_w_mode)

    def init(self, params):
        return {"step": 0,
                "exp_avg": [torch.zeros_like(p, dtype=torch.float32) for p in params],
                "exp_avg_sq": [torch.zeros_like(p, dtype=torch.float32) for p in params]}

    @torch.no_grad()
    def update(self, grads, state, params, lr):
        group = self.param_groups[0]
        beta1, beta2 = group["betas"]
        eps, wd = group["eps"], group["weight_decay"]
        adam_w = group["adam_w_mode"]
        state["step"] += 1
        step = state["step"]
        bc1, bc2 = ((1.0 - beta1**step, 1.0 - beta2**step) if group["bias_correction"]
                    else (1.0, 1.0))
        numels = [p.numel() for p in params]
        for sl in _groups(len(params), numels):
            p, g = params[sl], grads[sl]
            m, v = state["exp_avg"][sl], state["exp_avg_sq"][sl]
            if wd != 0.0 and not adam_w:
                g = torch._foreach_add(g, p, alpha=wd)
            torch._foreach_mul_(m, beta1)
            torch._foreach_add_(m, g, alpha=1.0 - beta1)
            torch._foreach_mul_(v, beta2)
            torch._foreach_addcmul_(v, g, g, value=1.0 - beta2)
            denom = torch._foreach_div(v, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, eps)
            if wd != 0.0 and adam_w:
                torch._foreach_mul_(p, 1.0 - lr * wd)
            torch._foreach_addcdiv_(p, m, denom, value=-lr / bc1)


class FusedAdamW(FusedAdam):

    def __init__(self, params=None, **kwargs):
        kwargs["adam_w_mode"] = True
        super().__init__(params=params, **kwargs)
