"""The public MoE module.

Port of ``deepspeed_tpu/moe/layer.py``'s ``MoE``: the experts are stacked
parameters inside :class:`~deepspeed_tpu_torch.moe.sharded_moe.MOELayer`
(``deepspeed_moe``), named as the JAX tree names them
(``deepspeed_moe.gate.wg.kernel``, ``deepspeed_moe.experts_w{1,3,2}``). The
caller adds ``aux_loss * coefficient`` to its loss. ``use_residual`` adds
the DeepSpeed-MoE residual branch: a dense MLP mixed with the experts'
output by a learned 2-way softmax."""

import torch
import torch.nn.functional as F
from torch import nn

from deepspeed_tpu_torch.moe.sharded_moe import MIN_CAPACITY, MOELayer, _Kernel
from deepspeed_tpu_torch.roadmap import not_ported


class _Coefficient(nn.Module):
    """``nn.Dense(2)`` with its bias: the residual branch's mixer."""

    def __init__(self, d_in, device, dtype, generator):
        super().__init__()
        self.kernel = _Kernel(d_in, 2, device, dtype, generator).kernel
        self.bias = nn.Parameter(torch.zeros(2, device=device, dtype=dtype))

    def forward(self, x):
        return x @ self.kernel + self.bias


class MoE(nn.Module):
    """Mixture-of-experts FFN. ``forward(hidden_states [B, S, D])`` →
    ``(output, aux_loss)``. ``intermediate_size`` 0 means 4 x hidden.
    ``ep_size`` > 1 (expert parallelism) is not ported yet; ``use_rts`` is
    accepted for config parity (capacity ties break by token order)."""

    def __init__(self, hidden_size, num_experts=1, intermediate_size=0, ep_size=1, k=1,
                 capacity_factor=1.0, eval_capacity_factor=1.0, min_capacity=MIN_CAPACITY,
                 use_residual=False, noisy_gate_policy="", drop_tokens=True, use_rts=True,
                 device=None, dtype=torch.float32, generator=None):
        super().__init__()
        if ep_size != 1:
            raise not_ported(f"expert parallelism (ep_size={ep_size})", 5)
        inter = intermediate_size or 4 * hidden_size
        self.use_residual = use_residual
        self.deepspeed_moe = MOELayer(num_experts, hidden_size, inter, k, capacity_factor,
                                      eval_capacity_factor, min_capacity,
                                      noisy_gate_policy or None, drop_tokens, device, dtype,
                                      generator)
        if use_residual:
            self.residual_up = _Kernel(hidden_size, inter, device, dtype, generator)
            self.residual_down = _Kernel(inter, hidden_size, device, dtype, generator)
            self.coefficient = _Coefficient(hidden_size, device, dtype, generator)

    def route(self, hidden_states):
        """The gate's output for ``hidden_states`` (:meth:`forward` takes it)."""
        return self.deepspeed_moe.gate(hidden_states)

    def forward(self, hidden_states, routing=None):
        out, aux_loss = self.deepspeed_moe(hidden_states, routing)
        if self.use_residual:
            res = F.silu(hidden_states @ self.residual_up.kernel) @ self.residual_down.kernel
            coef = torch.softmax(self.coefficient(hidden_states).float(), dim=-1).to(out.dtype)
            out = out * coef[..., 0:1] + res * coef[..., 1:2]
        return out, aux_loss
