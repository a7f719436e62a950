"""Top-k gating and expert dispatch.

Port of ``deepspeed_tpu/moe/sharded_moe.py`` on one device. The gate
computes its logits in fp32 from an fp32 router weight (the engine keeps
every parameter in the compute dtype; the gate widens both operands, as
the JAX gate's fp32 ``Dense`` does), takes an fp32 softmax and a greedy
top-k (ties to the lowest expert, as ``jax.lax.top_k``), and then either

- truncates each expert to its capacity (:func:`topkgating`: per-expert
  slots by a running count, the assignments past capacity dropped, the
  survivors' weights renormalized) and routes through the einsum dispatch
  of :class:`MOELayer` over [E, C, D] (a plain product, as the JAX package
  leaves it to XLA); or
- keeps every token's full top-k (``drop_tokens=False``, dropless) and
  routes through the grouped-GEMM kernels of ``ops/grouped_gemm.py``.

Both return the GShard load-balancing loss of the first choice.
``noisy_gate_policy`` ("Jitter": multiplicative input noise; "RSample":
logit noise) applies only in training and only when the gate has a
``generator`` (the JAX gate's ``has_rng("dropout")``); its numbers are
not ``jax.random``'s. Expert parallelism (an 'expert' mesh axis) is not
ported yet (ROADMAP.md, port queue item 5).
"""

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

MIN_CAPACITY = 4


def _capacity(num_tokens: int, num_experts: int, k: int, capacity_factor: float,
              min_capacity: int = MIN_CAPACITY) -> int:
    cap = int(np.ceil(num_tokens * k * capacity_factor / num_experts))
    return max(cap, min_capacity)


def multiplicative_jitter(x, generator, epsilon: float = 1e-2):
    """``x`` times iid uniform noise in [1 - eps, 1 + eps) drawn in fp32
    from ``generator`` (the reference's ``multiplicative_jitter``)."""
    if epsilon == 0.0:
        return x
    noise = torch.rand(x.shape, generator=generator, device=x.device, dtype=torch.float32)
    return x * (noise * (2 * epsilon) + (1.0 - epsilon)).to(x.dtype)


def gshard_aux_loss(gates, primary_mask):
    """GShard load-balancing loss: ``sum(mean_prob * mean_routed_fraction)
    * E`` from the primary assignment."""
    me = gates.mean(dim=0)
    ce = primary_mask.float().mean(dim=0)
    return (me * ce).sum() * gates.shape[-1]


def top_k(gates, k):
    """``jax.lax.top_k`` over the last dim: the k largest, ties to the
    lowest index (a stable descending sort keeps that order, which
    ``torch.topk`` does not promise). The serving router takes it too."""
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _one_hot(idx, n):
    """``jax.nn.one_hot``: an index outside [0, n) gives a row of zeros."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(torch.int32)


def topkgating(logits, k: int, capacity_factor: float = 1.0,
               min_capacity: int = MIN_CAPACITY, normalize: bool = True):
    """Top-k routing with capacity: ``logits`` [T, E] → (aux_loss,
    combine_weights [T, E, C] fp32, dispatch_mask [T, E, C] bool)."""
    T, E = logits.shape
    C = _capacity(T, E, k, capacity_factor, min_capacity)
    gates = torch.softmax(logits.float(), dim=-1)
    topk_vals, topk_idx = top_k(gates, k)

    masks, loc_toks, keeps = [], [], []
    offset = torch.zeros(E, dtype=torch.int32, device=logits.device)
    aux_loss = None
    for j in range(k):
        mask_j = _one_hot(topk_idx[:, j], E)  # [T, E]
        if j == 0:
            aux_loss = gshard_aux_loss(gates, mask_j)
        # each token's slot in its expert's capacity buffer
        loc_j = torch.cumsum(mask_j, dim=0, dtype=torch.int32) - 1 + offset[None, :]
        offset = offset + mask_j.sum(dim=0, dtype=torch.int32)
        within = (loc_j < C) & (mask_j > 0)
        masks.append(mask_j)
        loc_toks.append((loc_j * mask_j).sum(dim=-1))
        keeps.append(within.any(dim=-1))

    # drop the assignments past capacity, then renormalize over the survivors
    w = topk_vals * torch.stack(keeps, dim=1).float()
    if normalize and k > 1:
        w = w / w.sum(-1, keepdim=True).clamp(min=1e-9)

    combine = torch.zeros((T, E, C), dtype=torch.float32, device=logits.device)
    for j in range(k):
        combine = combine + (w[:, j, None, None] * masks[j].float()[:, :, None]
                             * _one_hot(loc_toks[j], C).float()[:, None, :])
    return aux_loss, combine, combine > 0.0


def top1gating(logits, capacity_factor=1.0, min_capacity=MIN_CAPACITY):
    """Switch-style top-1 gating."""
    return topkgating(logits, k=1, capacity_factor=capacity_factor, min_capacity=min_capacity)


def top2gating(logits, capacity_factor=1.0, min_capacity=MIN_CAPACITY):
    """GShard top-2 gating."""
    return topkgating(logits, k=2, capacity_factor=capacity_factor, min_capacity=min_capacity)


def _lecun_normal(shape, fan_in, device, dtype, generator):
    t = torch.empty(shape, device=device, dtype=dtype)
    return nn.Parameter(t.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator))


class _Kernel(nn.Module):
    """A bias-free linear weight stored [in, out] as ``kernel`` (the JAX
    ``nn.Dense`` leaf name)."""

    def __init__(self, d_in, d_out, device, dtype, generator):
        super().__init__()
        self.kernel = _lecun_normal((d_in, d_out), d_in, device, dtype, generator)


class TopKGate(nn.Module):
    """Linear router + top-k routing. ``forward(x)`` → with ``drop_tokens``
    (default) ``(aux_loss, combine [T, E, C], dispatch [T, E, C])``;
    dropless ``(aux_loss, topk_weights [T, k] fp32, topk_idx [T, k])``,
    every token keeping its full top-k. The capacity factor is
    ``capacity_factor`` in training and ``eval_capacity_factor`` otherwise
    (``module.training``). ``generator``: the noise source of
    ``noisy_gate_policy`` (None: no noise)."""

    def __init__(self, model_dim, num_experts, k=1, capacity_factor=1.0,
                 eval_capacity_factor=1.0, min_capacity=MIN_CAPACITY, noisy_gate_policy=None,
                 drop_tokens=True, device=None, dtype=torch.float32, generator=None):
        super().__init__()
        if noisy_gate_policy not in (None, "", "Jitter", "RSample"):
            raise ValueError(f"noisy_gate_policy {noisy_gate_policy!r}: Jitter | RSample | None")
        self.num_experts, self.k = num_experts, k
        self.capacity_factor, self.eval_capacity_factor = capacity_factor, eval_capacity_factor
        self.min_capacity, self.drop_tokens = min_capacity, drop_tokens
        self.noisy_gate_policy = noisy_gate_policy or None
        self.generator = None
        self.wg = _Kernel(model_dim, num_experts, device, dtype, generator)

    def forward(self, x):
        x32 = x.float()
        noisy = self.training and self.generator is not None
        if noisy and self.noisy_gate_policy == "Jitter":
            x32 = multiplicative_jitter(x32, self.generator)
        logits = (x32 @ self.wg.kernel.float()).reshape(-1, self.num_experts)
        if noisy and self.noisy_gate_policy == "RSample":
            logits = logits + torch.randn(logits.shape, generator=self.generator,
                                          device=logits.device) / self.num_experts
        if not self.drop_tokens:
            gates = torch.softmax(logits, dim=-1)
            topk_vals, topk_idx = top_k(gates, self.k)
            aux_loss = gshard_aux_loss(gates, _one_hot(topk_idx[:, 0], self.num_experts))
            if self.k > 1:
                topk_vals = topk_vals / topk_vals.sum(-1, keepdim=True).clamp(min=1e-9)
            return aux_loss, topk_vals, topk_idx
        cf = self.capacity_factor if self.training else self.eval_capacity_factor
        return topkgating(logits, self.k, cf, self.min_capacity)


class MOELayer(nn.Module):
    """Gate → dispatch → SwiGLU experts → combine. ``forward(x [B, S, D])``
    → ``(out [B, S, D], aux_loss)``. The experts are stacked parameters
    ``experts_w1``/``experts_w3`` [E, D, I] (gate, up) and ``experts_w2``
    [E, I, D] (down). Dropless: the grouped-GEMM path
    (``ops.grouped_gemm.dropless_moe_ffn``), differentiable through the
    hand-written backward kernels; with capacity: the einsum dispatch over
    [E, C, D]."""

    def __init__(self, num_experts, hidden_size, intermediate_size, k=2, capacity_factor=1.0,
                 eval_capacity_factor=1.0, min_capacity=MIN_CAPACITY, noisy_gate_policy=None,
                 drop_tokens=True, device=None, dtype=torch.float32, generator=None):
        super().__init__()
        E, D, I = num_experts, hidden_size, intermediate_size
        self.num_experts, self.drop_tokens = E, drop_tokens
        self.gate = TopKGate(D, E, k, capacity_factor, eval_capacity_factor, min_capacity,
                             noisy_gate_policy, drop_tokens, device, dtype, generator)
        self.experts_w1 = _lecun_normal((E, D, I), D, device, dtype, generator)
        self.experts_w3 = _lecun_normal((E, D, I), D, device, dtype, generator)
        self.experts_w2 = _lecun_normal((E, I, D), I, device, dtype, generator)

    def forward(self, x, routing=None):
        """``routing``: this ``x``'s gate output when the caller took it
        already (the ``"moe"`` remat policy recomputes the router with
        the attention half)."""
        from deepspeed_tpu_torch.ops.grouped_gemm import dropless_moe_ffn
        B, S, D = x.shape
        aux_loss, combine, dispatch = self.gate(x) if routing is None else routing
        if not self.drop_tokens:
            topk_w, topk_idx = combine, dispatch  # [T, k] each: the gate's dropless form
            out = dropless_moe_ffn(x.reshape(B * S, D), topk_idx, topk_w.to(x.dtype),
                                   self.experts_w1, self.experts_w3, self.experts_w2,
                                   num_experts=self.num_experts)
            return out.reshape(B, S, D), aux_loss
        E, C = dispatch.shape[1], dispatch.shape[2]
        dispatched = torch.einsum("bsec,bsd->ecd", dispatch.reshape(B, S, E, C).to(x.dtype), x)
        out = self.experts(dispatched)
        combined = torch.einsum("bsec,ecd->bsd", combine.reshape(B, S, E, C).to(x.dtype), out)
        return combined, aux_loss

    def experts(self, dispatched):
        """SwiGLU expert FFNs over [E, C, D]."""
        dt = dispatched.dtype
        h = F.silu(torch.einsum("ecd,edi->eci", dispatched, self.experts_w1.to(dt)))
        h = h * torch.einsum("ecd,edi->eci", dispatched, self.experts_w3.to(dt))
        return torch.einsum("eci,eid->ecd", h, self.experts_w2.to(dt))
