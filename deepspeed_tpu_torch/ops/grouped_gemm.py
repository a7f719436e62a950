"""Dropless top-k MoE FFN over a flat token batch: the grouped GEMM path.

Port of ``deepspeed_tpu/ops/grouped_gemm.py`` on one device, for serving
and for training.
Expert stacks are ``[E, D, I]`` / ``[E, D, I]`` / ``[E, I, D]`` tensors
or grouped quantized carriers (:class:`QuantizedWeight`).

Every grouped GEMM, dense or quantized, at every row count, goes through
the kernel wrappers (``ops/kernels/grouped_matmul``: ``gmm`` for bf16
stacks, ``gmm_quant`` for carriers) over the tile-aligned row layout that
:func:`moe_grouped_mlp` builds on the tensors' device: per-expert counts
and ranks from a one-hot cumsum, each tile's expert by ``searchsorted`` on
the cumulative tile counts, a static padded size, and the used-tile count
left on the device, so routing never syncs with the host. CUDA tensors
launch the hand-written kernels; CPU tensors take their plain versions,
so the CPU runs the card's routing and layout code too. The TPU
package's row-count floor for its Pallas path, its gathered decode branch
and its ``lax.ragged_dot`` path are TPU measurements and are not carried
over.

The three GEMMs are one ``torch.autograd.Function``, differentiable in x
and in dense stacks (``gmm``'s VJP): dx through ``gmm_transposed``
(reading the stack as stored), dW through ``gmm_dw``; through carriers,
x only (``gmm_quant``'s VJP, the frozen-base contract: carriers and
scales get no gradient), dx through ``gmm_quant_dx``. On the card each
GEMM takes one of two designs, chosen by shape before the launch and
counted by design (``gmm_{fwd,dx,dw}_design_launches``): the Hopper
designs (wgmma fed by a TMA ring; the forward and dW at 64-row tiles,
dx at either tile, wherever TMA can read the operands) or the first,
general ones (``qgemm_kernel`` for the forward: decode's 16-row tiles
and every ``gmm_quant``; ``gmm_dx_kernel``, ``gmm_dw_kernel``). It saves exactly what the JAX ``remat_policy="moe"``
keeps, the scattered rows and the gate and up activations (``moe_xs``,
``moe_gate``, ``moe_up``; the routing, ``moe_routing`` and ``moe_tiles``,
is the index tensors beside them), and rebuilds the SwiGLU product
elementwise, so its backward re-runs no forward GEMM. The scatter into
the layout and the gather back are indexing ops whose gradients PyTorch
takes (rows land in distinct slots).

Expert parallelism (a mesh) is not ported yet (ROADMAP.md, port queue
item 5).
"""

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.inference.quantization.quantization import QuantizedWeight
from deepspeed_tpu_torch.ops.kernels import grouped_matmul as gm
from deepspeed_tpu_torch.ops.kernels.fused_quant_matmul import row_tile
from deepspeed_tpu_torch.roadmap import not_ported


def _is_quantized(w):
    return isinstance(w, QuantizedWeight)


def _cast_stack(w, dtype):
    return w if _is_quantized(w) else w.to(dtype)


def sort_by_expert(x, expert_idx, num_experts):
    """→ (x_sorted [T, D], group_sizes [E], unsort_idx [T]): contiguous
    per-expert grouping of a flat batch (stable)."""
    order = torch.sort(expert_idx, stable=True).indices
    group_sizes = torch.bincount(expert_idx.long(), minlength=num_experts)
    unsort = torch.sort(order, stable=True).indices
    return x[order], group_sizes, unsort


def _gmm_dispatch(xp, w, te, tm, used):
    """One grouped GEMM on the tile-aligned layout: ``gmm`` for a dense
    stack, ``gmm_quant`` for carriers (dequantized to the activation
    dtype)."""
    if _is_quantized(w):
        return gm.gmm_quant(xp, w.values, w.scales, te, w.scheme, xp.dtype, tm, used)
    return gm.gmm(xp, w, te, tm, used)


def _gmm_dx(dy, w, te, tm, used):
    """The input gradient of :func:`_gmm_dispatch`: ``dy @ w[tile]ᵀ``."""
    if _is_quantized(w):
        return gm.gmm_quant_dx(dy, w.values, w.scales, te, w.scheme, dy.dtype, tm, used)
    return gm.gmm_transposed(dy, w, te, tm, used)


class _GroupedSwiGLU(torch.autograd.Function):
    """``(silu(xp @ w_gate) * (xp @ w_up)) @ w_down`` over the tile layout
    (each row tile through its expert's weights). Saves xp, gate and up;
    the backward rebuilds the product, takes dW of each dense stack with
    ``gmm_dw`` and dx with the transposed kernels: 3 forward launches,
    then 3 dx and (dense) 3 dW launches, and no forward re-run."""

    @staticmethod
    def forward(ctx, xp, w_gate, w_up, w_down, te, tm, used):
        gate = _gmm_dispatch(xp, w_gate, te, tm, used)
        up = _gmm_dispatch(xp, w_up, te, tm, used)
        inter = (F.silu(gate) * up).contiguous()
        ctx.save_for_backward(xp, gate, up, te, used)
        ctx.stacks, ctx.tm = (w_gate, w_up, w_down), tm
        return _gmm_dispatch(inter, w_down, te, tm, used)

    @staticmethod
    def backward(ctx, d_out):
        xp, gate, up, te, used = ctx.saved_tensors
        w_gate, w_up, w_down = ctx.stacks
        tm = ctx.tm
        need = ctx.needs_input_grad
        d_out = d_out.to(xp.dtype).contiguous()
        with torch.enable_grad():  # the elementwise product, as autograd takes it
            g, u = gate.detach().requires_grad_(), up.detach().requires_grad_()
            inter = F.silu(g) * u
        d_w = [None, None, None]
        if need[3] and not _is_quantized(w_down):
            d_w[2] = gm.gmm_dw(inter.detach().contiguous(), d_out, te, w_down.shape[0], tm,
                               used, w_down.dtype)
        d_gate, d_up = torch.autograd.grad(inter, (g, u), _gmm_dx(d_out, w_down, te, tm, used))
        del inter, g, u
        d_gate, d_up = d_gate.contiguous(), d_up.contiguous()
        for i, (w, dy) in enumerate(((w_gate, d_gate), (w_up, d_up))):
            if need[1 + i] and not _is_quantized(w):
                d_w[i] = gm.gmm_dw(xp, dy, te, w.shape[0], tm, used, w.dtype)
        d_xp = None
        if need[0]:
            d_xp = _gmm_dx(d_gate, w_gate, te, tm, used)
            d_xp += _gmm_dx(d_up, w_up, te, tm, used)
        return (d_xp, *d_w, None, None, None)


def moe_grouped_mlp(x, expert_idx, w_gate, w_up, w_down, num_experts, tm=None):
    """Dropless top-1 MoE FFN with SwiGLU experts: x [T, D]; expert_idx
    [T]; stacks [E, D, F] / [E, D, F] / [E, F, D] (dense or carriers) →
    [T, D] in x's dtype, differentiable in x and the dense stacks. Rows
    are scattered into the tile-aligned layout by rank (no sort), ride
    three grouped GEMMs and are gathered back; no step waits on the host.
    ``tm`` is the row tile (:func:`row_tile` of the average rows per
    expert when None)."""
    M, E = x.shape[0], num_experts
    if tm is None:
        tm = row_tile(-(-M // E))
    idx = expert_idx.long()
    oh = (idx[:, None] == torch.arange(E, device=x.device)[None, :]).to(torch.int32)
    ranks = torch.cumsum(oh, dim=0)
    sizes = ranks[-1]
    rank_in_e = ranks.gather(1, idx[:, None])[:, 0] - 1
    padded_starts, te, Mp = gm.tile_layout(sizes, M, tm)
    pdst = padded_starts[idx] + rank_in_e
    used = gm.used_tiles(sizes, tm)
    xp = torch.zeros((Mp, x.shape[1]), dtype=x.dtype, device=x.device)
    xp[pdst] = x
    return _GroupedSwiGLU.apply(xp, w_gate, w_up, w_down, te, tm, used)[pdst]


def dropless_moe_ffn(x, topk_idx, topk_vals, w1, w3, w2, num_experts, mesh=None):
    """Post-gate dropless MoE FFN over flat tokens: ``x`` [T, D];
    ``topk_idx``/``topk_vals`` [T, k] (weights already renormalized);
    ``w1``/``w3`` [E, D, I], ``w2`` [E, I, D] → [T, D]. Tokens replicate
    k times, ride the grouped GEMMs, and combine with the gate weights in
    x's dtype."""
    if mesh is not None:
        raise not_ported("expert- and tensor-parallel MoE (a mesh)", 5)
    T, k = topk_idx.shape
    x_rep = x.repeat_interleave(k, dim=0)
    out_rep = moe_grouped_mlp(x_rep, topk_idx.reshape(-1), _cast_stack(w1, x.dtype),
                              _cast_stack(w3, x.dtype), _cast_stack(w2, x.dtype), num_experts)
    return torch.einsum("tk,tkd->td", topk_vals.to(x.dtype), out_rep.reshape(T, k, -1))


def dense_reference_mlp(x, expert_idx, w_gate, w_up, w_down, activation=F.silu):
    """O(T*E) check: every token through every expert, each keeps its own."""
    gate = torch.einsum("td,edf->tef", x, w_gate)
    up = torch.einsum("td,edf->tef", x, w_up)
    out = torch.einsum("tef,efd->ted", activation(gate) * up, w_down)
    return out[torch.arange(x.shape[0]), expert_idx.long()].to(x.dtype)
