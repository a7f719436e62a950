"""Ragged model execution: flat token batches against a paged KV cache.

Port of ``deepspeed_tpu/inference/v2/model_runner.py`` for the Llama
family (Llama, Mistral, Mixtral-style MoE, Qwen2-style biases, Gemma
knobs), with dense or weight-only quantized params:

- tokens are a flat ``[T]`` buffer with per-token (slot, position);
- each layer writes its new K/V into the block pool at
  ``(block_tables[slot, pos // bs], pos % bs)`` — in place, where the
  JAX version returns an updated pool — and attends over each token's
  block table masked to ``pos``, which handles mixed prefill chunks and
  decodes in one step (Dynamic SplitFuse);
- the layer stack is a Python loop over the stacked layer params;
- dense projections go through ``dense_matmul``, a hand-written GEMM
  whose per-row sums do not depend on the batch's row count, and the RMS
  norms through the hand-written RMS forward (one warp a row), so greedy
  streams are the same at every token bucket and in a verify forward;
- quantized carriers (``inference/quantization``) stay quantized: every
  projection runs through the fused dequant-matmul kernel
  (``QuantizedWeight.matmul``), the MoE expert stacks through the grouped kernels
  (``ops/grouped_gemm``), and only the router, one small [D, E] slice a
  layer, is dequantized; the embedding decodes just the gathered rows,
  and the head goes through the fused kernel too;
- multi-tenant LoRA (``lora=``): each attention projection adds every
  token's adapter delta through the segmented LoRA kernel
  (``ops/kernels/lora_matmul``), whatever carrier the base weight is; the
  tokens' segmentation by adapter slot is computed once per forward and
  serves all 4 x L calls (the slots are the same at every layer and site).

Pad tokens carry the pad slot, whose table is all null blocks, so every
bucket keeps its static shape (ready for CUDA-graph capture later).
"""

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.inference.quantization.quantization import (QuantizedWeight,
                                                                     dequantize_grouped)
from deepspeed_tpu_torch.inference.v2.modules.heuristics import instantiate_attn
from deepspeed_tpu_torch.models.llama import check_servable, rope_frequencies, rope_scaling_of
from deepspeed_tpu_torch.moe.sharded_moe import top_k
from deepspeed_tpu_torch.ops.grouped_gemm import dropless_moe_ffn
from deepspeed_tpu_torch.ops.kernels.fused_norms import rms_norm_fwd, rms_norm_ref
from deepspeed_tpu_torch.ops.kernels.fused_quant_matmul import dense_matmul
from deepspeed_tpu_torch.ops.kernels.lora_matmul import lora_delta, lora_layout


def _rms(x, scale, eps):
    """RMS norm, fp32 statistics, x's dtype out: on CUDA the hand-written
    RMS forward (``csrc/fused_norms.cu``, one warp a row summing in a fixed
    order, so a row's bits do not depend on the batch; PyTorch's mean
    reduction takes another order at another row count), on the CPU its
    plain version."""
    if x.is_cuda:
        return rms_norm_fwd(x.contiguous(), scale.to(x.dtype), eps)
    return rms_norm_ref(x, scale, eps)


def _proj(x, w, b=None):
    """``x @ w (+ b)`` in x's dtype: a carrier through the fused kernel, a
    dense ``w`` through :func:`dense_matmul`, whose row sums do not depend
    on the batch's row count (cuBLAS's do: a token's bits would move with
    the token bucket it runs at)."""
    y = (w.matmul(x, dtype=x.dtype) if isinstance(w, QuantizedWeight)
         else dense_matmul(x, w.to(x.dtype)))
    if b is not None:
        y = y + b.to(x.dtype)
    return y


def _lproj(x, w, b, site, lora):
    """:func:`_proj`, then, at a LoRA site, ``y += delta`` in place:
    ``lora`` is None or this layer's ``(a {site: [S, in, r]}, b {site:
    [S, r, out]}, scales [S], layout)``."""
    y = _proj(x, w, b)
    if lora is not None and site in lora[0]:
        la, lb, scales, layout = lora
        lora_delta(x, y, la[site], lb[site], scales, layout)
    return y


def _rope_flat(x, cos, sin, positions):
    """x: [T, H, D]; cos/sin tables [maxlen, D/2] fp32; positions [T]."""
    c = cos[positions][:, None, :]
    s = sin[positions][:, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def rope_tables(cfg, device):
    """fp32 cos/sin tables [max_position_embeddings, head_dim/2] on ``device``."""
    cos, sin = rope_frequencies(cfg.head_dim, cfg.max_position_embeddings, cfg.rope_theta,
                                scaling=rope_scaling_of(cfg))
    return torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(device)


def _paged_attend(q, k, v, kc, vc, batch, attn_fn):
    """Write the new K/V into this layer's pool slice, then attend over
    each token's block-tabled context."""
    bs = kc.shape[1]
    pos = batch["token_pos"]
    tab = batch["block_tables"][batch["token_seq"]]  # [T, MB]
    blk = batch["block_tables"][batch["token_seq"], pos // bs]  # [T]
    off = pos % bs
    kc[blk, off] = k.to(kc.dtype)
    vc[blk, off] = v.to(vc.dtype)
    return attn_fn(q, kc, vc, tab, pos)


def _layer_step(cfg, cos, sin, batch, attn_fn, h, lp, kc, vc, lora=None):
    T = h.shape[0]
    H, Hkv, Dh = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim

    hn = _rms(h, lp["input_norm"], cfg.rms_norm_eps)
    q = _lproj(hn, lp["wq"], lp.get("bq"), "q_proj", lora).reshape(T, H, Dh)
    k = _lproj(hn, lp["wk"], lp.get("bk"), "k_proj", lora).reshape(T, Hkv, Dh)
    v = _lproj(hn, lp["wv"], lp.get("bv"), "v_proj", lora).reshape(T, Hkv, Dh)
    q = _rope_flat(q, cos, sin, batch["token_pos"])
    k = _rope_flat(k, cos, sin, batch["token_pos"])

    out = _paged_attend(q, k, v, kc, vc, batch, attn_fn)
    h = h + _lproj(out.reshape(T, H * Dh), lp["wo"], lp.get("bo"), "o_proj", lora)

    hn2 = _rms(h, lp["post_norm"], cfg.rms_norm_eps)
    if "gate_wg" in lp:
        return h + _moe_mlp(hn2, lp, cfg.moe_top_k)
    gate = _proj(hn2, lp["w_gate"])
    up = _proj(hn2, lp["w_up"])
    if cfg.mlp_activation == "gelu_tanh":  # Gemma GeGLU
        inter = F.gelu(gate, approximate="tanh") * up
    else:
        inter = F.silu(gate) * up
    return h + _proj(inter, lp["w_down"])


def _moe_mlp(x, lp, k):
    """Dropless top-k MoE over the flat [T, D] batch, in the JAX order of
    roundings: the router dequantized to x's dtype and only then taken to
    fp32, an fp32 softmax, top-k, renormalization by max(sum, 1e-9), and
    the combine in x's dtype (``dropless_moe_ffn``)."""
    gk = lp["gate_wg"]
    if isinstance(gk, QuantizedWeight):
        gk = gk.dequantized(x.dtype)
    gates = torch.softmax(x.float() @ gk.float(), dim=-1)
    topk_vals, topk_idx = top_k(gates, k)
    if k > 1:
        topk_vals = topk_vals / topk_vals.sum(-1, keepdim=True).clamp(min=1e-9)
    return dropless_moe_ffn(x, topk_idx, topk_vals, lp["experts_w1"], lp["experts_w3"],
                            lp["experts_w2"], num_experts=gates.shape[-1])


def _embed(embed, ids, dtype):
    """Rows ``ids`` of the embedding in ``dtype``; a carrier decodes only
    the gathered rows (grouped dequantization is elementwise, so the bits
    equal those of decoding the whole table first)."""
    if isinstance(embed, QuantizedWeight):
        return dequantize_grouped(embed.values[ids], embed.scales[ids], embed.scheme, dtype)
    return embed[ids].to(dtype)


def ragged_forward(params, kcache, vcache, batch, cfg, dtype=torch.bfloat16,
                   attn_impl=None, rope=None, lora=None):
    """→ (logits [len(last_index), vocab] fp32 of the tokens ``last_index``
    selects, kcache, vcache): each sequence's last token in a put or a
    burst step (``max_seqs`` rows), every token in a verify (``arange(T)``).

    ``kcache``/``vcache``: [L, NB, bs, Hkv, Dh], updated in place and
    returned; ``batch``: the tensors of ``unpack_batch`` on the params'
    device. ``attn_impl`` pins an attention implementation by name;
    ``rope``: precomputed :func:`rope_tables` (built here when None).
    ``lora``: None (the exact pre-LoRA forward) or ``(a, b, scales,
    seq_adapters)`` — the per-site hot slabs ``a[site] [L, S, in, r]`` /
    ``b[site] [L, S, r, out]``, per-slot ``scales [S]`` fp32, and the
    batch's per-sequence adapter slots ``seq_adapters [max_seqs + 1]``
    (pad row = slot 0 = base)."""
    check_servable(cfg)
    embed = params["embed_tokens"]
    device = embed.device
    h = _embed(embed, batch["token_ids"], dtype)  # [T, D]
    if cfg.embedding_multiplier != 1.0:  # Gemma: sqrt(hidden_size)
        h = h * cfg.embedding_multiplier
    cos, sin = rope if rope is not None else rope_tables(cfg, device)

    _, attn_fn = instantiate_attn(device, cfg.head_dim, override=attn_impl)
    layout = None
    if lora is not None:
        la, lb, scales, seq_adapters = lora
        # per-token slot: pad tokens take the pad row, which is slot 0 (base)
        layout = lora_layout(seq_adapters[batch["token_seq"]], scales.shape[0])
    layers = params["layers"]
    for i in range(cfg.num_hidden_layers):
        lp = {name: w[i] for name, w in layers.items()}  # a carrier's [i] is a carrier
        lora_i = None if layout is None else (
            {s: a[i] for s, a in la.items()}, {s: b[i] for s, b in lb.items()}, scales, layout)
        h = _layer_step(cfg, cos, sin, batch, attn_fn, h, lp, kcache[i], vcache[i], lora_i)

    # Selecting the last tokens before the head gives the same rows as the
    # JAX order (head over all T, then select) at max_seqs/T of the cost.
    h = _rms(h[batch["last_index"]], params["norm"], cfg.rms_norm_eps)
    if "lm_head" in params:
        return _proj(h, params["lm_head"]).float(), kcache, vcache
    table = embed.dequantized(h.dtype) if isinstance(embed, QuantizedWeight) else embed
    return (h @ table.t().to(h.dtype)).float(), kcache, vcache
