"""Llama-family configuration, serving parameters and the training model
in PyTorch.

Port of ``deepspeed_tpu/models/llama.py``:

- :class:`LlamaConfig` and its presets, the RoPE tables (numpy, copied
  verbatim) and GQA ``repeat_kv``;
- serving: :func:`init_params`, random weights from a seeded
  ``torch.Generator`` on the device in a stacked parameter layout

    {"embed_tokens": [V, D],
     "layers": {"input_norm": [L, D], "post_norm": [L, D],
                "wq": [L, D, H*Dh], "wk": [L, D, Hkv*Dh], "wv": [L, D, Hkv*Dh],
                "wo": [L, H*Dh, D],
                "w_gate": [L, D, I], "w_up": [L, D, I], "w_down": [L, I, D],
                optional "bq"/"bk"/"bv"/"bo": [L, out]},
     "norm": [D],
     "lm_head": [D, V]}            # absent when tie_word_embeddings

  with projections ``x @ w``, ``w`` stored [in, out] as in the JAX tree.
  An MoE model (``moe_num_experts`` E > 0) has, in place of the dense
  MLP, the router ``"gate_wg": [L, D, E]`` and the expert stacks
  ``"experts_w1"``/``"experts_w3": [L, E, D, I]`` (gate, up) and
  ``"experts_w2": [L, E, I, D]`` (down). :func:`init_quantized_params`
  draws the same layout as grouped quantized carriers, one layer at a
  time;
- training: the ``nn.Module``s :class:`RMSNorm`, :class:`LlamaAttention`,
  :class:`LlamaMLP`, :class:`LlamaBlock`, :class:`LlamaModel` and
  :class:`LlamaForCausalLM` (``forward(input_ids, labels)`` → ``(loss,
  logits)``, ``(loss, None)`` on the chunked-loss path), built by
  :func:`build_llama`. Each layer owns its parameters (an
  ``nn.ModuleList`` of blocks, one ``nn.Parameter`` per leaf, named as the
  JAX tree's paths: ``model.layers.3.self_attn.q_proj.kernel``): indexing
  a stacked [L, ...] parameter would make autograd build a full [L, ...]
  zero gradient for every layer. ``models/convert.py`` unstacks the JAX
  tree onto it and restacks it.

``models/convert.py`` maps a JAX tree onto either layout. Serving takes
dense and MoE models; training takes dense models only (MoE training
raises, ROADMAP.md port queue item 17).
"""

import dataclasses
import math
import re

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from deepspeed_tpu_torch.device import resolve_device
from deepspeed_tpu_torch.ops.kernels.flash_attention import flash_attention
from deepspeed_tpu_torch.ops.kernels.fused_norms import fused_rms_norm
from deepspeed_tpu_torch.roadmap import not_ported


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    # RoPE frequency rescaling (Llama-3.x): "none" | "linear" | "llama3"
    rope_scaling_type: str = "none"
    rope_scaling_factor: float = 1.0
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    rope_original_max_position: int = 8192
    tie_word_embeddings: bool = False
    # Qwen2-style QKV biases (Llama/Mistral/Mixtral: False)
    attention_bias: bool = False
    # InternLM-style o_proj bias (with attention_bias=True: biases on all
    # four attention projections)
    attention_out_bias: bool = False
    # Gemma-family knobs: explicit head_dim decoupled from hidden/heads,
    # GeGLU gate activation, and sqrt(hidden) embedding scaling.
    # 0 / "silu" / 1.0 = Llama.
    head_dim_override: int = 0
    mlp_activation: str = "silu"  # "silu" | "gelu_tanh"
    embedding_multiplier: float = 1.0
    attention_impl: str = "auto"  # "auto" | "einsum" | "flash"
    sp_impl: str = "ulysses"  # "ulysses" | "ring"
    remat: bool = True
    remat_policy: str = "full"  # "full" | "dots" | "moe"
    offload_params: bool = False
    # MoE (0 = dense)
    moe_num_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_loss_coef: float = 0.01
    moe_drop_tokens: bool = True
    moe_noisy_gate_policy: str = ""
    loss_chunk: int = 2048

    @property
    def head_dim(self):
        return self.head_dim_override or self.hidden_size // self.num_attention_heads


LLAMA_CONFIGS = {
    "debug": LlamaConfig(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                         num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128),
    "160m": LlamaConfig(vocab_size=32000, hidden_size=768, intermediate_size=2048, num_hidden_layers=12,
                        num_attention_heads=12, num_key_value_heads=12, max_position_embeddings=2048),
    "1b": LlamaConfig(vocab_size=32000, hidden_size=2048, intermediate_size=5504, num_hidden_layers=22,
                      num_attention_heads=16, num_key_value_heads=16, max_position_embeddings=4096),
    "7b": LlamaConfig(),
    "13b": LlamaConfig(hidden_size=5120, intermediate_size=13824, num_hidden_layers=40,
                       num_attention_heads=40, num_key_value_heads=40),
    "70b": LlamaConfig(hidden_size=8192, intermediate_size=28672, num_hidden_layers=80,
                       num_attention_heads=64, num_key_value_heads=8),
    "mistral-7b": LlamaConfig(vocab_size=32000, hidden_size=4096, intermediate_size=14336,
                              num_hidden_layers=32, num_attention_heads=32,
                              num_key_value_heads=8, max_position_embeddings=32768,
                              rope_theta=1e6),
    "mixtral-8x7b": LlamaConfig(vocab_size=32000, hidden_size=4096, intermediate_size=14336,
                                num_hidden_layers=32, num_attention_heads=32,
                                num_key_value_heads=8, max_position_embeddings=32768,
                                rope_theta=1e6, moe_num_experts=8, moe_top_k=2),
    "qwen2-7b": LlamaConfig(vocab_size=152064, hidden_size=3584, intermediate_size=18944,
                            num_hidden_layers=28, num_attention_heads=28,
                            num_key_value_heads=4, max_position_embeddings=32768,
                            rope_theta=1e6, attention_bias=True),
    "mixtral-debug": LlamaConfig(vocab_size=256, hidden_size=64, intermediate_size=128,
                                 num_hidden_layers=2, num_attention_heads=4,
                                 num_key_value_heads=2, max_position_embeddings=128,
                                 moe_num_experts=4, moe_top_k=2),
}


def llama_config(preset_or_config="debug", **overrides) -> LlamaConfig:
    """A preset name or a config, with ``overrides`` replaced into it."""
    cfg = preset_or_config if isinstance(preset_or_config, LlamaConfig) \
        else LLAMA_CONFIGS[preset_or_config]
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def rope_frequencies(head_dim: int, max_len: int, theta: float, scaling=None):
    """cos/sin tables [T, D/2]. ``scaling``: None, ("linear", factor), or
    ("llama3", factor, low_freq_factor, high_freq_factor, orig_max) —
    the Llama-3.x wavelength-dependent inv_freq rescale (long wavelengths
    divided by ``factor``, short kept, smooth ramp between)."""
    inv_freq = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))
    if scaling is not None and scaling[0] != "none":
        kind = scaling[0]
        if kind == "linear":
            inv_freq = inv_freq / scaling[1]
        elif kind == "llama3":
            _, factor, low_f, high_f, orig_max = scaling
            wavelen = 2.0 * np.pi / inv_freq
            low_wl = orig_max / low_f
            high_wl = orig_max / high_f
            scaled = np.where(wavelen > low_wl, inv_freq / factor, inv_freq)
            smooth = (orig_max / wavelen - low_f) / (high_f - low_f)
            mid = (1.0 - smooth) * inv_freq / factor + smooth * inv_freq
            inv_freq = np.where((wavelen <= low_wl) & (wavelen >= high_wl), mid, scaled)
        else:
            raise ValueError(f"unknown rope scaling {kind!r}")
    t = np.arange(max_len, dtype=np.float32)
    freqs = np.outer(t, inv_freq)  # [T, D/2]
    return np.cos(freqs), np.sin(freqs)


def rope_scaling_of(cfg):
    """Config → the ``scaling`` tuple ``rope_frequencies`` takes."""
    kind = getattr(cfg, "rope_scaling_type", "none")
    if kind == "none":
        return None
    if kind == "linear":
        return ("linear", cfg.rope_scaling_factor)
    if kind == "llama3":
        return ("llama3", cfg.rope_scaling_factor, cfg.rope_low_freq_factor,
                cfg.rope_high_freq_factor, cfg.rope_original_max_position)
    raise ValueError(f"unknown rope_scaling_type {kind!r}: expected 'none', 'linear', "
                     f"or 'llama3'")


def repeat_kv(k, v, n_rep: int):
    """GQA head expansion on [.., S, Hkv, D] K/V (no-op when n_rep == 1)."""
    if n_rep == 1:
        return k, v
    return k.repeat_interleave(n_rep, dim=-2), v.repeat_interleave(n_rep, dim=-2)


def check_servable(cfg: LlamaConfig):
    """Raise for a config the serving path cannot run."""
    if cfg.moe_num_experts and not 1 <= cfg.moe_top_k <= cfg.moe_num_experts:
        raise ValueError(f"moe_top_k={cfg.moe_top_k} must lie in [1, moe_num_experts="
                         f"{cfg.moe_num_experts}]")


def param_shapes(cfg: LlamaConfig):
    """{name: shape} of the port's parameter layout (module docstring)."""
    check_servable(cfg)
    L, D, I, V = (cfg.num_hidden_layers, cfg.hidden_size, cfg.intermediate_size,
                  cfg.vocab_size)
    H, Hkv, Dh = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    layers = {"input_norm": (L, D), "post_norm": (L, D),
              "wq": (L, D, H * Dh), "wk": (L, D, Hkv * Dh), "wv": (L, D, Hkv * Dh),
              "wo": (L, H * Dh, D)}
    E = cfg.moe_num_experts
    if E:
        layers.update(gate_wg=(L, D, E), experts_w1=(L, E, D, I), experts_w3=(L, E, D, I),
                      experts_w2=(L, E, I, D))
    else:
        layers.update(w_gate=(L, D, I), w_up=(L, D, I), w_down=(L, I, D))
    if cfg.attention_bias:
        layers.update(bq=(L, H * Dh), bk=(L, Hkv * Dh), bv=(L, Hkv * Dh))
        if cfg.attention_out_bias:
            layers["bo"] = (L, D)
    shapes = {"embed_tokens": (V, D), "layers": layers, "norm": (D,)}
    if not cfg.tie_word_embeddings:
        shapes["lm_head"] = (D, V)
    return shapes


def init_params(cfg: LlamaConfig, device=None, dtype=torch.bfloat16, generator=None,
                std=0.02):
    """Random serving weights on ``device`` (None = CUDA; raises without a
    GPU): matrices and biases N(0, std²) drawn from ``generator`` (a
    ``torch.Generator`` on that device; seed 0 when None), norm scales 1."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)

    def make(name, shape):
        if name.endswith("norm"):
            return torch.ones(shape, device=device, dtype=dtype)
        return torch.randn(shape, generator=generator, device=device, dtype=dtype) * std

    shapes = param_shapes(cfg)
    out = {k: make(k, s) for k, s in shapes.items() if k != "layers"}
    out["layers"] = {k: make(k, s) for k, s in shapes["layers"].items()}
    return out


def init_quantized_params(cfg: LlamaConfig, scheme, device=None, dtype=torch.bfloat16,
                          generator=None, std=0.02, group_size=512):
    """Random serving weights as grouped ``scheme`` carriers (int8, fp8 or
    fp6) on ``device`` (None = CUDA; raises without a GPU), drawn as
    :func:`init_params` draws them, in ``dtype``, one layer's leaf at a
    time: each slice is quantized into the stacked carriers and let go,
    so the full-precision tree never exists (Mixtral-8x7B's is ~93 GB in
    bf16). Leaves the quantizer passes over (norm scales, biases, a last
    dim with no legal group) stay in ``dtype``."""
    from deepspeed_tpu_torch.inference.quantization.quantization import (QUANTIZED_LEAVES,
                                                                         QuantizedWeight,
                                                                         _quantize_grouped)
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    pat = re.compile(QUANTIZED_LEAVES)

    def draw(name, shape):
        if name.endswith("norm"):
            return torch.ones(shape, device=device, dtype=dtype)
        return torch.randn(shape, generator=generator, device=device, dtype=dtype) * std

    def quantize(name, shape):
        if not pat.search(name):
            return draw(name, shape)
        first = _quantize_grouped(draw(name, shape[1:]), scheme, group_size, dtype)
        if not isinstance(first, QuantizedWeight):  # no legal group: the leaf stays dense
            return torch.stack([first] + [draw(name, shape[1:]) for _ in range(shape[0] - 1)])
        values = torch.empty((shape[0],) + tuple(first.values.shape), dtype=first.values.dtype,
                             device=device)
        scales = torch.empty((shape[0],) + tuple(first.scales.shape), dtype=torch.float32,
                             device=device)
        values[0], scales[0] = first.values, first.scales
        del first
        for i in range(1, shape[0]):
            q = _quantize_grouped(draw(name, shape[1:]), scheme, group_size, dtype)
            values[i], scales[i] = q.values, q.scales
            del q
        return QuantizedWeight(values, scales, shape, scheme, dequant_dtype=dtype)

    shapes = param_shapes(cfg)
    out = {}
    for k, s in shapes.items():
        if k == "layers":
            continue
        # the embedding and the head are one slab each: quantize them whole
        w = draw(k, s)
        out[k] = (_quantize_grouped(w, scheme, group_size, dtype) if pat.search(k) and
                  len(s) >= 2 else w)
        del w
    out["layers"] = {k: quantize(k, s) for k, s in shapes["layers"].items()}
    return out


def count_params(params) -> int:
    n = 0
    for v in params.values():
        if isinstance(v, dict):
            n += count_params(v)
        else:
            n += math.prod(v.shape)
    return n


# ---------------------------------------------------------------- training
def check_trainable(cfg: LlamaConfig):
    """Raise for the training options this port does not run yet."""
    if cfg.moe_num_experts:
        raise not_ported("MoE training (the grouped-GEMM backward kernels)", 17)
    if cfg.sp_impl != "ulysses":
        raise not_ported(f"sp_impl={cfg.sp_impl!r} (ring sequence parallelism)", 6)
    if cfg.offload_params:
        raise not_ported("offload_params (ZeRO-Infinity parameter streaming)", 12)
    if cfg.remat and cfg.remat_policy != "full":
        if cfg.remat_policy in ("dots", "moe"):
            raise not_ported(f"remat_policy={cfg.remat_policy!r}", 10)
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}: expected 'full', 'dots' "
                         f"or 'moe'")
    if cfg.attention_impl not in ("auto", "einsum", "flash"):
        raise ValueError(f"attention_impl {cfg.attention_impl!r}: auto | einsum | flash")
    if cfg.mlp_activation not in ("silu", "gelu_tanh"):
        raise ValueError(f"mlp_activation {cfg.mlp_activation!r}: silu | gelu_tanh")


def _param(shape, device, dtype, generator, std):
    """N(0, std²) from ``generator``, or ones when ``std`` is None."""
    if std is None:
        return nn.Parameter(torch.ones(shape, device=device, dtype=dtype))
    t = torch.empty(shape, device=device, dtype=dtype)
    return nn.Parameter(t.normal_(0.0, std, generator=generator))


class Dense(nn.Module):
    """``x @ kernel (+ bias)`` with ``kernel`` stored [in, out], as the JAX
    package's ``QuantDense`` (unquantized). Random init N(0, 1/in)."""

    def __init__(self, d_in, d_out, bias, device, dtype, generator):
        super().__init__()
        self.kernel = _param((d_in, d_out), device, dtype, generator, 1.0 / math.sqrt(d_in))
        self.bias = (nn.Parameter(torch.zeros(d_out, device=device, dtype=dtype))
                     if bias else None)

    def forward(self, x):
        y = x @ self.kernel
        return y if self.bias is None else y + self.bias


class RMSNorm(nn.Module):
    """RMSNorm over the last dim through ``fused_rms_norm`` (the CUDA kernel
    on the GPU, its plain version on the CPU)."""

    def __init__(self, dim, eps, device, dtype):
        super().__init__()
        self.eps = eps
        self.scale = _param((dim,), device, dtype, None, None)

    def forward(self, x):
        return fused_rms_norm(x, self.scale, self.eps)


def apply_rope(x, cos, sin, positions):
    """x: [B, S, H, D]; cos/sin: fp32 [T, D/2] tensors; positions: [B or 1, S]."""
    cos = cos[positions][:, :, None, :]
    sin = sin[positions][:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def einsum_attention(q, k, v, causal=True):
    """The JAX package's ``einsum_attention`` (its training branch):
    [B, S, H, D] → [B, S, H, D]; scores from a matmul in the input dtype,
    softmax in fp32, probabilities cast back before the product with v."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        sq, sk = scores.shape[-2:]
        mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril(diagonal=sk - sq)
        scores = scores.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def local_attention(q, k, v, impl, causal=True):
    """``attention_impl`` "auto" takes the flash kernel once the [S, S]
    scores dominate (S ≥ 256) and the einsum path below, as the JAX model
    does on its kernel path."""
    if impl == "auto":
        impl = "flash" if q.shape[1] >= 256 else "einsum"
    if impl == "flash":
        return flash_attention(q, k, v, causal=causal)
    return einsum_attention(q, k, v, causal=causal)


class LlamaAttention(nn.Module):

    def __init__(self, cfg, device, dtype, generator):
        super().__init__()
        self.config = cfg
        H, Hkv, Dh, D = (cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim,
                         cfg.hidden_size)
        args = (device, dtype, generator)
        self.q_proj = Dense(D, H * Dh, cfg.attention_bias, *args)
        self.k_proj = Dense(D, Hkv * Dh, cfg.attention_bias, *args)
        self.v_proj = Dense(D, Hkv * Dh, cfg.attention_bias, *args)
        self.o_proj = Dense(H * Dh, D, cfg.attention_out_bias, *args)

    def forward(self, h, positions, cos, sin):
        cfg = self.config
        B, S, _ = h.shape
        H, Hkv, Dh = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
        q = apply_rope(self.q_proj(h).view(B, S, H, Dh), cos, sin, positions)
        k = apply_rope(self.k_proj(h).view(B, S, Hkv, Dh), cos, sin, positions)
        v = self.v_proj(h).view(B, S, Hkv, Dh)
        k, v = repeat_kv(k, v, H // Hkv)
        out = local_attention(q, k, v, cfg.attention_impl, causal=True)
        return self.o_proj(out.reshape(B, S, H * Dh))


class LlamaMLP(nn.Module):

    def __init__(self, cfg, device, dtype, generator):
        super().__init__()
        self.activation = cfg.mlp_activation
        D, I = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = Dense(D, I, False, device, dtype, generator)
        self.up_proj = Dense(D, I, False, device, dtype, generator)
        self.down_proj = Dense(I, D, False, device, dtype, generator)

    def forward(self, h):
        gate = self.gate_proj(h)
        act = F.silu(gate) if self.activation == "silu" else F.gelu(gate, approximate="tanh")
        return self.down_proj(act * self.up_proj(h))


class LlamaBlock(nn.Module):

    def __init__(self, cfg, device, dtype, generator):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, device, dtype)
        self.self_attn = LlamaAttention(cfg, device, dtype, generator)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, device, dtype)
        self.mlp = LlamaMLP(cfg, device, dtype, generator)

    def forward(self, h, positions, cos, sin):
        h = h + self.self_attn(self.input_layernorm(h), positions, cos, sin)
        return h + self.mlp(self.post_attention_layernorm(h))


class LlamaModel(nn.Module):
    """Decoder trunk: embeddings, the blocks (each recomputed in the
    backward when ``remat``: ``remat_policy="full"``, the JAX
    ``nothing_saveable``), final norm."""

    def __init__(self, cfg, device, dtype, generator):
        super().__init__()
        self.config = cfg
        self.embed_tokens = _param((cfg.vocab_size, cfg.hidden_size), device, dtype, generator,
                                   0.02)
        self.layers = nn.ModuleList(LlamaBlock(cfg, device, dtype, generator)
                                    for _ in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, device, dtype)
        cos, sin = rope_frequencies(cfg.head_dim, cfg.max_position_embeddings, cfg.rope_theta,
                                    scaling=rope_scaling_of(cfg))
        self.register_buffer("rope_cos", torch.from_numpy(cos).to(device), persistent=False)
        self.register_buffer("rope_sin", torch.from_numpy(sin).to(device), persistent=False)

    def forward(self, input_ids):
        cfg = self.config
        h = self.embed_tokens[input_ids.long()]
        if cfg.embedding_multiplier != 1.0:  # Gemma: sqrt(hidden_size)
            h = h * torch.tensor(cfg.embedding_multiplier, dtype=h.dtype)
        positions = torch.arange(input_ids.shape[1], device=h.device)[None, :]
        remat = cfg.remat and torch.is_grad_enabled()
        for block in self.layers:
            if remat:
                h = checkpoint(block, h, positions, self.rope_cos, self.rope_sin,
                               use_reentrant=False)
            else:
                h = block(h, positions, self.rope_cos, self.rope_sin)
        return self.norm(h)


def _ce_chunk_stats(logits, targets):
    """(masked nll sum fp32, valid-token count) for one loss chunk."""
    logits = logits.float()
    mask = targets != -100
    safe = torch.where(mask, targets, torch.zeros_like(targets)).long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    return torch.where(mask, nll, torch.zeros_like(nll)).sum(), mask.sum()


def masked_cross_entropy(logits, targets):
    """Mean token cross entropy in fp32; positions with target -100 are
    ignored (HF convention)."""
    s, c = _ce_chunk_stats(logits, targets)
    return s / c.clamp(min=1).float()


def causal_lm_loss(logits, labels):
    """Next-token cross entropy with -100 ignore mask, fp32."""
    return masked_cross_entropy(logits[:, :-1], labels[:, 1:])


class LlamaForCausalLM(nn.Module):
    """Causal LM with the next-token shift inside.

    ``forward(input_ids, labels)`` → ``(loss, logits)``; ``forward(input_ids)``
    → ``logits``. Labels -100 are ignored. For sequences longer than
    ``2 * config.loss_chunk`` the loss is computed chunk by chunk, each
    chunk's unembed and cross entropy recomputed in the backward, and the
    second element is **None**: the [B, S, vocab] logits never exist."""

    def __init__(self, config, device=None, dtype=torch.float32, generator=None):
        super().__init__()
        check_trainable(config)
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        self.config = config
        self.model = LlamaModel(config, device, dtype, generator)
        self.lm_head = (None if config.tie_word_embeddings else
                        Dense(config.hidden_size, config.vocab_size, False, device, dtype,
                              generator))

    def _unembed(self, h):
        if self.lm_head is None:
            return h @ self.model.embed_tokens.t()
        return self.lm_head(h)

    def forward(self, input_ids, labels=None):
        cfg = self.config
        h = self.model(input_ids)
        S = input_ids.shape[1]
        if labels is not None and cfg.loss_chunk > 0 and S > 2 * cfg.loss_chunk:
            return self._chunked_causal_loss(h, labels), None
        logits = self._unembed(h)
        if labels is None:
            return logits
        return causal_lm_loss(logits, labels), logits

    def _chunked_causal_loss(self, h, labels):
        C = self.config.loss_chunk
        hs, ls = h[:, :-1], labels[:, 1:]
        pad = (-hs.shape[1]) % C
        if pad:
            hs = F.pad(hs, (0, 0, 0, pad))
            ls = F.pad(ls, (0, pad), value=-100)

        def step(hc, lc):
            return _ce_chunk_stats(self._unembed(hc), lc)

        total = torch.zeros((), dtype=torch.float32, device=h.device)
        count = torch.zeros((), dtype=torch.int64, device=h.device)
        for i in range(hs.shape[1] // C):
            s, c = checkpoint(step, hs[:, i * C:(i + 1) * C], ls[:, i * C:(i + 1) * C],
                              use_reentrant=False)
            total, count = total + s, count + c
        return total / count.clamp(min=1).float()


def build_llama(preset_or_config="debug", device=None, dtype=torch.float32, generator=None,
                **overrides) -> LlamaForCausalLM:
    """The training model for a preset (or config) with ``overrides``, random
    weights from ``generator`` (seed 0 when None) on ``device`` (None =
    CUDA; raises without a GPU)."""
    return LlamaForCausalLM(llama_config(preset_or_config, **overrides), device, dtype,
                            generator)
