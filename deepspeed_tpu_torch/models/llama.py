"""Llama-family configuration and serving parameters in PyTorch.

Port of the parts of ``deepspeed_tpu/models/llama.py`` that serving
needs: :class:`LlamaConfig` and its presets, the RoPE tables
(numpy, copied verbatim), GQA ``repeat_kv``, and :func:`init_params`,
which makes random weights from a seeded ``torch.Generator`` on the
device in the port's parameter layout:

    {"embed_tokens": [V, D],
     "layers": {"input_norm": [L, D], "post_norm": [L, D],
                "wq": [L, D, H*Dh], "wk": [L, D, Hkv*Dh], "wv": [L, D, Hkv*Dh],
                "wo": [L, H*Dh, D],
                "w_gate": [L, D, I], "w_up": [L, D, I], "w_down": [L, I, D],
                optional "bq"/"bk"/"bv"/"bo": [L, out]},
     "norm": [D],
     "lm_head": [D, V]}            # absent when tie_word_embeddings

Projections are ``x @ w`` with ``w`` stored [in, out] and the layers
stacked on a leading L dim, as in the JAX param tree;
``models/convert.py`` maps a JAX tree onto this layout.
Dense Llama-family models only: MoE presets raise.
"""

import dataclasses

import numpy as np
import torch

from deepspeed_tpu_torch.device import resolve_device


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


def check_dense(cfg: LlamaConfig):
    if cfg.moe_num_experts:
        raise NotImplementedError(
            "MoE Llama-family models are not ported yet: ROADMAP.md, port queue "
            "item 3 (quantized, MoE and LoRA serving)")


def param_shapes(cfg: LlamaConfig):
    """{name: shape} of the port's parameter layout (module docstring)."""
    check_dense(cfg)
    L, D, I, V = (cfg.num_hidden_layers, cfg.hidden_size, cfg.intermediate_size,
                  cfg.vocab_size)
    H, Hkv, Dh = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    layers = {"input_norm": (L, D), "post_norm": (L, D),
              "wq": (L, D, H * Dh), "wk": (L, D, Hkv * Dh), "wv": (L, D, Hkv * Dh),
              "wo": (L, H * Dh, D),
              "w_gate": (L, D, I), "w_up": (L, D, I), "w_down": (L, I, D)}
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


def count_params(params) -> int:
    n = 0
    for v in params.values():
        n += count_params(v) if isinstance(v, dict) else v.numel()
    return n
