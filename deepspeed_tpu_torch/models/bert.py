"""BERT-family bidirectional encoders in PyTorch, for training.

Port of ``deepspeed_tpu/models/bert.py``: the post-LN encoder block
(``LN(h + o_proj(attention))``, then ``LN(h + fc_out(gelu(fc_in(h))))``,
exact-erf GELU, biased projections), the embeddings (word + position +
optional token type, then LN), the masked-LM head (dense + GELU + LN, a
decoder tied to ``embed_tokens`` plus ``mlm_bias``) and the sequence
classification head ([CLS] pooler + classifier). Config axes cover BERT,
DistilBERT (``type_vocab_size`` 0: no token-type table) and RoBERTa
(``position_offset`` shifts the position lookup).

Each layer owns its parameters, named as the JAX tree's paths with the
layer index after ``layers`` (``model.layers.3.q_proj.kernel``,
``model.layers.3.attn_layernorm.scale``); ``models/convert.py`` unstacks
the JAX tree onto them and restacks them. Kernels stored [in, out].

Attention (:func:`_attention`), as in the JAX model:
- with a ``sparse_attention`` section (set by ``SparseAttentionUtils.
  replace_model_self_attention_with_sparse_self_attention``), layout-sparse
  attention through ``SparseSelfAttention``: no ``attention_mask`` → the
  block-sparse kernels (their plain version on the CPU); a mask → the
  masked-dense path. One layout per (section, heads, S), drawn from a fresh
  config, serves every layer and every step, as the JAX model's one traced
  block does (a BigBird config draws new random blocks on each call);
- otherwise dense: the flash kernel (K1, non-causal, padding as segment
  ids) for CUDA tensors at S ≥ 256 under ``attention_impl="auto"``, else
  ``einsum_attention`` with the padding as a key mask.

Every LayerNorm goes through ``fused_layer_norm`` (the CUDA kernel on the
GPU, its plain version on the CPU). Its variance is the two-pass form of
the TPU kernel; flax's ``nn.LayerNorm``, which the JAX model uses, takes
E[x²] − E[x]² (ROADMAP.md queue 3), a difference within fp32 tolerance.
``remat=True`` recomputes each block in the backward.
"""

import dataclasses
import functools

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from deepspeed_tpu_torch.device import resolve_device
from deepspeed_tpu_torch.models.llama import Dense, _param, einsum_attention, masked_cross_entropy
from deepspeed_tpu_torch.ops.kernels.flash_attention import flash_attention
from deepspeed_tpu_torch.ops.kernels.fused_norms import fused_layer_norm
from deepspeed_tpu_torch.roadmap import not_ported


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 512
    type_vocab_size: int = 2          # 0 = no token-type table (DistilBERT)
    layer_norm_eps: float = 1e-12
    hidden_dropout: float = 0.0       # kept for the config's shape; no layer reads it
    position_offset: int = 0          # RoBERTa reserves pad+1 slots
    attention_impl: str = "auto"      # "auto" | "einsum" | "flash"
    remat: bool = False
    # ds_config sparse_attention section, frozen to (key, value) tuples so
    # the config stays hashable
    sparse_attention: tuple = None
    # nonzero after structural head pruning
    head_dim_override: int = 0

    @property
    def head_dim(self):
        return self.head_dim_override or self.hidden_size // self.num_attention_heads


BERT_CONFIGS = {
    "bert-debug": BertConfig(vocab_size=256, hidden_size=64, intermediate_size=128,
                             num_hidden_layers=2, num_attention_heads=4,
                             max_position_embeddings=64),
    "bert-base": BertConfig(),
    "bert-large": BertConfig(hidden_size=1024, intermediate_size=4096,
                             num_hidden_layers=24, num_attention_heads=16),
    "distilbert-base": BertConfig(num_hidden_layers=6, type_vocab_size=0),
    "roberta-base": BertConfig(vocab_size=50265, position_offset=2),
    "distilbert-debug": BertConfig(vocab_size=256, hidden_size=64, intermediate_size=128,
                                   num_hidden_layers=2, num_attention_heads=4,
                                   max_position_embeddings=64, type_vocab_size=0),
}


@functools.lru_cache(maxsize=64)
def _sparse_self_attention(section, num_heads, max_seq, seq_len):
    """A fresh ``SparseSelfAttention`` for (section, heads, S): its first
    layout for S is the one the JAX model's single traced block draws (an
    evicted entry is rebuilt fresh, so it draws the same layout again)."""
    from deepspeed_tpu_torch.ops.sparse_attention.sparse_attention_utils import (
        build_sparse_self_attention, thaw_section)
    return build_sparse_self_attention(thaw_section(section), num_heads,
                                       max_seq_length=max_seq)


def _attention(q, k, v, attention_mask, impl, sparse_section=None, max_seq=2048):
    """Bidirectional attention on [B, S, H, D] with an optional [B, S]
    validity mask (> 0 = a real token)."""
    B, S, H, D = q.shape
    if sparse_section is not None:
        ssa = _sparse_self_attention(sparse_section, H, max_seq, S)
        kpm = None if attention_mask is None else attention_mask.reshape(B, S) > 0
        return ssa(q, k, v, key_padding_mask=kpm)
    if impl == "auto":
        impl = "flash" if q.is_cuda and S >= 256 else "einsum"
    valid = None if attention_mask is None else attention_mask.reshape(B, S) > 0
    if impl == "flash":
        # pad tokens get their own segment, so valid keys never attend across
        seg = None if valid is None else torch.where(valid, 0, 1).to(torch.int32)
        return flash_attention(q, k, v, causal=False, segment_ids=seg)
    return einsum_attention(q, k, v, causal=False,
                            mask=None if valid is None else valid[:, None, None, :])


class LayerNorm(nn.Module):
    """LayerNorm over the last dim through ``fused_layer_norm``."""

    def __init__(self, dim, eps, device, dtype):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(dim, device=device, dtype=dtype))

    def forward(self, x):
        return fused_layer_norm(x, self.scale, self.bias, self.eps)


class BertBlock(nn.Module):
    """Classic post-LN encoder block."""

    def __init__(self, cfg, device, dtype, generator):
        super().__init__()
        self.config = cfg
        D, HD, I = cfg.hidden_size, cfg.num_attention_heads * cfg.head_dim, cfg.intermediate_size
        args = (device, dtype, generator)
        self.q_proj = Dense(D, HD, True, *args)
        self.k_proj = Dense(D, HD, True, *args)
        self.v_proj = Dense(D, HD, True, *args)
        self.o_proj = Dense(HD, D, True, *args)
        self.attn_layernorm = LayerNorm(D, cfg.layer_norm_eps, device, dtype)
        self.fc_in = Dense(D, I, True, *args)
        self.fc_out = Dense(I, D, True, *args)
        self.ffn_layernorm = LayerNorm(D, cfg.layer_norm_eps, device, dtype)

    def forward(self, h, attention_mask):
        cfg = self.config
        B, S, _ = h.shape
        H, Dh = cfg.num_attention_heads, cfg.head_dim
        q = self.q_proj(h).view(B, S, H, Dh)
        k = self.k_proj(h).view(B, S, H, Dh)
        v = self.v_proj(h).view(B, S, H, Dh)
        ctx = _attention(q, k, v, attention_mask, cfg.attention_impl,
                         sparse_section=cfg.sparse_attention,
                         max_seq=cfg.max_position_embeddings).reshape(B, S, H * Dh)
        h = self.attn_layernorm(h + self.o_proj(ctx))
        out = self.fc_out(F.gelu(self.fc_in(h)))
        return self.ffn_layernorm(h + out)


class BertModel(nn.Module):
    """Encoder trunk: embeddings (word + position + optional token type,
    then LN) and the post-LN blocks → the last hidden states."""

    def __init__(self, cfg, device, dtype, generator):
        super().__init__()
        self.config = cfg
        D = cfg.hidden_size
        self.embed_tokens = _param((cfg.vocab_size, D), device, dtype, generator, 0.02)
        self.embed_positions = _param((cfg.max_position_embeddings + cfg.position_offset, D),
                                      device, dtype, generator, 0.02)
        self.embed_token_types = (_param((cfg.type_vocab_size, D), device, dtype, generator,
                                         0.02) if cfg.type_vocab_size > 0 else None)
        self.embed_layernorm = LayerNorm(D, cfg.layer_norm_eps, device, dtype)
        self.layers = nn.ModuleList(BertBlock(cfg, device, dtype, generator)
                                    for _ in range(cfg.num_hidden_layers))

    def forward(self, input_ids, attention_mask=None, token_type_ids=None):
        cfg = self.config
        S = input_ids.shape[1]
        h = self.embed_tokens[input_ids.long()]
        h = h + self.embed_positions[torch.arange(S, device=h.device) + cfg.position_offset][None]
        if self.embed_token_types is not None:
            tt = torch.zeros_like(input_ids) if token_type_ids is None else token_type_ids
            h = h + self.embed_token_types[tt.long()]
        h = self.embed_layernorm(h)
        remat = cfg.remat and torch.is_grad_enabled()
        for block in self.layers:
            h = (checkpoint(block, h, attention_mask, use_reentrant=False) if remat
                 else block(h, attention_mask))
        return h


def check_bert(cfg: BertConfig):
    if cfg.attention_impl not in ("auto", "einsum", "flash"):
        raise ValueError(f"attention_impl {cfg.attention_impl!r}: auto | einsum | flash")


def _resolve(device, generator):
    """``device`` None = CUDA (raises without a GPU); ``generator`` seed 0
    on it when None."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return device, generator


class _BertHead(nn.Module):
    """What both heads share: the trunk, and the JAX model's surface that
    the port does not run yet."""

    def __init__(self, config, device, dtype, generator):
        super().__init__()
        check_bert(config)
        self.config = config
        self.model = BertModel(config, device, dtype, generator)

    @property
    def param_stream_prefix(self):
        raise not_ported("parameter streaming (param_stream_prefix)", 12)

    def tp_rule(self, path, shape):
        raise not_ported("tensor-parallel sharding rules (tp_rule)", 6)


class BertForMaskedLM(_BertHead):
    """MLM head: transform (dense + GELU + LN), then the decoder tied to
    ``embed_tokens`` plus ``mlm_bias``. ``labels`` uses the -100 ignore
    convention; → ``(loss, logits)`` with labels, logits otherwise."""

    def __init__(self, config, device=None, dtype=torch.float32, generator=None):
        device, generator = _resolve(device, generator)
        super().__init__(config, device, dtype, generator)
        D = config.hidden_size
        self.mlm_transform = Dense(D, D, True, device, dtype, generator)
        self.mlm_layernorm = LayerNorm(D, config.layer_norm_eps, device, dtype)
        self.mlm_bias = nn.Parameter(torch.zeros(config.vocab_size, device=device, dtype=dtype))

    def forward(self, input_ids, labels=None, attention_mask=None, token_type_ids=None):
        h = self.model(input_ids, attention_mask, token_type_ids)
        h = self.mlm_layernorm(F.gelu(self.mlm_transform(h)))
        logits = h @ self.model.embed_tokens.t() + self.mlm_bias
        if labels is None:
            return logits
        return masked_cross_entropy(logits, labels), logits


class BertForSequenceClassification(_BertHead):
    """[CLS] pooler (dense + tanh) and classifier; cross entropy with int
    labels → ``(loss, logits)``, logits without labels."""

    def __init__(self, config, num_labels=2, device=None, dtype=torch.float32, generator=None):
        device, generator = _resolve(device, generator)
        super().__init__(config, device, dtype, generator)
        self.num_labels = num_labels
        self.pooler = Dense(config.hidden_size, config.hidden_size, True, device, dtype,
                            generator)
        self.classifier = Dense(config.hidden_size, num_labels, True, device, dtype, generator)

    def forward(self, input_ids, labels=None, attention_mask=None, token_type_ids=None):
        h = self.model(input_ids, attention_mask, token_type_ids)
        logits = self.classifier(torch.tanh(self.pooler(h[:, 0])))
        if labels is None:
            return logits
        logp = torch.log_softmax(logits.float(), dim=-1)
        return -logp.gather(-1, labels.long()[:, None]).mean(), logits


def build_bert(preset_or_config="bert-debug", head="mlm", num_labels=2, device=None,
               dtype=torch.float32, generator=None, **overrides):
    """A BERT-family model for a preset (or config) with ``overrides``,
    random weights from ``generator`` (seed 0 when None) on ``device``
    (None = CUDA; raises without a GPU). ``head``: "mlm" or
    "classification"."""
    cfg = (preset_or_config if isinstance(preset_or_config, BertConfig)
           else BERT_CONFIGS[preset_or_config])
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    if head == "mlm":
        return BertForMaskedLM(cfg, device, dtype, generator)
    if head in ("classification", "sequence_classification"):
        return BertForSequenceClassification(cfg, num_labels, device, dtype, generator)
    raise ValueError(f"unknown head {head!r} (mlm | classification)")
