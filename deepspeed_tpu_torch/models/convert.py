"""JAX param tree → the port's parameter layout.

The one place that knows how the JAX package lays out Llama-family
weights. ``tree`` is the JAX engine's param tree as nested numpy
(``jax.tree.map(np.asarray, params)``):

    model.embed_tokens                                      [V, D]
    model.layers.{input_layernorm,post_attention_layernorm}.scale  [L, D]
    model.layers.self_attn.{q,k,v,o}_proj.kernel            [L, in, out]
    model.layers.self_attn.{q,k,v,o}_proj.bias              [L, out] (optional)
    model.layers.mlp.{gate,up,down}_proj.kernel             [L, in, out]
    model.norm.scale                                        [D]
    lm_head.kernel                                          [D, V] (absent when tied)

Both packages keep projections [in, out] with layers stacked on a
leading L dim, so the mapping is renaming only."""

import numpy as np
import torch

_ATTN = {"q_proj": ("wq", "bq"), "k_proj": ("wk", "bk"), "v_proj": ("wv", "bv"),
         "o_proj": ("wo", "bo")}
_MLP = {"gate_proj": "w_gate", "up_proj": "w_up", "down_proj": "w_down"}


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def params_from_jax(tree):
    """→ the port's params (CPU tensors, the tree's dtypes); the engine
    moves and casts them to its device and dtype."""
    model = tree["model"]
    lay = model["layers"]
    if "moe_mlp" in lay:
        raise NotImplementedError(
            "MoE param trees are not ported yet: ROADMAP.md, port queue item 3 "
            "(quantized, MoE and LoRA serving)")
    layers = {"input_norm": _t(lay["input_layernorm"]["scale"]),
              "post_norm": _t(lay["post_attention_layernorm"]["scale"])}
    for jname, (w, b) in _ATTN.items():
        p = lay["self_attn"][jname]
        layers[w] = _t(p["kernel"])
        if "bias" in p:
            layers[b] = _t(p["bias"])
    for jname, w in _MLP.items():
        layers[w] = _t(lay["mlp"][jname]["kernel"])
    out = {"embed_tokens": _t(model["embed_tokens"]), "layers": layers,
           "norm": _t(model["norm"]["scale"])}
    if "lm_head" in tree:
        out["lm_head"] = _t(tree["lm_head"]["kernel"])
    return out
