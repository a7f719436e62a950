"""JAX param tree ↔ the port's parameter layouts.

The one place that knows how the JAX package lays out Llama-family
weights. :func:`params_from_jax` builds the serving layout;
:func:`load_jax_params` fills the training module and
:func:`params_to_jax` turns the training module's tensors (its params, or
their grads) back into a JAX-shaped tree, so that tests can compare them
leaf by leaf. ``tree`` is the JAX engine's param tree as nested numpy
(``jax.tree.map(np.asarray, params)``):

    model.embed_tokens                                      [V, D]
    model.layers.{input_layernorm,post_attention_layernorm}.scale  [L, D]
    model.layers.self_attn.{q,k,v,o}_proj.kernel            [L, in, out]
    model.layers.self_attn.{q,k,v,o}_proj.bias              [L, out] (optional)
    model.layers.mlp.{gate,up,down}_proj.kernel             [L, in, out]
    model.layers.moe_mlp.deepspeed_moe.gate.wg.kernel       [L, D, E]     (MoE, in
    model.layers.moe_mlp.deepspeed_moe.experts_w{1,3}       [L, E, D, I]   place of
    model.layers.moe_mlp.deepspeed_moe.experts_w2           [L, E, I, D]   mlp)
    model.norm.scale                                        [D]
    lm_head.kernel                                          [D, V] (absent when tied)

Both packages keep projections [in, out]. The serving layout keeps the
layers stacked on a leading L dim (renaming only); the training module
owns one tensor per layer and leaf, named by the JAX path with the layer
index after ``layers`` (``model.layers.3.self_attn.q_proj.kernel``), so
the stacked leaves are unstacked one way and restacked the other.

A serving tree may hold the JAX package's grouped ``QuantizedWeight``
leaves (``quantize_params_tree``'s output): :func:`params_from_jax` turns
each into the port's carrier byte for byte (``float8_e4m3fn`` through a
uint8 view, which ``torch.from_numpy`` needs)."""

import numpy as np
import torch

from deepspeed_tpu_torch.roadmap import not_ported

_ATTN = {"q_proj": ("wq", "bq"), "k_proj": ("wk", "bk"), "v_proj": ("wv", "bv"),
         "o_proj": ("wo", "bo")}
_MLP = {"gate_proj": "w_gate", "up_proj": "w_up", "down_proj": "w_down"}


_EXPERTS = ("experts_w1", "experts_w3", "experts_w2")  # the same names in both layouts


def _t(x):
    if hasattr(x, "values") and hasattr(x, "scales") and hasattr(x, "scheme"):
        return carrier_from_jax(x)
    return torch.from_numpy(np.array(x, copy=True))


def carrier_from_jax(qw):
    """The JAX package's ``QuantizedWeight`` → the port's, same bytes."""
    from deepspeed_tpu_torch.inference.quantization.quantization import QuantizedWeight
    if qw.layout != "grouped":
        raise not_ported(f"the {qw.layout!r} quantized layout", 18)
    values = np.array(qw.values, copy=True)
    if values.dtype.name == "float8_e4m3fn":
        vt = torch.from_numpy(values.view(np.uint8)).view(torch.float8_e4m3fn)
    else:
        vt = torch.from_numpy(values)
    return QuantizedWeight(vt, torch.from_numpy(np.array(qw.scales, copy=True)),
                           tuple(qw.shape), qw.scheme,
                           dequant_dtype=getattr(torch, np.dtype(qw.dequant_dtype).name))


def params_from_jax(tree):
    """→ the port's params (CPU tensors, the tree's dtypes; quantized
    leaves as the port's carriers); the engine moves and casts them to
    its device and dtype."""
    model = tree["model"]
    lay = model["layers"]
    layers = {"input_norm": _t(lay["input_layernorm"]["scale"]),
              "post_norm": _t(lay["post_attention_layernorm"]["scale"])}
    for jname, (w, b) in _ATTN.items():
        p = lay["self_attn"][jname]
        layers[w] = _t(p["kernel"])
        if "bias" in p:
            layers[b] = _t(p["bias"])
    if "moe_mlp" in lay:
        moe = lay["moe_mlp"]["deepspeed_moe"]
        layers["gate_wg"] = _t(moe["gate"]["wg"]["kernel"])
        for name in _EXPERTS:
            layers[name] = _t(moe[name])
    else:
        for jname, w in _MLP.items():
            layers[w] = _t(lay["mlp"][jname]["kernel"])
    out = {"embed_tokens": _t(model["embed_tokens"]), "layers": layers,
           "norm": _t(model["norm"]["scale"])}
    if "lm_head" in tree:
        out["lm_head"] = _t(tree["lm_head"]["kernel"])
    return out


_LAYERS = ("model", "layers")


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _train_state_from_jax(tree):
    """JAX tree (nested numpy) → ``{training-module name: CPU tensor}``,
    the stacked ``model/layers`` leaves split per layer."""
    out = {}
    for path, value in _flatten(tree):
        if path[:2] == _LAYERS:
            if path[2] == "moe_mlp":
                raise not_ported("MoE training", 17)
            rest = ".".join(path[2:])
            for i in range(value.shape[0]):
                out[f"model.layers.{i}.{rest}"] = _t(value[i])
        else:
            out[".".join(path)] = _t(value)
    return out


@torch.no_grad()
def load_jax_params(module, tree):
    """Copy a JAX ``LlamaForCausalLM`` param tree into the training
    ``module`` in place (each tensor keeps the module's device and dtype).
    Every parameter must be matched by exactly one leaf."""
    state = _train_state_from_jax(tree)
    params = dict(module.named_parameters())
    if set(state) != set(params):
        raise ValueError(f"param tree does not match the module: missing "
                         f"{sorted(set(params) - set(state))[:5]}, unexpected "
                         f"{sorted(set(state) - set(params))[:5]}")
    for name, p in params.items():
        if tuple(state[name].shape) != tuple(p.shape):
            raise ValueError(f"{name}: tree shape {tuple(state[name].shape)} != "
                             f"{tuple(p.shape)}")
        p.copy_(state[name])
    return module


def params_to_jax(named):
    """``{training-module name: tensor}`` (``module.named_parameters()``, or
    the same names mapped to grads) → the JAX tree's nesting as fp32 numpy,
    with the per-layer tensors restacked on a leading L dim."""
    out, stacks = {}, {}
    for name, t in dict(named).items():
        arr = t.detach().float().cpu().numpy()
        parts = name.split(".")
        if tuple(parts[:2]) == _LAYERS:
            stacks.setdefault(tuple(parts[3:]), {})[int(parts[2])] = arr
            continue
        node = out
        for key in parts[:-1]:
            node = node.setdefault(key, {})
        node[parts[-1]] = arr
    for rest, per_layer in stacks.items():
        node = out.setdefault("model", {}).setdefault("layers", {})
        for key in rest[:-1]:
            node = node.setdefault(key, {})
        node[rest[-1]] = np.stack([per_layer[i] for i in range(len(per_layer))])
    return out
