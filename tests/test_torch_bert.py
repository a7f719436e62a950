"""BERT in the PyTorch port vs the JAX package, on the CPU.

The same config in both packages, the JAX init carried onto the port's
modules by ``load_bert_params`` (``bert_params_from_jax``), the same
batches made with numpy: loss, logits and every gradient (``jax.grad`` vs
torch autograd, compared leaf by leaf through ``bert_params_to_jax``)
agree in fp32 within atol/rtol 5e-5. The port's LayerNorm takes the
two-pass variance of the TPU kernel, flax's ``nn.LayerNorm`` E[x²] −
E[x]² (ROADMAP.md queue 3); with unit-scale activations that and fp32
sums in another order stay near 1e-6. Cases: bert-debug, distilbert-debug
(no token-type table) and a RoBERTa-form config (``position_offset``),
MLM and classification heads, token types, remat, a padded attention mask,
and BigBird and Fixed block-sparse attention through
``replace_model_self_attention_with_sparse_self_attention`` (no mask: the
port's plain K8 against the JAX masked-dense path, which agree on layouts
without empty rows; with a mask: both masked-dense). Then 3
``initialize`` → ``train_batch`` steps of the sparse BigBird model match the
JAX engine's (losses and grad norms within rtol 1e-5, final params within
atol/rtol 1e-4, as ``test_torch_train_engine.py``)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import build_bert as jax_build_bert
from deepspeed_tpu.ops.sparse_attention import SparseAttentionUtils as JaxUtils
from deepspeed_tpu.parallel import groups
from deepspeed_tpu_torch.models import (bert_params_from_jax, bert_params_to_jax, build_bert,
                                        load_bert_params)
from deepspeed_tpu_torch.ops.sparse_attention import SparseAttentionUtils

TOL = dict(atol=5e-5, rtol=5e-5)
BIGBIRD = {"sparse_attention": {"mode": "bigbird", "block": 16, "num_random_blocks": 1,
                                "num_sliding_window_blocks": 3, "num_global_blocks": 1}}
FIXED = {"sparse_attention": {"mode": "fixed", "block": 16, "num_local_blocks": 2,
                              "num_global_blocks": 1}}

CASES = {  # name: (preset, head, overrides, sparse ds_config, S, padded, token types)
    "mlm": ("bert-debug", "mlm", {}, None, 16, False, False),
    "mlm_token_types": ("bert-debug", "mlm", {}, None, 16, False, True),
    "mlm_padded": ("bert-debug", "mlm", {}, None, 16, True, False),
    "mlm_remat": ("bert-debug", "mlm", dict(remat=True), None, 16, False, False),
    "distilbert": ("distilbert-debug", "mlm", {}, None, 16, False, False),
    "roberta_offset": ("bert-debug", "mlm", dict(position_offset=2, type_vocab_size=1), None,
                       16, True, False),
    "classification": ("bert-debug", "classification", {}, None, 16, False, True),
    "classification_padded": ("distilbert-debug", "classification", {}, None, 16, True, False),
    "bigbird": ("bert-debug", "mlm", {}, BIGBIRD, 128, False, False),
    "bigbird_padded": ("bert-debug", "mlm", {}, BIGBIRD, 128, True, False),
    "fixed": ("bert-debug", "mlm", {}, FIXED, 128, False, False),
    "fixed_classification": ("bert-debug", "classification", {}, FIXED, 128, False, False),
}


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v, np.float32)


def models(preset, head, overrides, sparse, S, num_labels=3):
    """(JAX module, its init as nested numpy, the port's model on the CPU
    with those weights). The JAX replacement rebuilds the head with its
    default ``num_labels`` (2), where the port's carries the model's: a
    sparse classification case uses 2 labels (ROADMAP.md queue 3)."""
    if sparse is not None:
        num_labels = 2
    jmodel = jax_build_bert(preset, head=head, num_labels=num_labels, **overrides)
    model = build_bert(preset, head=head, num_labels=num_labels, device="cpu", **overrides)
    if sparse is not None:
        jmodel = JaxUtils.replace_model_self_attention_with_sparse_self_attention(
            jmodel, max_position=S, ds_config=sparse)
        model = SparseAttentionUtils.replace_model_self_attention_with_sparse_self_attention(
            model, max_position=S, ds_config=sparse)
    ids = jnp.zeros((1, S), jnp.int32)
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0), ids)["params"])
    return jmodel, tree, load_bert_params(model, tree)


def batch(cfg, head, S, padded, token_types, B=2, seed=1):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    if head == "mlm":
        labels = np.where(rng.rand(B, S) < 0.5, ids, -100).astype(np.int32)
    else:
        labels = rng.randint(0, 2, size=B).astype(np.int32)
    kw = {}
    if padded:
        mask = np.ones((B, S), np.int32)
        mask[1, S - S // 4:] = 0
        kw["attention_mask"] = mask
    if token_types:
        kw["token_type_ids"] = (np.arange(S)[None] >= S // 2).repeat(B, 0).astype(np.int32)
    return ids, labels, kw


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_logits_and_grads_match_jax(case):
    preset, head, overrides, sparse, S, padded, token_types = CASES[case]
    jmodel, tree, model = models(preset, head, overrides, sparse, S)
    assert model.config.sparse_attention == jmodel.config.sparse_attention
    ids, labels, kw = batch(jmodel.config, head, S, padded, token_types)
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}

    def loss_fn(p):
        return jmodel.apply({"params": p}, jnp.asarray(ids), jnp.asarray(labels), **jkw)

    (loss_j, logits_j), grads_j = jax.value_and_grad(loss_fn, has_aux=True)(tree)
    loss, logits = model(torch.from_numpy(ids), torch.from_numpy(labels),
                         **{k: torch.from_numpy(v) for k, v in kw.items()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), **TOL)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(logits_j), **TOL)
    grads = dict(_flat(bert_params_to_jax({n: p.grad for n, p in model.named_parameters()})))
    want = dict(_flat(jax.tree.map(np.asarray, grads_j)))
    assert sorted(grads) == sorted(want)
    for path, g in want.items():
        np.testing.assert_allclose(grads[path], g, err_msg=path, **TOL)


def test_logits_without_labels_match_jax():
    jmodel, tree, model = models("bert-debug", "mlm", {}, BIGBIRD, 64)
    ids, _, _ = batch(jmodel.config, "mlm", 64, False, False, seed=4)
    want = jmodel.apply({"params": tree}, jnp.asarray(ids))
    with torch.no_grad():
        got = model(torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_params_round_trip_through_the_jax_layout():
    _, tree, model = models("bert-debug", "classification", {}, None, 16)
    back = dict(_flat(bert_params_to_jax(model.named_parameters())))
    want = dict(_flat(tree))
    assert sorted(back) == sorted(want)
    for path, x in want.items():
        np.testing.assert_array_equal(back[path], x, err_msg=path)
    state = bert_params_from_jax(tree)
    assert state["model.layers.1.q_proj.kernel"].shape == (64, 64)
    assert torch.equal(state["model.layers.1.attn_layernorm.bias"],
                       torch.from_numpy(np.array(tree["model"]["layers"]["attn_layernorm"]["bias"][1])))


def test_replacement_carries_weights_and_extends_positions():
    model = build_bert("bert-debug", device="cpu")
    sparse = SparseAttentionUtils.replace_model_self_attention_with_sparse_self_attention(
        model, max_position=160, ds_config=BIGBIRD)
    assert type(sparse) is type(model) and sparse.config.max_position_embeddings == 160
    old, new = dict(model.named_parameters()), dict(sparse.named_parameters())
    assert sorted(old) == sorted(new)
    table = new["model.embed_positions"]
    assert table.shape == (160, 64)
    assert torch.equal(table[:64], old["model.embed_positions"])
    assert torch.equal(table[64:128], old["model.embed_positions"])
    for name, p in old.items():
        if name != "model.embed_positions":
            assert torch.equal(new[name], p), name
    with pytest.raises(ValueError, match="must exceed"):
        SparseAttentionUtils.replace_model_self_attention_with_sparse_self_attention(
            model, max_position=32, ds_config=BIGBIRD)


def test_replacement_guards_match_jax():
    from deepspeed_tpu.models import build_llama as jax_build_llama
    from deepspeed_tpu_torch.models import build_llama
    from deepspeed_tpu_torch.ops.sparse_attention import FixedSparsityConfig
    with pytest.raises(NotImplementedError, match="BERT family"):
        SparseAttentionUtils.replace_model_self_attention_with_sparse_self_attention(
            build_llama("debug", device="cpu"), ds_config=FIXED)
    with pytest.raises(NotImplementedError, match="BERT family"):
        JaxUtils.replace_model_self_attention_with_sparse_self_attention(
            jax_build_llama("debug"), ds_config=FIXED)
    model = build_bert("bert-debug", device="cpu")
    for fn, m in ((SparseAttentionUtils, model), (JaxUtils, jax_build_bert("bert-debug"))):
        with pytest.raises(ValueError, match="no sparse_attention"):
            fn.replace_model_self_attention_with_sparse_self_attention(m, ds_config={"seed": 1})
    sparse = SparseAttentionUtils.replace_model_self_attention_with_sparse_self_attention(
        model, sparsity_config=FixedSparsityConfig(num_heads=4, block=16, num_local_blocks=2))
    section = dict(sparse.config.sparse_attention)
    assert section["mode"] == "fixed" and section["num_local_blocks"] == 2


def test_one_layout_serves_every_layer_and_step():
    """BigBird draws new random blocks on each ``make_layout``; the model
    asks a fresh config once per (section, heads, S), as the JAX model's one
    traced block does, so two forwards (and the layers within each) agree."""
    from deepspeed_tpu_torch.models import bert
    model = SparseAttentionUtils.replace_model_self_attention_with_sparse_self_attention(
        build_bert("bert-debug", device="cpu"), max_position=128, ds_config=BIGBIRD)
    ids = torch.from_numpy(batch(model.config, "mlm", 128, False, False)[0])
    with torch.no_grad():
        a, b = model(ids), model(ids)
    assert torch.equal(a, b)
    ssa = bert._sparse_self_attention(model.config.sparse_attention, 4, 128, 128)
    from deepspeed_tpu.ops.sparse_attention import BigBirdSparsityConfig
    want = BigBirdSparsityConfig(num_heads=4, **{k: v for k, v in BIGBIRD[
        "sparse_attention"].items() if k != "mode"}).make_layout(128)
    np.testing.assert_array_equal(ssa._layout(128), want)


# ------------------------------------------------------------ engine steps
B, S, GAS, STEPS = 2, 64, 2, 3


def config():
    return {"train_batch_size": B * GAS, "train_micro_batch_size_per_gpu": B,
            "gradient_accumulation_steps": GAS, "gradient_clipping": 0.5,
            "optimizer": {"type": "Adam", "params": {"lr": 1e-2, "weight_decay": 0.01,
                                                       "eps": 1e-5}},
            "zero_optimization": {"stage": 2}, "steps_per_print": 1000}


def engine_batches():
    rng = np.random.RandomState(0)
    out = []
    for _ in range(STEPS):
        ids = rng.randint(0, 256, size=(B * GAS, S)).astype(np.int32)
        out.append((ids, np.where(rng.rand(B * GAS, S) < 0.5, ids, -100).astype(np.int32)))
    return out


def test_three_engine_steps_match_the_jax_engine():
    jmodel, tree, model = models("bert-debug", "mlm", {}, BIGBIRD, S)
    mesh = groups.initialize_mesh({"data_parallel_size": 1}, devices=jax.devices()[:1])
    try:
        jengine, *_ = deepspeed_tpu.initialize(model=jmodel, config=config(),
                                               model_parameters=jax.tree.map(jnp.asarray, tree),
                                               mesh=mesh)
        losses_j, norms_j = [], []
        for ids, labels in engine_batches():
            losses_j.append(float(jengine.train_batch(batch=(ids, labels))))
            norms_j.append(float(jengine.global_grad_norm))
        final_j = dict(_flat(jax.tree.map(np.asarray, jengine.params)))
    finally:
        groups.destroy_mesh()
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=config(), device="cpu")
    losses, norms = [], []
    for ids, labels in engine_batches():
        losses.append(engine.train_batch(batch=(ids, labels)).item())
        norms.append(engine.global_grad_norm)
    np.testing.assert_allclose(losses, losses_j, rtol=1e-5)
    np.testing.assert_allclose(norms, norms_j, rtol=1e-5)
    final = dict(_flat(bert_params_to_jax(engine.module.named_parameters())))
    assert sorted(final) == sorted(final_j)
    for path, x in final_j.items():
        np.testing.assert_allclose(final[path], x, atol=1e-4, rtol=1e-4, err_msg=path)


def test_surface_not_ported_raises():
    model = build_bert("bert-debug", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md, port queue item 6 "):
        model.tp_rule("model/layers/q_proj/kernel", (2, 64, 64))
    with pytest.raises(NotImplementedError, match="ROADMAP.md, port queue item 12 "):
        model.param_stream_prefix
