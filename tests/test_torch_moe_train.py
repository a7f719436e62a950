"""MoE training in the PyTorch port vs the JAX package, on the CPU in fp32,
at ``mixtral-debug`` (D=64, I=128, 4 experts, top-2, 2 layers), from the
JAX init carried over by ``load_jax_params`` and token batches made with
numpy:

- loss, the summed aux loss and every parameter's gradient against
  ``jax.value_and_grad`` of the JAX model, dropless and capacity-routed,
  remat on ("full", "moe") and off, and on the chunked-loss path;
  atol/rtol 2e-5 (fp32 sums in another order through two layers);
- the JAX Pallas grouped-matmul branch (``FORCE_INTERPRET``, restored in
  ``finally``) once, its custom VJP's ``_gmm_dw_raw`` and transposed
  ``_gmm_raw`` in interpret mode against the port's plain kernels;
- remat ``"moe"`` gives the gradients of ``"full"`` and of no remat;
- 3 engine steps (gas 2, clipping, Adam with weight decay, WarmupLR)
  against the JAX engine on a 1-device mesh, as
  ``tests/test_torch_train_engine.py`` does for ``"debug"``: losses and
  grad norms within rtol 1e-5, final params within 1e-4;
- the frozen-base FFN: ``dropless_moe_ffn`` over int8 / fp8 / fp6 stacks,
  its input gradient against ``jax.grad`` through the same carriers (the
  JAX ``TestFrozenBaseGrad``), and no gradient for carriers or scales.

The noisy gate stays off: its noise is ``jax.random``'s there."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu.ops.grouped_gemm as jgg
import deepspeed_tpu_torch
from deepspeed_tpu.inference.quantization.quantization import (
    _quantize_grouped as jax_quantize_grouped)
from deepspeed_tpu.models import build_llama as jax_build_llama
from deepspeed_tpu.models.llama import LlamaModel as JaxLlamaModel
from deepspeed_tpu.parallel import groups
from deepspeed_tpu_torch.models import build_llama, load_jax_params, params_to_jax
from deepspeed_tpu_torch.models.convert import carrier_from_jax
from deepspeed_tpu_torch.ops import grouped_gemm as tgg

torch.set_num_threads(1)  # the suite runs in parallel worker processes

TOL = dict(atol=2e-5, rtol=2e-5)
CASES = {
    # name: (overrides, B, S)
    "dropless": (dict(moe_drop_tokens=False), 2, 24),
    "dropless_remat_moe": (dict(moe_drop_tokens=False, remat_policy="moe"), 2, 24),
    "dropless_no_remat": (dict(moe_drop_tokens=False, remat=False), 2, 24),
    "dropless_chunked_loss": (dict(moe_drop_tokens=False, loss_chunk=8), 2, 24),
    "capacity": (dict(moe_drop_tokens=True), 2, 24),
    "capacity_remat_moe": (dict(moe_drop_tokens=True, remat_policy="moe"), 2, 24),
}


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def jax_model_and_params(overrides, seed=0):
    model = jax_build_llama("mixtral-debug", **overrides)
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    return model, jax.tree.map(np.asarray, params)


def port_model(overrides, tree):
    return load_jax_params(build_llama("mixtral-debug", device="cpu", **overrides), tree)


def _batch(B, S, seed=1):
    ids = np.random.RandomState(seed).randint(0, 256, size=(B, S)).astype(np.int32)
    labels = ids.copy()
    labels[:, :3] = -100
    return ids, labels


def _jax_loss_and_grads(jmodel, tree, ids, labels):
    def loss_fn(p):
        return jmodel.apply({"params": p}, jnp.asarray(ids), jnp.asarray(labels))
    (loss, logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(tree)
    aux = JaxLlamaModel(jmodel.config).apply({"params": tree["model"]}, jnp.asarray(ids))[2]
    return float(loss), logits, float(aux), dict(_flat(jax.tree.map(np.asarray, grads)))


def _port_loss_and_grads(model, ids, labels):
    loss, logits = model(torch.from_numpy(ids), torch.from_numpy(labels))
    loss.backward()
    with torch.no_grad():
        aux = model.model(torch.from_numpy(ids))[1].item()
    grads = dict(_flat(params_to_jax({n: p.grad for n, p in model.named_parameters()})))
    return loss.item(), logits, aux, grads


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_aux_and_grads_match_jax(case):
    overrides, B, S = CASES[case]
    jmodel, tree = jax_model_and_params(overrides)
    ids, labels = _batch(B, S)
    loss_j, logits_j, aux_j, grads_j = _jax_loss_and_grads(jmodel, tree, ids, labels)
    model = port_model(overrides, tree)
    loss, logits, aux, grads = _port_loss_and_grads(model, ids, labels)
    assert aux > 0
    np.testing.assert_allclose(loss, loss_j, **TOL)
    np.testing.assert_allclose(aux, aux_j, **TOL)
    if logits_j is None:
        assert logits is None
    else:
        np.testing.assert_allclose(logits.detach().numpy(), np.asarray(logits_j), **TOL)
    assert sorted(grads) == sorted(grads_j)
    for path, g in grads_j.items():
        np.testing.assert_allclose(grads[path], g, err_msg=path, **TOL)


def test_grads_match_the_jax_pallas_branch_in_interpret_mode():
    overrides = dict(moe_drop_tokens=False, remat_policy="moe")
    jmodel, tree = jax_model_and_params(overrides, seed=1)
    ids, labels = _batch(2, 24, seed=2)
    jgg.GMM_STATS.reset()
    jgg.FORCE_INTERPRET = True
    try:
        loss_j, _, _, grads_j = _jax_loss_and_grads(jmodel, tree, ids, labels)
    finally:
        jgg.FORCE_INTERPRET = False
    assert jgg.GMM_STATS.snapshot().get("pallas")
    loss, _, _, grads = _port_loss_and_grads(port_model(overrides, tree), ids, labels)
    np.testing.assert_allclose(loss, loss_j, **TOL)
    for path, g in grads_j.items():
        np.testing.assert_allclose(grads[path], g, err_msg=path, **TOL)


def test_remat_moe_equals_full_and_no_remat():
    _, tree = jax_model_and_params(dict(moe_drop_tokens=False))
    ids, labels = _batch(2, 24, seed=3)
    runs = [_port_loss_and_grads(port_model(dict(moe_drop_tokens=False, **o), tree), ids,
                                 labels)
            for o in (dict(remat_policy="moe"), dict(remat_policy="full"), dict(remat=False))]
    for other in runs[1:]:
        np.testing.assert_allclose(other[0], runs[0][0], rtol=1e-6)
        for path, g in runs[0][3].items():
            np.testing.assert_allclose(other[3][path], g, rtol=1e-6, atol=1e-7, err_msg=path)


# ------------------------------------------------------- engine, 3 steps
B, S, GAS, STEPS = 2, 16, 2, 3


def _engine_config():
    return {"train_batch_size": B * GAS, "train_micro_batch_size_per_gpu": B,
            "gradient_accumulation_steps": GAS, "gradient_clipping": 0.5,
            "optimizer": {"type": "Adam", "params": {"lr": 1e-2, "weight_decay": 0.01,
                                                       "eps": 1e-5}},
            "scheduler": {"type": "WarmupLR",
                          "params": {"warmup_num_steps": 2, "warmup_max_lr": 1e-2}},
            "zero_optimization": {"stage": 0}, "steps_per_print": 1000}


def _engine_batches():
    rng = np.random.RandomState(0)
    return [(ids, ids.copy()) for ids in
            (rng.randint(0, 256, size=(B * GAS, S)).astype(np.int32) for _ in range(STEPS))]


@pytest.mark.parametrize("drop_tokens", [False, True], ids=["dropless", "capacity"])
def test_three_engine_steps_match_the_jax_engine(drop_tokens):
    overrides = dict(moe_drop_tokens=drop_tokens, remat_policy="moe")
    jmodel, tree = jax_model_and_params(overrides)
    mesh = groups.initialize_mesh({"data_parallel_size": 1}, devices=jax.devices()[:1])
    try:
        jengine, *_ = deepspeed_tpu.initialize(model=jmodel, config=_engine_config(),
                                               model_parameters=jax.tree.map(jnp.asarray, tree),
                                               mesh=mesh)
        want = [(float(jengine.train_batch(batch=b)), float(jengine.global_grad_norm))
                for b in _engine_batches()]
        final_j = dict(_flat(jax.tree.map(np.asarray, jengine.params)))
    finally:
        groups.destroy_mesh()
    engine, *_ = deepspeed_tpu_torch.initialize(model=port_model(overrides, tree),
                                                config=_engine_config(), device="cpu")
    got = [(engine.train_batch(batch=b).item(), engine.global_grad_norm)
           for b in _engine_batches()]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    final = dict(_flat(params_to_jax(engine.module.named_parameters())))
    assert sorted(final) == sorted(final_j)
    for path, x in final_j.items():
        np.testing.assert_allclose(final[path], x, atol=1e-4, rtol=1e-4, err_msg=path)


# ---------------------------------------------------- frozen quantized base
@pytest.mark.parametrize("scheme", ["int8", "fp8", "fp6"])
def test_frozen_base_dx_matches_jax(scheme):
    E, D, I, T, k = 4, 64, 128, 10, 2
    rng = np.random.RandomState(11)
    ws = [(rng.randn(*s) * 0.1).astype(np.float32) for s in ((E, D, I), (E, D, I), (E, I, D))]
    jw = [jax_quantize_grouped(jnp.asarray(w), scheme, 32, dequant_dtype=jnp.float32)
          for w in ws]
    tw = [carrier_from_jax(w) for w in jw]
    x = rng.randn(T, D).astype(np.float32)
    g = rng.randn(T, D).astype(np.float32)
    idx = np.stack([np.arange(T) % 3, 3 - np.arange(T) % 2], 1).astype(np.int32)  # expert 2 rare
    vals = rng.rand(T, k).astype(np.float32)
    vals /= vals.sum(-1, keepdims=True)

    def loss_j(xx):
        return (jgg.dropless_moe_ffn(xx, jnp.asarray(idx), jnp.asarray(vals), *jw,
                                     num_experts=E) * jnp.asarray(g)).sum()

    dx_j = jax.grad(loss_j)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    for q in tw:
        q.scales.requires_grad_()
    out = tgg.dropless_moe_ffn(xt, torch.from_numpy(idx), torch.from_numpy(vals), *tw,
                               num_experts=E)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_j), **TOL)
    for q in tw:  # the frozen base: carriers and scales get no gradient
        assert q.values.grad is None and q.scales.grad is None
