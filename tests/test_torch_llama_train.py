"""The training model in the PyTorch port vs the JAX package, on the CPU.

``build_llama("debug")`` in both packages on the same weights (the JAX
init, carried over by ``load_jax_params``) and the same token batch made
with numpy: loss, logits and every gradient (``jax.value_and_grad`` vs
torch autograd, compared leaf by leaf through ``params_to_jax``) must
agree in fp32 within atol/rtol 2e-5 (fp32 sums in another order through
two layers). Cases: remat on and off, the chunked loss (a small
``loss_chunk``; the JAX model then returns no logits, nor does the
port), tied embeddings, GQA (the debug preset has 4 query and 2 KV heads),
and S = 256, where ``attention_impl="auto"`` takes the flash path in the
port (its plain version on the CPU) and the einsum path in the JAX model
on the CPU: the same math."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.models import build_llama as jax_build_llama
from deepspeed_tpu_torch.models import build_llama, load_jax_params, params_to_jax

torch.set_num_threads(1)  # the suite runs in parallel worker processes

TOL = dict(atol=2e-5, rtol=2e-5)

CASES = {
    # name: (overrides, B, S)
    "remat": (dict(remat=True), 2, 24),
    "no_remat": (dict(remat=False), 2, 24),
    "chunked_loss": (dict(loss_chunk=8), 2, 24),
    "tied_embeddings": (dict(tie_word_embeddings=True), 2, 24),
    "flash_s256": (dict(max_position_embeddings=512), 1, 256),
}


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def jax_model_and_params(overrides, seed=0):
    model = jax_build_llama("debug", **overrides)
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    return model, jax.tree.map(np.asarray, params)


def port_model(overrides, tree):
    return load_jax_params(build_llama("debug", device="cpu", **overrides), tree)


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_logits_and_grads_match_jax(case):
    overrides, B, S = CASES[case]
    jmodel, tree = jax_model_and_params(overrides)
    rng = np.random.RandomState(1)
    ids = rng.randint(0, 256, size=(B, S)).astype(np.int32)
    labels = ids.copy()
    labels[:, :3] = -100  # ignored positions

    def loss_fn(p):
        loss, logits = jmodel.apply({"params": p}, jnp.asarray(ids), jnp.asarray(labels))
        return loss, logits

    (loss_j, logits_j), grads_j = jax.value_and_grad(loss_fn, has_aux=True)(tree)

    model = port_model(overrides, tree)
    assert model.config.remat == jmodel.config.remat
    loss, logits = model(torch.from_numpy(ids), torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), **TOL)
    if logits_j is None:
        assert logits is None
    else:
        np.testing.assert_allclose(logits.detach().numpy(), np.asarray(logits_j), **TOL)
    grads = dict(_flat(params_to_jax({n: p.grad for n, p in model.named_parameters()})))
    want = dict(_flat(jax.tree.map(np.asarray, grads_j)))
    assert sorted(grads) == sorted(want)
    for path, g in want.items():
        np.testing.assert_allclose(grads[path], g, err_msg=path, **TOL)


def test_logits_without_labels_match_jax():
    jmodel, tree = jax_model_and_params({})
    ids = np.random.RandomState(2).randint(0, 256, size=(2, 16)).astype(np.int32)
    logits_j = jmodel.apply({"params": tree}, jnp.asarray(ids))
    with torch.no_grad():
        logits = port_model({}, tree)(torch.from_numpy(ids))
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j), **TOL)


def test_params_round_trip_through_the_jax_layout():
    _, tree = jax_model_and_params({"tie_word_embeddings": True})
    back = dict(_flat(params_to_jax(port_model({"tie_word_embeddings": True},
                                               tree).named_parameters())))
    want = dict(_flat(tree))
    assert sorted(back) == sorted(want)
    for path, x in want.items():
        np.testing.assert_array_equal(back[path], x, err_msg=path)
