"""MoE gating and the capacity-routed MoE layer in the PyTorch port vs the
JAX package, fp32 on the CPU, inputs made with numpy.

- ``topkgating`` for k = 1 and 2 over capacity factors 0.5 to 2: combine
  weights within 1e-6 (fp32 softmax and one renormalizing division in
  another library), the dispatch mask and the capacity equal, the aux
  loss within 1e-6 relative; ``min_capacity`` taking over at few tokens;
  renormalization over the survivors after truncation;
- ``TopKGate`` in dropless form (weights, experts and aux) from the JAX
  gate's router weight;
- the jitter's bounds, and noise only in training and only with a
  generator (the port's counterpart of the JAX ``TestGateJitter``; the
  noise itself is ``jax.random``'s there and a ``torch.Generator``'s here,
  so the parity cases keep the noisy gate off);
- the capacity ``MOELayer`` forward and its gradients (x, router, the
  three expert stacks) against ``jax.grad``, atol/rtol 2e-5 (fp32 sums in
  another order)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.moe import sharded_moe as jmoe
from deepspeed_tpu_torch.moe import sharded_moe as tmoe

torch.set_num_threads(1)  # the suite runs in parallel worker processes

TOL = dict(atol=2e-5, rtol=2e-5)


def _logits(T, E, seed):
    return np.random.RandomState(seed).randn(T, E).astype(np.float32) * 2


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("cf", [0.5, 1.0, 1.25, 2.0])
def test_topkgating_matches_jax(k, cf):
    logits = _logits(40, 8, 10 * k + int(cf * 4))
    aux_j, comb_j, disp_j = jmoe.topkgating(jnp.asarray(logits), k, cf)
    aux, comb, disp = tmoe.topkgating(torch.from_numpy(logits), k, cf)
    assert comb.shape == comb_j.shape and comb.dtype == torch.float32
    np.testing.assert_allclose(comb.numpy(), np.asarray(comb_j), atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(disp.numpy(), np.asarray(disp_j))
    np.testing.assert_allclose(aux.item(), float(aux_j), rtol=1e-6)
    # every token's surviving weights sum to 1 (k = 2), or its one weight stays
    kept = comb.sum(dim=(1, 2))
    assert ((kept == 0) | ((kept - 1).abs() < 1e-6) | torch.tensor(k == 1)).all()


@pytest.mark.parametrize("T,E,k,cf", [(3, 8, 1, 1.0), (6, 4, 2, 0.25), (16, 4, 2, 1.0)])
def test_min_capacity(T, E, k, cf):
    want = max(int(np.ceil(T * k * cf / E)), 4)
    assert tmoe._capacity(T, E, k, cf) == jmoe._capacity(T, E, k, cf) == want
    logits = _logits(T, E, T)
    _, comb_j, _ = jmoe.topkgating(jnp.asarray(logits), k, cf, min_capacity=4)
    _, comb, _ = tmoe.topkgating(torch.from_numpy(logits), k, cf, min_capacity=4)
    assert comb.shape[-1] == comb_j.shape[-1] == want
    np.testing.assert_allclose(comb.numpy(), np.asarray(comb_j), atol=1e-6, rtol=1e-6)


def test_renormalization_after_truncation():
    """Every token prefers expert 0 first and one of experts 1-3 second: at
    capacity 6 the later tokens lose expert 0, and their second choice
    then carries the whole weight."""
    logits = np.tile(np.array([[4.0, 0.0, 0.0, 0.0]], np.float32), (12, 1))
    logits[np.arange(12), 1 + np.arange(12) % 3] = 2.0
    logits += np.random.RandomState(0).rand(12, 4).astype(np.float32) * 0.1
    aux_j, comb_j, _ = jmoe.topkgating(jnp.asarray(logits), 2, 1.0, min_capacity=4)
    aux, comb, disp = tmoe.topkgating(torch.from_numpy(logits), 2, 1.0, min_capacity=4)
    np.testing.assert_allclose(comb.numpy(), np.asarray(comb_j), atol=1e-6, rtol=1e-6)
    C = comb.shape[-1]
    assert C == 6 and disp[:, 0].sum() == C  # expert 0 full
    dropped = disp[:, 0].sum(-1) == 0
    assert dropped.any()
    # survivors of a dropped first choice: one expert left, weight 1
    np.testing.assert_allclose(comb[dropped].sum(dim=(1, 2)).numpy(), 1.0, rtol=1e-6)
    np.testing.assert_allclose(aux.item(), float(aux_j), rtol=1e-6)


def _jax_gate(D, E, k, drop_tokens, seed=0, **kw):
    gate = jmoe.TopKGate(num_experts=E, k=k, drop_tokens=drop_tokens, **kw)
    x = np.random.RandomState(seed).randn(2, 5, D).astype(np.float32)
    params = gate.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"]
    return gate, params, x


@pytest.mark.parametrize("k", [1, 2])
def test_dropless_gate_matches_jax(k):
    D, E = 16, 4
    jgate, params, x = _jax_gate(D, E, k, False)
    aux_j, vals_j, idx_j = jgate.apply({"params": params}, jnp.asarray(x))
    gate = tmoe.TopKGate(D, E, k, drop_tokens=False, device="cpu")
    with torch.no_grad():
        gate.wg.kernel.copy_(torch.from_numpy(np.array(params["wg"]["kernel"])))
    aux, vals, idx = gate(torch.from_numpy(x))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(vals.detach().numpy(), np.asarray(vals_j), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(aux.item(), float(aux_j), rtol=1e-6)


def test_multiplicative_jitter_bounds():
    x = torch.ones(64, 8)
    y = tmoe.multiplicative_jitter(x, torch.Generator().manual_seed(0), epsilon=1e-2)
    assert y.min().item() >= 0.99 and y.max().item() <= 1.01
    assert not torch.allclose(y, x)
    assert tmoe.multiplicative_jitter(x, None, epsilon=0.0) is x


@pytest.mark.parametrize("policy", ["Jitter", "RSample"])
@pytest.mark.parametrize("drop_tokens", [True, False])
def test_noise_only_in_training_and_with_a_generator(policy, drop_tokens):
    layer = tmoe.MOELayer(4, 16, 32, k=2, noisy_gate_policy=policy, drop_tokens=drop_tokens,
                          device="cpu", generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.RandomState(1).randn(2, 5, 16).astype(np.float32))
    with torch.no_grad():
        quiet = layer(x)[0]
        layer.eval()
        layer.gate.generator = torch.Generator().manual_seed(1)
        assert torch.equal(layer(x)[0], quiet)        # eval: no noise
        layer.train()
        layer.gate.generator = None
        assert torch.equal(layer(x)[0], quiet)        # training without a generator
        outs = []
        for seed in (1, 2):
            layer.gate.generator = torch.Generator().manual_seed(seed)
            outs.append(layer(x)[0])
    assert not torch.allclose(outs[0], outs[1])


def test_eval_capacity_factor_follows_module_training():
    gate = tmoe.TopKGate(16, 4, 2, capacity_factor=2.0, eval_capacity_factor=0.5, device="cpu")
    x = torch.randn(24, 16, generator=torch.Generator().manual_seed(0))
    assert gate(x)[1].shape[-1] == tmoe._capacity(24, 4, 2, 2.0)
    gate.eval()
    assert gate(x)[1].shape[-1] == tmoe._capacity(24, 4, 2, 0.5)


def _port_layer(params, D, E, I, k, **kw):
    layer = tmoe.MOELayer(E, D, I, k=k, device="cpu", **kw)
    with torch.no_grad():
        layer.gate.wg.kernel.copy_(torch.from_numpy(np.array(params["gate"]["wg"]["kernel"])))
        for n in ("experts_w1", "experts_w3", "experts_w2"):
            getattr(layer, n).copy_(torch.from_numpy(np.array(params[n])))
    return layer


@pytest.mark.parametrize("k,cf", [(1, 1.0), (2, 1.25), (2, 0.5)])
def test_capacity_moe_layer_forward_and_grads_match_jax(k, cf):
    D, E, I = 16, 4, 32
    jlayer = jmoe.MOELayer(num_experts=E, hidden_size=D, intermediate_size=I, k=k,
                           capacity_factor=cf)
    rng = np.random.RandomState(k)
    x = rng.randn(2, 6, D).astype(np.float32)
    g = rng.randn(2, 6, D).astype(np.float32)
    params = jlayer.init(jax.random.PRNGKey(k), jnp.asarray(x))["params"]

    def loss_j(p, xx):
        out, aux = jlayer.apply({"params": p}, xx)
        return (out * g).sum() + aux, (out, aux)

    (_, (out_j, aux_j)), (gp_j, gx_j) = jax.value_and_grad(loss_j, argnums=(0, 1),
                                                          has_aux=True)(params, jnp.asarray(x))
    layer = _port_layer(params, D, E, I, k, capacity_factor=cf)
    xt = torch.from_numpy(x).requires_grad_()
    out, aux = layer(xt)
    ((out * torch.from_numpy(g)).sum() + aux).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), **TOL)
    np.testing.assert_allclose(aux.item(), float(aux_j), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j), **TOL)
    np.testing.assert_allclose(layer.gate.wg.kernel.grad.numpy(),
                               np.asarray(gp_j["gate"]["wg"]["kernel"]), **TOL)
    for n in ("experts_w1", "experts_w3", "experts_w2"):
        np.testing.assert_allclose(getattr(layer, n).grad.numpy(), np.asarray(gp_j[n]),
                                   err_msg=n, **TOL)
