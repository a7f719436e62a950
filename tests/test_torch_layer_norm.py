"""Fused LayerNorm in the PyTorch port vs the JAX package, on the CPU.

The same inputs, made with numpy from a seed, go through the JAX
``fused_layer_norm`` with its Pallas kernel in interpret mode and through
the port's ``fused_layer_norm`` (CPU path: the plain version the CUDA
kernel is held against on the card, and the closed-form backward that runs
on both devices). Output, dx, dscale and dbias are compared with
``jax.grad`` in fp32, atol/rtol 1e-5 (fp32 sums in another order)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.ops.pallas.fused_norms import fused_layer_norm as jax_ln
from deepspeed_tpu_torch.ops.kernels.fused_norms import (fused_layer_norm, layer_norm_fwd,
                                                         layer_norm_ref)

torch.set_num_threads(1)  # the suite runs in parallel worker processes

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shape,eps", [((2, 5, 64), 1e-12), ((300, 128), 1e-5), ((7, 40), 1e-6),
                                       ((3, 1024), 1e-12)])
def test_forward_and_grads_match_jax_kernel(shape, eps):
    rng = np.random.RandomState(len(shape) + shape[-1])
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
    scale = (1 + 0.1 * rng.randn(shape[-1])).astype(np.float32)
    bias = (0.1 * rng.randn(shape[-1])).astype(np.float32)
    w = rng.randn(*shape).astype(np.float32)

    def loss(x, s, b):
        y = jax_ln(x, s, b, eps, True)
        return jnp.sum(y * w), y

    (_, y_j), grads_j = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    tx, ts, tb = (torch.tensor(a, requires_grad=True) for a in (x, scale, bias))
    y = fused_layer_norm(tx, ts, tb, eps)
    (y * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), **TOL)
    for got, want in zip((tx.grad, ts.grad, tb.grad), grads_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_plain_version_is_two_pass():
    """A row with a large mean and a small spread: the two-pass variance
    keeps its spread, where E[x²] − E[x]² in fp32 would cancel to noise."""
    x = torch.tensor([[1000.0 + 0.01 * i for i in range(64)]])
    y = layer_norm_ref(x, torch.ones(64), torch.zeros(64), 1e-12)
    want = (x.double() - x.double().mean()) / x.double().std(unbiased=False)
    np.testing.assert_allclose(y.numpy(), want.numpy(), atol=2e-3)


def test_kernel_launcher_takes_cuda_tensors_only():
    with pytest.raises(ValueError, match="CUDA tensors"):
        layer_norm_fwd(torch.zeros(2, 8), torch.ones(8), torch.zeros(8))
