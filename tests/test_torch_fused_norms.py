"""Fused RMSNorm in the PyTorch port vs the JAX package, on the CPU.

The same inputs, made with numpy from a seed, go through the JAX
``fused_rms_norm`` with its Pallas kernel in interpret mode and through
the port's ``fused_rms_norm`` (CPU path: the plain version the CUDA kernel
is held against on the card, and the closed-form backward that runs on
both devices). Output, dx and dscale are compared with ``jax.grad`` in
fp32, atol/rtol 1e-5."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.ops.pallas.fused_norms import fused_rms_norm as jax_rms
from deepspeed_tpu_torch.ops.kernels.fused_norms import fused_rms_norm, rms_norm_fwd

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shape,eps", [((2, 5, 64), 1e-5), ((300, 128), 1e-6), ((7, 40), 1e-5)])
def test_forward_and_grads_match_jax_kernel(shape, eps):
    rng = np.random.RandomState(len(shape))
    x = (rng.randn(*shape) * 2).astype(np.float32)
    scale = (1 + 0.1 * rng.randn(shape[-1])).astype(np.float32)
    w = rng.randn(*shape).astype(np.float32)

    def loss(x, s):
        y = jax_rms(x, s, eps, True)
        return jnp.sum(y * w), y

    (_, y_j), (dx_j, ds_j) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jnp.asarray(scale))
    tx, ts = torch.tensor(x, requires_grad=True), torch.tensor(scale, requires_grad=True)
    y = fused_rms_norm(tx, ts, eps)
    (y * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(dx_j), **TOL)
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(ds_j), **TOL)


def test_kernel_launcher_takes_cuda_tensors_only():
    with pytest.raises(ValueError, match="CUDA tensors"):
        rms_norm_fwd(torch.zeros(2, 8), torch.ones(8))
