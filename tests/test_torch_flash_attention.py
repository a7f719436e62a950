"""Flash attention in the PyTorch port vs the JAX package, on the CPU.

The same inputs, made with numpy from a seed, go through the JAX
``flash_attention`` with its Pallas kernels in interpret mode (blocks of
32, as ``tests/unit/ops/test_pallas_kernels.py`` runs them) and through
the port's ``flash_attention``, whose CPU path is the plain version the
CUDA kernels are held against on the card. Forward outputs and the
gradients of a scalar of the output (``jax.grad`` vs torch autograd) are
compared in fp32, atol/rtol 1e-5 (fp32 sums taken in another order). The
plain version of each kernel (``flash_fwd_ref`` with its lse,
``flash_bwd_dkv_ref``, ``flash_bwd_dq_ref``) is also held against the JAX
package's ``_fwd_impl`` and ``_bwd_impl`` (the three Pallas kernels) on
the same residuals. GQA: the kernels take equal head counts; the model
expands K/V with ``repeat_kv`` first, as the JAX model does, and
``test_torch_llama_train.py`` covers that path."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.ops.pallas.flash_attention import _bwd_impl, _fwd_impl
from deepspeed_tpu.ops.pallas.flash_attention import flash_attention as jax_flash
from deepspeed_tpu_torch.ops.kernels import flash_attention as fa

torch.set_num_threads(1)  # the suite runs in parallel worker processes

TOL = dict(atol=1e-5, rtol=1e-5)
BLOCK = 32

CASES = {
    # name: (B, S, H, D, causal, n_segments)
    "causal": (2, 64, 2, 16, True, 0),
    "noncausal": (2, 64, 2, 16, False, 0),
    "ragged_s": (1, 50, 3, 16, True, 0),
    "segments_causal": (2, 64, 2, 16, True, 3),
    "segments_noncausal": (1, 70, 2, 8, False, 4),
}


def make_case(B, S, H, D, n_seg, seed=0):
    rng = np.random.RandomState(seed)
    q, k, v, w = (rng.randn(B, S, H, D).astype(np.float32) for _ in range(4))
    seg = None
    if n_seg:
        cuts = np.sort(rng.choice(np.arange(1, S), n_seg - 1, replace=False))
        seg = np.tile(np.searchsorted(cuts, np.arange(S), side="right").astype(np.int32), (B, 1))
    return q, k, v, w, seg


def _jax_loss(causal, seg, w):
    def loss(q, k, v):
        o = jax_flash(q, k, v, causal=causal, block_q=BLOCK, block_k=BLOCK,
                      segment_ids=None if seg is None else jnp.asarray(seg),
                      interpret=True, force_pallas=True)
        return jnp.sum(o * w), o
    return loss


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_and_grads_match_jax_kernels(case):
    B, S, H, D, causal, n_seg = CASES[case]
    q, k, v, w, seg = make_case(B, S, H, D, n_seg)
    (_, o_jax), g_jax = jax.value_and_grad(_jax_loss(causal, seg, jnp.asarray(w)),
                                           argnums=(0, 1, 2), has_aux=True)(q, k, v)
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out = fa.flash_attention(*leaves, causal=causal,
                             segment_ids=None if seg is None else torch.from_numpy(seg))
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(o_jax), **TOL)
    for t, g in zip(leaves, g_jax):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **TOL)


def _bh(x):
    """[B, S, H, D] numpy → the JAX kernels' [B*H, S, D]."""
    B, S, H, D = x.shape
    return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(B * H, S, D))


@pytest.mark.parametrize("case", ["ragged_s", "segments_causal", "segments_noncausal"])
def test_plain_kernel_versions_match_pallas_kernels(case):
    B, S, H, D, causal, n_seg = CASES[case]
    q, k, v, do, seg = make_case(B, S, H, D, n_seg, seed=1)
    scale = 1.0 / np.sqrt(D)
    seg_bh = jnp.repeat(jnp.asarray(seg if seg is not None else np.zeros((B, S), np.int32)),
                        H, axis=0)
    o_j, lse_j = _fwd_impl(_bh(q), _bh(k), _bh(v), seg_bh, causal, scale, BLOCK, BLOCK, True)
    dq_j, dk_j, dv_j = _bwd_impl(_bh(q), _bh(k), _bh(v), seg_bh, o_j, lse_j, _bh(do), causal,
                                 scale, BLOCK, BLOCK, True)

    t = [torch.from_numpy(x) for x in (q, k, v, do)]
    tseg = None if seg is None else torch.from_numpy(seg)
    o, lse = fa.flash_fwd_ref(t[0], t[1], t[2], tseg, causal)
    delta = fa.flash_delta(o, t[3])
    dk, dv = fa.flash_bwd_dkv_ref(*t, lse, delta, tseg, causal)
    dq = fa.flash_bwd_dq_ref(*t, lse, delta, tseg, causal)

    def back(x):  # [B*H, S, D] → [B, S, H, D]
        return np.asarray(x).reshape(B, H, S, -1).transpose(0, 2, 1, 3)

    np.testing.assert_allclose(o.numpy(), back(o_j), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j)[:, :S].reshape(B, H, S), **TOL)
    for mine, theirs in ((dq, dq_j), (dk, dk_j), (dv, dv_j)):
        np.testing.assert_allclose(mine.numpy(), back(theirs), **TOL)


def test_bias_takes_the_plain_version_on_both_sides():
    B, S, H, D = 1, 40, 2, 16
    q, k, v, w, _ = make_case(B, S, H, D, 0, seed=2)
    bias = np.random.RandomState(3).randn(B, 1, S, S).astype(np.float32)
    o_j = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                    bias=jnp.asarray(bias))
    o = fa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), causal=True,
                           bias=torch.from_numpy(bias))
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), **TOL)


def test_kernel_launchers_take_cuda_tensors_only():
    q = torch.zeros(1, 8, 1, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_fwd(q, q, q)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_bwd_dq(q, q, q, q, None, None)
