"""``ragged_forward`` in the PyTorch port vs the JAX package.

Both run one mixed ragged batch — a decode token, a fresh prefill and a
prefill chunk continuing earlier context — over the same weights (the
JAX tree, converted by ``params_from_jax``) and the same pre-filled KV
pools, in fp32 on the CPU. Last-token logits and the updated pools must
agree within rtol/atol 1e-4 (fp32 matmuls summed in another order)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.inference.v2 import ragged as jr
from deepspeed_tpu.inference.v2.model_runner import ragged_forward as jax_forward
from deepspeed_tpu.models import build_llama
from deepspeed_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from deepspeed_tpu_torch.inference.v2 import ragged as tr
from deepspeed_tpu_torch.inference.v2.model_runner import ragged_forward
from deepspeed_tpu_torch.inference.v2.ragged.ragged_wrapper import unpack_batch
from deepspeed_tpu_torch.models import LlamaConfig, params_from_jax

TOL = dict(rtol=1e-4, atol=1e-4)
BS, NB, MS, MT, MB = 8, 16, 4, 32, 4

CONFIGS = {
    "debug": "debug",
    # 2 layers, GQA group 2, head_dim 128 (the kernel's width)
    "gqa_d128": JaxLlamaConfig(vocab_size=128, hidden_size=512, intermediate_size=256,
                               num_hidden_layers=2, num_attention_heads=4,
                               num_key_value_heads=2, max_position_embeddings=128),
}


def jax_params(preset, seed=0):
    model = build_llama(CONFIGS[preset], remat=False)
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    return model.config, jax.tree.map(np.asarray, params)


def port_config(jcfg):
    return LlamaConfig(**dataclasses.asdict(jcfg))


def mixed_batch(mod):
    """seq 0 decodes at position 9 (blocks 3, 5), seq 1 prefills 6 fresh
    tokens (block 7), seq 2 continues 5 seen tokens with a 4-token chunk
    (blocks 2, 9)."""
    w = mod.RaggedBatchWrapper(MT, MS, MB)
    for slot, (seen, blocks, toks) in enumerate([(9, [3, 5], [17]),
                                                 (0, [7], [1, 2, 3, 4, 5, 6]),
                                                 (5, [2, 9], [40, 41, 42, 43])]):
        d = mod.DSSequenceDescriptor(uid=slot, block_size=BS, slot=slot)
        d.seen_tokens = seen
        d.extend_blocks(blocks)
        w.insert_sequence(d, toks)
    return w


@pytest.mark.parametrize("preset", sorted(CONFIGS))
def test_ragged_forward_matches_jax(preset):
    jcfg, params = jax_params(preset)
    L, Hkv, Dh = jcfg.num_hidden_layers, jcfg.num_key_value_heads, jcfg.head_dim
    rng = np.random.RandomState(0)
    kc0 = rng.randn(L, NB, BS, Hkv, Dh).astype(np.float32)
    vc0 = rng.randn(L, NB, BS, Hkv, Dh).astype(np.float32)

    jb = {k: jnp.asarray(v) for k, v in mixed_batch(jr).finalize().items()}
    want, jk, jv = jax_forward(params, jnp.asarray(kc0), jnp.asarray(vc0), jb, jcfg,
                               dtype=jnp.float32)

    packed = torch.from_numpy(mixed_batch(tr).finalize_packed())
    tb = unpack_batch(packed, MS, MB)
    kc, vc = torch.from_numpy(kc0.copy()), torch.from_numpy(vc0.copy())
    got, tk, tv = ragged_forward(params_from_jax(params), kc, vc, tb, port_config(jcfg),
                                 dtype=torch.float32)
    assert tk is kc and tv is vc  # updated in place
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(kc.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(vc.numpy(), np.asarray(jv), **TOL)
    # KV lands only where the batch's positions fall (block 3 holds seq
    # 0's first 8 tokens, untouched) and pad tokens' null block 0
    touched = np.nonzero((kc.numpy() != kc0).any(axis=(0, 2, 3, 4)))[0]
    assert set(touched.tolist()) == {0, 2, 5, 7, 9}


def test_params_from_jax_layout():
    jcfg, params = jax_params("debug")
    p = params_from_jax(params)
    assert tuple(p["layers"]["wq"].shape) == params["model"]["layers"]["self_attn"][
        "q_proj"]["kernel"].shape
    np.testing.assert_array_equal(p["lm_head"].numpy(), params["lm_head"]["kernel"])
    np.testing.assert_array_equal(p["layers"]["w_down"].numpy(),
                                  params["model"]["layers"]["mlp"]["down_proj"]["kernel"])


def test_qkv_bias_config_matches_jax():
    """Qwen2-style attention biases ride through the converter."""
    model = build_llama("debug", attention_bias=True, remat=False)
    params = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(1),
                                                 jnp.zeros((1, 8), jnp.int32))["params"])
    jcfg = model.config
    L, Hkv, Dh = jcfg.num_hidden_layers, jcfg.num_key_value_heads, jcfg.head_dim
    kc0 = np.zeros((L, NB, BS, Hkv, Dh), np.float32)
    jb = {k: jnp.asarray(v) for k, v in mixed_batch(jr).finalize().items()}
    want, _, _ = jax_forward(params, jnp.asarray(kc0), jnp.asarray(kc0), jb, jcfg,
                             dtype=jnp.float32)
    tb = unpack_batch(torch.from_numpy(mixed_batch(tr).finalize_packed()), MS, MB)
    got, _, _ = ragged_forward(params_from_jax(params), torch.zeros(kc0.shape),
                               torch.zeros(kc0.shape), tb, port_config(jcfg),
                               dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
