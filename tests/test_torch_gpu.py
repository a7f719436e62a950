"""Tests of the PyTorch port that need a CUDA device (marker ``gpu``).

They skip where there is none. This file imports no jax, so it also runs
on a GPU machine without the JAX package's dependencies:

    python -m pytest --noconftest -q tests/test_torch_gpu.py

The CUDA paged-attention kernel is held against its plain version, in
fp32 on the same bf16 inputs, at shapes beyond the serving path's: every
supported group width (G = 1, 2, 3, 4, 6, 8 and 16, which splits over
two blocks), head dims 8 to 256, pad rows and positions past the table.
Tolerance: max-abs 2e-2, the kernel's bf16 output rounding."""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

TOL = 2e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _case(seed, T, H, Hkv, Dh, bs, MB, device):
    rng = np.random.RandomState(seed)
    NB = 1 + T * MB
    tables = rng.permutation(np.arange(1, NB)).astype(np.int32).reshape(T, MB)
    pos = rng.randint(0, MB * bs + 8, size=T).astype(np.int32)
    pos[0], tables[-1], pos[-1] = 0, 0, 0  # position 0, and a pad row
    g = torch.Generator(device=device).manual_seed(seed)

    def rand(*shape):
        return torch.randn(shape, generator=g, device=device).to(torch.bfloat16)

    return (rand(T, H, Dh) * 2, rand(NB, bs, Hkv, Dh), rand(NB, bs, Hkv, Dh),
            torch.from_numpy(tables).to(device), torch.from_numpy(pos).to(device))


@pytest.mark.parametrize("H,Hkv,Dh,bs", [
    (32, 8, 128, 32), (8, 8, 64, 16), (8, 4, 256, 8), (12, 4, 128, 32), (24, 4, 8, 32),
    (16, 2, 40, 16), (32, 2, 128, 32), (16, 16, 16, 1)])
def test_kernel_matches_plain(cuda, H, Hkv, Dh, bs):
    from deepspeed_tpu_torch.ops.kernels.paged_attention import (paged_attention_ref,
                                                                 paged_decode_attention)
    q, kc, vc, tab, pos = _case(0, 9, H, Hkv, Dh, bs, 5, cuda)
    before = paged_decode_attention.launches
    got = paged_decode_attention(q, kc, vc, tab, pos)
    want = paged_attention_ref(q.float(), kc.float(), vc.float(), tab, pos)
    torch.cuda.synchronize()
    assert paged_decode_attention.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert (got.float() - want).abs().max().item() <= TOL


def test_kernel_rejects_what_it_cannot_take(cuda):
    from deepspeed_tpu_torch.ops.kernels.paged_attention import paged_decode_attention
    q, kc, vc, tab, pos = _case(1, 4, 8, 2, 64, 16, 3, cuda)
    with pytest.raises(TypeError):
        paged_decode_attention(q.float(), kc, vc, tab, pos)
    with pytest.raises(TypeError):
        paged_decode_attention(q, kc, vc, tab.long(), pos)
    with pytest.raises(ValueError):
        strided = kc.permute(1, 0, 2, 3).contiguous().permute(1, 0, 2, 3)
        paged_decode_attention(q, strided, vc, tab, pos)
    with pytest.raises(ValueError):
        paged_decode_attention(q[:, :, :60].contiguous(), kc[..., :60].contiguous(),
                               vc[..., :60].contiguous(), tab, pos)
    with pytest.raises(ValueError):
        paged_decode_attention(q, kc, vc, tab.cpu(), pos)


@pytest.mark.parametrize("max_tokens,max_seqs", [(64, 4), (63, 3)])
def test_engine_on_card_matches_plain_attention_engine(cuda, max_tokens, max_seqs):
    """A small bf16 engine through the kernel vs the same weights pinned
    to ``torch_gather``: last-token logits of a prefill batch and of a
    decode batch within 2 bf16 ulps of their magnitude, and the pool
    empty again after flushes. Odd buckets (63, 3) put ``token_pos`` 8
    bytes off a 16-byte boundary in the packed vector; the kernel takes
    it."""
    from deepspeed_tpu_torch.inference.v2 import (DSStateManagerConfig, InferenceEngineV2,
                                                  RaggedInferenceEngineConfig)
    from deepspeed_tpu_torch.models import init_params, llama_config
    cfg = llama_config("debug", hidden_size=256, num_attention_heads=4,
                       num_key_value_heads=2, num_hidden_layers=3)
    params = init_params(cfg, cuda, torch.bfloat16, torch.Generator(cuda).manual_seed(3),
                         std=0.05)
    sm = DSStateManagerConfig(max_ragged_batch_size=max_tokens,
                              max_ragged_sequence_count=max_seqs,
                              max_tracked_sequences=4, max_context=96)
    outs = {}
    for impl in ("cuda_paged", "torch_gather"):
        eng = InferenceEngineV2(cfg, RaggedInferenceEngineConfig(
            kv_block_size=16, state_manager=sm, implementation_overrides={"attention": impl}),
            params=params, device=cuda)
        before = eng.forward_steps
        prefill = eng.put([0, 1, 2], [np.arange(40) % 200, np.arange(7) + 3, [5, 6]])
        decode = eng.put([0, 1, 2], [[9], [10], [11]])  # bucket max_seqs
        assert eng.forward_steps == before + 2
        outs[impl] = np.stack([prefill, decode])
        for uid in (0, 1, 2):
            eng.flush(uid)
        assert eng.free_blocks == eng.kv_cache.num_blocks - 1
    a, b = outs["cuda_paged"], outs["torch_gather"]
    scale = float(np.abs(b).max())
    assert np.abs(a - b).max() <= 2 * 2.0 ** (np.floor(np.log2(scale)) - 7)
