"""Tests of the PyTorch port that need a CUDA device (marker ``gpu``).

They skip where there is none. This file imports no jax, so it also runs
on a GPU machine without the JAX package's dependencies:

    python -m pytest --noconftest -q tests/test_torch_gpu.py

The CUDA paged-attention kernel is held against its plain version, in
fp32 on the same bf16 inputs, at shapes beyond the serving path's: every
supported group width (G = 1, 2, 3, 4, 6, 8 and 16, which splits over
two blocks), head dims 8 to 256, pad rows and positions past the table.
Tolerance: max-abs 2e-2, the kernel's bf16 output rounding.

The flash-attention kernels (forward, dK/dV, dQ) and the RMS-norm forward
are held against their plain versions element by element at each
element's scale (limits stated beside each test),
the wrappers must refuse what the kernels cannot take, and a 2-layer
bf16 training step through the kernels must match the same step pinned
to the plain versions. So must the quantized and grouped matmuls and the
segmented LoRA delta (which must also be bitwise row independent), each
with an engine through the kernels against one pinned to the plain
versions."""

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


# ------------------------------------------------- flash attention (K1)
# Kernel vs its plain version on the same bf16 inputs, element by element
# at the scale each element lives at (``row_scaled_err``: |got - ref| in
# units of 2^-8 of |ref| + the rms of its row + the tensor's rms / 16; its
# docstring derives the bound): o, dq, dk and dv within ROW_TOL units, lse
# within 1e-3 absolute (fp32, exp2 vs exp and summation order).
ROW_TOL = 6.0
FLASH_CASES = {
    # name: (B, S, H, D, causal, n_segments)
    "causal_d128": (2, 256, 2, 128, True, 0),
    "causal_ragged_s": (1, 200, 3, 128, True, 0),
    "noncausal_d64": (2, 130, 2, 64, False, 0),
    "segments_causal": (2, 192, 2, 64, True, 3),
    "segments_noncausal": (1, 160, 2, 128, False, 4),
}


def _flash_inputs(cuda, B, S, H, D, n_seg, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)

    def rand(*shape):
        return torch.randn(shape, generator=g, device=cuda).to(torch.bfloat16)

    seg = None
    if n_seg:
        rng = np.random.RandomState(seed)
        cuts = np.sort(rng.choice(np.arange(1, S), n_seg - 1, replace=False))
        seg = torch.from_numpy(np.searchsorted(cuts, np.arange(S), side="right")
                               .astype(np.int32)).repeat(B, 1).to(cuda)
    return rand(B, S, H, D), rand(B, S, H, D), rand(B, S, H, D), rand(B, S, H, D), seg


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_kernels_match_plain(cuda, case):
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    B, S, H, D, causal, n_seg = FLASH_CASES[case]
    q, k, v, do, seg = _flash_inputs(cuda, B, S, H, D, n_seg)
    before = (fa.flash_fwd.launches, fa.flash_bwd_dkv.launches, fa.flash_bwd_dq.launches)
    o, lse = fa.flash_fwd(q, k, v, seg, causal)
    o_ref, lse_ref = fa.flash_fwd_ref(q.float(), k.float(), v.float(), seg, causal)
    delta = fa.flash_delta(o, do)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, seg, causal)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, seg, causal)
    dk_ref, dv_ref = fa.flash_bwd_dkv_ref(q, k, v, do, lse, delta, seg, causal)
    dq_ref = fa.flash_bwd_dq_ref(q, k, v, do, lse, delta, seg, causal)
    torch.cuda.synchronize()
    assert (fa.flash_fwd.launches, fa.flash_bwd_dkv.launches, fa.flash_bwd_dq.launches) == \
        tuple(n + 1 for n in before)
    assert torch.isfinite(o.float()).all() and torch.isfinite(lse).all()
    assert (lse - lse_ref).abs().max().item() <= 1e-3
    for got, want in ((o, o_ref), (dq, dq_ref), (dk, dk_ref), (dv, dv_ref)):
        assert torch.isfinite(got.float()).all()
        assert fa.row_scaled_err(got, want) <= ROW_TOL


@pytest.mark.parametrize("case", ["causal_ragged_s", "segments_causal"])
def test_flash_attention_autograd_matches_reference_grads(cuda, case):
    """The autograd Function (kernels) against autograd through
    ``flash_attention_ref`` in fp32 on the same bf16 inputs: the output
    within ROW_TOL units, and each gradient within 2^-7 of the reference's
    L2 norm. The reference rounds neither p nor ds to bf16 and takes delta
    from its fp32 output, where the kernels take it from the bf16 one: in a
    row that one key dominates, that error is as large as the row's true
    dq, so the gradients are held by norm here and element by element in
    ``test_flash_kernels_match_plain``."""
    from deepspeed_tpu_torch.ops.kernels.flash_attention import (flash_attention,
                                                                 flash_attention_ref,
                                                                 row_scaled_err)
    B, S, H, D, causal, n_seg = FLASH_CASES[case]
    q, k, v, do, seg = _flash_inputs(cuda, B, S, H, D, n_seg, seed=1)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = flash_attention(*leaves, causal=causal, segment_ids=seg)
    out.backward(do)
    ref_leaves = [x.float().requires_grad_(True) for x in (q, k, v)]
    ref = flash_attention_ref(*ref_leaves, causal=causal, segment_ids=seg)
    ref.backward(do.float())
    errs = {"o": row_scaled_err(out, ref)}
    errs.update({n: ((a.grad.float() - b.grad).norm() / b.grad.norm()).item()
                 for n, a, b in zip(("dq", "dk", "dv"), leaves, ref_leaves)})
    assert errs["o"] <= ROW_TOL and max(errs[n] for n in ("dq", "dk", "dv")) <= 2.0 ** -7, errs


def test_flash_rejects_what_it_cannot_take(cuda):
    from deepspeed_tpu_torch.ops.kernels.flash_attention import flash_attention, flash_fwd
    q, k, v, _, _ = _flash_inputs(cuda, 1, 64, 2, 64, 0)
    with pytest.raises(TypeError):
        flash_attention(q.float(), k.float(), v.float())
    with pytest.raises(ValueError):
        flash_attention(q[..., :32].contiguous(), k[..., :32].contiguous(),
                        v[..., :32].contiguous())
    with pytest.raises(ValueError):
        flash_attention(q, k[:, :, :1].contiguous(), v[:, :, :1].contiguous())
    with pytest.raises(ValueError):
        flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    with pytest.raises(ValueError):
        flash_attention(q, k.cpu(), v)
    with pytest.raises(ValueError):
        flash_fwd(q.cpu(), k.cpu(), v.cpu())


# ------------------------------------------------------------ RMS norm (K2)
@pytest.mark.parametrize("rows,D,dtype", [(8192, 2048, torch.bfloat16), (37, 64, torch.bfloat16),
                                          (5, 4104, torch.bfloat16), (33, 2048, torch.float32)])
def test_rms_kernel_matches_plain(cuda, rows, D, dtype):
    """Within one unit in the last place of the output dtype at each
    element's magnitude (the kernel's output rounding, and rsqrtf's
    2-ulp fp32 error far below it), against the plain version in fp32."""
    from deepspeed_tpu_torch.ops.kernels.fused_norms import rms_norm_fwd, rms_norm_ref
    g = torch.Generator(device=cuda).manual_seed(rows)
    x = (torch.randn(rows, D, generator=g, device=cuda) * 3).to(dtype)
    scale = (1 + 0.1 * torch.randn(D, generator=g, device=cuda)).to(dtype)
    before = rms_norm_fwd.launches
    got = rms_norm_fwd(x, scale)
    want = rms_norm_ref(x.float(), scale.float())
    torch.cuda.synchronize()
    assert rms_norm_fwd.launches == before + 1
    ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -23
    assert ((got.float() - want).abs() <= ulp * want.abs() + 1e-6).all()


def test_fused_rms_norm_grads_match_plain_autograd(cuda):
    """Kernel forward + closed-form backward vs autograd through the plain
    version, in fp32 (relative to each tensor's max-abs, 1e-5)."""
    from deepspeed_tpu_torch.ops.kernels.fused_norms import fused_rms_norm, rms_norm_ref
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(4, 33, 256, generator=g, device=cuda)
    scale = 1 + 0.1 * torch.randn(256, generator=g, device=cuda)
    gy = torch.randn(4, 33, 256, generator=g, device=cuda)
    a = [x.clone().requires_grad_(True), scale.clone().requires_grad_(True)]
    fused_rms_norm(*a).backward(gy)
    b = [x.clone().requires_grad_(True), scale.clone().requires_grad_(True)]
    rms_norm_ref(*b).backward(gy)
    for p, r in zip(a, b):
        assert (p.grad - r.grad).abs().max() <= 1e-5 * r.grad.abs().max()


def test_rms_rejects_what_it_cannot_take(cuda):
    from deepspeed_tpu_torch.ops.kernels.fused_norms import fused_rms_norm
    x = torch.randn(4, 64, device=cuda, dtype=torch.bfloat16)
    s = torch.ones(64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        fused_rms_norm(x.half(), s.half())
    with pytest.raises(TypeError):
        fused_rms_norm(x, s.float())
    with pytest.raises(ValueError):
        fused_rms_norm(x[:, :60].contiguous(), s[:60].contiguous())
    with pytest.raises(ValueError):
        fused_rms_norm(x.t().contiguous().t(), s)
    with pytest.raises(ValueError):
        fused_rms_norm(x, s.cpu())


# ------------------------------------------------------- training parity
def test_two_layer_training_step_kernels_vs_plain(cuda):
    """One bf16 ``train_batch`` (gas 2) of a 2-layer model at head_dim 128
    and S=256 (the flash path) through the kernels, and again from the same
    weights with attention and norms pinned to their plain versions. Each
    parameter's accumulated fp32 gradient within 2^-4 of the plain run's
    in relative L2 norm, loss within 1e-4 relative and grad norm within
    4e-4 relative (a few times the readings on an H100: bf16 rounds at
    different places in the two), every kernel launched as the path implies (flash
    forward twice per layer and micro-batch with the remat recompute, each
    backward kernel once, RMS 4·L + 1 per micro-batch)."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import build_llama, llama
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    from deepspeed_tpu_torch.ops.kernels import fused_norms as fn
    L, gas = 2, 2
    cfg = {"train_batch_size": 2 * gas, "train_micro_batch_size_per_gpu": 2,
           "gradient_accumulation_steps": gas, "bf16": {"enabled": True},
           "optimizer": {"type": "Adam", "params": {"lr": 1e-4}}, "zero_optimization": {"stage": 3}}
    ids = torch.randint(0, 512, (2 * gas, 256), generator=torch.Generator(cuda).manual_seed(0),
                        device=cuda)
    out = {}
    for mode in ("kernels", "plain"):
        model = build_llama("debug", device=cuda, hidden_size=256, intermediate_size=512,
                            num_attention_heads=2, num_key_value_heads=2, vocab_size=512,
                            max_position_embeddings=512, num_hidden_layers=L,
                            generator=torch.Generator(cuda).manual_seed(1))
        engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=cfg, device=cuda)
        grads, step = [], engine.step

        def recording_step():  # the accumulated fp32 gradients, before the update
            grads[:] = [g.float().clone() for g in engine._grads_acc]
            step()

        engine.step = recording_step
        before = [f.launches for f in (fa.flash_fwd, fa.flash_bwd_dkv, fa.flash_bwd_dq,
                                       fn.rms_norm_fwd)]
        saved = llama.flash_attention, llama.fused_rms_norm
        if mode == "plain":
            llama.flash_attention = lambda q, k, v, causal=True: fa.flash_attention_ref(
                q, k, v, causal)
            llama.fused_rms_norm = fn.rms_norm_ref
        try:
            loss = engine.train_batch(batch=(ids, ids))
        finally:
            llama.flash_attention, llama.fused_rms_norm = saved
        torch.cuda.synchronize()
        grew = [f.launches - b for f, b in zip(
            (fa.flash_fwd, fa.flash_bwd_dkv, fa.flash_bwd_dq, fn.rms_norm_fwd), before)]
        want = [2 * L * gas, L * gas, L * gas, (4 * L + 1) * gas] if mode == "kernels" \
            else [0, 0, 0, 0]
        assert grew == want
        out[mode] = (loss.item(), engine.global_grad_norm, grads)
    (lk, nk, gk), (lp, np_, gp) = out["kernels"], out["plain"]
    readings = {"loss_rel": abs(lk - lp) / abs(lp), "grad_norm_rel": abs(nk - np_) / np_,
                "leaf_grad_rel_max": max(((a - b).norm() / b.norm()).item()
                                         for a, b in zip(gk, gp))}
    assert np.isfinite(lk) and readings["loss_rel"] <= 1e-4, readings
    assert readings["grad_norm_rel"] <= 4e-4 and readings["leaf_grad_rel_max"] <= 2.0 ** -4, \
        readings


# ------------------------------------ quantized matmul (K4), grouped (K5)
# Kernel vs its plain version on the same bf16 x and the same carriers:
# both round the same bf16 weights (decode * scale, rounded once) and
# differ only in fp32 summation order and the output's bf16 rounding, so
# ``row_scaled_err`` stays within QUANT_TOL units; with one-hot x rows
# only one product per output is nonzero, and the kernel must reproduce
# ``dequantize_grouped`` in bf16 exactly.
QUANT_TOL = 4.0
SCHEMES = ("int8", "fp8", "fp6")


def _carrier(shape, scheme, group, device, seed):
    from deepspeed_tpu_torch.inference.quantization.quantization import _quantize_grouped
    g = torch.Generator(device).manual_seed(seed)
    w = torch.randn(shape, generator=g, device=device) * 0.05
    q = _quantize_grouped(w, scheme, group)
    assert q.values.is_cuda
    return q


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("M,K,N,group", [
    (1, 64, 64, 64),        # M = 1, N = one group
    (37, 100, 20, 20),      # odd M and K; fp6 rows of 15 bytes, N < one tile
    (8, 4096, 1024, 512),   # decode, the K loop split over blocks
    (16, 320, 200, 8),      # group 8 (the router's), N past a tile edge
    (264, 256, 4096, 512),  # a prefill chunk, 64-row tiles
])
def test_quant_matmul_kernel_matches_plain(cuda, scheme, M, K, N, group):
    from deepspeed_tpu_torch.ops.kernels.flash_attention import row_scaled_err
    from deepspeed_tpu_torch.ops.kernels.fused_quant_matmul import (quant_matmul,
                                                                     quant_matmul_ref)
    q = _carrier((K, N), scheme, group, cuda, M + K)
    x = torch.randn(M, K, generator=torch.Generator(cuda).manual_seed(1),
                    device=cuda).to(torch.bfloat16)
    before = quant_matmul.launches
    got = quant_matmul(x, q.values, q.scales, scheme)
    want = quant_matmul_ref(x, q.values, q.scales, scheme)
    torch.cuda.synchronize()
    assert quant_matmul.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    err = row_scaled_err(got, want.float())
    assert err <= QUANT_TOL, f"row_scaled_err {err}"
    eye = torch.eye(K, device=cuda, dtype=torch.bfloat16)
    assert torch.equal(quant_matmul(eye, q.values, q.scales, scheme),
                       q.dequantized(torch.bfloat16))


def _gmm_case(sizes, K, tm, device, seed):
    """x rows of each expert's group placed into the tile-aligned layout
    → (xp [Mp, K] bf16, tile_experts, used_tiles)."""
    from deepspeed_tpu_torch.ops.kernels.grouped_matmul import pad_groups_to_tiles, used_tiles
    sizes_t = torch.tensor(sizes, device=device)
    n = int(sum(sizes))
    dst, te, Mp = pad_groups_to_tiles(sizes_t, n, tm)
    xp = torch.zeros((Mp, K), dtype=torch.bfloat16, device=device)
    xp[dst.long()] = torch.randn(n, K, generator=torch.Generator(device).manual_seed(seed),
                                 device=device).to(torch.bfloat16)
    return xp, te, used_tiles(sizes_t, tm)


@pytest.mark.parametrize("scheme", ("bf16",) + SCHEMES)
@pytest.mark.parametrize("sizes,K,N,tm", [
    ((2, 0, 5, 1, 3, 0, 2, 3), 256, 512, 16),   # decode: 16 rows, two experts empty
    ((70, 0, 33, 1), 128, 200, 64),              # prefill tiles; N past a tile edge
    ((0, 0, 40, 0), 96, 36, 16),                 # every row on one expert; fp6 rows of 27 bytes
])
def test_grouped_kernel_matches_plain(cuda, scheme, sizes, K, N, tm):
    from deepspeed_tpu_torch.ops.kernels import grouped_matmul as gm
    from deepspeed_tpu_torch.ops.kernels.flash_attention import row_scaled_err
    xp, te, used = _gmm_case(sizes, K, tm, cuda, 5)
    E = len(sizes)
    if scheme == "bf16":
        w = (torch.randn(E, K, N, generator=torch.Generator(cuda).manual_seed(2), device=cuda)
             * 0.05).to(torch.bfloat16)
        kernel, fn = gm.gmm, (lambda x: gm.gmm(x, w, te, tm, used))
        want = gm.gmm_ref(xp, w, te, tm, used)
    else:
        q = _carrier((E, K, N), scheme, 4 if N % 8 else 8, cuda, 3)
        kernel = gm.gmm_quant
        fn = (lambda x: gm.gmm_quant(x, q.values, q.scales, te, scheme, torch.bfloat16, tm, used))
        want = gm.gmm_quant_ref(xp, q.values, q.scales, te, scheme, torch.bfloat16, tm, used)
    before = kernel.launches
    got = fn(xp)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    n_used = int(used) * tm
    assert not got[n_used:].any()  # tiles without rows are written as zeros
    err = row_scaled_err(got[:n_used], want[:n_used].float())
    assert err <= QUANT_TOL, f"row_scaled_err {err}"


def test_quant_kernels_refuse_what_they_cannot_take(cuda):
    from deepspeed_tpu_torch.ops.kernels import grouped_matmul as gm
    from deepspeed_tpu_torch.ops.kernels.fused_quant_matmul import quant_matmul
    q = _carrier((64, 128), "fp6", 32, cuda, 0)
    x = torch.randn(4, 64, device=cuda, dtype=torch.bfloat16)
    before = quant_matmul.launches
    with pytest.raises(TypeError):
        quant_matmul(x.float(), q.values, q.scales, "fp6")        # fp32 x: no fallback
    with pytest.raises(TypeError):
        quant_matmul(x, q.values, q.scales, "fp6", dequant_dtype=torch.float32)
    with pytest.raises(ValueError):
        quant_matmul(x, q.values[:, :45], q.scales, "fp6")        # strided carriers
    with pytest.raises(ValueError):
        quant_matmul(x, q.values.cpu(), q.scales, "fp6")
    with pytest.raises(ValueError):
        quant_matmul(x, q.values, q.scales[:, :3].contiguous(), "fp6")  # 128 % 3: no groups
    stacked = _carrier((2, 64, 128), "int8", 32, cuda, 1)
    with pytest.raises(ValueError):
        stacked.matmul(x)                                          # a stack: no dequantize-then-matmul
    assert quant_matmul.launches == before
    xp, te, used = _gmm_case((3, 5), 64, 16, cuda, 0)
    w = torch.zeros(2, 64, 32, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        gm.gmm(xp, w, te, 32, used)                                # a tile it is not built for
    with pytest.raises(ValueError):
        gm.gmm(xp, w.float(), te, 16, used)
    with pytest.raises(TypeError):
        gm.gmm(xp, w, te.long(), 16, used)
    with pytest.raises(TypeError):
        gm.gmm_quant(xp.float(), q.values[None], q.scales[None], te, "fp6", tm=16)


@pytest.mark.parametrize("mode", ["int8", "none"])
def test_moe_engine_on_card_matches_plain_engine(cuda, mode):
    """``mixtral-debug`` (bf16; int8 carriers, or bf16 experts) through the
    kernels vs the same weights with ``quant_matmul``, ``gmm`` and
    ``gmm_quant`` pinned to their plain versions: last-token logits of a
    prefill put and a mixed put within 4 bf16 ulps of their magnitude
    (the kernels and cuBLAS sum in other orders, and a few roundings of
    bf16 activations may fall the other way through 2 layers), each
    kernel launched as the path implies, and a decode burst served."""
    import contextlib
    from deepspeed_tpu_torch.inference import quantization as qpkg
    from deepspeed_tpu_torch.inference.quantization import quantization as qmod
    from deepspeed_tpu_torch.inference.v2 import (DSStateManagerConfig, InferenceEngineV2,
                                                  RaggedInferenceEngineConfig)
    from deepspeed_tpu_torch.models import init_params, llama_config
    from deepspeed_tpu_torch.ops.kernels import fused_quant_matmul as fq
    from deepspeed_tpu_torch.ops.kernels import grouped_matmul as gm
    assert qpkg.QuantizedWeight is qmod.QuantizedWeight
    cfg = llama_config("mixtral-debug")
    params = init_params(cfg, cuda, torch.bfloat16, torch.Generator(cuda).manual_seed(4),
                         std=0.05)
    ecfg = RaggedInferenceEngineConfig(
        kv_block_size=16, quantization={"quantization_mode": mode},
        state_manager=DSStateManagerConfig(max_ragged_batch_size=64, max_ragged_sequence_count=4,
                                           max_tracked_sequences=4, max_context=96))

    @contextlib.contextmanager
    def plain():
        saved = qmod.quant_matmul, gm.gmm, gm.gmm_quant
        qmod.quant_matmul = fq.quant_matmul_ref
        gm.gmm, gm.gmm_quant = gm.gmm_ref, gm.gmm_quant_ref
        try:
            yield
        finally:
            qmod.quant_matmul, gm.gmm, gm.gmm_quant = saved

    outs, L = {}, cfg.num_hidden_layers
    for pin in ("kernels", "plain"):
        eng = InferenceEngineV2(cfg, ecfg, params=params, device=cuda)
        counts = [fq.quant_matmul.launches, gm.gmm.launches, gm.gmm_quant.launches]
        with plain() if pin == "plain" else contextlib.nullcontext():
            first = eng.put([0, 1, 2], [np.arange(40) % 200, np.arange(7) + 3, [5, 6]])
            mixed = eng.put([0, 1, 3], [[9], [10], np.arange(20) + 30])
            burst = eng.decode_burst([0, 1, 2, 3], [[1], [2], [3], [4]], 3)
        torch.cuda.synchronize()
        grew = [fq.quant_matmul.launches - counts[0], gm.gmm.launches - counts[1],
                gm.gmm_quant.launches - counts[2]]
        fwd = 2 + 3
        want = ([(4 * L + 1) * fwd, 0, 3 * L * fwd] if mode == "int8" else [0, 3 * L * fwd, 0])
        assert grew == (want if pin == "kernels" else [0, 0, 0]), (pin, grew)
        assert burst.shape == (3, 4) and (burst >= 0).all() and (burst < cfg.vocab_size).all()
        outs[pin] = np.stack([first, mixed])
    a, b = outs["kernels"], outs["plain"]
    scale = float(np.abs(b).max())
    ulps = np.abs(a - b).max() / 2.0 ** (np.floor(np.log2(scale)) - 7)
    assert ulps <= 4, f"{ulps} bf16 ulps"


# ------------------------------------------------- segmented LoRA delta (K6)
# The kernel's delta (added into zeros) against the plain version on the
# same inputs, element by element at each element's scale (``row_scaled_err``)
# over the rows of adapter tokens: both sum fp32 products in other orders
# and round the scaled result once to x's dtype (at most 2 units in bf16).
# Base rows must be exactly zero, and the fused add ``y + delta`` must equal
# rounding ``float(y) + float(delta)`` once.
LORA_TOL = 4.0
LORA_CASES = {
    # name: (T, K, N, S, r, dtype, slots: "rr" round-robin over S-1 adapters, "base", "one")
    "decode_q": (16, 4096, 4096, 9, 8, torch.bfloat16, "rr"),
    "decode_kv_r16": (16, 4096, 1024, 9, 16, torch.bfloat16, "rr"),
    "prefill": (512, 4096, 4096, 9, 8, torch.bfloat16, "rr"),
    "odd_t_n_r5": (37, 300, 1000, 5, 5, torch.bfloat16, "rr"),   # scalar A rows, ragged N
    "rank1_fp32": (23, 128, 96, 3, 1, torch.float32, "rr"),
    "rank64_fp32": (20, 256, 520, 4, 64, torch.float32, "rr"),
    "rank64_bf16": (33, 512, 512, 3, 64, torch.bfloat16, "one"),
    "all_base": (40, 256, 256, 5, 8, torch.bfloat16, "base"),
}


def _lora_case(device, T, K, N, S, r, dtype, slots, seed=0, offset=0):
    """x [T, K] (a view ``offset`` elements into a larger buffer when
    given), slots, slabs a [S, K, r] / b [S, r, N] (slot 0 zero), fp32
    scales, all seeded."""
    g = torch.Generator(device).manual_seed(seed)
    buf = torch.randn(T * K + offset, generator=g, device=device).to(dtype)
    x = buf[offset:].view(T, K)
    a = (torch.randn(S, K, r, generator=g, device=device) * 0.05).to(dtype)
    b = (torch.randn(S, r, N, generator=g, device=device) * 0.05).to(dtype)
    scales = torch.rand(S, generator=g, device=device) + 0.5
    a[0], b[0], scales[0] = 0, 0, 0
    if slots == "rr":
        s = torch.arange(T, device=device) % (S - 1) + 1
        s[::5] = 0  # some base rows among the adapters'
    elif slots == "one":
        s = torch.full((T,), S - 1, device=device)
    else:
        s = torch.zeros(T, device=device)
    return x, s.to(torch.int32), a, b, scales


@pytest.mark.parametrize("case", sorted(LORA_CASES))
def test_lora_kernel_matches_plain(cuda, case):
    from deepspeed_tpu_torch.ops.kernels.flash_attention import row_scaled_err
    from deepspeed_tpu_torch.ops.kernels.lora_matmul import (apply_lora_delta, lora_delta,
                                                             lora_delta_ref, lora_layout)
    T, K, N, S, r, dtype, kind = LORA_CASES[case]
    x, slots, a, b, scales = _lora_case(cuda, T, K, N, S, r, dtype, kind, offset=T % 7)
    before = lora_delta.launches
    got = apply_lora_delta(x, slots, a, b, scales)
    want = lora_delta_ref(x, slots, a, b, scales)
    torch.cuda.synchronize()
    assert lora_delta.launches == before + 1
    assert got.dtype == dtype and got.shape == (T, N)
    base = slots == 0
    assert not got[base].any()
    if kind != "base":
        err = row_scaled_err(got[~base], want[~base].float())
        assert err <= LORA_TOL, f"row_scaled_err {err}"
    y = torch.randn(T, N, generator=torch.Generator(cuda).manual_seed(9), device=cuda).to(dtype)
    fused = lora_delta(x, y.clone(), a, b, scales, lora_layout(slots, S))
    assert torch.equal(fused, (y.float() + got.float()).to(dtype))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_lora_kernel_rows_bitwise_independent(cuda, dtype):
    from deepspeed_tpu_torch.ops.kernels.lora_matmul import apply_lora_delta
    x, slots, a, b, scales = _lora_case(cuda, 45, 4096, 1024, 9, 8, dtype, "rr", seed=2)
    mixed = apply_lora_delta(x, slots, a, b, scales)
    for t in range(0, 45, 4):
        solo = apply_lora_delta(x[t:t + 1], slots[t:t + 1], a, b, scales)
        assert torch.equal(solo[0], mixed[t]), f"row {t}"
    assert torch.equal(apply_lora_delta(x[:17], slots[:17], a, b, scales), mixed[:17])
    perm = torch.randperm(45, generator=torch.Generator().manual_seed(0)).to(cuda)
    assert torch.equal(apply_lora_delta(x[perm], slots[perm], a, b, scales), mixed[perm])


def test_lora_kernel_refuses_what_it_cannot_take(cuda):
    from deepspeed_tpu_torch.ops.kernels.lora_matmul import (apply_lora_delta, lora_delta,
                                                             lora_layout)
    x, slots, a, b, scales = _lora_case(cuda, 8, 64, 32, 3, 4, torch.bfloat16, "rr")
    y = torch.zeros(8, 32, dtype=torch.bfloat16, device=cuda)
    lay = lora_layout(slots, 3)
    with pytest.raises(TypeError):
        apply_lora_delta(x.half(), slots, a.half(), b.half(), scales)
    with pytest.raises(TypeError):
        lora_delta(x, y.float(), a, b, scales, lay)
    with pytest.raises(TypeError):
        lora_delta(x, y, a, b, scales.bfloat16(), lay)
    with pytest.raises(ValueError):  # over the largest rank bucket
        x2, s2, a2, b2, sc2 = _lora_case(cuda, 8, 64, 32, 3, 65, torch.bfloat16, "rr")
        apply_lora_delta(x2, s2, a2, b2, sc2)
    with pytest.raises(ValueError):
        lora_delta(x, y, a.transpose(1, 2).contiguous().transpose(1, 2), b, scales, lay)
    with pytest.raises(ValueError):
        lora_delta(x.t().contiguous().t(), y, a, b, scales, lay)
    with pytest.raises(ValueError):
        lora_delta(x, y, a, b, scales, lora_layout(slots, 3, tm=8))
    with pytest.raises(ValueError):
        lora_delta(x[:7], y[:7], a, b, scales, lay)


def test_lora_engine_on_card_matches_plain_engine(cuda):
    """A 2-layer bf16 engine with 3 adapters through the kernel vs the
    same weights and adapters with ``lora_delta`` pinned to its plain
    version: last-token logits of a prefill put and a mixed put within 4
    bf16 ulps of their magnitude (the base path is the same cuBLAS calls
    on both sides; the deltas differ by summation order and a rounding
    may fall the other way through 2 layers), 4 x L launches per
    forward, and the adapters move the logits far more than that."""
    from deepspeed_tpu_torch.inference.v2 import (DSStateManagerConfig, InferenceEngineV2,
                                                  LoRAServingConfig, RaggedInferenceEngineConfig)
    from deepspeed_tpu_torch.inference.v2 import model_runner
    from deepspeed_tpu_torch.models import init_params, llama_config
    from deepspeed_tpu_torch.ops.kernels import lora_matmul as lm
    cfg = llama_config("debug", hidden_size=256, num_attention_heads=4,
                       num_key_value_heads=2, num_hidden_layers=2)
    params = init_params(cfg, cuda, torch.bfloat16, torch.Generator(cuda).manual_seed(3),
                         std=0.05)
    ecfg = RaggedInferenceEngineConfig(
        kv_block_size=16, lora=LoRAServingConfig(enabled=True, hot_set=4, max_rank=8,
                                                 prefetch=False),
        state_manager=DSStateManagerConfig(max_ragged_batch_size=63, max_ragged_sequence_count=3,
                                           max_tracked_sequences=4, max_context=96))

    def plain(x, y, a, b, scales, layout):
        return y.add_(lm.lora_delta_ref(x, layout.slots, a, b, scales))

    outs, L = {}, cfg.num_hidden_layers
    for pin in ("kernel", "plain", "base"):
        eng = InferenceEngineV2(cfg, ecfg, params=params, device=cuda)
        st = eng.lora_store
        for aid, r in ((1, 8), (2, 3), (3, 5)):
            rs = np.random.RandomState(aid)
            eng.register_adapter(aid, {s: (rs.randn(L, i, r).astype(np.float32) * 0.2,
                                           rs.randn(L, r, o).astype(np.float32) * 0.2)
                                       for s, (i, o) in st.dims.items()}, alpha=2.0 * r)
        if pin != "base":
            for uid, aid in ((0, 1), (1, 2), (3, 3)):
                eng.bind_adapter(uid, aid)
        before = lm.lora_delta.launches
        saved = model_runner.lora_delta
        model_runner.lora_delta = plain if pin == "plain" else saved
        try:
            first = eng.put([0, 1, 2], [np.arange(40) % 200, np.arange(7) + 3, [5, 6]])
            mixed = eng.put([0, 1, 3], [[9], [10], np.arange(20) + 30])
        finally:
            model_runner.lora_delta = saved
        torch.cuda.synchronize()
        assert lm.lora_delta.launches - before == (0 if pin == "plain" else 2 * 4 * L), pin
        outs[pin] = np.stack([first, mixed])
        eng.destroy()
    a, b = outs["kernel"], outs["plain"]
    ulp = 2.0 ** (np.floor(np.log2(float(np.abs(b).max()))) - 7)
    assert np.abs(a - b).max() / ulp <= 4, f"{np.abs(a - b).max() / ulp} bf16 ulps"
    assert np.abs(outs["base"] - b).max() / ulp > 40
