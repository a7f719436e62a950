"""Tests of the PyTorch port that need a CUDA device (marker ``gpu``).

They skip where there is none. This file imports no jax, so it also runs
on a GPU machine without the JAX package's dependencies:

    python -m pytest --noconftest -q tests/test_torch_gpu.py

The CUDA paged-attention kernels are held against their plain version,
in fp32 on the same bf16 inputs, at shapes beyond the serving path's: every
supported group width (G = 1, 2, 3, 4, 6, 8 and 16, which splits over
two blocks in the token design), head dims 8 to 256, pad rows and
positions past the table. Tolerance: max-abs 2e-2, the kernel's bf16
output rounding. The tiled design (the serving path's) also at the
serving shapes, across its chunk cut, at bs 16 and 24, G 1-5 and 8, Dh
32, 64, 96, 160, 224 and 256, with ``row_scaled_err`` rejecting a zeroed tile; a row's
bits must not move with its tile or batch; each call takes the design
``paged_design`` names, and a forced design it cannot take is refused.

The flash-attention kernels (forward, dK/dV, dQ) and the RMS-norm forward
are held against their plain versions element by element at each
element's scale (limits stated beside each test),
the wrappers must refuse what the kernels cannot take, and a 2-layer
bf16 training step through the kernels must match the same step pinned
to the plain versions. So must the quantized and grouped matmuls and the
segmented LoRA delta (which must also be bitwise row independent, and
take its mma design wherever ``lora_design`` names it), each
with an engine through the kernels against one pinned to the plain
versions. The int8 group quantize/dequantize kernels (K7) must equal their
plain versions bit for bit, stochastic rounding included, a quantized
restore must write the same pool bytes as on the CPU, and an engine with
an int8 KV tier must serve bit for bit as one pinned to the plain
versions, with the launches its demotions and promotions imply. The
block-sparse attention kernels (K8: forward, dQ, dK/dV) and the LayerNorm
forward are held against their plain versions with ``row_scaled_err``,
at every block size and head dim, per-head layouts and a layout with an
empty row and a key block no row admits (zeros there, lse ``NEG_INF``),
each check rejecting a zeroed tile, and a 2-layer BERT ``train_batch``
through the kernels must match the same step pinned to the plain
versions. The flash forward, dK/dV and dQ kernels are wgmma designs:
one-hot operands pin each operand's layout (exact means of a one-hot v, a
one-hot score selecting one key, one-hot do and q landing at one column of
dv and dk, a one-hot k, read MN-major by dS K, landing at one column of
dq), dQ must reject a zeroed tile and give the same bits on a second run,
and the built library's SASS shows wgmma in all three. K5's input gradient, its forward over a bf16 stack and its
weight gradient must take the design their shape predicates name (the
wgmma designs wherever TMA can read the operands, at 64-row tiles for the
forward and dW), give the same bits on a second run, and reproduce their
operands bit for bit on one-hot rows (dx: the dequantized carriers; the
forward: the stack; dW: dy). So must K5's forward through carriers
(``gmm_quant``) at Mixtral's shapes: the forward ring at prefill's 64-row
tiles, the decode design at 16-row tiles, the first design at an
unaligned base. On-device sampling: the counter PRNG's keys, bits and
uniforms on the card equal its CPU version bit for bit, the packed
sampler on the card draws the CPU's tokens from the same logits and keys
but for near-ties (at most SAMPLE_MISMATCHES of 512 rows), and a sampled
engine on the card replays a seeded trace, gives the same streams
stepwise and in bursts, and draws ``top_k: 1`` as greedy. Speculative
decoding: a verify on the card with forced drafts (greedy and sampled)
emits the stepwise stream bit for bit through the kernels, and spec on
gives the spec-off greedy streams; the serving RMS norm's rows keep their
bits at every row count; constrained decoding: the DFA mask and
advance on the card equal the CPU's, and a constrained engine on the card
emits schema-valid JSON. The serving gateway and weight refresh: client
threads streaming through a gateway whose pump thread drives the card get
the streams a scheduler driving the engine directly gets, and ``drain``
returns the engine's memory; an engine swapped to new weights on the
card (bf16, and int8 carriers quantized on the card) serves what a cold
start on them serves, its carriers byte-equal; a publication of CUDA
tensors loads back bit for bit. The fleet: two engines over one weight
tree, each behind its own gateway pump thread, stream what each streams
alone (they share the split-K workspace); two replicas behind a
``FleetRouter`` replay a killed replica's streams bit for bit; a
``FleetRefreshController`` rollout passes its canary against a cold
start. The wire: two replica processes of the port's entry point under a
``FleetSupervisor`` (2 layers of Mistral-7B width, each drawing the
seed-0 weights itself) stream what an in-process pair streams and report
their launches a forward at a clean stop; a ``PublicationRef`` rollout
passes its canary in both processes and a torn publication is rejected
typed in the child; a prefill/decode pair over JSON frames hands bf16 KV
records over the wire and streams what a unified pair streams."""

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


# ------------------------------------------- paged attention, tiled design (K3)
# The serving path's design: query tiles on mma.sync, long contexts split
# over blocks by chunks of 512 positions. Held against the plain version
# in fp32 at max-abs TOL and at ``row_scaled_err`` PAGED_ROW_TOL (P rounded
# to bf16 for P·V adds ~0.3 units a sigma to the output's 1 unit of bf16
# rounding), the check rejecting a zeroed tile; a row's bits must not move
# with its tile, its batch mates or T.
PAGED_ROW_TOL = 6.0


def _seq_case(seed, seqs, H, Hkv, Dh, bs, MB, device, pad_rows=0):
    """``seqs``: (first position, tokens) a sequence, each on its own
    random blocks; then ``pad_rows`` pad rows (null table, position 0)."""
    rng = np.random.RandomState(seed)
    NB = 1 + len(seqs) * MB
    perm = rng.permutation(np.arange(1, NB)).astype(np.int32).reshape(len(seqs), MB)
    tabs = [perm[s] for s, (p0, n) in enumerate(seqs) for _ in range(n)]
    pos = [p for p0, n in seqs for p in range(p0, p0 + n)]
    tabs += [np.zeros(MB, np.int32)] * pad_rows
    pos += [0] * pad_rows
    g = torch.Generator(device=device).manual_seed(seed)

    def rand(*shape):
        return torch.randn(shape, generator=g, device=device).to(torch.bfloat16)

    return (rand(len(pos), H, Dh) * 2, rand(NB, bs, Hkv, Dh), rand(NB, bs, Hkv, Dh),
            torch.from_numpy(np.stack(tabs).astype(np.int32)).to(device),
            torch.tensor(pos, dtype=torch.int32, device=device))


TILED_CASES = {
    # name: (seqs, H, Hkv, Dh, bs, MB, pad rows)
    "serving_decode": ([(160, 1)] * 16, 32, 8, 128, 32, 6, 0),
    "serving_prefill": ([(0, 128)] * 4, 32, 8, 128, 32, 6, 0),
    "prefill_chunk_512": ([(480, 32)] * 4, 32, 8, 128, 32, 16, 0),
    "across_the_chunk_cut": ([(500, 40), (1020, 9)], 32, 8, 128, 32, 40, 3),
    "decode_long": ([(p, 1) for p in (0, 511, 512, 1500, 4095)], 32, 8, 128, 32, 128, 0),
    "bs16": ([(37, 50), (3, 1)], 32, 8, 128, 16, 12, 1),
    "g1_dh64": ([(5, 70), (600, 3)], 8, 8, 64, 16, 40, 0),
    "g8_dh64": ([(9, 20), (700, 2)], 32, 4, 64, 32, 24, 0),
    "g3_dh256_bs8": ([(30, 25)], 12, 4, 256, 8, 8, 1),
    "dh32_bs24": ([(40, 30)], 8, 2, 32, 24, 4, 0),
    "dh96_g5": ([(3, 40), (500, 20)], 10, 2, 96, 16, 40, 1),
    "dh160_g4": ([(20, 40)], 16, 4, 160, 16, 8, 1),
    "dh224_g2_across_the_cut": ([(490, 40)], 8, 4, 224, 32, 20, 0),
}


@pytest.mark.parametrize("name", sorted(TILED_CASES))
def test_tiled_paged_kernel_matches_plain(cuda, name):
    from deepspeed_tpu_torch.ops.kernels.flash_attention import row_scaled_err
    from deepspeed_tpu_torch.ops.kernels.paged_attention import (paged_attention_ref,
                                                                 paged_decode_attention,
                                                                 paged_design_launches)
    seqs, H, Hkv, Dh, bs, MB, pad = TILED_CASES[name]
    q, kc, vc, tab, pos = _seq_case(4, seqs, H, Hkv, Dh, bs, MB, cuda, pad)
    before = dict(paged_design_launches)
    got = paged_decode_attention(q, kc, vc, tab, pos)
    want = paged_attention_ref(q.float(), kc.float(), vc.float(), tab, pos)
    torch.cuda.synchronize()
    assert paged_design_launches["tiled"] == before["tiled"] + 1
    assert paged_design_launches["token"] == before["token"]
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert (got.float() - want).abs().max().item() <= TOL
    assert row_scaled_err(got, want) <= PAGED_ROW_TOL
    zeroed = got.clone()
    zeroed[:1, : H // Hkv] = 0  # one (token, KV head)'s rows
    assert row_scaled_err(zeroed, want) > PAGED_ROW_TOL
    assert torch.equal(paged_decode_attention(q, kc, vc, tab, pos), got)  # no atomics in sums


@pytest.mark.parametrize("length", [1, 7, 16, 64, 128])
def test_tiled_paged_rows_do_not_move_with_tile_or_batch(cuda, length):
    """Every token of a chunk of ``length`` tokens (the last at position
    530, past the chunk cut at 512): alone, in its chunk, beside other
    sequences, and after them, the same bits."""
    from deepspeed_tpu_torch.ops.kernels.paged_attention import paged_decode_attention
    seqs = [(531 - length, length), (40, 33), (200, 1), (600, 16)]
    q, kc, vc, tab, pos = _seq_case(5, seqs, 32, 8, 128, 32, 24, cuda, pad_rows=2)
    T = pos.shape[0]

    def rows(idx):
        idx = torch.as_tensor(list(idx), device=cuda)
        return paged_decode_attention(q[idx].contiguous(), kc, vc, tab[idx].contiguous(),
                                      pos[idx].contiguous())

    mixed = rows(range(T))[:length]
    assert torch.equal(rows(range(length)), mixed)
    assert torch.equal(rows(list(range(length, T)) + list(range(length)))[T - length:], mixed)
    for t in range(length):
        assert torch.equal(rows([t])[0], mixed[t])


def test_paged_design_predicate_and_forced_designs(cuda):
    from deepspeed_tpu_torch.ops.kernels.paged_attention import (paged_attention_ref,
                                                                 paged_decode_attention,
                                                                 paged_design,
                                                                 paged_design_launches)
    assert paged_design(32, 8, 128, 32) == "tiled" and paged_design(32, 2, 128, 32) == "token"
    assert paged_design(16, 2, 40, 16) == "token" and paged_design(16, 16, 16, 1) == "token"
    assert paged_design(8, 2, 16, 16) == "token" and paged_design(8, 2, 96, 16) == "tiled"
    q, kc, vc, tab, pos = _seq_case(6, [(10, 20)], 32, 8, 128, 32, 2, cuda)
    want = paged_attention_ref(q.float(), kc.float(), vc.float(), tab, pos)
    for design in ("tiled", "token"):
        before = dict(paged_design_launches)
        got = paged_decode_attention(q, kc, vc, tab, pos, design=design)
        torch.cuda.synchronize()
        assert {d: paged_design_launches[d] - before[d] for d in before} == \
            {d: int(d == design) for d in before}
        assert (got.float() - want).abs().max().item() <= TOL
    q, kc, vc, tab, pos = _seq_case(7, [(10, 4)], 16, 2, 40, 16, 2, cuda)
    with pytest.raises(ValueError):  # Dh 40: the tiled design does not take it
        paged_decode_attention(q, kc, vc, tab, pos, design="tiled")
    with pytest.raises(ValueError):
        paged_decode_attention(q, kc, vc, tab, pos, design="other")
    before = dict(paged_design_launches)
    paged_decode_attention(q, kc, vc, tab, pos)
    assert paged_design_launches["token"] == before["token"] + 1


# ------------------------------------------------- flash attention (K1)
# Kernel vs its plain version on the same bf16 inputs, element by element
# at the scale each element lives at (``row_scaled_err``: |got - ref| in
# units of 2^-8 of |ref| + the rms of its row + the tensor's rms / 16; its
# docstring derives the bound): o, dq, dk and dv within ROW_TOL units, lse
# within 1e-3 absolute (fp32, exp2 vs exp and summation order).
ROW_TOL = 6.0
FLASH_CASES = {
    # name: (B, S, H, D, causal, segments: a count of random ones, or the cuts)
    "causal_d128": (2, 256, 2, 128, True, 0),
    "causal_ragged_s": (1, 200, 3, 128, True, 0),
    "noncausal_d64": (2, 130, 2, 64, False, 0),
    "segments_causal": (2, 192, 2, 64, True, 3),
    "segments_noncausal": (1, 160, 2, 128, False, 4),
    # the wgmma designs' edges: S ragged against their 128-row tiles and
    # below one tile, whole 128-key tiles masked for some rows by segment
    # ids, both head dims, causal and not, B·H > 1 with H > 1
    "causal_s1000_d128": (1, 1000, 2, 128, True, 0),
    "noncausal_s2049_d128": (1, 2049, 2, 128, False, 0),
    "causal_s2049_d64": (2, 2049, 2, 64, True, 0),
    "causal_s37_d128": (2, 37, 3, 128, True, 0),
    "noncausal_s37_d64": (1, 37, 2, 64, False, 0),
    "segments_tile_masked_causal_d128": (2, 384, 2, 128, True, (150, 300)),
    "segments_tile_masked_noncausal_d64": (1, 320, 3, 64, False, (130, 260)),
    "causal_s512_d64_h4": (2, 512, 4, 64, True, 0),
    "noncausal_s512_d128": (2, 512, 2, 128, False, 0),
}


def _flash_inputs(cuda, B, S, H, D, n_seg, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)

    def rand(*shape):
        return torch.randn(shape, generator=g, device=cuda).to(torch.bfloat16)

    seg = None
    if n_seg:
        if isinstance(n_seg, tuple):
            cuts = np.array(n_seg)
        else:
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


# One-hot operands pin each operand's layout in the wgmma designs (which
# key row and which head-dim column of each swizzled box a product reads):
# with q = k = 0 every admitted score is 0, so p is exactly uniform over
# the admitted keys, and a single 1 in v (forward) or do (dK/dV) lands at
# one (row, column) of the output, zeros everywhere else.
FLASH_ONE_HOT = [  # (D, causal, row, column): a row past 128 and a column past 64
    (128, True, 200, 100), (128, False, 5, 64), (64, True, 130, 63), (64, False, 70, 0)]


def _one_hot(cuda, shape, row, col):
    x = torch.zeros(shape, dtype=torch.bfloat16, device=cuda)
    x[:, row, :, col] = 1
    return x


def _admitted(S, causal, row, cuda):
    """Keys a query row admits (forward) and query rows a key is admitted
    by (dK/dV), as [S] bool over the other index."""
    idx = torch.arange(S, device=cuda)
    return (idx <= row) if causal else torch.ones(S, dtype=torch.bool, device=cuda), \
        (idx >= row) if causal else torch.ones(S, dtype=torch.bool, device=cuda)


@pytest.mark.parametrize("D, causal, key, col", FLASH_ONE_HOT)
def test_flash_fwd_one_hot_v_gives_exact_means(cuda, D, causal, key, col):
    """o[i, col] = 1 / (keys row i admits) where row i admits the key, else
    0, bit for bit: both sides round the fp32 quotient once."""
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    B, S, H = 2, 256, 2
    q = torch.zeros(B, S, H, D, dtype=torch.bfloat16, device=cuda)
    v = _one_hot(cuda, (B, S, H, D), key, col)
    o, lse = fa.flash_fwd(q, q, v, None, causal)
    idx = torch.arange(S, device=cuda, dtype=torch.float32)
    count = idx + 1 if causal else torch.full_like(idx, S)
    sees = idx >= key if causal else torch.ones(S, dtype=torch.bool, device=cuda)
    want = torch.zeros(B, S, H, D, device=cuda)
    want[:, :, :, col] = torch.where(sees, 1.0 / count, 0.0)[None, :, None]
    assert torch.equal(o, want.to(torch.bfloat16))
    assert (lse - count.log()[None, None]).abs().max().item() <= 1e-5


@pytest.mark.parametrize("D, causal, key, col", FLASH_ONE_HOT)
def test_flash_fwd_one_hot_scores_select_one_key(cuda, D, causal, key, col):
    """q's column ``col`` large and k's row ``key`` one-hot in that column:
    a row that admits the key puts all of p on it (the others weigh
    e^-30), so o's row is v[key] bit for bit; rows before a causal key
    take the plain version's mean."""
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    B, S, H = 2, 256, 2
    g = torch.Generator(device=cuda).manual_seed(key)
    q = torch.zeros(B, S, H, D, dtype=torch.bfloat16, device=cuda)
    q[..., col] = 30 * D ** 0.5
    k = _one_hot(cuda, (B, S, H, D), key, col)
    v = torch.randn(B, S, H, D, generator=g, device=cuda).to(torch.bfloat16)
    o, lse = fa.flash_fwd(q, k, v, None, causal)
    o_ref, lse_ref = fa.flash_fwd_ref(q.float(), k.float(), v.float(), None, causal)
    torch.cuda.synchronize()
    assert fa.row_scaled_err(o, o_ref) <= ROW_TOL
    assert (lse - lse_ref).abs().max().item() <= 1e-3
    rows = slice(key, None) if causal else slice(None)
    assert torch.equal(o[:, rows], v[:, key:key + 1].expand_as(o[:, rows]))


@pytest.mark.parametrize("D, causal, query, col", FLASH_ONE_HOT)
def test_flash_dkv_one_hot_do_pins_dv(cuda, D, causal, query, col):
    """q = k = 0 and do one-hot at (query, col): dv is p(query, key) in
    column ``col`` of the keys the query admits and exactly 0 elsewhere;
    dk is exactly 0 (q is)."""
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    B, S, H = 2, 256, 2
    g = torch.Generator(device=cuda).manual_seed(query)
    q = torch.zeros(B, S, H, D, dtype=torch.bfloat16, device=cuda)
    v = torch.randn(B, S, H, D, generator=g, device=cuda).to(torch.bfloat16)
    do = _one_hot(cuda, (B, S, H, D), query, col)
    o_ref, lse = fa.flash_fwd_ref(q.float(), q.float(), v.float(), None, causal)
    delta = fa.flash_delta(o_ref.to(torch.bfloat16), do)
    dk, dv = fa.flash_bwd_dkv(q, q, v, do, lse, delta, None, causal)
    dk_ref, dv_ref = fa.flash_bwd_dkv_ref(q, q, v, do, lse, delta, None, causal)
    torch.cuda.synchronize()
    keys, _ = _admitted(S, causal, query, cuda)
    mask = torch.zeros(B, S, H, D, dtype=torch.bool, device=cuda)
    mask[:, :, :, col] = keys[None, :, None]
    assert (dv[~mask] == 0).all() and (dv[mask] != 0).all()
    assert fa.row_scaled_err(dv, dv_ref) <= ROW_TOL
    assert (dk == 0).all() and (dk_ref == 0).all()


@pytest.mark.parametrize("D, causal, query, col", FLASH_ONE_HOT)
def test_flash_dkv_one_hot_q_pins_dk(cuda, D, causal, query, col):
    """k = 0 and q one-hot at (query, col): dk[key] = ds(query, key) q[query]
    lies in column ``col`` of the keys the query admits, 0 elsewhere."""
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    B, S, H = 2, 256, 2
    g = torch.Generator(device=cuda).manual_seed(query + 1)
    q = _one_hot(cuda, (B, S, H, D), query, col)
    k = torch.zeros_like(q)
    v, do = (torch.randn(B, S, H, D, generator=g, device=cuda).to(torch.bfloat16)
             for _ in range(2))
    o_ref, lse = fa.flash_fwd_ref(q.float(), k.float(), v.float(), None, causal)
    delta = fa.flash_delta(o_ref.to(torch.bfloat16), do)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, None, causal)
    dk_ref, dv_ref = fa.flash_bwd_dkv_ref(q, k, v, do, lse, delta, None, causal)
    torch.cuda.synchronize()
    keys, _ = _admitted(S, causal, query, cuda)
    outside = torch.ones(B, S, H, D, dtype=torch.bool, device=cuda)
    outside[:, :, :, col] = ~keys[None, :, None]
    assert (dk[outside] == 0).all() and (dk_ref[outside] == 0).all()
    assert fa.row_scaled_err(dk, dk_ref) <= ROW_TOL
    assert fa.row_scaled_err(dv, dv_ref) <= ROW_TOL


def test_flash_library_fwd_and_dkv_kernels_are_wgmma(cuda):
    """The built library's forward, dK/dV and dQ kernels (both head dims)
    issue wgmma (HGMMA in their SASS, no mma.sync HMMA) and keep nothing in
    local memory."""
    from deepspeed_tpu_torch.ops.kernels import build
    per = build.sass_counts("flash_attention.cu", ("HGMMA", "HMMA", "LDL", "STL"))
    kinds = {k: [c for n, c in per.items() if k in n] for k in
             ("flash_fwd_kernel", "flash_bwd_dkv_kernel", "flash_bwd_dq_kernel")}
    assert all(len(v) == 2 for v in kinds.values()), per
    for k, v in kinds.items():
        assert all(c["HGMMA"] > 0 and c["HMMA"] == 0 and c["LDL"] == c["STL"] == 0
                   for c in v), (k, per)


# dQ's wgmma design at its edges: both head dims (64 keys a stage at D 128,
# 128 at D 64), S 2049 (ragged against the 128-row blocks and both key
# tiles), non-causal, and segment ids that put whole key tiles outside
# some rows' segments
DQ_CASES = {
    "causal_s2049_d128": (1, 2049, 2, 128, True, 0),
    "noncausal_s2049_d64": (1, 2049, 2, 64, False, 0),
    "segments_causal_d64": (2, 520, 2, 64, True, (150, 300)),
    "segments_noncausal_d128": (1, 400, 3, 128, False, (70, 330)),
}


@pytest.mark.parametrize("case", sorted(DQ_CASES))
def test_flash_dq_kernel_matches_plain_and_repeats(cuda, case):
    """dQ within ROW_TOL units of its plain version, a zeroed last 64-row
    tile read as far beyond the limit, and a second run the same bits (each
    row is stored once, by one block: no atomics)."""
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    B, S, H, D, causal, n_seg = DQ_CASES[case]
    q, k, v, do, seg = _flash_inputs(cuda, B, S, H, D, n_seg, seed=len(case))
    o, lse = fa.flash_fwd(q, k, v, seg, causal)
    delta = fa.flash_delta(o, do)
    before = fa.flash_bwd_dq.launches
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, seg, causal)
    again = fa.flash_bwd_dq(q, k, v, do, lse, delta, seg, causal)
    dq_ref = fa.flash_bwd_dq_ref(q, k, v, do, lse, delta, seg, causal)
    torch.cuda.synchronize()
    assert fa.flash_bwd_dq.launches == before + 2
    zeroed = dq.clone()
    zeroed[:, -64:] = 0
    err, err_zeroed = fa.row_scaled_err(dq, dq_ref), fa.row_scaled_err(zeroed, dq_ref)
    assert torch.isfinite(dq.float()).all()
    assert err <= ROW_TOL < err_zeroed, (err, err_zeroed)
    assert torch.equal(dq, again)


@pytest.mark.parametrize("D, causal, key, col", FLASH_ONE_HOT)
def test_flash_dq_one_hot_k_pins_dq(cuda, D, causal, key, col):
    """k one-hot at (key, col): dq[query] = ds(query, key) k[key] lies in
    column ``col`` of the query rows that admit the key, exactly 0
    elsewhere; so dS K reads K's rows and columns (MN-major) where they
    lie."""
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    B, S, H = 2, 256, 2
    g = torch.Generator(device=cuda).manual_seed(key + 2)
    k = _one_hot(cuda, (B, S, H, D), key, col)
    q, v, do = (torch.randn(B, S, H, D, generator=g, device=cuda).to(torch.bfloat16)
                for _ in range(3))
    o_ref, lse = fa.flash_fwd_ref(q.float(), k.float(), v.float(), None, causal)
    delta = fa.flash_delta(o_ref.to(torch.bfloat16), do)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, None, causal)
    dq_ref = fa.flash_bwd_dq_ref(q, k, v, do, lse, delta, None, causal)
    torch.cuda.synchronize()
    _, queries = _admitted(S, causal, key, cuda)
    outside = torch.ones(B, S, H, D, dtype=torch.bool, device=cuda)
    outside[:, :, :, col] = ~queries[None, :, None]
    assert (dq[outside] == 0).all() and (dq_ref[outside] == 0).all()
    assert (dq[~outside] != 0).any()
    assert fa.row_scaled_err(dq, dq_ref) <= ROW_TOL


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
@pytest.mark.parametrize("rows,D,dtype", [
    (8192, 2048, torch.bfloat16), (37, 64, torch.bfloat16), (5, 4104, torch.bfloat16),
    (33, 2048, torch.float32), (8192, 2048, torch.float32), (4096, 4096, torch.bfloat16),
    (4096, 4096, torch.float32), (3, 4096, torch.bfloat16)])
def test_rms_kernel_matches_plain(cuda, rows, D, dtype):
    """Within one unit in the last place of the output dtype at each
    element's magnitude (the kernel's output rounding, and rsqrtf's
    2-ulp fp32 error far below it), against the plain version in fp32.
    The models' widths (2048, 4096) take the register-held instances, with
    rows by grid stride (8192 rows) or fewer rows than warps (3); the
    others the general one."""
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


def _zero_cols(t):
    """``t`` with one 64-column tile zeroed in every row (the middle one)."""
    z = t.clone()
    c = (t.shape[-1] // 64 // 2) * 64
    z[..., c:c + 64] = 0
    return z


def _unaligned(x):
    """``x``'s values at a base one element into a buffer: what TMA cannot
    read, so K4 takes its general design."""
    xm = torch.empty(x.numel() + 8, dtype=x.dtype, device=x.device)[1:1 + x.numel()]
    xm = xm.view(x.shape)
    xm.copy_(x)
    return xm


def _one_hot_rows(M, K, device):
    """M one-hot rows over K (row i picks weight row (7919 i) % K) → (x, picks)."""
    picks = (torch.arange(M, device=device) * 7919) % K
    x = torch.zeros(M, K, device=device, dtype=torch.bfloat16)
    x[torch.arange(M, device=device), picks] = 1
    return x, picks


def _k4_check(cuda, fn, want, x, w_bf16, instance, kernel):
    """One K4 case: the design k4_design names is the one launched, within
    QUANT_TOL of ``want`` (a zeroed 64-column tile rejected), two runs the
    same bits, M one-hot rows through that design giving the weight's rows
    exactly, and the general design taken, and right, at an unaligned base
    of x."""
    from deepspeed_tpu_torch.ops.kernels import fused_quant_matmul as fq
    from deepspeed_tpu_torch.ops.kernels.flash_attention import row_scaled_err
    inst = "dense" if instance == "bf16" else "quant"
    (M, K), N = x.shape, w_bf16.shape[1]
    design = fq.k4_design(instance, M, K, N, x.data_ptr(), 0)
    before = kernel.launches, dict(fq.k4_design_launches[inst])
    got = fn(x)
    torch.cuda.synchronize()
    grew = {k: v - before[1][k] for k, v in fq.k4_design_launches[inst].items()}
    assert kernel.launches == before[0] + 1 and grew == {d: int(d == design) for d in grew}, grew
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    err, bad = row_scaled_err(got, want), row_scaled_err(_zero_cols(got), want)
    assert err <= QUANT_TOL < bad, (design, err, bad)
    assert torch.equal(fn(x), got)  # no atomics on outputs: the same bits every run
    eye, picks = _one_hot_rows(M, K, cuda)
    assert torch.equal(fn(eye), w_bf16[picks])
    xu = _unaligned(x)
    assert fq.k4_design(instance, M, K, N, xu.data_ptr(), 0) == "general"
    before = fq.k4_design_launches[inst]["general"]
    assert row_scaled_err(fn(xu), want) <= QUANT_TOL
    assert fq.k4_design_launches[inst]["general"] == before + 1
    return design


# K4 through carriers: the small shapes beside Mixtral-8x7B's attention
# projections, MLP widths and head (group 500), at decode (8 rows: the
# decode design, K split by (N, K)), a 37-row and a 264-row prefill chunk
# (the prefill design, K split over blocks where the tiles leave SMs idle).
QMM_CASES = [
    (1, 64, 64, 64),        # M = 1, N = one group
    (37, 100, 20, 20),      # odd M and K; fp6 rows of 15 bytes, N < one tile: general
    (8, 4096, 1024, 512),   # decode, the K loop split over blocks
    (16, 320, 200, 8),      # group 8 (the router's), N past a tile edge
    (264, 256, 4096, 512),  # a prefill chunk
] + [(M, K, N, 512) for K, N in ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096))
     for M in (8, 37, 264)] + [(M, 4096, 32000, 500) for M in (8, 37, 264)]


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("M,K,N,group", QMM_CASES)
def test_quant_matmul_kernel_matches_plain(cuda, scheme, M, K, N, group):
    from deepspeed_tpu_torch.ops.kernels.fused_quant_matmul import (quant_matmul,
                                                                     quant_matmul_ref)
    q = _carrier((K, N), scheme, group, cuda, M + K)
    x = torch.randn(M, K, generator=torch.Generator(cuda).manual_seed(1),
                    device=cuda).to(torch.bfloat16)
    want = quant_matmul_ref(x, q.values, q.scales, scheme).float()
    w_bf16 = q.dequantized(torch.bfloat16)
    design = _k4_check(cuda, lambda a: quant_matmul(a, q.values, q.scales, scheme), want, x,
                       w_bf16, scheme, quant_matmul)
    if K >= 4096:  # the Hopper designs at Mixtral's shapes
        assert design == ("stream" if M <= 16 else "wgmma")
    eye = torch.eye(K, device=cuda, dtype=torch.bfloat16)  # every weight row, exactly
    assert torch.equal(quant_matmul(eye, q.values, q.scales, scheme), w_bf16)


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
        design = gm.wgmma_design(tm, K, N, xp.data_ptr(), w.data_ptr())
        counts = gm.gmm_fwd_design_launches
    else:
        q = _carrier((E, K, N), scheme, 4 if N % 8 else 8, cuda, 3)
        kernel = gm.gmm_quant
        fn = (lambda x: gm.gmm_quant(x, q.values, q.scales, te, scheme, torch.bfloat16, tm, used))
        want = gm.gmm_quant_ref(xp, q.values, q.scales, te, scheme, torch.bfloat16, tm, used)
        design = gm.quant_design(scheme, tm, K, N, xp.data_ptr(), q.values.data_ptr())
        counts = gm.gmm_quant_design_launches
    before = kernel.launches, dict(counts)
    got = fn(xp)
    torch.cuda.synchronize()
    assert kernel.launches == before[0] + 1
    grew = {k: v - before[1][k] for k, v in counts.items()}
    assert grew == {d: int(d == design) for d in grew}, grew
    n_used = int(used) * tm
    assert not got[n_used:].any()  # tiles without rows are written as zeros
    err = row_scaled_err(got[:n_used], want[:n_used].float())
    assert err <= QUANT_TOL, f"row_scaled_err {err}"


# gmm_quant's Hopper designs at Mixtral's expert stacks, w1 [8, 4096,
# 14336] and w2 [8, 14336, 4096], under serving's routings (expert 7
# empty): decode, 8 tokens top-2 over 16-row tiles (the decode design),
# and a 264-token prefill chunk, 528 rows over 64-row tiles (the
# forward ring). Each: within QUANT_TOL of the plain version (fp32 over the
# same bf16 weights), a zeroed 64-row tile rejected, two runs equal bit for
# bit, zeros past the used tiles, one-hot rows over all of K reproducing
# ``dequantize_grouped`` exactly (at 16-row tiles, 128-row items: the
# widest x operand), and the first design taken at x's unaligned base,
# counted by design in ``gmm_quant_design_launches``.
MIXTRAL_QUANT_CASES = [("decode", 4096, 14336), ("decode", 14336, 4096),
                       ("prefill", 4096, 14336), ("prefill", 14336, 4096)]


def _serving_sizes(case):
    rng = np.random.RandomState(3)
    tokens = 8 if case == "decode" else 264
    idx = np.concatenate([rng.choice(7, 2, replace=False) for _ in range(tokens)])
    return tuple(np.bincount(idx, minlength=8).tolist())


def _quant_run(x, q, te, used, tm, scheme):
    """One ``gmm_quant`` launch → (output, the design it was counted on)."""
    from deepspeed_tpu_torch.ops.kernels import grouped_matmul as gm
    before = gm.gmm_quant.launches, dict(gm.gmm_quant_design_launches)
    got = gm.gmm_quant(x, q.values, q.scales, te, scheme, torch.bfloat16, tm, used)
    torch.cuda.synchronize()
    assert gm.gmm_quant.launches == before[0] + 1
    grew = {k: v - before[1][k] for k, v in gm.gmm_quant_design_launches.items()}
    assert sorted(grew.values()) == [0, 0, 1], grew
    return got, max(grew, key=grew.get)


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("case,K,N", MIXTRAL_QUANT_CASES)
def test_gmm_quant_designs_match_plain(cuda, scheme, case, K, N):
    from deepspeed_tpu_torch.ops.kernels import grouped_matmul as gm
    from deepspeed_tpu_torch.ops.kernels.flash_attention import row_scaled_err
    from deepspeed_tpu_torch.ops.kernels.fused_quant_matmul import dequantize_grouped
    sizes, tm = _serving_sizes(case), 16 if case == "decode" else 64
    assert sizes[7] == 0
    xp, te, used = _gmm_case(sizes, K, tm, cuda, 21)
    q = _carrier((8, K, N), scheme, 512, cuda, 22)
    design = "stream" if tm == 16 else "wgmma"
    assert gm.quant_design(scheme, tm, K, N, xp.data_ptr(), q.values.data_ptr()) == design
    got, d1 = _quant_run(xp, q, te, used, tm, scheme)
    again, d2 = _quant_run(xp, q, te, used, tm, scheme)
    assert d1 == d2 == design
    want = gm.gmm_quant_ref(xp.float(), q.values, q.scales, te, scheme, torch.bfloat16, tm, used)
    assert got.dtype == torch.bfloat16 and got.shape == (xp.shape[0], N)
    assert torch.equal(got, again)  # each output written once: the same bits every run
    n_used = int(used) * tm
    assert not got[n_used:].any()
    err = row_scaled_err(got[:n_used], want[:n_used])
    bad_err = row_scaled_err(_zero_tile(got[:n_used]), want[:n_used])
    assert err <= QUANT_TOL and bad_err > 10 * QUANT_TOL, (err, bad_err)
    # the first design at x's unaligned base: the same values
    xm = torch.empty(xp.numel() + 8, dtype=torch.bfloat16, device=cuda)[1:1 + xp.numel()]
    xm = xm.view(xp.shape)
    xm.copy_(xp)
    first, d3 = _quant_run(xm, q, te, used, tm, scheme)
    assert d3 == "general"
    assert row_scaled_err(first[:n_used], want[:n_used]) <= QUANT_TOL
    assert not first[n_used:].any()
    del xp, xm, got, again, want, first
    # one-hot rows over all of K through expert 5
    one = [0] * 8
    one[5] = K
    xp, te, used = _gmm_case(one, K, tm, cuda, 0)
    xp[:K] = torch.eye(K, device=cuda, dtype=torch.bfloat16)
    got, d4 = _quant_run(xp, q, te, used, tm, scheme)
    assert d4 == design
    assert torch.equal(got[:K], dequantize_grouped(q.values[5], q.scales[5], scheme,
                                                   torch.bfloat16))
    assert not got[K:].any()


# The backward kernels of K5 against their plain versions on the same bf16
# inputs: dW sums fp32 products in another order and rounds once to bf16
# (at most 1 unit of ``row_scaled_err`` against an fp32 reference), dx
# likewise over the same bf16 weights; every check must reject the output
# with one 64 x 64 tile zeroed.
BWD_CASES = [
    ((70, 0, 33, 1), 128, 200, 64),              # an empty expert; N past a tile edge
    ((2, 0, 5, 1, 3, 0, 2, 3), 256, 512, 16),   # decode-sized groups, two experts empty
    ((0, 0, 40, 0), 96, 136, 16),                # every row on one expert
    ((300, 20, 0, 200), 512, 384, 64),           # several tiles an expert
]


def _zero_tile(t):
    z = t.clone()
    flat = z.reshape(-1, z.shape[-1])
    r, c = (flat.shape[0] // 64 // 2) * 64, (flat.shape[1] // 64 // 2) * 64
    flat[r:r + 64, c:c + 64] = 0
    return z


@pytest.mark.parametrize("sizes,K,N,tm", BWD_CASES)
def test_gmm_dw_kernel_matches_plain(cuda, sizes, K, N, tm):
    from deepspeed_tpu_torch.ops.kernels import grouped_matmul as gm
    from deepspeed_tpu_torch.ops.kernels.flash_attention import row_scaled_err
    xp, te, used = _gmm_case(sizes, K, tm, cuda, 5)
    dy, _, _ = _gmm_case(sizes, N, tm, cuda, 6)
    E = len(sizes)
    before = gm.gmm_dw.launches, dict(gm.gmm_dw_design_launches)
    got = gm.gmm_dw(xp, dy, te, E, tm, used)
    again = gm.gmm_dw(xp, dy, te, E, tm, used)
    want = gm.gmm_dw_ref(xp, dy, te, E, tm, used, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert gm.gmm_dw.launches == before[0] + 2
    design = gm.wgmma_design(tm, K, N, xp.data_ptr(), dy.data_ptr())
    grew = {k: v - before[1][k] for k, v in gm.gmm_dw_design_launches.items()}
    assert grew == {d: 2 * (d == design) for d in grew}, grew
    assert got.dtype == torch.bfloat16 and got.shape == (E, K, N)
    assert torch.equal(got, again)  # no atomics: the same bits every run
    for e, n in enumerate(sizes):
        if n == 0:
            assert not got[e].any(), f"expert {e} has no rows"
    err = row_scaled_err(got, want)
    busy = int(np.argmax(sizes))
    bad = got.clone()
    bad[busy] = _zero_tile(got[busy])
    assert err <= QUANT_TOL and row_scaled_err(bad, want) > 10 * QUANT_TOL, err


# Shapes that take the wgmma forward and dW designs (64-row tiles, K % 8
# and N % 8): odd tile counts an expert, empty experts, used tiles below
# the layout's, K not a multiple of 128 (a second consumer idle past K in
# dW, a ragged contraction in the forward) and N not a multiple of 256
# (boxes partly and wholly past N).
WGMMA_CASES = [
    ((200, 0, 130, 70, 65), 640, 320),
    ((0, 300, 0, 0), 256, 1024),
    ((37, 0, 90, 5, 0, 16), 384, 264),
    ((129, 64, 1), 72, 136),
]


@pytest.mark.parametrize("tm", (16, 64))
@pytest.mark.parametrize("seed", range(4))
def test_table_kernels_match_plain(cuda, seed, tm):
    """The wgmma designs' work list, built by a one-thread kernel, equals
    its plain version (torch ops on the card) bit for bit: skewed routings
    with empty experts, every tile used and the used tiles cut short, and
    no rows at all; one launch each."""
    from deepspeed_tpu_torch.ops.kernels import grouped_matmul as gm
    rng = np.random.RandomState(seed)
    p = rng.dirichlet(np.full(8, 0.7))
    p[rng.rand(8) < 0.25] = 0.0
    p = p / p.sum() if p.any() else np.full(8, 1 / 8)
    sizes = torch.from_numpy(np.bincount(rng.choice(8, 2000, p=p), minlength=8)).to(cuda)
    for s in (sizes, torch.zeros_like(sizes)):
        _, te, _ = gm.tile_layout(s, int(s.sum()), tm)
        full = gm.used_tiles(s, tm)
        for used in (full, full // 3, full * 0):
            before = gm.gmm_plan.launches
            plan = gm.gmm_plan(te, used, tm, 8)
            assert gm.gmm_plan.launches == before + 1
            assert torch.equal(plan, gm.gmm_plan_ref(te, used, tm, 8))


@pytest.mark.parametrize("sizes,K,N", WGMMA_CASES)
def test_gmm_wgmma_forward_matches_plain(cuda, sizes, K, N):
    """The forward over a bf16 stack at 64-row tiles on the wgmma design:
    two runs equal bit for bit, zeros past the used tiles, within
    QUANT_TOL of the plain version, a zeroed tile rejected."""
    from deepspeed_tpu_torch.ops.kernels import grouped_matmul as gm
    from deepspeed_tpu_torch.ops.kernels.flash_attention import row_scaled_err
    xp, te, used = _gmm_case(sizes, K, 64, cuda, 13)
    assert int(used) < xp.shape[0] // 64
    E = len(sizes)
    w = (torch.randn(E, K, N, generator=torch.Generator(cuda).manual_seed(4), device=cuda)
         * 0.05).to(torch.bfloat16)
    assert gm.wgmma_design(64, K, N, xp.data_ptr(), w.data_ptr()) == "wgmma"
    before = gm.gmm.launches, dict(gm.gmm_fwd_design_launches)
    got, again = gm.gmm(xp, w, te, 64, used), gm.gmm(xp, w, te, 64, used)
    want = gm.gmm_ref(xp.float(), w.float(), te, 64, used)
    torch.cuda.synchronize()
    assert gm.gmm.launches == before[0] + 2
    grew = {k: v - before[1][k] for k, v in gm.gmm_fwd_design_launches.items()}
    assert grew == {"wgmma": 2, "general": 0}, grew
    assert got.dtype == torch.bfloat16 and got.shape == (xp.shape[0], N)
    assert torch.equal(got, again)
    n_used = int(used) * 64
    assert not got[n_used:].any()
    err = row_scaled_err(got[:n_used], want[:n_used])
    bad_err = row_scaled_err(_zero_tile(got[:n_used]), want[:n_used])
    assert err <= QUANT_TOL and bad_err > 10 * QUANT_TOL, (err, bad_err)


@pytest.mark.parametrize("K,N", [(320, 264), (72, 136)])
def test_gmm_wgmma_forward_one_hot_rows_reproduce_the_stack(cuda, K, N):
    """One-hot x rows each read one row of W: the forward over expert 1's
    rows must be W[1] bit for bit (W read across its rows, MN-major)."""
    from deepspeed_tpu_torch.ops.kernels import grouped_matmul as gm
    xp, te, used = _gmm_case((64, K), K, 64, cuda, 0)
    xp[64:64 + K] = torch.eye(K, device=cuda, dtype=torch.bfloat16)
    w = torch.randn(2, K, N, generator=torch.Generator(cuda).manual_seed(9),
                    device=cuda).to(torch.bfloat16)
    before = gm.gmm_fwd_design_launches["wgmma"]
    got = gm.gmm(xp, w, te, 64, used)
    torch.cuda.synchronize()
    assert gm.gmm_fwd_design_launches["wgmma"] == before + 1
    assert torch.equal(got[64:64 + K], w[1])


@pytest.mark.parametrize("sizes,K,N", WGMMA_CASES)
def test_gmm_dw_wgmma_design_matches_plain(cuda, sizes, K, N):
    """dW at 64-row tiles on the wgmma design: two runs equal bit for bit,
    the empty experts' dW zero, within QUANT_TOL of the plain version, a
    zeroed tile rejected."""
    from deepspeed_tpu_torch.ops.kernels import grouped_matmul as gm
    from deepspeed_tpu_torch.ops.kernels.flash_attention import row_scaled_err
    xp, te, used = _gmm_case(sizes, K, 64, cuda, 15)
    dy, _, _ = _gmm_case(sizes, N, 64, cuda, 16)
    E = len(sizes)
    assert gm.wgmma_design(64, K, N, xp.data_ptr(), dy.data_ptr()) == "wgmma"
    before = dict(gm.gmm_dw_design_launches)
    got, again = gm.gmm_dw(xp, dy, te, E, 64, used), gm.gmm_dw(xp, dy, te, E, 64, used)
    want = gm.gmm_dw_ref(xp, dy, te, E, 64, used, out_dtype=torch.float32)
    torch.cuda.synchronize()
    grew = {k: v - before[k] for k, v in gm.gmm_dw_design_launches.items()}
    assert grew == {"wgmma": 2, "general": 0}, grew
    assert got.dtype == torch.bfloat16 and got.shape == (E, K, N)
    assert torch.equal(got, again)
    for e, n in enumerate(sizes):
        if n == 0:
            assert not got[e].any(), f"expert {e} has no rows"
    err = row_scaled_err(got, want)
    busy = int(np.argmax(sizes))
    bad = got.clone()
    bad[busy] = _zero_tile(got[busy])
    assert err <= QUANT_TOL and row_scaled_err(bad, want) > 10 * QUANT_TOL, err


@pytest.mark.parametrize("K,N", [(320, 264), (72, 136)])
def test_gmm_dw_wgmma_one_hot_rows_reproduce_dy(cuda, K, N):
    """One-hot x rows each place one dy row: with expert 1's x rows the
    identity, its dW must be its dy rows bit for bit (x read transposed,
    MN-major), and zero past them."""
    from deepspeed_tpu_torch.ops.kernels import grouped_matmul as gm
    rows = min(K, 128)
    xp, te, used = _gmm_case((64, rows), K, 64, cuda, 0)
    dy, _, _ = _gmm_case((64, rows), N, 64, cuda, 1)
    xp[64:64 + rows] = torch.eye(rows, K, device=cuda, dtype=torch.bfloat16)
    before = gm.gmm_dw_design_launches["wgmma"]
    got = gm.gmm_dw(xp, dy, te, 2, 64, used)
    torch.cuda.synchronize()
    assert gm.gmm_dw_design_launches["wgmma"] == before + 1
    assert torch.equal(got[1, :rows], dy[64:64 + rows])
    assert not got[1, rows:].any()


def _dx_run(dy, te, used, tm, scheme, K, N, E, group, device):
    """gmm's dx (bf16) or ``gmm_quant_dx`` (carriers) over a seeded stack,
    twice → (kernel, run 1, run 2, plain version in fp32, design the
    wrapper's predicate names)."""
    from deepspeed_tpu_torch.ops.kernels import grouped_matmul as gm
    if scheme == "bf16":
        w = (torch.randn(E, K, N, generator=torch.Generator(device).manual_seed(2),
                         device=device) * 0.05).to(torch.bfloat16)
        runs = [gm.gmm_transposed(dy, w, te, tm, used) for _ in range(2)]
        want = gm.gmm_transposed_ref(dy.float(), w.float(), te, tm, used)
        return gm.gmm, runs, want, gm.dx_design(scheme, N, dy.data_ptr(), w.data_ptr())
    q = _carrier((E, K, N), scheme, group, device, 3)
    runs = [gm.gmm_quant_dx(dy, q.values, q.scales, te, scheme, torch.bfloat16, tm, used)
            for _ in range(2)]
    want = gm.gmm_quant_dx_ref(dy.float(), q.values, q.scales, te, scheme, torch.bfloat16, tm,
                               used)
    return gm.gmm_quant_dx, runs, want, gm.dx_design(scheme, N, dy.data_ptr(),
                                                      q.values.data_ptr())


def _check_dx(dy, te, used, tm, scheme, K, N, E, group, device, design=None):
    """Both runs equal bit for bit, zeros past the used tiles, within
    QUANT_TOL of the plain version, a zeroed tile rejected, and two
    launches counted, on the design the predicate names (``design`` when
    given)."""
    from deepspeed_tpu_torch.ops.kernels import grouped_matmul as gm
    from deepspeed_tpu_torch.ops.kernels.flash_attention import row_scaled_err
    kernel = gm.gmm if scheme == "bf16" else gm.gmm_quant_dx
    before = kernel.launches, dict(gm.gmm_dx_design_launches)
    kernel, (got, again), want, predicted = _dx_run(dy, te, used, tm, scheme, K, N, E, group,
                                                    device)
    torch.cuda.synchronize()
    assert design is None or predicted == design
    assert kernel.launches == before[0] + 2
    grew = {k: v - before[1][k] for k, v in gm.gmm_dx_design_launches.items()}
    assert grew == {d: 2 * (d == predicted) for d in grew}, grew
    assert got.dtype == torch.bfloat16 and got.shape == (dy.shape[0], K)
    assert torch.equal(got, again)  # each output written once: the same bits every run
    n_used = int(used) * tm
    assert not got[n_used:].any()
    err = row_scaled_err(got[:n_used], want[:n_used])
    bad_err = row_scaled_err(_zero_tile(got[:n_used]), want[:n_used])
    assert err <= QUANT_TOL and bad_err > 10 * QUANT_TOL, (err, bad_err)


@pytest.mark.parametrize("scheme", ("bf16",) + SCHEMES)
@pytest.mark.parametrize("sizes,K,N,tm", BWD_CASES)
def test_grouped_dx_kernels_match_plain(cuda, scheme, sizes, K, N, tm):
    """``gmm_transposed`` (bf16, counted as ``gmm``) and ``gmm_quant_dx``
    (carriers): zeros past the used tiles, within QUANT_TOL of the plain
    version, a zeroed tile rejected, two runs equal, on the design the
    shape predicate names (TMA-aligned rows take the wgmma design)."""
    dy, te, used = _gmm_case(sizes, N, tm, cuda, 7)
    _check_dx(dy, te, used, tm, scheme, K, N, len(sizes), 4 if N % 8 else 8, cuda)


# Shapes that take the wgmma design at every scheme (rows a multiple of 64
# columns): odd tile counts an expert (one-tile items), an empty expert,
# used tiles below the layout's, K not a multiple of the 256-column block,
# group widths that are and are not a multiple of 16 (one scale per row
# and step, or one per element), and 16-row tiles taken 8 to an item.
WGMMA_DX_CASES = [
    ((200, 0, 130, 70, 65), 640, 320, 64, 64),
    ((200, 0, 130, 70, 65), 640, 320, 64, 40),
    ((37, 0, 90, 5, 0, 16), 384, 256, 16, 32),
    ((0, 300, 0, 0), 256, 1024, 64, 512),
]


@pytest.mark.parametrize("scheme", ("bf16",) + SCHEMES)
@pytest.mark.parametrize("sizes,K,N,tm,group", WGMMA_DX_CASES)
def test_grouped_dx_wgmma_design_matches_plain(cuda, scheme, sizes, K, N, tm, group):
    dy, te, used = _gmm_case(sizes, N, tm, cuda, 11)
    assert int(used) < dy.shape[0] // tm
    _check_dx(dy, te, used, tm, scheme, K, N, len(sizes), group, cuda, design="wgmma")


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("group", (64, 40))
def test_grouped_dx_wgmma_decodes_exactly(cuda, scheme, group):
    """One-hot dy rows each read one weight: dx over expert 1's rows must be
    its carriers as ``dequantize_grouped`` decodes them to bf16, transposed,
    bit for bit (a group of 64: one scale a row and step; of 40: one an
    element)."""
    from deepspeed_tpu_torch.ops.kernels import grouped_matmul as gm
    from deepspeed_tpu_torch.ops.kernels.fused_quant_matmul import dequantize_grouped
    K, N = 320, 320
    dy, te, used = _gmm_case((64, N), N, 64, cuda, 0)
    dy[64:64 + N] = torch.eye(N, device=cuda, dtype=torch.bfloat16)
    q = _carrier((2, K, N), scheme, group, cuda, 4)
    before = gm.gmm_dx_design_launches["wgmma"]
    got = gm.gmm_quant_dx(dy, q.values, q.scales, te, scheme, torch.bfloat16, 64, used)
    torch.cuda.synchronize()
    assert gm.gmm_dx_design_launches["wgmma"] == before + 1
    want = dequantize_grouped(q.values[1], q.scales[1], scheme, torch.bfloat16).t()
    assert torch.equal(got[64:64 + N], want)


def test_grouped_backward_kernels_refuse_what_they_cannot_take(cuda):
    from deepspeed_tpu_torch.ops.kernels import grouped_matmul as gm
    xp, te, used = _gmm_case((3, 5), 64, 16, cuda, 0)
    w = torch.zeros(2, 32, 64, device=cuda, dtype=torch.bfloat16)
    q = _carrier((2, 32, 64), "int8", 32, cuda, 1)
    counts = [gm.gmm.launches, gm.gmm_dw.launches, gm.gmm_quant_dx.launches]
    with pytest.raises(TypeError):
        gm.gmm_dw(xp.float(), xp.float(), te, 2, 16, used)      # fp32: no fallback
    with pytest.raises(ValueError):
        gm.gmm_dw(xp, xp, te, 2, 32, used)                      # a tile it is not built for
    with pytest.raises(ValueError):
        gm.gmm_transposed(xp, w.float(), te, 16, used)
    with pytest.raises(ValueError):
        gm.gmm_transposed(xp[:, :32], w, te, 16, used)          # a strided dy
    with pytest.raises(TypeError):
        gm.gmm_quant_dx(xp, q.values, q.scales, te, "int8", torch.float32, 16, used)
    with pytest.raises(ValueError):
        gm.gmm_quant_dx(xp, q.values.cpu(), q.scales, te, "int8", torch.bfloat16, 16, used)
    assert [gm.gmm.launches, gm.gmm_dw.launches, gm.gmm_quant_dx.launches] == counts


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


# The mma design (bf16, K % 512, N and r % 8, 16-byte rows: the serving
# path's), at x's aligned base: held to the same bound, a zeroed slot
# rejected, two runs equal, and each call counted on the design
# ``lora_design`` names.
LORA_MMA_CASES = {
    # name: (T, K, N, S, r, slots)
    "decode_q_r8": (16, 4096, 4096, 9, 8, "rr"),
    "decode_k_r16": (16, 4096, 1024, 9, 16, "rr"),
    "chunk_q_r8": (512, 4096, 4096, 9, 8, "rr"),
    "chunk_k_r16": (512, 4096, 1024, 9, 16, "rr"),
    "r24_in_bucket32_n1000": (37, 512, 1000, 5, 24, "rr"),
    "rank64_one": (33, 512, 512, 3, 64, "one"),
    "k512_n8": (20, 512, 8, 4, 8, "rr"),
}


@pytest.mark.parametrize("case", sorted(LORA_MMA_CASES))
def test_lora_mma_design_matches_plain(cuda, case):
    from deepspeed_tpu_torch.ops.kernels.flash_attention import row_scaled_err
    from deepspeed_tpu_torch.ops.kernels.lora_matmul import (apply_lora_delta, lora_delta,
                                                             lora_delta_ref,
                                                             lora_design_launches, lora_layout)
    T, K, N, S, r, kind = LORA_MMA_CASES[case]
    x, slots, a, b, scales = _lora_case(cuda, T, K, N, S, r, torch.bfloat16, kind, seed=4)
    before = dict(lora_design_launches)
    got = apply_lora_delta(x, slots, a, b, scales)
    want = lora_delta_ref(x, slots, a, b, scales)
    torch.cuda.synchronize()
    assert {d: lora_design_launches[d] - before[d] for d in before} == {"mma": 1, "general": 0}
    base = slots == 0
    assert not got[base].any()
    err = row_scaled_err(got[~base], want[~base].float())
    assert err <= LORA_TOL, f"row_scaled_err {err}"
    zeroed = got.clone()
    zeroed[slots == slots[~base][0]] = 0
    assert row_scaled_err(zeroed[~base], want[~base].float()) > LORA_TOL
    assert torch.equal(apply_lora_delta(x, slots, a, b, scales), got)
    y = torch.randn(T, N, generator=torch.Generator(cuda).manual_seed(9), device=cuda).to(
        torch.bfloat16)
    fused = lora_delta(x, y.clone(), a, b, scales, lora_layout(slots, S))
    assert torch.equal(fused, (y.float() + got.float()).to(torch.bfloat16))
    first = lora_delta(x, torch.zeros_like(got), a, b, scales, lora_layout(slots, S),
                       design="general")
    assert row_scaled_err(first[~base], want[~base].float()) <= LORA_TOL


def test_lora_design_predicate_and_forced_designs(cuda):
    from deepspeed_tpu_torch.ops.kernels.lora_matmul import (lora_delta, lora_design,
                                                             lora_design_launches, lora_layout)
    assert lora_design(torch.bfloat16, 4096, 4096, 8, 0, 16, 32, 48, 4096, 4096) == "mma"
    assert lora_design(torch.float32, 4096, 4096, 8, 0, 16, 32, 48, 4096, 4096) == "general"
    x, slots, a, b, scales = _lora_case(cuda, 8, 512, 32, 3, 8, torch.float32, "rr")
    y = torch.zeros(8, 32, device=cuda)
    with pytest.raises(ValueError):  # fp32: the mma design does not take it
        lora_delta(x, y, a, b, scales, lora_layout(slots, 3), design="mma")
    x, slots, a, b, scales = _lora_case(cuda, 8, 512, 32, 3, 8, torch.bfloat16, "rr", offset=1)
    y = torch.zeros(8, 32, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):  # x 2 bytes off a 16-byte boundary
        lora_delta(x, y, a, b, scales, lora_layout(slots, 3), design="mma")
    with pytest.raises(ValueError):
        lora_delta(x, y, a, b, scales, lora_layout(slots, 3), design="other")
    before = dict(lora_design_launches)
    lora_delta(x, y, a, b, scales, lora_layout(slots, 3))
    assert lora_design_launches["general"] == before["general"] + 1


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


# ------------------------------------------------------------ K7: int8 quantize
K7_CASES = {  # name: (shape, group, dtype, stochastic)
    "slab_bf16_n1": ((32, 1, 32, 8, 128), 0, torch.bfloat16, False),
    "slab_bf16_n16": ((32, 16, 32, 8, 128), 0, torch.bfloat16, False),
    "g2048_bf16_n16": ((32, 16, 32, 8, 128), 2048, torch.bfloat16, False),
    "slab_fp32_n4": ((32, 4, 32, 8, 128), 0, torch.float32, False),
    "g64_bf16": ((4, 3, 16, 2, 64), 64, torch.bfloat16, False),
    "g256_padded_fp32": ((1000,), 256, torch.float32, False),
    "g1000_fp32_scalar": ((3, 1000), 1000, torch.float32, False),
    "g65536_fp32_unstaged": ((4, 65536), 65536, torch.float32, False),
    "slab_bf16_stochastic": ((32, 4, 32, 8, 128), 0, torch.bfloat16, True),
    "g64_fp32_stochastic": ((4, 3, 16, 2, 64), 64, torch.float32, True),
}


def _k7_input(cuda, shape, dtype, seed=0):
    g = torch.Generator(cuda).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=cuda) * 3
    x.view(-1)[: x.numel() // 7] = 0  # zeros, and with small groups whole zero groups
    return x.to(dtype)


@pytest.mark.parametrize("case", sorted(K7_CASES))
def test_int8_quant_kernels_match_plain_bitwise(cuda, case):
    from deepspeed_tpu_torch.ops.kernels import quantization as tq
    shape, group, dtype, stochastic = K7_CASES[case]
    x = _k7_input(cuda, shape, dtype)
    gs = group or int(np.prod(shape[2:]))
    before = (tq.quantize_int8.launches, tq.dequantize_int8.launches)
    v, s, sh = tq.quantize_int8(x, gs, stochastic=stochastic, seed=5)
    groups, _ = tq._group_view(x, gs)
    rv, rs = tq.quantize_int8_ref(groups, stochastic, 5)
    assert torch.equal(v, rv), f"{int((v != rv).sum())} codes differ"
    assert torch.equal(s.view(torch.int32), rs.view(torch.int32))
    for out in (torch.bfloat16, torch.float32):
        d = tq.dequantize_int8(v, s, sh, dtype=out)
        want = tq.dequantize_int8_ref(v, s, out).reshape(-1)[:x.numel()].reshape(sh)
        assert torch.equal(d, want)
    assert (tq.quantize_int8.launches - before[0], tq.dequantize_int8.launches - before[1]) \
        == (1, 2)
    flipped = v.clone()
    flipped.view(-1)[v.numel() // 2] ^= 1
    assert not torch.equal(flipped, rv)  # the exact comparison sees one code


def test_int8_quant_kernel_on_unaligned_view(cuda):
    from deepspeed_tpu_torch.ops.kernels import quantization as tq
    base = _k7_input(cuda, (4 * 2048 + 1,), torch.bfloat16)
    x = base[1:]  # 2 bytes off the 16-byte alignment: the element path
    v, s, _ = tq.quantize_int8(x, 2048)
    rv, rs = tq.quantize_int8_ref(x.reshape(-1, 2048))
    assert torch.equal(v, rv) and torch.equal(s, rs)


# K7's quantize designs: the cluster design at groups its slices divide and
# do not (8200 bf16 values: 1025 units over 4 blocks; 40008: 5001 over 8;
# 4104: 513 over 2), at its largest group (65536 fp32: 4 units a thread),
# stochastic, and at a demotion's 64 slabs; the two-pass design where the
# groups fill the card (512 slabs) or are too large; a warp group
K7_DESIGN_CASES = {  # name: (groups, group size, dtype, stochastic, design k7_design names)
    "cluster_bf16_8200": (3, 8200, torch.bfloat16, False, "cluster"),
    "cluster_bf16_40008": (2, 40008, torch.bfloat16, False, "cluster"),
    "cluster_fp32_65536": (2, 65536, torch.float32, False, "cluster"),
    "cluster_fp32_4104_stochastic": (5, 4104, torch.float32, True, "cluster"),
    "cluster_bf16_slab_stochastic": (64, 32768, torch.bfloat16, True, "cluster"),
    "two_pass_bf16_slab_512": (512, 32768, torch.bfloat16, False, "two_pass"),
    "two_pass_bf16_65544": (2, 65544, torch.bfloat16, False, "two_pass"),
    "two_pass_bf16_2048": (9, 2048, torch.bfloat16, False, "two_pass"),
    "warp_fp32_1000": (7, 1000, torch.float32, False, "warp"),
}


@pytest.mark.parametrize("case", sorted(K7_DESIGN_CASES))
def test_int8_quant_designs_match_plain_bitwise(cuda, case):
    """The design ``k7_design`` names (counted on it), the two-pass design
    forced on the same groups, and the cluster design forced where it can
    take them give the plain version's codes and scales bit for bit; two
    runs give the same bits."""
    from deepspeed_tpu_torch.ops.kernels import quantization as tq
    G, gs, dtype, stochastic, design = K7_DESIGN_CASES[case]
    x = _k7_input(cuda, (G, gs), dtype, seed=G)
    x[-1] = 0  # an all-zero group: scale 1
    assert tq.k7_design(gs, dtype, G, tq.sm_count(x.device)) == design
    forced = ["two_pass"] + (["cluster"] if tq.cluster_takes(gs, dtype) else [])
    rv, rs = tq.quantize_int8_ref(x, stochastic, 9)
    before = dict(tq.k7_design_launches)
    got = [tq.quantize_int8(x, gs, stochastic=stochastic, seed=9)[:2] for _ in range(2)]
    got += [tq.quantize_int8(x, gs, stochastic=stochastic, seed=9, design=d)[:2] for d in forced]
    torch.cuda.synchronize()
    grew = {d: n - before[d] for d, n in tq.k7_design_launches.items()}
    assert grew == {d: 2 * (d == design) + (d in forced) for d in tq.DESIGNS}
    for v, s in got:
        assert torch.equal(v, rv), f"{int((v != rv).sum())} codes differ"
        assert torch.equal(s.view(torch.int32), rs.view(torch.int32))
    assert rs[-1].item() == 1.0


def test_int8_quant_forced_design_it_cannot_take_raises(cuda):
    from deepspeed_tpu_torch.ops.kernels import quantization as tq
    x = _k7_input(cuda, (2, 65544), torch.bfloat16)
    with pytest.raises(ValueError):  # past the largest cluster's group
        tq.quantize_int8(x, 65544, design="cluster")
    with pytest.raises(ValueError):  # a group one block takes
        tq.quantize_int8(x[:, :2048], 2048, design="cluster")
    with pytest.raises(ValueError):  # 2 bytes off 16: no 16-byte vectors
        tq.quantize_int8(_k7_input(cuda, (2 * 2048 + 1,), torch.bfloat16)[1:], 2048,
                         design="cluster")
    with pytest.raises(ValueError):
        tq.quantize_int8(x, 65544, design="tiled")


def test_dequantize_rows_and_quantized_restore_match_cpu(cuda):
    from deepspeed_tpu_torch.inference.v2.ragged import BlockedKVCache
    from deepspeed_tpu_torch.ops.kernels import quantization as tq
    rng = np.random.RandomState(1)
    L, n, bs, H, D = 2, 3, 32, 8, 128
    for per_block in (1, 16):
        q = {"k": torch.from_numpy(rng.randint(-127, 128, (L, n, bs, H, D)).astype(np.int8)),
             "v": torch.from_numpy(rng.randint(-127, 128, (L, n, bs, H, D)).astype(np.int8)),
             "k_scales": torch.from_numpy(rng.rand(L, n, per_block).astype(np.float32)),
             "v_scales": torch.from_numpy(rng.rand(L, n, per_block).astype(np.float32)),
             "quantized": True}
        pools = {}
        for dev in ("cpu", cuda):
            pool = BlockedKVCache(L, 8, bs, H, D, dtype=torch.bfloat16, device=dev)
            pool.reserve(2)  # restore into ids 3, 4, 5
            before = tq.dequantize_int8.launches
            assert list(pool.restore(q)) == [3, 4, 5]
            launched = tq.dequantize_int8.launches - before
            assert launched == (2 if dev == cuda else 0)
            pools[str(dev)] = (pool.k.cpu(), pool.v.cpu())
        for a, b in zip(pools["cpu"], pools[str(cuda)]):
            assert torch.equal(a, b)


def test_int8_quant_kernels_refuse_what_they_cannot_take(cuda):
    from deepspeed_tpu_torch.ops.kernels import quantization as tq
    with pytest.raises(TypeError):
        tq.quantize_int8(torch.zeros(64, dtype=torch.float16, device=cuda), 64)
    v, s, sh = tq.quantize_int8(torch.randn(128, device=cuda), 64)
    with pytest.raises(TypeError):
        tq.dequantize_int8(v, s, sh, dtype=torch.float16)
    with pytest.raises(ValueError):
        tq.dequantize_int8_rows(v, s, torch.zeros(4, 32, device=cuda),
                                torch.zeros(2, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError):
        tq.dequantize_int8_rows(v, s.cpu(), torch.zeros(4, 64, device=cuda),
                                torch.zeros(2, dtype=torch.int32, device=cuda))


def _plain_k7(tq):
    """Pin K7's launchers to the plain versions (no launch counted)."""
    def quant(groups, stochastic, seed, design=None):
        return tq.quantize_int8_ref(groups, stochastic, seed)

    def dequant(values, scales, out, rows):
        deq = tq.dequantize_int8_ref(values, scales, out.dtype)
        if rows is None:
            out.copy_(deq)
        else:
            out[rows.long()] = deq
    return quant, dequant


def test_int8_tier_engine_on_card_matches_plain_engine(cuda, monkeypatch):
    """A 2-layer bf16 engine (8 KV heads of 128, block 32: one slab is
    Mistral-7B's 32768 values) with an int8 KV tier, under a three-phase
    trace that demotes and promotes: through K7 and with K7 pinned to its
    plain versions, the streams and a probe request's logits are
    bitwise equal; each demotion launches 2 quantize and 2 dequantize
    kernels (k and v, and their measured error) and each quantized restore
    2 dequantize kernels."""
    from deepspeed_tpu_torch.inference.v2 import (DSStateManagerConfig,
                                                  DynamicSplitFuseScheduler, InferenceEngineV2,
                                                  KVTierConfig, PrefixCacheConfig,
                                                  RaggedInferenceEngineConfig)
    from deepspeed_tpu_torch.models import init_params, llama_config
    from deepspeed_tpu_torch.ops.kernels import quantization as tq
    cfg = llama_config("debug", vocab_size=1000, hidden_size=1024, intermediate_size=2048,
                       num_attention_heads=8, num_key_value_heads=8, num_hidden_layers=2,
                       max_position_embeddings=512)
    params = init_params(cfg, cuda, torch.bfloat16, torch.Generator(cuda).manual_seed(2))
    n_req, prompt_len, new = 3, 4 * 32 + 16, 16
    per_seq = -(-(prompt_len + new) // 32)
    ecfg = RaggedInferenceEngineConfig(
        kv_block_size=32, num_kv_blocks=n_req * per_seq + 1 + 2,
        prefix_cache=PrefixCacheConfig(enabled=True),
        kv_tier=KVTierConfig(enabled=True, quantize=True, prefetch=False),
        state_manager=DSStateManagerConfig(max_ragged_batch_size=prompt_len + n_req,
                                           max_ragged_sequence_count=n_req,
                                           max_tracked_sequences=n_req + 1,
                                           max_context=prompt_len + new))
    rng = np.random.RandomState(0)
    system = rng.randint(0, 1000, 4 * 32)
    fleets = [[np.concatenate([system, rng.randint(0, 1000, 16)]) for _ in range(n_req)],
              [rng.randint(0, 1000, prompt_len) for _ in range(n_req)],
              [np.concatenate([system, rng.randint(0, 1000, 16)]) for _ in range(n_req)]]
    results = {}
    for pin in ("kernel", "plain"):
        if pin == "plain":
            quant, dequant = _plain_k7(tq)
            monkeypatch.setattr(tq, "_quant_kernel", quant)
            monkeypatch.setattr(tq, "_dequant_kernel", dequant)
        eng = InferenceEngineV2(cfg, ecfg, params=params, device=cuda)
        calls = {"demote": 0, "restore": 0}
        demote, restore = eng.kv_tier.demote, eng.kv_cache.restore

        def counted_demote(victims):
            calls["demote"] += bool(victims)
            return demote(victims)

        def counted_restore(handle):
            calls["restore"] += bool(handle.get("quantized")) and handle["k"].shape[1] > 0
            return restore(handle)
        eng.kv_tier.demote, eng.kv_cache.restore = counted_demote, counted_restore
        before = (tq.quantize_int8.launches, tq.dequantize_int8.launches)
        streams, cached = [], []
        for f, prompts in enumerate(fleets):
            sched = DynamicSplitFuseScheduler(eng, token_budget=prompt_len + n_req, max_burst=8)
            for i, p in enumerate(prompts):
                sched.add_request(100 * f + i, p, max_new_tokens=new)
            out = sched.run_to_completion()
            streams += [out[100 * f + i] for i in range(n_req)]
            cached += [sched.requests[100 * f + i].prefix_cached_tokens for i in range(n_req)]
        probe = np.concatenate([system, np.arange(5, 21)])
        got = eng.prefix_match(999, probe)
        logits = eng.put([999], [probe[got:]])
        torch.cuda.synchronize()
        launched = (tq.quantize_int8.launches - before[0],
                    tq.dequantize_int8.launches - before[1])
        want = (0, 0) if pin == "plain" else (2 * calls["demote"],
                                              2 * calls["demote"] + 2 * calls["restore"])
        assert launched == want, (pin, launched, calls)
        assert calls["demote"] > 0 and calls["restore"] > 0
        results[pin] = (streams, cached, logits, eng.kv_tier.stats()["quant_error_max"])
        eng.destroy()
    k, p = results["kernel"], results["plain"]
    assert k[0] == p[0] and k[1] == p[1] and k[3] == p[3]
    assert np.array_equal(k[2], p[2])
    assert sum(k[1][2 * n_req:]) > 0


@pytest.mark.parametrize("quantize", [False, True])
def test_tier_records_own_their_bytes_and_promote_from_host(cuda, quantize):
    """A demotion stores each block's k and v in one pinned buffer of
    exactly their size (a record locks its own bytes, which the store's
    budget charges), and a promotion from those host records, prefetch off,
    restores the blocks: bit for bit in bf16, within the measured error
    plus bf16 rounding in int8."""
    from deepspeed_tpu_torch.inference.v2.kv_tier import TierManager
    from deepspeed_tpu_torch.inference.v2.kv_tier.quant import handle_nbytes
    from deepspeed_tpu_torch.inference.v2.prefix_cache import PrefixCacheManager
    from deepspeed_tpu_torch.inference.v2.ragged import BlockedKVCache, DSStateManager
    bs = 32
    cache = BlockedKVCache(2, 8, bs, 8, 128, dtype=torch.bfloat16, device=cuda)
    g = torch.Generator(cuda).manual_seed(3)
    for pool in (cache.k, cache.v):
        pool.copy_(torch.randn(pool.shape, generator=g, device=cuda))
    mgr = DSStateManager(cache, max_tracked_sequences=4)
    pc = PrefixCacheManager(cache)
    tier = TierManager(pc, 1 << 30, quantize=quantize, prefetch=False)
    mgr.attach_prefix_cache(pc)
    pc.attach_tier(tier)
    tokens = list(range(3 * bs + 1))
    d = mgr.get_or_create_sequence(1)
    mgr.allocate_for(d, len(tokens))
    d.advance(len(tokens))
    d.tokens = tokens
    want = cache.gather([int(b) for b in d.blocks[:3]])
    mgr.flush_sequence(1)
    pc.ensure_free(cache.free_blocks + 3)
    records = list(tier.store._records.values())
    assert len(records) == 3 and tier.stats()["demoted_blocks"] == 3
    for rec in records:
        k, v = rec["handle"]["k"], rec["handle"]["v"]
        assert k.is_pinned() and k.untyped_storage().data_ptr() == v.untyped_storage().data_ptr()
        assert k.untyped_storage().nbytes() == k.nbytes + v.nbytes
        assert rec["nbytes"] == handle_nbytes(rec["handle"])
    assert tier.store.stats()["bytes_resident"] == sum(r["nbytes"] for r in records)
    blocks, cached = pc.acquire(2, tokens)
    assert cached == 3 * bs and tier.stats()["stage_hits"] == 0
    got = cache.gather(blocks)
    for name in ("k", "v"):
        if quantize:
            err = tier.stats()["quant_error_max"] + float(want[name].abs().max()) * 2 ** -8
            assert float((got[name].float() - want[name].float()).abs().max()) <= err
        else:
            assert torch.equal(got[name], want[name])


# ------------------------------------------------- batch-invariant serving
@pytest.mark.parametrize("K,N", [(4096, 4096), (4096, 1024), (14336, 4096), (4096, 14336),
                                 (4096, 32000), (100, 72)])
def test_dense_matmul_matches_plain_and_rows_do_not_move(cuda, K, N):
    """``dense_matmul`` at every row count of phase 4b, across its decode
    (M <= 16) and prefill designs (the general design at (100, 72), whose
    rows TMA cannot read): each within QUANT_TOL of the fp32 product of the
    same bf16 inputs, a zeroed tile rejected, two runs the same bits,
    one-hot rows exact, the general design right at an unaligned base; row
    0 the same bits at every row count (cuBLAS's move between 16 and 512
    rows at Mistral-7B's shapes on an H100); and eye(K) giving w exactly."""
    from deepspeed_tpu_torch.ops.kernels.fused_quant_matmul import dense_matmul
    g = torch.Generator(cuda).manual_seed(K + N)
    x = torch.randn(512, K, generator=g, device=cuda).to(torch.bfloat16)
    w = (torch.randn(K, N, generator=g, device=cuda) * 0.02).to(torch.bfloat16)
    rows, designs = {}, {}
    for M in (1, 7, 16, 64, 255, 512):
        xm = x[:M].contiguous()
        designs[M] = _k4_check(cuda, lambda a: dense_matmul(a, w), xm.float() @ w.float(), xm,
                               w, "bf16", dense_matmul)
        rows[M] = dense_matmul(xm, w)
    torch.cuda.synchronize()
    if K % 8 == 0:
        assert designs == {M: "stream" if M <= 16 else "wgmma" for M in designs}, designs
    assert all(torch.equal(y[:1], rows[1]) for y in rows.values())
    assert torch.equal(dense_matmul(torch.eye(K, device=cuda, dtype=torch.bfloat16), w), w)
    with pytest.raises(TypeError):
        dense_matmul(x.float(), w.float())  # fp32 on the card: no fallback


def test_greedy_stream_alone_equals_stream_in_a_mixed_batch(cuda):
    """A 2-layer Mistral-7B-width bf16 engine: one request alone (its
    decode steps at the max_seqs bucket) and the same request beside other
    prompts (decode steps at the prefill bucket) give the same greedy
    stream and the same logits bits."""
    from deepspeed_tpu_torch.inference.v2 import (DSStateManagerConfig, InferenceEngineV2,
                                                  RaggedInferenceEngineConfig)
    from deepspeed_tpu_torch.models import init_params, llama_config
    cfg = llama_config("mistral-7b", num_hidden_layers=2)
    params = init_params(cfg, cuda, torch.bfloat16, torch.Generator(cuda).manual_seed(1))
    sm = DSStateManagerConfig(max_ragged_batch_size=512, max_ragged_sequence_count=16,
                              max_tracked_sequences=8, max_context=256)
    rng = np.random.RandomState(3)
    prompt = rng.randint(0, cfg.vocab_size, 100).astype(np.int32)
    others = [rng.randint(0, cfg.vocab_size, n).astype(np.int32) for n in (60, 90, 33, 45)]
    runs = {}
    for kind in ("alone", "mixed"):
        eng = InferenceEngineV2(cfg, RaggedInferenceEngineConfig(kv_block_size=32,
                                                                 state_manager=sm),
                                params=params, device=cuda)
        logits = [eng.put([0], [prompt])[0]]
        for i in range(4):
            tok = [int(np.argmax(logits[-1]))]
            out = (eng.put([0], [tok]) if kind == "alone"
                   else eng.put([0, i + 1], [tok, others[i]]))  # a prompt beside: bucket 512
            logits.append(out[0])
        runs[kind] = np.stack(logits)
        eng.destroy()
    assert np.array_equal(runs["alone"], runs["mixed"])


# ------------------------------------------------- MoE training (K5 backward)
def test_two_layer_moe_training_step_kernels_vs_plain(cuda):
    """One bf16 ``train_batch`` (gas 2) of a 2-layer dropless MoE model
    (4 experts, top-2, S = 256: the flash path) with remat ``"moe"``
    through the kernels, and from the same weights with the grouped
    kernels, attention and norms pinned to their plain versions (the plain
    run replays the kernel run's routing: a near-tie may fall either way
    under the two runs' roundings). Each parameter's accumulated fp32
    gradient within 2^-4 of the plain run's in relative L2 norm, the loss
    within 1e-3 relative; per layer and micro-batch 3 ``gmm`` forward + 3
    ``gmm`` dx launches and 3 ``gmm_dw``, and no forward re-run."""
    import contextlib
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import build_llama, llama
    from deepspeed_tpu_torch.moe import sharded_moe
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    from deepspeed_tpu_torch.ops.kernels import fused_norms as fn
    from deepspeed_tpu_torch.ops.kernels import grouped_matmul as gm
    L, gas = 2, 2
    cfg = {"train_batch_size": 2 * gas, "train_micro_batch_size_per_gpu": 2,
           "gradient_accumulation_steps": gas, "bf16": {"enabled": True},
           "optimizer": {"type": "Adam", "params": {"lr": 1e-4}}}
    ids = torch.randint(0, 512, (2 * gas, 256), generator=torch.Generator(cuda).manual_seed(0),
                        device=cuda)
    routes, top_k = [], sharded_moe.top_k

    def recording_top_k(gates, k):
        vals, idx = top_k(gates, k)
        routes.append(idx)
        return vals, idx

    def replaying_top_k(gates, k):
        idx = routes.pop(0)
        return gates.gather(-1, idx), idx

    @contextlib.contextmanager
    def pinned(mode):
        saved = (llama.flash_attention, llama.fused_rms_norm, gm.gmm, gm.gmm_transposed,
                 gm.gmm_dw, sharded_moe.top_k)
        sharded_moe.top_k = recording_top_k if mode == "kernels" else replaying_top_k
        if mode == "plain":
            llama.flash_attention = lambda q, k, v, causal=True: fa.flash_attention_ref(
                q, k, v, causal)
            llama.fused_rms_norm = fn.rms_norm_ref
            gm.gmm, gm.gmm_transposed, gm.gmm_dw = gm.gmm_ref, gm.gmm_transposed_ref, \
                gm.gmm_dw_ref
        try:
            yield
        finally:
            (llama.flash_attention, llama.fused_rms_norm, gm.gmm, gm.gmm_transposed,
             gm.gmm_dw, sharded_moe.top_k) = saved

    out = {}
    for mode in ("kernels", "plain"):
        model = build_llama("mixtral-debug", device=cuda, hidden_size=256, intermediate_size=512,
                            num_attention_heads=2, num_key_value_heads=2, vocab_size=512,
                            max_position_embeddings=512, moe_drop_tokens=False,
                            remat_policy="moe", generator=torch.Generator(cuda).manual_seed(1))
        engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=cfg, device=cuda)
        grads, step = [], engine.step

        def recording_step():
            grads[:] = [g.float().clone() for g in engine._grads_acc]
            step()

        engine.step = recording_step
        before = [gm.gmm.launches, gm.gmm_dw.launches]
        with pinned(mode):
            loss = engine.train_batch(batch=(ids, ids))
        torch.cuda.synchronize()
        grew = [gm.gmm.launches - before[0], gm.gmm_dw.launches - before[1]]
        assert grew == ([6 * L * gas, 3 * L * gas] if mode == "kernels" else [0, 0]), grew
        out[mode] = (loss.item(), grads)
    assert not routes
    (lk, gk), (lp, gp) = out["kernels"], out["plain"]
    rel = max(((a - b).norm() / b.norm()).item() for a, b in zip(gk, gp))
    assert np.isfinite(lk) and abs(lk - lp) <= 1e-3 * abs(lp), (lk, lp)
    assert rel <= 2.0 ** -4, rel


# ------------------------------------------- block-sparse attention (K8), LN
def _unreached_layout(H, n):
    """Per-head layouts over n blocks with an empty row (2) and a key block
    no row admits (n - 2); block 0 is admitted by every other row."""
    layout = np.zeros((H, n, n), bool)
    for r in range(n):
        if r != 2:
            layout[:, r, [0, r if r != n - 2 else n - 1]] = True
    layout[:, 0, :n - 2] = True
    layout[1:, 1, 3] = True  # the heads differ
    return layout


def _bigbird(H, S, block, per_head=False):
    from deepspeed_tpu_torch.ops.sparse_attention import BigBirdSparsityConfig
    return BigBirdSparsityConfig(num_heads=H, block=block, different_layout_per_head=per_head,
                                 num_random_blocks=1, num_sliding_window_blocks=3,
                                 num_global_blocks=1).make_layout(S)


def _fixed(H, S, block):
    from deepspeed_tpu_torch.ops.sparse_attention import FixedSparsityConfig
    return FixedSparsityConfig(num_heads=H, block=block, num_local_blocks=4,
                               num_global_blocks=1).make_layout(S)


K8_CASES = {  # name: (B, S, H, D, block, layout maker)
    "bigbird_b64_d64": (2, 1024, 2, 64, 64, lambda: _bigbird(1, 1024, 64)),
    "bigbird_b16_d128": (1, 512, 2, 128, 16, lambda: _bigbird(1, 512, 16)),
    "fixed_b32_d64": (2, 512, 2, 64, 32, lambda: _fixed(1, 512, 32)),
    "per_head_b128_d128": (1, 1024, 3, 128, 128, lambda: _bigbird(3, 1024, 128, True)),
    "per_head_b16_d64": (2, 256, 3, 64, 16, lambda: _bigbird(3, 256, 16, True)),
    "unreached_b64_d64": (1, 512, 2, 64, 64, lambda: _unreached_layout(2, 8)),
    "unreached_b16_d128": (2, 160, 2, 128, 16, lambda: _unreached_layout(2, 10)),
    "unreached_b32_d128": (1, 256, 2, 128, 32, lambda: _unreached_layout(2, 8)),
}


def _zero_first_block(x, block):
    y = x.clone()
    y[:, :block] = 0
    return y


@pytest.mark.parametrize("case", sorted(K8_CASES))
def test_block_sparse_kernels_match_plain(cuda, case):
    """Forward, dQ and dK/dV against their plain versions on the same bf16
    inputs: o, dq, dk, dv within ROW_TOL units of ``row_scaled_err`` (as
    K1: the output's bf16 rounding, and p and ds rounded to bf16 on both
    sides from scores summed in another order), lse within 1e-3 absolute;
    an empty row gives o = 0, dq = 0 and lse = NEG_INF, and a key block no
    row admits dk = dv = 0, all exactly. Each check rejects the output with
    its first block of rows zeroed (row and key block 0 are admitted)."""
    from deepspeed_tpu_torch.ops.kernels import block_sparse_attention as bsa
    from deepspeed_tpu_torch.ops.kernels.flash_attention import flash_delta, row_scaled_err
    B, S, H, D, block, make = K8_CASES[case]
    layout = make()
    q, k, v, do, _ = _flash_inputs(cuda, B, S, H, D, 0, seed=len(case))
    counters = (bsa.block_sparse_fwd, bsa.block_sparse_dq, bsa.block_sparse_dkv)
    before = [f.launches for f in counters]
    o, lse = bsa.block_sparse_fwd(q, k, v, layout, block)
    delta = flash_delta(o, do)
    dq = bsa.block_sparse_dq(q, k, v, do, lse, delta, layout, block)
    dk, dv = bsa.block_sparse_dkv(q, k, v, do, lse, delta, layout, block)
    o_ref, lse_ref = bsa.block_sparse_fwd_ref(q.float(), k.float(), v.float(), layout, block)
    dq_ref = bsa.block_sparse_dq_ref(q, k, v, do, lse, delta, layout, block)
    dk_ref, dv_ref = bsa.block_sparse_dkv_ref(q, k, v, do, lse, delta, layout, block)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(counters, before)] == [1, 1, 1]
    full = bsa.full_layout(layout, H, S, block)
    live = torch.from_numpy(full.any(-1)).to(cuda).repeat_interleave(block, 1)  # [H, S]
    reached = torch.from_numpy(full.any(-2)).to(cuda).repeat_interleave(block, 1)
    assert torch.equal(lse == bsa.NEG_INF, ~live[None].expand_as(lse))
    assert (lse - lse_ref)[live[None].expand_as(lse)].abs().max().item() <= 1e-3
    assert torch.all(o.transpose(1, 2)[~live[None].expand(B, -1, -1)] == 0)
    assert torch.all(dq.transpose(1, 2)[~live[None].expand(B, -1, -1)] == 0)
    for t in (dk, dv):
        assert torch.all(t.transpose(1, 2)[~reached[None].expand(B, -1, -1)] == 0)
    errs = {n: row_scaled_err(got, ref) for n, got, ref in (
        ("o", o, o_ref), ("dq", dq, dq_ref), ("dk", dk, dk_ref), ("dv", dv, dv_ref))}
    zeroed = {n: row_scaled_err(_zero_first_block(got, block), ref) for n, got, ref in (
        ("o", o, o_ref), ("dq", dq, dq_ref), ("dk", dk, dk_ref), ("dv", dv, dv_ref))}
    assert max(errs.values()) <= ROW_TOL, errs
    assert min(zeroed.values()) > ROW_TOL, zeroed


def _bsa_designs():
    from deepspeed_tpu_torch.ops.kernels.block_sparse_attention import bsa_design_launches
    return {k: dict(v) for k, v in bsa_design_launches.items()}


def _bsa_grew(before):
    return {k: {d: n - before[k][d] for d, n in v.items()} for k, v in _bsa_designs().items()}


def test_block_sparse_autograd_runs_the_kernels(cuda):
    """``block_sparse_attention``'s backward on CUDA tensors launches dQ and
    dK/dV once each, on the wgmma design at block 64, and gives the
    launchers' results bit for bit."""
    from deepspeed_tpu_torch.ops.kernels import block_sparse_attention as bsa
    from deepspeed_tpu_torch.ops.kernels.flash_attention import flash_delta
    B, S, H, D, block = 2, 512, 2, 64, 64
    layout = _bigbird(1, S, block)
    q, k, v, do, _ = _flash_inputs(cuda, B, S, H, D, 0, seed=5)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    before = [f.launches for f in (bsa.block_sparse_fwd, bsa.block_sparse_dq,
                                   bsa.block_sparse_dkv)]
    designs = _bsa_designs()
    out = bsa.block_sparse_attention(*leaves, layout, block)
    out.backward(do)
    assert [f.launches - b for f, b in zip(
        (bsa.block_sparse_fwd, bsa.block_sparse_dq, bsa.block_sparse_dkv), before)] == [1, 1, 1]
    assert _bsa_grew(designs) == {k: {"wgmma": 1, "first": 0} for k in designs}
    o, lse = bsa.block_sparse_fwd(q, k, v, layout, block)
    delta = flash_delta(o, do)
    assert torch.equal(out, o)
    assert torch.equal(leaves[0].grad, bsa.block_sparse_dq(q, k, v, do, lse, delta, layout, block))
    dk, dv = bsa.block_sparse_dkv(q, k, v, do, lse, delta, layout, block)
    assert torch.equal(leaves[1].grad, dk) and torch.equal(leaves[2].grad, dv)


# K8's backward on its wgmma designs: blocks 64 and 128 at head dims 64
# and 128, BigBird (shared and per-head) and a layout with an empty row and
# a key block no row admits
K8_WGMMA_CASES = {  # name: (B, S, H, D, block, layout maker)
    "bigbird_b64_d64": (2, 1024, 2, 64, 64, lambda: _bigbird(1, 1024, 64)),
    "per_head_b64_d128": (1, 1024, 3, 128, 64, lambda: _bigbird(3, 1024, 64, True)),
    "per_head_b128_d64": (2, 1024, 3, 64, 128, lambda: _bigbird(3, 1024, 128, True)),
    "bigbird_b128_d128": (1, 2048, 2, 128, 128, lambda: _bigbird(1, 2048, 128)),
    "unreached_b64_d64": (1, 512, 2, 64, 64, lambda: _unreached_layout(2, 8)),
    "unreached_b64_d128": (2, 640, 2, 128, 64, lambda: _unreached_layout(2, 10)),
    "unreached_b128_d64": (1, 1024, 2, 64, 128, lambda: _unreached_layout(2, 8)),
    "unreached_b128_d128": (2, 1024, 2, 128, 128, lambda: _unreached_layout(2, 8)),
}


@pytest.mark.parametrize("case", sorted(K8_WGMMA_CASES))
def test_block_sparse_wgmma_backward_matches_plain_and_first(cuda, case):
    """dQ and dK/dV on the wgmma design (counted on it): within ROW_TOL units
    of ``row_scaled_err`` of the plain versions and of the first design on
    the same inputs, the check rejecting the output with its first block of
    rows zeroed; the same bits on a second run; exactly zero dq on an empty
    row and dk, dv on a key block no row admits."""
    from deepspeed_tpu_torch.ops.kernels import block_sparse_attention as bsa
    from deepspeed_tpu_torch.ops.kernels.flash_attention import flash_delta, row_scaled_err
    B, S, H, D, block, make = K8_WGMMA_CASES[case]
    layout = make()
    assert bsa.bsa_design(block, D) == "wgmma"
    q, k, v, do, _ = _flash_inputs(cuda, B, S, H, D, 0, seed=len(case) + 7)
    o, lse = bsa.block_sparse_fwd(q, k, v, layout, block)
    delta = flash_delta(o, do)
    args = (q, k, v, do, lse, delta, layout, block)
    designs = _bsa_designs()
    dq, (dk, dv) = bsa.block_sparse_dq(*args), bsa.block_sparse_dkv(*args)
    dq2, (dk2, dv2) = bsa.block_sparse_dq(*args), bsa.block_sparse_dkv(*args)
    first = {"dq": bsa.block_sparse_dq(*args, design="first")}
    first["dk"], first["dv"] = bsa.block_sparse_dkv(*args, design="first")
    dq_ref = bsa.block_sparse_dq_ref(*args)
    dk_ref, dv_ref = bsa.block_sparse_dkv_ref(*args)
    torch.cuda.synchronize()
    assert _bsa_grew(designs) == {key: {"wgmma": 2 * (key != "block_sparse_fwd"),
                                        "first": int(key != "block_sparse_fwd")}
                                  for key in designs}
    assert torch.equal(dq, dq2) and torch.equal(dk, dk2) and torch.equal(dv, dv2)
    full = bsa.full_layout(layout, H, S, block)
    live = torch.from_numpy(full.any(-1)).to(cuda).repeat_interleave(block, 1)[None]
    reached = torch.from_numpy(full.any(-2)).to(cuda).repeat_interleave(block, 1)[None]
    assert torch.all(dq.transpose(1, 2)[~live.expand(B, -1, -1)] == 0)
    for t in (dk, dv):
        assert torch.all(t.transpose(1, 2)[~reached.expand(B, -1, -1)] == 0)
    got = {"dq": (dq, dq_ref), "dk": (dk, dk_ref), "dv": (dv, dv_ref)}
    errs = {n: row_scaled_err(g, r) for n, (g, r) in got.items()}
    vs_first = {n: row_scaled_err(g, first[n]) for n, (g, _) in got.items()}
    zeroed = {n: row_scaled_err(_zero_first_block(g, block), r) for n, (g, r) in got.items()}
    assert max(errs.values()) <= ROW_TOL, errs
    assert max(vs_first.values()) <= ROW_TOL, vs_first
    assert min(zeroed.values()) > ROW_TOL, zeroed


# the forward's wgmma design at K8_WGMMA_CASES and at chip_smoke.py's phase
# 23 shapes that it takes (BERT-large's path; Dh 128 at block 128; an empty
# row and a key block no row admits)
K8_FWD_CASES = dict(
    K8_WGMMA_CASES,
    path=(4, 4096, 16, 64, 64, lambda: _bigbird(16, 4096, 64)),
    dh128_block128=(2, 2048, 8, 128, 128, lambda: _bigbird(8, 2048, 128)),
    empty_row_unreached=(2, 1024, 4, 64, 64, lambda: _unreached_layout(4, 16)))


@pytest.mark.parametrize("case", sorted(K8_FWD_CASES))
def test_block_sparse_wgmma_forward_matches_plain_and_first(cuda, case):
    """The forward on the wgmma design (counted on it): o within ROW_TOL
    units of ``row_scaled_err`` of the plain version and of the first
    design on the same inputs, the check rejecting o with its first block
    of rows zeroed; lse within 1e-3 of the plain version's where a row
    admits something, and exactly NEG_INF (o exactly 0) where it admits
    nothing; the same bits on a second run."""
    from deepspeed_tpu_torch.ops.kernels import block_sparse_attention as bsa
    from deepspeed_tpu_torch.ops.kernels.flash_attention import row_scaled_err
    B, S, H, D, block, make = K8_FWD_CASES[case]
    layout = make()
    assert bsa.bsa_design(block, D) == "wgmma"
    q, k, v, _, _ = _flash_inputs(cuda, B, S, H, D, 0, seed=len(case) + 3)
    designs = _bsa_designs()
    o, lse = bsa.block_sparse_fwd(q, k, v, layout, block)
    o2, lse2 = bsa.block_sparse_fwd(q, k, v, layout, block)
    o_f, lse_f = bsa.block_sparse_fwd(q, k, v, layout, block, design="first")
    o_ref, lse_ref = bsa.block_sparse_fwd_ref(q, k, v, layout, block)
    torch.cuda.synchronize()
    assert _bsa_grew(designs) == {key: {"wgmma": 2 * (key == "block_sparse_fwd"),
                                        "first": int(key == "block_sparse_fwd")}
                                  for key in designs}
    assert torch.equal(o, o2) and torch.equal(lse.view(torch.int32), lse2.view(torch.int32))
    full = bsa.full_layout(layout, H, S, block)
    live = torch.from_numpy(full.any(-1)).to(cuda).repeat_interleave(block, 1)[None]
    live = live.expand(B, -1, -1)  # [B, H, S]
    for got_o, got_lse in ((o, lse), (o_f, lse_f)):
        assert torch.equal(got_lse == bsa.NEG_INF, ~live)
        assert (got_lse - lse_ref)[live].abs().max().item() <= 1e-3
        assert torch.all(got_o.transpose(1, 2)[~live] == 0)
    errs = {"plain": row_scaled_err(o, o_ref), "first": row_scaled_err(o, o_f)}
    assert max(errs.values()) <= ROW_TOL, errs
    assert row_scaled_err(_zero_first_block(o, block), o_ref) > ROW_TOL


def test_bsa_design_predicate_and_forced_designs(cuda):
    """Blocks of 64 and 128 take the wgmma design, 16 and 32 the first; the
    wgmma design cannot be forced on a block of 32, for any of the three
    kernels."""
    from deepspeed_tpu_torch.ops.kernels import block_sparse_attention as bsa
    from deepspeed_tpu_torch.ops.kernels.flash_attention import flash_delta
    assert [bsa.bsa_design(b, d) for b in (16, 32, 64, 128) for d in (64, 128)] == \
        ["first"] * 4 + ["wgmma"] * 4
    q, k, v, do, _ = _flash_inputs(cuda, 1, 256, 2, 64, 0)
    layout = _bigbird(1, 256, 32)
    o, lse = bsa.block_sparse_fwd(q, k, v, layout, 32)
    args = (q, k, v, do, lse, flash_delta(o, do), layout, 32)
    for fn in (bsa.block_sparse_dq, bsa.block_sparse_dkv):
        with pytest.raises(ValueError):
            fn(*args, design="wgmma")
        with pytest.raises(ValueError):
            fn(*args, design="tiled")
    for design in ("wgmma", "tiled"):
        with pytest.raises(ValueError):
            bsa.block_sparse_fwd(q, k, v, layout, 32, design=design)


def test_bsa_wgmma_kernels_are_wgmma(cuda):
    """The built library's wgmma forward, dQ and dK/dV kernels (blocks 64
    and 128, head dims 64 and 128) issue wgmma (HGMMA) and no mma.sync
    (HMMA). (Their producer warps, held to 24 or 40 registers so that the
    consumers get 232, spill a few words around the item counter; ptxas
    reports it.)"""
    from deepspeed_tpu_torch.ops.kernels import build
    per = build.sass_counts("block_sparse_attention.cu", ("HGMMA", "HMMA"))
    kinds = {k: [c for n, c in per.items() if k in n] for k in
             ("bsa_fwd_wgmma_kernel", "bsa_dq_wgmma_kernel", "bsa_dkv_wgmma_kernel")}
    assert all(len(v) == 4 for v in kinds.values()), per
    for k, v in kinds.items():
        assert all(c["HGMMA"] > 0 and c["HMMA"] == 0 for c in v), (k, per)


def test_block_sparse_rejects_what_it_cannot_take(cuda):
    from deepspeed_tpu_torch.ops.kernels.block_sparse_attention import block_sparse_attention
    q, k, v, _, _ = _flash_inputs(cuda, 1, 256, 2, 64, 0)
    layout = np.ones((1, 4, 4), bool)
    with pytest.raises(TypeError):
        block_sparse_attention(q.float(), k.float(), v.float(), layout, 64)
    with pytest.raises(ValueError):  # head dim 32
        block_sparse_attention(q[..., :32].contiguous(), k[..., :32].contiguous(),
                               v[..., :32].contiguous(), layout, 64)
    with pytest.raises(ValueError):  # block 8
        block_sparse_attention(q, k, v, np.ones((1, 32, 32), bool), 8)
    with pytest.raises(ValueError):  # layout for another length
        block_sparse_attention(q, k, v, np.ones((1, 8, 8), bool), 64)
    with pytest.raises(ValueError):
        block_sparse_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, layout, 64)
    with pytest.raises(ValueError):
        block_sparse_attention(q, k.cpu(), v, layout, 64)


@pytest.mark.parametrize("rows,D,dtype", [(16384, 1024, torch.bfloat16), (37, 64, torch.bfloat16),
                                          (5, 4104, torch.bfloat16), (33, 1024, torch.float32)])
def test_layer_norm_kernel_matches_plain(cuda, rows, D, dtype):
    """Against the plain version in fp32, with ``row_scaled_err``: within 2
    units in bf16 (the output's rounding is at most 1), within 0.01 units
    (4e-5 of the row's scale) in fp32; the check rejects a zeroed last
    tile of 64 rows (or of all rows, when fewer)."""
    from deepspeed_tpu_torch.ops.kernels.flash_attention import row_scaled_err
    from deepspeed_tpu_torch.ops.kernels.fused_norms import layer_norm_fwd, layer_norm_ref
    g = torch.Generator(device=cuda).manual_seed(rows)
    x = (torch.randn(rows, D, generator=g, device=cuda) * 3 + 1).to(dtype)
    scale = (1 + 0.1 * torch.randn(D, generator=g, device=cuda)).to(dtype)
    bias = (0.1 * torch.randn(D, generator=g, device=cuda)).to(dtype)
    before = layer_norm_fwd.launches
    got = layer_norm_fwd(x, scale, bias, 1e-12)
    want = layer_norm_ref(x.float(), scale.float(), bias.float(), 1e-12)
    torch.cuda.synchronize()
    assert layer_norm_fwd.launches == before + 1
    zeroed = got.clone()
    zeroed[-64:] = 0
    limit = 2.0 if dtype == torch.bfloat16 else 0.01
    assert row_scaled_err(got, want) <= limit
    assert row_scaled_err(zeroed, want) > limit


def test_fused_layer_norm_grads_match_plain_autograd(cuda):
    """Kernel forward + closed-form backward vs autograd through the plain
    version, in fp32 (relative to each tensor's max-abs, 1e-5)."""
    from deepspeed_tpu_torch.ops.kernels.fused_norms import fused_layer_norm, layer_norm_ref
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(4, 33, 256, generator=g, device=cuda) + 0.5
    scale = 1 + 0.1 * torch.randn(256, generator=g, device=cuda)
    bias = 0.1 * torch.randn(256, generator=g, device=cuda)
    gy = torch.randn(4, 33, 256, generator=g, device=cuda)
    a = [t.clone().requires_grad_(True) for t in (x, scale, bias)]
    fused_layer_norm(*a).backward(gy)
    b = [t.clone().requires_grad_(True) for t in (x, scale, bias)]
    layer_norm_ref(*b).backward(gy)
    for p, r in zip(a, b):
        assert (p.grad - r.grad).abs().max() <= 1e-5 * r.grad.abs().max()


def test_layer_norm_rejects_what_it_cannot_take(cuda):
    from deepspeed_tpu_torch.ops.kernels.fused_norms import fused_layer_norm
    x = torch.randn(4, 64, device=cuda, dtype=torch.bfloat16)
    s = torch.ones(64, device=cuda, dtype=torch.bfloat16)
    b = torch.zeros(64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        fused_layer_norm(x.half(), s.half(), b.half())
    with pytest.raises(TypeError):
        fused_layer_norm(x, s, b.float())
    with pytest.raises(ValueError):
        fused_layer_norm(x[:, :60].contiguous(), s[:60].contiguous(), b[:60].contiguous())
    with pytest.raises(ValueError):
        fused_layer_norm(x, s, b[:32])
    with pytest.raises(ValueError):
        fused_layer_norm(x, s, b.cpu())


def test_two_layer_bert_training_step_kernels_vs_plain(cuda):
    """One bf16 ``train_batch`` (gas 2, B 2, S 512) of a 2-layer BERT at
    head_dim 64 with BigBird block 64 through the kernels, and again from
    the same weights with block-sparse attention and LayerNorm pinned to
    their plain versions: the loss within 1e-4 relative, each parameter's
    accumulated fp32 gradient within 2^-4 of the plain run's in relative L2
    norm (as the Llama step above); K8's three kernels launched L per
    micro-batch each and LayerNorm 2 L + 2, none in the plain run. The key
    projection's bias has no gradient in exact arithmetic (a softmax is
    blind to q·b_k added to a whole row), so both runs hold rounding noise
    there: each is held under 2^-4 of its layer's query-bias gradient."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import bert, build_bert
    from deepspeed_tpu_torch.ops.kernels import block_sparse_attention as bsa
    from deepspeed_tpu_torch.ops.kernels import fused_norms as fn
    from deepspeed_tpu_torch.ops.sparse_attention import SparseAttentionUtils, sparse_self_attention
    L, gas, S = 2, 2, 512
    cfg = {"train_batch_size": 2 * gas, "train_micro_batch_size_per_gpu": 2,
           "gradient_accumulation_steps": gas, "bf16": {"enabled": True},
           "optimizer": {"type": "Adam", "params": {"lr": 1e-4}}, "zero_optimization": {"stage": 3}}
    ds = {"sparse_attention": {"mode": "bigbird", "block": 64, "num_random_blocks": 1,
                               "num_sliding_window_blocks": 3, "num_global_blocks": 1}}
    ids = torch.randint(0, 512, (2 * gas, S), generator=torch.Generator(cuda).manual_seed(0),
                        device=cuda)
    counters = (bsa.block_sparse_fwd, bsa.block_sparse_dq, bsa.block_sparse_dkv,
                fn.layer_norm_fwd)
    out = {}
    for mode in ("kernels", "plain"):
        model = build_bert("bert-debug", device=cuda, hidden_size=256, intermediate_size=512,
                           num_attention_heads=4, vocab_size=512, num_hidden_layers=L,
                           generator=torch.Generator(cuda).manual_seed(1))
        model = SparseAttentionUtils.replace_model_self_attention_with_sparse_self_attention(
            model, max_position=S, ds_config=ds)
        engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=cfg, device=cuda)
        grads, step = [], engine.step

        def recording_step():  # the accumulated fp32 gradients, before the update
            grads[:] = [g.float().clone() for g in engine._grads_acc]
            step()

        engine.step = recording_step
        before = [f.launches for f in counters]
        saved = sparse_self_attention.bsa.block_sparse_attention, bert.fused_layer_norm
        if mode == "plain":
            sparse_self_attention.bsa.block_sparse_attention = bsa.block_sparse_attention_ref
            bert.fused_layer_norm = fn.layer_norm_ref
        try:
            loss = engine.train_batch(batch=(ids, ids))
        finally:
            sparse_self_attention.bsa.block_sparse_attention, bert.fused_layer_norm = saved
        torch.cuda.synchronize()
        grew = [f.launches - b for f, b in zip(counters, before)]
        want = [L * gas, L * gas, L * gas, (2 * L + 2) * gas] if mode == "kernels" \
            else [0, 0, 0, 0]
        assert grew == want
        names = [n for n, p in model.named_parameters() if p.requires_grad]
        out[mode] = (loss.item(), dict(zip(names, grads)))
    (lk, gk), (lp, gp) = out["kernels"], out["plain"]
    kbias = [n for n in names if n.endswith("k_proj.bias")]
    readings = {"loss_rel": abs(lk - lp) / abs(lp),
                "leaf_grad_rel_max": max(((gk[n] - gp[n]).norm() / gp[n].norm()).item()
                                         for n in names if n not in kbias),
                "k_bias_vs_q_bias_max": max(
                    (g[n].norm() / g[n.replace("k_proj", "q_proj")].norm()).item()
                    for n in kbias for g in (gk, gp))}
    assert np.isfinite(lk) and readings["loss_rel"] <= 1e-4, readings
    assert readings["leaf_grad_rel_max"] <= 2.0 ** -4, readings
    assert readings["k_bias_vs_q_bias_max"] <= 2.0 ** -4, readings


# ------------------------------------------------------- on-device sampling
# The counter PRNG and the packed sampler are PyTorch ops on the card: the
# keys, bits and uniforms must equal the port's CPU version bit for bit.
# The card's ``log`` and its parallel ``cumsum`` are not the CPU's, so a
# token may differ only where two Gumbel-perturbed logits, or a cumulative
# probability and ``top_p``, lie within a few ulps: at most
# SAMPLE_MISMATCHES of the 512 rows below.
SAMPLE_MISMATCHES = 1


def _sample_specs(rng, n, V):
    out = []
    for i in range(n):
        kind = i % 8
        if kind == 0:
            out.append(None)  # a greedy row
            continue
        s = {"temperature": float(rng.uniform(0.3, 1.5)), "seed": int(rng.randint(0, 2 ** 31))}
        s.update([{}, {"top_k": 1}, {"top_k": V + 5}, {"top_p": 0.05}, {"top_p": 1.0},
                  {"top_k": 20, "top_p": 0.9}, {"top_p": 0.7}, {}][kind])
        out.append(s)
    return out


def test_counter_prng_on_card_equals_cpu(cuda):
    from deepspeed_tpu_torch.inference.structured import prng
    rng = np.random.RandomState(0)
    seeds = torch.from_numpy(rng.randint(0, 2 ** 31, 64).astype(np.int32))
    pos = torch.from_numpy(rng.randint(0, 2 ** 20, 64).astype(np.int32))
    base = prng.base_sampling_key(42)
    keys = prng.token_keys(prng.key_tensor(base, "cpu"), seeds, pos)
    keys_gpu = prng.token_keys(prng.key_tensor(base, cuda), seeds.to(cuda), pos.to(cuda))
    assert torch.equal(keys_gpu.cpu(), keys)
    bits, bits_gpu = prng.row_bits(keys, 32000), prng.row_bits(keys_gpu, 32000)
    assert torch.equal(bits_gpu.cpu(), bits)
    assert torch.equal(prng.uniform_from_bits(bits_gpu).cpu(), prng.uniform_from_bits(bits))
    assert torch.equal(prng.flat_bits(prng.key_tensor(base, cuda), (64, 1000)).cpu(),
                       prng.flat_bits(prng.key_tensor(base, "cpu"), (64, 1000)))


def test_sample_rows_on_card_against_cpu(cuda):
    """``sample_rows`` on the card and on the CPU over the same fixed fp32
    logits, specs and keys: greedy rows equal, at most SAMPLE_MISMATCHES of
    512 rows apart, the result an int32 tensor on the card."""
    from deepspeed_tpu_torch.inference.structured import prng
    from deepspeed_tpu_torch.inference.structured.sampling import (pack_sample_meta,
                                                                   sample_rows,
                                                                   unpack_sample_meta)
    rng = np.random.RandomState(1)
    n, V = 64, 32000
    base = prng.base_sampling_key(42)
    mismatches = 0
    for trial in range(8):
        logits = torch.from_numpy((rng.randn(n, V) * (1 + trial % 3)).astype(np.float32))
        meta = torch.from_numpy(pack_sample_meta(_sample_specs(rng, n, V), n))
        pos = torch.from_numpy(rng.randint(0, 2 ** 20, n).astype(np.int32))
        outs = []
        for dev in ("cpu", cuda):
            t = unpack_sample_meta(meta.to(dev), n)
            keys = prng.token_keys(prng.key_tensor(base, dev), t[3], pos.to(dev))
            outs.append(sample_rows(logits.to(dev), keys, t[0], t[1], t[2]))
        assert outs[1].is_cuda and outs[1].dtype == torch.int32
        got, want = outs[1].cpu(), outs[0]
        assert torch.equal(got[0::8], want[0::8])  # greedy rows: the argmax
        mismatches += int((got != want).sum())
    assert mismatches <= SAMPLE_MISMATCHES, mismatches


def _topk1_against_greedy(eng, prompt, ntok):
    """Stepwise over ``ntok`` steps: request 1 takes its logits' argmax,
    request 2 the token of ``top_k: 1`` (its own puts at the same slot,
    bucket and positions: the same logits). At every step the draw must be
    the argmax, or one of the tied maxima where the logits tie; the draw
    feeds both requests, so the check goes on past a tie. → (tied steps,
    steps where the draw was a tied token other than the first)."""
    spec = {"temperature": 0.7, "top_k": 1, "seed": 9}
    tok = None
    tied = parted = 0
    for step in range(ntok):
        feed = prompt if tok is None else [tok]
        logits = eng.put([1], [feed])[0]
        tok = int(eng.put([2], [feed], sample=[spec])[0])
        top = np.flatnonzero(logits == logits.max())
        assert tok in top, (step, tok, top)
        tied += len(top) > 1
        parted += int(tok != top[0])
    eng.flush(1)
    eng.flush(2)
    return tied, parted


def test_sampled_engine_on_card(cuda):
    """A small bf16 engine on the card: a seeded sampled trace replays
    bit-identically under fresh uids, ``max_burst`` 1 gives the streams of
    ``max_burst`` 4, and ``top_k: 1`` follows greedy."""
    from deepspeed_tpu_torch.inference.v2 import (DSStateManagerConfig,
                                                  DynamicSplitFuseScheduler, InferenceEngineV2,
                                                  RaggedInferenceEngineConfig)
    from deepspeed_tpu_torch.models import init_params, llama_config
    cfg = llama_config("debug", hidden_size=256, num_attention_heads=4,
                       num_key_value_heads=2, num_hidden_layers=2)
    params = init_params(cfg, cuda, torch.bfloat16, torch.Generator(cuda).manual_seed(5),
                         std=0.05)
    eng = InferenceEngineV2(cfg, RaggedInferenceEngineConfig(
        kv_block_size=16, state_manager=DSStateManagerConfig(
            max_ragged_batch_size=64, max_ragged_sequence_count=4, max_tracked_sequences=8,
            max_context=96)), params=params, device=cuda)
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32) for n in (9, 30, 17, 24)]
    specs = [{"temperature": 0.8, "top_k": 40, "seed": 11}, {"temperature": 1.1, "seed": 12},
             {"temperature": 0.6, "top_p": 0.9, "seed": 13}, None]

    def run(uid0, max_burst, sample):
        sched = DynamicSplitFuseScheduler(eng, token_budget=64, max_burst=max_burst)
        for i, p in enumerate(prompts):
            sched.add_request(uid0 + i, p, max_new_tokens=24, sample=sample[i])
        out = sched.run_to_completion()
        return [out[uid0 + i] for i in range(len(prompts))]

    free0 = eng.free_blocks
    sampled = run(0, 4, specs)
    assert run(100, 4, specs) == sampled
    assert run(200, 1, specs) == sampled
    greedy = run(300, 4, [None] * 4)
    assert sampled[3] == greedy[3] and sampled[:3] != greedy[:3]
    for p in prompts[:2]:
        _topk1_against_greedy(eng, p, 24)
    assert eng.free_blocks == free0


# ------------------------------------------- speculative and constrained decoding
def _spec_engine(cuda, spec=True, structured=False):
    from deepspeed_tpu_torch.inference.v2 import (DSStateManagerConfig, InferenceEngineV2,
                                                  RaggedInferenceEngineConfig)
    from deepspeed_tpu_torch.models import init_params, llama_config
    cfg = llama_config("debug", hidden_size=256, num_attention_heads=4,
                       num_key_value_heads=2, num_hidden_layers=2)
    params = init_params(cfg, cuda, torch.bfloat16, torch.Generator(cuda).manual_seed(5),
                         std=0.05)
    return InferenceEngineV2(cfg, RaggedInferenceEngineConfig(
        kv_block_size=16, spec_decode={"enabled": spec, "draft_len": 4},
        structured={"enabled": structured}, state_manager=DSStateManagerConfig(
            max_ragged_batch_size=64, max_ragged_sequence_count=4, max_tracked_sequences=8,
            max_context=128)), params=params, device=cuda)


def test_verify_burst_on_card_equals_stepwise(cuda):
    """Forced drafts on the card (all correct, one wrong, two rows and pad
    rows; greedy and sampled): every emitted token equals the stepwise
    stream, bit for bit, and the verify forward runs the paged-attention
    and ``dense_matmul`` kernels; then schedulers with spec on and off
    over repetitive prompts give the same greedy streams, with verify
    steps taken."""
    from deepspeed_tpu_torch.inference.v2 import DynamicSplitFuseScheduler
    from deepspeed_tpu_torch.ops.kernels.fused_quant_matmul import dense_matmul
    from deepspeed_tpu_torch.ops.kernels.paged_attention import paged_decode_attention
    eng = _spec_engine(cuda)
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, 256, 21).astype(np.int32), rng.randint(0, 256, 40).astype(np.int32)]
    spec = {"temperature": 1.1, "top_k": 24, "seed": 8}
    free0 = eng.free_blocks
    for sample in (None, spec):
        refs = []
        for uid, p in enumerate(prompts):  # stepwise: one put a token
            toks = [int(eng.put([uid], [p], sample=sample or "greedy")[0])]
            for _ in range(6):
                toks.append(int(eng.put([uid], [[toks[-1]]], sample=sample or "greedy")[0]))
            refs.append(toks)
            eng.flush(uid)
        first = eng.put([10, 11], prompts, sample=sample or "greedy")
        assert first.tolist() == [r[0] for r in refs]
        a0, a1 = paged_decode_attention.launches, dense_matmul.launches
        wrong = refs[1][1:3] + [(refs[1][3] + 1) % 256, refs[1][4]]
        toks, acc = eng.verify_burst([10, 11], [[first[0]], [first[1]]],
                                     [refs[0][1:5], wrong], sample=sample)
        assert paged_decode_attention.launches - a0 == 2 and dense_matmul.launches - a1 == 15
        assert acc.tolist() == [4, 2], (sample, acc)
        assert toks[0].tolist() == refs[0][1:6] and toks[1, :3].tolist() == refs[1][1:4]
        for uid in (10, 11):
            eng.flush(uid)
    assert eng.free_blocks == free0

    def run(engine, uid0):
        sched = DynamicSplitFuseScheduler(engine, token_budget=64, max_burst=8)
        for i in range(3):
            p = np.tile(rng.randint(0, 256, 6).astype(np.int32), 5)
            sched.add_request(uid0 + i, p, max_new_tokens=32)
        out = sched.run_to_completion()
        return [out[uid0 + i] for i in range(3)]
    rng = np.random.RandomState(4)
    on = run(eng, 100)
    rng = np.random.RandomState(4)
    assert run(_spec_engine(cuda, spec=False), 100) == on
    assert eng.spec.stats()["verify_steps"] > 0, eng.spec.stats()


def test_dfa_mask_and_constrained_engine_on_card(cuda):
    """``apply_dfa_mask`` and the DFA advance on the card equal the CPU's;
    a constrained engine on the card keeps its slabs there and emits
    schema-valid JSON, sampled and greedy, each replaying per seed."""
    import json
    from deepspeed_tpu_torch.inference.structured import CompiledSchema, byte_vocab, detokenize
    from deepspeed_tpu_torch.inference.structured.sampling import apply_dfa_mask
    from deepspeed_tpu_torch.inference.v2 import DynamicSplitFuseScheduler
    schema = {"type": "object", "properties": {"ok": {"type": "boolean"},
                                               "mode": {"enum": ["fast", "safe"]}}}
    eng = _spec_engine(cuda, structured=True)
    vocab = byte_vocab(eng.model_config.vocab_size)
    compiled = CompiledSchema(schema, vocab, eos_token_id=2)
    eng.bind_schema(1, compiled)
    masks, trans = eng.structured.slabs()
    assert masks.is_cuda and trans.is_cuda and trans.dtype == torch.int32
    rng = np.random.RandomState(5)
    logits = torch.from_numpy(rng.randn(4, 256).astype(np.float32))
    slots = torch.tensor([0, 1, 1, 1], dtype=torch.int32)
    states = torch.tensor([0, 0, 5, 9], dtype=torch.int32)
    got = apply_dfa_mask(logits.to(cuda), masks, slots.to(cuda), states.to(cuda))
    want = apply_dfa_mask(logits, masks.cpu(), slots, states)
    assert torch.equal(got.cpu(), want)
    pick = got.argmax(dim=-1)
    assert torch.equal(trans[slots.to(cuda).long(), states.to(cuda).long(), pick].cpu(),
                       trans.cpu()[slots.long(), states.long(), pick.cpu()])
    eng.structured.release(1)  # bound, never prefilled: no sequence to flush

    def run(uid0, specs):
        sched = DynamicSplitFuseScheduler(eng, max_burst=8, eos_token_id=2)
        for i, s in enumerate(specs):
            sched.add_request(uid0 + i, rng.randint(0, 256, 12).astype(np.int32),
                              max_new_tokens=64, sample=s, schema=compiled)
        out = sched.run_to_completion()
        return [out[uid0 + i] for i in range(len(specs))]
    specs = [{"temperature": 1.1, "top_k": 40, "seed": 500 + i} for i in range(3)] + [None]
    rng = np.random.RandomState(6)
    first = run(0, specs)
    rng = np.random.RandomState(6)
    assert run(100, specs) == first
    for toks in first:
        assert toks[-1] == 2, toks
        doc = json.loads(detokenize(toks[:-1], vocab))
        assert isinstance(doc["ok"], bool) and doc["mode"] in ("fast", "safe")


def test_serving_rms_rows_do_not_move(cuda):
    """The serving path's RMS norm (K2's RMS forward on CUDA) at the row
    counts of a decode step, a verify forward and a prefill: every row
    the same bits as at 512 rows and as alone. PyTorch's eager mean took
    another summation order at 40 and 64 rows and moved a row's bits."""
    from deepspeed_tpu_torch.inference.v2.model_runner import _rms
    from deepspeed_tpu_torch.ops.kernels.fused_norms import rms_norm_fwd
    g = torch.Generator(cuda).manual_seed(3)
    x = (torch.randn(512, 4096, generator=g, device=cuda) * 3).to(torch.bfloat16)
    sc = (1 + 0.1 * torch.randn(4096, generator=g, device=cuda)).to(torch.bfloat16)
    n0 = rms_norm_fwd.launches
    full = _rms(x, sc, 1e-5)
    assert rms_norm_fwd.launches == n0 + 1
    for M in (1, 2, 7, 8, 16, 40, 64, 255):
        assert torch.equal(_rms(x[:M], sc, 1e-5), full[:M]), M
    for r in range(0, 512, 37):
        assert torch.equal(_rms(x[r:r + 1], sc, 1e-5), full[r:r + 1]), r


# ------------------------------------------------------- pipelined decode bursts
def _async_engine(cuda, async_on, structured=False):
    from deepspeed_tpu_torch.inference.v2 import (DSStateManagerConfig, InferenceEngineV2,
                                                  RaggedInferenceEngineConfig)
    from deepspeed_tpu_torch.models import init_params, llama_config
    cfg = llama_config("debug", hidden_size=256, num_attention_heads=4,
                       num_key_value_heads=2, num_hidden_layers=2)
    params = init_params(cfg, cuda, torch.bfloat16, torch.Generator(cuda).manual_seed(5),
                         std=0.05)
    return InferenceEngineV2(cfg, RaggedInferenceEngineConfig(
        kv_block_size=16, async_burst={"enabled": async_on, "depth": 2},
        structured={"enabled": structured}, state_manager=DSStateManagerConfig(
            max_ragged_batch_size=64, max_ragged_sequence_count=4, max_tracked_sequences=8,
            max_context=128)), params=params, device=cuda)


def test_chained_async_burst_on_card_equals_sync_under_sync_debug(cuda):
    """On the card a chained pipelined burst dispatches with no
    synchronizing call (``set_sync_debug_mode("error")`` around its
    dispatch), its tokens come down through its own pinned copy, and two
    chained bursts emit what two synchronous bursts emit, greedy and
    sampled, with the same KV launches a forward; then schedulers on a
    pipelined and a synchronous engine give the same streams."""
    from deepspeed_tpu_torch.inference.v2 import DynamicSplitFuseScheduler
    from deepspeed_tpu_torch.ops.kernels.fused_quant_matmul import dense_matmul
    from deepspeed_tpu_torch.ops.kernels.paged_attention import paged_decode_attention
    engines = [_async_engine(cuda, False), _async_engine(cuda, True)]
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, 256, n).astype(np.int32) for n in (13, 30, 22)]
    uids = [1, 2, 3]
    spec = [{"temperature": 1.1, "top_k": 24, "seed": 8 + i} for i in range(3)]
    for sample in (None, spec):
        first = [np.concatenate([e.put([u], [p], sample=[sample[i]] if sample else "greedy")
                                 for i, (u, p) in enumerate(zip(uids, prompts))])
                 for e in engines]
        assert first[0].tolist() == first[1].tolist()
        sync, eng = engines
        a0, a1, f0 = paged_decode_attention.launches, dense_matmul.launches, sync.forward_steps
        want = [sync.decode_burst(uids, [[int(t)] for t in first[0]], 8, sample=sample)]
        want.append(sync.decode_burst(uids, [[int(t)] for t in want[0][-1]], 8, sample=sample))
        per_sync = ((paged_decode_attention.launches - a0) / (sync.forward_steps - f0),
                    (dense_matmul.launches - a1) / (sync.forward_steps - f0))
        a0, a1, f0 = paged_decode_attention.launches, dense_matmul.launches, eng.forward_steps
        h0 = eng.decode_burst_async(uids, [[int(t)] for t in first[1]], 8, sample=sample)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            h1 = eng.decode_burst_async(uids, None, 8, sample=sample, prev=h0)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert h0._host.is_pinned() and h1._event is not None
        got = [h0.fetch(), h1.fetch()]
        assert all(np.array_equal(g, w) for g, w in zip(got, want)), sample
        assert ((paged_decode_attention.launches - a0) / (eng.forward_steps - f0),
                (dense_matmul.launches - a1) / (eng.forward_steps - f0)) == per_sync == (2, 15)
        for e in engines:
            for u in uids:
                e.flush(u)

    def run(engine, uid0, sample):
        sched = DynamicSplitFuseScheduler(engine, token_budget=64, max_burst=8)
        for i, p in enumerate(prompts):
            sched.add_request(uid0 + i, p, max_new_tokens=30, sample=sample[i] if sample else None)
        out = sched.run_to_completion()
        return [out[uid0 + i] for i in range(len(prompts))]
    for sample in (None, spec):
        assert run(engines[1], 100, sample) == run(engines[0], 100, sample)
    assert engines[1].bursts["async"] > 0 and engines[0].bursts["async"] == 0


def test_sanitize_gate_on_card(cuda, monkeypatch):
    """``DS_SANITIZE=1`` on the card: a clean pipelined run equals the
    unsanitized engine's, and a NaN-poisoned weight raises
    ``SanitizerNaNError`` at the next forward; off, the forward is the
    gate's input itself."""
    from deepspeed_tpu_torch.inference.v2 import DynamicSplitFuseScheduler, InferenceEngineV2
    from deepspeed_tpu_torch.utils.sanitize import SanitizerNaNError
    plain = _async_engine(cuda, True)
    assert plain._forward.__func__ is InferenceEngineV2._forward
    monkeypatch.setenv("DS_SANITIZE", "1")
    checked = _async_engine(cuda, True)
    assert checked._forward._ds_sanitized
    rng = np.random.RandomState(9)
    prompts = [rng.randint(0, 256, n).astype(np.int32) for n in (11, 27)]

    def run(engine):
        sched = DynamicSplitFuseScheduler(engine, token_budget=64, max_burst=8)
        for i, p in enumerate(prompts):
            sched.add_request(i, p, max_new_tokens=20)
        return sched.run_to_completion()
    assert run(checked) == run(plain)
    checked.params = dict(checked.params, norm=torch.full_like(checked.params["norm"],
                                                               float("nan")))
    with pytest.raises(SanitizerNaNError):
        checked.put([5], [prompts[0]], sample="greedy")


# ------------------------------------------------------- gateway, weight refresh
def _greedy(engine, prompts, uid0, new=24):
    from deepspeed_tpu_torch.inference.v2 import DynamicSplitFuseScheduler
    sched = DynamicSplitFuseScheduler(engine, token_budget=64, max_burst=8)
    for i, p in enumerate(prompts):
        sched.add_request(uid0 + i, p, max_new_tokens=new)
    out = sched.run_to_completion()
    for i in range(len(prompts)):
        sched.retire(uid0 + i)
    return [out[uid0 + i] for i in range(len(prompts))]


def test_gateway_streams_on_card_equal_direct_run(cuda):
    """Client threads submit and stream through a gateway whose pump thread
    drives the card: every stream equals the direct scheduler's on the
    same engine, and ``drain`` destroys the engine and frees its KV pool."""
    import threading
    from deepspeed_tpu_torch.serving import ServingConfig, ServingGateway
    engine = _async_engine(cuda, False)
    rng = np.random.RandomState(11)
    prompts = [rng.randint(0, 256, n).astype(np.int32) for n in (9, 30, 17, 22, 5, 12)]
    want = _greedy(engine, prompts, 0)
    gw = ServingGateway(engine, config=ServingConfig(token_budget=64, max_burst=8))
    streams = {}

    def client(i):
        streams[i] = list(gw.submit(prompts[i], max_new_tokens=24).tokens(timeout=120))
    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert [streams[i] for i in range(len(prompts))] == want
    c = gw.snapshot()["counters"]
    assert c["completed"] == len(prompts) and c["failed"] == 0
    kv = engine.kv_cache.bytes()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(cuda)
    gw.drain(timeout=60)
    assert engine.kv_cache is None and gw.state == "stopped"
    assert before - torch.cuda.memory_allocated(cuda) >= kv


@pytest.mark.parametrize("mode", ["none", "int8"])
def test_swap_on_card_equals_cold_start(cuda, mode):
    """``swap_params`` on the card (int8: the new tree quantized there)
    serves what a cold start on the new weights serves, its params equal
    the cold start's byte for byte, and the streams moved."""
    from deepspeed_tpu_torch.inference.quantization import QuantizedWeight
    from deepspeed_tpu_torch.inference.v2 import (DSStateManagerConfig, InferenceEngineV2,
                                                  RaggedInferenceEngineConfig)
    from deepspeed_tpu_torch.models import init_params, llama_config
    cfg = llama_config("mixtral-debug" if mode == "int8" else "debug", hidden_size=256,
                       num_attention_heads=4, num_key_value_heads=2, num_hidden_layers=2)
    v0 = init_params(cfg, cuda, torch.bfloat16, torch.Generator(cuda).manual_seed(6), std=0.05)
    from chip_smoke import stepped  # the stand-in train step of phase 30
    v1 = stepped(v0, 1)
    ecfg = RaggedInferenceEngineConfig(
        kv_block_size=16, quantization={"quantization_mode": mode},
        state_manager=DSStateManagerConfig(max_ragged_batch_size=64, max_ragged_sequence_count=4,
                                           max_tracked_sequences=8, max_context=128))
    rng = np.random.RandomState(12)
    prompts = [rng.randint(0, 256, n).astype(np.int32) for n in (13, 30, 22)]
    engine = InferenceEngineV2(cfg, ecfg, params=v0, device=cuda)
    before = _greedy(engine, prompts, 0)
    v1_host = {k: ({n: w.cpu() for n, w in v.items()} if isinstance(v, dict) else v.cpu())
               for k, v in v1.items()}
    assert engine.swap_params(v1_host, 1) == 1 and engine.weight_version == 1
    cold = InferenceEngineV2(cfg, ecfg, params=v1, device=cuda)
    got = _greedy(engine, prompts, 100)
    assert got == _greedy(cold, prompts, 100) and got != before

    def parts(tree):
        for k, v in sorted(tree.items()):
            for n, w in (sorted(v.items()) if isinstance(v, dict) else [("", v)]):
                yield from ((w.values, w.scales) if isinstance(w, QuantizedWeight) else (w,))
    pairs = list(zip(parts(engine.params), parts(cold.params)))
    assert len(pairs) == len(list(parts(cold.params)))
    assert all(a.device.type == cuda.type and torch.equal(a, b) for a, b in pairs)
    if mode == "int8":
        assert any(isinstance(w, QuantizedWeight) for w in engine.params["layers"].values())


def test_publication_of_cuda_tensors_round_trips(cuda, tmp_path, monkeypatch):
    """A tree of CUDA tensors (bf16, fp32, int8, a 0-d leaf) publishes leaf
    by leaf in chunks and loads back as CPU tensors bit for bit."""
    from deepspeed_tpu_torch.serving import WeightPublisher
    from deepspeed_tpu_torch.serving.refresh import publisher
    monkeypatch.setattr(publisher, "_CHUNK_BYTES", 1 << 16)
    g = torch.Generator(cuda).manual_seed(13)
    tree = {"layers": {"wq": torch.randn(2, 256, 384, generator=g, device=cuda).to(torch.bfloat16),
                       "norm": torch.rand(2, 256, generator=g, device=cuda)},
            "q": torch.randint(-128, 127, (64, 96), generator=g, device=cuda).to(torch.int8),
            "step": torch.tensor(7, device=cuda)}
    pub = WeightPublisher(tmp_path)
    manifest = pub.publish(tree)
    loaded, m = pub.load(1)
    assert m == manifest and manifest["tree"]["layers/wq"]["dtype"] == "bfloat16"
    for k in ("q", "step"):
        assert loaded[k].device.type == "cpu" and torch.equal(loaded[k], tree[k].cpu())
    for n in ("wq", "norm"):
        assert torch.equal(loaded["layers"][n], tree["layers"][n].cpu())
    assert loaded["step"].shape == ()



# ------------------------------------------------------- the fleet: two engines on one card
def _wide(cuda, layers=2):
    """Mistral-7B's widths at ``layers`` layers, bf16 weights on the card."""
    from deepspeed_tpu_torch.models import init_params, llama_config
    cfg = llama_config("mistral-7b", num_hidden_layers=layers)
    return cfg, init_params(cfg, cuda, torch.bfloat16, torch.Generator(cuda).manual_seed(21))


def _wide_engine(cuda, cfg, params, max_context=320):
    from deepspeed_tpu_torch.inference.v2 import (DSStateManagerConfig, InferenceEngineV2,
                                                  RaggedInferenceEngineConfig)
    return InferenceEngineV2(cfg, RaggedInferenceEngineConfig(
        kv_block_size=32, state_manager=DSStateManagerConfig(
            max_ragged_batch_size=512, max_ragged_sequence_count=8, max_tracked_sequences=8,
            max_context=max_context)), params=params, device=cuda)


def test_two_engines_two_pumps_one_card_equal_serial_runs(cuda):
    """Two engines over one weight tree, each behind its own gateway pump
    thread, serve traffic that grows the shared split-K workspace (decode
    buckets, and 512-token chunks over contexts past 512, where K3's tiled
    design takes it too) at the same time, the cache emptied before each
    round and the interpreter switching threads every 10 µs: each engine's
    streams equal its streams served alone, one engine after the other,
    three times over."""
    import sys
    import threading
    from deepspeed_tpu_torch.ops.kernels import fused_quant_matmul
    from deepspeed_tpu_torch.serving import ServingConfig, ServingGateway
    cfg, params = _wide(cuda)
    engines = [_wide_engine(cuda, cfg, params, max_context=1280) for _ in range(2)]
    rng = np.random.RandomState(22)
    traffic = [[rng.randint(0, 32000, n).astype(np.int32) for n in lens]
               for lens in ((1100, 600, 48, 200), (900, 700, 30, 64))]
    gws = [ServingGateway(e, config=ServingConfig(token_budget=512, max_burst=8))
           for e in engines]

    def serve(i, out):
        handles = [gws[i].submit(p, max_new_tokens=16) for p in traffic[i]]
        out[i] = [list(h.tokens(timeout=300)) for h in handles]
    alone = {}
    for i in range(2):
        serve(i, alone)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for _ in range(3):
            fused_quant_matmul._WORKSPACE.clear()  # both pumps grow it again, together
            together = {}
            threads = [threading.Thread(target=serve, args=(i, together)) for i in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            assert not any(t.is_alive() for t in threads)
            assert together == alone
    finally:
        sys.setswitchinterval(interval)
        for gw in gws:
            gw.shutdown()
    assert all(len(s) == 16 for streams in alone.values() for s in streams)


def _fleet_direct(cuda, cfg, params, prompts, new):
    """Greedy streams of a cold-started engine on ``params``."""
    engine = _wide_engine(cuda, cfg, params)
    out = _greedy(engine, prompts, 0, new)
    engine.destroy()
    return out


def test_fleet_failover_on_card_equals_direct_run(cuda):
    """Two replicas at 2 layers of Mistral-7B width over one weight tree
    behind a ``FleetRouter``; the first dies at its third streamed token:
    every request completes on the survivor with the direct run's stream
    (the replay verified token for token), and the dead replica is DOWN."""
    from deepspeed_tpu_torch.serving import (FaultyReplica, FleetConfig, FleetRouter,
                                             GatewayReplica, ServingConfig)
    cfg, params = _wide(cuda)
    rng = np.random.RandomState(23)
    prompts = [rng.randint(0, 32000, n).astype(np.int32) for n in (200, 17, 96, 250, 33, 128)]
    want = _fleet_direct(cuda, cfg, params, prompts, 24)
    scfg = ServingConfig(token_budget=512, max_burst=8)
    reps = [GatewayReplica(n, lambda: _wide_engine(cuda, cfg, params), serving_config=scfg)
            for n in ("r0", "r1")]
    router = FleetRouter([FaultyReplica(reps[0], crash_at_token=3), reps[1]],
                         config=FleetConfig(retry_backoff_s=0.01, stream_token_timeout_s=120),
                         auto_heartbeat=False)
    try:
        handles = [router.submit(p, max_new_tokens=24) for p in prompts]
        got = [[int(t) for t in h.tokens(timeout=300)] for h in handles]
        c = router.snapshot()["counters"]
        assert got == want
        assert c["failovers"] >= 1 and c["completed"] == len(prompts) and c["failed"] == 0
        assert router.health["r0"].state == "down"
    finally:
        router.shutdown()


def test_controller_rollout_on_card_canary_passes(cuda):
    """A ``FleetRefreshController`` rolls v1 (phase 30's stand-in train step
    on the card) over two replicas at 2 layers of Mistral-7B width, the
    canary a cold-started engine on the v1 tree: the canary passes, both
    replicas serve v1, and their probe streams equal the cold engine's and
    differ from v0's."""
    from chip_smoke import stepped
    from deepspeed_tpu_torch.serving import (FleetConfig, FleetRefreshController, FleetRouter,
                                             GatewayReplica, ServingConfig)
    cfg, v0 = _wide(cuda)
    v1 = stepped(v0, 1)
    probe = np.random.RandomState(24).randint(0, 32000, 160).astype(np.int32)
    scfg = ServingConfig(token_budget=512, max_burst=8)
    reps = [GatewayReplica(n, lambda: _wide_engine(cuda, cfg, v0), serving_config=scfg)
            for n in ("r0", "r1")]
    router = FleetRouter(reps, config=FleetConfig(refresh_timeout_s=120), auto_heartbeat=False)
    ctrl = FleetRefreshController(
        router, canary_prompts=[list(probe)], baseline_params=v0,
        reference_fn=lambda params, prompt, new: _fleet_direct(
            cuda, cfg, params, [np.asarray(prompt, np.int32)], new)[0])
    try:
        before = [int(t) for t in reps[0].submit(probe, max_new_tokens=16).tokens(timeout=300)]
        report = ctrl.rollout(version=1, params=v1)
        assert report["canary"] == "passed" and report["refreshed"] == ["r0", "r1"]
        assert not report["rolled_back"] and [r.weight_version() for r in reps] == [1, 1]
        after = [[int(t) for t in r.submit(probe, max_new_tokens=16).tokens(timeout=300)]
                 for r in reps]
        cold = _fleet_direct(cuda, cfg, v1, [probe], 16)[0]
        assert after == [cold, cold] and cold != before
    finally:
        router.shutdown()


# ------------------------------------------------------- the wire: a replica a process on one card
WIRE_ENGINE = {"kv_block_size": 32, "state_manager": {
    "max_ragged_batch_size": 512, "max_ragged_sequence_count": 8, "max_tracked_sequences": 8,
    "max_context": 320}}
WIRE_TIER = {"prefix_cache": {"enabled": True},
             "kv_tier": {"enabled": True, "host_bytes": 1 << 28, "quantize": False}}


def _wire_child_config(tier=False):
    """The replica entry point's config: 2 layers of Mistral-7B width on the
    card, the seed-0 weights the child draws itself."""
    return {"preset": "mistral-7b", "model": {"num_hidden_layers": 2}, "device": "cuda",
            "engine": dict(WIRE_ENGINE, **(WIRE_TIER if tier else {})),
            "serving": {"token_budget": 512, "max_burst": 8}}


def _wire_parent(cuda, tier=False):
    """The children's weights drawn in this process (seed 0, as
    ``InferenceEngineV2(params=None)`` draws them), and a factory of
    engines on them with the children's config."""
    from deepspeed_tpu_torch.inference.v2 import (DSStateManagerConfig, InferenceEngineV2,
                                                  RaggedInferenceEngineConfig)
    from deepspeed_tpu_torch.models import init_params, llama_config
    cfg = llama_config("mistral-7b", num_hidden_layers=2)
    params = init_params(cfg, cuda, torch.bfloat16)
    ecfg = dict(WIRE_ENGINE, **(WIRE_TIER if tier else {}))

    def make(tree=None):
        return InferenceEngineV2(cfg, RaggedInferenceEngineConfig(
            kv_block_size=ecfg["kv_block_size"],
            state_manager=DSStateManagerConfig(**ecfg["state_manager"]),
            **{k: v for k, v in ecfg.items() if k not in ("kv_block_size", "state_manager")}),
            params=params if tree is None else tree, device=cuda)
    return cfg, params, make


class _WireFleet:
    """Two replica processes of the port's entry point under a
    ``FleetSupervisor`` on unix sockets, reached by ``WireReplica``s; the
    run directory removed and the children stopped on exit."""

    def __init__(self, roles=("unified", "unified"), tier=False, env=None):
        import tempfile
        from deepspeed_tpu_torch.serving.fleet.wire import FleetSupervisor, ReplicaProcSpec
        self.names, self.roles = ("r0", "r1"), roles
        self.run_dir = tempfile.mkdtemp(prefix="dsw")
        specs = [ReplicaProcSpec(n, config=dict(_wire_child_config(tier), name=n), role=r,
                                 env=env or {}) for n, r in zip(self.names, roles)]
        self.sup = FleetSupervisor(specs, run_dir=self.run_dir, max_restarts=0,
                                   monitor_interval=0.2, watchdog_timeout=0, grace=10.0)
        self.clients = []

    def log(self, name):
        import os
        with open(os.path.join(self.run_dir, f"{name}.log")) as fd:
            return fd.read()

    def __enter__(self):
        import time
        from deepspeed_tpu_torch.serving.fleet.wire import WireReplica
        self.sup.start()
        try:
            for n, r in zip(self.names, self.roles):
                cli = WireReplica(n, self.sup.address(n, timeout=300.0), role=r, timeout_s=300.0,
                                  probe_timeout_s=5.0, connect_timeout_s=10.0, backoff_s=0.2)
                self.clients.append(cli)
                deadline = time.monotonic() + 300
                while not cli.probe():
                    if self.sup.stats()[n]["state"] != "running" or time.monotonic() > deadline:
                        raise AssertionError(f"replica {n} never served:\n{self.log(n)[-3000:]}")
                    time.sleep(0.2)
        except BaseException:
            self.__exit__(None, None, None)
            raise
        return self

    def __exit__(self, *exc):
        import shutil
        for cli in self.clients:
            cli.close()
        self.sup.stop()
        self.reports = {n: [line for line in self.log(n).splitlines()
                            if line.startswith(f"[ds_replica] {n} stopped ")]
                        for n in self.names}
        self.starts = {n: [line for line in self.log(n).splitlines()
                           if line.startswith(f"[ds_replica] {n} (")] for n in self.names}
        shutil.rmtree(self.run_dir, ignore_errors=True)


def _router_streams(router, prompts, new):
    handles = [router.submit(p, max_new_tokens=new) for p in prompts]
    return [[int(t) for t in h.tokens(timeout=300)] for h in handles]


def test_wire_fleet_on_card_equals_in_process_fleet(cuda):
    """Two replica processes at 2 layers of Mistral-7B width, each drawing
    the seed-0 weights itself, behind a ``FleetRouter`` over the wire:
    every stream equals a two-replica in-process fleet's on the same
    weights; each child stops cleanly and reports the card and its
    K3/K4/K2 launches a forward."""
    import json
    from deepspeed_tpu_torch.serving import (FleetConfig, FleetRouter, GatewayReplica,
                                             ServingConfig)
    cfg, params, make = _wire_parent(cuda)
    rng = np.random.RandomState(25)
    prompts = [rng.randint(0, 32000, n).astype(np.int32) for n in (200, 17, 96, 250, 33, 128)]
    scfg = ServingConfig(token_budget=512, max_burst=8)
    router = FleetRouter([GatewayReplica(n, make, serving_config=scfg) for n in ("r0", "r1")],
                         config=FleetConfig(retry_backoff_s=0.05, stream_token_timeout_s=300))
    try:
        want = _router_streams(router, prompts, 24)
    finally:
        router.shutdown()
    del params
    torch.cuda.empty_cache()
    with _WireFleet() as fleet:
        router = FleetRouter(fleet.clients, config=FleetConfig(retry_backoff_s=0.05,
                                                               stream_token_timeout_s=300))
        try:
            got = _router_streams(router, prompts, 24)
            c = router.snapshot()["counters"]
        finally:
            router.shutdown()
    assert got == want and c["completed"] == len(prompts) and c["failed"] == 0
    for name in fleet.names:
        assert len(fleet.reports[name]) == 1, fleet.reports
        report = json.loads(fleet.reports[name][0].split(" stopped ", 1)[1])
        n, got_l = report["forwards"], report["launches"]
        assert report["card"] and n > 0
        assert got_l == {"paged_decode_attention": 2 * n, "dense_matmul": 15 * n,
                         "rms_norm_fwd": 5 * n}
        assert report["paged_by_design"]["tiled"] == 2 * n
        assert report["dense_by_design"]["general"] == 0


def test_wire_publication_rollout_on_card_canary_passes(cuda):
    """v0 → v1 (phase 30's stand-in step) rolled over two replica
    processes by a ``FleetRefreshController`` as a ``PublicationRef``, the
    canary on (a cold engine in this process on the publication's v1):
    both processes load, verify and adopt it, and their probe streams
    equal the cold engine's; a publication with a flipped payload byte is
    rejected typed in the child, which keeps serving v1."""
    import shutil
    import tempfile
    from chip_smoke import stepped
    from deepspeed_tpu_torch.serving import FleetConfig, FleetRefreshController, FleetRouter
    from deepspeed_tpu_torch.serving.fleet.wire import PublicationRef
    from deepspeed_tpu_torch.serving.refresh import WeightPublisher
    from deepspeed_tpu_torch.utils.sanitize import WeightPublicationError
    cfg, v0, make = _wire_parent(cuda)
    v1 = stepped(v0, 1)
    root = tempfile.mkdtemp(prefix="dswpub")
    pub = WeightPublisher(root)
    pub.publish(v1, version=1)
    probe = np.random.RandomState(26).randint(0, 32000, 160).astype(np.int32)

    def cold(ref, prompt, new):
        tree, _ = WeightPublisher(ref.publish_dir).load(version=1)
        engine = make(tree)
        out = _greedy(engine, [np.asarray(prompt, np.int32)], 0, new)[0]
        engine.destroy()
        return out
    engine = make()
    want_v0 = _greedy(engine, [probe], 0, 16)[0]
    engine.destroy()
    del engine, v0, v1
    torch.cuda.empty_cache()
    try:
        with _WireFleet() as fleet:
            router = FleetRouter(fleet.clients, config=FleetConfig(refresh_timeout_s=300),
                                 auto_heartbeat=False)
            ctrl = FleetRefreshController(router, reference_fn=cold,
                                          canary_prompts=[list(probe)])
            try:
                before = [[int(t) for t in c.submit(probe, max_new_tokens=16).tokens(timeout=300)]
                          for c in fleet.clients]
                report = ctrl.rollout(version=1, params=PublicationRef(root))
                assert report["canary"] == "passed" and report["refreshed"] == ["r0", "r1"]
                assert not report["rolled_back"]
                assert [c.weight_version() for c in fleet.clients] == [1, 1]
                after = [[int(t) for t in c.submit(probe, max_new_tokens=16).tokens(timeout=300)]
                         for c in fleet.clients]
                pub.publish(stepped(pub.load(version=1)[0], 2), version=2)
                payload = f"{root}/v00000002/payload.bin"
                with open(payload, "r+b") as fd:
                    fd.seek(4096)
                    byte = fd.read(1)
                    fd.seek(4096)
                    fd.write(bytes([byte[0] ^ 0xFF]))
                with pytest.raises(WeightPublicationError):
                    fleet.clients[0].refresh(PublicationRef(root), 2, timeout=300)
                assert fleet.clients[0].weight_version() == 1
                again = [int(t) for t in
                         fleet.clients[0].submit(probe, max_new_tokens=16).tokens(timeout=300)]
            finally:
                router.shutdown()
        cold_v1 = cold(PublicationRef(root), probe, 16)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    assert before == [want_v0, want_v0]
    assert after[0] == after[1] == again == cold_v1 and cold_v1 != want_v0


def test_wire_disagg_pair_over_json_frames_equals_unified_pair(cuda, tmp_path, monkeypatch):
    """A prefill/decode pair of replica processes with the bf16 KV tier,
    every frame JSON on both ends (msgpack hidden from the children, and
    from this process): bf16 handoff records cross the wire as base64
    and the pair streams what a unified in-process pair streams, every
    handoff acked."""
    from deepspeed_tpu_torch.serving import (FleetConfig, FleetRouter, GatewayReplica,
                                             ServingConfig)
    from deepspeed_tpu_torch.serving.fleet.wire import codec
    cfg, params, make = _wire_parent(cuda, tier=True)
    rng = np.random.RandomState(27)
    prompts = [rng.randint(0, 32000, n).astype(np.int32) for n in (200, 96, 250, 128, 64, 160)]
    scfg = ServingConfig(token_budget=512, max_burst=8)
    router = FleetRouter([GatewayReplica(n, make, serving_config=scfg) for n in ("a", "b")],
                         config=FleetConfig(retry_backoff_s=0.05, stream_token_timeout_s=300))
    try:
        want = _router_streams(router, prompts, 24)
    finally:
        router.shutdown()
    del params
    torch.cuda.empty_cache()
    blocker = tmp_path / "no_msgpack" / "msgpack"
    blocker.mkdir(parents=True)
    (blocker / "__init__.py").write_text("raise ImportError('hidden: JSON frames only')\n")
    monkeypatch.setattr(codec, "_msgpack", None)
    with _WireFleet(roles=("prefill", "decode"), tier=True,
                    env={"PYTHONPATH": str(blocker.parent)}) as fleet:
        router = FleetRouter(fleet.clients, config=FleetConfig(
            disagg=True, prefill_max_tokens=2, retry_backoff_s=0.05,
            stream_token_timeout_s=300))
        try:
            got = _router_streams(router, prompts, 24)
            snap = router.snapshot()
        finally:
            router.shutdown()
    assert all(s[0].endswith(", J frames") for s in fleet.starts.values()), fleet.starts
    assert got == want and snap["counters"]["failed"] == 0
    assert snap["disagg"]["handoffs"]["acked"] == len(prompts)
    assert snap["counters"]["unified_fallbacks"] == 0
