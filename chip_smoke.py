#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Runs from the root of a checkout and needs one CUDA device; without one
it exits non-zero and prints no result. Imports nothing of JAX. Phases,
each of which fails the run if it fails:

1. device  — prints the card (``nvidia-smi`` name and power limit), torch
   and CUDA versions;
2. build   — builds every CUDA kernel of the port from ``csrc/`` (one
   ``nvcc`` per source) and prints what ptxas reports;
3. kernels — calls each kernel's wrapper at Mistral-7B attention shapes
   (H=32, Hkv=8, Dh=128, block 32, bf16): the serving run's decode and
   prefill steps, a decode batch over contexts 1..4096, a 512-token
   prefill chunk over 16 sequences, and edge rows (position 0, block
   boundaries, past the table, pad rows). Each result is held against the
   plain PyTorch version in fp32 on the same bf16 inputs (max-abs 2e-2:
   the kernel's bf16 output rounding), and timed with CUDA events, L2
   flushed before every launch, beside the plain version, one PyTorch
   library call (SDPA over the gathered dense KV, gather excluded) and
   the bound (bytes over 3.35 TB/s or flops over 989 TFLOP/s);
4. parity  — a 2-layer Mistral-7B-width engine through the kernel and one
   pinned to the plain ``torch_gather`` attention, same weights, odd
   token buckets (255 and 7, so the packed vector's views sit off 16-byte
   boundaries): a prefill put and a mixed prefill+decode put must give
   last-token logits within 2 bf16 ulps (at the largest logit's
   magnitude) of each other. Both attentions compute in fp32 and round
   only their output, so they differ by summation order, and the logits
   come out of a bf16 matmul;
5. serving — the full 32-layer Mistral-7B-width engine (random weights
   from a seeded generator) under ``DynamicSplitFuseScheduler``: 16
   requests x 128-token random prompts x 64 new tokens, block 32, budget
   512, bursts of 16. Every request must get 64 in-vocab tokens, the
   kernel's launch count must grow by layers x forward steps, and the
   pool must be empty again at the end. Prints tokens/s, steps, host
   syncs per token and peak memory, then profiles one prefill step and
   one decode burst of the same traffic (device time by kernel, device
   busy share);
6. train kernels — flash attention forward, dK/dV and dQ, and the RMS-norm
   forward at the training path's shapes (B=4, S=2048, H=16, Dh=128,
   causal; RMS on [8192, 2048]) and beside them S=1000 (not a tile
   multiple), 4 packed segments, non-causal, H=32 and Dh=64, all bf16.
   Each is held against its plain version on the same inputs, element by
   element at the scale each element lives at (``row_scaled_err``: |got -
   ref| in units of 2^-8 of |ref| + the rms of its row + the tensor's
   rms/16): o, dq, dk and dv within ROW_TOL = 6 units. The forward's
   output is bf16 against the plain version's fp32 (at most 1 unit) and
   the kernel rounds the p of P·V to bf16 (a random error of ~0.3 units of
   the row per sigma); the backward's outputs are bf16 on both sides (at
   most 2 units) and p and ds are rounded to bf16 on both sides, from
   scores summed in another order, so a rounding may fall the other way
   (readings up to 2.6 units, ``PERF.md``). Each check must also reject the
   kernel's output with its last 64-row tile zeroed (~200 units), so a
   wrong or missing query or key tile cannot pass. lse within 1e-3
   absolute (fp32, exp2 vs exp and summation order), RMS within one bf16
   ulp at each element's magnitude. Timed as in phase 3 beside the plain
   version, one library call (SDPA forward, SDPA's backward through
   autograd, ``F.rms_norm``) and the bound (max of flops over 989 TFLOP/s
   and bytes over 3.35 TB/s, flops counted over the valid (q, k) pairs of
   the case);
7. train parity — a 2-layer ``"1b"``-width model takes one ``train_batch``
   (gas 2, B=4, S=2048, bf16, Adam) twice from the same bf16 weights and
   batch: once through the kernels, once with the model's attention and
   norms pinned to the plain versions. The two differ by where bf16
   rounds: the kernels round p and ds to bf16 and take the backward's
   delta from the bf16 output, the plain versions do neither. The
   difference reads as noise: 1-2% of each parameter's gradient, in a
   direction that leaves the global norm within 3e-5. Limits, a few times the
   readings recorded in ``PERF.md``: each parameter's accumulated fp32
   gradient (read before the update) within GRAD_LEAF_TOL = 2^-4 of the
   plain run's in relative L2 norm, the loss within 2e-5 relative, the
   global grad norm within 2e-4 relative, and at most 1% of the updated
   fp32 master elements apart by more than lr/2 (Adam's first step is about
   ±lr per element, so this compares the gradients' signs; the leaf check
   compares their size);
8. training — the full 22-layer ``"1b"`` preset (1.24 B params) under
   ``bench.py``'s ``_train_config(4, 2)`` (bf16, Adam lr 1e-4, ZeRO stage
   3, gas 2), ``remat_policy="full"``, S=2048, random weights from a
   seeded generator and one fixed seeded batch: 1 warm-up step and 3 timed
   ``train_batch`` steps. Every loss must be finite and the loss must fall
   from the first step to the last; each kernel's launch count must grow
   by exactly what the path implies per step (flash forward 2·L·gas with
   the remat recompute, dK/dV and dQ L·gas each, RMS (4·L + 1)·gas); no
   parameter may be NaN. Prints ms per step, tokens/s, MFU (``bench.py``'s
   6N + 12·L·S·H flops per token against 989 TFLOP/s), peak memory and a
   profile of one step (device time by kernel, device busy share).

9. quant/grouped kernels — ``quant_matmul`` (K4) at Mixtral attention shapes
   ([4096, 4096] and [4096, 1024]; M = 8, 264, 37) for int8, fp8 and fp6,
   at [4096, 14336] / [14336, 4096] (M = 8, 264; int8, fp6), and at the
   head [4096, 32000] (M = 8, the decode step's last tokens; int8, fp8,
   fp6) with the group ``_quantize_grouped`` picks for it, 500; ``gmm``
   (bf16) and ``gmm_quant`` (int8, fp8, fp6) at Mixtral's expert stacks
   ([8, 4096, 14336] and [8, 14336, 4096]) over four routings: a decode
   burst step (8 tokens, top-2: 16 rows), a prefill chunk (264 tokens: 528
   rows), 16 rows with one expert empty, and all 528 rows on one expert.
   Group 512 elsewhere, bf16 x. Each case must (a) reproduce ``dequantize_grouped``
   in bf16 exactly when the x rows are one-hot over K (every K row of one
   expert for K5), (b) stay within QUANT_TOL = 4 units of
   ``row_scaled_err`` of its plain version on random x (both round the same
   bf16 weights; fp32 summation order and the output rounding differ:
   readings up to 1.51, ``PERF.md``), and (c) have that check reject its
   output with one 64-column tile (K4) or the busiest expert's rows (K5)
   zeroed. Timed beside the plain version, the bound (max of flops over
   989 TFLOP/s and carrier + scale + x + output bytes, touched experts
   only, over 3.35 TB/s), a library call (``torch.matmul`` on the
   pre-dequantized bf16 weight for K4; ``torch._grouped_mm`` on the bf16
   stack for K5, or the sum of per-expert ``torch.matmul`` times where
   this torch refuses it) and the unfused path (dequantize the stack,
   then the bf16 grouped kernel; for K4 the plain version is that path);
10. quant/MoE parity — a 2-layer Mixtral-8x7B-width engine with int8, fp6
   and bf16 experts, each run twice from the same bf16 weights: through
   the kernels, and with ``quant_matmul``, ``gmm`` and ``gmm_quant``
   pinned to their plain versions. The plain run replays the kernel run's
   expert choices (with its own gate values), since a near-tie in the
   router falls either way under the two runs' bf16 roundings and sends a
   token through another expert; the count of such ties is printed. A
   prefill put and a mixed put must give last-token logits within
   MOE_PATH_TOL_ULPS = 8 bf16 ulps at the largest logit's magnitude
   (readings 1.25-2.16); every launch count must be what the path implies;
11. quantized MoE serving — the full 32-layer ``mixtral-8x7b`` preset
   (46.7 B params) in int8, weights drawn into carriers by
   ``init_quantized_params`` from a seeded generator, under ``bench.py``'s
   ``bench_serving_2b_moe`` traffic: 8 requests x 256-token prompts x 64
   new tokens, block 32, token budget 264, bursts of 16. Every request must
   get 64 in-vocab tokens, the pool must be empty at the end, ``quant_matmul``
   must launch (4 per layer + 1 for the head) per forward and ``gmm_quant``
   3 per layer per forward (so every MoE FFN went through the kernels), and peak memory
   must stay under the card's. Prints tokens/s, ms per forward, host syncs
   per token, resident bytes, peak memory and a profile of one prefill step
   and one decode burst;
12. bf16 MoE serving — the same preset and traffic in bf16 at 8 of 32
   layers (the bf16 model does not fit one card at full depth); ``gmm``
   must launch 3 per layer per forward. Same prints.
13. LoRA kernel — ``lora_delta`` (K6) at the Mistral-7B LoRA sites, q_proj
   (and o_proj) [4096 -> 4096] and k_proj (and v_proj) [4096 -> 1024],
   rank buckets 8 and 16, 9 slots (8 adapters and the base), bf16: the
   decode step (T = 16, the 8 adapters round-robin) and a prefill chunk
   (T = 512 over 16 sequences) at each, and at q_proj rank 8 all-base and
   one-adapter batches, T = 37 as a view 2 bytes off alignment, and
   adapters of rank 5 padded to the bucket. Each case must (a) stay within
   LORA_TOL = 4 units of ``row_scaled_err`` of the plain version over the
   adapter rows (both sum fp32 products in other orders and round the
   scaled delta once to bf16: at most 2 units), (b) have that check reject
   the output with one slot's rows zeroed, (c) give 4 rows computed alone
   the same bits as in the mixed launch (row independence), and (d) leave
   base rows bitwise equal to y, the fused add being exactly round(y +
   delta). Timed beside the plain version, the layout (once per forward),
   the wrapper's host time per call (the all-base case, whose tiles exit at
   once),
   the bound (adapter rows' x, the touched slots' A and B, their y rows
   both ways, over 3.35 TB/s; fp32 FMAs over 67 TFLOP/s) and the library
   yardstick: two ``torch._grouped_mm`` calls over the slot-sorted,
   tile-padded rows (or per-slot ``torch.matmul`` times where this torch
   refuses them);
14. LoRA parity — a 2-layer Mistral-7B-width engine with the LoRA lane's
   8 adapters, through the kernel and with ``lora_delta`` pinned to its
   plain version, same weights: a prefill put and a mixed prefill+decode
   put (odd buckets 255 and 7) must give last-token logits within
   PATH_TOL_ULPS bf16 ulps, and the same puts with every request on the
   base must differ from the adapter run by more than 10x that (the check
   is not vacuous); K6 launches 4 x L per forward;
15. LoRA serving — the full 32-layer ``mistral-7b`` with LoRA on under
   ``bench.py``'s ``bench_serving_2b_lora`` traffic: 8 adapters of rank 8
   and alpha 16 on q, k, v and o (N(0, 0.02²) from a seeded generator),
   hot set 8, rank bucket 8, 16 requests x 128-token prompts x 64 new
   tokens, block 32, budget 512, bursts of 16. A warm-up, a base-only run
   (every request on slot 0, same engine), the single-adapter run and the
   mixed run (request i on adapter 1 + i % 8), in turn with the same
   traffic through an engine with LoRA off on the same weights (slice 1's
   path), whose streams the base-only run must reproduce bit for bit (a
   slot-0 tile leaves the projection untouched). The four runs go three
   times in turn and medians are printed: the forward is host-bound, and
   one run's speed varies by ~20% on that machine. Every request must get
   64 in-vocab tokens, each run's streams must repeat in every round, K6
   must launch 4 x 32 per forward in every LoRA run and the pool must be
   empty at the end. Then: isolation at fixed shapes (the
   mixed trace again with requests 3-14 on other adapters and 15 on the
   base: requests 0-2's streams bit-identical); slot moves (a 9th adapter
   evicts the least recently used one, which comes back in another slot:
   its requests' streams in a re-run of the mixed trace unchanged); a
   staged promotion (a 10th adapter, rank 5, prefetched and then bound:
   one ``stage_hit``, its slab rows bitwise the padded bf16 payload). The
   solo runs of the lane's isolation check are printed as a reading, not
   asserted: a request alone runs at smaller token buckets, where cuBLAS
   may pick another algorithm for the base GEMMs, so its bits may move
   for a reason that is not LoRA's. The engine is built with prefetch on
   for that check; the scheduler never kicks a prefetch, so the runs are
   the lane's (prefetch off). Prints tokens/s of each run,
   ``multi_vs_single``, the LoRA overhead against base-only and against
   LoRA off, ms per
   forward, host syncs per token, hot hit rate, promotions, peak memory,
   and a profile of one prefill step and one decode burst (K6's device ms
   and share, kernels per forward, busy share).

The last lines are the card, one JSON object with every kernel's numbers
and, last, ``{"ok": true, "device": {...}}``."""

import contextlib
import json
import math
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

H, HKV, DH, BS = 32, 8, 128, 32   # Mistral-7B attention, the serving block size
HBM_BYTES_PER_S = 3.35e12         # H100 SXM
BF16_FLOPS_PER_S = 989e12         # H100 SXM, dense
KERNEL_TOL = 2e-2
PATH_TOL_ULPS = 2
N_REQ, PROMPT, NEW, BUDGET, BURST = 16, 128, 64, 512, 16
TB, TS, TGAS, TLR = 4, 2048, 2, 1e-4  # bench.py's headline training shape, _train_config
ROW_TOL, LSE_TOL = 6.0, 1e-3  # phase 6, units of row_scaled_err; absolute
GRAD_LEAF_TOL = 2.0 ** -4     # phase 7, relative L2 norm of each leaf's gradient
QUANT_TOL = 4.0               # phase 9, units of row_scaled_err
MOE_PATH_TOL_ULPS = 8         # phase 10
# bench.py's bench_serving_2b_moe traffic: 8 requests x 256-token prompts x 64 new
# tokens, token budget prompt_len + n_req, bursts of 16 (KV block BS = 32)
MOE_N_REQ, MOE_PROMPT, MOE_NEW, MOE_BURST = 8, 256, 64, 16
MOE_BUDGET = MOE_PROMPT + MOE_N_REQ
MOE_BF16_LAYERS = 8           # phase 12: bf16 Mixtral-8x7B fits one card at 8 of 32 layers
ATTN_SHAPES = ((4096, 4096), (4096, 1024))   # Mixtral [K, N]: q and o; k and v
MLP_SHAPES = ((4096, 14336), (14336, 4096))  # a dense quantized MLP; the expert stacks'
HEAD_SHAPE = (4096, 32000)                   # Mixtral's lm_head [K, N]: groups of 500
FP32_FLOPS_PER_S = 67e12      # H100 SXM, fp32 outside the tensor cores
# bench.py's bench_serving_2b_lora: 8 adapters of rank 8, alpha 16 (scale 2), on q, k, v
# and o, N(0, 0.02²) weights; hot set 8; the serving traffic of phase 5
LORA_N_ADAPTERS, LORA_RANK, LORA_ALPHA, LORA_INIT = 8, 8, 16.0, 0.02
LORA_SHAPES = {"q_proj": (4096, 4096), "k_proj": (4096, 1024)}  # Mistral-7B [K, N]; o, v alike
LORA_TOL = 4.0                # phase 13, units of row_scaled_err
LORA_PATH_TOL_ULPS = PATH_TOL_ULPS  # phase 14
LORA_ROUNDS = 3               # phase 15: each run in turn, three times


def log(msg):
    print(msg, flush=True)


def time_ms(fn, flush, iters=20):
    """Median device ms of ``fn`` over ``iters`` launches, L2 flushed
    (a 256 MB write) before each, CUDA events around the call only."""
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in events]))


# ---------------------------------------------------------------- phase 3
def attention_case(seed, contexts, chunk, MB, device, pad_rows=0, extra_pos=()):
    """Sequences with ``contexts[i]`` tokens of which the last ``chunk``
    are this step's query tokens, each sequence on its own random blocks
    of one pool; ``extra_pos`` adds single rows at those positions and
    ``pad_rows`` rows on the all-null table at position 0, as the engine
    packs pad tokens. → dict of device tensors (bf16 q/kc/vc)."""
    rng = np.random.RandomState(seed)
    rows_pos, rows_seq = [], []
    for s, ctx in enumerate(contexts):
        for p in range(ctx - chunk, ctx):
            rows_pos.append(p)
            rows_seq.append(s)
    n_seq = len(contexts) + len(extra_pos)
    for j, p in enumerate(extra_pos):
        rows_pos.append(p)
        rows_seq.append(len(contexts) + j)
    NB = 1 + n_seq * MB
    perm = rng.permutation(np.arange(1, NB)).astype(np.int32).reshape(n_seq, MB)
    tables = perm[np.asarray(rows_seq)]
    pos = np.asarray(rows_pos, np.int32)
    if pad_rows:
        tables = np.concatenate([tables, np.zeros((pad_rows, MB), np.int32)])
        pos = np.concatenate([pos, np.zeros(pad_rows, np.int32)])
    T = len(pos)
    g = torch.Generator(device=device).manual_seed(seed)

    def rand(*shape):
        return torch.randn(shape, generator=g, device=device).to(torch.bfloat16)

    return {"q": rand(T, H, DH) * 2, "kc": rand(NB, BS, HKV, DH), "vc": rand(NB, BS, HKV, DH),
            "tables": torch.from_numpy(tables).to(device),
            "pos": torch.from_numpy(pos).to(device)}


def attention_bound(case):
    """(bound ms, 'bytes'|'operations', bytes, flops) for what this case's
    data needs: every K/V row some token attends read once, q read and
    the output written once, tables and positions read once."""
    tables, pos = case["tables"].cpu().numpy(), case["pos"].cpu().numpy()
    T, MB = tables.shape
    n_pos = np.minimum(pos.astype(np.int64) + 1, MB * BS)
    rows = np.unique(np.concatenate([
        tables[t, np.arange(n) // BS].astype(np.int64) * BS + np.arange(n) % BS
        for t, n in enumerate(n_pos)]))
    nbytes = (rows.size * HKV * DH * 2 * 2 + 2 * T * H * DH * 2 + tables.nbytes + pos.nbytes)
    flops = int(n_pos.sum()) * H * DH * 4
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


def sdpa_inputs(case):
    """Dense [T, H, C, Dh] K/V gathered from the pool and a [T, 1, 1, C]
    mask, for the library yardstick (never used by the port)."""
    kc, vc, tab, pos = case["kc"], case["vc"], case["tables"].long(), case["pos"].long()
    T = tab.shape[0]
    k = kc[tab].reshape(T, -1, HKV, DH).repeat_interleave(H // HKV, dim=2).transpose(1, 2)
    v = vc[tab].reshape(T, -1, HKV, DH).repeat_interleave(H // HKV, dim=2).transpose(1, 2)
    C = k.shape[2]
    mask = (torch.arange(C, device=kc.device)[None, :] <= pos[:, None])[:, None, None, :]
    return case["q"][:, :, None, :], k.contiguous(), v.contiguous(), mask


def kernel_phase(device, flush):
    from deepspeed_tpu_torch.ops.kernels.paged_attention import (paged_attention_ref,
                                                                 paged_decode_attention)
    F = torch.nn.functional
    serve_mb = math.ceil((PROMPT + NEW) / BS)
    cases = {
        # the serving run's steps: a decode burst step (16 sequences midway
        # through generation) and a prefill step (4 prompts fill the budget)
        "serving_decode": attention_case(1, [PROMPT + NEW // 2] * N_REQ, 1, serve_mb, device),
        "serving_prefill": attention_case(2, [PROMPT] * (BUDGET // PROMPT), PROMPT,
                                          serve_mb, device),
        "decode_4k": attention_case(3, np.linspace(1, 4096, 16).astype(int).tolist(), 1,
                                    4096 // BS, device),
        "prefill_chunk_512": attention_case(4, [480 + 32] * 16, 32, 16, device),
        "edges": attention_case(5, [1, 32, 33, 64, 65], 1, 3, device, pad_rows=3,
                                extra_pos=(95, 96 + 40)),
    }
    out = []
    for name, c in cases.items():
        args = (c["q"], c["kc"], c["vc"], c["tables"], c["pos"])
        got = paged_decode_attention(*args)
        want = paged_attention_ref(c["q"].float(), c["kc"].float(), c["vc"].float(),
                                   c["tables"], c["pos"])
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise AssertionError(f"kernel case {name}: non-finite output")
        err = (got.float() - want).abs().max().item()
        row = {"case": name, "T": int(args[0].shape[0]), "MB": int(args[3].shape[1]),
               "max_abs_err": err}
        if err > KERNEL_TOL:
            raise AssertionError(f"kernel case {name}: max-abs {err} > {KERNEL_TOL}")
        if name != "edges":
            sq, sk, sv, smask = sdpa_inputs(c)
            bound, by, nbytes, flops = attention_bound(c)
            row.update(
                ms=time_ms(lambda: paged_decode_attention(*args), flush),
                plain_ms=time_ms(lambda: paged_attention_ref(*args), flush),
                library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                    sq, sk, sv, attn_mask=smask), flush),
                bound_ms=bound, bound_by=by, bytes=nbytes, flops=flops)
            del sq, sk, sv, smask
        log(f"[kernels] paged_decode_attention {json.dumps(row)}")
        out.append(row)
    del cases
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- phase 4
def parity_phase(device):
    from deepspeed_tpu_torch.inference.v2 import (DSStateManagerConfig, InferenceEngineV2,
                                                  RaggedInferenceEngineConfig)
    from deepspeed_tpu_torch.models import init_params, llama_config
    cfg = llama_config("mistral-7b", num_hidden_layers=2)
    params = init_params(cfg, device, torch.bfloat16,
                         torch.Generator(device=device).manual_seed(1))
    # odd buckets: token_pos sits 8 bytes off a 16-byte boundary in the
    # packed vector, which the kernel must take
    sm = DSStateManagerConfig(max_ragged_batch_size=255, max_ragged_sequence_count=7,
                              max_tracked_sequences=8, max_context=256)
    engines = {}
    for impl in ("cuda_paged", "torch_gather"):
        ecfg = RaggedInferenceEngineConfig(kv_block_size=BS, state_manager=sm,
                                           implementation_overrides={"attention": impl})
        engines[impl] = InferenceEngineV2(cfg, ecfg, params=params, device=device)
        if engines[impl].attn_impl_name != impl:
            raise AssertionError(f"engine resolved {engines[impl].attn_impl_name}, not {impl}")
    rng = np.random.RandomState(7)
    toks = [rng.randint(0, cfg.vocab_size, n).astype(np.int32) for n in (100, 37, 64, 50, 9)]
    logits = {}
    for impl, eng in engines.items():
        # three prefills, then decodes for seqs 0 and 1, a fresh prompt
        # (seq 3) and a chunk continuing seq 2, in one ragged batch
        # in one ragged batch (bucket 255), then a pure decode (bucket 7)
        first = eng.put([0, 1, 2], toks[:3])
        mixed = eng.put([0, 1, 3, 2], [[11], [12], toks[3], toks[4]])
        decode = eng.put([0, 1, 2, 3], [[13], [14], [15], [16]])
        logits[impl] = (first, mixed, decode)
    errs = []
    for a, b in zip(logits["cuda_paged"], logits["torch_gather"]):
        if a.shape != b.shape or not (np.isfinite(a).all() and np.isfinite(b).all()):
            raise AssertionError("parity: bad logits shape or non-finite values")
        errs.append(float(np.abs(a - b).max()))
    scale = max(float(np.abs(b).max()) for b in logits["torch_gather"])
    ulp = 2.0 ** (math.floor(math.log2(scale)) - 7)  # bf16: 8-bit mantissa
    tol = PATH_TOL_ULPS * ulp
    log(f"[parity] 2-layer mistral-7b width, kernel vs torch_gather engine: max-abs "
        f"logits diff prefill={errs[0]:.5f} mixed={errs[1]:.5f} decode={errs[2]:.5f} "
        f"= {max(errs) / ulp:.3f} bf16 ulps (|logits| max {scale:.3f}, tol {tol})")
    if max(errs) > tol:
        raise AssertionError(f"parity: logits differ by {max(errs)} > {tol}")
    for eng in engines.values():
        eng.destroy()
    del params, engines
    torch.cuda.empty_cache()
    return max(errs)


# ---------------------------------------------------------------- phase 5
def add_requests(engine, n, plen, ntok, seed, budget=BUDGET, burst=BURST, adapters=None):
    from deepspeed_tpu_torch.inference.v2 import DynamicSplitFuseScheduler
    rng = np.random.RandomState(seed)
    sched = DynamicSplitFuseScheduler(engine, token_budget=budget, max_burst=burst)
    for uid in range(n):
        sched.add_request(uid, rng.randint(0, engine.model_config.vocab_size,
                                           size=plen).astype(np.int32), max_new_tokens=ntok,
                          adapter_id=None if adapters is None else adapters[uid])
    return sched


def run_requests(engine, n, plen, ntok, seed, budget=BUDGET, burst=BURST):
    sched = add_requests(engine, n, plen, ntok, seed, budget, burst)
    steps = 0
    while sched.has_work:
        sched.step()
        steps += 1
        if steps > 10000:
            raise AssertionError("scheduler stalled")
    return {uid: list(r.generated) for uid, r in sched.requests.items()}, steps


def serving_phase(device):
    from deepspeed_tpu_torch.inference.v2 import (DSStateManagerConfig, InferenceEngineV2,
                                                  RaggedInferenceEngineConfig)
    from deepspeed_tpu_torch.models import llama_config
    from deepspeed_tpu_torch.models.llama import count_params
    from deepspeed_tpu_torch.ops.kernels.paged_attention import paged_decode_attention
    cfg = llama_config("mistral-7b")
    ecfg = RaggedInferenceEngineConfig(
        kv_block_size=BS,
        state_manager=DSStateManagerConfig(max_ragged_batch_size=BUDGET,
                                           max_ragged_sequence_count=N_REQ,
                                           max_tracked_sequences=N_REQ,
                                           max_context=PROMPT + NEW))
    t0 = time.perf_counter()
    engine = InferenceEngineV2(cfg, ecfg, device=device,
                               generator=torch.Generator(device=device).manual_seed(0))
    torch.cuda.synchronize()
    log(f"[serving] mistral-7b: {count_params(engine.params) / 1e9:.3f} B params, "
        f"attention={engine.attn_impl_name}, kv pool {engine.kv_cache.bytes() / 1e9:.3f} GB, "
        f"built in {time.perf_counter() - t0:.2f} s")
    if engine.attn_impl_name != "cuda_paged":
        raise AssertionError(f"serving engine resolved {engine.attn_impl_name}")
    free0 = engine.free_blocks
    run_requests(engine, 2, 16, NEW // 2, seed=1)  # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    syncs0, toks0, fwd0 = engine.host_syncs, engine.tokens_emitted, engine.forward_steps

    paged_decode_attention.launches = 0
    t0 = time.perf_counter()
    streams, steps = run_requests(engine, N_REQ, PROMPT, NEW, seed=0)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = paged_decode_attention.launches

    fwd = engine.forward_steps - fwd0
    syncs, toks = engine.host_syncs - syncs0, engine.tokens_emitted - toks0
    if launches == 0 or launches != cfg.num_hidden_layers * fwd:
        raise AssertionError(f"kernel launches {launches} != layers x forward steps "
                             f"{cfg.num_hidden_layers} x {fwd}")
    if sorted(streams) != list(range(N_REQ)):
        raise AssertionError(f"requests served: {sorted(streams)}")
    for uid, toks_u in streams.items():
        if len(toks_u) != NEW or not all(0 <= t < cfg.vocab_size for t in toks_u):
            raise AssertionError(f"request {uid}: {len(toks_u)} tokens, want {NEW} in vocab")
    if engine.free_blocks != free0:
        raise AssertionError(f"free blocks {engine.free_blocks} != {free0} after flushes")
    result = {"requests": N_REQ, "prompt_len": PROMPT, "new_tokens": NEW,
              "token_budget": BUDGET, "max_burst": BURST, "steps": steps,
              "forward_steps": fwd, "time_s": dt, "ms_per_forward": dt * 1e3 / fwd,
              "gen_tokens_per_sec": N_REQ * NEW / dt,
              "total_tokens_per_sec": N_REQ * (PROMPT + NEW) / dt,
              "host_syncs": syncs, "syncs_per_token": syncs / max(toks, 1),
              "kernel_launches": launches,
              "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(f"[serving] {json.dumps(result)}")
    log(f"[serving] request 0 first tokens: {streams[0][:8]}")
    result["profile"] = profile_steps(engine)
    engine.destroy()
    return result, launches


_CATEGORIES = (  # (category, name patterns: a substring, or a tuple of substrings that must
    # all appear), first match wins; K4 and K5 are instances of one template ("qgemm")
    ("lora_delta (K6)", ("lora_kernel",)),
    ("quant_matmul (K4)", (("qgemm_kernel", "false>"), "reduce_splits_kernel")),
    ("grouped_matmul (K5)", (("qgemm_kernel", "true>"),)),
    ("flash_attention (K1)", ("flash_fwd_kernel", "flash_bwd_dkv_kernel", "flash_bwd_dq_kernel")),
    ("rms_norm (K2)", ("rms_fwd_kernel",)),
    ("paged_attention (K3)", ("paged_decode_kernel",)),
    ("gemm", ("nvjet", "gemm", "cutlass", "xmma", "cublas")),
    ("multi-tensor (Adam, grad accumulation)", ("multi_tensor_apply",)),
    ("reductions", ("reduce_kernel",)),
    ("elementwise and copies", ("elementwise", "copy", "cat", "index", "scatter", "gather")),
)


def _category(name):
    for cat, keys in _CATEGORIES:
        if any(all(k in name for k in ((key,) if isinstance(key, str) else key))
               for key in keys):
            return cat
    return "other"


def _summarize(prof, wall_ms, forwards):
    from torch.autograd import DeviceType
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue  # host ops: their device time is counted by their kernels
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        if dev_us > 0:
            rows.append((ev.key, dev_us / 1e3, ev.count))
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    by_category = {}
    for name, ms, _ in rows:
        cat = _category(name)
        by_category[cat] = by_category.get(cat, 0.0) + ms
    out = {"forwards": forwards, "wall_ms": wall_ms, "device_ms": busy,
           "device_busy_share": busy / wall_ms if rows else None,
           "kernels_launched": sum(r[2] for r in rows),
           "by_category_ms": dict(sorted(by_category.items(), key=lambda kv: -kv[1])),
           "top": [{"name": n[:70], "ms": ms, "calls": c} for n, ms, c in rows[:12]]}
    if not rows:
        out["note"] = "profiler recorded no device time: not measured"
    return out


def profile_steps(engine, traffic=(N_REQ, PROMPT, NEW, BUDGET, BURST), adapters=None):
    """The same traffic (requests, prompt, new tokens, budget, burst) once
    more, with torch.profiler around two scheduler steps only (its
    post-processing grows with the events): the first (a full-budget
    prefill step) and the first decode burst. ``adapters`` gives request
    i its adapter id. → device time by kernel and the device's busy share
    of each step's wall time."""
    from torch.profiler import ProfilerActivity, profile
    n, plen, ntok, budget, burst = traffic
    sched = add_requests(engine, n, plen, ntok, 0, budget, burst, adapters)
    out = {}
    while sched.has_work:
        live = [r for r in sched.requests.values() if not r.done]
        kind = "prefill_step" if not out else (
            "decode_burst" if "decode_burst" not in out
            and all(r.next_token is not None for r in live) else None)
        if kind is None:
            sched.step()
            continue
        f0 = engine.forward_steps
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            sched.step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        out[kind] = _summarize(prof, wall_ms, engine.forward_steps - f0)
        log(f"[profile] {kind} {json.dumps(out[kind])}")
    return out

# ---------------------------------------------------------------- phase 6
def flash_case(seed, B, S, H, D, causal, n_seg, device):
    """bf16 q/k/v/do [B, S, H, D] and, when ``n_seg``, int32 segment ids
    [B, S] cutting each row into ``n_seg`` packed sequences."""
    g = torch.Generator(device=device).manual_seed(seed)

    def rand(*shape):
        return torch.randn(shape, generator=g, device=device).to(torch.bfloat16)

    seg = None
    if n_seg:
        rng = np.random.RandomState(seed)
        cuts = np.sort(rng.choice(np.arange(1, S), n_seg - 1, replace=False))
        seg = torch.from_numpy(np.searchsorted(cuts, np.arange(S), side="right")
                               .astype(np.int32)).repeat(B, 1).to(device)
    return {"q": rand(B, S, H, D), "k": rand(B, S, H, D), "v": rand(B, S, H, D),
            "do": rand(B, S, H, D), "seg": seg, "causal": causal}


def valid_pairs(c):
    """(query, key) pairs the mask admits, summed over batch rows."""
    B, S = c["q"].shape[:2]
    if c["seg"] is None:
        sizes = np.full((B, 1), S)
    else:
        sizes = np.stack([np.bincount(r) for r in c["seg"].cpu().numpy()])
    per = sizes * (sizes + 1) // 2 if c["causal"] else sizes * sizes
    return int(per.sum())


def bound(nbytes, flops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def max_abs(got, want):
    return (got.float() - want.float()).abs().max().item()


def zero_last_tile(x):
    """``x`` [B, S, H, D] with its last 64 rows of S zeroed: what a kernel
    that skipped its last query or key tile would return."""
    y = x.clone()
    y[:, -64:] = 0
    return y


def flash_kernel_cases(c, name, flush):
    """Forward, dK/dV and dQ of one case against their plain versions,
    each timed beside its plain version, the library call and its bound →
    three result rows."""
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    F = torch.nn.functional
    q, k, v, do, seg, causal = c["q"], c["k"], c["v"], c["do"], c["seg"], c["causal"]
    B, S, H, D = q.shape
    o, lse = fa.flash_fwd(q, k, v, seg, causal)
    o_ref, lse_ref = fa.flash_fwd_ref(q.float(), k.float(), v.float(), seg, causal)
    delta = fa.flash_delta(o, do)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, seg, causal)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, seg, causal)
    dk_ref, dv_ref = fa.flash_bwd_dkv_ref(q, k, v, do, lse, delta, seg, causal)
    dq_ref = fa.flash_bwd_dq_ref(q, k, v, do, lse, delta, seg, causal)
    torch.cuda.synchronize()
    for t in (o, lse, dq, dk, dv):
        if not torch.isfinite(t.float()).all():
            raise AssertionError(f"flash case {name}: non-finite kernel output")
    outs = {"o": (o, o_ref), "dq": (dq, dq_ref), "dk": (dk, dk_ref), "dv": (dv, dv_ref)}
    errs = {t: fa.row_scaled_err(got, ref) for t, (got, ref) in outs.items()}
    zeroed = {t: fa.row_scaled_err(zero_last_tile(got), ref) for t, (got, ref) in outs.items()}
    lse_err = max_abs(lse, lse_ref)
    if max(errs.values()) > ROW_TOL or lse_err > LSE_TOL:
        raise AssertionError(f"flash case {name}: errors {errs} (units of row_scaled_err, "
                             f"limit {ROW_TOL}), lse {lse_err} (limit {LSE_TOL})")
    if min(zeroed.values()) <= ROW_TOL:
        raise AssertionError(f"flash case {name}: the check passes a zeroed last tile: {zeroed}")
    shape = {"case": name, "B": B, "S": S, "H": H, "Dh": D, "causal": causal,
             "segments": 0 if seg is None else int(seg.max().item()) + 1}
    rows = {
        "flash_fwd": dict(shape, max_abs_err=max_abs(o, o_ref), row_err=errs["o"],
                          zeroed_tile_row_err=zeroed["o"], lse_abs_err=lse_err),
        "flash_bwd_dkv": dict(shape, max_abs_err=max(max_abs(dk, dk_ref), max_abs(dv, dv_ref)),
                              row_err=max(errs["dk"], errs["dv"]),
                              zeroed_tile_row_err=min(zeroed["dk"], zeroed["dv"])),
        "flash_bwd_dq": dict(shape, max_abs_err=max_abs(dq, dq_ref), row_err=errs["dq"],
                             zeroed_tile_row_err=zeroed["dq"]),
    }
    del outs
    del o_ref, lse_ref, dk_ref, dv_ref, dq_ref
    pairs = valid_pairs(c)
    act = B * S * H * D * 2                     # one bf16 [B, S, H, D] tensor
    stats = B * H * S * 4                       # one fp32 [B, H, S] tensor
    segb = 0 if seg is None else seg.numel() * 4
    fwd_b, fwd_f = 4 * act + stats + segb, 4 * D * pairs * H
    dkv_b, dkv_f = 6 * act + 2 * stats + segb, 8 * D * pairs * H
    dq_b, dq_f = 5 * act + 2 * stats + segb, 6 * D * pairs * H
    mask = None
    if seg is not None:
        same = seg[:, None, :, None] == seg[:, None, None, :]
        causal_mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        mask = same & causal_mask if causal else same
    sq, sk, sv = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
    sdo = do.transpose(1, 2)

    def sdpa():
        return F.scaled_dot_product_attention(sq, sk, sv, attn_mask=mask,
                                              is_causal=causal and mask is None)

    s_out = sdpa()
    lib_bwd = time_ms(lambda: torch.autograd.grad(s_out, (sq, sk, sv), sdo,
                                                  retain_graph=True), flush)
    with torch.no_grad():
        lib_fwd = time_ms(sdpa, flush)
    for key, fn, plain, nb, nf, lib in (
            ("flash_fwd", lambda: fa.flash_fwd(q, k, v, seg, causal),
             lambda: fa.flash_fwd_ref(q, k, v, seg, causal), fwd_b, fwd_f, lib_fwd),
            ("flash_bwd_dkv", lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, seg, causal),
             lambda: fa.flash_bwd_dkv_ref(q, k, v, do, lse, delta, seg, causal),
             dkv_b, dkv_f, lib_bwd),
            ("flash_bwd_dq", lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, seg, causal),
             lambda: fa.flash_bwd_dq_ref(q, k, v, do, lse, delta, seg, causal),
             dq_b, dq_f, lib_bwd)):
        b_ms, b_by = bound(nb, nf)
        rows[key].update(ms=time_ms(fn, flush), plain_ms=time_ms(plain, flush),
                         library_ms=lib, bound_ms=b_ms, bound_by=b_by, bytes=nb, flops=nf)
    rows["flash_fwd"]["library_call"] = "scaled_dot_product_attention forward"
    for key in ("flash_bwd_dkv", "flash_bwd_dq"):
        rows[key]["library_call"] = "scaled_dot_product_attention backward (dq, dk, dv)"
    del s_out, sq, sk, sv
    return rows


def train_kernel_phase(device, flush):
    from deepspeed_tpu_torch.ops.kernels.fused_norms import rms_norm_fwd, rms_norm_ref
    F = torch.nn.functional
    cases = {  # name: (B, S, H, Dh, causal, segments)
        "path": (TB, TS, 16, 128, True, 0),
        "s1000": (2, 1000, 16, 128, True, 0),
        "packed_4_segments": (TB, TS, 16, 128, True, 4),
        "noncausal": (2, TS, 16, 128, False, 0),
        "h32": (2, TS, 32, 128, True, 0),
        "dh64": (TB, TS, 32, 64, True, 0),
    }
    out = {"flash_fwd": [], "flash_bwd_dkv": [], "flash_bwd_dq": [], "rms_norm_fwd": []}
    for i, (name, (B, S, H, D, causal, n_seg)) in enumerate(cases.items()):
        c = flash_case(10 + i, B, S, H, D, causal, n_seg, device)
        for key, row in flash_kernel_cases(c, name, flush).items():
            log(f"[train-kernels] {key} {json.dumps(row)}")
            out[key].append(row)
        del c
        torch.cuda.empty_cache()

    for name, rows, D in (("path", TB * TS, 2048), ("odd_rows", 37, 4104)):
        g = torch.Generator(device=device).manual_seed(rows)
        x = (torch.randn(rows, D, generator=g, device=device) * 3).to(torch.bfloat16)
        scale = (1 + 0.1 * torch.randn(D, generator=g, device=device)).to(torch.bfloat16)
        got = rms_norm_fwd(x, scale)
        want = rms_norm_ref(x.float(), scale.float())
        torch.cuda.synchronize()
        ulp_ok = (got.float() - want).abs() <= 2.0 ** -7 * want.abs() + 1e-6
        if not ulp_ok.all():
            raise AssertionError(f"rms case {name}: {int((~ulp_ok).sum())} elements beyond "
                                 f"one bf16 ulp")
        nb = 2 * x.numel() * 2 + D * 2
        b_ms, b_by = bound(nb, 4 * x.numel())
        row = {"case": name, "rows": rows, "D": D,
               "max_abs_err": (got.float() - want).abs().max().item(),
               "ms": time_ms(lambda: rms_norm_fwd(x, scale), flush),
               "plain_ms": time_ms(lambda: rms_norm_ref(x, scale), flush),
               "library_ms": time_ms(lambda: F.rms_norm(x, (D,), scale, 1e-5), flush),
               "library_call": "torch.nn.functional.rms_norm",
               "bound_ms": b_ms, "bound_by": b_by, "bytes": nb, "flops": 4 * x.numel()}
        log(f"[train-kernels] rms_norm_fwd {json.dumps(row)}")
        out["rms_norm_fwd"].append(row)
    return out


# ---------------------------------------------------------------- phase 7
@contextlib.contextmanager
def plain_train_kernels():
    """Pin the training model's attention and norms to the plain versions
    (autograd through ``flash_attention_ref`` and ``rms_norm_ref``)."""
    from deepspeed_tpu_torch.models import llama
    from deepspeed_tpu_torch.ops.kernels.flash_attention import flash_attention_ref
    from deepspeed_tpu_torch.ops.kernels.fused_norms import rms_norm_ref
    saved = llama.flash_attention, llama.fused_rms_norm
    llama.flash_attention = lambda q, k, v, causal=True: flash_attention_ref(q, k, v, causal)
    llama.fused_rms_norm = rms_norm_ref
    try:
        yield
    finally:
        llama.flash_attention, llama.fused_rms_norm = saved


def train_config(micro_batch, gas):
    """``bench.py``'s ``_train_config``: the shared ZeRO-3 bf16 config."""
    return {"train_batch_size": micro_batch * gas, "train_micro_batch_size_per_gpu": micro_batch,
            "gradient_accumulation_steps": gas, "bf16": {"enabled": True},
            "optimizer": {"type": "Adam", "params": {"lr": TLR}},
            "zero_optimization": {"stage": 3}, "steps_per_print": 1000000}


def train_batch_ids(vocab, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    ids = torch.randint(0, vocab, (TB * TGAS, TS), generator=g, device=device, dtype=torch.int32)
    return ids, ids.clone()


def train_parity_phase(device):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import build_llama
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    results = {}
    for mode in ("kernels", "plain"):
        model = build_llama("1b", device=device, num_hidden_layers=2,
                            generator=torch.Generator(device=device).manual_seed(2))
        engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=train_config(TB, TGAS),
                                                    device=device)
        names = [n for n, p in model.named_parameters() if p.requires_grad]
        grads = capture_grads(engine)
        before = fa.flash_fwd.launches
        with plain_train_kernels() if mode == "plain" else contextlib.nullcontext():
            loss = engine.train_batch(batch=train_batch_ids(model.config.vocab_size, device))
        torch.cuda.synchronize()
        launched = fa.flash_fwd.launches - before
        if (mode == "kernels") != (launched > 0):
            raise AssertionError(f"train parity {mode}: {launched} flash launches")
        results[mode] = (loss.item(), engine.global_grad_norm, grads,
                         [m.clone() for m in engine.master_params])
        engine.destroy()
        del model, engine
        torch.cuda.empty_cache()
    (lk, nk, gk, mk), (lp, np_, gp, mp) = results["kernels"], results["plain"]
    leaf = {n: ((a - b).norm() / b.norm()).item() for n, a, b in zip(names, gk, gp)}
    moved = sum(int(((a - b).abs() > TLR / 2).sum()) for a, b in zip(mk, mp))
    res = {"loss_kernels": lk, "loss_plain": lp, "loss_rel_diff": abs(lk - lp) / abs(lp),
           "grad_norm_kernels": nk, "grad_norm_plain": np_,
           "grad_norm_rel_diff": abs(nk - np_) / np_,
           "leaf_grad_rel_diff_max": max(leaf.values()),
           "leaf_grad_rel_diff_worst": max(leaf, key=leaf.get),
           "master_steps_moved_share": moved / sum(m.numel() for m in mp),
           "leaf_grad_rel_diff": leaf}
    log(f"[train-parity] 2-layer 1b width, gas {TGAS}, B={TB}, S={TS}: {json.dumps(res)}")
    if not (math.isfinite(lk) and math.isfinite(lp)) or res["loss_rel_diff"] > 2e-5 \
            or res["grad_norm_rel_diff"] > 2e-4 or max(leaf.values()) > GRAD_LEAF_TOL \
            or res["master_steps_moved_share"] > 0.01:
        raise AssertionError(f"train parity over its limits: {res}")
    return res


def capture_grads(engine):
    """→ a list that ``engine.step()`` fills with a copy of the accumulated
    fp32 gradients, one per parameter, just before it applies them."""
    grads, step = [], engine.step

    def recording_step(*args, **kwargs):
        if engine.is_gradient_accumulation_boundary():
            grads[:] = [g.float().clone() for g in engine._grads_acc]
        return step(*args, **kwargs)

    engine.step = recording_step
    return grads


# ---------------------------------------------------------------- phase 8
def model_flops(n_params, tokens, layers, seq, hidden):
    """``bench.py``'s ``_model_flops``: 6N per token + 12·L·S·H."""
    return 6.0 * n_params * tokens + 12.0 * layers * seq * hidden * tokens


def training_phase(device):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import build_llama
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    from deepspeed_tpu_torch.ops.kernels.fused_norms import rms_norm_fwd
    t0 = time.perf_counter()
    model = build_llama("1b", device=device, remat=True, remat_policy="full",
                        generator=torch.Generator(device=device).manual_seed(0))
    cfg = model.config
    L = cfg.num_hidden_layers
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=train_config(TB, TGAS),
                                                device=device)
    n_params = sum(p.numel() for p in model.parameters())
    torch.cuda.synchronize()
    log(f"[training] 1b: {n_params / 1e9:.4f} B params, {L} layers, built in "
        f"{time.perf_counter() - t0:.2f} s")
    batch = train_batch_ids(cfg.vocab_size, device)
    counters = {"flash_fwd": fa.flash_fwd, "flash_bwd_dkv": fa.flash_bwd_dkv,
                "flash_bwd_dq": fa.flash_bwd_dq, "rms_norm_fwd": rms_norm_fwd}
    per_step = {"flash_fwd": 2 * L * TGAS, "flash_bwd_dkv": L * TGAS, "flash_bwd_dq": L * TGAS,
                "rms_norm_fwd": (4 * L + 1) * TGAS}
    for fn in counters.values():
        fn.launches = 0
    losses = [engine.train_batch(batch=batch).item()]  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_s = []
    for _ in range(3):
        t1 = time.perf_counter()
        loss = engine.train_batch(batch=batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t1)
        losses.append(loss.item())
    launches = {k: fn.launches for k, fn in counters.items()}
    for k, n in launches.items():
        if n != 4 * per_step[k]:
            raise AssertionError(f"{k}: {n} launches over 4 steps, want 4 x {per_step[k]}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"losses not finite and falling: {losses}")
    if any(torch.isnan(p).any().item() for p in model.parameters()):
        raise AssertionError("NaN in a parameter after training")
    tokens = TB * TGAS * TS
    mean_s = float(np.mean(step_s))
    res = {"layers": L, "params": n_params, "micro_batch": TB, "gas": TGAS, "seq": TS,
           "tokens_per_step": tokens, "losses": losses, "step_ms": [s * 1e3 for s in step_s],
           "ms_per_step": mean_s * 1e3, "tokens_per_sec": tokens / mean_s,
           "mfu": model_flops(n_params, tokens, L, TS, cfg.hidden_size) / mean_s
           / BF16_FLOPS_PER_S,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches_per_step": per_step, "launches": launches,
           "grad_norm": engine.global_grad_norm}
    log(f"[training] {json.dumps(res)}")
    res["profile"] = profile_train_step(engine, batch)
    engine.destroy()
    del model, engine
    torch.cuda.empty_cache()
    return res, launches


def profile_train_step(engine, batch):
    """One more ``train_batch`` under torch.profiler → device time by kernel
    and the device's busy share of the step's wall time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.train_batch(batch=batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    out = _summarize(prof, wall_ms, 1)
    log(f"[profile] train_step {json.dumps(out)}")
    return out



# ---------------------------------------------------------------- phase 9
def quant_inputs(seed, M, shape, scheme, device):
    """bf16 x [M, K] and the ``scheme`` carriers of a random bf16 weight of
    ``shape`` ([K, N], or [E, K, N]), grouped as the serving path groups
    it: 512, or the largest width under it that divides N (500 for the
    head)."""
    from deepspeed_tpu_torch.inference.quantization.quantization import _quantize_grouped
    g = torch.Generator(device=device).manual_seed(seed)
    w = torch.randn(shape, generator=g, device=device, dtype=torch.bfloat16) * 0.02
    x = torch.randn(M, shape[-2], generator=g, device=device).to(torch.bfloat16)
    return x, (w if scheme == "bf16" else _quantize_grouped(w, scheme, 512))


def carrier_bytes(q, experts):
    """Bytes of the listed experts of a stack: bf16 weights, or quantized
    carriers and their scales."""
    if isinstance(q, torch.Tensor):
        return q[0].nbytes * len(experts)
    return (q.values[0].nbytes + q.scales[0].nbytes) * len(experts)


def zero_col_tile(y):
    """``y`` with one 64-column tile zeroed (the middle one): what a kernel
    that skipped a column tile would return."""
    z = y.clone()
    c = (y.shape[-1] // 64 // 2) * 64
    z[..., c:c + 64] = 0
    return z


def quant_matmul_cases(device, flush):
    """K4 at the Mixtral serving shapes, for every scheme. → rows."""
    from deepspeed_tpu_torch.ops.kernels.flash_attention import row_scaled_err
    from deepspeed_tpu_torch.ops.kernels.fused_quant_matmul import (dequantize_grouped,
                                                                     quant_matmul,
                                                                     quant_matmul_ref)
    cases = [(scheme, M, K, N) for scheme in ("int8", "fp8", "fp6")
             for (K, N) in ATTN_SHAPES for M in (8, 264, 37)]
    cases += [(scheme, M, K, N) for scheme in ("int8", "fp6") for (K, N) in MLP_SHAPES
              for M in (8, 264)]
    cases += [(scheme, 8) + HEAD_SHAPE for scheme in ("int8", "fp8", "fp6")]
    rows, exact_done = [], set()
    for i, (scheme, M, K, N) in enumerate(cases):
        x, q = quant_inputs(100 + i, M, (K, N), scheme, device)
        v, sc = q.values, q.scales
        name = f"quant_matmul {scheme} M={M} [{K}, {N}]"
        got = quant_matmul(x, v, sc, scheme)
        want = quant_matmul_ref(x, v, sc, scheme)
        torch.cuda.synchronize()
        if not torch.isfinite(got.float()).all():
            raise AssertionError(f"{name}: non-finite kernel output")
        err = row_scaled_err(got, want.float())
        zerr = row_scaled_err(zero_col_tile(got), want.float())
        if err > QUANT_TOL or zerr <= QUANT_TOL:
            raise AssertionError(f"{name}: row_scaled_err {err} (limit {QUANT_TOL}), zeroed "
                                 f"tile {zerr} (must exceed it)")
        row = {"case": f"{scheme}_M{M}_{K}x{N}", "scheme": scheme, "M": M, "K": K, "N": N,
               "group": N // sc.shape[-1], "max_abs_err": max_abs(got, want), "row_err": err,
               "zeroed_tile_row_err": zerr}
        w_bf16 = dequantize_grouped(v, sc, scheme, torch.bfloat16)
        if (scheme, K, N) not in exact_done:  # (a) one-hot rows: exact decode
            eye = torch.eye(K, device=device, dtype=torch.bfloat16)
            exact = torch.equal(quant_matmul(eye, v, sc, scheme), w_bf16)
            del eye
            if not exact:
                raise AssertionError(f"{name}: one-hot rows do not reproduce "
                                     f"dequantize_grouped exactly")
            exact_done.add((scheme, K, N))
            row["one_hot_exact"] = True
        nbytes = q.nbytes() + x.nbytes + M * N * 2
        b_ms, b_by = bound(nbytes, 2 * M * K * N)
        row.update(ms=time_ms(lambda: quant_matmul(x, v, sc, scheme), flush),
                   plain_ms=time_ms(lambda: quant_matmul_ref(x, v, sc, scheme), flush),
                   library_ms=time_ms(lambda: x @ w_bf16, flush),
                   library_call="torch.matmul on the pre-dequantized bf16 weight",
                   bound_ms=b_ms, bound_by=b_by, bytes=nbytes, flops=2 * M * K * N)
        row["unfused_ms"] = row["plain_ms"]  # the plain version is dequantize, then matmul
        log(f"[quant-kernels] {json.dumps(row)}")
        rows.append(row)
        del x, q, v, sc, w_bf16, got, want
    torch.cuda.empty_cache()
    return rows


def routing_sizes(case, device):
    """Rows per expert of a routing case over E = 8 → int64 [8] on device."""
    rng = np.random.RandomState(len(case))
    if case in ("decode", "prefill"):  # 8 or 264 tokens, top-2 of 8 experts
        tokens = 8 if case == "decode" else 264
        idx = np.concatenate([rng.choice(8, 2, replace=False) for _ in range(tokens)])
    elif case == "empty_expert":       # 16 rows over every expert but 6
        idx = rng.choice([0, 1, 2, 3, 4, 5, 7], 16)
    else:                              # all 528 prefill rows on expert 3
        idx = np.full(528, 3)
    return torch.from_numpy(np.bincount(idx, minlength=8)).to(device)


def grouped_cases(device, flush):
    """gmm (bf16) and gmm_quant (int8, fp8, fp6) at Mixtral's expert
    shapes over four routings. → {"gmm": rows, "gmm_quant": rows}."""
    from deepspeed_tpu_torch.ops.kernels import grouped_matmul as gm
    from deepspeed_tpu_torch.ops.kernels.flash_attention import row_scaled_err
    from deepspeed_tpu_torch.ops.kernels.fused_quant_matmul import dequantize_grouped, row_tile
    out = {"gmm": [], "gmm_quant": []}
    for si, (wname, (K, N)) in enumerate(zip(("w1", "w2"), MLP_SHAPES)):
        for scheme in ("bf16", "int8", "fp8", "fp6"):
            _, q = quant_inputs(200 + si, 1, (8, K, N), scheme, device)
            quant = scheme != "bf16"
            w_bf16 = (dequantize_grouped(q.values, q.scales, scheme, torch.bfloat16) if quant
                      else q)
            kernel = gm.gmm_quant if quant else gm.gmm
            key = "gmm_quant" if quant else "gmm"

            def run(xp, te, tm, used):
                if quant:
                    return gm.gmm_quant(xp, q.values, q.scales, te, scheme, torch.bfloat16, tm,
                                        used)
                return gm.gmm(xp, q, te, tm, used)

            def plain(xp, te, tm, used):
                if quant:
                    return gm.gmm_quant_ref(xp, q.values, q.scales, te, scheme, torch.bfloat16,
                                            tm, used)
                return gm.gmm_ref(xp, q, te, tm, used)

            # (a) expert 5 takes one-hot rows over all of K: exact decode
            sizes = torch.zeros(8, dtype=torch.int64, device=device)
            sizes[5] = K
            dst, te, Mp = gm.pad_groups_to_tiles(sizes, K, 64)
            xp = torch.zeros((Mp, K), dtype=torch.bfloat16, device=device)
            xp[dst.long()] = torch.eye(K, device=device, dtype=torch.bfloat16)
            got = run(xp, te, 64, gm.used_tiles(sizes, 64))
            if not torch.equal(got[:K], w_bf16[5]) or got[K:].any():
                raise AssertionError(f"{key} {scheme} {wname}: one-hot rows do not reproduce "
                                     f"the expert's weight exactly")
            del xp, got
            for case in ("decode", "prefill", "empty_expert", "one_expert"):
                sizes = routing_sizes(case, device)
                n = int(sizes.sum())
                tm = row_tile(-(-n // 8))
                dst, te, Mp = gm.pad_groups_to_tiles(sizes, n, tm)
                used = gm.used_tiles(sizes, tm)
                g = torch.Generator(device=device).manual_seed(7)
                xs = torch.randn(n, K, generator=g, device=device).to(torch.bfloat16)
                xp = torch.zeros((Mp, K), dtype=torch.bfloat16, device=device)
                xp[dst.long()] = xs
                name = f"{key} {scheme} {wname} {case}"
                got = run(xp, te, tm, used)
                want = plain(xp, te, tm, used)
                torch.cuda.synchronize()
                if not torch.isfinite(got.float()).all():
                    raise AssertionError(f"{name}: non-finite kernel output")
                err = row_scaled_err(got, want.float())
                # (c) the rows of the busiest expert zeroed
                busiest = int(sizes.argmax())
                start = int(((sizes[:busiest] + tm - 1) // tm * tm).sum())
                zeroed = got.clone()
                zeroed[start:start + int(sizes[busiest])] = 0
                zerr = row_scaled_err(zeroed, want.float())
                if err > QUANT_TOL or zerr <= QUANT_TOL:
                    raise AssertionError(f"{name}: row_scaled_err {err} (limit {QUANT_TOL}), "
                                         f"zeroed expert {zerr} (must exceed it)")
                touched = [e for e in range(8) if int(sizes[e])]
                nbytes = carrier_bytes(q, touched) + 2 * n * (K + N) + te.nbytes + 4
                b_ms, b_by = bound(nbytes, 2 * n * K * N)
                row = {"case": f"{scheme}_{wname}_{case}", "scheme": scheme, "weight": wname,
                       "rows": n, "tm": tm, "padded_rows": Mp, "K": K, "N": N,
                       "experts_touched": len(touched), "max_abs_err": max_abs(got, want),
                       "row_err": err, "zeroed_expert_row_err": zerr, "one_hot_exact": True,
                       "ms": time_ms(lambda: run(xp, te, tm, used), flush),
                       "plain_ms": time_ms(lambda: plain(xp, te, tm, used), flush, iters=5),
                       "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
                       "flops": 2 * n * K * N}
                row.update(grouped_library(xs, w_bf16, sizes, flush))
                if quant:  # dequantize the stack, then the bf16 grouped kernel
                    row["unfused_ms"] = time_ms(lambda: gm.gmm(
                        xp, dequantize_grouped(q.values, q.scales, scheme, torch.bfloat16), te,
                        tm, used), flush, iters=5)
                log(f"[grouped-kernels] {key} {json.dumps(row)}")
                out[key].append(row)
                del xs, xp, got, want, zeroed
            del q, w_bf16
            torch.cuda.empty_cache()
    return out


def grouped_library(xs, w_bf16, sizes, flush):
    """The yardstick for one grouped GEMM: ``torch._grouped_mm`` over the
    sorted rows and the bf16 stack where this torch has it and takes the
    case, else the sum of per-expert ``torch.matmul`` times."""
    offs = torch.cumsum(sizes, 0).to(torch.int32)
    if hasattr(torch, "_grouped_mm"):
        w_col = w_bf16.transpose(-2, -1).contiguous().transpose(-2, -1)
        try:
            torch._grouped_mm(xs, w_col, offs=offs)
            torch.cuda.synchronize()
        except RuntimeError as exc:  # this torch refuses the case: the per-expert sum below
            log(f"[grouped-kernels] torch._grouped_mm refused the case: {str(exc)[:120]}")
        else:
            ms = time_ms(lambda: torch._grouped_mm(xs, w_col, offs=offs), flush)
            return {"library_ms": ms, "library_call": "torch._grouped_mm"}
    bounds = [0] + offs.tolist()
    total = 0.0
    for e in range(w_bf16.shape[0]):
        if bounds[e + 1] > bounds[e]:
            xe = xs[bounds[e]:bounds[e + 1]]
            total += time_ms(lambda: xe @ w_bf16[e], flush)
    return {"library_ms": total, "library_call": "sum of per-expert torch.matmul"}


# ---------------------------------------------------------------- phase 10
@contextlib.contextmanager
def plain_serving_kernels():
    """Pin the serving path's quantized and grouped GEMMs to their plain
    versions (``quant_matmul_ref``, ``gmm_ref``, ``gmm_quant_ref``)."""
    from deepspeed_tpu_torch.inference.quantization import quantization as qmod
    from deepspeed_tpu_torch.ops.kernels import fused_quant_matmul as fq
    from deepspeed_tpu_torch.ops.kernels import grouped_matmul as gm
    saved = qmod.quant_matmul, gm.gmm, gm.gmm_quant
    qmod.quant_matmul, gm.gmm, gm.gmm_quant = fq.quant_matmul_ref, gm.gmm_ref, gm.gmm_quant_ref
    try:
        yield
    finally:
        qmod.quant_matmul, gm.gmm, gm.gmm_quant = saved


@contextlib.contextmanager
def routing(record, replay):
    """Record each MoE layer's top-k experts (``replay`` False), or make
    the router take the recorded ones, in call order, with its own gate
    values at those experts (``replay`` True). Yields a one-element list
    that counts the tokens whose own top-k set differed from the recorded
    one: near-ties that the two runs' bf16 roundings break differently."""
    from deepspeed_tpu_torch.inference.v2 import model_runner as mr
    orig, calls, flips = mr.top_k, iter(record), [0]

    def top_k(gates, k):
        vals, idx = orig(gates, k)
        if not replay:
            record.append(idx)
            return vals, idx
        want = next(calls)
        flips[0] += int((idx.sort(-1).values != want.sort(-1).values).any(-1).sum())
        return gates.gather(-1, want), want

    mr.top_k = top_k
    try:
        yield flips
    finally:
        mr.top_k = orig


def moe_counters():
    from deepspeed_tpu_torch.ops.kernels import fused_quant_matmul as fq
    from deepspeed_tpu_torch.ops.kernels import grouped_matmul as gm
    return {"quant_matmul": fq.quant_matmul, "gmm": gm.gmm, "gmm_quant": gm.gmm_quant}


def moe_launches_per_forward(L, mode):
    """What one forward of an L-layer MoE model launches: quant_matmul 4
    per layer (q, k, v, o) and 1 for the head; three grouped GEMMs per
    layer, gmm_quant when quantized, gmm in bf16."""
    quant = mode != "none"
    return {"quant_matmul": (4 * L + 1) if quant else 0, "gmm": 0 if quant else 3 * L,
            "gmm_quant": 3 * L if quant else 0}


def moe_parity_phase(device):
    from deepspeed_tpu_torch.inference.v2 import (DSStateManagerConfig, InferenceEngineV2,
                                                  RaggedInferenceEngineConfig)
    from deepspeed_tpu_torch.models import init_params, llama_config
    L = 2
    cfg = llama_config("mixtral-8x7b", num_hidden_layers=L)
    params = init_params(cfg, device, torch.bfloat16, torch.Generator(device=device).manual_seed(5))
    sm = DSStateManagerConfig(max_ragged_batch_size=255, max_ragged_sequence_count=7,
                              max_tracked_sequences=8, max_context=256)
    rng = np.random.RandomState(9)
    toks = [rng.randint(0, cfg.vocab_size, n).astype(np.int32) for n in (100, 37, 64, 50, 9)]
    counters = moe_counters()
    res = {}
    for mode in ("int8", "fp6", "none"):
        logits, record = {}, []
        for pin in ("kernels", "plain"):
            eng = InferenceEngineV2(cfg, RaggedInferenceEngineConfig(
                kv_block_size=BS, state_manager=sm, quantization={"quantization_mode": mode}),
                params=params, device=device)
            before = {k: f.launches for k, f in counters.items()}
            f0 = eng.forward_steps
            with plain_serving_kernels() if pin == "plain" else contextlib.nullcontext(), \
                    routing(record, replay=pin == "plain") as flips:
                first = eng.put([0, 1, 2], toks[:3])
                mixed = eng.put([0, 1, 3, 2], [[11], [12], toks[3], toks[4]])
            torch.cuda.synchronize()
            fwd = eng.forward_steps - f0
            grew = {k: f.launches - before[k] for k, f in counters.items()}
            per = moe_launches_per_forward(L, mode)
            want = {k: (per[k] * fwd if pin == "kernels" else 0) for k in counters}
            if grew != want:
                raise AssertionError(f"moe parity {mode} {pin}: launches {grew}, want {want}")
            logits[pin] = (first, mixed)
            eng.destroy()
            del eng
            torch.cuda.empty_cache()
        errs = []
        for a, b in zip(logits["kernels"], logits["plain"]):
            if a.shape != b.shape or not (np.isfinite(a).all() and np.isfinite(b).all()):
                raise AssertionError(f"moe parity {mode}: bad logits shape or non-finite values")
            errs.append(float(np.abs(a - b).max()))
        scale = max(float(np.abs(b).max()) for b in logits["plain"])
        ulp = 2.0 ** (math.floor(math.log2(scale)) - 7)
        res[mode] = {"prefill_abs": errs[0], "mixed_abs": errs[1], "ulps": max(errs) / ulp,
                     "logit_scale": scale, "routing_near_ties": flips[0],
                     "router_rows": sum(int(r.shape[0]) for r in record)}
        log(f"[moe-parity] 2-layer mixtral-8x7b width, {mode}, kernels vs plain: "
            f"{json.dumps(res[mode])} (limit {MOE_PATH_TOL_ULPS} ulps)")
        if max(errs) > MOE_PATH_TOL_ULPS * ulp:
            raise AssertionError(f"moe parity {mode}: logits differ by {max(errs) / ulp} ulps")
    del params
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------- phases 11, 12
def moe_serving_phase(device, mode, layers):
    """The ``mixtral-8x7b`` preset at ``layers`` layers, ``mode`` weights,
    under the quantized-MoE lane's traffic. → (result, launches)."""
    from deepspeed_tpu_torch.inference.v2 import (DSStateManagerConfig, InferenceEngineV2,
                                                  RaggedInferenceEngineConfig)
    from deepspeed_tpu_torch.models import llama_config
    from deepspeed_tpu_torch.models.llama import count_params
    cfg = llama_config("mixtral-8x7b", num_hidden_layers=layers)
    L = cfg.num_hidden_layers
    tag = f"moe-serving {mode} {L}L"
    ecfg = RaggedInferenceEngineConfig(
        kv_block_size=BS, quantization={"quantization_mode": mode},
        state_manager=DSStateManagerConfig(max_ragged_batch_size=MOE_BUDGET,
                                           max_ragged_sequence_count=MOE_N_REQ,
                                           max_tracked_sequences=MOE_N_REQ,
                                           max_context=MOE_PROMPT + MOE_NEW))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = InferenceEngineV2(cfg, ecfg, device=device,
                               generator=torch.Generator(device=device).manual_seed(0))
    torch.cuda.synchronize()
    build = {"params": count_params(engine.params), "resident_param_bytes": engine.quantized_bytes,
             "kv_pool_bytes": engine.kv_cache.bytes(), "build_s": time.perf_counter() - t0,
             "build_peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
             "allocated_gb": torch.cuda.memory_allocated() / 1e9}
    log(f"[{tag}] built: {json.dumps(build)}")
    traffic = (MOE_N_REQ, MOE_PROMPT, MOE_NEW, MOE_BUDGET, MOE_BURST)
    free0 = engine.free_blocks
    run_requests(engine, 2, 16, MOE_NEW // 2, 1, MOE_BUDGET, MOE_BURST)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    syncs0, toks0, fwd0 = engine.host_syncs, engine.tokens_emitted, engine.forward_steps
    counters = moe_counters()
    for f in counters.values():
        f.launches = 0
    t0 = time.perf_counter()
    streams, steps = run_requests(engine, MOE_N_REQ, MOE_PROMPT, MOE_NEW, 0, MOE_BUDGET,
                                  MOE_BURST)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k: f.launches for k, f in counters.items()}
    fwd = engine.forward_steps - fwd0
    per = moe_launches_per_forward(L, mode)
    if launches != {k: per[k] * fwd for k in per} or fwd == 0:
        raise AssertionError(f"{tag}: launches {launches} over {fwd} forwards, want "
                             f"{per} per forward")
    if sorted(streams) != list(range(MOE_N_REQ)):
        raise AssertionError(f"{tag}: requests served: {sorted(streams)}")
    for uid, toks_u in streams.items():
        if len(toks_u) != MOE_NEW or not all(0 <= t < cfg.vocab_size for t in toks_u):
            raise AssertionError(f"{tag}: request {uid}: {len(toks_u)} tokens, want "
                                 f"{MOE_NEW} in vocab")
    if engine.free_blocks != free0:
        raise AssertionError(f"{tag}: free blocks {engine.free_blocks} != {free0}")
    peak = torch.cuda.max_memory_allocated()
    card = torch.cuda.get_device_properties(device).total_memory
    if peak >= card:
        raise AssertionError(f"{tag}: peak memory {peak} >= the card's {card}")
    syncs, toks = engine.host_syncs - syncs0, engine.tokens_emitted - toks0
    result = dict(build, mode=mode, layers=L, requests=MOE_N_REQ, prompt_len=MOE_PROMPT,
                  new_tokens=MOE_NEW, token_budget=MOE_BUDGET, max_burst=MOE_BURST,
                  steps=steps, forward_steps=fwd, time_s=dt, ms_per_forward=dt * 1e3 / fwd,
                  gen_tokens_per_sec=MOE_N_REQ * MOE_NEW / dt,
                  total_tokens_per_sec=MOE_N_REQ * (MOE_PROMPT + MOE_NEW) / dt,
                  host_syncs=syncs, syncs_per_token=syncs / max(toks, 1),
                  launches=launches, launches_per_forward=per,
                  peak_memory_gb=peak / 1e9, card_memory_gb=card / 1e9)
    log(f"[{tag}] {json.dumps(result)}")
    log(f"[{tag}] request 0 first tokens: {streams[0][:8]}")
    result["profile"] = profile_steps(engine, traffic)
    engine.destroy()
    del engine
    torch.cuda.empty_cache()
    return result, launches


# ---------------------------------------------------------------- phase 13
def lora_inputs(seed, T, K, N, r, slots, device, offset=0, true_rank=None):
    """bf16 x [T, K] (a view ``offset`` elements into a larger buffer), y
    [T, N] (the base projection), the hot slabs of one layer of one site,
    a [S, K, r] / b [S, r, N] bf16 with slot 0 zero, and fp32 scales:
    ``alpha / true_rank`` with alpha 16 (the LoRA lane's), the adapters'
    columns past ``true_rank`` zero (the store's rank padding)."""
    g = torch.Generator(device=device).manual_seed(seed)
    S = LORA_N_ADAPTERS + 1
    buf = torch.randn(T * K + offset, generator=g, device=device).to(torch.bfloat16)
    x = buf[offset:].view(T, K)
    y = torch.randn(T, N, generator=g, device=device).to(torch.bfloat16)
    a = torch.randn(S, K, r, generator=g, device=device) * LORA_INIT
    b = torch.randn(S, r, N, generator=g, device=device) * LORA_INIT
    tr = true_rank or r
    a[:, :, tr:], b[:, tr:], a[0], b[0] = 0, 0, 0, 0
    scales = torch.full((S,), LORA_ALPHA / tr, device=device)
    scales[0] = 0
    return (x, y, a.to(torch.bfloat16).contiguous(), b.to(torch.bfloat16).contiguous(), scales,
            torch.as_tensor(slots, dtype=torch.int32, device=device))


def lora_slots(kind, T):
    """Adapter slot per token: ``rr`` decode rows round-robin over the 8
    adapters; ``chunk`` 16 sequences of T/16 tokens, sequence i on
    adapter 1 + i % 8; ``base`` all 0; ``one`` all on adapter 1."""
    if kind == "rr":
        return 1 + np.arange(T) % LORA_N_ADAPTERS
    if kind == "chunk":
        return 1 + (np.arange(T) // (T // 16)) % LORA_N_ADAPTERS
    return np.full(T, 0 if kind == "base" else 1)


def lora_bound(T_a, K, N, r, touched):
    """(ms, by, bytes, flops): the adapter rows' x read once, the touched
    slots' A and B read once, their y rows read and written once (bf16),
    and fp32 FMAs at the card's fp32 rate (no tensor cores: an mma would
    round h to bf16)."""
    nbytes = 2 * (T_a * K + touched * (K * r + r * N) + 2 * T_a * N)
    flops = 2 * T_a * r * (K + N)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


def lora_library(x, slots, a, b, flush):
    """The yardstick: two ``torch._grouped_mm`` calls over the slot-sorted,
    tile-padded rows (``x @ A_g`` then ``h @ B_g``, the layout made
    outside the timing; h rounds to bf16 between them), where this torch
    takes them, else the sum of per-slot ``torch.matmul`` times."""
    from deepspeed_tpu_torch.ops.kernels.lora_matmul import segment_tokens
    S = a.shape[0]
    order, dst, _, Mp = segment_tokens(slots, S, 16)
    xp = torch.zeros((Mp, x.shape[1]), dtype=x.dtype, device=x.device)
    xp[dst.long()] = x[order.long()]
    sizes = torch.bincount(slots.long(), minlength=S)
    offs = torch.cumsum((sizes + 15) // 16 * 16, 0).to(torch.int32)
    if hasattr(torch, "_grouped_mm"):
        a_col = a.transpose(-2, -1).contiguous().transpose(-2, -1)
        b_col = b.transpose(-2, -1).contiguous().transpose(-2, -1)

        def two():
            return torch._grouped_mm(torch._grouped_mm(xp, a_col, offs=offs), b_col, offs=offs)
        try:
            two()
            torch.cuda.synchronize()
        except RuntimeError as exc:  # this torch refuses the case: the per-slot sum below
            log(f"[lora-kernels] torch._grouped_mm refused the case: {str(exc)[:120]}")
        else:
            return {"library_ms": time_ms(two, flush), "library_call": "2 x torch._grouped_mm"}
    total = 0.0
    for s in range(1, S):
        xs = x[slots == s]
        if xs.shape[0]:
            total += time_ms(lambda: (xs @ a[s]) @ b[s], flush)
    return {"library_ms": total, "library_call": "sum of per-slot torch.matmul"}


def lora_kernel_cases(device, flush):
    """K6 at the Mistral-7B LoRA sites over the decode step, a prefill
    chunk, all-base and one-adapter batches, an odd T as an unaligned
    view and a rank below its bucket. → rows."""
    from deepspeed_tpu_torch.ops.kernels.flash_attention import row_scaled_err
    from deepspeed_tpu_torch.ops.kernels.lora_matmul import (lora_delta, lora_delta_ref,
                                                             lora_layout)
    cases = [(f"{kind}_{site}_r{r}", T, K, N, r, kind, 0, None)
             for site, (K, N) in LORA_SHAPES.items() for r in (8, 16)
             for kind, T in (("rr", 16), ("chunk", 512))]
    K, N = LORA_SHAPES["q_proj"]
    cases += [("base_q_proj_r8", 16, K, N, 8, "base", 0, None),
              ("one_q_proj_r8", 16, K, N, 8, "one", 0, None),
              ("odd37_q_proj_r8", 37, K, N, 8, "rr", 1, None),     # x 2 bytes off alignment
              ("rank5_q_proj_r8", 16, K, N, 8, "rr", 0, 5)]
    rows = []
    for i, (name, T, K, N, r, kind, offset, true_rank) in enumerate(cases):
        slots = lora_slots(kind, T)
        x, y, a, b, sc, s = lora_inputs(200 + i, T, K, N, r, slots, device, offset, true_rank)
        lay = lora_layout(s, a.shape[0])
        got = lora_delta(x, torch.zeros_like(y), a, b, sc, lay)
        fused = lora_delta(x, y.clone(), a, b, sc, lay)
        want = lora_delta_ref(x, s, a, b, sc)
        torch.cuda.synchronize()
        if not torch.isfinite(got.float()).all():
            raise AssertionError(f"lora case {name}: non-finite kernel output")
        base, row = s == 0, {"case": name, "T": T, "K": K, "N": N, "rank_bucket": r,
                             "true_rank": true_rank or r, "slots": kind}
        if not torch.equal(fused[base], y[base]) or got[base].any():  # (d)
            raise AssertionError(f"lora case {name}: base rows are not the base projection")
        if not torch.equal(fused, (y.float() + got.float()).to(y.dtype)):
            raise AssertionError(f"lora case {name}: the fused add is not round(y + delta)")
        if kind != "base":
            err = row_scaled_err(got[~base], want[~base].float())             # (a)
            zeroed = got.clone()
            zeroed[s == int(s[0])] = 0
            zerr = row_scaled_err(zeroed[~base], want[~base].float())         # (b)
            if err > LORA_TOL or zerr <= LORA_TOL:
                raise AssertionError(f"lora case {name}: row_scaled_err {err} (limit "
                                     f"{LORA_TOL}), zeroed slot {zerr} (must exceed it)")
            picks = [0, T // 3, T // 2 + 1, T - 1]                             # (c)
            for t in picks:
                solo = lora_delta(x[t:t + 1], torch.zeros_like(y[t:t + 1]), a, b, sc,
                                  lora_layout(s[t:t + 1], a.shape[0]))
                if not torch.equal(solo[0], got[t]):
                    raise AssertionError(f"lora case {name}: row {t} alone differs from the "
                                         f"mixed launch")
            row.update(max_abs_err=max_abs(got, want), row_err=err, zeroed_slot_row_err=zerr,
                       solo_rows_bitwise=len(picks))
        else:
            row.update(max_abs_err=max_abs(got, want))
        touched = len(set(slots.tolist()) - {0})
        b_ms, b_by, nbytes, flops = lora_bound(int((~base).sum()), K, N, r, touched)
        yt = y.clone()
        if kind == "base":  # every tile exits at once: the wrapper's host time per call
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                lora_delta(x, yt, a, b, sc, lay)
            row["host_us_per_call"] = (time.perf_counter() - t0) / 200 * 1e6
            torch.cuda.synchronize()
        row.update(ms=time_ms(lambda: lora_delta(x, yt, a, b, sc, lay), flush),
                   plain_ms=time_ms(lambda: y + lora_delta_ref(x, s, a, b, sc), flush),
                   layout_ms=time_ms(lambda: lora_layout(s, a.shape[0]), flush),
                   bound_ms=b_ms, bound_by=b_by, bytes=nbytes, flops=flops,
                   **lora_library(x, s, a, b, flush))
        log(f"[lora-kernels] {json.dumps(row)}")
        rows.append(row)
        del x, y, a, b, sc, s, got, fused, want, yt
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------- phases 14, 15
def lora_engine(cfg, device, budget, max_seqs, max_ctx, params=None, prefetch=False):
    """A ragged engine with LoRA on (hot set 8, rank bucket 8) and the
    LoRA lane's 8 adapters registered (rank 8, alpha 16, N(0, 0.02²) from
    a seeded numpy generator). → (engine, layers of adapter 1..8)."""
    from deepspeed_tpu_torch.inference.v2 import (DSStateManagerConfig, InferenceEngineV2,
                                                  LoRAServingConfig, RaggedInferenceEngineConfig)
    ecfg = RaggedInferenceEngineConfig(
        kv_block_size=BS,
        lora=LoRAServingConfig(enabled=True, hot_set=LORA_N_ADAPTERS, max_rank=LORA_RANK,
                               prefetch=prefetch),
        state_manager=DSStateManagerConfig(max_ragged_batch_size=budget,
                                           max_ragged_sequence_count=max_seqs,
                                           max_tracked_sequences=max_seqs,
                                           max_context=max_ctx))
    engine = InferenceEngineV2(cfg, ecfg, params=params, device=device,
                               generator=torch.Generator(device=device).manual_seed(0))
    for aid in range(1, LORA_N_ADAPTERS + 1):
        engine.register_adapter(aid, lora_adapter(engine.lora_store, aid, LORA_RANK),
                                alpha=LORA_ALPHA)
    return engine


def lora_adapter(store, seed, r):
    rs = np.random.RandomState(seed)
    return {site: (rs.randn(store.num_layers, din, r).astype(np.float32) * LORA_INIT,
                   rs.randn(store.num_layers, r, dout).astype(np.float32) * LORA_INIT)
            for site, (din, dout) in store.dims.items()}


@contextlib.contextmanager
def plain_lora():
    """Pin the runner's LoRA delta to its plain version."""
    from deepspeed_tpu_torch.inference.v2 import model_runner as mr
    from deepspeed_tpu_torch.ops.kernels.lora_matmul import lora_delta_ref
    saved = mr.lora_delta
    mr.lora_delta = lambda x, y, a, b, sc, lay: y.add_(lora_delta_ref(x, lay.slots, a, b, sc))
    try:
        yield
    finally:
        mr.lora_delta = saved


def lora_parity_phase(device):
    from deepspeed_tpu_torch.models import init_params, llama_config
    from deepspeed_tpu_torch.ops.kernels.lora_matmul import lora_delta
    cfg = llama_config("mistral-7b", num_hidden_layers=2)
    L = cfg.num_hidden_layers
    params = init_params(cfg, device, torch.bfloat16,
                         torch.Generator(device=device).manual_seed(1))
    rng = np.random.RandomState(7)
    toks = [rng.randint(0, cfg.vocab_size, n).astype(np.int32) for n in (100, 37, 64, 50, 9)]
    logits = {}
    for run in ("kernel", "plain", "base"):
        engine = lora_engine(cfg, device, 255, 7, 256, params=params)
        if run != "base":
            for uid in range(4):
                engine.bind_adapter(uid, 1 + 2 * uid)  # adapters 1, 3, 5, 7
        lora_delta.launches = 0
        with plain_lora() if run == "plain" else contextlib.nullcontext():
            first = engine.put([0, 1, 2], toks[:3])
            mixed = engine.put([0, 1, 3, 2], [[11], [12], toks[3], toks[4]])
        torch.cuda.synchronize()
        want = 0 if run == "plain" else 2 * 4 * L
        if lora_delta.launches != want:
            raise AssertionError(f"lora parity {run}: {lora_delta.launches} launches, want {want}")
        logits[run] = (first, mixed)
        engine.destroy()
    errs = [float(np.abs(a - b).max()) for a, b in zip(logits["kernel"], logits["plain"])]
    moved = [float(np.abs(a - b).max()) for a, b in zip(logits["base"], logits["plain"])]
    scale = max(float(np.abs(b).max()) for b in logits["plain"])
    ulp = 2.0 ** (math.floor(math.log2(scale)) - 7)
    result = {"kernel_vs_plain_ulps": max(errs) / ulp, "base_vs_adapters_ulps": min(moved) / ulp,
              "tol_ulps": LORA_PATH_TOL_ULPS, "logit_scale": scale, "launches_per_forward": 4 * L}
    log(f"[lora-parity] 2-layer mistral-7b width, 8 adapters: {json.dumps(result)}")
    if max(errs) > LORA_PATH_TOL_ULPS * ulp:
        raise AssertionError(f"lora parity: logits differ by {max(errs) / ulp} ulps")
    if min(moved) <= 10 * LORA_PATH_TOL_ULPS * ulp:
        raise AssertionError(f"lora parity is vacuous: the adapters move the logits by only "
                             f"{min(moved) / ulp} ulps")
    del params
    torch.cuda.empty_cache()
    return result


def lora_run(engine, prompts, adapters, uids):
    """One scheduler run of ``prompts`` with ``adapters[i]`` (None = base)
    under uids from ``uids`` → (streams by request index, seconds, forwards)."""
    from deepspeed_tpu_torch.inference.v2 import DynamicSplitFuseScheduler
    sched = DynamicSplitFuseScheduler(engine, token_budget=BUDGET, max_burst=BURST)
    mine = []
    for p, aid in zip(prompts, adapters):
        mine.append(next(uids))
        sched.add_request(mine[-1], p, max_new_tokens=NEW, adapter_id=aid)
    f0 = engine.forward_steps
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = sched.run_to_completion()
    torch.cuda.synchronize()
    return [list(out[u]) for u in mine], time.perf_counter() - t0, engine.forward_steps - f0


def lora_serving_phase(device):
    from deepspeed_tpu_torch.inference.v2 import (DSStateManagerConfig, InferenceEngineV2,
                                                  RaggedInferenceEngineConfig)
    from deepspeed_tpu_torch.models import llama_config
    from deepspeed_tpu_torch.ops.kernels.lora_matmul import lora_delta
    cfg = llama_config("mistral-7b")
    L, V = cfg.num_hidden_layers, cfg.vocab_size
    t0 = time.perf_counter()
    engine = lora_engine(cfg, device, BUDGET, N_REQ, PROMPT + NEW, prefetch=True)
    store = engine.lora_store
    torch.cuda.synchronize()
    log(f"[lora-serving] mistral-7b + {LORA_N_ADAPTERS} adapters (rank {LORA_RANK}, alpha "
        f"{LORA_ALPHA}): built in {time.perf_counter() - t0:.2f} s, hot slabs "
        f"{sum(t.nbytes for d in store.slabs()[:2] for t in d.values()) / 1e6:.1f} MB")
    rs = np.random.RandomState(0)
    prompts = [rs.randint(3, V, size=PROMPT).astype(np.int32) for _ in range(N_REQ)]
    uids = iter(range(1_000_000))
    free0 = engine.free_blocks
    lora_run(engine, [prompts[0][:PROMPT // 2], prompts[1]], [1, 2], uids)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    # the same weights with LoRA off (slice 1's path), in turn with the LoRA
    # runs, for the cost of turning LoRA on; the host-bound forward varies
    # from run to run, so every run goes LORA_ROUNDS times and medians count
    off = InferenceEngineV2(cfg, RaggedInferenceEngineConfig(
        kv_block_size=BS, state_manager=DSStateManagerConfig(
            max_ragged_batch_size=BUDGET, max_ragged_sequence_count=N_REQ,
            max_tracked_sequences=N_REQ, max_context=PROMPT + NEW)),
        params=engine.params, device=device)
    lora_run(off, [prompts[0][:PROMPT // 2], prompts[1]], [None, None], uids)  # warm-up
    mix = [1 + i % LORA_N_ADAPTERS for i in range(N_REQ)]
    order = (("lora_off", [None] * N_REQ), ("base_only", [None] * N_REQ),
             ("single", [1] * N_REQ), ("mixed", mix))
    samples, streams = {name: [] for name, _ in order}, {}
    for rnd in range(LORA_ROUNDS):
        for name, adapters in order:
            eng = off if name == "lora_off" else engine
            syncs0, toks0 = eng.host_syncs, eng.tokens_emitted
            hits0, misses0 = store.hot_hits, store.hot_misses
            lora_delta.launches = 0
            got, dt, fwd = lora_run(eng, prompts, adapters, uids)
            launches = lora_delta.launches
            if launches != (0 if eng is off else 4 * L * fwd) or fwd == 0:
                raise AssertionError(f"lora serving {name}: {launches} K6 launches over {fwd} "
                                     f"forwards, want {0 if eng is off else 4 * L} per forward")
            for i, t in enumerate(got):
                if len(t) != NEW or not all(0 <= v < V for v in t):
                    raise AssertionError(f"lora serving {name}: request {i}: {len(t)} tokens")
            if streams.setdefault(name, got) != got:
                raise AssertionError(f"lora serving {name}: round {rnd} changed the streams")
            binds = store.hot_hits - hits0 + store.hot_misses - misses0
            samples[name].append({
                "time_s": dt, "forward_steps": fwd, "ms_per_forward": dt * 1e3 / fwd,
                "gen_tokens_per_sec": N_REQ * NEW / dt,
                "syncs_per_token": (eng.host_syncs - syncs0) / max(eng.tokens_emitted - toks0, 1),
                "k6_launches": launches,
                "hot_hit_rate": (store.hot_hits - hits0) / binds if binds else None})
            log(f"[lora-serving] round {rnd} {name}: {json.dumps(samples[name][-1])}")
    if streams["base_only"] != streams["lora_off"]:
        raise AssertionError("lora serving: with every request on the base, LoRA on must give "
                             "the LoRA-off streams bit for bit")
    if streams["single"] == streams["base_only"]:
        raise AssertionError("lora serving: adapter 1 left every stream as the base model's")
    off.destroy()
    runs = {}
    for name, rows in samples.items():
        tps = sorted(r["gen_tokens_per_sec"] for r in rows)
        runs[name] = {"gen_tokens_per_sec_median": float(np.median(tps)),
                      "gen_tokens_per_sec_min": tps[0], "gen_tokens_per_sec_max": tps[-1],
                      "ms_per_forward_median": float(np.median([r["ms_per_forward"]
                                                                for r in rows])),
                      "forward_steps": rows[0]["forward_steps"],
                      "syncs_per_token": rows[0]["syncs_per_token"],
                      "k6_launches": rows[0]["k6_launches"],
                      "hot_hit_rate_first_round": rows[0]["hot_hit_rate"]}

    # isolation at fixed shapes: requests 3.. on other adapters, one on the base
    rot = mix[:3] + [1 + (a % LORA_N_ADAPTERS) for a in mix[3:-1]] + [None]
    rerun, _, _ = lora_run(engine, prompts, rot, uids)
    for i in range(3):
        if rerun[i] != streams["mixed"][i]:
            raise AssertionError(f"lora isolation: request {i} (adapter {mix[i]}) changed "
                                 f"when its batchmates' adapters changed")
    solo = [lora_run(engine, [prompts[i]], [mix[i]], uids)[0][0] == streams["mixed"][i]
            for i in range(3)]
    log(f"[lora-serving] isolation: 3 of 3 streams bit-identical at fixed shapes; solo runs "
        f"(smaller buckets, a reading only) identical: {solo}")

    # slot moves: adapter 9 evicts the least recently used adapter X, then X
    # comes back and evicts the next one, so it lands in another slot
    engine.register_adapter(9, lora_adapter(store, 9, LORA_RANK), alpha=LORA_ALPHA)
    probe = next(uids)
    slot_of = dict(store._hot)  # adapter -> slot, read only
    store.bind(probe, 9)
    store.release(probe)
    x_id = (set(slot_of) - set(store.hot_set())).pop()
    slot_x, slot_new = slot_of[x_id], engine.bind_adapter(probe, x_id)
    store.release(probe)
    if slot_new == slot_x:
        raise AssertionError(f"lora slot move: adapter {x_id} came back in slot {slot_x}")
    moved, _, _ = lora_run(engine, prompts, mix, uids)
    idx = [i for i, a in enumerate(mix) if a == x_id]
    if any(moved[i] != streams["mixed"][i] for i in idx):
        raise AssertionError(f"lora slot move: adapter {x_id}'s streams changed with its slot")

    # staged promotion: a 10th adapter of rank 5 (padded to 8), prefetched, then bound
    layers = lora_adapter(store, 10, 5)
    engine.register_adapter(10, layers, alpha=LORA_ALPHA)
    staged0, hits0 = store.stats()["prefetched"], store.stats()["stage_hits"]
    engine.prefetch_adapter(10)
    t_wait = time.perf_counter()
    while store.stats()["prefetched"] == staged0:
        if time.perf_counter() - t_wait > 30:
            raise AssertionError("lora staged promotion: the prefetch worker staged nothing")
        time.sleep(0.01)
    slot = engine.bind_adapter(probe, 10)
    if store.stats()["stage_hits"] != hits0 + 1:
        raise AssertionError("lora staged promotion: the bind did not use the staged copy")
    a_slabs, b_slabs, scales = store.slabs()
    for site, (la, lb) in layers.items():
        want_a = torch.from_numpy(np.pad(la, ((0, 0), (0, 0), (0, LORA_RANK - 5)))).to(
            torch.bfloat16).to(device)
        want_b = torch.from_numpy(np.pad(lb, ((0, 0), (0, LORA_RANK - 5), (0, 0)))).to(
            torch.bfloat16).to(device)
        if not (torch.equal(a_slabs[site][:, slot], want_a) and
                torch.equal(b_slabs[site][:, slot], want_b)):
            raise AssertionError(f"lora staged promotion: slot {slot} {site} rows differ from "
                                 f"the padded payload")
    if float(scales[slot]) != float(np.float32(LORA_ALPHA / 5)):
        raise AssertionError(f"lora staged promotion: scale {float(scales[slot])}")
    store.release(probe)
    if engine.free_blocks != free0:
        raise AssertionError(f"lora serving: free blocks {engine.free_blocks} != {free0}")

    stats = store.stats()
    result = {"requests": N_REQ, "prompt_len": PROMPT, "new_tokens": NEW, "adapters":
              LORA_N_ADAPTERS, "rank": LORA_RANK, "alpha": LORA_ALPHA, "runs": runs,
              "multi_vs_single": runs["mixed"]["gen_tokens_per_sec_median"] /
              runs["single"]["gen_tokens_per_sec_median"],
              "lora_overhead_vs_base": runs["base_only"]["gen_tokens_per_sec_median"] /
              runs["mixed"]["gen_tokens_per_sec_median"] - 1,
              "lora_on_vs_off": runs["lora_off"]["gen_tokens_per_sec_median"] /
              runs["mixed"]["gen_tokens_per_sec_median"] - 1,
              "promotions": stats["promotions"], "evictions": stats["evictions"],
              "stage_hits": stats["stage_hits"], "solo_identical": solo,
              "slot_move": {"adapter": x_id, "from": slot_x, "to": slot_new},
              "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(f"[lora-serving] {json.dumps(result)}")
    result["profile"] = profile_steps(engine, adapters=mix)
    burst = result["profile"]["decode_burst"]
    k6_ms = burst["by_category_ms"].get("lora_delta (K6)", 0.0)
    result["decode_burst"] = {"k6_device_ms": k6_ms,
                              "k6_share_of_device": (k6_ms / burst["device_ms"]
                                                     if burst["device_ms"] else None),
                              "kernels_per_forward": burst["kernels_launched"] / burst["forwards"],
                              "busy_share": burst["device_busy_share"]}
    log(f"[lora-serving] decode burst: {json.dumps(result['decode_burst'])}")
    engine.destroy()
    del engine
    torch.cuda.empty_cache()
    return result, samples["mixed"][0]["k6_launches"]


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on a GPU", file=sys.stderr)
        return 2
    from deepspeed_tpu_torch.device import gpu_report
    from deepspeed_tpu_torch.ops.kernels import build

    device = torch.device("cuda", 0)
    card = gpu_report()
    log(f"[device] {card}")
    log(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}, {torch.cuda.device_count()} device(s)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(build.SOURCES)) as pool:  # one nvcc per source, together
        built = list(pool.map(build.build, build.SOURCES))
    log(f"[build] all sources in {time.perf_counter() - t0:.2f} s")
    for src, (path, report, seconds) in zip(build.SOURCES, built):
        log(f"[build] {src} -> {path.name} in {seconds:.2f} s"
            + ("" if report is not None else " (reused)"))
        for line in (report or "").splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                log(f"[build] {src}: {line.strip()[:160]}")

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    cases = kernel_phase(device, flush)
    train_cases = train_kernel_phase(device, flush)
    del flush
    torch.cuda.empty_cache()
    parity_phase(device)
    serving, launches = serving_phase(device)
    train_parity_phase(device)
    training, train_launches = training_phase(device)

    # quantized and MoE serving; every earlier engine and training state is gone
    torch.cuda.empty_cache()
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    qmm_cases = quant_matmul_cases(device, flush)
    grouped = grouped_cases(device, flush)
    del flush
    torch.cuda.empty_cache()
    moe_parity_phase(device)
    _, int8_launches = moe_serving_phase(device, "int8", 32)
    _, bf16_launches = moe_serving_phase(device, "none", MOE_BF16_LAYERS)

    # multi-tenant LoRA serving of Mistral-7B
    torch.cuda.empty_cache()
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    lora_cases = lora_kernel_cases(device, flush)
    del flush
    torch.cuda.empty_cache()
    lora_parity_phase(device)
    _, lora_launches = lora_serving_phase(device)

    main_case = next(c for c in cases if c["case"] == "serving_decode")
    kernels = [{"name": "paged_decode_attention", "route": "cuda",
                "source": "deepspeed_tpu_torch/csrc/paged_attention.cu",
                "replaces": "deepspeed_tpu/ops/pallas/paged_attention.py:70",
                "launches": launches,
                "max_abs_err": max(c["max_abs_err"] for c in cases),
                "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
                "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
                "library_ms": main_case["library_ms"],
                "shape": "serving decode step: T=16, H=32, Hkv=8, Dh=128, bs=32, ctx 160",
                "cases": cases}]
    train_kernels = {
        "flash_fwd": ("flash_attention.cu", "flash_attention.py:46",
                      f"training path: B={TB}, S={TS}, H=16, Dh=128, causal, bf16"),
        "flash_bwd_dkv": ("flash_attention.cu", "flash_attention.py:96",
                          f"training path: B={TB}, S={TS}, H=16, Dh=128, causal, bf16"),
        "flash_bwd_dq": ("flash_attention.cu", "flash_attention.py:141",
                         f"training path: B={TB}, S={TS}, H=16, Dh=128, causal, bf16"),
        "rms_norm_fwd": ("fused_norms.cu", "fused_norms.py:19",
                         f"training path: [{TB * TS}, 2048] bf16, bf16 scale"),
    }
    for name, (src, replaces, shape) in train_kernels.items():
        rows = train_cases[name]
        main_row = next(r for r in rows if r["case"] == "path")
        kernels.append({"name": name, "route": "cuda",
                        "source": f"deepspeed_tpu_torch/csrc/{src}",
                        "replaces": f"deepspeed_tpu/ops/pallas/{replaces}",
                        "launches": train_launches[name],
                        "max_abs_err": max(r["max_abs_err"] for r in rows),
                        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
                        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
                        "library_ms": main_row["library_ms"], "shape": shape, "cases": rows})
    slice3 = {  # name: (source, TPU kernel, cases, main case, launches, shape)
        "quant_matmul": ("fused_quant_matmul.cu", "fused_quant_matmul.py:90", qmm_cases,
                         "int8_M8_{}x{}".format(*ATTN_SHAPES[0]), int8_launches["quant_matmul"],
                         "serving decode step: M=8 x [4096, 4096] int8, group 512 (q, o)"),
        "gmm": ("grouped_matmul.cu", "grouped_matmul.py:40", grouped["gmm"], "bf16_w1_decode",
                bf16_launches["gmm"],
                "decode: 16 rows (8 tokens, top-2) over [8, 4096, 14336] bf16 experts"),
        "gmm_quant": ("grouped_matmul.cu", "grouped_matmul.py:200", grouped["gmm_quant"],
                      "int8_w1_decode", int8_launches["gmm_quant"],
                      "decode: 16 rows (8 tokens, top-2) over [8, 4096, 14336] int8 experts"),
    }
    for name, (src, replaces, rows, main_name, n, shape) in slice3.items():
        main_row = next(r for r in rows if r["case"] == main_name)
        kernels.append({"name": name, "route": "cuda",
                        "source": f"deepspeed_tpu_torch/csrc/{src}",
                        "replaces": f"deepspeed_tpu/ops/pallas/{replaces}",
                        "launches": n, "max_abs_err": max(r["max_abs_err"] for r in rows),
                        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
                        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
                        "library_ms": main_row["library_ms"], "shape": shape, "cases": rows})
    main_row = next(r for r in lora_cases if r["case"] == "rr_q_proj_r8")
    kernels.append({"name": "lora_delta", "route": "cuda",
                    "source": "deepspeed_tpu_torch/csrc/lora_matmul.cu",
                    "replaces": "deepspeed_tpu/ops/pallas/lora_matmul.py:45",
                    "launches": lora_launches,
                    "max_abs_err": max(r["max_abs_err"] for r in lora_cases),
                    "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
                    "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
                    "library_ms": main_row["library_ms"],
                    "shape": "serving decode step: T=16 (8 adapters x 2 tokens), q_proj "
                             "[4096, 4096], rank 8, 9 slots, bf16", "cases": lora_cases})
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
