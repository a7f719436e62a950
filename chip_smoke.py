#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Runs from the root of a checkout and needs one CUDA device; without one
it exits non-zero and prints no result. Imports nothing of JAX. Phases,
each of which fails the run if it fails:

1. device  — prints the card (``nvidia-smi`` name and power limit), torch
   and CUDA versions;
2. build   — builds every CUDA kernel of the port from ``csrc/`` (one
   ``nvcc`` per source) and prints what ptxas reports, then reads K1's
   designs from the library's SASS (``cuobjdump``): the forward, dK/dV
   and dQ kernels must all issue wgmma (HGMMA);
3. kernels — calls K3's wrapper at Mistral-7B attention shapes (H=32,
   Hkv=8, Dh=128, block 32, bf16): the serving run's decode and prefill
   steps, a decode batch over contexts 1..4096, a 512-token prefill chunk
   over 16 sequences, edge rows (position 0, block boundaries, past the
   table, pad rows), and beyond the serving path block size 16, one and
   eight query heads a KV head, head dim 64, chunks that start mid-block,
   contexts across the tiled design's chunk cut at 512, an odd T with the
   positions 8 bytes off 16, pad rows after a prefill. Each call takes the
   design ``paged_design`` names (the tiled design at every case; counted
   on it) and is run again on the first (token) design: both are held
   against the plain PyTorch version in fp32 on the same bf16 inputs
   (max-abs 2e-2: the kernels' bf16 output rounding), the tiled design
   also within ROW_TOL units of ``row_scaled_err`` with one (token, KV
   head)'s rows zeroed rejected, and a second run must give the same
   bits. Both designs are timed in the same call with CUDA events, L2
   flushed before every launch, beside the plain version, one PyTorch
   library call (SDPA over the gathered dense KV, gather excluded) and the
   bound (bytes over 3.35 TB/s or flops over 989 TFLOP/s);
4. parity  — a 2-layer Mistral-7B-width engine through the kernel and one
   pinned to the plain ``torch_gather`` attention, same weights, odd
   token buckets (255 and 7, so the packed vector's views sit off 16-byte
   boundaries): a prefill put and a mixed prefill+decode put must give
   last-token logits within 2 bf16 ulps (at the largest logit's
   magnitude) of each other. Both attentions compute in fp32 and round
   only their output, so they differ by summation order, and the logits
   come out of a bf16 matmul;
4b. batch invariance — (a) ``dense_matmul`` (K4 over a bf16 weight, the
   serving path's dense projections, K cut into chunks chosen by (N, K)
   alone) at Mistral-7B's projections, 16 rows (the decode design) and 512
   (the prefill design), each row naming the design ``k4_design`` gives it
   (counted on it) and the kernels one call launches: within QUANT_TOL
   units of ``row_scaled_err`` of cuBLAS on the same inputs, a zeroed
   column tile rejected, the first design (``design="general"``) held to
   the same check, timed beside cuBLAS (the plain version and the library
   call), the first design and the bound,
   with each one's host µs to enqueue a call; (b) the row counts (1 to
   512, 40 a verify's) at which any row's bits differ from the same row
   alone, of cuBLAS's product (also with reduced-precision reductions
   off), of ``dense_matmul``, of the eager RMS norm (the serving path's
   former norm, a reading) and of the serving path's RMS norm (K2's RMS
   forward): gated none for ``dense_matmul`` and the serving RMS;
   (c) a 2-layer Mistral-7B-width engine: one request's decode token alone
   (the 16-token bucket) and beside another prompt (the 512-token bucket),
   each serving op's input and output recorded for its row. Gate: equal
   logits bits and no op whose output moves on equal input; with the
   projections pinned to cuBLAS (the path before the repair) the first op
   that moves is printed; (d) K3: every row of a sequence's chunk of 1, 7,
   16, 64 and 128 tokens (the last at position 530, past the chunk cut)
   beside three decoding sequences and pad rows, its chunk alone, the batch
   with it last, and each token alone. Gate: no row's bits move;
5. serving — the full 32-layer Mistral-7B-width engine (random weights
   from a seeded generator) under ``DynamicSplitFuseScheduler``: 16
   requests x 128-token random prompts x 64 new tokens, block 32, budget
   512, bursts of 16. Every request must get 64 in-vocab tokens, the
   kernel's launch count must grow by layers x forward steps, and the
   pool must be empty again at the end, and ``dense_matmul`` must launch
   7 x layers + 1 per forward, none on the first design: a decode burst's
   all on the decode design, a prefill or mixed forward's projections on
   the prefill design (its head, at the 16 sequences' last tokens, on the
   decode design). Prints tokens/s, steps, host syncs per token, peak
   memory and the forwards split by K4 design, then profiles one prefill
   step and one decode burst of the same traffic (device time by kernel,
   K4's among it, device busy share), then runs the traffic with the projections through
   ``dense_matmul`` and pinned to cuBLAS in turn, three times each
   (generated tokens/s and ms per forward of each: the repair's cost).
   K3's launches by design (all on the tiled design) and K3's device ms in
   each profiled step are printed; phases 11, 14, 15 and 18 print and gate
   the same (K6 on its mma design where LoRA is on);
6. train kernels — flash attention forward, dK/dV and dQ, and the RMS-norm
   forward at the training path's shapes (B=4, S=2048, H=16, Dh=128,
   causal; RMS on [8192, 2048]) and beside them S=1000 and S=2049 (not
   multiples of the 128-row tiles), 4 packed segments, non-causal, H=32,
   Dh=64, and the dense BERT comparison's shape (B=4, S=4096, H=16, Dh=64,
   non-causal), all bf16 (RMS also at Mixtral's width, [4096, 4096], and
   in fp32, and at an odd shape); it prints the launches by design, and
   for each case dQ's time beside SDPA's whole backward and dQ's bound.
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
   version, one library call (SDPA forward and SDPA's backward through
   autograd, each under every backend the installed PyTorch offers:
   flash, cuDNN, memory-efficient; the fastest is ``library_ms``, named
   in ``library_call``; ``F.rms_norm``) and the bound (max of flops over
   989 TFLOP/s and bytes over 3.35 TB/s, flops counted over the valid
   (q, k) pairs of the case);
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
   the remat recompute, dK/dV and dQ L·gas each, RMS (4·L + 1)·gas), and
   every forward, dK/dV and dQ launch must take the wgmma design; no
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
   then the bf16 grouped kernel; for K4 the plain version is that path).
   Each ``quant_matmul`` case names the design ``k4_design`` gives it (the
   decode design at 8 rows, the prefill design at 37 and 264), is counted
   on it, gives the same bits on a second run, and the first design on
   the same inputs is held to the same check and timed beside it; one
   case a scheme takes the first
   design by itself (x at an unaligned base).
   Each ``gmm_quant`` case names the design ``quant_design`` gives it and
   must be counted on it (the decode design at 16-row tiles, the forward
   ring at 64, the one-hot check at both), give the same bits on a second
   run and zeros past the used tiles; at the decode and prefill routings
   the first design (x at an unaligned base, the same values) is held to
   QUANT_TOL and timed beside it. A reading, not a gate: whether a decode
   row's bits match between the decode design and the forward ring;
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
11. quantized MoE serving — the ``mixtral-8x7b`` preset at its widths and
   MOE_INT8_LAYERS of its 32 layers (for the run's time limit; the full
   depth, 46.7 B params, fits the card) in int8, weights drawn into carriers by
   ``init_quantized_params`` from a seeded generator, under ``bench.py``'s
   ``bench_serving_2b_moe`` traffic: 8 requests x 256-token prompts x 64
   new tokens, block 32, token budget 264, bursts of 16. Every request must
   get 64 in-vocab tokens, the pool must be empty at the end, ``quant_matmul``
   must launch (4 per layer + 1 for the head) per forward and ``gmm_quant``
   3 per layer per forward (so every MoE FFN went through the kernels), each
   forward's all on one Hopper design (a decode burst's on the decode
   design, none on the first), ``quant_matmul``'s likewise (a prefill
   forward's projections on the prefill design, the head at the 8
   sequences' last tokens on the decode design), and peak memory
   must stay under the card's. Prints tokens/s, ms per forward, host syncs
   per token, resident bytes, peak memory, the forwards split by design
   with their ms each (CUDA events around every forward) and a profile of
   one prefill step and one decode burst, with K4's share of each;
12. bf16 MoE serving — the same preset and traffic in bf16 at 8 of 32
   layers (the bf16 model does not fit one card at full depth); ``gmm``
   must launch 3 per layer per forward. Same prints, and how many ``gmm``
   launches took each design (prefill's 64-row tiles the wgmma design,
   decode's 16-row tiles the first).
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
   delta). Each case takes the design ``lora_design`` names (counted on
   it; the mma design wherever x is aligned) and runs again on the first
   (``design="general"``), held to the same check (a). Timed beside the
   first design, the plain version, the layout (once per forward),
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
15. LoRA serving — ``mistral-7b`` at its widths and LORA_SERVING_LAYERS of
   its 32 layers (the run's time limit) with LoRA on under
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
   one ``stage_hit``, its slab rows bitwise the padded bf16 payload); and
   requests 0-2 each run alone (at other token buckets) must reproduce
   their mixed-trace streams bit for bit. The engine is built with prefetch on
   for that check; the scheduler never kicks a prefetch, so the runs are
   the lane's (prefetch off). Prints tokens/s of each run,
   ``multi_vs_single``, the LoRA overhead against base-only and against
   LoRA off, ms per
   forward, host syncs per token, hot hit rate, promotions, peak memory,
   and a profile of one prefill step and one decode burst (K6's device ms
   and share, kernels per forward, busy share).

16. K7 kernels — ``quantize_int8`` and ``dequantize_int8`` (``csrc/
   quantization.cu``) at the KV tier's shapes: one of k or v of n = 1, 2,
   12 and 16 Mistral-7B blocks ([32, n, 32, 8, 128]; the tier lane demotes
   2 blocks a time and promotes 12 at once), groups of one (layer, block)
   slab (32768 values) and of 2048, bf16 and fp32 input, and stochastic
   rounding. Values, scales and the dequantized bf16 output must equal the
   plain versions bit for bit (the contract: true divisions, rounding half
   to even, the stochastic hash computed alike), and the comparison must
   catch one flipped code; stochastic codes must each be the floor or the
   ceiling of x / scale. The quantize takes the design ``k7_design``
   names (counted on it: the cluster design at a demotion's slabs, n = 1
   and 2; the two-pass design at 12 and 16 blocks' slabs and at groups of
   2048), and the two-pass design (the first) runs on the same inputs,
   held bitwise too. Timed beside the plain versions and the bound (each value read
   and written once plus 4 bytes a group, over 3.35 TB/s), the quantize
   by CUDA events and by the profiler's kernel span (``profiled_us``), on
   both designs; no single PyTorch call computes grouped absmax-scaled
   int8 (library null). Then the device→host copy of a demoted handle's k into pageable,
   freshly pinned and cached pinned memory (the tier's records are pinned),
   as a reading;
17. tier parity — a 2-layer Mistral-7B-width engine with an int8 KV tier
   under the tier lane's trace (below), through K7 and with K7 pinned to its
   plain versions: streams, prefix hits, a probe request's logits and the
   measured quantization error bitwise; each demotion launches 2 quantize
   and 2 dequantize kernels (k and v, and their measured error), each
   quantized restore 2 dequantize kernels;
18. KV tier serving — ``mistral-7b`` at its widths and TIER_LAYERS of its
   32 layers (cut for the run's time), bf16, weights
   built once from a seeded generator for every engine of the phase:
   (a) ``bench.py``'s ``bench_serving_2b_prefix`` traffic (8 requests x (512
   shared + 32) prompt x 64 new, block 32, budget 552, bursts of 16), a cold
   and a warm fleet on one engine with the prefix cache: cold vs warm
   tokens/s and ``warm_prefill_frac``; (b) ``bench_serving_2b_kv_tier``'s
   three phases (4 requests each; A shares a 512-token system prompt, B is
   disjoint and overflows the 81-block pool, A' returns; 544 + 64 tokens,
   budget 548, bursts of 16; host budget 4 GiB) on five engines: a control
   whose 256-block pool evicts nothing, the tier off, a bf16 tier, an int8
   tier, and a bf16 tier with its prefetch worker off. Gates: both bf16
   tiers' streams equal the control's bit for bit, the tier-off engine's
   (which prefills A' at other shapes) equal the control's in 12 of 12,
   and the bf16 tier's equal the tier-off engine's in 12 of 12 (bench.py
   asserts tier on = tier off); every promoted block equals its demoted
   bytes (a device copy at demotion); the tier saves at least twice the
   A'-phase prefill tokens of the tier-off run; the no-prefetch tier stages
   nothing; no block leaks; the int8 tier's quantizes run on the cluster
   design (its launches by design are printed). Readings: tokens/s per phase, demoted /
   promoted / prefetched blocks, stage hits, prefetch wait, bytes and ms
   per demotion (gather, quantize, device→host copy) and per promotion
   (host→device copies and the restore: from staged copies, and from host
   records with prefetch off), the store's peak bytes beside the pinned
   host memory the allocator holds, the probe's own host time, the int8
   tier's error and agreement with the control, host syncs per token, peak
   memory; (c) one request suspended mid-decode and resumed
   (its KV to host memory and back) must continue the uninterrupted stream
   bit for bit.

19. K5 training kernels — the forward ``gmm``, ``gmm_dw`` (dW of w1 [8,
   4096, 14336] and w2 [8, 14336, 4096]), ``gmm``'s dx reading the stack
   as stored, and ``gmm_quant_dx`` over int8, fp8 and fp6 carriers of
   each, at T·k = 8192 rows (B 2 x S 2048, top-2) routed with a skew that
   leaves expert 7 empty, 64-row tiles; every launch on the wgmma design.
   Then each first design at one case its predicate gives it: the forward
   with x at an unaligned base (a view one element in), and dW over a
   128-row routing with 16-row tiles (expert 1 empty).
   Each within QUANT_TOL units of ``row_scaled_err`` of its plain version
   (fp32 sums in another order, one bf16 rounding), the check rejecting
   one zeroed 64 x 64 tile (dW) or 64-row tile (forward, dx); the empty
   expert's dW all zeros; two runs of each equal bit for bit; rows past
   the used tiles zero; the wgmma designs' work list, built by a
   one-thread kernel, equal to its plain version at this routing and
   phase 9's, at 16- and 64-row tiles. Timed beside the plain version, the bound
   (flops over 989 TFLOP/s or bytes over 3.35 TB/s) and the library call
   (``torch._grouped_mm``: 2-D x 2-D with offsets on the contraction dim
   for dW, the bf16 or dequantized stack for dx; else per-expert
   ``torch.matmul`` times, and it says which);
20. MoE training parity — a 2-layer Mixtral-8x7B-width model (3.17 B
   params), dropless, remat ``"moe"``, one ``train_batch`` (B 1 x S 2048,
   gas 2, bf16, Adam) through the kernels and from the same weights and
   batch with attention, norms and every grouped GEMM pinned to their
   plain versions (the plain run replays the kernel run's routing). The
   loss within MOE_LOSS_TOL and the summed aux loss within MOE_AUX_TOL
   relative, every parameter's accumulated gradient within GRAD_LEAF_TOL
   in relative L2 norm; launches per layer and micro-batch: 3 ``gmm``
   forward + 3 ``gmm`` dx, 3 ``gmm_dw``, flash forward twice (the
   attention half is recomputed), no grouped GEMM re-run; every forward,
   dx and dW launch on the wgmma design. Then the
   frozen base: the dropless FFN over one Mixtral layer's int8 carriers
   from ``init_quantized_params``, gradients in x only, through the
   kernels (3 ``gmm_quant``, on the forward ring, 3 ``gmm_quant_dx``) and
   the plain versions: dx within GRAD_LEAF_TOL, no gradient for carriers or
   scales; then that forward through its w1 carriers at phase 19's 8192
   rows held as phase 19 holds its kernels (QUANT_TOL, zeroed tile, two
   runs, zeros past the used tiles) and timed beside the first design, the
   plain version, dequantize + ``torch._grouped_mm`` and
   ``torch._grouped_mm`` on the dequantized stack;
21. MoE training — Mixtral-8x7B at its widths, 2 of 32 layers, through
   ``initialize`` → ``train_batch`` (bench.py's ``_train_config``: bf16
   with the fp32 master, Adam lr 1e-4, ZeRO-3), dropless, remat ``"moe"``,
   B 2 x S 2048, gas 2, one seeded batch: 1 warm-up and 3 timed steps,
   each kernel's launches as the path implies (every forward, dx and dW
   on the wgmma design, also under remat ``"full"``), losses and aux losses
   finite, the aux loss > 0 and the loss lower after the 3 steps. Prints
   ms per step, tokens/s, active MFU (bench.py's flops over the active
   parameters: attention, norms, embedding, head, router, and k/E of the
   experts), peak memory and a profiled step; then a step each (after a
   warm-up) with remat ``"full"`` (3 more ``gmm`` launches per layer and
   micro-batch) and with capacity routing (no grouped GEMM);
22. ``bench_train_moe`` — that lane's shape (8 layers, hidden 768, I 2048,
   12 heads, 8 experts, top-2, S 1024, B 4, gas 32, remat ``"moe"``),
   dropless: tokens/s, active MFU and the step time (the capacity-routed
   repeat, within 0.4% of it in ``PERF.md``, was cut to keep the run's
   length);

23. K8 and LayerNorm kernels — ``block_sparse_fwd``, ``block_sparse_dq`` and
   ``block_sparse_dkv`` (``csrc/block_sparse_attention.cu``) at BERT-large's
   training path (B 4, S 4096, H 16, Dh 64, bf16, BigBird block 64: 1
   random, a window of 3 and 1 global block, 9.13% of the block pairs), and
   beside it block 16, per-head layouts at block 32, Dh 128 at block 128,
   and a hand-made layout with an empty row and a key block no row admits.
   Each held against its plain version with ``row_scaled_err`` (ROW_TOL, as
   K1), lse within LSE_TOL on the rows that admit something and exactly
   ``NEG_INF`` on the empty row, zeros on the empty row (o, dq) and the
   unreached key block (dk, dv), each check rejecting the output with its
   first block of rows zeroed (and o with its last 64-row tile zeroed). All
   three launch the design ``bsa_design`` names (counted on it: the wgmma
   design at blocks 64 and 128, the first at 16 and 32), the backward on
   that forward's o and lse; where that is the wgmma design, each must give
   the same bits on a second run, and the first design runs on the same
   inputs, held to the same checks (the forward's lse too) and timed
   beside it; the LayerNorm forward (``fused_norms.cu``) at
   [16384, 1024] bf16 within LN_TOL units. Timed beside the bound (bytes
   over 3.35 TB/s or the admitted pairs' flops over 989 TFLOP/s) and, at
   every case the wgmma design takes, the plain version, the library call
   (SDPA with the layout expanded to a boolean [H, S, S] mask, forward and
   backward; ``F.layer_norm``) and, as a reading, K1 non-causal at the same
   shape: the dense work the layout skips;
24. BERT parity — a 2-layer bert-large-width model at S 4096 with BigBird
   block 64 takes one ``train_batch`` (B 2, gas 2, bf16, Adam) through the
   kernels and again from the same weights with block-sparse attention and
   LayerNorm pinned to their plain versions. The two differ by where bf16
   rounds (the kernels round p and ds). Limits, a few times the readings
   in ``PERF.md``: the loss within BERT_LOSS_TOL relative, each parameter's
   accumulated gradient within GRAD_LEAF_TOL in relative L2 norm and
   BERT_GRAD_ROW_TOL units of ``row_scaled_err`` (readings up to 65: one
   element in a million off by a quarter of its row's scale), except the
   key projection's bias: its exact gradient is zero (a softmax is blind
   to q·b_k added to a whole row), so both runs hold rounding noise there,
   and each is held under GRAD_LEAF_TOL of its layer's query-bias gradient
   instead. The launches exact in the kernel run (K8's three L per
   micro-batch each, all on the wgmma design, LayerNorm 2 L + 2) and none
   in the plain run; the kernel run is profiled and
   prints K8's device ms by kernel;
25. BERT-large training — all 24 layers, the position table tiled from 512
   to 4096 by ``replace_model_self_attention_with_sparse_self_attention``,
   BigBird block 64, micro-batch 4, gas 2, S 4096, bf16 Adam, ZeRO-3, no
   attention mask: 4 ``train_batch`` steps on a fixed batch, the loss
   finite and falling, launches exact (K8's three 48 a step each, all on
   the wgmma design, LayerNorm 100). Prints step ms,
   tokens/s, MFU (``bench.py``'s formula with its dense attention term)
   beside the attention flops the layout admits, peak memory and a profiled
   step with K8's device ms by kernel (the forward's, dQ's and dK/dV's);
   then 2 steps and a profiled one with K8 pinned to its first design, for
   the step and K8's device ms beside the wgmma design's; then the same model without a sparse
   section (K1 non-causal) for its step time and peak;
26. sampled serving — ``bench_serving_2b_sampled``'s protocol (``bench.py``)
   on the Mistral-7B-width engine at SAMPLED_LAYERS of its 32 layers (cut
   for the run's time; bf16, random weights from a seeded generator): 8 requests x 256-token prompts x 64 new tokens, block
   32, budget 264, bursts of 8, each request with its own spec (the lane's
   temperature, top_k and top_p pattern, seed 1000 + i). A greedy and a
   sampled warm-up, then the greedy and the sampled run, timed. Gates: 64
   in-vocab tokens a request, K3's launches layers x forwards and
   ``dense_matmul``'s (7 x layers + 1) x forwards in the sampled run (counts
   zeroed before it), the engine's host syncs those of its puts and bursts
   (2 a put, requests + 1 a burst), the sampled trace replayed under fresh
   uids bit-identical, a ``max_burst`` 1 run equal to the ``max_burst`` 8
   run's first 16 tokens, a ``top_k: 1`` request (stepwise, beside its
   greedy twin on the same logits) equal to greedy except where the logits'
   maximum ties, where it must draw one of the tied tokens (bf16 logits tie
   at ~4% of steps; the step it parts at and the tied steps are printed),
   one device→host ``cpu()`` of a sampled burst's tokens (PyTorch's sync
   debug mode counts the burst's synchronizing calls, printed), and the
   counter PRNG's keys at every position of the run and the bits of 32 of
   them on the card bitwise equal to the port's CPU version. Prints, each
   beside the card's name and power limit: greedy and sampled generated
   tokens/s and their ratio, host syncs per token, the sampler's device
   launches and device µs per sampled forward in a burst (the position fold
   and ``sample_rows`` on [8, 32000] logits, profiled over 20 calls, and ms
   a call by CUDA events), and the tokens the card's sampler and the CPU's
   draw differently from the same captured logits and keys (8 positions of
   the 8 requests);
27. speculative decoding — ``bench_serving_2b_spec``'s protocol on the
   full 32-layer Mistral-7B engine (bf16; phases 27 and 28 share one set
   of random weights, seed 0): 8 requests x (a 256-token system prompt, a
   16-token pattern of ``RandomState(0)`` tiled, + a 64-token template, an
   8-token pattern tiled, its first token + i) x 64 new tokens, block 32,
   budget 328, draft_len 4, bursts of 16; the engine built with
   ``DS_SPEC_DECODE=0`` (off: a greedy run and a sampled one with phase
   26's specs), then without it (on). The random-weight model repeats no
   suffix n-gram of its history within 64 tokens, so on this trace the
   n-gram drafter proposes nothing (a reading); the on engine runs the
   trace with it, then with ``StreamDrafter`` (oracle drafts taken from
   the spec-off streams, a seeded quarter of the positions altered),
   greedy and sampled.
   Gates: every on run's streams equal to the off run's (greedy bit-
   identical); the drafted runs take verify steps and accept some drafts
   but not all; every verify forward launching K3 once a layer and
   ``dense_matmul`` 7 x layers + 1 times, none on K4's first design, and
   K2's RMS forward 2 x layers + 1 times; then
   one verify of the 8 requests after their prefill, with drafts taken
   from the spec-off sampled streams (rows 0-3 all correct, row 4 + j one
   altered at j), accepting 4, 4, 4, 4, 0, 1, 2, 3 and emitting the streams'
   tokens. Prints, for each on run, verify steps, the accept rate, tokens a
   verify step, generated tokens/s beside plain, ms a verify forward by
   rows and d beside a plain forward, K3's and K4's launches a verify
   forward and K4's by design, host syncs a token, the verify forwards'
   seconds beside the other forwards', and the sequences whose drafting
   the accept-rate EMA turned off;
28. constrained decoding — ``bench_serving_2b_json``'s protocol on the
   same weights: the schema ``{"ok": boolean, "mode": enum fast|safe}``
   compiled over ``byte_vocab(32000)`` with EOS 2, 8 random 64-token
   prompts x 64 new tokens, temperature 1.1, top_k 40, seeds 500 + i,
   bursts of 8, unconstrained then constrained, 3 repeats each. Gates:
   every constrained lane ends at EOS and parses to the schema's fields,
   the repeats replay bit-identically, a greedy constrained run is valid
   too, K3 and K4 launch their counts a forward in each constrained run,
   and a batch of 4 constrained and 4 unconstrained requests on an engine
   with spec decoding on never verifies while a constrained row is live.
   Prints the DFA's states, compile and bind ms, the slabs' bytes and
   plain vs constrained generated tokens/s, the overhead a reading beside
   the JAX bench's 10% bound.
29. pipelined bursts — ``bench_serving_v2_ragged``'s protocol (16 random
   128-token prompts from seed 0 x 64 new tokens, budget 512, bursts of
   16, KV block 32) on the same weights' first ASYNC_LAYERS layers (cut
   for the run's time), a synchronous and a pipelined
   (``async_burst``, depth 2) engine in the same call, over greedy,
   sampled (per-request seeds, top_k/top_p) and constrained (phase 28's
   schema) lanes. Gates: each lane's streams equal between the engines
   (constrained ones valid JSON ending at EOS), every forward's K2, K3 and
   K4 launches (none on K4's first design) and the lanes' launches equal,
   syncs per generated token dropping at least 4x, a lane whose request 0
   stops at EOS mid-pipeline leaving the free blocks of the start on both
   engines, a chained burst dispatched under
   ``set_sync_debug_mode("error")`` (no synchronizing call before its
   fence) emitting what two synchronous bursts emit, and under
   ``DS_SANITIZE=1`` a clean run equal to the plain engine's and a
   NaN-poisoned weight raising ``SanitizerNaNError``. Prints generated
   tokens/s of both engines, the device's busy share over a profiled
   window of chained bursts, host ms to dispatch a burst, and K2/K3/K4
   launches by design, beside the card.
30. gateway and weight refresh — on the same weights and phase 29's
   synchronous engine config with LoRA serving on (hot set 4, rank 8) and
   its disk tier under a temp dir: (a) ``bench_serving_v2_ragged``'s
   traffic run directly by ``DynamicSplitFuseScheduler``, then through a
   ``ServingGateway`` whose pump thread drives the engine, from 16 client
   threads each consuming its stream: nothing lost, every stream equal to
   the direct run's, K2/K3/K4 launches a forward as phase 29's (none on
   K4's first design); (b) v1 = the stand-in train step on the device
   (``p - REFRESH_STEP·p·z``, z ~ N(0, 1) from seed 1, every floating
   leaf; the JAX bench's ``p - 1e-3·p`` moves no bf16 value), published
   by the port's ``WeightPublisher`` into the temp dir and loaded back;
   (c) ``bench_serving_2b_refresh``'s protocol on one gateway: a second
   wave of 16 streams, ``refresh_weights(v1, 1)`` from a control thread
   once they stream, REFRESH_QUEUED requests submitted behind the staged
   swap: nothing lost, the in-flight streams equal v0's, the queued ones
   equal a cold-started engine's on the same v1 tree (the canary's
   oracle) and differ from v0's, ``weight_version`` 1; a swap with a live
   sequence refused; (d) v1 at REFRESH_FAULT_LAYERS layers published
   beside it (the depth cut for the run's time), then a bit-flipped payload
   and a forged manifest of it each rejected with
   ``WeightPublicationError``, the version and the probe's stream
   unchanged; (f) two adapters (rank 8, q/k/v/o) published to the
   engine's disk tier and adopted lazily at ``submit(adapter_id=...)``
   stream what they stream registered in memory on the cold engine (and
   not the base streams), v2 of one adopted streams the in-memory v2's,
   a torn publication is rejected typed and counted; (e) an int8 engine
   at REFRESH_QUANT_LAYERS of 32 layers, swapped to v1, holds carriers and
   scales byte-equal to a cold start's and serves its streams; then a
   third wave drained (``drain`` frees the engine's device memory). The
   temp dir is removed. Prints gateway and direct tokens/s, TTFT and
   inter-token p50/p99 from ``ServingMetrics``, host syncs a token,
   launches a forward, publish and load bytes, seconds and GB/s (free
   disk and host RAM before, the chain hash), the refresh's wall time,
   its wait for in-flight streams, the swap alone and the device memory
   peak over it, drain plus cold restart and ``drain_over_refresh``, and
   p99 inter-token gap during the refresh against steady state.
31. fleet — the in-process serving fleet on the same weights: two
   ``GatewayReplica``s (each a ``FaultyReplica`` with no fault armed until
   a lane arms one) behind a ``FleetRouter`` (heartbeat 0.2 s, retry
   backoff 0.05 s, stream token timeout 120 s), every engine of the phase
   (replicas, restarts, cold references, the direct runs) over the one
   device tree of its version (gated: no engine places a copy). (a)
   ``bench_serving_2b_fleet``'s protocol: 3 x 8 random 256-token prompts
   from ``RandomState(0)`` x 32 new tokens, budget 264, bursts of 16, in
   three parts: healthy; r0 killed once any stream has a token, 2 sampled
   requests (temperature 1.1, top_k 40, the seed derived by the router
   from its uid) beside the 8; after ``restart_replica("r0")``. Gates:
   nothing lost, every greedy stream equal to one engine's direct run,
   each sampled stream equal to its uninterrupted run on that engine with
   the router's seed, failovers >= 1, r0 back HEALTHY. (b)
   ``bench_serving_2b_refresh``'s fleet protocol with the canary on
   (``FleetRefreshController``, its ``reference_fn`` a cold-started
   engine on the target tree, the canary prompts the probe and the first
   prompt, 32 tokens each): v1 and v2 by phase 30's step, rolled out with
   the second and third 8 prompts in flight. Gates: no rollback, both
   replicas refreshed, the canary passed, nothing lost, every in-flight
   stream one version's direct stream, the probe's stream then equal on
   both replicas and a cold v2 engine's and not v0's. Then r1 killed and
   restarted on v2 (``drain_restart_s``), and from v2 to v3 (the step on
   v2) a crash mid-swap on r1 (rolled back, r1 DOWN, then restarted) and
   a version lie on r0 (the canary diverges, rolled back), the probe's
   stream on v2 on both replicas after each. (c)
   ``bench_serving_2b_disagg``'s trace (12 requests alternating 384-token
   prompts x 12 new tokens and 64-token prompts x 48, in bursts of 4 0.25
   s apart, budget 396) through a unified pair, then a prefill/decode
   pair (2 tokens from the prefill replica), each engine with the prefix
   cache and a 1 GiB bf16 KV tier. Gate: the pair's streams equal the
   unified fleet's, nothing lost. K2, K3 and K4 launch their counts over
   every forward of every engine of the phase (none on K4's first
   design). Prints, beside the card: tokens/s of each part of (a),
   failovers, retries and the restart's seconds; each rollout's wall time,
   ``drain_restart_s``, ``drain_over_refresh``, the p99 inter-token gap
   steady (part A of (a)) and during the rollouts, the faults' reasons; both fleets' p99 TTFT and coefficient of
   variation of inter-token gaps, handoffs and fallbacks; the device peak
   over (a) and (b) beside one tree's bytes.

The last lines are the card, one JSON object with every kernel's numbers
and, last, ``{"ok": true, "device": {...}}``."""

import contextlib
import dataclasses
import functools
import gc
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
MOE_INT8_LAYERS = 8           # phase 11: int8 Mixtral-8x7B, cut from 32 for the run's time
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
LORA_SERVING_LAYERS = 16      # phase 15: Mistral-7B's depth, cut from 32 for the run's time
K7_LAYERS = 32                # phase 16: Mistral-7B's layers in one demoted handle
K7_GROUP = 2048               # phase 16: quantize_int8's default group, beside the slab
# bench.py's bench_serving_2b_prefix (phase 18 a) and bench_serving_2b_kv_tier (18 b)
PFX_N_REQ, PFX_SYS, PFX_SFX, PFX_NEW, PFX_BURST = 8, 512, 32, 64, 16
TIER_N_REQ, TIER_SYS, TIER_SFX, TIER_NEW, TIER_BURST = 4, 512, 32, 64, 16
TIER_PROMPT = TIER_SYS + TIER_SFX
TIER_BUDGET = TIER_PROMPT + TIER_N_REQ
TIER_KV_BLOCKS = TIER_N_REQ * -(-(TIER_PROMPT + TIER_NEW) // BS) + 1 + 4  # 81: B evicts A
TIER_CONTROL_BLOCKS = 256     # nothing is evicted: A's and B's retired chains fit beside B
TIER_HOST_BYTES = 4 << 30
TIER_LAYERS = 16              # phase 18: Mistral-7B's depth, cut from 32 for the run's time
# phases 19-21: Mixtral-8x7B width, 2 of 32 layers; T·k = 8192 rows (B 2 x S 2048, top-2)
MOE_TRAIN_SIZES = (2048, 1638, 1229, 1065, 819, 737, 656, 0)  # skewed, expert 7 empty
DW_SMALL_SIZES = (40, 0, 16, 9, 30, 3, 20, 10)  # 128 rows, 16 an expert: 16-row tiles
MOE_TRAIN_LAYERS = 2
MB, MS, MGAS = 2, 2048, 2     # phase 21: micro batch, sequence, gas (bf16, Adam, ZeRO-3)
MOE_LOSS_TOL, MOE_AUX_TOL = 1e-4, 1e-4  # phase 20: relative, kernels vs plain
# phase 22: bench.py's bench_train_moe: 8 layers, hidden 768, I 2048, 12 heads, 8 experts,
# top-2, S 1024, B 4, gas 32
BENCH_MOE_LAYERS, BENCH_MOE_HIDDEN, BENCH_MOE_INTER, BENCH_MOE_HEADS = 8, 768, 2048, 12
BENCH_MOE_S, BENCH_MOE_B, BENCH_MOE_GAS = 1024, 4, 32
# phases 23-25: BERT-large (24 x 1024, 16 heads, Dh 64) at S 4096, BigBird block 64
BERT_B, BERT_S, BERT_GAS, BERT_PARITY_B = 4, 4096, 2, 2
BIGBIRD = {"mode": "bigbird", "block": 64, "num_random_blocks": 1,
           "num_sliding_window_blocks": 3, "num_global_blocks": 1}
# phase 23: name → (B, S, H, Dh, block, layout: "bigbird", "bigbird_per_head" or "unreached")
SPARSE_CASES = {"path": (BERT_B, BERT_S, 16, 64, 64, "bigbird"),
                "block16": (2, 2048, 16, 64, 16, "bigbird"),
                "per_head_block32": (2, 2048, 16, 64, 32, "bigbird_per_head"),
                "dh128_block128": (2, 2048, 8, 128, 128, "bigbird"),
                "empty_row_unreached": (2, 1024, 4, 64, 64, "unreached")}
LN_TOL = 2.0                  # phase 23, units of row_scaled_err (bf16 output rounding: 1)
BERT_LOSS_TOL = 1e-4          # phase 24, relative
BERT_GRAD_ROW_TOL = 256.0     # phase 24, units of row_scaled_err per parameter gradient
# phase 26: bench.py's bench_serving_2b_sampled: 8 requests x 256-token prompts x 64 new
# tokens, token budget prompt_len + n_req, bursts of 8; the max_burst 1 run over 16 tokens
SAMPLED_N_REQ, SAMPLED_PROMPT, SAMPLED_NEW, SAMPLED_BURST = 8, 256, 64, 8
SAMPLED_BUDGET = SAMPLED_PROMPT + SAMPLED_N_REQ
SAMPLED_STEP_TOKENS = 16
SAMPLED_LAYERS = 16           # phase 26: Mistral-7B's depth, cut from 32 for the run's time
# phase 27: bench.py's bench_serving_2b_spec: 8 requests x (a 256-token system prompt, a
# 16-token pattern tiled, + a 64-token template, an 8-token pattern tiled, its first token + i)
# x 64 new tokens, draft_len 4, bursts of 16, token budget prompt_len + n_req
SPEC_N_REQ, SPEC_SYS, SPEC_TMPL, SPEC_NEW, SPEC_BURST, SPEC_DRAFT = 8, 256, 64, 64, 16, 4
SPEC_PROMPT = SPEC_SYS + SPEC_TMPL
SPEC_BUDGET = SPEC_PROMPT + SPEC_N_REQ
# phase 28: bench.py's bench_serving_2b_json: 8 random 64-token prompts x 64 new tokens,
# temperature 1.1, top_k 40, seeds 500 + i, EOS 2, bursts of 8, 3 repeats
JSON_N_REQ, JSON_PROMPT, JSON_NEW, JSON_BURST, JSON_REPEATS, JSON_EOS = 8, 64, 64, 8, 3, 2
JSON_BUDGET = JSON_PROMPT + JSON_N_REQ
JSON_OVERHEAD_BOUND = 0.10  # the JAX bench's bound on the constrained overhead: a reading here
# phase 29: bench.py's bench_serving_v2_ragged (N_REQ x PROMPT x NEW, BUDGET, bursts of BURST)
# in a synchronous and a pipelined lane; the EOS lane stops at greedy request 0's token
# ASYNC_EOS_AT; the profiled window is ASYNC_WINDOW chained bursts; the sanitized run serves
# 4 of the prompts ASYNC_SANITIZE_NEW tokens
ASYNC_DEPTH, ASYNC_EOS_AT, ASYNC_WINDOW, ASYNC_SANITIZE_NEW = 2, 20, 2, 16
ASYNC_LAYERS = 16             # phase 29: the shared weights' first layers, cut for the run's time
# phase 30: bench_serving_v2_ragged's traffic through a ServingGateway, then
# bench_serving_2b_refresh's protocol on one gateway: REFRESH_QUEUED requests queue behind
# the staged swap; v1 = p - REFRESH_STEP·p·z (z ~ N(0, 1), seed 1) on every floating leaf;
# the int8 swap at REFRESH_QUANT_LAYERS of Mistral's 32 layers
REFRESH_STEP, REFRESH_QUEUED, REFRESH_QUANT_LAYERS = 1e-2, 4, 2
STEP_CHUNK = 1 << 26      # phases 30-31: values the stand-in train step takes at a time
REFRESH_FAULT_LAYERS = 2  # phase 30 (d): the faulted publication's depth, cut for the run's time
# phase 31: bench_serving_2b_fleet's trace (3 x FLEET_N_REQ random FLEET_PROMPT-token prompts
# from RandomState(0) x FLEET_NEW new tokens, budget prompt + n_req, bursts of 16) on two
# replicas, FLEET_SAMPLED sampled requests beside the kill; bench_serving_2b_disagg's
# (DISAGG_N_REQ requests alternating DISAGG_LONG-token prompts x DISAGG_NEW // 4 new tokens
# and DISAGG_SHORT-token prompts x DISAGG_NEW, in bursts of 4, DISAGG_PREFILL tokens from
# the prefill replica, a DISAGG_TIER_BYTES bf16 KV tier)
FLEET_N_REQ, FLEET_PROMPT, FLEET_NEW, FLEET_BURST, FLEET_SAMPLED = 8, 256, 32, 16, 2
FLEET_BUDGET = FLEET_PROMPT + FLEET_N_REQ
DISAGG_N_REQ, DISAGG_LONG, DISAGG_SHORT, DISAGG_NEW, DISAGG_PREFILL = 12, 384, 64, 48, 2
DISAGG_BUDGET, DISAGG_TIER_BYTES = DISAGG_LONG + DISAGG_N_REQ, 1 << 30


def log(msg):
    print(msg, flush=True)


SPIN_CYCLES = 400_000  # ~0.2 ms of the card's clock: longer than the host takes to enqueue a call


def time_ms(fn, flush, iters=20):
    """Median device ms of ``fn`` over ``iters`` launches, L2 flushed
    (a 256 MB write) before each, CUDA events around the call only. A
    spin on the card after the flush keeps it busy while the host
    enqueues the call, so the events bracket the call's kernels and not
    the host's launch path (a K4 call at decode enqueues in 20-60 µs,
    longer than its kernel runs)."""
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in events]))


def profiled_us(fn, flush, match, iters=20):
    """Median device µs of the kernels named with ``match`` that ``fn``
    launches, as torch.profiler's CUDA activity records them (the kernel's
    own span: no host enqueue, no spin), L2 flushed before each call; None
    when the profiler recorded no such kernel (not measured)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    spans = [ev.time_range.elapsed_us() for ev in prof.events()
             if ev.device_type == DeviceType.CUDA and match in ev.name]
    return float(np.median(spans)) if spans else None


# ---------------------------------------------------------------- phase 3
def attention_case(seed, contexts, chunk, MB, device, pad_rows=0, extra_pos=(),
                   shape=(H, HKV, DH, BS), pos_offset=0):
    """Sequences with ``contexts[i]`` tokens of which the last ``chunk``
    are this step's query tokens, each sequence on its own random blocks
    of one pool; ``extra_pos`` adds single rows at those positions and
    ``pad_rows`` rows on the all-null table at position 0, as the engine
    packs pad tokens. ``shape``: (H, Hkv, Dh, bs). ``pos_offset``: the
    positions as a view that many int32 into a larger vector, as the
    engine's packed batch puts them. → dict of device tensors (bf16
    q/kc/vc) and the shape."""
    nh, nkv, dh, bs = shape
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

    pos_buf = torch.from_numpy(np.concatenate([np.zeros(pos_offset, np.int32), pos]))
    return {"q": rand(T, nh, dh) * 2, "kc": rand(NB, bs, nkv, dh), "vc": rand(NB, bs, nkv, dh),
            "tables": torch.from_numpy(tables).to(device),
            "pos": pos_buf.to(device)[pos_offset:], "shape": shape}


def attention_bound(case):
    """(bound ms, 'bytes'|'operations', bytes, flops) for what this case's
    data needs: every K/V row some token attends read once, q read and
    the output written once, tables and positions read once."""
    nh, nkv, dh, bs = case["shape"]
    tables, pos = case["tables"].cpu().numpy(), case["pos"].cpu().numpy()
    T, MB = tables.shape
    n_pos = np.minimum(pos.astype(np.int64) + 1, MB * bs)
    rows = np.unique(np.concatenate([
        tables[t, np.arange(n) // bs].astype(np.int64) * bs + np.arange(n) % bs
        for t, n in enumerate(n_pos)]))
    nbytes = (rows.size * nkv * dh * 2 * 2 + 2 * T * nh * dh * 2 + tables.nbytes + pos.nbytes)
    flops = int(n_pos.sum()) * nh * dh * 4
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


def sdpa_inputs(case):
    """Dense [T, H, C, Dh] K/V gathered from the pool and a [T, 1, 1, C]
    mask, for the library yardstick (never used by the port)."""
    nh, nkv, dh, _ = case["shape"]
    kc, vc, tab, pos = case["kc"], case["vc"], case["tables"].long(), case["pos"].long()
    T = tab.shape[0]
    k = kc[tab].reshape(T, -1, nkv, dh).repeat_interleave(nh // nkv, dim=2).transpose(1, 2)
    v = vc[tab].reshape(T, -1, nkv, dh).repeat_interleave(nh // nkv, dim=2).transpose(1, 2)
    C = k.shape[2]
    mask = (torch.arange(C, device=kc.device)[None, :] <= pos[:, None])[:, None, None, :]
    return case["q"][:, :, None, :], k.contiguous(), v.contiguous(), mask


def paged_designs():
    """K3's launches so far by design."""
    from deepspeed_tpu_torch.ops.kernels.paged_attention import paged_design_launches
    return dict(paged_design_launches)


def paged_grew(before):
    return {k: v - before[k] for k, v in paged_designs().items()}


def serving_designs():
    """K3's and K6's launches so far by design."""
    from deepspeed_tpu_torch.ops.kernels.lora_matmul import lora_design_launches
    return {"K3": paged_designs(), "K6": dict(lora_design_launches)}


def designs_since(tag, before):
    """K3's and K6's launches by design since ``before`` (from
    ``serving_designs``), logged under ``tag``. Every serving lane runs
    Mistral-7B's or Mixtral's attention (H 32, Hkv 8, Dh 128, bs 32), which
    the tiled K3 design takes: a launch on the token design, or none on the
    tiled one, fails the run; so does a K6 launch off its mma design (the
    LoRA sites' bf16 16-byte rows). → {kernel: {design: launches}}."""
    now = serving_designs()
    grew = {k: {d: v - before[k][d] for d, v in now[k].items()} for k in now}
    if grew["K3"]["token"] or not grew["K3"]["tiled"] or grew["K6"]["general"]:
        raise AssertionError(f"{tag}: launches by design {grew}, want K3's all on the tiled "
                             f"design and K6's on the mma design")
    log(f"[{tag}] launches by design: {json.dumps(grew)}")
    return grew


def kernel_ms(profile, tag):
    """K3's and K6's device ms in each profiled step, logged under ``tag``."""
    out = {kind: {"K3_ms": p["by_category_ms"].get("paged_attention (K3)", 0.0),
                  "K6_ms": p["by_category_ms"].get("lora_delta (K6)", 0.0),
                  "device_ms": p["device_ms"], "forwards": p["forwards"]}
           for kind, p in profile.items()}
    log(f"[{tag}] K3 and K6 in the profiled steps: {json.dumps(out)}")
    return out


def kernel_phase(device, flush):
    """K3 at the serving shapes and at shapes beyond them, each case on the
    design ``paged_design`` names (the tiled design at every case here)
    and on the first (token) design, both within KERNEL_TOL of the plain
    version in max-abs and the named design within ROW_TOL of
    ``row_scaled_err`` (a zeroed tile must exceed it); the timed cases
    time both designs in the same call beside the plain version, SDPA and
    the bound."""
    from deepspeed_tpu_torch.ops.kernels.flash_attention import row_scaled_err
    from deepspeed_tpu_torch.ops.kernels.paged_attention import (paged_attention_ref,
                                                                 paged_decode_attention,
                                                                 paged_design)
    F = torch.nn.functional
    serve_mb = math.ceil((PROMPT + NEW) / BS)
    cases = {  # name: (case, timed)
        # the serving run's steps: a decode burst step (16 sequences midway
        # through generation) and a prefill step (4 prompts fill the budget)
        "serving_decode": (attention_case(1, [PROMPT + NEW // 2] * N_REQ, 1, serve_mb,
                                          device), True),
        "serving_prefill": (attention_case(2, [PROMPT] * (BUDGET // PROMPT), PROMPT,
                                           serve_mb, device), True),
        "decode_4k": (attention_case(3, np.linspace(1, 4096, 16).astype(int).tolist(), 1,
                                     4096 // BS, device), True),
        "prefill_chunk_512": (attention_case(4, [480 + 32] * 16, 32, 16, device), True),
        "edges": (attention_case(5, [1, 32, 33, 64, 65], 1, 3, device, pad_rows=3,
                                 extra_pos=(95, 96 + 40)), False),
        # beyond the serving path: the engine's default block size 16, one and
        # eight query heads a KV head, head dim 64, a chunk starting mid-block,
        # contexts across the tiled design's chunk cut at 512, an odd T with
        # token_pos 8 bytes off 16, pad rows after a prefill
        "bs16": (attention_case(6, [PROMPT + 64] * 4, 64, 12, device,
                                shape=(H, HKV, DH, 16)), True),
        "g1": (attention_case(7, [300] * 2, 100, 10, device, shape=(32, 32, DH, BS)), True),
        "g8": (attention_case(8, [300] * 2, 100, 10, device, shape=(32, 4, DH, BS)), True),
        "dh64": (attention_case(9, [PROMPT] * 4, PROMPT, serve_mb, device,
                                shape=(H, HKV, 64, BS)), True),
        "midblock_chunk": (attention_case(10, [211, 77, 150], 45, 8, device), True),
        "across_chunk_cut": (attention_case(11, [540, 1030, 600], 64, 40, device), True),
        "odd_t": (attention_case(12, [150, 43, 99], 33, 6, device, pos_offset=2), False),
        "pad_rows": (attention_case(13, [PROMPT] * 3, PROMPT, serve_mb, device,
                                    pad_rows=BUDGET - 3 * PROMPT), True),
    }
    out = []
    for name, (c, timed) in cases.items():
        args = (c["q"], c["kc"], c["vc"], c["tables"], c["pos"])
        nh, nkv, dh, bs = c["shape"]
        design = paged_design(nh, nkv, dh, bs)
        before = paged_designs()
        got = paged_decode_attention(*args)
        grew = paged_grew(before)
        first = paged_decode_attention(*args, design="token")
        want = paged_attention_ref(c["q"].float(), c["kc"].float(), c["vc"].float(),
                                   c["tables"], c["pos"])
        torch.cuda.synchronize()
        if grew != {d: int(d == design) for d in grew} or design != "tiled":
            raise AssertionError(f"kernel case {name}: launches by design {grew}, want one on "
                                 f"the tiled design")
        if not (torch.isfinite(got).all() and torch.isfinite(first).all()):
            raise AssertionError(f"kernel case {name}: non-finite output")
        err, ferr = max_abs(got, want), max_abs(first, want)
        zeroed = got.clone()
        zeroed[:1, :nh // nkv] = 0  # one (token, KV head)'s rows
        rerr, zerr = row_scaled_err(got, want), row_scaled_err(zeroed, want)
        row = {"case": name, "T": int(args[0].shape[0]), "MB": int(args[3].shape[1]),
               "H": nh, "Hkv": nkv, "Dh": dh, "bs": bs, "design": design, "max_abs_err": err,
               "row_err": rerr, "zeroed_tile_row_err": zerr, "first_design_max_abs_err": ferr}
        if max(err, ferr) > KERNEL_TOL or rerr > ROW_TOL or zerr <= ROW_TOL:
            raise AssertionError(f"kernel case {name}: max-abs {err} (first design {ferr}; "
                                 f"limit {KERNEL_TOL}), row_scaled_err {rerr} (limit {ROW_TOL}), "
                                 f"zeroed tile {zerr} (must exceed it)")
        if not torch.equal(paged_decode_attention(*args), got):
            raise AssertionError(f"kernel case {name}: a second run gave other bits")
        if timed:
            sq, sk, sv, smask = sdpa_inputs(c)
            bound, by, nbytes, flops = attention_bound(c)
            row.update(
                ms=time_ms(lambda: paged_decode_attention(*args), flush),
                first_design_ms=time_ms(lambda: paged_decode_attention(*args, design="token"),
                                        flush),
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


# ---------------------------------------------------------------- phase 4b
INV_SEQS, INV_TOKENS = 16, 512  # the serving engine's two token buckets (max_seqs, budget)
INV_ROWS = (1, 7, 16, 40, 64, 255, 512)  # row counts of the per-op reading (40: a verify's)
INV_GEMMS = ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096), (4096, 32000))
INV_ROUNDS = 3  # the cost reading: each path in turn, three times
# each serving op the layer step calls, in order (model_runner._layer_step), then the tail
INV_OPS = ("input_norm", "q", "k", "v", "rope_q", "rope_k", "attention", "o", "post_norm",
           "gate", "up", "down")


def cublas_proj(x, w, b=None):
    """The serving projection before the repair: ``x @ w`` through cuBLAS
    for a bf16 weight (the fused kernel for carriers)."""
    from deepspeed_tpu_torch.inference.quantization.quantization import matmul_any
    y = matmul_any(x, w, dtype=x.dtype)
    return y if b is None else y + b.to(x.dtype)


@contextlib.contextmanager
def serving_proj(proj):
    """Pin the serving forward's projection to ``proj``."""
    from deepspeed_tpu_torch.inference.v2 import model_runner as mr
    saved, mr._proj = mr._proj, proj
    try:
        yield
    finally:
        mr._proj = saved


def k4_designs(inst):
    """K4's launches so far by design, of ``inst`` ("dense" or "quant")."""
    from deepspeed_tpu_torch.ops.kernels.fused_quant_matmul import k4_design_launches
    return dict(k4_design_launches[inst])


def k4_grew(inst, before):
    return {k: v - before[k] for k, v in k4_designs(inst).items()}


def one_hot_rows(M, K, device):
    """M one-hot bf16 rows over K, row i picking weight row (7919 i) % K →
    (rows, picks)."""
    picks = (torch.arange(M, device=device) * 7919) % K
    x = torch.zeros(M, K, device=device, dtype=torch.bfloat16)
    x[torch.arange(M, device=device), picks] = 1
    return x, picks


def kernels_per_call(fn, calls=4):
    """The kernels one call of ``fn`` launches on the card, read from a
    profile of ``calls`` calls (the profiler's first events can go
    unrecorded)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(ev.count for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA) / calls


def host_us_per_call(fn, n=200):
    """Host µs to enqueue one call of ``fn`` (the decode forward is host-bound)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def dense_matmul_cases(device, flush):
    """``dense_matmul`` at Mistral-7B's projections, decode (16 rows: the
    decode design) and prefill (512 rows: the prefill design): each on the
    design ``k4_design`` names, within QUANT_TOL of its plain version
    (cuBLAS on the same bf16 inputs; both sum fp32 products in other
    orders and round once), the check rejecting one 64-column tile zeroed;
    the first design ("general") held to the same check; timed beside the
    plain version (which is also the library call), the first design on
    the same inputs and the bound, with the kernels a call launches and the
    host µs to enqueue one."""
    from deepspeed_tpu_torch.ops.kernels.flash_attention import row_scaled_err
    from deepspeed_tpu_torch.ops.kernels.fused_quant_matmul import (dense_matmul,
                                                                     dense_matmul_ref,
                                                                     k4_design)
    rows = []
    for i, (K, N) in enumerate(INV_GEMMS):
        for M in (INV_SEQS, INV_TOKENS):
            g = torch.Generator(device=device).manual_seed(300 + i)
            x = torch.randn(M, K, generator=g, device=device).to(torch.bfloat16)
            w = (torch.randn(K, N, generator=g, device=device) * 0.02).to(torch.bfloat16)
            design, before = k4_design("bf16", M, K, N, x.data_ptr(), w.data_ptr()), \
                k4_designs("dense")
            got, want = dense_matmul(x, w), dense_matmul_ref(x, w)
            torch.cuda.synchronize()
            if k4_grew("dense", before) != {d: int(d == design) for d in before} or \
                    design == "general":
                raise AssertionError(f"dense_matmul M={M} [{K}, {N}]: launches by design "
                                     f"{k4_grew('dense', before)}, want 1 on {design}, a "
                                     f"Hopper design")
            err, zerr = row_scaled_err(got, want.float()), row_scaled_err(zero_col_tile(got),
                                                                         want.float())
            if err > QUANT_TOL or zerr <= QUANT_TOL:
                raise AssertionError(f"dense_matmul M={M} [{K}, {N}]: row_scaled_err {err}, "
                                     f"zeroed tile {zerr}")
            eye, picks = one_hot_rows(M, K, device)
            if not torch.equal(dense_matmul(x, w), got) or \
                    not torch.equal(dense_matmul(eye, w), w[picks]):
                raise AssertionError(f"dense_matmul M={M} [{K}, {N}]: a second run gave other "
                                     f"bits, or one-hot rows did not give w's rows exactly")
            first = lambda: dense_matmul(x, w, design="general")  # noqa: E731
            fgot = first()  # the general design, held to the same check
            ferr, fzerr = row_scaled_err(fgot, want.float()), \
                row_scaled_err(zero_col_tile(fgot), want.float())
            if ferr > QUANT_TOL or fzerr <= QUANT_TOL:
                raise AssertionError(f"dense_matmul M={M} [{K}, {N}], general design: "
                                     f"row_scaled_err {ferr}, zeroed tile {fzerr}")
            b_ms, b_by = bound(2 * (M * K + K * N + M * N), 2 * M * K * N)
            plain_ms = time_ms(lambda: dense_matmul_ref(x, w), flush)
            row = {"case": f"M{M}_{K}x{N}", "M": M, "K": K, "N": N, "design": design,
                   "max_abs_err": max_abs(got, want), "row_err": err, "zeroed_tile_row_err": zerr,
                   "first_design_row_err": ferr, "first_design_zeroed_tile_row_err": fzerr,
                   "ms": time_ms(lambda: dense_matmul(x, w), flush), "plain_ms": plain_ms,
                   "first_design_ms": time_ms(first, flush),
                   "bound_ms": b_ms, "bound_by": b_by, "library_ms": plain_ms,
                   "library_call": "torch.matmul (the plain version)",
                   "kernels_per_call": kernels_per_call(lambda: dense_matmul(x, w)),
                   "first_design_kernels_per_call": kernels_per_call(first),
                   "host_us_per_call": host_us_per_call(lambda: dense_matmul(x, w)),
                   "first_design_host_us_per_call": host_us_per_call(first),
                   "plain_host_us_per_call": host_us_per_call(lambda: dense_matmul_ref(x, w))}
            log(f"[dense-matmul] {json.dumps(row)}")
            rows.append(row)
    return rows


def invariance_ops_reading(device):
    """Row 0 of each op at every row count of INV_ROWS against row 0
    alone (M = 1), bitwise: the row counts at which its bits move."""
    from deepspeed_tpu_torch.inference.v2.model_runner import _rms
    from deepspeed_tpu_torch.ops.kernels.fused_norms import rms_norm_ref
    from deepspeed_tpu_torch.ops.kernels.fused_quant_matmul import dense_matmul
    g = torch.Generator(device=device).manual_seed(11)
    M = max(INV_ROWS)
    out = {}

    def moved(f, x):
        """The row counts at which any row differs from that row alone."""
        alone = torch.cat([f(x[r:r + 1].contiguous()) for r in range(M)])
        return [m for m in INV_ROWS if not torch.equal(f(x[:m].contiguous()), alone[:m])]

    for K, N in INV_GEMMS:
        x = torch.randn(M, K, generator=g, device=device).to(torch.bfloat16)
        w = (torch.randn(K, N, generator=g, device=device) * 0.02).to(torch.bfloat16)
        out[f"cublas_{K}x{N}"] = moved(lambda a: a @ w, x)
        flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        try:
            out[f"cublas_fp32_reduce_{K}x{N}"] = moved(lambda a: a @ w, x)
        finally:
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = flag
        out[f"dense_matmul_{K}x{N}"] = moved(lambda a: dense_matmul(a, w), x)
    x = torch.randn(M, 4096, generator=g, device=device).to(torch.bfloat16) * 3
    sc = (1 + 0.1 * torch.randn(4096, generator=g, device=device)).to(torch.bfloat16)
    out["eager_rms_4096"] = moved(lambda a: rms_norm_ref(a, sc, 1e-5), x)  # the former path
    out["rms_4096"] = moved(lambda a: _rms(a, sc, 1e-5), x)  # serving's: K2's RMS forward
    log(f"[invariance] per op, the row counts of {list(INV_ROWS)} at which any row differs "
        f"from the same row alone: {json.dumps(out)}")
    out["paged_attention"] = paged_invariance_reading(device)
    return out


INV_CHUNKS = (1, 7, 16, 64, 128)  # chunk lengths of K3's reading


def paged_invariance_reading(device):
    """K3 at Mistral-7B's attention: a sequence's chunk of L tokens (L in
    INV_CHUNKS, the last at position 530, past the tiled design's chunk
    cut at 512) beside three decoding sequences and two pad rows, then
    its chunk alone, the batch with it last, and each of its tokens alone
    (T 1): → the lengths L at which any of its rows' bits moved."""
    from deepspeed_tpu_torch.ops.kernels.paged_attention import paged_decode_attention
    moved = []
    for L in INV_CHUNKS:
        c = attention_case(20 + L, [531], L, 24, device, pad_rows=2, extra_pos=(40, 200, 600))
        T = c["pos"].shape[0]

        def rows(idx):
            idx = torch.as_tensor(list(idx), device=device)
            return paged_decode_attention(c["q"][idx].contiguous(), c["kc"], c["vc"],
                                          c["tables"][idx].contiguous(),
                                          c["pos"][idx].contiguous())

        mixed = rows(range(T))[:L]
        same = (torch.equal(rows(range(L)), mixed)
                and torch.equal(rows(list(range(L, T)) + list(range(L)))[T - L:], mixed)
                and all(torch.equal(rows([t])[0], mixed[t]) for t in range(L)))
        if not same:
            moved.append(L)
    log(f"[invariance] paged attention (K3): the chunk lengths of {list(INV_CHUNKS)} at which "
        f"a row's bits moved beside other sequences, alone or last: {moved}")
    return moved


def invariance_trace(cfg, params, device, proj=None):
    """One request's decode token at the decode bucket (alone) and at the
    prefill bucket (beside another request's prompt), same weights and
    prompt: → (equal logits, the ops that moved by themselves, every op's
    first difference), recording each op's input and output for that
    token's row (row 0: the request is the batch's first)."""
    from deepspeed_tpu_torch.inference.v2 import (DSStateManagerConfig, InferenceEngineV2,
                                                  RaggedInferenceEngineConfig)
    from deepspeed_tpu_torch.inference.v2 import model_runner as mr
    sm = DSStateManagerConfig(max_ragged_batch_size=INV_TOKENS,
                              max_ragged_sequence_count=INV_SEQS, max_tracked_sequences=4,
                              max_context=256)
    rng = np.random.RandomState(5)
    prompt = rng.randint(0, cfg.vocab_size, 100).astype(np.int32)
    other = rng.randint(0, cfg.vocab_size, 60).astype(np.int32)
    runs = {}
    for kind in ("alone", "mixed"):
        eng = InferenceEngineV2(cfg, RaggedInferenceEngineConfig(kv_block_size=BS,
                                                                 state_manager=sm),
                                params=params, device=device)
        first = eng.put([0], [prompt])
        tok = int(np.argmax(first[0]))
        rec = []

        def wrap(fn):
            def call(x, *args, **kw):
                y = fn(x, *args, **kw)
                rec.append((x[:1].clone(), y[:1].clone()))
                return y
            return call

        saved = mr._proj, mr._rms, mr._rope_flat, mr._paged_attend
        mr._proj, mr._rms = wrap(proj or mr._proj), wrap(mr._rms)
        mr._rope_flat, mr._paged_attend = wrap(mr._rope_flat), wrap(mr._paged_attend)
        try:
            logits = eng.put([0] if kind == "alone" else [0, 1], [[tok]] if kind == "alone"
                             else [[tok], other])
        finally:
            mr._proj, mr._rms, mr._rope_flat, mr._paged_attend = saved
        runs[kind] = (logits[0], rec)
        eng.destroy()
    names = [f"layer{i}.{op}" for i in range(cfg.num_hidden_layers) for op in INV_OPS] + \
        ["final_norm", "head"]
    (la, ra), (lb, rb) = runs["alone"], runs["mixed"]
    if len(ra) != len(names) or len(rb) != len(names):
        raise AssertionError(f"invariance: recorded {len(ra)}/{len(rb)} ops, want {len(names)}")
    moved_alone, first_diff = [], None
    for name, (xa, ya), (xb, yb) in zip(names, ra, rb):
        same_in, same_out = torch.equal(xa, xb), torch.equal(ya, yb)
        if same_in and not same_out:
            moved_alone.append(name)
        if first_diff is None and not same_out:
            first_diff = name
    return bool(np.array_equal(la, lb)), moved_alone, first_diff


def batch_invariance_phase(device):
    """Phase 4b: the per-op reading, then a 2-layer Mistral-7B-width
    engine's decode token alone (bucket INV_SEQS) and beside a prompt
    (bucket INV_TOKENS) through the port's serving path (gate: equal
    logits and no op that moves), and with the projections pinned to
    cuBLAS, the path before the repair (a reading: its first difference
    names the op that moved)."""
    from deepspeed_tpu_torch.models import init_params, llama_config
    ops = invariance_ops_reading(device)
    cfg = llama_config("mistral-7b", num_hidden_layers=2)
    params = init_params(cfg, device, torch.bfloat16,
                         torch.Generator(device=device).manual_seed(1))
    out = {"ops": ops}
    for name, proj in (("port", None), ("cublas_proj", cublas_proj)):
        equal, moved, first = invariance_trace(cfg, params, device, proj)
        out[name] = {"logits_equal": equal, "ops_that_moved": moved, "first_difference": first}
        log(f"[invariance] {name}: decode token alone vs at the prefill bucket: logits equal "
            f"{equal}; ops whose output moved on equal input {moved}; first difference "
            f"{first}")
    if ops["paged_attention"]:
        raise AssertionError(f"invariance: K3's rows moved with their tile or batch at chunk "
                             f"lengths {ops['paged_attention']}")
    serving_ops = {k: v for k, v in ops.items() if k.startswith(("dense_matmul", "rms_4096"))}
    if any(serving_ops.values()):
        raise AssertionError(f"invariance: a serving op's rows moved with the row count: "
                             f"{serving_ops}")
    if not out["port"]["logits_equal"] or out["port"]["ops_that_moved"]:
        raise AssertionError(f"invariance: the serving path moves with the token bucket: "
                             f"{out['port']}")
    del params
    torch.cuda.empty_cache()
    return out


def invariance_cost(engine):
    """Phase 5's traffic on ``engine`` with the projections through
    ``dense_matmul`` (the port) and pinned to cuBLAS (before the repair),
    in turn INV_ROUNDS times each (cuBLAS, port, port, cuBLAS, ...): the
    runs are host-bound and vary, so medians. → generated tokens/s and ms
    per forward of each."""
    order = (["cublas", "port", "port", "cublas"] * INV_ROUNDS)[:2 * INV_ROUNDS]
    runs = {"cublas": [], "port": []}
    for name in order:
        f0 = engine.forward_steps
        with serving_proj(cublas_proj) if name == "cublas" else contextlib.nullcontext():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_requests(engine, N_REQ, PROMPT, NEW, seed=0)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        runs[name].append((N_REQ * NEW / dt, dt * 1e3 / (engine.forward_steps - f0)))
    out = {name: {"gen_tokens_per_sec_median": float(np.median([r[0] for r in rows])),
                  "gen_tokens_per_sec": [r[0] for r in rows],
                  "ms_per_forward_median": float(np.median([r[1] for r in rows]))}
           for name, rows in runs.items()}
    out["port_over_cublas"] = (out["port"]["gen_tokens_per_sec_median"] /
                               out["cublas"]["gen_tokens_per_sec_median"])
    log(f"[invariance] cost on phase 5's traffic: {json.dumps(out)}")
    return out


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
    from deepspeed_tpu_torch.ops.kernels.fused_quant_matmul import dense_matmul
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

    paged_decode_attention.launches = dense_matmul.launches = 0
    forwards, restore = forward_split(engine, {"k4": lambda: k4_designs("dense")})
    kd0 = serving_designs()
    t0 = time.perf_counter()
    streams, steps = run_requests(engine, N_REQ, PROMPT, NEW, seed=0)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    restore()
    kd = designs_since("serving", kd0)
    launches = paged_decode_attention.launches
    dense_launches = dense_matmul.launches

    fwd = engine.forward_steps - fwd0
    syncs, toks = engine.host_syncs - syncs0, engine.tokens_emitted - toks0
    if launches == 0 or launches != cfg.num_hidden_layers * fwd:
        raise AssertionError(f"kernel launches {launches} != layers x forward steps "
                             f"{cfg.num_hidden_layers} x {fwd}")
    if dense_launches != (7 * cfg.num_hidden_layers + 1) * fwd:  # q k v o gate up down, head
        raise AssertionError(f"dense_matmul launches {dense_launches} != (7 x layers + 1) x "
                             f"forward steps {fwd}")
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
              "kernel_launches": launches, "dense_matmul_launches": dense_launches,
              "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(f"[serving] {json.dumps(result)}")
    log(f"[serving] request 0 first tokens: {streams[0][:8]}")
    result["k4_forwards"] = k4_split_forwards(forwards, "k4", 7 * cfg.num_hidden_layers + 1,
                                              "serving")
    result["profile"] = profile_steps(engine)
    result["designs"] = dict(kd, device_ms=kernel_ms(result["profile"], "serving"))
    result["k4_device"] = k4_share(result["profile"], "dense_matmul (K4's bf16 instance)",
                                   "serving")
    result["invariance_cost"] = invariance_cost(engine)
    engine.destroy()
    return result, launches


_CATEGORIES = (  # (category, name patterns: a substring, or a tuple of substrings that must
    # all appear), first match wins; K4's first design and K5's are instances of one template
    # ("qgemm"), their Hopper designs of one body (ring_gemm.cuh) under separate names
    ("lora_delta (K6)", ("lora_kernel", "lora_mma_kernel")),
    ("dense_matmul (K4's bf16 instance)", (("qgemm_kernel<0,", "false>"), "k4_stream_kernel<0>",
                                           "k4_ring_kernel<0>", "k4_dense_ring_kernel")),
    ("quant_matmul (K4)", (("qgemm_kernel", "false>"), "k4_stream_kernel", "k4_ring_kernel")),
    ("split-K sums (K4's first design)", ("reduce_splits_kernel",)),
    ("grouped_matmul (K5)", (("qgemm_kernel", "true>"), ("gmm_wgmma_kernel", "true>"),
                             "gmm_stream_kernel")),
    ("grouped_matmul dx (K5 backward)", ("gmm_dx_kernel", ("gmm_wgmma_kernel", "false>"))),
    ("grouped_matmul dW (K5 backward)", ("gmm_dw_kernel", "gmm_dw_wgmma_kernel")),
    ("flash_attention (K1)", ("flash_fwd_kernel", "flash_bwd_dkv_kernel", "flash_bwd_dq_kernel")),
    ("rms_norm (K2)", ("rms_fwd_kernel",)),
    ("layer_norm (K2)", ("ln_fwd_kernel",)),
    ("block_sparse_attention (K8)", ("bsa_fwd_kernel", "bsa_dq_kernel", "bsa_dkv_kernel",
                                     "bsa_fwd_wgmma_kernel", "bsa_dq_wgmma_kernel",
                                     "bsa_dkv_wgmma_kernel")),
    ("paged_attention (K3)", ("paged_decode_kernel", "paged_tiled_kernel")),
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


def _kernel_name(key):
    """A kernel's name without its return type, namespace and arguments."""
    return key.replace("(anonymous namespace)::", "").split("(", 1)[0].replace("void ", "")


def _summarize(prof, wall_ms, forwards, detail=None):
    """→ device ms by category of the profiled window, and by kernel for the
    category ``detail``."""
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
    if detail is not None:
        out["by_kernel_ms"] = {f"{_kernel_name(n)} x{c}": ms for n, ms, c in rows
                               if _category(n) == detail}
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
    sdpa_ms = sdpa_library(q, k, v, do, mask, causal, flush)
    if not sdpa_ms:
        raise AssertionError(f"flash case {name}: no SDPA backend takes it")
    fwd_by, bwd_by = (min(sdpa_ms, key=lambda b: sdpa_ms[b][i]) for i in (0, 1))
    lib_fwd, lib_bwd = sdpa_ms[fwd_by][0], sdpa_ms[bwd_by][1]
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
    rows["flash_fwd"]["library_call"] = f"scaled_dot_product_attention forward ({fwd_by})"
    rows["flash_fwd"]["library_ms_by_backend"] = {b: t[0] for b, t in sdpa_ms.items()}
    for key in ("flash_bwd_dkv", "flash_bwd_dq"):
        rows[key]["library_call"] = (f"scaled_dot_product_attention backward (dq, dk, dv; "
                                     f"{bwd_by})")
        rows[key]["library_ms_by_backend"] = {b: t[1] for b, t in sdpa_ms.items()}
    return rows


SDPA_BACKENDS = ("FLASH_ATTENTION", "CUDNN_ATTENTION", "EFFICIENT_ATTENTION")


def sdpa_library(q, k, v, do, mask, causal, flush):
    """SDPA's forward, and its backward (dq, dk, dv through autograd), on a
    case's inputs under each of SDPA_BACKENDS that the installed PyTorch
    has → {backend: (forward ms, backward ms)}. A backend that refuses
    the case (a mask it does not take) is left out, and said so."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    F = torch.nn.functional
    sq, sk, sv = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
    sdo = do.transpose(1, 2)

    def sdpa():
        return F.scaled_dot_product_attention(sq, sk, sv, attn_mask=mask,
                                              is_causal=causal and mask is None)

    out = {}
    for name in SDPA_BACKENDS:
        backend = getattr(SDPBackend, name, None)
        if backend is None:
            continue
        try:
            with sdpa_kernel(backend):
                s_out = sdpa()
        except RuntimeError as e:
            log(f"[train-kernels] SDPA {name} refuses B={q.shape[0]} S={q.shape[1]} "
                f"H={q.shape[2]} Dh={q.shape[3]} causal={causal} mask={mask is not None}: "
                f"{str(e).splitlines()[0][:120]}")
            continue
        bwd = time_ms(lambda: torch.autograd.grad(s_out, (sq, sk, sv), sdo,
                                                  retain_graph=True), flush)
        with sdpa_kernel(backend), torch.no_grad():
            fwd = time_ms(sdpa, flush)
        out[name] = (fwd, bwd)
        del s_out
    return out


@functools.lru_cache(maxsize=None)
def flash_designs():
    """The design of each K1 kernel in the built library, read from its SASS
    (``build.sass_counts``): "wgmma" where it issues HGMMA, "mma.sync"
    where it issues HMMA only; both head dims' instances must agree. The
    library holds one forward, one dK/dV and one dQ kernel template, so
    every counted launch of a wrapper takes its kernel's design. Fails
    unless all three are the wgmma designs."""
    from deepspeed_tpu_torch.ops.kernels import build
    counts = build.sass_counts("flash_attention.cu", ("HGMMA", "HMMA"))
    out = {}
    for key in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
        kinds = {"wgmma" if c["HGMMA"] else "mma.sync" if c["HMMA"] else "none"
                 for n, c in counts.items() if f"{key}_kernel" in n}
        if len(kinds) != 1:
            raise AssertionError(f"{key}: kernels of designs {kinds} in the library: {counts}")
        out[key] = kinds.pop()
    if set(out.values()) != {"wgmma"}:
        raise AssertionError(f"flash designs {out}: the forward, dK/dV and dQ must be wgmma")
    return out


def flash_design_launches(launches, where):
    """Counted K1 launches by design (``flash_designs``), logged under
    ``where`` → {kernel: {design: launches}}."""
    designs = flash_designs()
    out = {k: {designs[k]: launches[k]} for k in designs if k in launches}
    log(f"[{where}] flash launches by design: {json.dumps(out)}")
    return out


def train_kernel_phase(device, flush):
    cases = {  # name: (B, S, H, Dh, causal, segments)
        "path": (TB, TS, 16, 128, True, 0),
        "s1000": (2, 1000, 16, 128, True, 0),
        "packed_4_segments": (TB, TS, 16, 128, True, 4),
        "noncausal": (2, TS, 16, 128, False, 0),
        "h32": (2, TS, 32, 128, True, 0),
        "dh64": (TB, TS, 32, 64, True, 0),
        "s2049": (2, TS + 1, 16, 128, True, 0),
        "bert_dense": (BERT_B, BERT_S, 16, 64, False, 0),  # phase 25's dense comparison
    }
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    out = {"flash_fwd": [], "flash_bwd_dkv": [], "flash_bwd_dq": []}
    counters = {"flash_fwd": fa.flash_fwd, "flash_bwd_dkv": fa.flash_bwd_dkv,
                "flash_bwd_dq": fa.flash_bwd_dq}
    before = {k: f.launches for k, f in counters.items()}
    for i, (name, (B, S, H, D, causal, n_seg)) in enumerate(cases.items()):
        c = flash_case(10 + i, B, S, H, D, causal, n_seg, device)
        rows = flash_kernel_cases(c, name, flush)
        for key, row in rows.items():
            log(f"[train-kernels] {key} {json.dumps(row)}")
            out[key].append(row)
        dq = rows["flash_bwd_dq"]
        log(f"[train-kernels] dq {name}: {dq['ms'] * 1e3:.1f} us, SDPA's whole backward "
            f"{dq['library_ms'] * 1e3:.1f} us, bound {dq['bound_ms'] * 1e3:.2f} us "
            f"({dq['bound_by']})")
        del c
        torch.cuda.empty_cache()
    flash_design_launches({k: f.launches - before[k] for k, f in counters.items()},
                          "train-kernels")
    out["rms_norm_fwd"] = rms_cases(device, flush)
    return out


def rms_cases(device, flush):
    """The RMS-norm forward at the training path's [8192, 2048], at an odd
    shape and at Mixtral's width, bf16 and fp32, against its plain version
    (within one ulp of the output dtype at each element's magnitude), each
    timed beside the plain version, ``F.rms_norm`` and the bound → rows."""
    from deepspeed_tpu_torch.ops.kernels.fused_norms import rms_norm_fwd, rms_norm_ref
    F = torch.nn.functional
    out = []
    bf16, fp32 = torch.bfloat16, torch.float32
    for name, rows, D, dtype in (("path", TB * TS, 2048, bf16), ("odd_rows", 37, 4104, bf16),
                                 ("mixtral_width", 2 * TS, 4096, bf16),
                                 ("path_fp32", TB * TS, 2048, fp32),
                                 ("mixtral_width_fp32", 2 * TS, 4096, fp32)):
        g = torch.Generator(device=device).manual_seed(rows)
        x = (torch.randn(rows, D, generator=g, device=device) * 3).to(dtype)
        scale = (1 + 0.1 * torch.randn(D, generator=g, device=device)).to(dtype)
        got = rms_norm_fwd(x, scale)
        want = rms_norm_ref(x.float(), scale.float())
        torch.cuda.synchronize()
        ulp = 2.0 ** -7 if dtype == bf16 else 2.0 ** -23  # one ulp of the output dtype
        ulp_ok = (got.float() - want).abs() <= ulp * want.abs() + 1e-6
        if not ulp_ok.all():
            raise AssertionError(f"rms case {name}: {int((~ulp_ok).sum())} elements beyond "
                                 f"one {dtype} ulp")
        nb = (2 * x.numel() + D) * x.element_size()
        b_ms, b_by = bound(nb, 4 * x.numel())
        row = {"case": name, "rows": rows, "D": D, "dtype": str(dtype).split(".")[1],
               "max_abs_err": (got.float() - want).abs().max().item(),
               "ms": time_ms(lambda: rms_norm_fwd(x, scale), flush),
               "plain_ms": time_ms(lambda: rms_norm_ref(x, scale), flush),
               "library_ms": time_ms(lambda: F.rms_norm(x, (D,), scale, 1e-5), flush),
               "library_call": "torch.nn.functional.rms_norm",
               "bound_ms": b_ms, "bound_by": b_by, "bytes": nb, "flops": 4 * x.numel()}
        log(f"[train-kernels] rms_norm_fwd {json.dumps(row)}")
        out.append(row)
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
        gc.collect()  # the wrapped step and the engine hold each other
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


def capture_grads(engine, to_host=False):
    """→ a list that ``engine.step()`` fills with a copy of the accumulated
    fp32 gradients, one per parameter, just before it applies them; in
    host memory with ``to_host`` (two 3.17 B-parameter runs' gradients do
    not fit the card beside an engine)."""
    grads, step = [], engine.step

    def recording_step(*args, **kwargs):
        if engine.is_gradient_accumulation_boundary():
            grads[:] = [g.float().cpu() if to_host else g.float().clone()
                        for g in engine._grads_acc]
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
    by_design = flash_design_launches(launches, "training")
    for k in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):  # every launch on wgmma
        if by_design[k].get("wgmma") != 4 * per_step[k]:
            raise AssertionError(f"{k}: launches by design {by_design[k]}, want "
                                 f"4 x {per_step[k]} on wgmma")
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
           "flash_launches_by_design": by_design, "grad_norm": engine.global_grad_norm}
    log(f"[training] {json.dumps(res)}")
    res["profile"] = profile_train_step(engine, batch)
    engine.destroy()
    del model, engine
    torch.cuda.empty_cache()
    return res, launches


def profile_train_step(engine, batch, detail=None):
    """One more ``train_batch`` under torch.profiler → device time by kernel
    (each kernel of the category ``detail`` by name) and the device's busy
    share of the step's wall time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.train_batch(batch=batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    out = _summarize(prof, wall_ms, 1, detail)
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
    """K4 at the Mixtral serving shapes, for every scheme, each on the
    design ``k4_design`` names (one case a scheme with x at an unaligned
    base: the first design), the first design on the same inputs held to
    the same check, and timed beside it. → rows."""
    from deepspeed_tpu_torch.ops.kernels.flash_attention import row_scaled_err
    from deepspeed_tpu_torch.ops.kernels.fused_quant_matmul import (dequantize_grouped,
                                                                     k4_design, quant_matmul,
                                                                     quant_matmul_ref)
    cases = [(scheme, M, K, N) for scheme in ("int8", "fp8", "fp6")
             for (K, N) in ATTN_SHAPES for M in (8, 264, 37)]
    cases += [(scheme, M, K, N) for scheme in ("int8", "fp6") for (K, N) in MLP_SHAPES
              for M in (8, 264)]
    cases += [(scheme, 8) + HEAD_SHAPE for scheme in ("int8", "fp8", "fp6")]
    cases += [(scheme, 8) + ATTN_SHAPES[0] + ("unaligned",) for scheme in ("int8", "fp8", "fp6")]
    rows, exact_done = [], set()
    for i, (scheme, M, K, N, *unaligned) in enumerate(cases):
        x, q = quant_inputs(100 + i, M, (K, N), scheme, device)
        if unaligned:
            x = unaligned_copy(x)
        v, sc = q.values, q.scales
        name = f"quant_matmul {scheme} M={M} [{K}, {N}]" + (" unaligned x" if unaligned else "")
        design = k4_design(scheme, M, K, N, x.data_ptr(), v.data_ptr())
        if design != ("general" if unaligned else "stream" if M <= 16 else "wgmma"):
            raise AssertionError(f"{name}: k4_design names {design}")
        before = k4_designs("quant")
        got = quant_matmul(x, v, sc, scheme)
        want = quant_matmul_ref(x, v, sc, scheme)
        torch.cuda.synchronize()
        if k4_grew("quant", before) != {d: int(d == design) for d in before}:
            raise AssertionError(f"{name}: launches by design {k4_grew('quant', before)}, "
                                 f"want 1 on {design}")
        if not torch.isfinite(got.float()).all():
            raise AssertionError(f"{name}: non-finite kernel output")
        if not torch.equal(quant_matmul(x, v, sc, scheme), got):
            raise AssertionError(f"{name}: a second run gave other bits")
        err = row_scaled_err(got, want.float())
        zerr = row_scaled_err(zero_col_tile(got), want.float())
        if err > QUANT_TOL or zerr <= QUANT_TOL:
            raise AssertionError(f"{name}: row_scaled_err {err} (limit {QUANT_TOL}), zeroed "
                                 f"tile {zerr} (must exceed it)")
        row = {"case": f"{scheme}_M{M}_{K}x{N}" + ("_unaligned" if unaligned else ""),
               "scheme": scheme, "M": M, "K": K, "N": N, "design": design,
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
        eye, picks = one_hot_rows(M, K, device)  # and M of them, through this case's design
        if unaligned:
            eye = unaligned_copy(eye)
        if not torch.equal(quant_matmul(eye, v, sc, scheme), w_bf16[picks]):
            raise AssertionError(f"{name}: {M} one-hot rows through the {design} design do "
                                 f"not reproduce dequantize_grouped exactly")
        if not unaligned:  # the first design on the same inputs, held to the same check
            fgot = quant_matmul(x, v, sc, scheme, design="general")
            ferr = row_scaled_err(fgot, want.float())
            fzerr = row_scaled_err(zero_col_tile(fgot), want.float())
            if ferr > QUANT_TOL or fzerr <= QUANT_TOL:
                raise AssertionError(f"{name}, general design: row_scaled_err {ferr} (limit "
                                     f"{QUANT_TOL}), zeroed tile {fzerr} (must exceed it)")
            row.update(first_design_row_err=ferr, first_design_zeroed_tile_row_err=fzerr)
            del fgot
        nbytes = q.nbytes() + x.nbytes + M * N * 2
        b_ms, b_by = bound(nbytes, 2 * M * K * N)
        row.update(ms=time_ms(lambda: quant_matmul(x, v, sc, scheme), flush),
                   first_design_ms=time_ms(
                       lambda: quant_matmul(x, v, sc, scheme, design="general"), flush),
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


def unaligned_copy(x):
    """``x``'s values in a view one element into its buffer: a base TMA
    cannot read, so the shape predicates give it the first design."""
    xm = torch.empty(x.numel() + 8, dtype=x.dtype, device=x.device)[1:1 + x.numel()]
    xm = xm.view(x.shape)
    xm.copy_(x)
    return xm


def quant_designs():
    from deepspeed_tpu_torch.ops.kernels import grouped_matmul as gm
    return dict(gm.gmm_quant_design_launches)


def quant_grew(before):
    return {k: v - before[k] for k, v in quant_designs().items()}


def grouped_cases(device, flush):
    """gmm (bf16) and gmm_quant (int8, fp8, fp6) at Mixtral's expert
    shapes over four routings; each ``gmm_quant`` case on the design its
    predicate names (counted), beside the first design at x's unaligned
    base (the same values), and the bits of one row between the decode
    design at 16-row tiles and the forward ring at 64. → {"gmm": rows,
    "gmm_quant": rows, "tile_invariance": readings}."""
    from deepspeed_tpu_torch.ops.kernels import grouped_matmul as gm
    from deepspeed_tpu_torch.ops.kernels.flash_attention import row_scaled_err
    from deepspeed_tpu_torch.ops.kernels.fused_quant_matmul import dequantize_grouped, row_tile
    out = {"gmm": [], "gmm_quant": [], "tile_invariance": []}
    for si, (wname, (K, N)) in enumerate(zip(("w1", "w2"), MLP_SHAPES)):
        for scheme in ("bf16", "int8", "fp8", "fp6"):
            _, q = quant_inputs(200 + si, 1, (8, K, N), scheme, device)
            quant = scheme != "bf16"
            w_bf16 = (dequantize_grouped(q.values, q.scales, scheme, torch.bfloat16) if quant
                      else q)
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

            def design_of(xp, tm):
                ptrs = xp.data_ptr(), (q.values if quant else q).data_ptr()
                return gm.quant_design(scheme, tm, K, N, *ptrs) if quant else \
                    gm.wgmma_design(tm, K, N, *ptrs)

            def checked_run(xp, te, tm, used, name):
                """One launch, on the design the predicate names where the
                launches are counted by design (carriers) → (out, design)."""
                design, before = design_of(xp, tm), quant_designs()
                got = run(xp, te, tm, used)
                if quant and quant_grew(before) != {d: int(d == design) for d in before}:
                    raise AssertionError(f"{name}: launches by design {quant_grew(before)}, want "
                                         f"one on {design}")
                return got, design

            # (a) expert 5 takes one-hot rows over all of K: exact decode, at
            # both row tiles (carriers: the forward ring, the decode design)
            sizes = torch.zeros(8, dtype=torch.int64, device=device)
            sizes[5] = K
            for tm in ((16, 64) if quant else (64,)):
                dst, te, Mp = gm.pad_groups_to_tiles(sizes, K, tm)
                xp = torch.zeros((Mp, K), dtype=torch.bfloat16, device=device)
                xp[dst.long()] = torch.eye(K, device=device, dtype=torch.bfloat16)
                got, _ = checked_run(xp, te, tm, gm.used_tiles(sizes, tm),
                                     f"{key} {scheme} {wname} one-hot tm {tm}")
                if not torch.equal(got[:K], w_bf16[5]) or got[K:].any():
                    raise AssertionError(f"{key} {scheme} {wname} tm {tm}: one-hot rows do not "
                                         f"reproduce the expert's weight exactly")
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
                got, design = checked_run(xp, te, tm, used, name)
                again, _ = checked_run(xp, te, tm, used, name)
                want = plain(xp, te, tm, used)
                torch.cuda.synchronize()
                if not torch.isfinite(got.float()).all():
                    raise AssertionError(f"{name}: non-finite kernel output")
                if quant and (not torch.equal(got, again) or got[int(used) * tm:].any()):
                    raise AssertionError(f"{name}: two runs differ, or rows past the used "
                                         f"tiles are not zero")
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
                       "experts_touched": len(touched), "design": design,
                       "max_abs_err": max_abs(got, want), "row_err": err,
                       "zeroed_expert_row_err": zerr, "one_hot_exact": True,
                       "ms": time_ms(lambda: run(xp, te, tm, used), flush),
                       "plain_ms": time_ms(lambda: plain(xp, te, tm, used), flush, iters=5),
                       "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
                       "flops": 2 * n * K * N}
                row.update(grouped_library(xs, w_bf16, sizes, flush))
                if quant:  # dequantize the stack, then the bf16 grouped kernel
                    row["deterministic"] = True
                    row["unfused_ms"] = time_ms(lambda: gm.gmm(
                        xp, dequantize_grouped(q.values, q.scales, scheme, torch.bfloat16), te,
                        tm, used), flush, iters=5)
                    if case in ("decode", "prefill"):  # the first design on the same values
                        xm = unaligned_copy(xp)
                        first, fd = checked_run(xm, te, tm, used, f"{name} unaligned")
                        ferr = row_scaled_err(first, want.float())
                        if fd != "general" or ferr > QUANT_TOL:
                            raise AssertionError(f"{name} unaligned: {fd} design, "
                                                 f"row_scaled_err {ferr}")
                        row.update(first_design_ms=time_ms(lambda: run(xm, te, tm, used), flush),
                                   first_design_row_err=ferr)
                        del xm, first
                log(f"[grouped-kernels] {key} {json.dumps(row)}")
                out[key].append(row)
                del xs, xp, got, again, want, zeroed
            if quant:
                out["tile_invariance"].append(tile_invariance_reading(q, scheme, wname, K,
                                                                      device))
            del q, w_bf16
            torch.cuda.empty_cache()
    return out


def tile_invariance_reading(q, scheme, wname, K, device):
    """A reading, not a gate: phase 9's decode rows (16 rows, 8 tokens
    top-2) through ``gmm_quant`` at 16-row tiles (the decode design) and at
    64-row tiles (the forward ring): do a row's bits match? → row."""
    from deepspeed_tpu_torch.ops.kernels import grouped_matmul as gm
    sizes = routing_sizes("decode", device)
    n = int(sizes.sum())
    g = torch.Generator(device=device).manual_seed(7)
    xs = torch.randn(n, K, generator=g, device=device).to(torch.bfloat16)
    rows, designs = {}, {}
    for tm in (16, 64):
        dst, te, Mp = gm.pad_groups_to_tiles(sizes, n, tm)
        xp = torch.zeros((Mp, K), dtype=torch.bfloat16, device=device)
        xp[dst.long()] = xs
        designs[tm] = gm.quant_design(scheme, tm, K, carrier_n(q, scheme), xp.data_ptr(),
                                      q.values.data_ptr())
        rows[tm] = gm.gmm_quant(xp, q.values, q.scales, te, scheme, torch.bfloat16, tm,
                                gm.used_tiles(sizes, tm))[dst.long()]
    same = (rows[16] == rows[64]).all(-1)
    row = {"case": f"{scheme}_{wname}_tile_invariance", "scheme": scheme, "weight": wname,
           "designs": {str(t): d for t, d in designs.items()},
           "row0_bits_equal": bool(same[0]), "rows_bits_equal": int(same.sum()), "rows": n,
           "max_abs_diff": max_abs(rows[16], rows[64])}
    log(f"[grouped-kernels] invariance reading (not a gate): {json.dumps(row)}")
    return row


def carrier_n(q, scheme):
    """The output columns of a carrier stack ``q``."""
    return q.values.shape[-1] * 4 // 3 if scheme == "fp6" else q.values.shape[-1]


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
def routing(record, replay, mr=None):
    """Record each MoE layer's top-k experts (``replay`` False), or make
    the router take the recorded ones, in call order, with its own gate
    values at those experts (``replay`` True). Yields a one-element list
    that counts the tokens whose own top-k set differed from the recorded
    one: near-ties that the two runs' bf16 roundings break differently.
    ``mr``: the module whose ``top_k`` the router calls (the serving
    runner when None; ``moe.sharded_moe`` for training)."""
    if mr is None:
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
            before, qd = {k: f.launches for k, f in counters.items()}, quant_designs()
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
            by_design = quant_grew(qd)
            if by_design["general"] or sum(by_design.values()) != want["gmm_quant"]:
                raise AssertionError(f"moe parity {mode} {pin}: gmm_quant by design {by_design}")
            if pin == "kernels":
                quant_by_design = by_design
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
                     "router_rows": sum(int(r.shape[0]) for r in record),
                     "gmm_quant_designs": quant_by_design}
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
    designs = gemm_designs()
    k4_inst = "dense" if mode == "none" else "quant"  # the attention projections and the head
    forwards, restore = forward_split(engine, {"gmm_quant": quant_designs,
                                               "k4": lambda: k4_designs(k4_inst)})
    kd0 = serving_designs()
    t0 = time.perf_counter()
    streams, steps = run_requests(engine, MOE_N_REQ, MOE_PROMPT, MOE_NEW, 0, MOE_BUDGET,
                                  MOE_BURST)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    restore()
    kd = designs_since(tag, kd0)
    launches = {k: f.launches for k, f in counters.items()}
    # bf16 experts: prefill's 64-row tiles take the wgmma forward, decode's 16 the first design
    fwd_designs = {k: v - designs["fwd"][k] for k, v in gemm_designs()["fwd"].items()}
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
                  launches=launches, launches_per_forward=per, gmm_fwd_designs=fwd_designs,
                  forward_split=split_forwards(forwards, per["gmm_quant"], tag),
                  k4_forwards=k4_split_forwards(forwards, "k4", 4 * L + 1, f"{tag} K4"),
                  peak_memory_gb=peak / 1e9, card_memory_gb=card / 1e9)
    log(f"[{tag}] {json.dumps(result)}")
    log(f"[{tag}] request 0 first tokens: {streams[0][:8]}")
    result["profile"] = profile_steps(engine, traffic)
    result["designs"] = dict(kd, device_ms=kernel_ms(result["profile"], tag))
    result["k4_device"] = k4_share(result["profile"], "dense_matmul (K4's bf16 instance)"
                                   if mode == "none" else "quant_matmul (K4)", tag)
    engine.destroy()
    del engine
    torch.cuda.empty_cache()
    return result, launches


def forward_split(engine, counters=None):
    """Time each ragged forward of ``engine`` on the card (CUDA events
    around it, no host sync) and record the launches by design it made of
    each of ``counters`` (name → launches by design so far; ``gmm_quant``'s
    by default) and whether a decode burst ran it. → (records, restore)."""
    counters = counters or {"gmm_quant": quant_designs}
    records, state = [], {"burst": False}
    fwd, burst = engine._forward, engine.decode_burst

    def timed(batch):
        before = {k: f() for k, f in counters.items()}
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = fwd(batch)
        ev[1].record()
        grew = {k: {d: v - before[k][d] for d, v in f().items()} for k, f in counters.items()}
        records.append((ev, grew, state["burst"]))
        return out

    def in_burst(*args, **kwargs):
        state["burst"] = True
        try:
            return burst(*args, **kwargs)
        finally:
            state["burst"] = False

    def restore():  # the engine's own forward back: the DS_SANITIZE gate's result
        engine._forward = fwd
        del engine.decode_burst

    engine._forward, engine.decode_burst = timed, in_burst
    return records, restore


def split_forwards(records, per_forward, tag):
    """Each forward's ``gmm_quant`` launches on one design (``per_forward``
    of them; none on the first design where TMA reads every operand),
    decode bursts' all on the decode design; → ms per forward on the card
    for decode forwards (16-row tiles: the decode design) and prefill or
    mixed ones (64-row tiles: the forward ring)."""
    torch.cuda.synchronize()
    out = {}
    for ev, grews, in_burst in records:
        grew = grews["gmm_quant"]
        on = [d for d, v in grew.items() if v]
        if per_forward and (len(on) != 1 or grew[on[0]] != per_forward or on == ["general"]
                            or (in_burst and on != ["stream"])):
            raise AssertionError(f"{tag}: a forward's gmm_quant launches by design {grew} "
                                 f"(decode burst: {in_burst}), want {per_forward} on one "
                                 f"Hopper design")
        kind = "decode" if on == ["stream"] else "prefill" if on == ["wgmma"] else "dense"
        k = out.setdefault(kind, {"forwards": 0, "in_bursts": 0, "ms": 0.0})
        k["forwards"] += 1
        k["in_bursts"] += int(in_burst)
        k["ms"] += ev[0].elapsed_time(ev[1])
    for k in out.values():
        k["ms_per_forward"] = k["ms"] / k["forwards"]
    log(f"[{tag}] forwards by gmm_quant design (CUDA events around each forward): "
        f"{json.dumps(out)}")
    return out


def k4_split_forwards(records, name, per_forward, tag):
    """Each forward's K4 launches (``records``' counter ``name``):
    ``per_forward`` of them, none on the first design; a decode burst's
    all on the decode design; any other forward's projections all on one
    design by its token count (the head, at the sequences' last tokens,
    may take the decode design beside the prefill design). → launches by
    design and ms per forward on the card, by kind of forward ("prefill":
    one with prefill-design launches; "decode")."""
    torch.cuda.synchronize()
    out = {}
    for ev, grews, in_burst in records:
        grew = grews[name]
        wg, st = grew["wgmma"], grew["stream"]
        if sum(grew.values()) != per_forward or grew["general"] or \
                (in_burst and st != per_forward) or wg not in (0, per_forward - 1, per_forward):
            raise AssertionError(f"{tag}: a forward's K4 launches by design {grew} (decode "
                                 f"burst: {in_burst}), want {per_forward}: the projections on "
                                 f"one Hopper design, a decode burst's on the decode design")
        k = out.setdefault("prefill" if wg else "decode",
                           {"forwards": 0, "in_bursts": 0, "ms": 0.0, "stream": 0, "wgmma": 0})
        k["forwards"] += 1
        k["in_bursts"] += int(in_burst)
        k["ms"] += ev[0].elapsed_time(ev[1])
        k["stream"] += st
        k["wgmma"] += wg
    for k in out.values():
        k["ms_per_forward"] = k["ms"] / k["forwards"]
    log(f"[{tag}] forwards by K4 design (CUDA events around each forward): {json.dumps(out)}")
    return out


def k4_share(profile, category, tag):
    """K4's device ms and share of the device time in each profiled step."""
    out = {kind: {"k4_ms": p["by_category_ms"].get(category, 0.0), "device_ms": p["device_ms"],
                  "forwards": p["forwards"],
                  "k4_share": p["by_category_ms"].get(category, 0.0) / p["device_ms"]
                  if p["device_ms"] else None}
           for kind, p in profile.items()}
    log(f"[{tag}] K4 ({category}) in the profiled steps: {json.dumps(out)}")
    return out


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
                                                             lora_design, lora_design_launches,
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
        zeros = torch.zeros_like(y)
        design = lora_design(x.dtype, K, N, r, x.data_ptr(), zeros.data_ptr(), a.data_ptr(),
                             b.data_ptr(), x.stride(0), zeros.stride(0))
        before = dict(lora_design_launches)
        got = lora_delta(x, zeros, a, b, sc, lay)
        grew = {d: lora_design_launches[d] - before[d] for d in before}
        fused = lora_delta(x, y.clone(), a, b, sc, lay)
        first = lora_delta(x, torch.zeros_like(y), a, b, sc, lay, design="general")
        want = lora_delta_ref(x, s, a, b, sc)
        torch.cuda.synchronize()
        if grew != {d: int(d == design) for d in grew} or (offset == 0 and design != "mma"):
            raise AssertionError(f"lora case {name}: launches by design {grew}, want one on "
                                 f"{design} (the mma design at an aligned x)")
        if not torch.isfinite(got.float()).all():
            raise AssertionError(f"lora case {name}: non-finite kernel output")
        base, row = s == 0, {"case": name, "T": T, "K": K, "N": N, "rank_bucket": r,
                             "true_rank": true_rank or r, "slots": kind, "design": design}
        if not torch.equal(fused[base], y[base]) or got[base].any():  # (d)
            raise AssertionError(f"lora case {name}: base rows are not the base projection")
        if not torch.equal(fused, (y.float() + got.float()).to(y.dtype)):
            raise AssertionError(f"lora case {name}: the fused add is not round(y + delta)")
        if kind != "base":
            err = row_scaled_err(got[~base], want[~base].float())             # (a)
            zeroed = got.clone()
            zeroed[s == int(s[0])] = 0
            zerr = row_scaled_err(zeroed[~base], want[~base].float())         # (b)
            ferr = row_scaled_err(first[~base], want[~base].float())
            if err > LORA_TOL or zerr <= LORA_TOL or ferr > LORA_TOL:
                raise AssertionError(f"lora case {name}: row_scaled_err {err} (first design "
                                     f"{ferr}; limit {LORA_TOL}), zeroed slot {zerr} (must "
                                     f"exceed it)")
            row["first_design_row_err"] = ferr
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
                   first_design_ms=time_ms(lambda: lora_delta(x, yt, a, b, sc, lay,
                                                              design="general"), flush),
                   plain_ms=time_ms(lambda: y + lora_delta_ref(x, s, a, b, sc), flush),
                   layout_ms=time_ms(lambda: lora_layout(s, a.shape[0]), flush),
                   bound_ms=b_ms, bound_by=b_by, bytes=nbytes, flops=flops,
                   **lora_library(x, s, a, b, flush))
        log(f"[lora-kernels] {json.dumps(row)}")
        rows.append(row)
        del x, y, a, b, sc, s, got, fused, first, want, yt
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
        kd0 = serving_designs()
        with plain_lora() if run == "plain" else contextlib.nullcontext():
            first = engine.put([0, 1, 2], toks[:3])
            mixed = engine.put([0, 1, 3, 2], [[11], [12], toks[3], toks[4]])
        torch.cuda.synchronize()
        designs_since(f"lora-parity {run}", kd0)
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
    cfg = llama_config("mistral-7b", num_hidden_layers=LORA_SERVING_LAYERS)
    L, V = cfg.num_hidden_layers, cfg.vocab_size
    t0 = time.perf_counter()
    engine = lora_engine(cfg, device, BUDGET, N_REQ, PROMPT + NEW, prefetch=True)
    store = engine.lora_store
    torch.cuda.synchronize()
    log(f"[lora-serving] mistral-7b at {L} layers + {LORA_N_ADAPTERS} adapters (rank "
        f"{LORA_RANK}, alpha {LORA_ALPHA}): built in {time.perf_counter() - t0:.2f} s, hot slabs "
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
    kd0 = serving_designs()
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
    kd = designs_since("lora-serving", kd0)
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
        f"(other token buckets) identical: {solo}")
    if not all(solo):
        raise AssertionError(f"lora isolation: a request alone differs from its mixed-trace "
                             f"stream ({solo})")

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
    result["designs"] = dict(kd, device_ms=kernel_ms(result["profile"], "lora-serving"))
    engine.destroy()
    del engine
    torch.cuda.empty_cache()
    return result, samples["mixed"][0]["k6_launches"]


# ---------------------------------------------------------------- phase 16
def k7_bound(n_values, in_bytes, out_bytes, groups):
    """Least time for a K7 call: each value read once and written once,
    plus one fp32 scale a group, over the card's memory rate."""
    nbytes = n_values * (in_bytes + out_bytes) + 4 * groups
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes", nbytes


def k7_cases(device, flush):
    """K7 at the tier's shapes: one of k or v of n Mistral-7B blocks,
    [32, n, 32, 8, 128], groups of one (layer, block) slab and of 2048,
    bf16 and fp32 input, and stochastic rounding; n = 2 is what a demotion
    of the tier lane quantizes, n = 12 what its promotion dequantizes. Kernel and plain version
    must agree bit for bit (values, scales, dequantized output), and the
    comparison must see one flipped code. → rows."""
    from deepspeed_tpu_torch.ops.kernels import quantization as tq
    slab = BS * HKV * DH
    cases = [(f"{'slab' if gs == slab else 'g' + str(gs)}_{name}_n{n}", n, gs, dt, False)
             for n in (1, 2, 16) for gs in (slab, K7_GROUP)
             for name, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32))]
    cases += [("slab_bf16_n12", 12, slab, torch.bfloat16, False),
              ("slab_bf16_n16_stochastic", 16, slab, torch.bfloat16, True)]
    rows = []
    for i, (name, n, gs, dtype, stochastic) in enumerate(cases):
        g = torch.Generator(device=device).manual_seed(300 + i)
        x = (torch.randn((K7_LAYERS, n, BS, HKV, DH), generator=g, device=device) * 2).to(dtype)
        x[:, :, :, 0] = 0  # a zero head in every slab
        groups = x.reshape(-1, gs)
        design = tq.k7_design(gs, dtype, groups.shape[0], tq.sm_count(device))
        before = dict(tq.k7_design_launches)
        v, s, shape = tq.quantize_int8(x, gs, stochastic=stochastic, seed=i)
        fv, fs, _ = tq.quantize_int8(x, gs, stochastic=stochastic, seed=i, design="two_pass")
        rv, rs = tq.quantize_int8_ref(groups, stochastic, i)
        deq = tq.dequantize_int8(v, s, shape, dtype=torch.bfloat16)
        rdeq = tq.dequantize_int8_ref(rv, rs, torch.bfloat16).reshape(shape)
        torch.cuda.synchronize()
        flipped = v.clone()
        flipped.view(-1)[v.numel() // 3] ^= 1
        same = (torch.equal(v, rv), torch.equal(s.view(torch.int32), rs.view(torch.int32)),
                torch.equal(deq, rdeq), torch.equal(fv, rv),
                torch.equal(fs.view(torch.int32), rs.view(torch.int32)))
        grew = {d: c - before[d] for d, c in tq.k7_design_launches.items()}
        if not all(same) or torch.equal(flipped, rv):
            raise AssertionError(f"k7 case {name}: values/scales/dequant/first design's values "
                                 f"and scales bitwise {same}, flipped code caught "
                                 f"{not torch.equal(flipped, rv)}")
        if grew != {d: (d == design) + (d == "two_pass") for d in grew}:
            raise AssertionError(f"k7 case {name}: quantize launches by design {grew}, want one "
                                 f"on {design} and one on two_pass")
        if stochastic:  # every code is the floor or the ceiling of x / scale
            scaled = groups.float() / s[:, None]
            q = v.float()
            if not bool(((q == scaled.floor().clamp(-127, 127)) |
                         (q == scaled.ceil().clamp(-127, 127))).all()):
                raise AssertionError(f"k7 case {name}: a code is neither floor nor ceil")
        N, G, eb = x.numel(), groups.shape[0], x.element_size()
        qb_ms, qb_by, qbytes = k7_bound(N, eb, 1, G)
        db_ms, db_by, dbytes = k7_bound(N, 1, 2, G)
        quant = functools.partial(tq.quantize_int8, x, gs, stochastic=stochastic)
        first = functools.partial(quant, design="two_pass")
        row = {"case": name, "blocks": n, "group": gs, "dtype": str(dtype).split(".")[-1],
               "stochastic": stochastic, "values": N, "groups": G, "design": design,
               "bitwise": True, "first_design_bitwise": True, "flipped_code_caught": True,
               "quant_max_abs_err": max(max_abs(v, rv), max_abs(s, rs)),
               "max_abs_err": max_abs(deq, rdeq),
               "ms": time_ms(quant, flush), "profiled_us": profiled_us(quant, flush, "quant"),
               "first_design_ms": time_ms(first, flush),
               "first_design_profiled_us": profiled_us(first, flush, "quant"),
               "plain_ms": time_ms(lambda: tq.quantize_int8_ref(groups, stochastic), flush),
               "bound_ms": qb_ms, "bound_by": qb_by, "bytes": qbytes, "library_ms": None,
               "dequant_ms": time_ms(lambda: tq.dequantize_int8(v, s, shape), flush),
               "dequant_plain_ms": time_ms(lambda: tq.dequantize_int8_ref(v, s), flush),
               "dequant_bound_ms": db_ms, "dequant_bytes": dbytes}
        log(f"[k7-kernels] {json.dumps(row)}")
        rows.append(row)
        del x, v, s, fv, fs, groups, rv, rs, deq, rdeq, flipped
    torch.cuda.empty_cache()
    return rows


def empty_host_cache():
    """Give the caching host allocator's free pinned blocks back (torch
    builds name it differently); → whether one was found."""
    for name in ("_host_emptyCache", "_accelerator_emptyHostCache"):
        if hasattr(torch._C, name):
            getattr(torch._C, name)()
            return True
    return False


def host_pinned_stats():
    """The caching host allocator's byte counters (pinned memory it owns,
    cached blocks included, and what callers hold), where this torch has
    them: a record of n bytes locks its power-of-two rounding."""
    stats = getattr(torch.cuda, "host_memory_stats", lambda: {})()
    return {k: v for k, v in stats.items()
            if k.split(".")[0] in ("allocated_bytes", "active_bytes", "allocations")
            and k.split(".")[-1] in ("current", "peak")} | \
        {k: stats[k] for k in ("num_host_alloc", "host_alloc_time.avg", "host_alloc_time.total")
         if k in stats}


def host_copy_readings(device):
    """Device→host copy of a demoted handle's k (1, 2 and 16 Mistral-7B
    blocks, bf16): into pageable memory, into freshly pinned memory (the
    pinning included, the host allocator's cache emptied first) and into
    pinned memory the allocator has cached, which is what the tier's copies
    (``kv_cache.to_host``) get once the store has turned over. → readings."""
    out = {"host_cache_emptied": empty_host_cache()}
    for n in (1, 2, 16):
        x = torch.randn((32, n, BS, HKV, DH), device=device).to(torch.bfloat16)
        ms = {"pageable": [], "pinned_fresh": [], "pinned_cached": []}

        def pinned():
            torch.empty(x.shape, dtype=x.dtype, pin_memory=True).copy_(x, non_blocking=True)
            torch.cuda.synchronize()
        for _ in range(2):
            for kind, fn in (("pageable", x.cpu), ("pinned_fresh", pinned),
                             ("pinned_cached", pinned)):
                if kind == "pinned_fresh":
                    empty_host_cache()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                ms[kind].append((time.perf_counter() - t0) * 1e3)
        out[f"n{n}"] = {"bytes": x.numel() * 2, **{f"{k}_ms": min(v) for k, v in ms.items()}}
        out[f"n{n}"]["pageable_gb_per_s"] = x.numel() * 2 / min(ms["pageable"]) / 1e6
        out[f"n{n}"]["pinned_cached_gb_per_s"] = x.numel() * 2 / min(ms["pinned_cached"]) / 1e6
        del x
    log(f"[kv-tier] host copy of one handle's k: {json.dumps(out)}")
    return out


# ---------------------------------------------------------------- phase 17
@contextlib.contextmanager
def plain_k7():
    """Pin K7's launchers to the plain versions (no launch counted)."""
    from deepspeed_tpu_torch.ops.kernels import quantization as tq
    saved = tq._quant_kernel, tq._dequant_kernel

    def dequant(values, scales, out, rows):
        deq = tq.dequantize_int8_ref(values, scales, out.dtype)
        if rows is None:
            out.copy_(deq)
        else:
            out[rows.long()] = deq
    tq._quant_kernel = lambda groups, stochastic, seed, design=None: tq.quantize_int8_ref(
        groups, stochastic, seed)
    tq._dequant_kernel = dequant
    try:
        yield
    finally:
        tq._quant_kernel, tq._dequant_kernel = saved


def tier_engine(cfg, device, params, mode, num_kv_blocks=TIER_KV_BLOCKS, prefetch=True):
    """A Mistral-7B-width engine under the tier lane's sizing: prefix cache
    on; ``mode`` "off" (no tier), "bf16" or "int8" tier storage; the tier's
    prefetch worker on unless ``prefetch`` is false."""
    from deepspeed_tpu_torch.inference.v2 import (DSStateManagerConfig, InferenceEngineV2,
                                                  KVTierConfig, PrefixCacheConfig,
                                                  RaggedInferenceEngineConfig)
    ecfg = RaggedInferenceEngineConfig(
        kv_block_size=BS, num_kv_blocks=num_kv_blocks,
        prefix_cache=PrefixCacheConfig(enabled=True),
        kv_tier=KVTierConfig(enabled=mode != "off", host_bytes=TIER_HOST_BYTES,
                             quantize=mode == "int8", prefetch=prefetch),
        state_manager=DSStateManagerConfig(max_ragged_batch_size=TIER_BUDGET,
                                           max_ragged_sequence_count=TIER_N_REQ,
                                           max_tracked_sequences=TIER_N_REQ + 1,
                                           max_context=TIER_PROMPT + TIER_NEW))
    return InferenceEngineV2(cfg, ecfg, params=params, device=device)


def tier_traffic(vocab):
    """``bench_serving_2b_kv_tier``'s three phases: A shares a system
    prompt, B is disjoint, A' returns with new suffixes."""
    rng = np.random.RandomState(0)
    system = rng.randint(0, vocab, size=TIER_SYS).astype(np.int32)
    suffixes = [rng.randint(0, vocab, size=TIER_SFX).astype(np.int32)
                for _ in range(2 * TIER_N_REQ)]
    disjoint = [rng.randint(0, vocab, size=TIER_PROMPT).astype(np.int32)
                for _ in range(TIER_N_REQ)]
    return system, {"A": [np.concatenate([system, s]) for s in suffixes[:TIER_N_REQ]],
                    "B": disjoint,
                    "A'": [np.concatenate([system, s]) for s in suffixes[TIER_N_REQ:]]}


def tier_fleet(engine, uid0, prompts, new=None):
    """One scheduler run → (streams, seconds, prefix-cached tokens, forwards)."""
    from deepspeed_tpu_torch.inference.v2 import DynamicSplitFuseScheduler
    sched = DynamicSplitFuseScheduler(engine, token_budget=TIER_BUDGET, max_burst=TIER_BURST)
    for i, p in enumerate(prompts):
        sched.add_request(uid0 + i, p, max_new_tokens=new or TIER_NEW)
    f0 = engine.forward_steps
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = sched.run_to_completion()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    cached = sum(sched.requests[uid0 + i].prefix_cached_tokens for i in range(len(prompts)))
    return [list(out[uid0 + i]) for i in range(len(prompts))], dt, cached, \
        engine.forward_steps - f0


def device_ids(blocks, device):
    """Block ids as a device tensor without a host sync (from pinned memory;
    ``torch.tensor(..., device=)`` waits for the stream)."""
    return torch.tensor(blocks, dtype=torch.int64).pin_memory().to(device, non_blocking=True)


class TierProbe:
    """Instruments one engine's tier with no host sync of its own: each
    demotion's victims' KV is copied on the device (by chained identity)
    before it leaves the pool, each promotion's restored blocks are copied
    on the device after it, and :meth:`readings` holds the two against each
    other after the run. Times each demotion (host clock: it ends in the
    device→host copy) and each promotion (CUDA events on the serving stream,
    read at the end, and the host clock: the whole of it, the restore alone,
    and the demotions that made room in it, host clock; the rest is the
    claims and the host→device copies), tracks the store's peak bytes, and
    counts its own host time (``probe_host_ms``), which the engine's tokens/s
    include."""

    def __init__(self, engine):
        self.engine, self.tier, self.cache = engine, engine.kv_tier, engine.kv_cache
        self.snap, self.pending, self.checks = {}, [], []
        self.demote_ms, self.demote_bytes, self.promotions = [], [], []
        self.store_peak, self.own_s, self._start, self._evict_ms = 0, 0.0, None, 0.0
        pc = engine.prefix_cache
        demote, claim, unclaim = self.tier.demote, self.tier.claim, self.tier.unclaim
        restore, promote = self.cache.restore, pc._promote_tier_hits_locked

        def p_demote(victims):
            t0 = time.perf_counter()
            if victims:
                ids = device_ids([b for _, _, b in victims], self.cache.device)
                k, v = self.cache.k.index_select(1, ids), self.cache.v.index_select(1, ids)
                for i, (pk, toks, _) in enumerate(victims):
                    self.snap[(pk, tuple(toks))] = (k[:, i], v[:, i])
            bytes0 = self.tier.store.stats()["bytes_resident"]
            t1 = time.perf_counter()
            demote(victims)
            t2 = time.perf_counter()
            if victims:
                self.demote_ms.append((t2 - t1) * 1e3)
                if self._start is not None:
                    self._evict_ms += (t2 - t1) * 1e3
                resident = self.tier.store.stats()["bytes_resident"]
                self.demote_bytes.append(resident - bytes0)
                self.store_peak = max(self.store_peak, resident)
            self.own_s += (t1 - t0) + (time.perf_counter() - t2)

        def p_claim(parent_key, tokens):
            item = claim(parent_key, tokens)
            if item is not None:
                self.pending.append((parent_key, tuple(int(t) for t in tokens)))
            return item

        def p_unclaim(item):
            rec = item["record"]
            self.pending.remove((rec["parent_key"], tuple(rec["tokens"])))
            return unclaim(item)

        def p_promote(prompt_tokens, max_blocks):
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            self._start, self._evict_ms = (start, time.perf_counter()), 0.0
            try:
                return promote(prompt_tokens, max_blocks)
            finally:
                self._start = None

        def p_restore(handle):
            if self._start is None:  # a resume, not a promotion
                return restore(handle)
            mid, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            mid.record()
            blocks = restore(handle)
            end.record()
            t0 = time.perf_counter()
            start, h0 = self._start
            nbytes = sum(handle[n].nbytes for n in ("k", "v", "k_scales", "v_scales")
                         if n in handle)
            self.promotions.append((start, mid, end, (t0 - h0) * 1e3, self._evict_ms, nbytes,
                                    len(blocks)))
            ids = device_ids(blocks, self.cache.device)
            k, v = self.cache.k.index_select(1, ids), self.cache.v.index_select(1, ids)
            self.checks += [(key, k[:, i], v[:, i]) for i, key in enumerate(self.pending)]
            self.pending = []
            self.own_s += time.perf_counter() - t0
            return blocks

        self.tier.demote, self.tier.claim, self.tier.unclaim = p_demote, p_claim, p_unclaim
        self.cache.restore, pc._promote_tier_hits_locked = p_restore, p_promote

    def readings(self):
        torch.cuda.synchronize()
        p_ms = [s.elapsed_time(e) for s, _, e, *_ in self.promotions]
        err = max((max(max_abs(k, self.snap[key][0]), max_abs(v, self.snap[key][1]))
                   for key, k, v in self.checks), default=0.0)
        out = {"demotions": len(self.demote_ms), "promotions": len(self.promotions),
               "demote_ms_mean": float(np.mean(self.demote_ms)) if self.demote_ms else None,
               "demote_d2h_bytes_mean": float(np.mean(self.demote_bytes))
               if self.demote_bytes else None,
               "blocks_per_demotion": len(self.snap) / max(len(self.demote_ms), 1),
               "store_bytes_peak": self.store_peak,
               "promote_ms": p_ms, "promote_host_ms": [p[3] for p in self.promotions],
               "promote_restore_ms": [m.elapsed_time(e) for _, m, e, *_ in self.promotions],
               "promote_evict_host_ms": [p[4] for p in self.promotions],
               "promote_bytes": [p[5] for p in self.promotions],
               "promote_blocks": [p[6] for p in self.promotions],
               "promoted_blocks_checked": len(self.checks),
               "promoted_vs_demoted_max_abs": err, "probe_host_ms": self.own_s * 1e3}
        self.snap, self.checks = {}, []
        return out


def tier_trace(engine, traffic, uid0=0):
    """The three phases on ``engine`` → per-phase readings and streams."""
    out = {}
    for j, (phase, prompts) in enumerate(traffic.items()):
        streams, dt, cached, fwd = tier_fleet(engine, uid0 + 100 * j, prompts)
        for i, t in enumerate(streams):
            if len(t) != TIER_NEW or not all(0 <= v < engine.model_config.vocab_size
                                             for v in t):
                raise AssertionError(f"tier trace {phase}: request {i}: {len(t)} tokens")
        out[phase] = {"streams": streams, "time_s": dt, "forward_steps": fwd,
                      "prefix_cached_tokens": cached,
                      "gen_tokens_per_sec": len(prompts) * TIER_NEW / dt}
    return out


def tier_parity_phase(device):
    """An int8-tier engine at Mistral-7B width, 2 layers, under the tier
    lane's trace through K7 and with K7 pinned to its plain versions:
    streams, prefix hits and a probe's logits bitwise; each demotion
    launches 2 quantize and 2 dequantize kernels, each quantized restore
    2 dequantize kernels."""
    from deepspeed_tpu_torch.models import init_params, llama_config
    from deepspeed_tpu_torch.ops.kernels import quantization as tq
    cfg = llama_config("mistral-7b", num_hidden_layers=2)
    params = init_params(cfg, device, torch.bfloat16,
                         torch.Generator(device=device).manual_seed(5))
    system, traffic = tier_traffic(cfg.vocab_size)
    probe = np.concatenate([system, np.arange(7, 7 + TIER_SFX, dtype=np.int32)])
    results = {}
    for pin in ("kernel", "plain"):
        engine = tier_engine(cfg, device, params, "int8", prefetch=False)
        probe_obj = TierProbe(engine)
        tq.quantize_int8.launches = tq.dequantize_int8.launches = 0
        with plain_k7() if pin == "plain" else contextlib.nullcontext():
            trace = tier_trace(engine, traffic)
            got = engine.prefix_match(999, probe)
            logits = engine.put([999], [probe[got:]])
            engine.flush(999)
        torch.cuda.synchronize()
        r = probe_obj.readings()
        launched = (tq.quantize_int8.launches, tq.dequantize_int8.launches)
        want = (0, 0) if pin == "plain" else (2 * r["demotions"],
                                              2 * r["demotions"] + 2 * r["promotions"])
        if launched != want or r["demotions"] == 0 or r["promotions"] == 0:
            raise AssertionError(f"tier parity {pin}: launches {launched}, want {want} "
                                 f"({r['demotions']} demotions, {r['promotions']} promotions)")
        results[pin] = (trace, logits, engine.kv_tier.stats(), r)
        engine.destroy()
    (tk, lk, sk, rk), (tp, lp, sp, _) = results["kernel"], results["plain"]
    for phase in tk:
        if tk[phase]["streams"] != tp[phase]["streams"] or \
                tk[phase]["prefix_cached_tokens"] != tp[phase]["prefix_cached_tokens"]:
            raise AssertionError(f"tier parity: phase {phase} differs, kernel vs plain")
    if not np.array_equal(lk, lp) or sk["quant_error_max"] != sp["quant_error_max"]:
        raise AssertionError("tier parity: probe logits or quant_error_max differ")
    result = {"layers": 2, "demotions": rk["demotions"], "promotions": rk["promotions"],
              "quantize_launches_per_demotion": 2, "dequantize_launches_per_demotion": 2,
              "dequantize_launches_per_promotion": 2, "quant_error_max": sk["quant_error_max"],
              "streams_bitwise": True, "logits_bitwise": True,
              "promoted_vs_demoted_max_abs": rk["promoted_vs_demoted_max_abs"]}
    log(f"[tier-parity] 2-layer mistral-7b width, int8 tier: {json.dumps(result)}")
    del params
    torch.cuda.empty_cache()
    return result


# ---------------------------------------------------------------- phase 18
def prefix_lane(cfg, device, params):
    """``bench_serving_2b_prefix``: 8 requests share a 512-token system
    prompt + 32-token suffixes; a cold fleet fills the trie, a warm fleet
    on the same engine leases it."""
    from deepspeed_tpu_torch.inference.v2 import (DSStateManagerConfig, InferenceEngineV2,
                                                  PrefixCacheConfig, RaggedInferenceEngineConfig)
    plen = PFX_SYS + PFX_SFX
    budget = plen + PFX_N_REQ
    engine = InferenceEngineV2(cfg, RaggedInferenceEngineConfig(
        kv_block_size=BS, prefix_cache=PrefixCacheConfig(enabled=True),
        state_manager=DSStateManagerConfig(max_ragged_batch_size=budget,
                                           max_ragged_sequence_count=PFX_N_REQ,
                                           max_tracked_sequences=PFX_N_REQ,
                                           max_context=plen + PFX_NEW)),
        params=params, device=device)
    from deepspeed_tpu_torch.inference.v2 import DynamicSplitFuseScheduler
    rng = np.random.RandomState(0)
    system = rng.randint(0, cfg.vocab_size, size=PFX_SYS).astype(np.int32)
    total = engine.free_blocks

    def fleet(uid0, n, plen_sys, plen_sfx, ntok):
        sched = DynamicSplitFuseScheduler(engine, token_budget=budget, max_burst=PFX_BURST)
        for i in range(n):
            sfx = rng.randint(0, cfg.vocab_size, size=plen_sfx).astype(np.int32)
            sched.add_request(uid0 + i, np.concatenate([system[:plen_sys], sfx]),
                              max_new_tokens=ntok)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sched.run_to_completion()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        for uid, t in out.items():
            if len(t) != ntok or not all(0 <= v < cfg.vocab_size for v in t):
                raise AssertionError(f"prefix lane: request {uid}: {len(t)} tokens")
        prefilled = sum(len(r.prompt) - r.prefix_cached_tokens for r in sched.requests.values())
        return dt, prefilled

    fleet(10_000, 2, 16, 16, 32)  # warm-up; random prompts that cannot match the system one
    torch.cuda.reset_peak_memory_stats()
    syncs0, toks0 = engine.host_syncs, engine.tokens_emitted
    kd0 = serving_designs()
    cold_dt, cold_prefill = fleet(0, PFX_N_REQ, PFX_SYS, PFX_SFX, PFX_NEW)
    warm_dt, warm_prefill = fleet(PFX_N_REQ, PFX_N_REQ, PFX_SYS, PFX_SFX, PFX_NEW)
    kd = designs_since("prefix-lane", kd0)
    gen = PFX_N_REQ * PFX_NEW
    stats = engine.prefix_cache.stats()
    if engine.free_blocks + engine.evictable_blocks != total:
        raise AssertionError("prefix lane: blocks leaked")
    if warm_prefill >= cold_prefill:
        raise AssertionError(f"prefix lane: warm prefill {warm_prefill} >= cold {cold_prefill}")
    result = {"requests": PFX_N_REQ, "system_prompt_len": PFX_SYS, "suffix_len": PFX_SFX,
              "new_tokens": PFX_NEW, "cold_prefill_tokens": cold_prefill,
              "warm_prefill_tokens": warm_prefill,
              "warm_prefill_frac": warm_prefill / cold_prefill,
              "cold_gen_tokens_per_sec": gen / cold_dt, "warm_gen_tokens_per_sec": gen / warm_dt,
              "warm_vs_cold_speedup": cold_dt / warm_dt,
              "cache": {k: stats[k] for k in ("hit_rate", "tokens_saved", "cached_blocks",
                                              "evictions")},
              "syncs_per_token": (engine.host_syncs - syncs0) / max(engine.tokens_emitted - toks0,
                                                                    1),
              "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9, "designs": kd}
    log(f"[prefix-lane] {json.dumps(result)}")
    engine.destroy()
    torch.cuda.empty_cache()
    return result


def suspend_check(engine, system, vocab):
    """Suspend one request mid-decode and resume it: its stream must be
    the uninterrupted one (same prompt, same cached prefix, same shapes)."""
    rng = np.random.RandomState(9)
    prompt = np.concatenate([system, rng.randint(0, vocab, size=BS - 1).astype(np.int32)])
    runs, readings = [], {}

    def allocs():  # fresh pinned allocations so far, their host µs, blocks demoted so far
        st = host_pinned_stats()
        return np.array([st.get("num_host_alloc", 0), st.get("host_alloc_time.total", 0),
                         engine.kv_tier.stats()["demoted_blocks"] if engine.kv_tier else 0])
    for uid, pause in ((700, True), (701, False)):
        cached = engine.prefix_match(uid, prompt)
        toks = [int(engine.put([uid], [prompt[cached:]], sample="greedy")[0])]
        for step in range(4):
            if pause and step == 2:
                torch.cuda.synchronize()
                a0 = allocs()
                t0 = time.perf_counter()
                engine.suspend(uid)
                readings["suspend_ms"] = (time.perf_counter() - t0) * 1e3
                a1 = allocs()
                readings["suspended_blocks"] = engine.suspended_blocks(uid)
                readings["host_bytes"] = sum(t.nbytes for t in
                                             engine._suspended[uid]["handle"].values())
                t0 = time.perf_counter()
                engine.resume(uid)
                torch.cuda.synchronize()
                readings["resume_ms"] = (time.perf_counter() - t0) * 1e3
                for what, d in (("suspend", a1 - a0), ("resume", allocs() - a1)):
                    readings[f"{what}_fresh_pinned"] = int(d[0])
                    readings[f"{what}_pinning_ms"] = float(d[1]) / 1e3
                    readings[f"{what}_demoted_blocks"] = int(d[2])
            toks += [int(t) for t in engine.decode_burst([uid], [toks[-1]], TIER_NEW // 4)[:, 0]]
        engine.flush(uid)
        runs.append((cached, toks))
    if runs[0] != runs[1]:
        raise AssertionError("suspend/resume: the resumed stream differs from the "
                             "uninterrupted one")
    readings.update(cached_tokens=runs[0][0], tokens=len(runs[0][1]), bitwise=True)
    log(f"[suspend] {json.dumps(readings)}")
    return readings


TIER_MODES = {"control": ("off", TIER_CONTROL_BLOCKS, True), "off": ("off", TIER_KV_BLOCKS, True),
              "bf16": ("bf16", TIER_KV_BLOCKS, True), "int8": ("int8", TIER_KV_BLOCKS, True),
              "bf16_no_prefetch": ("bf16", TIER_KV_BLOCKS, False)}


def tier_lane(cfg, device, params):
    """``bench_serving_2b_kv_tier`` on five engines from the same weights:
    a control whose pool evicts nothing, the lane's pool with the tier
    off, with a bf16 tier, with an int8 tier, and with a bf16 tier whose
    prefetch worker is off (its promotion copies the host records)."""
    from deepspeed_tpu_torch.ops.kernels import quantization as tq
    system, traffic = tier_traffic(cfg.vocab_size)
    runs, launches, probes, suspend = {}, None, {}, None
    for mode, (storage, num_kv_blocks, prefetch) in TIER_MODES.items():
        engine = tier_engine(cfg, device, params, storage, num_kv_blocks=num_kv_blocks,
                             prefetch=prefetch)
        total = engine.free_blocks
        tier_fleet(engine, 10_000, [p[:48] for p in traffic["B"][:2]], new=16)  # warm-up
        probe = TierProbe(engine) if engine.kv_tier is not None else None
        empty_host_cache()
        getattr(torch.cuda, "reset_peak_host_memory_stats", lambda: None)()
        torch.cuda.reset_peak_memory_stats()
        syncs0, toks0 = engine.host_syncs, engine.tokens_emitted
        tq.quantize_int8.launches = tq.dequantize_int8.launches = 0
        kd0, k7d0 = serving_designs(), dict(tq.k7_design_launches)
        trace = tier_trace(engine, traffic)
        if mode == "int8":
            by_design = {d: n - k7d0[d] for d, n in tq.k7_design_launches.items()}
            launches = {"quantize_int8": tq.quantize_int8.launches,
                        "dequantize_int8": tq.dequantize_int8.launches,
                        "quantize_int8_by_design": by_design}
            log(f"[tier-lane] K7 quantize launches by design: {json.dumps(by_design)}")
            if by_design["cluster"] == 0 or by_design["warp"]:
                raise AssertionError(f"tier lane: K7 quantize launches by design {by_design}, "
                                     f"want the demotions' slabs on the cluster design")
        run = {"phases": {p: {k: v for k, v in r.items() if k != "streams"}
                          for p, r in trace.items()},
               "streams": {p: r["streams"] for p, r in trace.items()},
               "syncs_per_token": (engine.host_syncs - syncs0) /
               max(engine.tokens_emitted - toks0, 1),
               "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
               "prefix": engine.prefix_cache.stats(),
               "designs": designs_since(f"tier-lane {mode}", kd0)}
        if engine.kv_tier is not None:
            run["tier"] = engine.kv_tier.stats()
            run["host_pinned"] = host_pinned_stats()
            probes[mode] = probe.readings()
        if mode == "control" and run["prefix"]["evictions"]:
            raise AssertionError("tier lane: the control engine evicted cached blocks")
        if mode == "bf16":
            suspend = suspend_check(engine, system, cfg.vocab_size)
        if engine.free_blocks + engine.evictable_blocks != total:
            raise AssertionError(f"tier lane {mode}: blocks leaked")
        log(f"[tier-lane] {mode}: {json.dumps({k: v for k, v in run.items() if k != 'streams'})}")
        if probe is not None:
            log(f"[tier-lane] {mode} demote/promote: {json.dumps(probes[mode])}")
        runs[mode] = run
        engine.destroy()
        torch.cuda.empty_cache()
    # gates: the bf16 tiers serve the control's streams and restore the demoted bytes
    for mode in ("bf16", "bf16_no_prefetch"):
        if runs[mode]["streams"] != runs["control"]["streams"]:
            raise AssertionError(f"tier lane: {mode}-tier streams differ from the control "
                                 f"engine's")
        if probes[mode]["promoted_blocks_checked"] == 0 or \
                probes[mode]["promoted_vs_demoted_max_abs"] != 0.0:
            raise AssertionError(f"tier lane {mode}: promoted blocks differ from the demoted "
                                 f"ones ({probes[mode]})")
    if runs["bf16_no_prefetch"]["tier"]["stage_hits"] or \
            runs["bf16_no_prefetch"]["tier"]["prefetched_blocks"]:
        raise AssertionError("tier lane: the no-prefetch tier staged copies")
    saved_on = runs["bf16"]["phases"]["A'"]["prefix_cached_tokens"]
    saved_off = runs["off"]["phases"]["A'"]["prefix_cached_tokens"]
    if saved_on < 2 * max(saved_off, 1):
        raise AssertionError(f"tier lane: A' prefill saved {saved_on} with the tier vs "
                             f"{saved_off} without, want >= 2x")

    def agree(a, b):
        return sum(x == y for p in a["streams"] for x, y in zip(a["streams"][p],
                                                                 b["streams"][p]))
    # batch invariance: the tier-off engine prefills A' at other shapes than
    # the control; the bf16 tier equals the tier off, as bench.py asserts
    for a, b in (("off", "control"), ("bf16", "off")):
        if agree(runs[a], runs[b]) != 3 * TIER_N_REQ:
            raise AssertionError(f"tier lane: {a} agrees with {b} in "
                                 f"{agree(runs[a], runs[b])} of {3 * TIER_N_REQ} streams")
    result = {"requests_per_phase": TIER_N_REQ, "system_prompt_len": TIER_SYS,
              "suffix_len": TIER_SFX, "new_tokens": TIER_NEW, "num_kv_blocks": TIER_KV_BLOCKS,
              "control_blocks": TIER_CONTROL_BLOCKS,
              "return_prefill_saved_tier_off": saved_off,
              "return_prefill_saved_bf16_tier": saved_on,
              "return_prefill_saved_int8_tier":
                  runs["int8"]["phases"]["A'"]["prefix_cached_tokens"],
              "tokens_saved_ratio": saved_on / max(saved_off, 1),
              "promotion_from_host_records": {
                  k: v for k, v in probes["bf16_no_prefetch"].items() if k.startswith("promote")},
              "promotion_from_staged_copies": {
                  k: v for k, v in probes["bf16"].items() if k.startswith("promote")},
              "streams_agreeing_of_12": {"bf16_vs_off": agree(runs["bf16"], runs["off"]),
                                         "off_vs_control": agree(runs["off"], runs["control"]),
                                         "bf16_vs_control": agree(runs["bf16"], runs["control"]),
                                         "int8_vs_control": agree(runs["int8"], runs["control"])},
              "runs": {m: {k: v for k, v in r.items() if k != "streams"}
                       for m, r in runs.items()},
              "demote_promote": probes, "suspend": suspend, "k7_launches": launches}
    log(f"[tier-lane] {json.dumps({k: v for k, v in result.items() if k != 'runs'})}")
    return result, launches


def kv_tier_phase(device):
    """Phase 18: Mistral-7B at TIER_LAYERS layers, bf16, seeded weights
    built once."""
    from deepspeed_tpu_torch.models import init_params, llama_config
    cfg = llama_config("mistral-7b", num_hidden_layers=TIER_LAYERS)
    t0 = time.perf_counter()
    params = init_params(cfg, device, torch.bfloat16,
                         torch.Generator(device=device).manual_seed(0))
    torch.cuda.synchronize()
    log(f"[kv-tier] mistral-7b weights ({TIER_LAYERS} layers) built in "
        f"{time.perf_counter() - t0:.2f} s")
    prefix = prefix_lane(cfg, device, params)
    tier, launches = tier_lane(cfg, device, params)
    del params
    torch.cuda.empty_cache()
    return {"prefix_lane": prefix, "tier_lane": tier}, launches


# ---------------------------------------------------------------- phase 19
def moe_train_layout(device):
    """The phase's routing: MOE_TRAIN_SIZES rows per expert, tile-aligned
    → (sizes, dst, tile_experts, used_tiles, Mp, tm)."""
    from deepspeed_tpu_torch.ops.kernels import grouped_matmul as gm
    from deepspeed_tpu_torch.ops.kernels.fused_quant_matmul import row_tile
    sizes = torch.tensor(MOE_TRAIN_SIZES, device=device)
    n = int(sum(MOE_TRAIN_SIZES))
    tm = row_tile(-(-n // len(MOE_TRAIN_SIZES)))
    dst, te, Mp = gm.pad_groups_to_tiles(sizes, n, tm)
    return sizes, dst.long(), te, gm.used_tiles(sizes, tm), Mp, tm


def dw_library(xs, dys, sizes, flush):
    """The yardstick for dW: ``torch._grouped_mm`` of xᵀ [K, n] and dy
    [n, N] with offsets on the contraction dim where this torch takes the
    case, else the sum of per-expert ``torch.matmul`` times. ``xs``/``dys``
    are the tile layout's used rows and ``sizes`` the padded groups: its
    kernel asserts on the device (and the context is lost) unless every
    group's rows are a multiple of 16 bytes, and the zero pad rows add
    nothing."""
    offs = torch.cumsum(sizes, 0).to(torch.int32)
    if hasattr(torch, "_grouped_mm"):
        a, b = xs.t().contiguous(), dys.t().contiguous().t()
        try:
            torch._grouped_mm(a, b, offs=offs)
            torch.cuda.synchronize()
        except RuntimeError as exc:  # this torch refuses the case: the per-expert sum below
            log(f"[grouped-bwd] torch._grouped_mm refused the dW case: {str(exc)[:120]}")
        else:
            return {"library_ms": time_ms(lambda: torch._grouped_mm(a, b, offs=offs), flush),
                    "library_call": "torch._grouped_mm (2-D x 2-D, offsets on the "
                                    "contraction dim)"}
    bounds, total = [0] + offs.tolist(), 0.0
    for e in range(sizes.shape[0]):
        if bounds[e + 1] > bounds[e]:
            xe, de = xs[bounds[e]:bounds[e + 1]].t(), dys[bounds[e]:bounds[e + 1]]
            total += time_ms(lambda: xe @ de, flush)
    return {"library_ms": total, "library_call": "sum of per-expert torch.matmul"}


def dequant_library(xs, q, scheme, sizes, flush):
    """The same-function yardstick of ``gmm_quant_dx``: dequantize the
    whole carrier stack with ``dequantize_grouped``, then one
    ``torch._grouped_mm`` of the sorted rows against it transposed (else
    the per-expert ``torch.matmul`` sum), timed as one call sequence."""
    from deepspeed_tpu_torch.ops.kernels.fused_quant_matmul import dequantize_grouped
    offs = torch.cumsum(sizes, 0).to(torch.int32)
    bounds = [0] + offs.tolist()

    def per_expert():
        w = dequantize_grouped(q.values, q.scales, scheme, torch.bfloat16)
        return [xs[bounds[e]:bounds[e + 1]] @ w[e].t() for e in range(w.shape[0])
                if bounds[e + 1] > bounds[e]]

    def grouped():
        w = dequantize_grouped(q.values, q.scales, scheme, torch.bfloat16)
        return torch._grouped_mm(xs, w.transpose(1, 2), offs=offs)

    if hasattr(torch, "_grouped_mm"):
        try:
            grouped()
            torch.cuda.synchronize()
        except RuntimeError as exc:
            log(f"[grouped-bwd] torch._grouped_mm refused the dequantized case: {str(exc)[:120]}")
        else:
            return {"library_ms": time_ms(grouped, flush),
                    "library_call": "dequantize_grouped + torch._grouped_mm"}
    return {"library_ms": time_ms(per_expert, flush),
            "library_call": "dequantize_grouped + per-expert torch.matmul"}


def gemm_designs():
    """K5's bf16 GEMM launches so far, by GEMM ("fwd": ``gmm`` over a bf16
    stack, "dx", "dw") and design (the wgmma design, the general one), and
    the launches of the work list's kernel (``gmm_plan``: the forward's
    and dx's wgmma designs build one a launch)."""
    from deepspeed_tpu_torch.ops.kernels import grouped_matmul as gm
    return {"fwd": dict(gm.gmm_fwd_design_launches), "dx": dict(gm.gmm_dx_design_launches),
            "dw": dict(gm.gmm_dw_design_launches), "quant": quant_designs(),
            "plan": gm.gmm_plan.launches}


def check_designs(before, want, name, design="wgmma"):
    """Raise unless, since ``before``, each GEMM of ``want`` ({"fwd": n,
    "dx": n, "dw": n}) launched exactly its count, all on ``design``, each
    forward and dx on the wgmma design with one launch of the work list's
    kernel (as is each ``gmm_quant`` on a Hopper design)."""
    now = gemm_designs()
    grew = {g: {k: v - before[g][k] for k, v in now[g].items()} for g in want}
    plans = now["plan"] - before["plan"]
    want_plans = want.get("fwd", 0) + want.get("dx", 0) if design == "wgmma" else 0
    want_plans += sum(now["quant"][d] - before["quant"][d] for d in ("wgmma", "stream"))
    other = "general" if design == "wgmma" else "wgmma"
    if grew != {g: {design: n, other: 0} for g, n in want.items()} or plans != want_plans:
        raise AssertionError(f"{name}: launches by design {grew}, want {want}, all {design}; "
                             f"work lists {plans}, want {want_plans}")
    return grew


def table_cases(device, flush):
    """The wgmma designs' work list built by its one-thread kernel
    (``gmm_plan``) against its plain version (torch ops on the card), bit
    for bit: at phase 19's routing and phase 9's serving routings, at 16-
    and 64-row tiles, with every tile used and with the used tiles cut to
    half, and with no rows at all; timed at phase 19's layout beside its
    plain version. → rows."""
    from deepspeed_tpu_torch.ops.kernels import grouped_matmul as gm
    layouts = [("train", torch.tensor(MOE_TRAIN_SIZES, device=device))]
    layouts += [(c, routing_sizes(c, device)) for c in ("decode", "prefill", "one_expert")]
    layouts += [("no_rows", torch.zeros(8, dtype=torch.int64, device=device))]
    checked, out = 0, []
    for name, sizes in layouts:
        for tm in (16, 64):
            _, te, _ = gm.tile_layout(sizes, int(sizes.sum()), tm)
            for used in (gm.used_tiles(sizes, tm), gm.used_tiles(sizes, tm) // 2):
                E = sizes.shape[0]
                if not torch.equal(gm.gmm_plan(te, used, tm, E), gm.gmm_plan_ref(te, used, tm, E)):
                    raise AssertionError(f"work list {name} tm {tm} used {int(used)}: the "
                                         f"kernel's differs from its plain version")
                checked += 1
            if name == "train" and tm == 64:
                used = gm.used_tiles(sizes, tm)
                out.append({"case": "gmm_plan_train", "tm": tm, "tiles": te.shape[0],
                            "max_abs_err": 0.0, "equal_to_plain": True,
                            "ms": time_ms(lambda: gm.gmm_plan(te, used, tm, E), flush),
                            "plain_ms": time_ms(lambda: gm.gmm_plan_ref(te, used, tm, E),
                                                flush)})
    log(f"[grouped-bwd] work lists: {checked} layouts equal to the plain version; "
        f"{json.dumps(out)}")
    return out


def dw_first_design_case(wname, K, N, device, g, check, flush):
    """dW on its first design at Mixtral width: a small training routing
    (DW_SMALL_SIZES, 128 rows, expert 1 empty) whose row tile is 16, so
    the predicate keeps the first design. Held against the plain version
    (the zeroed-tile check), the empty expert's dW zero, two runs equal
    bit for bit, timed beside its bound. → row."""
    from deepspeed_tpu_torch.ops.kernels import grouped_matmul as gm
    from deepspeed_tpu_torch.ops.kernels.fused_quant_matmul import row_tile
    sizes = torch.tensor(DW_SMALL_SIZES, device=device)
    n, E = int(sizes.sum()), sizes.shape[0]
    tm = row_tile(-(-n // E))
    dst, te, Mp = gm.pad_groups_to_tiles(sizes, n, tm)
    used = gm.used_tiles(sizes, tm)
    x, dy = (torch.zeros((Mp, c), dtype=torch.bfloat16, device=device) for c in (K, N))
    x[dst.long()] = torch.randn(n, K, generator=g, device=device).to(torch.bfloat16)
    dy[dst.long()] = (torch.randn(n, N, generator=g, device=device) * 0.02).to(torch.bfloat16)
    name = f"gmm_dw {wname} tm {tm}"
    designs = gemm_designs()
    got, again = gm.gmm_dw(x, dy, te, E, tm, used), gm.gmm_dw(x, dy, te, E, tm, used)
    check_designs(designs, {"dw": 2}, name, design="general")
    want = gm.gmm_dw_ref(x, dy, te, E, tm, used, out_dtype=torch.float32)
    busiest = int(sizes.argmax())
    zeroed = got.clone()
    zeroed[busiest, :64, :64] = 0
    row = check(name, got, want, zeroed)
    if not torch.equal(got, again):
        raise AssertionError(f"{name}: two runs differ")
    empty = [e for e in range(E) if not int(sizes[e])]
    if any(got[e].any() for e in empty):
        raise AssertionError(f"{name}: the empty expert's dW is not zero")
    b_ms, b_by = bound(2 * n * (K + N) + E * K * N * 2, 2 * n * K * N)
    row.update({"case": f"dw_{wname}_tm{tm}", "rows": n, "tm": tm, "padded_rows": Mp, "K": K,
                "N": N, "experts": E, "empty_experts": empty, "design": "general",
                "deterministic": True,
                "ms": time_ms(lambda: gm.gmm_dw(x, dy, te, E, tm, used), flush),
                "bound_ms": b_ms, "bound_by": b_by, "flops": 2 * n * K * N})
    log(f"[grouped-bwd] {name} {json.dumps(row)}")
    del x, dy, got, again, want, zeroed
    return row


def gmm_bwd_cases(device, flush):
    """Phase 19: K5's backward kernels at Mixtral's expert stacks over the
    phase's skewed routing (8192 rows, expert 7 empty, 64-row tiles):
    ``gmm_dw`` at w1 [8, 4096, 14336] and w2 [8, 14336, 4096], ``gmm``'s dx
    on each stack as stored, and ``gmm_quant_dx`` over int8, fp8 and fp6
    carriers of each; and the forward ``gmm`` at the same shapes. Each held
    against its plain version with ``row_scaled_err`` (limit QUANT_TOL),
    the check rejecting the output with one tile zeroed; dW of the empty
    expert all zeros; two runs of each equal bit for bit, every launch on
    the wgmma design and zeros past the used tiles; each timed beside its
    plain version, one library call (for carriers, ``dequantize_grouped``
    + ``torch._grouped_mm``, the same function, with ``torch._grouped_mm``
    on the dequantized stack beside it) and the bound. Then the first
    designs of the forward (x at an unaligned base) and of dW (16-row
    tiles, :func:`dw_first_design_case`), held the same way; and the
    wgmma designs' work-list kernel (:func:`table_cases`). →
    {"gmm_dw": rows, "gmm_dx": rows, "gmm_quant_dx": rows, "gmm_fwd": rows,
    "tables": rows}."""
    from deepspeed_tpu_torch.inference.quantization.quantization import _quantize_grouped
    from deepspeed_tpu_torch.ops.kernels import grouped_matmul as gm
    from deepspeed_tpu_torch.ops.kernels.flash_attention import row_scaled_err
    from deepspeed_tpu_torch.ops.kernels.fused_quant_matmul import dequantize_grouped
    sizes, dst, te, used, Mp, tm = moe_train_layout(device)
    n, E = int(sizes.sum()), sizes.shape[0]
    busiest, empty = int(sizes.argmax()), [e for e in range(E) if not int(sizes[e])]
    start = int(((sizes[:busiest] + tm - 1) // tm * tm).sum())
    touched = [e for e in range(E) if int(sizes[e])]
    g = torch.Generator(device=device).manual_seed(19)

    def rows(cols, scale):
        r = torch.zeros((Mp, cols), dtype=torch.bfloat16, device=device)
        r[dst] = (torch.randn(n, cols, generator=g, device=device) * scale).to(torch.bfloat16)
        return r

    def check(name, got, want, zeroed):
        torch.cuda.synchronize()
        if not torch.isfinite(got.float()).all():
            raise AssertionError(f"{name}: non-finite kernel output")
        err, zerr = row_scaled_err(got, want.float()), row_scaled_err(zeroed, want.float())
        if err > QUANT_TOL or zerr <= QUANT_TOL:
            raise AssertionError(f"{name}: row_scaled_err {err} (limit {QUANT_TOL}), zeroed "
                                 f"tile {zerr} (must exceed it)")
        return {"max_abs_err": max_abs(got, want), "row_err": err, "zeroed_tile_row_err": zerr}

    out = {"gmm_dw": [], "gmm_dx": [], "gmm_quant_dx": [], "gmm_fwd": [],
           "tables": table_cases(device, flush)}
    for si, (wname, (K, N)) in enumerate(zip(("w1", "w2"), MLP_SHAPES)):
        x, dy = rows(K, 1.0), rows(N, 0.02)
        w = (torch.randn(E, K, N, generator=g, device=device) * 0.02).to(torch.bfloat16)
        # the forward gmm at the training shape: x [Mp, K] @ w[tile] [K, N]
        designs = gemm_designs()
        got, again = gm.gmm(x, w, te, tm, used), gm.gmm(x, w, te, tm, used)
        check_designs(designs, {"fwd": 2}, f"gmm fwd {wname}")
        want = gm.gmm_ref(x, w, te, tm, used)
        zeroed = got.clone()
        zeroed[start:start + 64] = 0
        row = check(f"gmm fwd {wname}", got, want, zeroed)
        if got[int(used) * tm:].any():
            raise AssertionError(f"gmm fwd {wname}: rows past the used tiles are not zero")
        if not torch.equal(got, again):
            raise AssertionError(f"gmm fwd {wname}: two runs differ")
        del again
        b_ms, b_by = bound(w[0].nbytes * len(touched) + 2 * n * (K + N), 2 * n * K * N)
        row.update({"case": f"bf16_fwd_{wname}", "scheme": "bf16", "rows": n, "tm": tm, "K": K,
                    "N": N, "design": "wgmma", "deterministic": True,
                    "ms": time_ms(lambda: gm.gmm(x, w, te, tm, used), flush),
                    "plain_ms": time_ms(lambda: gm.gmm_ref(x, w, te, tm, used), flush, iters=3),
                    "bound_ms": b_ms, "bound_by": b_by, "flops": 2 * n * K * N})
        row.update(grouped_library(x[dst], w, sizes, flush))
        log(f"[grouped-bwd] gmm fwd {wname} {json.dumps(row)}")
        out["gmm_fwd"].append(row)
        # the first forward design, at a base the predicate refuses TMA: x
        # one element into its buffer (a view), the same values
        xm = torch.empty(Mp * K + 8, dtype=torch.bfloat16, device=device)[1:1 + Mp * K]
        xm = xm.view(Mp, K)
        xm.copy_(x)
        name = f"gmm fwd {wname} unaligned"
        designs = gemm_designs()
        got, again = gm.gmm(xm, w, te, tm, used), gm.gmm(xm, w, te, tm, used)
        check_designs(designs, {"fwd": 2}, name, design="general")
        zeroed = got.clone()
        zeroed[start:start + 64] = 0
        row = check(name, got, want, zeroed)
        if got[int(used) * tm:].any():
            raise AssertionError(f"{name}: rows past the used tiles are not zero")
        if not torch.equal(got, again):
            raise AssertionError(f"{name}: two runs differ")
        row.update({"case": f"bf16_fwd_{wname}_unaligned", "scheme": "bf16", "rows": n, "tm": tm,
                    "K": K, "N": N, "design": "general", "deterministic": True,
                    "ms": time_ms(lambda: gm.gmm(xm, w, te, tm, used), flush),
                    "bound_ms": b_ms, "bound_by": b_by, "flops": 2 * n * K * N})
        log(f"[grouped-bwd] {name} {json.dumps(row)}")
        out["gmm_fwd"].append(row)
        del got, again, want, zeroed, xm
        # dW
        designs = gemm_designs()
        got = gm.gmm_dw(x, dy, te, E, tm, used)
        again = gm.gmm_dw(x, dy, te, E, tm, used)
        check_designs(designs, {"dw": 2}, f"gmm_dw {wname}")
        want = gm.gmm_dw_ref(x, dy, te, E, tm, used, out_dtype=torch.float32)
        zeroed = got.clone()
        zeroed[busiest, :64, :64] = 0
        row = check(f"gmm_dw {wname}", got, want, zeroed)
        if not torch.equal(got, again):
            raise AssertionError(f"gmm_dw {wname}: two runs differ")
        if any(got[e].any() for e in empty):
            raise AssertionError(f"gmm_dw {wname}: the empty expert's dW is not zero")
        del again, want, zeroed
        b_ms, b_by = bound(2 * n * (K + N) + E * K * N * 2, 2 * n * K * N)
        row.update({"case": f"dw_{wname}", "rows": n, "tm": tm, "padded_rows": Mp, "K": K,
                    "N": N, "experts": E, "empty_experts": empty, "design": "wgmma",
                    "deterministic": True,
                    "ms": time_ms(lambda: gm.gmm_dw(x, dy, te, E, tm, used), flush),
                    "plain_ms": time_ms(lambda: gm.gmm_dw_ref(x, dy, te, E, tm, used), flush,
                                        iters=3),
                    "bound_ms": b_ms, "bound_by": b_by, "flops": 2 * n * K * N})
        padded = (sizes + tm - 1) // tm * tm
        n_pad = int(padded.sum())
        row.update(dw_library(x[:n_pad], dy[:n_pad], padded, flush))
        log(f"[grouped-bwd] gmm_dw {json.dumps(row)}")
        out["gmm_dw"].append(row)
        del got
        out["gmm_dw"].append(dw_first_design_case(wname, K, N, device, g, check, flush))
        # dx: dy [Mp, N] against the stack [E, K, N] as stored
        for scheme in ("bf16", "int8", "fp8", "fp6"):
            quant = scheme != "bf16"
            q = _quantize_grouped(w, scheme, 512) if quant else None
            w_bf16 = dequantize_grouped(q.values, q.scales, scheme, torch.bfloat16) if quant \
                else w

            def run():
                if quant:
                    return gm.gmm_quant_dx(dy, q.values, q.scales, te, scheme, torch.bfloat16,
                                           tm, used)
                return gm.gmm_transposed(dy, w, te, tm, used)

            def plain():
                if quant:
                    return gm.gmm_quant_dx_ref(dy, q.values, q.scales, te, scheme,
                                               torch.bfloat16, tm, used)
                return gm.gmm_transposed_ref(dy, w, te, tm, used)

            name = f"{'gmm_quant_dx' if quant else 'gmm dx'} {scheme} {wname}"
            designs = gemm_designs()
            got, again, want = run(), run(), plain()
            check_designs(designs, {"dx": 2}, name)
            zeroed = got.clone()
            zeroed[start:start + 64] = 0
            row = check(name, got, want, zeroed)
            if got[int(used) * tm:].any():
                raise AssertionError(f"{name}: rows past the used tiles are not zero")
            if not torch.equal(got, again):
                raise AssertionError(f"{name}: two runs differ")
            del again
            wbytes = (carrier_bytes(q, touched) if quant else w[0].nbytes * len(touched))
            b_ms, b_by = bound(wbytes + 2 * n * (K + N), 2 * n * K * N)
            row.update({"case": f"{scheme}_dx_{wname}", "scheme": scheme, "rows": n, "tm": tm,
                        "K": K, "N": N, "design": "wgmma", "deterministic": True,
                        "ms": time_ms(run, flush),
                        "plain_ms": time_ms(plain, flush, iters=3), "bound_ms": b_ms,
                        "bound_by": b_by, "flops": 2 * n * K * N})
            stack = grouped_library(dy[dst], w_bf16.transpose(1, 2), sizes, flush)
            if quant:  # the same function: the stack's decode is part of it
                row.update(dequant_library(dy[dst], q, scheme, sizes, flush))
                row.update({"bf16_stack_library_ms": stack["library_ms"],
                            "bf16_stack_library_call": stack["library_call"]})
            else:
                row.update(stack)
            log(f"[grouped-bwd] {name} {json.dumps(row)}")
            out["gmm_quant_dx" if quant else "gmm_dx"].append(row)
            del got, want, zeroed, q, w_bf16
        del x, dy, w
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- phase 20
@contextlib.contextmanager
def plain_moe_train_kernels():
    """Pin the training model's attention, norms and grouped GEMMs
    (forward, dx, dW, quantized forward and dx) to their plain versions."""
    from deepspeed_tpu_torch.ops.kernels import grouped_matmul as gm
    names = ("gmm", "gmm_transposed", "gmm_dw", "gmm_quant", "gmm_quant_dx")
    saved = [getattr(gm, n) for n in names]
    for n in names:
        setattr(gm, n, getattr(gm, n + "_ref"))
    try:
        with plain_train_kernels():
            yield
    finally:
        for n, f in zip(names, saved):
            setattr(gm, n, f)


def moe_train_counters():
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    from deepspeed_tpu_torch.ops.kernels import grouped_matmul as gm
    from deepspeed_tpu_torch.ops.kernels.fused_norms import rms_norm_fwd
    return {"gmm": gm.gmm, "gmm_dw": gm.gmm_dw, "gmm_quant": gm.gmm_quant,
            "gmm_quant_dx": gm.gmm_quant_dx, "flash_fwd": fa.flash_fwd,
            "flash_bwd_dkv": fa.flash_bwd_dkv, "flash_bwd_dq": fa.flash_bwd_dq,
            "rms_norm_fwd": rms_norm_fwd}


def moe_train_launches(L, gas, policy):
    """What one dropless MoE training step launches: per layer and
    micro-batch 3 grouped GEMMs forward, 3 dx and 3 dW, plus the forward
    again under remat "full" (the whole block recomputed); flash forward
    twice (the attention half is recomputed under either policy), dK/dV
    and dQ once; RMS 4 per layer (both norms, recomputed) and the final
    norm."""
    return {"gmm": (9 if policy == "full" else 6) * L * gas, "gmm_dw": 3 * L * gas,
            "gmm_quant": 0, "gmm_quant_dx": 0, "flash_fwd": 2 * L * gas,
            "flash_bwd_dkv": L * gas, "flash_bwd_dq": L * gas, "rms_norm_fwd": (4 * L + 1) * gas}


def moe_train_model(device, seed, **overrides):
    from deepspeed_tpu_torch.models import build_llama
    return build_llama("mixtral-8x7b", device=device, dtype=torch.bfloat16,
                       num_hidden_layers=MOE_TRAIN_LAYERS, moe_drop_tokens=False,
                       remat_policy="moe", generator=torch.Generator(device=device).manual_seed(seed),
                       **overrides)


def moe_batch(vocab, device, B, S, gas, seed=0):
    """One seeded batch [gas, B, S] (``train_batch`` takes micro-batch g
    as ``ids[g]``)."""
    g = torch.Generator(device=device).manual_seed(seed)
    ids = torch.randint(0, vocab, (gas, B, S), generator=g, device=device, dtype=torch.int32)
    return ids, ids.clone()


def aux_recorder(model):
    """→ a list that collects each forward's summed aux loss (the model
    trunk's second output)."""
    auxes = []
    model.model.register_forward_hook(lambda m, i, o: auxes.append(o[1].detach().float()))
    return auxes


def moe_train_parity_phase(device):
    """Phase 20: a 2-layer Mixtral-width dropless model, remat "moe", one
    engine step (B 1 x S 2048, gas 2) through the kernels and from the
    same weights and batch through the plain versions (the plain run
    replays the kernel run's routing), then the frozen-base FFN over int8
    carriers."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.moe import sharded_moe
    L, gas = MOE_TRAIN_LAYERS, 2
    counters = moe_train_counters()
    results, record = {}, []
    for mode in ("kernels", "plain"):
        model = moe_train_model(device, 20)
        engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=train_config(1, gas),
                                                    device=device)
        names = [n for n, p in model.named_parameters() if p.requires_grad]
        grads, auxes = capture_grads(engine, to_host=True), aux_recorder(model)
        before, designs = {k: f.launches for k, f in counters.items()}, gemm_designs()
        with plain_moe_train_kernels() if mode == "plain" else contextlib.nullcontext(), \
                routing(record, replay=mode == "plain", mr=sharded_moe) as flips:
            loss = engine.train_batch(batch=moe_batch(model.config.vocab_size, device, 1, MS,
                                                      gas))
        torch.cuda.synchronize()
        grew = {k: f.launches - before[k] for k, f in counters.items()}
        want = moe_train_launches(L, gas, "moe") if mode == "kernels" else \
            {k: 0 for k in counters}
        if grew != want:
            raise AssertionError(f"moe train parity {mode}: launches {grew}, want {want}")
        n = 3 * L * gas if mode == "kernels" else 0  # every tm 64 GEMM on the wgmma design
        check_designs(designs, {"fwd": n, "dx": n, "dw": n}, f"moe train parity {mode}")
        results[mode] = (loss.item(), float(sum(a.item() for a in auxes)), grads, flips[0])
        engine.destroy()
        del model, engine, grads
        gc.collect()  # the wrapped step and the engine hold each other
        torch.cuda.empty_cache()
    (lk, ak, gk, _), (lp, ap, gp, flips) = results["kernels"], results["plain"]
    leaf = {n: ((a - b).norm() / b.norm()).item() for n, a, b in zip(names, gk, gp)}
    res = {"loss_kernels": lk, "loss_plain": lp, "loss_rel_diff": abs(lk - lp) / abs(lp),
           "aux_kernels": ak, "aux_plain": ap, "aux_rel_diff": abs(ak - ap) / abs(ap),
           "routing_near_ties": flips, "leaf_grad_rel_diff_max": max(leaf.values()),
           "leaf_grad_rel_diff_worst": max(leaf, key=leaf.get),
           "launches_per_step": moe_train_launches(L, gas, "moe"), "leaf_grad_rel_diff": leaf}
    log(f"[moe-train-parity] 2-layer mixtral-8x7b width, dropless, remat moe, B=1, S={MS}, "
        f"gas {gas}: {json.dumps(res)}")
    if not (math.isfinite(lk) and math.isfinite(lp) and math.isfinite(ak)) or ak <= 0 \
            or res["loss_rel_diff"] > MOE_LOSS_TOL or res["aux_rel_diff"] > MOE_AUX_TOL \
            or max(leaf.values()) > GRAD_LEAF_TOL:
        raise AssertionError(f"moe train parity over its limits: {res}")
    res["frozen_base"], launches = frozen_base_check(device)
    return res, launches


def frozen_base_check(device):
    """The dropless FFN over one Mixtral layer's int8 expert carriers (from
    ``init_quantized_params``), gradients in x only: through the kernels
    (3 ``gmm_quant`` forward, 3 ``gmm_quant_dx``) and through the plain
    versions. dx within GRAD_LEAF_TOL in relative L2 norm (and printed in
    ``row_scaled_err`` units); carriers and scales get no gradient."""
    from deepspeed_tpu_torch.models import llama_config
    from deepspeed_tpu_torch.models.llama import init_quantized_params
    from deepspeed_tpu_torch.ops.grouped_gemm import dropless_moe_ffn
    from deepspeed_tpu_torch.ops.kernels.flash_attention import row_scaled_err
    from deepspeed_tpu_torch.ops.kernels import grouped_matmul as gm
    cfg = llama_config("mixtral-8x7b", num_hidden_layers=1)
    qp = init_quantized_params(cfg, "int8", device, torch.bfloat16,
                               torch.Generator(device=device).manual_seed(21))
    stacks = [qp["layers"][n][0] for n in ("experts_w1", "experts_w3", "experts_w2")]
    del qp
    torch.cuda.empty_cache()
    T, E, k = MB * MS, cfg.moe_num_experts, cfg.moe_top_k
    g = torch.Generator(device=device).manual_seed(22)
    x = torch.randn(T, cfg.hidden_size, generator=g, device=device).to(torch.bfloat16)
    gout = torch.randn(T, cfg.hidden_size, generator=g, device=device).to(torch.bfloat16)
    gates = torch.softmax(torch.randn(T, E, generator=g, device=device) * 2, -1)
    vals, idx = gates.topk(k, dim=-1)
    vals = (vals / vals.sum(-1, keepdim=True)).to(torch.bfloat16)
    dx = {}
    for mode in ("kernels", "plain"):
        if mode == "kernels":
            gm.gmm_quant.launches = gm.gmm_quant_dx.launches = 0
        before, designs = [gm.gmm_quant.launches, gm.gmm_quant_dx.launches], gemm_designs()
        qd = quant_designs()
        xt = x.clone().requires_grad_()
        with plain_moe_train_kernels() if mode == "plain" else contextlib.nullcontext():
            out = dropless_moe_ffn(xt, idx, vals, *stacks, num_experts=E)
            (out.float() * gout.float()).sum().backward()
        torch.cuda.synchronize()
        if mode == "kernels":
            launches = {"gmm_quant": gm.gmm_quant.launches,
                        "gmm_quant_dx": gm.gmm_quant_dx.launches}
            if launches != {"gmm_quant": 3, "gmm_quant_dx": 3}:
                raise AssertionError(f"frozen base: launches {launches}, want 3 and 3")
        elif [gm.gmm_quant.launches, gm.gmm_quant_dx.launches] != before:
            raise AssertionError("frozen base: the plain run launched a kernel")
        check_designs(designs, {"fwd": 0, "dx": 3 if mode == "kernels" else 0, "dw": 0},
                      f"frozen base {mode}")
        want_q = {"wgmma": 3 if mode == "kernels" else 0, "stream": 0, "general": 0}
        if quant_grew(qd) != want_q:  # 8192 rows: 64-row tiles, the forward ring
            raise AssertionError(f"frozen base {mode}: gmm_quant by design {quant_grew(qd)}, "
                                 f"want {want_q}")
        dx[mode] = xt.grad
    if any(q.values.grad is not None or q.scales.grad is not None for q in stacks):
        raise AssertionError("frozen base: a carrier or scale got a gradient")
    rel = ((dx["kernels"].float() - dx["plain"].float()).norm() / dx["plain"].float().norm()).item()
    res = {"tokens": T, "dx_rel_l2": rel, "dx_row_err": row_scaled_err(dx["kernels"],
                                                                       dx["plain"].float()),
           "launches": launches, "carriers_without_grad": True}
    log(f"[moe-train-parity] frozen int8 base, one Mixtral layer's experts, {T} tokens: "
        f"{json.dumps(res)}")
    if not torch.isfinite(dx["kernels"].float()).all() or rel > GRAD_LEAF_TOL:
        raise AssertionError(f"frozen base: dx differs from the plain run's: {res}")
    del dx
    res["forward"] = frozen_forward_case(stacks[0], device)
    del stacks
    torch.cuda.empty_cache()
    return res, launches


def frozen_forward_case(q, device):
    """The frozen base's forward through its int8 w1 carriers ``q`` at 8192
    rows (phase 19's routing, 64-row tiles): the forward ring, held against
    the plain version (the zeroed-tile check), two runs equal bit for bit,
    rows past the used tiles zero; timed beside the first design (x at an
    unaligned base), the plain version, dequantize + ``torch._grouped_mm``
    (the same function) and ``torch._grouped_mm`` on the dequantized
    stack, and the bound. → row."""
    from deepspeed_tpu_torch.ops.kernels import grouped_matmul as gm
    from deepspeed_tpu_torch.ops.kernels.flash_attention import row_scaled_err
    from deepspeed_tpu_torch.ops.kernels.fused_quant_matmul import dequantize_grouped
    sizes, dst, te, used, Mp, tm = moe_train_layout(device)
    n, (E, K, N) = int(sizes.sum()), q.values.shape
    g = torch.Generator(device=device).manual_seed(23)
    x = torch.zeros((Mp, K), dtype=torch.bfloat16, device=device)
    x[dst] = torch.randn(n, K, generator=g, device=device).to(torch.bfloat16)
    name = "gmm_quant int8 w1 frozen base"
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)

    def run(xx):
        return gm.gmm_quant(xx, q.values, q.scales, te, q.scheme, torch.bfloat16, tm, used)

    qd = quant_designs()
    got, again = run(x), run(x)
    want = gm.gmm_quant_ref(x, q.values, q.scales, te, q.scheme, torch.bfloat16, tm, used)
    torch.cuda.synchronize()
    if quant_grew(qd) != {"wgmma": 2, "stream": 0, "general": 0}:
        raise AssertionError(f"{name}: launches by design {quant_grew(qd)}, want 2 on wgmma")
    busiest = int(sizes.argmax())
    start = int(((sizes[:busiest] + tm - 1) // tm * tm).sum())
    zeroed = got.clone()
    zeroed[start:start + 64] = 0
    err, zerr = row_scaled_err(got, want.float()), row_scaled_err(zeroed, want.float())
    if err > QUANT_TOL or zerr <= QUANT_TOL or not torch.equal(got, again) or \
            got[int(used) * tm:].any():
        raise AssertionError(f"{name}: row_scaled_err {err} (limit {QUANT_TOL}), zeroed tile "
                             f"{zerr}, or two runs differ, or rows past the used tiles not zero")
    xm = unaligned_copy(x)
    first = run(xm)
    ferr = row_scaled_err(first, want.float())
    if ferr > QUANT_TOL:
        raise AssertionError(f"{name}: the first design's row_scaled_err {ferr}")
    touched = [e for e in range(E) if int(sizes[e])]
    b_ms, b_by = bound(carrier_bytes(q, touched) + 2 * n * (K + N), 2 * n * K * N)
    row = {"case": "int8_w1_frozen_base", "scheme": q.scheme, "rows": n, "tm": tm, "K": K,
           "N": N, "design": "wgmma", "max_abs_err": max_abs(got, want), "row_err": err,
           "zeroed_tile_row_err": zerr, "deterministic": True,
           "ms": time_ms(lambda: run(x), flush), "first_design_ms": time_ms(lambda: run(xm), flush),
           "first_design_row_err": ferr,
           "plain_ms": time_ms(lambda: gm.gmm_quant_ref(x, q.values, q.scales, te, q.scheme,
                                                        torch.bfloat16, tm, used), flush, iters=3),
           "bound_ms": b_ms, "bound_by": b_by, "flops": 2 * n * K * N}
    xs = x[dst]
    offs = torch.cumsum(sizes, 0).to(torch.int32)

    def dequant_grouped_mm():
        w = dequantize_grouped(q.values, q.scales, q.scheme, torch.bfloat16)
        return torch._grouped_mm(xs, w.transpose(-2, -1).contiguous().transpose(-2, -1),
                                 offs=offs)

    if hasattr(torch, "_grouped_mm"):
        row.update(library_ms=time_ms(dequant_grouped_mm, flush, iters=5),
                   library_call="dequantize_grouped + torch._grouped_mm")
    else:
        row.update(library_ms=None, library_call="none in this torch")
    w_bf16 = dequantize_grouped(q.values, q.scales, q.scheme, torch.bfloat16)
    stack = grouped_library(xs, w_bf16, sizes, flush)
    row.update(bf16_stack_library_ms=stack["library_ms"],
               bf16_stack_library_call=stack["library_call"])
    log(f"[moe-train-parity] {name} forward {json.dumps(row)}")
    del x, xm, got, again, want, zeroed, first, w_bf16, flush
    return row


# ---------------------------------------------------------------- phase 21
def active_params(model):
    """(total, active): active counts the attention, norms, embedding, head
    and router whole and k/E of the expert stacks (``bench_train_moe``)."""
    cfg = model.config
    total = sum(p.numel() for p in model.parameters())
    experts = sum(p.numel() for n, p in model.named_parameters() if "experts_w" in n)
    return total, total - experts + experts * cfg.moe_top_k // cfg.moe_num_experts


def set_moe_mode(model, remat_policy=None, drop_tokens=None):
    """Switch the model's remat policy or MoE routing in place, weights
    and optimizer state kept."""
    import dataclasses
    cfg = model.config
    cfg = dataclasses.replace(cfg, remat_policy=remat_policy or cfg.remat_policy,
                              moe_drop_tokens=cfg.moe_drop_tokens if drop_tokens is None
                              else drop_tokens)
    model.config = model.model.config = cfg
    for block in model.model.layers:
        layer = block.moe_mlp.deepspeed_moe
        layer.drop_tokens = layer.gate.drop_tokens = cfg.moe_drop_tokens


def timed_steps(engine, batch, n):
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        loss = engine.train_batch(batch=batch)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0, loss.item()))
    return out


def mixtral_training_phase(device):
    """Phase 21: Mixtral-8x7B at its widths, 2 of 32 layers (3.17 B
    params), through ``initialize`` → ``train_batch``: bf16 with the fp32
    master, Adam, dropless, remat "moe", B 2 x S 2048, gas 2, one seeded
    batch; 1 warm-up and 3 timed steps, a profiled step, then a step each
    (after a warm-up) with remat "full" and with capacity routing."""
    import deepspeed_tpu_torch
    t0 = time.perf_counter()
    model = moe_train_model(device, 0)
    cfg, L = model.config, MOE_TRAIN_LAYERS
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=train_config(MB, MGAS),
                                                device=device)
    total, active = active_params(model)
    torch.cuda.synchronize()
    log(f"[moe-training] mixtral-8x7b width, {L} of 32 layers: {total / 1e9:.4f} B params "
        f"({active / 1e9:.4f} B active), built in {time.perf_counter() - t0:.2f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB after initialize")
    batch = moe_batch(cfg.vocab_size, device, MB, MS, MGAS)
    auxes = aux_recorder(model)
    counters = moe_train_counters()
    for f in counters.values():
        f.launches = 0
    designs = gemm_designs()
    warm = timed_steps(engine, batch, 1)
    torch.cuda.reset_peak_memory_stats()
    steps = timed_steps(engine, batch, 3)
    launches = {k: f.launches for k, f in counters.items()}
    want = {k: 4 * v for k, v in moe_train_launches(L, MGAS, "moe").items()}
    if launches != want:
        raise AssertionError(f"moe training: launches {launches} over 4 steps, want {want}")
    n = 4 * 3 * L * MGAS  # every tm 64 GEMM on the wgmma design
    check_designs(designs, {"fwd": n, "dx": n, "dw": n}, "moe training")
    flash_design_launches(launches, "moe-training")
    losses = [l for _, l in warm + steps]
    aux = [a.item() for a in auxes]
    if not all(math.isfinite(x) for x in losses + aux) or not losses[-1] < losses[0] \
            or not min(aux) > 0:
        raise AssertionError(f"moe training: losses {losses}, aux {aux}")
    if any(torch.isnan(p).any().item() for p in model.parameters()):
        raise AssertionError("moe training: NaN in a parameter")
    tokens = MB * MGAS * MS
    mean_s = float(np.mean([s for s, _ in steps]))
    res = {"layers": L, "params": total, "active_params": active, "micro_batch": MB,
           "gas": MGAS, "seq": MS, "tokens_per_step": tokens, "losses": losses,
           "aux_losses": aux, "step_ms": [s * 1e3 for s, _ in steps], "ms_per_step": mean_s * 1e3,
           "tokens_per_sec": tokens / mean_s,
           "active_mfu": model_flops(active, tokens, L, MS, cfg.hidden_size) / mean_s
           / BF16_FLOPS_PER_S,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches_per_step": moe_train_launches(L, MGAS, "moe"), "launches": launches,
           "grad_norm": engine.global_grad_norm}
    log(f"[moe-training] {json.dumps(res)}")
    res["profile"] = profile_train_step(engine, batch)
    for name, kw, policy in (("remat_full", dict(remat_policy="full"), "full"),
                             ("capacity", dict(remat_policy="moe", drop_tokens=True), None)):
        set_moe_mode(model, **kw)
        for f in counters.values():
            f.launches = 0
        designs = gemm_designs()
        (s0, l0), (s1, l1) = timed_steps(engine, batch, 2)
        n = 2 * 3 * L * MGAS if policy is not None else 0
        check_designs(designs, {"fwd": 2 * n if policy == "full" else n, "dx": n, "dw": n},
                      f"moe training {name}")
        got = {k: f.launches for k, f in counters.items()}
        if policy is not None and got != {k: 2 * v for k, v in
                                          moe_train_launches(L, MGAS, policy).items()}:
            raise AssertionError(f"moe training {name}: launches {got}")
        if policy is None and (got["gmm"] or got["gmm_dw"]):
            raise AssertionError(f"moe training {name}: the capacity path launched {got}")
        if not (math.isfinite(l0) and math.isfinite(l1)):
            raise AssertionError(f"moe training {name}: losses {l0}, {l1}")
        res[name] = {"ms_per_step": s1 * 1e3, "tokens_per_sec": tokens / s1,
                     "active_mfu": model_flops(active, tokens, L, MS, cfg.hidden_size) / s1
                     / BF16_FLOPS_PER_S, "losses": [l0, l1], "launches_per_step":
                     {k: v // 2 for k, v in got.items()}}
        log(f"[moe-training] {name}: {json.dumps(res[name])}")
    engine.destroy()
    del model, engine
    gc.collect()
    torch.cuda.empty_cache()
    return res, launches


# ---------------------------------------------------------------- phase 22
def bench_train_moe_phase(device):
    """Phase 22: ``bench.py``'s ``bench_train_moe`` shape (8 layers, hidden
    768, I 2048, 12 heads, 8 experts, top-2, S 1024, B 4, gas 32, bf16,
    Adam, ZeRO-3, remat "moe"), dropless: one warm-up and one timed step;
    tokens/s and active MFU as that lane reports them."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import build_llama
    model = build_llama("160m", device=device, hidden_size=BENCH_MOE_HIDDEN,
                        intermediate_size=BENCH_MOE_INTER, num_hidden_layers=BENCH_MOE_LAYERS,
                        num_attention_heads=BENCH_MOE_HEADS, num_key_value_heads=BENCH_MOE_HEADS,
                        max_position_embeddings=BENCH_MOE_S, moe_num_experts=8, moe_top_k=2,
                        moe_drop_tokens=False, remat_policy="moe",
                        generator=torch.Generator(device=device).manual_seed(0))
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=model, config=train_config(BENCH_MOE_B, BENCH_MOE_GAS), device=device)
    rng = np.random.RandomState(0)
    ids = torch.from_numpy(rng.randint(0, model.config.vocab_size, size=(
        BENCH_MOE_GAS, BENCH_MOE_B, BENCH_MOE_S)).astype(np.int32)).to(device)
    (_, l0), (dt, loss) = timed_steps(engine, (ids, ids), 2)
    total, active = active_params(model)
    tokens = BENCH_MOE_B * BENCH_MOE_GAS * BENCH_MOE_S
    if not (math.isfinite(l0) and math.isfinite(loss)):
        raise AssertionError(f"bench_train_moe: losses {l0}, {loss}")
    res = {"params_total": total, "params_active": active, "step_ms": dt * 1e3,
           "tokens_per_sec": tokens / dt, "loss": loss,
           "active_mfu": model_flops(active, tokens, BENCH_MOE_LAYERS, BENCH_MOE_S,
                                     BENCH_MOE_HIDDEN) / dt / BF16_FLOPS_PER_S}
    log(f"[bench-train-moe] dropless: {json.dumps(res)}")
    engine.destroy()
    del model, engine
    gc.collect()
    torch.cuda.empty_cache()
    return res


# ------------------------------------------------------------ phases 23-25
def bigbird_layout(H, S, block=64, per_head=False):
    from deepspeed_tpu_torch.ops.sparse_attention import BigBirdSparsityConfig
    kw = {k: v for k, v in BIGBIRD.items() if k not in ("mode", "block")}
    return BigBirdSparsityConfig(num_heads=H, block=block, different_layout_per_head=per_head,
                                 **kw).make_layout(S)


def unreached_layout(H, n):
    """Per-head layouts over n blocks with an empty row (2) and a key block
    no row admits (n - 2); every other row admits block 0 and itself, row 0
    the first n - 2 blocks (``test_ragged_rows_and_empty_row`` at scale)."""
    layout = np.zeros((H, n, n), bool)
    for r in range(n):
        if r != 2:
            layout[:, r, [0, r if r != n - 2 else n - 1]] = True
    layout[:, 0, :n - 2] = True
    layout[1:, 1, 3] = True
    return layout


def sparse_case_rows(name, B, S, H, D, block, layout, device, flush, timed):
    """K8's three kernels on one case against their plain versions → result
    rows; ``timed`` adds the plain versions, SDPA over the expanded mask and
    K1 non-causal at the same shape."""
    from deepspeed_tpu_torch.ops.kernels import block_sparse_attention as bsa
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    F = torch.nn.functional
    c = flash_case(230 + len(name), B, S, H, D, False, 0, device)
    q, k, v, do = c["q"], c["k"], c["v"], c["do"]
    full = bsa.full_layout(layout, H, S, block)
    design, before = bsa.bsa_design(block, D), bsa_designs()
    o, lse = bsa.block_sparse_fwd(q, k, v, layout, block)
    delta = fa.flash_delta(o, do)  # the backward runs on this design's o and lse
    dq = bsa.block_sparse_dq(q, k, v, do, lse, delta, layout, block)
    dk, dv = bsa.block_sparse_dkv(q, k, v, do, lse, delta, layout, block)
    torch.cuda.synchronize()
    grew = bsa_grew(before)
    if grew != {key: {d: int(d == design) for d in by} for key, by in grew.items()}:
        raise AssertionError(f"block-sparse case {name}: launches by design {grew}, want one "
                             f"each on {design}")
    first = {}  # the first design on the same inputs, where the wgmma design takes the case
    first_lse = None
    if design == "wgmma":
        first["o"], first_lse = bsa.block_sparse_fwd(q, k, v, layout, block, design="first")
        first["dq"] = bsa.block_sparse_dq(q, k, v, do, lse, delta, layout, block, design="first")
        first["dk"], first["dv"] = bsa.block_sparse_dkv(q, k, v, do, lse, delta, layout, block,
                                                        design="first")
        again = (*bsa.block_sparse_fwd(q, k, v, layout, block),
                 bsa.block_sparse_dq(q, k, v, do, lse, delta, layout, block),
                 *bsa.block_sparse_dkv(q, k, v, do, lse, delta, layout, block))
        if not all(torch.equal(a, b) for a, b in zip(again, (o, lse, dq, dk, dv))):
            raise AssertionError(f"block-sparse case {name}: the wgmma design's second run "
                                 f"differs from its first")
    o_ref, lse_ref = bsa.block_sparse_fwd_ref(q, k, v, layout, block)
    dq_ref = bsa.block_sparse_dq_ref(q, k, v, do, lse, delta, layout, block)
    dk_ref, dv_ref = bsa.block_sparse_dkv_ref(q, k, v, do, lse, delta, layout, block)
    live = torch.from_numpy(full.any(-1)).to(q.device).repeat_interleave(block, 1)[None]
    reached = torch.from_numpy(full.any(-2)).to(q.device).repeat_interleave(block, 1)[None]
    live, reached = live.expand(B, -1, -1), reached.expand(B, -1, -1)   # [B, H, S]
    lse_err = (lse - lse_ref)[live].abs().max().item()
    first_lse_err = None
    if first_lse is not None:
        first_lse_err = (first_lse - lse_ref)[live].abs().max().item()
        if not torch.equal(first_lse == bsa.NEG_INF, ~live):
            raise AssertionError(f"block-sparse case {name}: the first design's lse is not "
                                 f"NEG_INF exactly on the empty rows")
    zeros_ok = (torch.equal(lse == bsa.NEG_INF, ~live)
                and bool((o.transpose(1, 2)[~live] == 0).all())
                and bool((dq.transpose(1, 2)[~live] == 0).all())
                and bool((dk.transpose(1, 2)[~reached] == 0).all())
                and bool((dv.transpose(1, 2)[~reached] == 0).all()))
    outs = {"o": (o, o_ref), "dq": (dq, dq_ref), "dk": (dk, dk_ref), "dv": (dv, dv_ref)}
    outs.update({f"first_{t}": (got, outs[t][1]) for t, got in first.items()})
    zeros_ok = zeros_ok and all(bool((got.transpose(1, 2)[~(live if t in ("o", "dq") else
                                                             reached)] == 0).all())
                                for t, got in first.items())
    errs = {t: fa.row_scaled_err(got, ref) for t, (got, ref) in outs.items()}
    abs_errs = {t: max_abs(got, ref) for t, (got, ref) in outs.items()}
    zeroed = {}
    for t, (got, ref) in outs.items():
        y = got.clone()
        y[:, :block] = 0  # query row 0 and key block 0 are admitted in every case
        zeroed[t] = fa.row_scaled_err(y, ref)
    # the forward's last 64-row tile (its last item's last consumer; the last
    # query block is admitted in every case) zeroed
    zeroed_last = {t: fa.row_scaled_err(zero_last_tile(got), ref) for t, (got, ref) in outs.items()
                   if t in ("o", "first_o")}
    del outs, o_ref, dq_ref, dk_ref, dv_ref, first
    if max(errs.values()) > ROW_TOL or max(lse_err, first_lse_err or 0.0) > LSE_TOL \
            or not zeros_ok:
        raise AssertionError(f"block-sparse case {name}: errors {errs} (limit {ROW_TOL}), lse "
                             f"{lse_err} (limit {LSE_TOL}), empty rows and unreached blocks "
                             f"zero: {zeros_ok}")
    if min(zeroed.values()) <= ROW_TOL or min(zeroed_last.values()) <= ROW_TOL:
        raise AssertionError(f"block-sparse case {name}: the check passes a zeroed block: "
                             f"{zeroed}, the forward's last tile {zeroed_last}")
    admitted = int(full.sum())                 # admitted (head, row, key block) triples
    pairs = B * admitted * block * block       # (query, key) pairs over the batch
    act, stats = B * S * H * D * 2, B * H * S * 4
    sched = bsa.schedule(full, q.device)
    lists = sum(t.numel() * 4 for t in sched.k[:3])
    qlists = sum(t.numel() * 4 for t in sched.q[:3])
    shape = {"case": name, "B": B, "S": S, "H": H, "Dh": D, "block": block,
             "density": float(full.mean()), "empty_rows": int((~full.any(-1)).sum()),
             "unreached_key_blocks": int((~full.any(-2)).sum())}
    cost = {"block_sparse_fwd": (4 * act + stats + lists, 4 * D * pairs),
            "block_sparse_dq": (5 * act + 2 * stats + lists, 6 * D * pairs),
            "block_sparse_dkv": (6 * act + 2 * stats + qlists, 8 * D * pairs)}
    calls = {"block_sparse_fwd": (lambda design=None: bsa.block_sparse_fwd(
                                      q, k, v, layout, block, design=design),
                                  lambda: bsa.block_sparse_fwd_ref(q, k, v, layout, block)),
             "block_sparse_dq": (lambda design=None: bsa.block_sparse_dq(
                                     q, k, v, do, lse, delta, layout, block, design=design),
                                 lambda: bsa.block_sparse_dq_ref(q, k, v, do, lse, delta,
                                                                 layout, block)),
             "block_sparse_dkv": (lambda design=None: bsa.block_sparse_dkv(
                                      q, k, v, do, lse, delta, layout, block, design=design),
                                  lambda: bsa.block_sparse_dkv_ref(q, k, v, do, lse, delta,
                                                                   layout, block))}
    err_of = {"block_sparse_fwd": ("o",), "block_sparse_dq": ("dq",),
              "block_sparse_dkv": ("dk", "dv")}
    lib = {}
    if timed:
        mask = bsa.block_mask(full, block, q.device)[None]           # [1, H, S, S] bool
        sq, sk, sv = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
        sdo = do.transpose(1, 2)

        def sdpa():
            return F.scaled_dot_product_attention(sq, sk, sv, attn_mask=mask)

        s_out = sdpa()
        lib["bwd"] = time_ms(lambda: torch.autograd.grad(s_out, (sq, sk, sv), sdo,
                                                         retain_graph=True), flush)
        with torch.no_grad():
            lib["fwd"] = time_ms(sdpa, flush)
        del s_out, sq, sk, sv, mask
        dense = {"flash_fwd_ms": time_ms(lambda: fa.flash_fwd(q, k, v, None, False), flush)}
        fo, flse = fa.flash_fwd(q, k, v, None, False)
        fdelta = fa.flash_delta(fo, do)
        dense["flash_bwd_dq_ms"] = time_ms(
            lambda: fa.flash_bwd_dq(q, k, v, do, flse, fdelta, None, False), flush)
        dense["flash_bwd_dkv_ms"] = time_ms(
            lambda: fa.flash_bwd_dkv(q, k, v, do, flse, fdelta, None, False), flush)
        del fo, flse, fdelta
        log(f"[sparse-kernels] K1 non-causal at {name}'s shape (the dense work): "
            f"{json.dumps(dense)}")
    rows = {}
    for key, (nb, nf) in cost.items():
        b_ms, b_by = bound(nb, nf)
        fn, plain = calls[key]
        row = dict(shape, max_abs_err=max(abs_errs[t] for t in err_of[key]),
                   row_err=max(errs[t] for t in err_of[key]),
                   zeroed_tile_row_err=min(zeroed[t] for t in err_of[key]),
                   ms=time_ms(fn, flush), bound_ms=b_ms, bound_by=b_by, bytes=nb, flops=nf,
                   design=design, launches_by_design=grew[key])
        if key == "block_sparse_fwd":
            row.update(lse_abs_err=lse_err, first_design_lse_abs_err=first_lse_err,
                       zeroed_last_tile_row_err=zeroed_last["o"])
        if design == "wgmma":  # timed beside the first design
            row.update(repeat_bitwise=True,
                       first_design_max_abs_err=max(abs_errs["first_" + t] for t in err_of[key]),
                       first_design_row_err=max(errs["first_" + t] for t in err_of[key]),
                       first_design_zeroed_tile_row_err=min(zeroed["first_" + t]
                                                            for t in err_of[key]),
                       first_design_ms=time_ms(functools.partial(fn, design="first"), flush))
        if timed:
            row.update(plain_ms=time_ms(plain, flush),
                       library_ms=lib["fwd" if key == "block_sparse_fwd" else "bwd"],
                       library_call=("scaled_dot_product_attention forward, boolean [H, S, S] "
                                     "layout mask" if key == "block_sparse_fwd" else
                                     "scaled_dot_product_attention backward (dq, dk, dv), "
                                     "boolean [H, S, S] layout mask"),
                       library_fwd_plus_bwd_ms=lib["fwd"] + lib["bwd"])
        rows[key] = row
    return rows


def bsa_designs():
    """K8's launches so far by kernel and design."""
    from deepspeed_tpu_torch.ops.kernels.block_sparse_attention import bsa_design_launches
    return {k: dict(v) for k, v in bsa_design_launches.items()}


def bsa_grew(before):
    return {k: {d: n - before[k][d] for d, n in v.items()} for k, v in bsa_designs().items()}


def bsa_on_wgmma(grew, want, where):
    """Fails unless each of K8's kernels (forward, dQ, dK/dV) launched
    ``want`` times, all on the wgmma design; logs the launches by design
    under ``where``."""
    log(f"[{where}] K8 launches by design: {json.dumps(grew)}")
    if grew != {k: {"wgmma": want, "first": 0} for k in grew}:
        raise AssertionError(f"{where}: K8 launches by design {grew}, want {want} each on the "
                             f"wgmma design")


def sparse_kernel_phase(device, flush):
    """Phase 23: K8's three kernels and the LayerNorm forward."""
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    from deepspeed_tpu_torch.ops.kernels.fused_norms import layer_norm_fwd, layer_norm_ref
    F = torch.nn.functional
    out = {"block_sparse_fwd": [], "block_sparse_dq": [], "block_sparse_dkv": [],
           "layer_norm_fwd": []}
    from deepspeed_tpu_torch.ops.kernels.block_sparse_attention import bsa_design
    for name, (B, S, H, D, block, kind) in SPARSE_CASES.items():
        layout = (unreached_layout(H, S // block) if kind == "unreached" else
                  bigbird_layout(H, S, block, per_head=kind == "bigbird_per_head"))
        for key, row in sparse_case_rows(name, B, S, H, D, block, layout, device, flush,
                                         timed=bsa_design(block, D) == "wgmma").items():
            log(f"[sparse-kernels] {key} {json.dumps(row)}")
            out[key].append(row)
        torch.cuda.empty_cache()

    rows, D = BERT_B * BERT_S, 1024
    g = torch.Generator(device=device).manual_seed(rows)
    x = (torch.randn(rows, D, generator=g, device=device) * 3 + 1).to(torch.bfloat16)
    scale = (1 + 0.1 * torch.randn(D, generator=g, device=device)).to(torch.bfloat16)
    bias = (0.1 * torch.randn(D, generator=g, device=device)).to(torch.bfloat16)
    got = layer_norm_fwd(x, scale, bias, 1e-12)
    want = layer_norm_ref(x.float(), scale.float(), bias.float(), 1e-12)
    torch.cuda.synchronize()
    zeroed = got.clone()
    zeroed[-64:] = 0
    err, zerr = fa.row_scaled_err(got, want), fa.row_scaled_err(zeroed, want)
    if err > LN_TOL or zerr <= LN_TOL:
        raise AssertionError(f"layer norm: {err} units (limit {LN_TOL}); zeroed tile {zerr}")
    nb = 2 * x.numel() * 2 + 2 * D * 2
    b_ms, b_by = bound(nb, 8 * x.numel())
    row = {"case": "path", "rows": rows, "D": D, "row_err": err, "zeroed_tile_row_err": zerr,
           "max_abs_err": (got.float() - want).abs().max().item(),
           "ms": time_ms(lambda: layer_norm_fwd(x, scale, bias, 1e-12), flush),
           "plain_ms": time_ms(lambda: layer_norm_ref(x, scale, bias, 1e-12), flush),
           "library_ms": time_ms(lambda: F.layer_norm(x, (D,), scale, bias, 1e-12), flush),
           "library_call": "torch.nn.functional.layer_norm",
           "bound_ms": b_ms, "bound_by": b_by, "bytes": nb, "flops": 8 * x.numel()}
    log(f"[sparse-kernels] layer_norm_fwd {json.dumps(row)}")
    out["layer_norm_fwd"].append(row)
    return out


def bert_counters():
    from deepspeed_tpu_torch.ops.kernels import block_sparse_attention as bsa
    from deepspeed_tpu_torch.ops.kernels.fused_norms import layer_norm_fwd
    return {"block_sparse_fwd": bsa.block_sparse_fwd, "block_sparse_dq": bsa.block_sparse_dq,
            "block_sparse_dkv": bsa.block_sparse_dkv, "layer_norm_fwd": layer_norm_fwd}


K8_CATEGORY = "block_sparse_attention (K8)"


@contextlib.contextmanager
def first_bsa_design():
    """Pin K8's three kernels to their first design: ``bsa_design``, which
    the wrappers ask when the caller names no design, names it everywhere."""
    from deepspeed_tpu_torch.ops.kernels import block_sparse_attention as bsa
    saved = bsa.bsa_design
    bsa.bsa_design = lambda block, D: "first"
    try:
        yield
    finally:
        bsa.bsa_design = saved


def bert_model(device, layers, seed, sparse=True):
    """bert-large at ``layers`` of 24, random weights from ``seed``, on the
    path: positions tiled from 512 to BERT_S and BigBird block 64 by
    ``replace_model_self_attention_with_sparse_self_attention``; without
    ``sparse`` the dense model with a BERT_S table."""
    from deepspeed_tpu_torch.models import build_bert
    from deepspeed_tpu_torch.ops.sparse_attention import SparseAttentionUtils
    g = torch.Generator(device=device).manual_seed(seed)
    if not sparse:
        return build_bert("bert-large", device=device, generator=g, num_hidden_layers=layers,
                          max_position_embeddings=BERT_S)
    model = build_bert("bert-large", device=device, generator=g, num_hidden_layers=layers)
    return SparseAttentionUtils.replace_model_self_attention_with_sparse_self_attention(
        model, max_position=BERT_S, ds_config={"sparse_attention": BIGBIRD})


def bert_batch(vocab, B, gas, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    ids = torch.randint(0, vocab, (B * gas, BERT_S), generator=g, device=device,
                        dtype=torch.int32)
    return ids, ids.clone()


@contextlib.contextmanager
def plain_bert_kernels():
    """Pin BERT's block-sparse attention and LayerNorm to the plain versions
    (autograd through ``block_sparse_attention_ref`` and ``layer_norm_ref``)."""
    from deepspeed_tpu_torch.models import bert
    from deepspeed_tpu_torch.ops.kernels import block_sparse_attention as bsa
    from deepspeed_tpu_torch.ops.kernels.fused_norms import layer_norm_ref
    saved = bsa.block_sparse_attention, bert.fused_layer_norm
    bsa.block_sparse_attention, bert.fused_layer_norm = bsa.block_sparse_attention_ref, \
        layer_norm_ref
    try:
        yield
    finally:
        bsa.block_sparse_attention, bert.fused_layer_norm = saved


def bert_parity_phase(device):
    """Phase 24: a 2-layer bert-large-width step through the kernels and
    pinned to the plain versions, from the same weights and batch."""
    import deepspeed_tpu_torch
    from torch.profiler import ProfilerActivity, profile
    from deepspeed_tpu_torch.ops.kernels.flash_attention import row_scaled_err
    L, B, gas = 2, BERT_PARITY_B, BERT_GAS
    results = {}
    for mode in ("kernels", "plain"):
        model = bert_model(device, L, seed=24)
        engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=train_config(B, gas),
                                                    device=device)
        names = [n for n, p in model.named_parameters() if p.requires_grad]
        grads = capture_grads(engine, to_host=True)
        counters = bert_counters()
        for fn in counters.values():
            fn.launches = 0
        designs = bsa_designs()
        batch = bert_batch(model.config.vocab_size, B, gas, device)
        if mode == "plain":
            with plain_bert_kernels():
                loss = engine.train_batch(batch=batch)
        else:  # profiled: K8's device ms by kernel
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                loss = engine.train_batch(batch=batch)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            k8 = _summarize(prof, wall_ms, 1, K8_CATEGORY)
        torch.cuda.synchronize()
        launched = {k: fn.launches for k, fn in counters.items()}
        want = ({"block_sparse_fwd": L * gas, "block_sparse_dq": L * gas,
                 "block_sparse_dkv": L * gas, "layer_norm_fwd": (2 * L + 2) * gas}
                if mode == "kernels" else dict.fromkeys(counters, 0))
        if launched != want:
            raise AssertionError(f"bert parity {mode}: launches {launched}, want {want}")
        bsa_on_wgmma(bsa_grew(designs), want["block_sparse_dq"], f"bert-parity {mode}")
        results[mode] = (loss.item(), engine.global_grad_norm, grads)
        engine.destroy()
        del model, engine
        gc.collect()
        torch.cuda.empty_cache()
    (lk, nk, gk), (lp, np_, gp) = results["kernels"], results["plain"]
    # The key projection's bias has no gradient in exact arithmetic (adding
    # q·b_k to every score of a row leaves its softmax unchanged), so both
    # runs give rounding noise there: each is held to be small against its
    # layer's query-bias gradient instead.
    gk, gp = dict(zip(names, gk)), dict(zip(names, gp))
    kbias = [n for n in names if n.endswith("k_proj.bias")]
    kbias_vs_q = {f"{n} {mode}": (g[n].norm() / g[n.replace("k_proj", "q_proj")].norm()).item()
                  for n in kbias for mode, g in (("kernels", gk), ("plain", gp))}
    held = [n for n in names if n not in kbias]
    leaf = {n: ((gk[n] - gp[n]).norm() / gp[n].norm()).item() for n in held}
    rows = {n: row_scaled_err(gk[n].reshape(-1, gk[n].shape[-1]), gp[n].reshape(-1, gp[n].shape[-1]))
            for n in held}
    res = {"layers": L, "micro_batch": B, "gas": gas, "seq": BERT_S,
           "loss_kernels": lk, "loss_plain": lp, "loss_rel_diff": abs(lk - lp) / abs(lp),
           "grad_norm_kernels": nk, "grad_norm_plain": np_,
           "grad_norm_rel_diff": abs(nk - np_) / np_,
           "leaf_grad_rel_diff_max": max(leaf.values()),
           "leaf_grad_rel_diff_worst": max(leaf, key=leaf.get),
           "leaf_grad_row_err_max": max(rows.values()),
           "leaf_grad_row_err_worst": max(rows, key=rows.get),
           "k_bias_grad_vs_q_bias_max": max(kbias_vs_q.values()),
           "k_bias_grad_vs_q_bias": kbias_vs_q,
           "k8_device_ms": k8["by_category_ms"].get(K8_CATEGORY),
           "k8_by_kernel_ms": k8["by_kernel_ms"], "kernels_step_device_ms": k8["device_ms"],
           "leaf_grad_rel_diff": leaf, "leaf_grad_row_err": rows}
    log(f"[bert-parity] 2-layer bert-large width, BigBird block 64, B {B}, gas {gas}, "
        f"S {BERT_S}: {json.dumps(res)}")
    if not (math.isfinite(lk) and math.isfinite(lp)) or res["loss_rel_diff"] > BERT_LOSS_TOL \
            or max(leaf.values()) > GRAD_LEAF_TOL or max(rows.values()) > BERT_GRAD_ROW_TOL \
            or max(kbias_vs_q.values()) > GRAD_LEAF_TOL:
        raise AssertionError(f"bert parity over its limits: loss {res['loss_rel_diff']}, leaf "
                             f"{res['leaf_grad_rel_diff_max']} ({res['leaf_grad_rel_diff_worst']})"
                             f", rows {res['leaf_grad_row_err_max']} "
                             f"({res['leaf_grad_row_err_worst']}), key bias "
                             f"{res['k_bias_grad_vs_q_bias_max']}")
    return res


def k8_split(by_kernel_ms):
    """K8's device ms of a profiled step by kernel (``_summarize``'s
    ``by_kernel_ms``) → the forward's, dQ's and dK/dV's, over both designs."""
    out = {"forward": 0.0, "dq": 0.0, "dkv": 0.0}
    for name, ms in by_kernel_ms.items():
        out["forward" if "bsa_fwd" in name else "dq" if "bsa_dq" in name else "dkv"] += ms
    return out


def bert_training_phase(device):
    """Phase 25: bert-large at S 4096 with BigBird block 64, 4 steps, then
    the dense model (K1 non-causal) for its step time and peak."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    t0 = time.perf_counter()
    model = bert_model(device, 24, seed=25)
    cfg = model.config
    L, B, gas, S = cfg.num_hidden_layers, BERT_B, BERT_GAS, BERT_S
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=train_config(B, gas),
                                                device=device)
    n_params = sum(p.numel() for p in model.parameters())
    density = grid_fraction_of(cfg)
    torch.cuda.synchronize()
    log(f"[bert-training] bert-large: {n_params / 1e9:.4f} B params, {L} layers, positions "
        f"{model.model.embed_positions.shape[0]}, BigBird density {density}, built in "
        f"{time.perf_counter() - t0:.2f} s")
    batch = bert_batch(cfg.vocab_size, B, gas, device)
    counters = bert_counters()
    per_step = {"block_sparse_fwd": L * gas, "block_sparse_dq": L * gas,
                "block_sparse_dkv": L * gas, "layer_norm_fwd": (2 * L + 2) * gas}
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    designs = bsa_designs()
    steps = timed_steps(engine, batch, 4)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    for k, n in launches.items():
        if n != 4 * per_step[k]:
            raise AssertionError(f"{k}: {n} launches over 4 steps, want 4 x {per_step[k]}")
    by_design = bsa_grew(designs)
    bsa_on_wgmma(by_design, 4 * per_step["block_sparse_dq"], "bert-training")
    losses = [loss for _, loss in steps]
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"bert losses not finite and falling: {losses}")
    if any(torch.isnan(p).any().item() for p in model.parameters()):
        raise AssertionError("NaN in a parameter after training")
    tokens = B * gas * S
    mean_s = float(np.mean([dt for dt, _ in steps[1:]]))
    attn_term = 12.0 * L * S * cfg.hidden_size * tokens
    res = {"layers": L, "params": n_params, "micro_batch": B, "gas": gas, "seq": S,
           "tokens_per_step": tokens, "losses": losses,
           "step_ms": [dt * 1e3 for dt, _ in steps], "ms_per_step": mean_s * 1e3,
           "tokens_per_sec": tokens / mean_s,
           "mfu": model_flops(n_params, tokens, L, S, cfg.hidden_size) / mean_s
           / BF16_FLOPS_PER_S,
           "attention_flops_dense_term": attn_term, "layout_density": density,
           "attention_flops_admitted": density * attn_term,
           "mfu_with_admitted_attention": (6.0 * n_params * tokens + density * attn_term)
           / mean_s / BF16_FLOPS_PER_S,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches_per_step": per_step, "launches": launches,
           "k8_launches_by_design": by_design, "grad_norm": engine.global_grad_norm}
    log(f"[bert-training] sparse: {json.dumps(res)}")
    res["profile"] = profile_train_step(engine, batch, K8_CATEGORY)
    # the same steps with K8 pinned to its first design, for the step's time
    # and K8's device ms beside the wgmma design's
    with first_bsa_design():
        designs = bsa_designs()
        first_steps = timed_steps(engine, batch, 2)
        first_profile = profile_train_step(engine, batch, K8_CATEGORY)
        grew = bsa_grew(designs)
    if grew != {k: {"wgmma": 0, "first": 3 * per_step[k]} for k in grew}:
        raise AssertionError(f"bert-training, first design: K8 launches {grew}")
    res["first_design"] = {"step_ms": [dt * 1e3 for dt, _ in first_steps],
                           "ms_per_step": first_steps[-1][0] * 1e3,
                           "device_ms": first_profile["device_ms"],
                           "k8_device_ms": first_profile["by_category_ms"].get(K8_CATEGORY),
                           "k8_split_ms": k8_split(first_profile["by_kernel_ms"]),
                           "k8_by_kernel_ms": first_profile["by_kernel_ms"]}
    k8 = {"wgmma": {"ms_per_step": res["ms_per_step"],
                    "device_ms": res["profile"]["device_ms"],
                    "k8_device_ms": res["profile"]["by_category_ms"].get(K8_CATEGORY),
                    "k8_split_ms": k8_split(res["profile"]["by_kernel_ms"]),
                    "k8_by_kernel_ms": res["profile"]["by_kernel_ms"]},
          "first": res["first_design"]}
    log(f"[bert-training] K8 in the profiled step, by design: {json.dumps(k8)}")
    engine.destroy()
    del model, engine
    gc.collect()
    torch.cuda.empty_cache()

    model = bert_model(device, 24, seed=25, sparse=False)
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=train_config(B, gas),
                                                device=device)
    torch.cuda.reset_peak_memory_stats()
    flash = {"flash_fwd": fa.flash_fwd, "flash_bwd_dkv": fa.flash_bwd_dkv,
             "flash_bwd_dq": fa.flash_bwd_dq}
    f0 = {k: f.launches for k, f in flash.items()}
    dense_steps = timed_steps(engine, batch, 2)
    dense_launches = {k: f.launches - f0[k] for k, f in flash.items()}
    if dense_launches != {"flash_fwd": 2 * L * gas, "flash_bwd_dkv": 2 * L * gas,
                          "flash_bwd_dq": 2 * L * gas}:
        raise AssertionError(f"dense bert: flash launches {dense_launches} over 2 steps, want "
                             f"{2 * L * gas} each")
    flash_design_launches(dense_launches, "bert-training")
    dense = {"step_ms": [dt * 1e3 for dt, _ in dense_steps],
             "ms_per_step": dense_steps[-1][0] * 1e3,
             "tokens_per_sec": tokens / dense_steps[-1][0],
             "losses": [loss for _, loss in dense_steps],
             "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    if not all(math.isfinite(x) for x in dense["losses"]):
        raise AssertionError(f"dense bert losses not finite: {dense['losses']}")
    dense["sparse_speedup"] = dense["ms_per_step"] / res["ms_per_step"]
    log(f"[bert-training] dense (K1 non-causal): {json.dumps(dense)}")
    res["dense"] = dense
    engine.destroy()
    del model, engine
    gc.collect()
    torch.cuda.empty_cache()
    return res, launches


# ---------------------------------------------------------------- phase 26
def sampled_specs(n):
    """``bench_serving_2b_sampled``'s per-request specs: its temperature,
    top_k and top_p pattern, seed 1000 + i."""
    specs = [{"temperature": 0.7 + 0.2 * (i % 3), "top_k": 16 + 16 * (i % 2),
              "top_p": (0.9 if i % 2 else None), "seed": 1000 + i} for i in range(n)]
    return [{k: v for k, v in s.items() if v is not None} for s in specs]


def sampled_fleet(engine, uid0, prompts, specs, ntok, burst=SAMPLED_BURST):
    """``bench_serving_2b_sampled``'s ``fleet``: every prompt with its spec
    (greedy when ``specs`` is None) to completion under one scheduler; the
    requests retired after. → (seconds, streams, engine.put calls,
    engine.decode_burst calls)."""
    from deepspeed_tpu_torch.inference.v2 import DynamicSplitFuseScheduler
    calls = {"put": 0, "decode_burst": 0}
    inner = {name: getattr(engine, name) for name in calls}

    def counted(name):
        def call(*args, **kwargs):
            calls[name] += 1
            return inner[name](*args, **kwargs)
        return call
    for name in calls:
        setattr(engine, name, counted(name))
    try:
        sched = DynamicSplitFuseScheduler(engine, token_budget=SAMPLED_BUDGET, max_burst=burst)
        for i, p in enumerate(prompts):
            sched.add_request(uid0 + i, p, max_new_tokens=ntok,
                              sample=specs[i] if specs else None)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sched.run_to_completion(max_steps=100_000)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        for name in calls:
            delattr(engine, name)
    for i in range(len(prompts)):
        sched.retire(uid0 + i)
    return dt, [out[uid0 + i] for i in range(len(prompts))], calls["put"], calls["decode_burst"]


def prefill_each(engine, uids, prompts, specs=None):
    """Each prompt in a put of its own (a prompt fits the token budget, all
    of them do not), with its spec, or returning logits when ``specs`` is
    None → the puts' outputs stacked."""
    return np.concatenate([engine.put([uid], [p], sample=None if specs is None else [specs[i]])
                           for i, (uid, p) in enumerate(zip(uids, prompts))])


def host_copies_of_a_burst(engine, prompts, specs):
    """One sampled ``decode_burst`` of every request after its prefill, with
    ``Tensor.cpu`` counted on CUDA tensors and PyTorch's sync debug mode
    recording every synchronizing call. → (device→host ``cpu()`` calls,
    synchronizing calls, burst tokens)."""
    import warnings
    uids = list(range(900, 900 + len(prompts)))
    first = prefill_each(engine, uids, prompts, specs)
    cpu, copies = torch.Tensor.cpu, []

    def counted(t, *args, **kwargs):
        if t.is_cuda:
            copies.append(tuple(t.shape))
        return cpu(t, *args, **kwargs)
    torch.cuda.synchronize()
    torch.Tensor.cpu = counted
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            toks = engine.decode_burst(uids, [[int(t)] for t in first], SAMPLED_BURST,
                                       sample=specs)
    finally:
        torch.cuda.set_sync_debug_mode("default")
        torch.Tensor.cpu = cpu
    syncs = sum("synchronizing" in str(w.message) for w in caught)
    for uid in uids:
        engine.flush(uid)
    return copies, syncs, toks


def topk1_check(engine, prompt, ntok):
    """``top_k: 1`` against greedy on one prompt, stepwise over ``ntok``
    steps: request A takes the argmax of its logits (``put`` returning
    logits), request B the sampled token of ``{"temperature": 0.7,
    "top_k": 1}`` (its own puts, the same slot, bucket and positions, so
    the same logits bits). At every step B's token must be the argmax, or
    one of the tied maxima where the logits hold a tie (bf16 logits tie at
    ~4% of steps over 32000 tokens; the filter keeps every tied token and
    the Gumbel draw picks one, in JAX's sampler as here). B's token feeds
    both requests, so the check goes on past a tie. → {"steps",
    "tied_steps", "parted_steps"} (parted: B drew a tied token other than
    the first)."""
    spec = {"temperature": 0.7, "top_k": 1, "seed": 1234}
    tok = None
    tied = parted = 0
    for step in range(ntok):
        feed = prompt if tok is None else [tok]
        logits = engine.put([1], [feed])[0]
        tok = int(engine.put([2], [feed], sample=[spec])[0])
        top = np.flatnonzero(logits == logits.max())
        if tok not in top:
            raise AssertionError(f"top_k 1 drew {tok} at step {step}, the argmax set "
                                 f"is {top.tolist()}")
        tied += len(top) > 1
        parted += int(tok != top[0])
    for uid in (1, 2):
        engine.flush(uid)
    return {"steps": ntok, "tied_steps": tied, "parted_steps": parted}


def device_by_op(prof, per):
    """A profile's device activities (kernels and copies) by the aten op
    that launched them, divided by ``per`` → ({op: [launches, device µs]},
    launches, device µs). Activities that no aten op launched (the port's
    own kernels, called through ctypes) fall under "(no aten op)"; the
    profiler links some of them to runtime events such as
    ``cudaLaunchKernel``, which are not ops."""
    from torch.autograd import DeviceType
    ops, n, us = {}, 0, 0.0
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            n += 1
            us += ev.time_range.elapsed_us()
        elif ev.device_type == DeviceType.CPU and ev.name.startswith("aten::"):
            for k in ev.kernels:
                row = ops.setdefault(ev.name, [0, 0.0])
                row[0] += 1
                row[1] += k.duration
    rest = [n - sum(r[0] for r in ops.values()), us - sum(r[1] for r in ops.values())]
    if rest[0]:
        ops["(no aten op)"] = rest
    return {op: [r[0] / per, r[1] / per] for op, r in ops.items()}, n / per, us / per


def burst_profile(engine, uid0, prompts, specs):
    """One ``decode_burst`` of ``SAMPLED_BURST`` steps over every request
    after its prefill (sampled with ``specs``, greedy when None), under
    the profiler → ``device_by_op`` per forward."""
    from torch.profiler import ProfilerActivity, profile
    uids = list(range(uid0, uid0 + len(prompts)))
    first = prefill_each(engine, uids, prompts, specs)
    if specs is None:
        first = first.argmax(-1)  # the puts returned logits
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.decode_burst(uids, [[int(t)] for t in first], SAMPLED_BURST, sample=specs)
        torch.cuda.synchronize()
    for uid in uids:
        engine.flush(uid)
    return device_by_op(prof, SAMPLED_BURST)


def sampler_in_burst(engine, prompts, specs):
    """The sampler's cost on the main path: a sampled burst against a
    greedy burst of the same shape (the same prompts, positions and
    [max_seqs, vocab] logits), per forward. The model's forward is the
    same in both, so the ops whose launch counts differ are the sampler's
    less the greedy argmax. → {"by_op": {op: [launches, device µs]} (the
    difference, at those ops), "launches": the difference in all device
    launches, "device_us": the sum at those ops, "greedy_device_us",
    "sampled_device_us": the whole forward's}."""
    greedy, g_n, g_us = burst_profile(engine, 700, prompts, None)
    sampled, s_n, s_us = burst_profile(engine, 750, prompts, specs)
    by_op = {}
    for op in sorted(set(greedy) | set(sampled)):
        g, s = greedy.get(op, [0, 0.0]), sampled.get(op, [0, 0.0])
        if g[0] != s[0]:
            by_op[op] = [s[0] - g[0], s[1] - g[1]]
    return {"by_op": by_op, "launches": s_n - g_n,
            "device_us": sum(r[1] for r in by_op.values()),
            "greedy_device_us": g_us, "sampled_device_us": s_us}


def sampler_cost(logits, keys, meta, flush):
    """Cross-check of :func:`sampler_in_burst`: the sampler of one sampled
    forward alone (the position fold and ``sample_rows`` on the card's
    [max_seqs, vocab] logits), profiled over 20 calls → ({op: [launches,
    device µs]} a call, device launches a call, device µs a call, ms a call
    by CUDA events)."""
    from torch.profiler import ProfilerActivity, profile
    from deepspeed_tpu_torch.inference.structured.prng import fold_in_rows
    from deepspeed_tpu_torch.inference.structured.sampling import sample_rows
    temp, topk, topp, _, _, _ = meta
    pos = torch.arange(keys.shape[0], dtype=torch.int32, device=logits.device) + 300

    def one():
        return sample_rows(logits, fold_in_rows(keys, pos), temp, topk, topp)
    ms = time_ms(one, flush)
    one()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            one()
        torch.cuda.synchronize()
    return (*device_by_op(prof, 20), ms)


def sampled_serving_phase(device, flush):
    """Phase 26: ``bench_serving_2b_sampled``'s protocol on the Mistral-7B
    engine at SAMPLED_LAYERS layers. → (result, {kernel: launches in the
    sampled run})."""
    from deepspeed_tpu_torch.device import gpu_report
    from deepspeed_tpu_torch.inference.structured import prng
    from deepspeed_tpu_torch.inference.structured.sampling import (pack_sample_meta,
                                                                   sample_rows,
                                                                   unpack_sample_meta)
    from deepspeed_tpu_torch.inference.v2 import (DSStateManagerConfig, InferenceEngineV2,
                                                  RaggedInferenceEngineConfig)
    from deepspeed_tpu_torch.models import llama_config
    from deepspeed_tpu_torch.ops.kernels.fused_quant_matmul import dense_matmul
    from deepspeed_tpu_torch.ops.kernels.paged_attention import paged_decode_attention
    card = gpu_report()
    cfg = llama_config("mistral-7b", num_hidden_layers=SAMPLED_LAYERS)
    n, plen, ntok = SAMPLED_N_REQ, SAMPLED_PROMPT, SAMPLED_NEW
    engine = InferenceEngineV2(cfg, RaggedInferenceEngineConfig(
        kv_block_size=BS, state_manager=DSStateManagerConfig(
            max_ragged_batch_size=SAMPLED_BUDGET, max_ragged_sequence_count=n,
            max_tracked_sequences=n + 2, max_context=plen + ntok + 8)),
        device=device, generator=torch.Generator(device=device).manual_seed(0))
    free0 = engine.free_blocks
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, size=plen).astype(np.int32) for _ in range(n)]
    specs = sampled_specs(n)
    sampled_fleet(engine, 10_000, prompts, None, 8)   # greedy warm-up
    sampled_fleet(engine, 20_000, prompts, specs, 8)  # sampled warm-up
    greedy_dt, greedy, _, _ = sampled_fleet(engine, 0, prompts, None, ntok)

    syncs0, toks0, fwd0 = engine.host_syncs, engine.tokens_emitted, engine.forward_steps
    paged_decode_attention.launches = dense_matmul.launches = 0
    sampled_dt, sampled, puts, bursts = sampled_fleet(engine, 100, prompts, specs, ntok)
    launches = {"paged_decode_attention": paged_decode_attention.launches,
                "dense_matmul": dense_matmul.launches}
    fwd = engine.forward_steps - fwd0
    syncs, toks = engine.host_syncs - syncs0, engine.tokens_emitted - toks0
    if launches["paged_decode_attention"] != cfg.num_hidden_layers * fwd or \
            launches["dense_matmul"] != (7 * cfg.num_hidden_layers + 1) * fwd:
        raise AssertionError(f"sampled run launches {launches}, {fwd} forwards")
    for s in sampled + greedy:
        if len(s) != ntok or not all(0 <= t < cfg.vocab_size for t in s):
            raise AssertionError(f"a stream of {len(s)} tokens, want {ntok} in vocab")
    if sampled == greedy:
        raise AssertionError("sampled streams equal the greedy ones")
    # the sync sites: a put copies its inputs and its tokens, a burst reads
    # each entry token and copies its tokens once (every seed is given)
    want_syncs = 2 * puts + bursts * (n + 1)
    if syncs != want_syncs:
        raise AssertionError(f"host syncs {syncs}, want {want_syncs} ({puts} puts, {bursts} "
                             f"bursts of {n})")

    _, replay, _, _ = sampled_fleet(engine, 200, prompts, specs, ntok)
    if replay != sampled:
        raise AssertionError("seeded sampled streams failed to replay bit-identically")
    _, stepwise, _, step_bursts = sampled_fleet(engine, 300, prompts, specs,
                                                SAMPLED_STEP_TOKENS, burst=1)
    if step_bursts or stepwise != [s[:SAMPLED_STEP_TOKENS] for s in sampled]:
        raise AssertionError(f"max_burst 1 streams differ from max_burst {SAMPLED_BURST}'s "
                             f"first {SAMPLED_STEP_TOKENS} tokens")
    topk1 = topk1_check(engine, prompts[0], ntok)
    copies, sync_calls, _ = host_copies_of_a_burst(engine, prompts, specs)
    if len(copies) != 1:
        raise AssertionError(f"a sampled burst copied {copies} to the host, want its tokens once")

    # the counter PRNG on the card against the port's CPU version: the
    # engine's base key, the phase's seeds at every position of the run
    seeds = torch.tensor([s["seed"] for s in specs], dtype=torch.int32)
    pos = torch.arange(plen, plen + ntok, dtype=torch.int32).repeat_interleave(n)
    base, base_cpu = engine._base_key, engine._base_key.cpu()
    keys_cpu = prng.token_keys(base_cpu, seeds.repeat(ntok), pos)
    keys_gpu = prng.token_keys(base, seeds.repeat(ntok).to(device), pos.to(device))
    bits_rows = keys_cpu[:4 * n]
    bits_equal = torch.equal(keys_gpu.cpu(), keys_cpu) and torch.equal(
        prng.row_bits(bits_rows.to(device), cfg.vocab_size).cpu(),
        prng.row_bits(bits_rows, cfg.vocab_size))
    if not bits_equal:
        raise AssertionError("CUDA keys or bits differ from the CPU's")

    # captured logits: every request's last-token logits after its prompt,
    # drawn at 8 positions, on the card and on the CPU
    uids = list(range(800, 800 + n))
    logits = torch.from_numpy(prefill_each(engine, uids, prompts)).to(device)
    for uid in uids:
        engine.flush(uid)
    meta_np = pack_sample_meta(specs, n)
    meta = unpack_sample_meta(torch.from_numpy(meta_np).to(device), n)
    meta_cpu = unpack_sample_meta(torch.from_numpy(meta_np), n)
    mismatches = 0
    for p in range(8):
        at = torch.full((n,), plen + p, dtype=torch.int32)
        got = sample_rows(logits, prng.token_keys(base, meta[3], at.to(device)), *meta[:3])
        want = sample_rows(logits.cpu(), prng.token_keys(base_cpu, meta_cpu[3], at),
                           *meta_cpu[:3])
        mismatches += int((got.cpu() != want).sum())
    in_burst = sampler_in_burst(engine, prompts, specs)
    alone_by_op, alone_launches, alone_us, alone_ms = sampler_cost(
        logits, prng.fold_in_rows(base, meta[3]), meta, flush)
    if engine.free_blocks != free0:
        raise AssertionError(f"free blocks {engine.free_blocks} != {free0} after flushes")

    gen = n * ntok
    result = {"card": card, "requests": n, "prompt_len": plen, "new_tokens": ntok,
              "token_budget": SAMPLED_BUDGET, "max_burst": SAMPLED_BURST,
              "greedy_gen_tokens_per_sec": gen / greedy_dt,
              "sampled_gen_tokens_per_sec": gen / sampled_dt,
              "sampled_vs_greedy": greedy_dt / sampled_dt,
              "forward_steps": fwd, "ms_per_forward": sampled_dt * 1e3 / fwd,
              "puts": puts, "bursts": bursts, "host_syncs": syncs,
              "syncs_per_token": syncs / max(toks, 1),
              "burst_host_copies": len(copies), "burst_synchronizing_calls": sync_calls,
              "replay_bit_identical": True,
              f"max_burst_1_equals_{SAMPLED_BURST}_over_{SAMPLED_STEP_TOKENS}": True,
              "top_k_1": topk1, "cuda_bits_equal_cpu": bits_equal,
              "cuda_vs_cpu_token_mismatches": mismatches, "cuda_vs_cpu_tokens": 8 * n,
              "sampler_launches_per_forward": in_burst["launches"],
              "sampler_device_us_per_forward": in_burst["device_us"],
              "sampler_by_op_per_forward": in_burst["by_op"],
              "burst_device_us_per_forward": {"greedy": in_burst["greedy_device_us"],
                                              "sampled": in_burst["sampled_device_us"]},
              "sampler_alone": {"launches": alone_launches, "device_us": alone_us,
                                "ms_by_cuda_events": alone_ms, "by_op": alone_by_op},
              "launches": launches}
    log(f"[sampled-serving] {card}: greedy {result['greedy_gen_tokens_per_sec']:.1f} and "
        f"sampled {result['sampled_gen_tokens_per_sec']:.1f} generated tokens/s, "
        f"ratio {result['sampled_vs_greedy']:.3f}")
    log(f"[sampled-serving] {card}: host syncs per token {result['syncs_per_token']:.4f}, "
        f"a sampled burst's host copies {len(copies)}, synchronizing calls {sync_calls}")
    log(f"[sampled-serving] {card}: sampler in a burst (sampled less greedy) "
        f"{in_burst['launches']:.1f} device launches and {in_burst['device_us']:.1f} device µs "
        f"per forward, of {in_burst['sampled_device_us']:.1f} (greedy "
        f"{in_burst['greedy_device_us']:.1f}); alone {alone_launches:.1f} launches, "
        f"{alone_us:.1f} device µs, {alone_ms * 1e3:.1f} µs by CUDA events a call")
    log(f"[sampled-serving] {card}: sampler by op per forward (launches, device µs), in a "
        f"burst {json.dumps(in_burst['by_op'])}; alone {json.dumps(alone_by_op)}")
    log(f"[sampled-serving] {card}: CUDA vs CPU token mismatches on captured logits "
        f"{mismatches} of {8 * n}; top_k 1 vs greedy {json.dumps(topk1)}")
    log(f"[sampled-serving] {json.dumps(result)}")
    log(f"[sampled-serving] request 0 first tokens: sampled {sampled[0][:8]}, greedy "
        f"{greedy[0][:8]}")
    engine.destroy()
    gc.collect()
    torch.cuda.empty_cache()
    return result, launches


# ---------------------------------------------------------------- phase 27
def serving_params(device):
    """Mistral-7B's bf16 serving weights, drawn as phases 5 and 26 draw
    them (seed 0): phases 27 and 28 share one set across their engines."""
    from deepspeed_tpu_torch.models import init_params, llama_config
    cfg = llama_config("mistral-7b")
    return cfg, init_params(cfg, device, torch.bfloat16,
                            torch.Generator(device=device).manual_seed(0))


def spec_prompts(n, vocab):
    """``bench_serving_2b_spec``'s trace: a 16-token pattern from
    ``RandomState(0)`` tiled to the system prompt, then an 8-token pattern
    tiled to the template, its first token + i."""
    rng = np.random.RandomState(0)
    system = np.tile(rng.randint(0, vocab, size=16).astype(np.int32), SPEC_SYS // 16)[:SPEC_SYS]
    template = np.tile(rng.randint(0, vocab, size=8).astype(np.int32),
                       SPEC_TMPL // 8)[:SPEC_TMPL]
    prompts = []
    for i in range(n):
        t = template.copy()
        t[0] = (t[0] + i) % vocab  # requests differ by one slot-filled token
        prompts.append(np.concatenate([system, t]))
    return prompts


def spec_engine(cfg, params, device, spec, structured=False):
    """The phase's engine over ``params``; ``spec`` False builds it with
    ``DS_SPEC_DECODE=0`` over a config that enables spec decoding (the
    kill switch, as the bench's off run)."""
    import os
    from deepspeed_tpu_torch.inference.v2 import (DSStateManagerConfig, InferenceEngineV2,
                                                  RaggedInferenceEngineConfig)
    saved = os.environ.get("DS_SPEC_DECODE")
    if not spec:
        os.environ["DS_SPEC_DECODE"] = "0"
    try:
        engine = InferenceEngineV2(cfg, RaggedInferenceEngineConfig(
            kv_block_size=BS, spec_decode={"enabled": True, "draft_len": SPEC_DRAFT},
            structured={"enabled": structured}, state_manager=DSStateManagerConfig(
                max_ragged_batch_size=SPEC_BUDGET, max_ragged_sequence_count=SPEC_N_REQ,
                max_tracked_sequences=SPEC_N_REQ + 2,
                max_context=SPEC_PROMPT + SPEC_NEW + 8)), params=params, device=device)
    finally:
        if saved is None:
            os.environ.pop("DS_SPEC_DECODE", None)
        else:
            os.environ["DS_SPEC_DECODE"] = saved
    if (engine.spec is not None) != spec:
        raise AssertionError(f"spec decoding {'off' if spec else 'on'} in a spec={spec} engine")
    return engine


def fleet(engine, uid0, prompts, ntok, specs=None, burst=SPEC_BURST, budget=SPEC_BUDGET,
          eos=None, schemas=None, adapters=None):
    """Every prompt (with its spec, greedy when None; its schema and its
    adapter when given) to completion under one scheduler, timed to a
    synchronize, the requests retired after → (seconds, streams)."""
    from deepspeed_tpu_torch.inference.v2 import DynamicSplitFuseScheduler
    sched = DynamicSplitFuseScheduler(engine, token_budget=budget, max_burst=burst,
                                      eos_token_id=eos)
    for i, p in enumerate(prompts):
        sched.add_request(uid0 + i, p, max_new_tokens=ntok, sample=specs[i] if specs else None,
                          schema=schemas[i] if schemas else None,
                          adapter_id=adapters[i] if adapters else None)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = sched.run_to_completion(max_steps=100_000)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    for i in range(len(prompts)):
        sched.retire(uid0 + i)
    return dt, [out[uid0 + i] for i in range(len(prompts))]


def record_verifies(engine):
    """Wraps ``engine.verify_burst``: each call's rows, draft length d,
    wall ms (host packing, the forward and the one device→host copy it
    ends in), K3's and K4's launches and K4's launches by design. →
    (records, restore)."""
    from deepspeed_tpu_torch.ops.kernels.fused_quant_matmul import dense_matmul
    from deepspeed_tpu_torch.ops.kernels.paged_attention import paged_decode_attention
    from deepspeed_tpu_torch.ops.kernels.fused_norms import rms_norm_fwd
    records, inner = [], engine.verify_burst

    def call(uids, tokens, drafts, sample=None):
        k3, k4, kd = paged_decode_attention.launches, dense_matmul.launches, k4_designs("dense")
        k2 = rms_norm_fwd.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(uids, tokens, drafts, sample=sample)
        records.append({"rows": len(uids), "d": max(len(x) for x in drafts),
                        "ms": (time.perf_counter() - t0) * 1e3,
                        "k3": paged_decode_attention.launches - k3,
                        "k4": dense_matmul.launches - k4, "k4_by_design": k4_grew("dense", kd),
                        "rms": rms_norm_fwd.launches - k2})
        return out
    engine.verify_burst = call
    return records, lambda: delattr(engine, "verify_burst")


def check_verifies(records, layers, where):
    """Every verify forward launched K3 once a layer, K4 7 times a layer
    and once for the head, none on K4's first design, and K2's RMS forward
    twice a layer and once for the final norm."""
    for r in records:
        if r["k3"] != layers or r["k4"] != 7 * layers + 1 or r["k4_by_design"]["general"] \
                or r["rms"] != 2 * layers + 1:
            raise AssertionError(f"{where}: a verify forward launched {r}")


def forced_verify_check(engine, prompts, specs, streams, vocab):
    """Drafts taken from spec-off sampled ``streams`` in one verify of
    every request after its prefill: rows 0-3 all four drafts correct,
    row 4 + j one altered at j. Each must accept its correct prefix and
    emit the stream's tokens. → (accepted, records of the verify)."""
    uids = list(range(600, 600 + len(prompts)))
    first = prefill_each(engine, uids, prompts, specs)
    if [int(t) for t in first] != [s[0] for s in streams]:
        raise AssertionError("prefill draws differ from the spec-off streams' first tokens")
    drafts, want = [], []
    for i, s in enumerate(streams):
        d = list(s[1:1 + SPEC_DRAFT])
        j = i - 4 if i >= 4 else SPEC_DRAFT
        if j < SPEC_DRAFT:
            d[j] = (d[j] + 1) % vocab
        drafts.append(d)
        want.append(j)
    records, restore = record_verifies(engine)
    try:
        toks, acc = engine.verify_burst(uids, [[int(t)] for t in first], drafts, sample=specs)
    finally:
        restore()
    for i, s in enumerate(streams):
        if int(acc[i]) != want[i] or toks[i, :want[i] + 1].tolist() != s[1:want[i] + 2]:
            raise AssertionError(f"forced verify row {i}: accepted {int(acc[i])} (want "
                                 f"{want[i]}), emitted {toks[i].tolist()}, stream {s[:6]}")
    for uid in uids:
        engine.flush(uid)
    return acc.tolist(), records


class StreamDrafter:
    """An oracle drafter whose proposals are taken from reference streams
    (the spec-off run's), each prompt's own: the random-weight model
    repeats no suffix n-gram of its history within 64 tokens (phase 27
    prints each greedy stream's distinct tokens and tokens found in its
    prompt), so the n-gram drafter proposes nothing on this trace. A
    seeded share ``alter`` of each stream's positions has its draft
    altered, drawn independently a position, so a verify's drafts fail at
    any of its positions and its accept rate is about ``1 - alter`` a
    draft position."""

    def __init__(self, prompts, streams, vocab, alter=0.25, seed=0):
        rng = np.random.RandomState(seed)
        self.refs = {tuple(int(t) for t in p): (s, rng.random_sample(len(s)) < alter)
                     for p, s in zip(prompts, streams)}
        self.plen = len(prompts[0])
        self.vocab = vocab

    def propose(self, history, max_tokens):
        """History = prompt + generated[:m] (the entry token last) → the
        reference's generated[m:m + max_tokens], altered where drawn."""
        ref, bad = self.refs[tuple(int(t) for t in history[:self.plen])]
        m = len(history) - self.plen
        return [(ref[k] + 1) % self.vocab if bad[k] else ref[k]
                for k in range(m, min(m + max_tokens, len(ref)))]


def spec_serving_phase(device, weights=None):
    """Phase 27: ``bench_serving_2b_spec``'s protocol on the full-depth
    Mistral-7B engine, then the same trace with drafts taken from the
    spec-off streams. → (result, {kernel: launches in the drafted greedy
    run's verify forwards})."""
    from deepspeed_tpu_torch.device import gpu_report
    card = gpu_report()
    cfg, params = weights or serving_params(device)
    L, V, n = cfg.num_hidden_layers, cfg.vocab_size, SPEC_N_REQ
    prompts = spec_prompts(n, V)
    specs = sampled_specs(n)  # phase 26's: temperature, top_k and top_p, seed 1000 + i

    off = spec_engine(cfg, params, device, False)
    fleet(off, 10_000, prompts[:2], 16)  # warm-up, as the bench
    syncs0, toks0, fwd0 = off.host_syncs, off.tokens_emitted, off.forward_steps
    plain_dt, plain = fleet(off, 0, prompts, SPEC_NEW)
    plain_fwd, plain_syncs = off.forward_steps - fwd0, off.host_syncs - syncs0
    plain_toks = off.tokens_emitted - toks0
    _, sampled = fleet(off, 100, prompts, SPEC_NEW, specs)
    off.destroy()

    engine = spec_engine(cfg, params, device, True)
    free0 = engine.free_blocks
    fleet(engine, 10_000, prompts[:2], 16)
    runs = {}
    for name, drafter, specs_ in (("ngram", None, None),
                                  ("drafted", StreamDrafter(prompts, plain, V), None),
                                  ("drafted_sampled", StreamDrafter(prompts, sampled, V), specs)):
        if drafter is not None:
            engine.spec.drafter = drafter
        stats0 = engine.spec.stats()
        syncs0, toks0, fwd0 = engine.host_syncs, engine.tokens_emitted, engine.forward_steps
        records, restore = record_verifies(engine)
        dt, out = fleet(engine, 1_000 * (len(runs) + 1), prompts, SPEC_NEW, specs_)
        restore()
        runs[name] = {"dt": dt, "out": out, "verifies": records,
                      "syncs": engine.host_syncs - syncs0, "tokens": engine.tokens_emitted - toks0,
                      "forwards": engine.forward_steps - fwd0,
                      **{k: v - stats0[k] for k, v in engine.spec.stats().items()
                         if k in ("verify_steps", "tokens_drafted", "tokens_accepted",
                                  "disabled_sequences")}}
        check_verifies(records, L, f"spec-serving {name}")
    forced = forced_verify_check(engine, prompts, specs, sampled, V)
    check_verifies(forced[1], L, "spec-serving forced")
    if engine.free_blocks != free0:
        raise AssertionError(f"free blocks {engine.free_blocks} != {free0} after flushes")
    engine.destroy()

    for s in plain + sampled:
        if len(s) != SPEC_NEW or not all(0 <= t < V for t in s):
            raise AssertionError(f"a stream of {len(s)} tokens, want {SPEC_NEW} in vocab")
    for name, want in (("ngram", plain), ("drafted", plain), ("drafted_sampled", sampled)):
        if runs[name]["out"] != want:
            bad = [i for i in range(n) if runs[name]["out"][i] != want[i]]
            raise AssertionError(f"spec decoding ({name}) changed the streams of requests {bad}")
    for name in ("drafted", "drafted_sampled"):
        r = runs[name]
        if not 0 < r["tokens_accepted"] < r["tokens_drafted"] or r["verify_steps"] <= 0:
            raise AssertionError(f"{name}: {r['verify_steps']} verify steps, "
                                 f"{r['tokens_accepted']} of {r['tokens_drafted']} drafts accepted")
    gen = n * SPEC_NEW
    result = {"card": card, "requests": n, "system_prompt_len": SPEC_SYS,
              "template_len": SPEC_TMPL, "new_tokens": SPEC_NEW, "draft_len": SPEC_DRAFT,
              "max_burst": SPEC_BURST, "token_budget": SPEC_BUDGET,
              "plain_gen_tokens_per_sec": gen / plain_dt, "plain_forwards": plain_fwd,
              "plain_ms_per_forward": plain_dt * 1e3 / plain_fwd,
              "plain_syncs_per_token": plain_syncs / max(plain_toks, 1),
              # why the n-gram drafter finds nothing on random weights: a
              # draft needs the entry token earlier in the sequence
              "greedy_distinct_tokens": [len(set(s)) for s in plain],
              "greedy_tokens_in_prompt": [sum(t in set(p.tolist()) for t in s)
                                          for p, s in zip(prompts, plain)],
              "greedy_bit_identical": True, "sampled_equal": True,
              "forced_verify_accepted": forced[0], "forced_verify_ms": forced[1][0]["ms"]}
    for name, r in runs.items():
        v = r["verifies"]
        by_shape = {}
        for rec in v:
            by_shape.setdefault(f"rows{rec['rows']}_d{rec['d']}", []).append(rec["ms"])
        result[name] = {
            "verify_steps": r["verify_steps"], "tokens_drafted": r["tokens_drafted"],
            "tokens_accepted": r["tokens_accepted"],
            "accept_rate": r["tokens_accepted"] / max(r["tokens_drafted"], 1),
            "tokens_per_verify_step": (r["tokens_accepted"] + r["verify_steps"])
            / max(r["verify_steps"], 1),
            "gen_tokens_per_sec": gen / r["dt"], "vs_plain": plain_dt / r["dt"],
            "syncs_per_token": r["syncs"] / max(r["tokens"], 1), "verify_forwards": len(v),
            # where the run's time went: verify calls (host packing, the
            # forward, the copy) against every other forward of the run
            "forwards": r["forwards"], "verify_s": sum(rec["ms"] for rec in v) / 1e3,
            "other_s": r["dt"] - sum(rec["ms"] for rec in v) / 1e3,
            "disabled_sequences": r["disabled_sequences"],
            "verify_ms": {k: float(np.median(x)) for k, x in by_shape.items()},
            "verify_k3_k4_launches": [v[0]["k3"], v[0]["k4"]] if v else None,
            "verify_k4_by_design": {k: sum(rec["k4_by_design"][k] for rec in v)
                                    for k in v[0]["k4_by_design"]} if v else None}
        log(f"[spec-serving] {card}: {name}: {r['verify_steps']} verify steps, accept rate "
            f"{result[name]['accept_rate']:.3f}, {result[name]['tokens_per_verify_step']:.3f} "
            f"tokens a verify step, {result[name]['gen_tokens_per_sec']:.1f} generated tokens/s "
            f"against plain {result['plain_gen_tokens_per_sec']:.1f} "
            f"({result[name]['vs_plain']:.3f}x); ms a verify forward "
            f"{json.dumps(result[name]['verify_ms'])} against "
            f"{result['plain_ms_per_forward']:.2f} a plain forward; K3, K4 launches a verify "
            f"forward {result[name]['verify_k3_k4_launches']}, K4 by design "
            f"{json.dumps(result[name]['verify_k4_by_design'])}; host syncs a token "
            f"{result[name]['syncs_per_token']:.4f} (plain {result['plain_syncs_per_token']:.4f}); "
            f"{result[name]['verify_forwards']} verify forwards in {result[name]['verify_s']:.3f} s "
            f"and {result[name]['forwards'] - result[name]['verify_forwards']} other forwards in "
            f"{result[name]['other_s']:.3f} s (plain {plain_fwd} in {plain_dt:.3f} s); "
            f"drafting disabled for {r['disabled_sequences']} sequences")
    log(f"[spec-serving] {json.dumps(result)}")
    v = runs["drafted"]["verifies"]
    launches = {"paged_decode_attention": sum(r["k3"] for r in v),
                "dense_matmul": sum(r["k4"] for r in v), "rms_norm_fwd": sum(r["rms"] for r in v)}
    gc.collect()
    torch.cuda.empty_cache()
    return result, launches


# ---------------------------------------------------------------- phase 28
def json_serving_phase(device, weights=None):
    """Phase 28: ``bench_serving_2b_json``'s protocol on the full-depth
    Mistral-7B engine. → (result, {kernel: launches in a constrained
    run})."""
    from deepspeed_tpu_torch.device import gpu_report
    from deepspeed_tpu_torch.inference.structured import (CompiledSchema, byte_vocab,
                                                          detokenize)
    from deepspeed_tpu_torch.inference.v2 import (DSStateManagerConfig, InferenceEngineV2,
                                                  RaggedInferenceEngineConfig)
    from deepspeed_tpu_torch.ops.kernels.fused_quant_matmul import dense_matmul
    from deepspeed_tpu_torch.ops.kernels.paged_attention import paged_decode_attention
    card = gpu_report()
    cfg, params = weights or serving_params(device)
    L, V, n = cfg.num_hidden_layers, cfg.vocab_size, JSON_N_REQ
    schema = {"type": "object", "properties": {"ok": {"type": "boolean"},
                                               "mode": {"enum": ["fast", "safe"]}},
              "required": ["ok", "mode"]}
    vocab = byte_vocab(V)
    t0 = time.perf_counter()
    compiled = CompiledSchema(schema, vocab, eos_token_id=JSON_EOS)
    compile_ms = (time.perf_counter() - t0) * 1e3
    engine = InferenceEngineV2(cfg, RaggedInferenceEngineConfig(
        kv_block_size=BS, structured={"enabled": True, "max_schemas": 4,
                                      "max_states": max(64, compiled.n_states)},
        state_manager=DSStateManagerConfig(
            max_ragged_batch_size=JSON_BUDGET, max_ragged_sequence_count=n,
            max_tracked_sequences=n + 2, max_context=JSON_PROMPT + JSON_NEW + 8)),
        params=params, device=device)
    masks, trans = engine.structured.slabs()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.bind_schema(-1, compiled)  # the install: one copy of the schema's rows
    torch.cuda.synchronize()
    bind_ms = (time.perf_counter() - t0) * 1e3
    engine.structured.release(-1)
    free0 = engine.free_blocks
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, V, size=JSON_PROMPT).astype(np.int32) for _ in range(n)]
    specs = [{"temperature": 1.1, "top_k": 40, "seed": 500 + i} for i in range(n)]

    def run(uid0, constrained, ntok, sample=specs):
        return fleet(engine, uid0, prompts, ntok, sample, burst=JSON_BURST, budget=JSON_BUDGET,
                     eos=JSON_EOS, schemas=[compiled] * n if constrained else None)

    def valid(toks, where):
        if toks[-1] != JSON_EOS:
            raise AssertionError(f"{where}: a constrained lane never reached EOS: {toks}")
        doc = json.loads(detokenize(toks[:-1], vocab))  # raises if invalid
        if not (isinstance(doc.get("ok"), bool) and doc.get("mode") in ("fast", "safe")):
            raise AssertionError(f"{where}: off-schema JSON {doc}")
        return doc

    run(10_000, False, 8)  # plain sampled warm-up
    run(20_000, True, 8)   # constrained warm-up
    plain_tput = json_tput = 0.0
    outs = []
    for r in range(JSON_REPEATS):
        dt, plain = run(1_000 + 100 * r, False, JSON_NEW)
        plain_tput = max(plain_tput, sum(map(len, plain)) / dt)
        paged_decode_attention.launches = dense_matmul.launches = 0
        fwd0 = engine.forward_steps
        dt, out = run(5_000 + 100 * r, True, JSON_NEW)
        fwd = engine.forward_steps - fwd0
        launches = {"paged_decode_attention": paged_decode_attention.launches,
                    "dense_matmul": dense_matmul.launches}
        if launches["paged_decode_attention"] != L * fwd or \
                launches["dense_matmul"] != (7 * L + 1) * fwd:
            raise AssertionError(f"constrained run launches {launches}, {fwd} forwards")
        json_tput = max(json_tput, sum(map(len, out)) / dt)
        outs.append(out)
    docs = [valid(t, "sampled") for t in outs[-1]]
    if any(o != outs[0] for o in outs[1:]):
        raise AssertionError("constrained sampled streams failed to replay per seed")
    _, greedy = run(30_000, True, JSON_NEW, sample=[None] * n)
    greedy_docs = [valid(t, "greedy") for t in greedy]
    if engine.free_blocks != free0 or engine.structured.any_bound():
        raise AssertionError("a constrained run left blocks or leases behind")
    engine.destroy()
    mixed = mixed_spec_check(cfg, params, device, compiled, prompts, specs, valid)
    overhead = plain_tput / json_tput - 1.0
    result = {"card": card, "requests": n, "prompt_len": JSON_PROMPT, "max_new_tokens": JSON_NEW,
              "max_burst": JSON_BURST, "repeats": JSON_REPEATS, "dfa_states": compiled.n_states,
              "compile_ms": compile_ms, "bind_ms": bind_ms,
              "slab_bytes": masks.numel() * masks.element_size()
              + trans.numel() * trans.element_size(),
              "plain_gen_tokens_per_sec": plain_tput, "json_gen_tokens_per_sec": json_tput,
              "constrained_overhead": overhead, "jax_bench_bound": JSON_OVERHEAD_BOUND,
              "schema_valid_frac": len(docs) / n, "replay_bit_identical": True,
              "json_tokens": [len(t) for t in outs[-1]], "greedy_docs": greedy_docs[:1],
              "launches": launches, "mixed_with_spec": mixed}
    log(f"[json-serving] {card}: {compiled.n_states} DFA states, compile {compile_ms:.1f} ms "
        f"(V {V}), bind {bind_ms:.2f} ms, slabs {result['slab_bytes'] / 1e6:.1f} MB; plain "
        f"{plain_tput:.1f} and constrained {json_tput:.1f} generated tokens/s, overhead "
        f"{overhead:.4f} (a reading; the JAX bench's bound {JSON_OVERHEAD_BOUND})")
    log(f"[json-serving] {json.dumps(result)}")
    log(f"[json-serving] lane 0: {detokenize(outs[-1][0][:-1], vocab)}")
    gc.collect()
    torch.cuda.empty_cache()
    return result, launches


def mixed_spec_check(cfg, params, device, compiled, json_prompts, specs, valid):
    """Constrained and unconstrained rows in one batch on an engine with
    spec and constrained decoding on: the constrained rows (the JSON
    traffic's first four, sampled) take plain bursts, and no verify runs
    while one is live; the unconstrained rows (greedy, the spec trace's
    first four) draft once they are alone. → readings."""
    engine = spec_engine(cfg, params, device, True, structured=True)
    bursts_with_schema, verifies = [], []
    burst, verify = engine.decode_burst, engine.verify_burst

    def counted_burst(uids, *args, **kwargs):
        bursts_with_schema.append(any(engine.structured.bound(u) for u in uids))
        return burst(uids, *args, **kwargs)

    def counted_verify(uids, *args, **kwargs):
        verifies.append(any(engine.structured.bound(u) for u in uids))
        return verify(uids, *args, **kwargs)
    engine.decode_burst, engine.verify_burst = counted_burst, counted_verify
    prompts = json_prompts[:4] + spec_prompts(4, cfg.vocab_size)
    _, out = fleet(engine, 0, prompts, SPEC_NEW, specs[:4] + [None] * 4, eos=JSON_EOS,
                   schemas=[compiled] * 4 + [None] * 4)
    for toks in out[:4]:
        valid(toks, "mixed")
    if any(verifies) or not any(bursts_with_schema):
        raise AssertionError(f"mixed batch: verifies with a constrained row {sum(verifies)}, "
                             f"bursts with one {sum(bursts_with_schema)}")
    stats = engine.spec.stats()
    engine.destroy()
    return {"bursts_with_constrained_rows": sum(bursts_with_schema),
            "verify_steps_after": len(verifies), "tokens_drafted": stats["tokens_drafted"]}


# ---------------------------------------------------------------- phase 29
def async_engine(cfg, params, device, async_on, max_states=64):
    """Phase 29's engine over ``params``: ``bench_serving_v2_ragged``'s
    state manager, the pipeline on or off at depth ``ASYNC_DEPTH``,
    constrained decoding live (an unbound request takes the plain path,
    so greedy and sampled lanes run as on an engine without it)."""
    from deepspeed_tpu_torch.inference.v2 import (DSStateManagerConfig, InferenceEngineV2,
                                                  RaggedInferenceEngineConfig)
    engine = InferenceEngineV2(cfg, RaggedInferenceEngineConfig(
        kv_block_size=BS, async_burst={"enabled": async_on, "depth": ASYNC_DEPTH},
        structured={"enabled": True, "max_schemas": 4, "max_states": max_states},
        state_manager=DSStateManagerConfig(
            max_ragged_batch_size=BUDGET, max_ragged_sequence_count=N_REQ,
            max_tracked_sequences=N_REQ + 4, max_context=PROMPT + NEW)),
        params=params, device=device)
    if engine.async_burst != async_on or engine._sanitize:
        raise AssertionError(f"async lane engine: async_burst {engine.async_burst} (want "
                             f"{async_on}), sanitize {engine._sanitize} (want off)")
    return engine


def serving_counters():
    """K2's, K3's and K4's launches so far, K3's and K4's by design."""
    from deepspeed_tpu_torch.ops.kernels.fused_norms import rms_norm_fwd
    from deepspeed_tpu_torch.ops.kernels.fused_quant_matmul import dense_matmul
    from deepspeed_tpu_torch.ops.kernels.paged_attention import paged_decode_attention
    return {"rms_norm_fwd": rms_norm_fwd.launches,
            "paged_decode_attention": paged_decode_attention.launches,
            "dense_matmul": dense_matmul.launches,
            "paged_by_design": paged_designs(), "dense_by_design": k4_designs("dense")}


def counters_since(before):
    now = serving_counters()
    return {k: ({d: n - before[k][d] for d, n in v.items()} if isinstance(v, dict)
                else v - before[k]) for k, v in now.items()}


def timed_dispatches(engine, name):
    """Wraps ``engine.<name>``: the host ms of each call (no synchronize
    around it). → (ms list, restore)."""
    times, inner = [], getattr(engine, name)

    def call(*args, **kwargs):
        t0 = time.perf_counter()
        out = inner(*args, **kwargs)
        times.append((time.perf_counter() - t0) * 1e3)
        return out
    setattr(engine, name, call)
    return times, lambda: delattr(engine, name)


def async_lane(engine, uid0, prompts, ntok, specs=None, schemas=None, eos=None):
    """One lane of phase 29: the traffic to completion under one scheduler
    (``fleet``), with the engine's counts around it → a record."""
    c0 = serving_counters()
    syncs0, toks0, fwd0 = engine.host_syncs, engine.tokens_emitted, engine.forward_steps
    bursts0 = dict(engine.bursts)
    name = "decode_burst_async" if engine.async_burst else "decode_burst"
    times, restore = timed_dispatches(engine, name)
    try:
        dt, streams = fleet(engine, uid0, prompts, ntok, specs, burst=BURST, budget=BUDGET,
                            eos=eos, schemas=schemas)
    finally:
        restore()
    fwd = engine.forward_steps - fwd0
    syncs, toks = engine.host_syncs - syncs0, engine.tokens_emitted - toks0
    return {"streams": streams, "time_s": dt, "forwards": fwd,
            "gen_tokens_per_sec": sum(map(len, streams)) / dt,
            "host_syncs": syncs, "syncs_per_token": syncs / max(toks, 1),
            "bursts": {k: v - bursts0[k] for k, v in engine.bursts.items()},
            "burst_call_ms": times, "launches": counters_since(c0)}


def check_lane_launches(rec, layers, where):
    """Every forward of a lane launched K3 once a layer, K4 7 times a layer
    and once for the head (none on its first design) and K2's RMS forward
    twice a layer and once for the final norm."""
    n, got = rec["forwards"], rec["launches"]
    want = {"paged_decode_attention": layers * n, "dense_matmul": (7 * layers + 1) * n,
            "rms_norm_fwd": (2 * layers + 1) * n}
    if n == 0 or any(got[k] != v for k, v in want.items()) or got["dense_by_design"]["general"]:
        raise AssertionError(f"{where}: {n} forwards launched {got}, want {want} a lane")


def chained_burst_check(engines, prompts):
    """A cold-start pipelined burst, then a chained one dispatched under
    ``torch.cuda.set_sync_debug_mode("error")``: any synchronizing call
    before its fence raises. Both bursts' tokens must equal two
    synchronous bursts' on the sync engine. → host ms of the chained
    dispatch."""
    sync, eng = engines
    uids = list(range(800, 800 + len(prompts)))
    first = [prefill_each(e, uids, prompts, [None] * len(prompts)) for e in engines]
    if not np.array_equal(first[0], first[1]):
        raise AssertionError("chained check: the engines' prefill tokens differ")
    want = [sync.decode_burst(uids, [[int(t)] for t in first[0]], BURST)]
    want.append(sync.decode_burst(uids, [[int(t)] for t in want[0][-1]], BURST))
    h0 = eng.decode_burst_async(uids, [[int(t)] for t in first[1]], BURST)
    torch.cuda.synchronize()  # the cold start's own copies settled: the check is the chain's
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        h1 = eng.decode_burst_async(uids, None, BURST, prev=h0)
        dispatch_ms = (time.perf_counter() - t0) * 1e3
    except RuntimeError as err:
        raise AssertionError(f"a chained burst's dispatch synchronized: {err}") from err
    finally:
        torch.cuda.set_sync_debug_mode("default")
    got = [h0.fetch(), h1.fetch()]
    if not all(np.array_equal(g, w) for g, w in zip(got, want)):
        raise AssertionError("chained bursts' tokens differ from two synchronous bursts'")
    for e in engines:
        for uid in uids:
            e.flush(uid)
    return dispatch_ms


def chained_window(engine, prompts, bursts=ASYNC_WINDOW):
    """The device's busy share over a steady pipelined window: after the
    prompts' prefill, ``bursts`` chained bursts of ``BURST`` steps
    dispatched as the scheduler does (each fence one burst behind the
    dispatch), then the last fence, under the profiler → ``_summarize``'s
    record."""
    from torch.profiler import ProfilerActivity, profile
    uids = list(range(850, 850 + len(prompts)))
    first = prefill_each(engine, uids, prompts, [None] * len(prompts))
    torch.cuda.synchronize()
    f0 = engine.forward_steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        live = [engine.decode_burst_async(uids, [[int(t)] for t in first], BURST)]
        for _ in range(bursts - 1):
            live.append(engine.decode_burst_async(uids, None, BURST, prev=live[-1]))
            if len(live) > ASYNC_DEPTH:
                live.pop(0).fetch()
        for h in live:
            h.fetch()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    for uid in uids:
        engine.flush(uid)
    return _summarize(prof, wall_ms, engine.forward_steps - f0)


def sanitize_check(cfg, params, device, plain, prompts):
    """``DS_SANITIZE=1``: an engine built under it serves ``prompts``
    (greedy, pipelined) to the streams the unsanitized engine ``plain``
    gives, and a NaN-poisoned weight (the final norm, in a copy of the
    params dict) raises ``SanitizerNaNError`` at its next forward. The
    unsanitized engines' forward is the gate's result, the method itself.
    → readings."""
    import os
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
    from deepspeed_tpu_torch.utils.sanitize import SanitizerNaNError
    if getattr(plain._forward, "_ds_sanitized", False) or \
            plain._forward.__func__ is not InferenceEngineV2._forward:
        raise AssertionError("an unsanitized engine's forward is wrapped")
    saved = os.environ.get("DS_SANITIZE")
    os.environ["DS_SANITIZE"] = "1"
    from deepspeed_tpu_torch.inference.v2 import DSStateManagerConfig, RaggedInferenceEngineConfig
    try:
        engine = InferenceEngineV2(cfg, RaggedInferenceEngineConfig(
            kv_block_size=BS, async_burst={"enabled": True, "depth": ASYNC_DEPTH},
            state_manager=DSStateManagerConfig(
                max_ragged_batch_size=BUDGET, max_ragged_sequence_count=N_REQ,
                max_tracked_sequences=N_REQ, max_context=PROMPT + NEW)),
            params=params, device=device)
    finally:
        if saved is None:
            os.environ.pop("DS_SANITIZE", None)
        else:
            os.environ["DS_SANITIZE"] = saved
    if not (engine._sanitize and engine._forward._ds_sanitized):
        raise AssertionError("DS_SANITIZE=1 built an unsanitized engine")
    _, want = fleet(plain, 70_000, prompts, ASYNC_SANITIZE_NEW, burst=BURST, budget=BUDGET)
    dt, got = fleet(engine, 70_000, prompts, ASYNC_SANITIZE_NEW, burst=BURST, budget=BUDGET)
    if got != want:
        raise AssertionError("the sanitized engine's streams differ from the plain engine's")
    engine.params = dict(engine.params, norm=torch.full_like(params["norm"], float("nan")))
    try:
        engine.put([1], [prompts[0]], sample="greedy")
    except SanitizerNaNError as err:
        caught = str(err)
    else:
        raise AssertionError("a NaN-poisoned weight passed the sanitized forward")
    engine.destroy()
    return {"clean_run_s": dt, "clean_streams_equal": True, "poisoned": caught[:120]}


def async_serving_phase(device, weights=None):
    """Phase 29: ``bench_serving_v2_ragged``'s protocol on the Mistral-7B
    engine over the first ASYNC_LAYERS layers of ``weights``, a synchronous
    lane and a pipelined one (depth ``ASYNC_DEPTH``) in the same call. →
    (result, {kernel: launches in the pipelined greedy lane})."""
    from deepspeed_tpu_torch.device import gpu_report
    from deepspeed_tpu_torch.inference.structured import (CompiledSchema, byte_vocab,
                                                          detokenize)
    card = gpu_report()
    cfg, params = weights or serving_params(device)
    cfg, params = (dataclasses.replace(cfg, num_hidden_layers=ASYNC_LAYERS),
                   first_layers(params, ASYNC_LAYERS))
    L, V = cfg.num_hidden_layers, cfg.vocab_size
    t0 = time.perf_counter()
    laps = {}
    schema = {"type": "object", "properties": {"ok": {"type": "boolean"},
                                               "mode": {"enum": ["fast", "safe"]}},
              "required": ["ok", "mode"]}
    vocab = byte_vocab(V)
    compiled = CompiledSchema(schema, vocab, eos_token_id=JSON_EOS)
    engines = [async_engine(cfg, params, device, on, max(64, compiled.n_states))
               for on in (False, True)]
    free0 = [e.free_blocks for e in engines]
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, V, size=PROMPT).astype(np.int32) for _ in range(N_REQ)]
    warm = [np.random.RandomState(1).randint(0, V, size=16).astype(np.int32)] * 2
    for e in engines:  # allocator, pinned staging and host caches
        fleet(e, 90_000, warm, NEW // 2, burst=BURST, budget=BUDGET)
        fleet(e, 91_000, warm, NEW // 2, sampled_specs(2), burst=BURST, budget=BUDGET)
    lanes = {}
    for name, specs, schemas, eos in (
            ("greedy", None, None, None),
            ("sampled", sampled_specs(N_REQ), None, None),
            ("constrained", [{"temperature": 1.1, "top_k": 40, "seed": 500 + i}
                             for i in range(N_REQ)], [compiled] * N_REQ, JSON_EOS)):
        recs = [async_lane(e, 1_000 * (len(lanes) + 1), prompts, NEW, specs, schemas, eos)
                for e in engines]
        if recs[0]["streams"] != recs[1]["streams"]:
            raise AssertionError(f"{name}: pipelined streams differ from the synchronous lane's")
        if recs[1]["bursts"]["async"] == 0 or recs[1]["bursts"]["sync"] or \
                recs[0]["bursts"]["async"]:
            raise AssertionError(f"{name}: bursts by path sync {recs[0]['bursts']}, "
                                 f"async {recs[1]['bursts']}")
        for rec, where in zip(recs, ("sync", "async")):
            check_lane_launches(rec, L, f"{name} {where} lane")
        per = [{k: v / r["forwards"] for k, v in r["launches"].items()
                if not isinstance(v, dict)} for r in recs]
        # without EOS both engines run the same forwards; a lane that ends
        # at EOS runs the pipeline's dispatched tail past it as well
        if per[0] != per[1] or (eos is None and recs[0]["launches"] != recs[1]["launches"]):
            raise AssertionError(f"{name}: launches {recs[0]['launches']} over "
                                 f"{recs[0]['forwards']} forwards (sync) vs "
                                 f"{recs[1]['launches']} over {recs[1]['forwards']} (async)")
        if schemas:
            for toks in recs[1]["streams"]:
                if toks[-1] != JSON_EOS:
                    raise AssertionError(f"constrained lane never reached EOS: {toks}")
                doc = json.loads(detokenize(toks[:-1], vocab))
                if not (isinstance(doc.get("ok"), bool) and doc.get("mode") in ("fast", "safe")):
                    raise AssertionError(f"constrained lane: off-schema JSON {doc}")
        lanes[name] = recs
    laps["warm_up_and_lanes"] = time.perf_counter() - t0
    greedy = lanes["greedy"]
    drop = greedy[0]["syncs_per_token"] / max(greedy[1]["syncs_per_token"], 1e-9)
    if drop < 4.0:
        raise AssertionError(f"syncs per generated token dropped {drop:.2f}x, want >= 4")
    # EOS found one burst late: request 0 stops mid-pipeline, at the first
    # token from ASYNC_EOS_AT on that its stream has not emitted before
    stream0 = greedy[0]["streams"][0]
    at = next((i for i in range(ASYNC_EOS_AT, NEW - 1) if stream0[i] not in stream0[:i]), None)
    if at is None:
        raise AssertionError(f"EOS lane: request 0's greedy stream repeats from "
                             f"{ASYNC_EOS_AT} on: {stream0}")
    eos = stream0[at]
    stop = [async_lane(e, 5_000, prompts, NEW, eos=eos) for e in engines]
    if stop[0]["streams"] != stop[1]["streams"] or len(stop[1]["streams"][0]) != at + 1:
        raise AssertionError(f"EOS lane: streams equal {stop[0]['streams'] == stop[1]['streams']}"
                             f", request 0 emitted {len(stop[1]['streams'][0])}, want {at + 1}")
    free = [e.free_blocks for e in engines]
    if free != free0:
        raise AssertionError(f"free blocks after the EOS lanes {free}, at the start {free0}")
    laps["eos_lanes"] = time.perf_counter() - t0 - sum(laps.values())
    dispatch_ms = chained_burst_check(engines, prompts)
    windows = {"async": chained_window(engines[1], prompts)}
    laps["chained_check_and_window"] = time.perf_counter() - t0 - sum(laps.values())
    sanitize = sanitize_check(cfg, params, device, engines[1], prompts[:4])
    laps["sanitize"] = time.perf_counter() - t0 - sum(laps.values())
    for e in engines:
        e.destroy()
    launches = {k: greedy[1]["launches"][k] for k in ("paged_decode_attention", "dense_matmul",
                                                      "rms_norm_fwd")}
    result = {"card": card, "requests": N_REQ, "prompt_len": PROMPT, "new_tokens": NEW,
              "token_budget": BUDGET, "max_burst": BURST, "depth": ASYNC_DEPTH,
              "gen_tokens_per_sec": {k: [r["gen_tokens_per_sec"] for r in v]
                                     for k, v in lanes.items()},
              "syncs_per_token": {k: [r["syncs_per_token"] for r in v]
                                  for k, v in lanes.items()},
              "syncs_per_token_drop": drop,
              "host_syncs": {k: [r["host_syncs"] for r in v] for k, v in lanes.items()},
              "forwards": {k: [r["forwards"] for r in v] for k, v in lanes.items()},
              "burst_host_ms_median": {
                  "sync_decode_burst": float(np.median(greedy[0]["burst_call_ms"])),
                  "async_dispatch": float(np.median(greedy[1]["burst_call_ms"]))},
              "chained_dispatch_ms_under_sync_debug": dispatch_ms,
              "launches_by_design": {k: greedy[1]["launches"][k]
                                     for k in ("paged_by_design", "dense_by_design")},
              "launches_per_forward": {k: v / greedy[1]["forwards"] for k, v in launches.items()},
              "eos_lane": {"eos": int(eos), "request0_tokens": at + 1,
                           "forwards": [r["forwards"] for r in stop],
                           "free_blocks": free},
              "chained_window": windows["async"], "sanitize": sanitize, "phase_s": laps}
    log(f"[async-serving] {card}: generated tokens/s sync vs pipelined: "
        + ", ".join(f"{k} {v[0]:.1f} vs {v[1]:.1f}"
                    for k, v in result["gen_tokens_per_sec"].items())
        + f"; syncs/token {greedy[0]['syncs_per_token']:.4f} vs "
        f"{greedy[1]['syncs_per_token']:.4f} ({drop:.1f}x)")
    log(f"[async-serving] {card}: device busy share over {ASYNC_WINDOW} chained bursts "
        f"{windows['async']['device_busy_share']}; host ms to dispatch a burst (median) "
        f"{result['burst_host_ms_median']['async_dispatch']:.2f} pipelined vs "
        f"{result['burst_host_ms_median']['sync_decode_burst']:.2f} a whole synchronous "
        f"burst; launches K2/K3/K4 {launches}, by design "
        f"{json.dumps(result['launches_by_design'])}")
    log(f"[async-serving] {json.dumps({k: v for k, v in result.items()})}")
    gc.collect()
    torch.cuda.empty_cache()
    return result, launches


# ---------------------------------------------------------------- phase 30
def gateway_engine(cfg, params, device, publish_root=""):
    """Phase 30's engine over ``params``: phase 29's synchronous config
    with LoRA serving on (hot set 4, rank bucket ``LORA_RANK``), its disk
    tier under ``publish_root`` when given."""
    from deepspeed_tpu_torch.inference.v2 import (DSStateManagerConfig, InferenceEngineV2,
                                                  RaggedInferenceEngineConfig)
    return InferenceEngineV2(cfg, RaggedInferenceEngineConfig(
        kv_block_size=BS, structured={"enabled": True, "max_schemas": 4},
        lora={"enabled": True, "hot_set": 4, "max_rank": LORA_RANK, "prefetch": False,
              "publish_root": publish_root},
        state_manager=DSStateManagerConfig(
            max_ragged_batch_size=BUDGET, max_ragged_sequence_count=N_REQ,
            max_tracked_sequences=N_REQ + REFRESH_QUEUED + 4, max_context=PROMPT + NEW)),
        params=params, device=device)


def stepped(params, seed):
    """The stand-in train step on every floating leaf, leaf by leaf on the
    leaf's device: ``p - REFRESH_STEP·p·z``, z ~ N(0, 1) from ``seed``, in
    fp32, stored in the leaf's dtype, STEP_CHUNK values at a time (a
    stacked [32, 4096, 14336] leaf in fp32 at once would hold ~30 GB of
    temporaries). (The JAX bench's ``p - 1e-3·p`` moves no bf16 value: 1e-3
    is below half a bf16 ulp.)"""
    def step(w, g):
        if not w.is_floating_point():
            return w
        out = torch.empty_like(w)
        src, dst = w.reshape(-1), out.view(-1)
        for i in range(0, src.numel(), STEP_CHUNK):
            x = src[i:i + STEP_CHUNK].float()
            z = torch.randn(x.shape, generator=g, device=w.device)
            dst[i:i + STEP_CHUNK] = (x - REFRESH_STEP * x * z).to(w.dtype)
        return out
    g = torch.Generator(params["norm"].device).manual_seed(seed)
    return {k: ({n: step(w, g) for n, w in v.items()} if isinstance(v, dict) else step(v, g))
            for k, v in params.items()}


def first_layers(params, n):
    """The tree at its first ``n`` layers (views of the stacked leaves)."""
    return {k: ({m: w[:n] for m, w in v.items()} if k == "layers" else v)
            for k, v in params.items()}


def tree_leaves(tree):
    return [w for v in tree.values() for w in (v.values() if isinstance(v, dict) else [v])]


def tree_bytes(tree):
    return sum(w.numel() * w.element_size() for w in tree_leaves(tree))


def gateway_wave(gw, prompts, ntok=NEW, during=None, adapters=None, wait_streaming=True):
    """Submit ``prompts`` from client threads and consume each stream on its
    own thread; once every stream has its first token, run ``during()``
    (on this thread). → {streams, wall_s, gaps_ms, lost, during}: nothing
    lost is the caller's check."""
    import threading
    n = len(prompts)
    streams, gaps, lost, handles = [None] * n, [], [], [None] * n
    lock = threading.Lock()
    started = threading.Barrier(n + 1)

    def client(i):
        prev = None
        got = []
        try:
            handles[i] = gw.submit(prompts[i], max_new_tokens=ntok,
                                   adapter_id=adapters[i] if adapters else None)
            started.wait()
            for tok in handles[i].tokens(timeout=600):
                now = time.perf_counter()
                if prev is not None:
                    with lock:
                        gaps.append((now - prev) * 1e3)
                prev = now
                got.append(tok)
            streams[i] = got
        except Exception as err:  # noqa: BLE001 — the zero-lost audit
            with lock:
                lost.append(f"request {i}: {type(err).__name__}: {err}")
            started.abort()

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    started.wait(timeout=600)
    out = None
    if during is not None:
        while wait_streaming and not all(h._first_token_at is not None for h in handles):
            time.sleep(0.001)
        out = during()
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        lost.append("a stream hung")
    return {"streams": streams, "wall_s": wall, "gaps_ms": gaps, "lost": lost, "during": out,
            "tokens": sum(len(s) for s in streams if s)}


def p99(xs):
    return float(np.percentile(xs, 99)) if xs else 0.0


def publication_readings(tree, root):
    """Phase 30 (b): publish ``tree`` (device tensors) with the port's
    ``WeightPublisher`` under ``root`` and load it back → (host tree,
    publisher, readings)."""
    import os
    import shutil
    from deepspeed_tpu_torch.serving import WeightPublisher
    nbytes = tree_bytes(tree)
    free_disk = shutil.disk_usage(root).free
    host_ram = os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    pub = WeightPublisher(os.path.join(root, "weights"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    manifest = pub.publish(tree)
    publish_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded, m = pub.load(1, expect_parent_chain=None)
    load_s = time.perf_counter() - t0
    if m != manifest or pub.rejects or pub.publishes != 1:
        raise AssertionError("publication: the loaded manifest differs from the published one")
    size = manifest["files"]["payload.bin"]["bytes"]
    if size != nbytes:
        raise AssertionError(f"publication: {size} payload bytes for a {nbytes}-byte tree")
    return loaded, pub, {"bytes": size, "leaves": len(manifest["tree"]), "publish_s": publish_s,
                         "publish_gb_per_s": size / publish_s / 1e9, "load_s": load_s,
                         "load_gb_per_s": size / load_s / 1e9, "free_disk_before": free_disk,
                         "host_ram_available_before": host_ram, "chain": manifest["chain"]}


def publication_faults(tree, root, gw, probe, want):
    """Phase 30 (d): ``tree`` at its first REFRESH_FAULT_LAYERS layers
    published under ``root`` (cut for the run's time: a bit flip is found
    by hashing the whole payload), then a bit-flipped payload and a forged
    manifest of it each rejected with ``WeightPublicationError``; the
    gateway's version and the probe's stream stay. → readings."""
    import os
    from deepspeed_tpu_torch.serving import WeightPublisher
    from deepspeed_tpu_torch.utils.sanitize import WeightPublicationError
    pub = WeightPublisher(os.path.join(root, "faults"))
    pub.publish(first_layers(tree, REFRESH_FAULT_LAYERS))
    pdir = os.path.join(pub.dir, "v00000001")
    faults = {}
    payload = os.path.join(pdir, "payload.bin")
    mpath = os.path.join(pdir, "weight_manifest.json")
    size = os.path.getsize(payload)
    with open(payload, "r+b") as fd:
        fd.seek(size // 2)
        byte = fd.read(1)
        fd.seek(size // 2)
        fd.write(bytes([byte[0] ^ 0xFF]))
    with open(mpath) as fd:
        saved = fd.read()
    for name, undo in (("bitflip", None), ("forged_manifest", saved)):
        if name == "forged_manifest":
            with open(payload, "r+b") as fd:  # the payload as published again
                fd.seek(size // 2)
                fd.write(byte)
            forged = json.loads(saved)
            forged["files"]["payload.bin"]["bytes"] += 1
            with open(mpath, "w") as fd:
                json.dump(forged, fd)
        t0 = time.perf_counter()
        try:
            pub.load(1)
        except WeightPublicationError as err:
            faults[name] = {"rejected": type(err).__name__, "message": str(err)[:100],
                            "s": time.perf_counter() - t0}
        else:
            raise AssertionError(f"a {name} publication loaded")
        if undo is not None:
            with open(mpath, "w") as fd:
                fd.write(undo)
    if pub.rejects != 2 or gw.weight_version != 1:
        raise AssertionError(f"faults: rejects {pub.rejects}, version {gw.weight_version}")
    got = gateway_wave(gw, [probe])
    if got["lost"] or got["streams"][0] != want:
        raise AssertionError(f"faults: the probe's stream moved {got['lost']}")
    return faults


def quantized_swap_check(cfg, v0, v1, device, prompts):
    """Phase 30 (e): an int8 engine at ``REFRESH_QUANT_LAYERS`` of Mistral's
    layers, swapped from ``v0`` to ``v1`` (quantized on the device), holds
    carriers and scales byte-equal to a cold start's on ``v1``, and serves
    its greedy streams. → readings."""
    from deepspeed_tpu_torch.inference.quantization import QuantizedWeight
    from deepspeed_tpu_torch.inference.v2 import (DSStateManagerConfig, InferenceEngineV2,
                                                  RaggedInferenceEngineConfig)
    qcfg = dataclasses.replace(cfg, num_hidden_layers=REFRESH_QUANT_LAYERS)
    ecfg = RaggedInferenceEngineConfig(
        kv_block_size=BS, quantization={"quantization_mode": "int8"},
        state_manager=DSStateManagerConfig(
            max_ragged_batch_size=BUDGET, max_ragged_sequence_count=len(prompts),
            max_tracked_sequences=len(prompts) + 2, max_context=PROMPT + NEW))
    L = REFRESH_QUANT_LAYERS
    engine = InferenceEngineV2(qcfg, ecfg, params=first_layers(v0, L), device=device)
    _, before = fleet(engine, 0, prompts, NEW // 2, burst=BURST, budget=BUDGET)
    engine.swap_params(first_layers(v1, L), 1)
    cold = InferenceEngineV2(qcfg, ecfg, params=first_layers(v1, L), device=device)

    def parts(tree):
        for k, v in sorted(tree.items()):
            for n, w in (sorted(v.items()) if isinstance(v, dict) else [(k, v)]):
                yield from (((n, w.values), (n, w.scales)) if isinstance(w, QuantizedWeight)
                            else ((n, w),))
    pairs = list(zip(parts(engine.params), parts(cold.params)))
    carriers = sum(isinstance(w, QuantizedWeight) for w in engine.params["layers"].values())
    if carriers == 0 or not all(torch.equal(a, b) for (_, a), (_, b) in pairs):
        raise AssertionError(f"int8 swap: {carriers} carriers, params differ from a cold start")
    _, got = fleet(engine, 100, prompts, NEW // 2, burst=BURST, budget=BUDGET)
    _, want = fleet(cold, 100, prompts, NEW // 2, burst=BURST, budget=BUDGET)
    if got != want:
        raise AssertionError("int8 swap: greedy streams differ from a cold start's")
    out = {"layers": L, "carrier_leaves": carriers, "tensors_equal": len(pairs),
           "bytes": engine.quantized_bytes, "streams_moved": sum(a != b for a, b in
                                                                 zip(got, before))}
    engine.destroy()
    cold.destroy()
    return out


def lora_disk_check(gw, cold, prompts, base):
    """Phase 30 (f): two adapters (rank ``LORA_RANK``, q/k/v/o) published
    to the gateway engine's disk tier and adopted lazily at
    ``submit(adapter_id=...)`` stream what the same adapters registered in
    memory on ``cold`` stream (and not the ``base`` streams: the check is
    not vacuous); v2 of one, adopted, streams the in-memory v2's; a torn
    publication is rejected typed and counted. → readings."""
    from deepspeed_tpu_torch.serving.lora import AdapterPublisher
    from deepspeed_tpu_torch.utils.sanitize import WeightPublicationError
    store = gw.engine.lora_store
    layers = {aid: lora_adapter(store, seed, LORA_RANK) for aid, seed in
              ((101, 1), (102, 2), (201, 3))}
    t0 = time.perf_counter()
    for aid in (101, 102):
        store.publish(aid, layers[aid], alpha=LORA_ALPHA)
        cold.register_adapter(aid, layers[aid], alpha=LORA_ALPHA)
    publish_s = time.perf_counter() - t0
    if not (store.known(101) and not store.has_adapter(101)):
        raise AssertionError("lora disk: a published adapter is not known, or already hot")
    ids = [101, 102, None, 101]

    def in_memory():
        return fleet(cold, 600, prompts, NEW // 2, burst=BURST, budget=BUDGET, adapters=ids)[1]
    want = in_memory()
    got = gateway_wave(gw, prompts, NEW // 2, adapters=ids)
    promoted = store.stats()["promotions"]
    if got["lost"] or got["streams"] != want or want[0] == base[0] or promoted < 2:
        raise AssertionError(f"lora disk: streams equal {got['streams'] == want}, "
                             f"lost {got['lost']}, promotions {promoted}")
    store.publish(101, layers[201], alpha=LORA_ALPHA)
    if gw.engine.adopt_adapter(101) != 2:
        raise AssertionError("lora disk: v2 not adopted")
    cold.lora_store.invalidate()  # a registration installs the host tier only
    cold.register_adapter(101, layers[201], alpha=LORA_ALPHA, version=2)
    want2 = in_memory()
    got2 = gateway_wave(gw, prompts, NEW // 2, adapters=ids)
    if got2["lost"] or got2["streams"] != want2 or want2[0] == want[0]:
        raise AssertionError("lora disk: the adopted v2 does not stream the in-memory v2's")

    def crash(point, detail=None):
        if point == "before_manifest":
            raise RuntimeError("torn adapter publication")
    try:
        AdapterPublisher(store.publisher.root, test_hook=crash).publish(102, layers[201],
                                                                        LORA_ALPHA)
    except RuntimeError:
        pass
    try:
        store.adopt(102, version=2)
    except WeightPublicationError as err:
        torn = str(err)[:100]
    else:
        raise AssertionError("lora disk: a torn adapter publication was adopted")
    stats = store.stats()
    if stats["publish_rejects"] != 1 or store.version_of(102) != 1:
        raise AssertionError(f"lora disk: rejects {stats['publish_rejects']}, "
                             f"version {store.version_of(102)}")
    return {"adapters": 2, "rank": LORA_RANK, "publish_s": publish_s, "promotions": promoted,
            "swaps": stats["swaps"], "publish_rejects": stats["publish_rejects"],
            "torn": torn, "streams_moved_by_v2": sum(a != b for a, b in zip(want2, want))}


def gateway_refresh_phase(device, weights=None):
    """Phase 30: ``bench_serving_v2_ragged``'s traffic through a
    ``ServingGateway`` (pump thread, client threads) on the full-depth
    Mistral-7B engine, then a live refresh under
    ``bench_serving_2b_refresh``'s protocol: publication, staged swap under
    traffic, faults, an int8 swap, the LoRA disk tier, drain. → (result,
    {kernel: launches in the gateway wave})."""
    import shutil
    import tempfile
    import threading
    from deepspeed_tpu_torch.device import gpu_report
    from deepspeed_tpu_torch.serving import ServingConfig, ServingGateway
    card = gpu_report()
    cfg, params = weights or serving_params(device)
    L, V = cfg.num_hidden_layers, cfg.vocab_size
    root = tempfile.mkdtemp(prefix="ds_refresh_")
    laps, t_phase = {}, time.perf_counter()

    def lap(name):
        laps[name] = time.perf_counter() - t_phase - sum(laps.values())
    try:
        engine = gateway_engine(cfg, params, device, publish_root=f"{root}/adapters")
        rng = np.random.RandomState(0)
        prompts = [rng.randint(0, V, size=PROMPT).astype(np.int32) for _ in range(N_REQ)]
        warm = [np.random.RandomState(1).randint(0, V, size=16).astype(np.int32)] * 2
        fleet(engine, 90_000, warm, NEW // 2, burst=BURST, budget=BUDGET)
        # (a) direct run, then the same traffic through the gateway
        direct_s, want0 = fleet(engine, 1_000, prompts, NEW, burst=BURST, budget=BUDGET)
        gw = ServingGateway(engine, config=ServingConfig(
            token_budget=BUDGET, max_burst=BURST, max_queue_depth=4 * N_REQ,
            drain_timeout_s=600.0))
        gateway_wave(gw, warm, NEW // 2)  # the pump thread's first forwards
        c0 = serving_counters()
        syncs0, toks0, fwd0 = engine.host_syncs, engine.tokens_emitted, engine.forward_steps
        from deepspeed_tpu_torch.ops.kernels.lora_matmul import lora_delta
        k6 = lora_delta.launches
        wave1 = gateway_wave(gw, prompts)
        rec = {"forwards": engine.forward_steps - fwd0, "launches": counters_since(c0)}
        k6 = lora_delta.launches - k6
        if wave1["lost"] or wave1["streams"] != want0:
            raise AssertionError(f"gateway: lost {wave1['lost']}, streams equal "
                                 f"{wave1['streams'] == want0}")
        check_lane_launches(rec, L, "gateway wave")
        snap = gw.snapshot()
        gateway = {"gen_tokens_per_sec": wave1["tokens"] / wave1["wall_s"],
                   "direct_gen_tokens_per_sec": sum(map(len, want0)) / direct_s,
                   "ttft_ms": {k: snap["ttft"][k] for k in ("p50_ms", "p99_ms")},
                   "inter_token_ms": {k: snap["token_latency"][k] for k in ("p50_ms", "p99_ms")},
                   "syncs_per_token": (engine.host_syncs - syncs0) /
                   max(engine.tokens_emitted - toks0, 1),
                   "forwards": rec["forwards"],
                   "launches_per_forward": {k: v / rec["forwards"] for k, v in
                                            rec["launches"].items() if not isinstance(v, dict)},
                   "lora_delta_launches": k6,
                   "launches_by_design": {k: rec["launches"][k] for k in ("paged_by_design",
                                                                          "dense_by_design")}}
        lap("gateway_wave")
        # (b) v1 = the stand-in train step on the device, published and loaded
        v1_dev = stepped(params, 1)
        loaded, pub, publication = publication_readings(v1_dev, root)
        del v1_dev
        gc.collect()
        torch.cuda.empty_cache()
        lap("publication")
        # (c) live refresh under a second wave; REFRESH_QUEUED requests queue behind it
        swap_times = {}
        inner = engine.swap_params

        def timed_swap(new_params, version):
            torch.cuda.synchronize(device)
            swap_times["allocated_before"] = torch.cuda.memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
            swap_times["start"] = time.perf_counter()
            out = inner(new_params, version)
            torch.cuda.synchronize(device)
            swap_times["end"] = time.perf_counter()
            swap_times["peak_allocated"] = torch.cuda.max_memory_allocated(device)
            swap_times["allocated_after"] = torch.cuda.memory_allocated(device)
            return out
        engine.swap_params = timed_swap
        queued, control = {}, {}

        def refresh():
            def stage():
                control["staged"] = time.perf_counter()
                control["version"] = gw.refresh_weights(loaded, 1, timeout=600)
                control["applied"] = time.perf_counter()
            ctl = threading.Thread(target=stage)
            ctl.start()
            while gw._pending_refresh is None and ctl.is_alive():
                time.sleep(0.0005)
            queued["wave"] = gateway_wave(gw, prompts[:REFRESH_QUEUED])
            ctl.join(timeout=600)
        wave2 = gateway_wave(gw, prompts, during=refresh)
        del engine.swap_params  # the wrapper goes; the method stays
        behind = queued["wave"]
        if wave2["lost"] or behind["lost"] or control.get("version") != 1:
            raise AssertionError(f"refresh: lost {wave2['lost'] + behind['lost']}, "
                                 f"version {control.get('version')}")
        if wave2["streams"] != want0:
            raise AssertionError("refresh: streams admitted before the swap differ from v0's")
        lap("refresh_wave")
        # the canary's oracle: a cold-started engine on the same v1 tree
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cold = gateway_engine(cfg, loaded, device)
        cold.put([99_999], [warm[0]], sample="greedy")
        torch.cuda.synchronize()
        cold_restart_s = time.perf_counter() - t0
        cold.flush(99_999)
        _, want1 = fleet(cold, 2_000, prompts[:REFRESH_QUEUED], NEW, burst=BURST,
                         budget=BUDGET)
        if behind["streams"] != want1:
            raise AssertionError("refresh: requests queued behind the swap differ from a cold "
                                 "v1 engine's streams")
        moved = sum(a != b for a, b in zip(want1, want0))
        if moved == 0 or gw.weight_version != 1:
            raise AssertionError(f"refresh: {moved} probes moved, version {gw.weight_version}")
        refresh_wall = control["applied"] - control["staged"]
        refresh = {"wall_s": refresh_wall,
                   "waiting_for_inflight_s": swap_times["start"] - control["staged"],
                   "swap_s": swap_times["end"] - swap_times["start"],
                   "device_allocated_before_gb": swap_times["allocated_before"] / 1e9,
                   "device_peak_during_swap_gb": swap_times["peak_allocated"] / 1e9,
                   "device_allocated_after_gb": swap_times["allocated_after"] / 1e9,
                   "params_gb": tree_bytes(loaded) / 1e9,
                   "cold_restart_s": cold_restart_s, "probes_moved": moved,
                   "queued_behind": REFRESH_QUEUED,
                   "p99_gap_steady_ms": p99(wave1["gaps_ms"]),
                   "p99_gap_during_refresh_ms": p99(wave2["gaps_ms"] + behind["gaps_ms"])}
        # a swap with a live sequence raises
        cold.put([1], [prompts[0]], sample="greedy")
        try:
            cold.swap_params(loaded, 2)
        except RuntimeError as err:
            refresh["live_swap_refused"] = str(err)[:80]
        else:
            raise AssertionError("a swap with a live sequence went through")
        cold.flush(1)
        lap("oracle")
        # (d) faults, (f) the LoRA disk tier, (e) the int8 swap
        faults = publication_faults(loaded, root, gw, prompts[0], want1[0])
        lap("faults")
        lora = lora_disk_check(gw, cold, prompts[:4], [s[:NEW // 2] for s in want1])
        lap("lora_disk")
        quant = quantized_swap_check(cfg, params, loaded, device, prompts[:4])
        lap("int8_swap")
        cold.destroy()
        del cold
        gc.collect()
        # drain with a third wave in flight: the alternative to a refresh is a
        # drain and a cold restart
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated(device)

        def drain():
            t0 = time.perf_counter()
            gw.drain(timeout=600)
            return time.perf_counter() - t0
        wave3 = gateway_wave(gw, prompts, during=drain)
        if wave3["lost"] or wave3["streams"][:REFRESH_QUEUED] != want1 or \
                any(len(s) != NEW for s in wave3["streams"]):
            raise AssertionError(f"drain: lost {wave3['lost']}, or streams cut or moved")
        freed = held - torch.cuda.memory_allocated(device)
        if gw.state != "stopped" or engine.kv_cache is not None or \
                freed < 0.9 * tree_bytes(loaded):
            raise AssertionError(f"drain: state {gw.state}, {freed / 1e9:.2f} GB freed")
        refresh.update(drain_s=wave3["during"], device_freed_by_drain_gb=freed / 1e9,
                       drain_over_refresh=(wave3["during"] + cold_restart_s) / refresh_wall)
        lap("drain")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del loaded
    gc.collect()
    torch.cuda.empty_cache()
    launches = {k: rec["launches"][k] for k in ("paged_decode_attention", "dense_matmul",
                                                "rms_norm_fwd")}
    result = {"card": card, "requests": N_REQ, "prompt_len": PROMPT, "new_tokens": NEW,
              "token_budget": BUDGET, "max_burst": BURST, "lost_requests": 0,
              "gateway": gateway, "publication": publication, "refresh": refresh,
              "faults": faults, "int8_swap": quant, "lora_disk": lora, "phase_s": laps}
    log(f"[gateway-refresh] {card}: generated tokens/s gateway {gateway['gen_tokens_per_sec']:.1f}"
        f" vs direct {gateway['direct_gen_tokens_per_sec']:.1f}; inter-token p50/p99 "
        f"{gateway['inter_token_ms']['p50_ms']:.2f}/{gateway['inter_token_ms']['p99_ms']:.2f} ms,"
        f" TTFT p50/p99 {gateway['ttft_ms']['p50_ms']:.1f}/{gateway['ttft_ms']['p99_ms']:.1f} "
        f"ms; syncs/token {gateway['syncs_per_token']:.4f}; launches K2/K3/K4 a forward "
        f"{json.dumps(gateway['launches_per_forward'])}")
    log(f"[gateway-refresh] {card}: published {publication['bytes']} bytes (free disk "
        f"{publication['free_disk_before']}, host RAM available "
        f"{publication['host_ram_available_before']} bytes before) in "
        f"{publication['publish_s']:.2f} s ({publication['publish_gb_per_s']:.2f} GB/s), loaded "
        f"in {publication['load_s']:.2f} s ({publication['load_gb_per_s']:.2f} GB/s); chain "
        f"{publication['chain'][:16]}; refresh {refresh['wall_s']:.2f} s (waiting "
        f"{refresh['waiting_for_inflight_s']:.2f}, swap {refresh['swap_s']:.2f}), peak "
        f"{refresh['device_peak_during_swap_gb']:.2f} GB; drain + cold restart "
        f"{refresh['drain_s'] + refresh['cold_restart_s']:.2f} s, drain_over_refresh "
        f"{refresh['drain_over_refresh']:.2f}; p99 gap {refresh['p99_gap_steady_ms']:.1f} "
        f"steady vs {refresh['p99_gap_during_refresh_ms']:.1f} ms during the refresh")
    log(f"[gateway-refresh] {json.dumps(result)}")
    return result, launches


# ---------------------------------------------------------------- phase 31
class FleetEngines:
    """Phase 31's engines, each over the device tree of its version that it
    is handed (``_place_params`` moves nothing already on the card in
    bf16, so replicas, restarts and cold references share one tree a
    version), kept for the phase's launch gate."""

    def __init__(self, cfg, device):
        self.cfg, self.device, self.built = cfg, device, []

    def make(self, params, disagg=False):
        """Phase 31a/b's engine, or with ``disagg`` 31c's: the prefix cache
        and a DISAGG_TIER_BYTES bf16 KV tier."""
        from deepspeed_tpu_torch.inference.v2 import (DSStateManagerConfig, InferenceEngineV2,
                                                      RaggedInferenceEngineConfig)
        n, budget, ctx = ((DISAGG_N_REQ, DISAGG_BUDGET, DISAGG_LONG + DISAGG_NEW) if disagg
                          else (FLEET_N_REQ, FLEET_BUDGET, FLEET_PROMPT + FLEET_NEW))
        engine = InferenceEngineV2(self.cfg, RaggedInferenceEngineConfig(
            kv_block_size=BS, prefix_cache={"enabled": disagg},
            kv_tier={"enabled": disagg, "host_bytes": DISAGG_TIER_BYTES, "quantize": False},
            state_manager=DSStateManagerConfig(
                max_ragged_batch_size=budget, max_ragged_sequence_count=n,
                max_tracked_sequences=n, max_context=ctx)), params=params, device=self.device)
        shared = [(a.data_ptr(), b.data_ptr()) for a, b in zip(tree_leaves(engine.params),
                                                             tree_leaves(params))]
        if not shared or any(a != b for a, b in shared):
            raise AssertionError("fleet: an engine placed a second copy of the weights")
        self.built.append(engine)
        return engine

    def forwards(self):
        return sum(e.forward_steps for e in self.built)


def router_wave(router, prompts, news, specs=None, during=None, pause_every=0):
    """Submit ``prompts`` (``news[i]`` new tokens each, sampled by
    ``specs[i]`` or greedy) to ``router``, ``pause_every`` at a time 0.25 s
    apart when given, and consume each stream on its own thread; once any
    stream has a token, run ``during()`` on this thread. → {streams,
    handles, wall_s, gaps_ms, ttft_ms, lost, during, tokens}: nothing lost
    is the caller's check."""
    import threading
    n = len(prompts)
    streams, ttft, gaps, lost, handles = [None] * n, [None] * n, [], [], [None] * n
    lock = threading.Lock()

    def consume(i, t_submit):
        prev, got = None, []
        try:
            for tok in handles[i].tokens(timeout=600):
                now = time.perf_counter()
                if prev is None:
                    ttft[i] = (now - t_submit) * 1e3
                else:
                    with lock:
                        gaps.append((now - prev) * 1e3)
                prev = now
                got.append(int(tok))
            streams[i] = got
        except Exception as err:  # noqa: BLE001 — the zero-lost audit
            with lock:
                lost.append(f"request {i}: {type(err).__name__}: {err}")

    threads = []
    t0 = time.perf_counter()
    for i in range(n):
        if pause_every and i and i % pause_every == 0:
            time.sleep(0.25)  # a burst boundary
        handles[i] = router.submit(prompts[i], max_new_tokens=news[i],
                                   sample=specs[i] if specs else None)
        threads.append(threading.Thread(target=consume, args=(i, time.perf_counter())))
        threads[-1].start()
    out = None
    if during is not None:
        while not any(h._collected for h in handles) and not all(h.done for h in handles):
            time.sleep(0.001)
        out = during()
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        lost.append("a stream hung")
    return {"streams": streams, "handles": handles, "wall_s": wall, "gaps_ms": gaps,
            "ttft_ms": ttft, "lost": lost, "during": out,
            "tokens": sum(len(x) for x in streams if x)}


def cov(xs):
    return float(np.std(xs) / np.mean(xs)) if xs else 0.0


def fleet_failover(router, reps, direct, trace, sampled_prompts, spec):
    """Phase 31a: ``bench_serving_2b_fleet``'s three parts → readings."""
    n = FLEET_N_REQ
    new = [FLEET_NEW] * (n + FLEET_SAMPLED)
    want = direct["want"]
    router_wave(router, trace[:2], [2, 2])  # the pumps' first forwards
    a = router_wave(router, trace[:n], new[:n])
    b = router_wave(router, trace[n:2 * n] + sampled_prompts, new,
                    specs=[None] * n + [dict(spec)] * FLEET_SAMPLED, during=reps[0].kill)
    t0 = time.perf_counter()
    recovered = router.restart_replica("r0", timeout=600)
    restart_s = time.perf_counter() - t0
    c = router_wave(router, trace[2 * n:], new[:n])
    for name, wave, lo in (("A", a, 0), ("B", b, n), ("C", c, 2 * n)):
        if wave["lost"] or wave["streams"][:n] != want[lo:lo + n]:
            raise AssertionError(f"fleet part {name}: lost {wave['lost']}, greedy streams "
                                 f"equal the direct run's: {wave['streams'][:n] == want[lo:lo + n]}")
    seeds = [h.sample["seed"] for h in b["handles"][n:]]
    _, alone = fleet(direct["engine"], 5_000, sampled_prompts, FLEET_NEW,
                     specs=[dict(spec, seed=sd) for sd in seeds], burst=FLEET_BURST,
                     budget=FLEET_BUDGET)
    if b["streams"][n:] != alone:
        raise AssertionError("fleet: a sampled stream killed mid-generation differs from its "
                             "uninterrupted run")
    counters = router.snapshot()["counters"]
    if counters["failovers"] < 1 or counters["failed"] or not recovered or \
            router.health["r0"].state != "healthy":
        raise AssertionError(f"fleet: failovers {counters['failovers']}, failed "
                             f"{counters['failed']}, r0 recovered {recovered} "
                             f"({router.health['r0'].state})")
    return {"tokens_per_sec": {k: w["tokens"] / w["wall_s"] for k, w in
                               (("before", a), ("during", b), ("after", c))},
            "failovers": counters["failovers"], "retries": counters["retries"],
            "restart_s": restart_s, "replica_recovered": recovered, "sampled_seeds": seeds,
            "p99_gap_steady_ms": p99(a["gaps_ms"])}


def fleet_refresh(router, reps, current, cold_run, direct, trace, probe):
    """Phase 31b: ``bench_serving_2b_refresh``'s fleet protocol with the
    canary on, then a crash mid-swap and a version lie → readings."""
    from deepspeed_tpu_torch.serving import FleetRefreshController
    n = FLEET_N_REQ
    v0 = current["params"]
    ctrl = FleetRefreshController(
        router, reference_fn=lambda params, prompt, new: cold_run(params, [prompt], new)[0],
        canary_prompts=[list(probe), list(trace[0])], baseline_params=v0)
    streams = {0: {"probe": direct["probe"], "trace": direct["want"]}}
    trees = {0: v0}
    for v in (1, 2):
        trees[v] = stepped(trees[v - 1], v)
        got = cold_run(trees[v], [probe] + trace[n:], FLEET_NEW)
        streams[v] = {"probe": got[0], "trace": [None] * n + got[1:]}
    rollouts, waves, gaps = {}, {}, []
    for v, lo in ((1, n), (2, 2 * n)):
        wave = router_wave(router, trace[lo:lo + n], [FLEET_NEW] * n,
                           during=lambda v=v: ctrl.rollout(version=v, params=trees[v]))
        rep = wave["during"]
        old, new = streams[v - 1]["trace"][lo:lo + n], streams[v]["trace"][lo:lo + n]
        mixed = [s == a for s, a in zip(wave["streams"], old)]
        if wave["lost"] or rep["rolled_back"] or sorted(rep["refreshed"]) != ["r0", "r1"] or \
                rep["canary"] != "passed" or \
                any(s not in (a, b) for s, a, b in zip(wave["streams"], old, new)):
            raise AssertionError(f"fleet refresh to v{v}: lost {wave['lost']}, report {rep}")
        current["params"] = trees[v]
        gaps += wave["gaps_ms"]
        rollouts[v], waves[v] = rep, {"old_version_streams": sum(mixed),
                                      "new_version_streams": n - sum(mixed)}
    after = [[int(t) for t in r.submit(probe, max_new_tokens=FLEET_NEW).tokens(timeout=600)]
             for r in reps]
    if after != [streams[2]["probe"]] * 2 or after[0] == streams[0]["probe"]:
        raise AssertionError("fleet refresh: the replicas' probe streams after v2 differ from "
                             "each other or from a cold v2 engine's, or equal v0's")
    # the alternative: drain one replica and cold-restart it on the new weights
    reps[1].kill()
    t0 = time.perf_counter()
    if not router.restart_replica("r1", timeout=600):
        raise AssertionError("fleet refresh: r1 did not come back on v2")
    router.submit(probe, max_new_tokens=2).result(timeout=600)
    drain_restart_s = time.perf_counter() - t0
    # faults, each from v2 to v3 = the step on v2: a crash mid-swap on the second replica,
    # then a version lie on the first; the fleet back on v2 after each
    del trees[1]
    cold_run(None, [], 0)  # the cold v1 engine goes with its tree
    trees[3] = stepped(trees[2], 3)
    faults = {}
    for fault, rep_i in (("crash_mid_swap", 1), ("lie_version", 0)):
        setattr(reps[rep_i], fault, True)
        report = ctrl.rollout(version=3, params=trees[3])
        setattr(reps[rep_i], fault, False)
        state = router.health[reps[rep_i].name].state
        restarted = None
        if fault == "crash_mid_swap":
            restarted = router.restart_replica(reps[rep_i].name, timeout=600)
        probes = [[int(t) for t in r.submit(probe, max_new_tokens=FLEET_NEW).tokens(timeout=600)]
                  for r in reps]
        want_state, want_canary = (("down", "passed") if fault == "crash_mid_swap"
                                   else ("healthy", "diverged"))
        if not report["rolled_back"] or ctrl.current_version != 2 or state != want_state or \
                report["canary"] != want_canary or restarted is False or \
                probes != [streams[2]["probe"]] * 2:
            raise AssertionError(f"fleet {fault}: report {report}, {reps[rep_i].name} "
                                 f"{state}, restarted {restarted}, probes on v2 "
                                 f"{probes == [streams[2]['probe']] * 2}")
        faults[fault] = {k: report[k] for k in ("rolled_back", "canary", "demoted")}
        faults[fault]["reason"] = report["reason"][:100]  # a canary's reason lists the prompt
        faults[fault].update(rolled_back_replicas=report.get("rolled_back_replicas"),
                             replica_state=state, restarted=restarted)
    counters = router.snapshot()["counters"]
    return {"rollouts": {v: {k: r[k] for k in ("wall_s", "refreshed", "canary")}
                         for v, r in rollouts.items()},
            "in_flight": waves, "drain_restart_s": drain_restart_s,
            "drain_over_refresh": drain_restart_s / rollouts[2]["wall_s"],
            "p99_gap_during_refresh_ms": p99(gaps),
            "faults": faults, "refreshes": counters["refreshes"],
            "refresh_rollbacks": counters["refresh_rollbacks"],
            "canary_divergences": counters["canary_divergences"]}


def fleet_disagg(E, v0, vocab):
    """Phase 31c: ``bench_serving_2b_disagg``'s trace through a unified
    two-replica fleet, then a prefill/decode pair → readings."""
    from deepspeed_tpu_torch.serving import FleetConfig, FleetRouter, GatewayReplica, ServingConfig
    rng = np.random.RandomState(0)
    prompts, news = [], []
    for i in range(DISAGG_N_REQ):
        long = i % 2 == 0
        prompts.append(rng.randint(0, vocab, size=DISAGG_LONG if long else DISAGG_SHORT)
                       .astype(np.int32))
        news.append(DISAGG_NEW // 4 if long else DISAGG_NEW)
    warm = [np.random.RandomState(2).randint(0, vocab, size=DISAGG_SHORT).astype(np.int32)
            for _ in range(2)]
    scfg = ServingConfig(token_budget=DISAGG_BUDGET, max_burst=FLEET_BURST,
                         drain_timeout_s=600.0)
    runs = {}
    for mode, roles in (("unified", (None, None)), ("disagg", ("prefill", "decode"))):
        reps = [GatewayReplica(name, lambda: E.make(v0, disagg=True), serving_config=scfg,
                               role=role) for name, role in zip(("a", "b"), roles)]
        router = FleetRouter(reps, config=FleetConfig(
            disagg=mode == "disagg", prefill_max_tokens=DISAGG_PREFILL,
            heartbeat_interval_s=0.2, retry_backoff_s=0.05, stream_token_timeout_s=120.0))
        try:
            router_wave(router, warm, [2, 2])
            wave = router_wave(router, prompts, news, pause_every=4)
            snap = router.snapshot()
        finally:
            router.shutdown()
        if wave["lost"] or snap["counters"]["failed"]:
            raise AssertionError(f"fleet {mode}: lost {wave['lost']}")
        runs[mode] = {"streams": wave["streams"], "p99_ttft_ms": p99(wave["ttft_ms"]),
                      "mean_ttft_ms": float(np.mean(wave["ttft_ms"])),
                      "decode_gap_cov": cov(wave["gaps_ms"]),
                      "tokens_per_sec": wave["tokens"] / wave["wall_s"],
                      "handoffs_acked": (snap.get("disagg") or {}).get("handoffs", {})
                      .get("acked", 0),
                      "handoff_failures": snap["counters"]["handoff_failures"],
                      "unified_fallbacks": snap["counters"]["unified_fallbacks"]}
    if runs["disagg"]["streams"] != runs["unified"]["streams"]:
        raise AssertionError("fleet: the prefill/decode pair's streams differ from the unified "
                             "fleet's")
    for r in runs.values():
        del r["streams"]
    return runs


def fleet_phase(device, weights):
    """Phase 31: the in-process fleet on two Mistral-7B replicas sharing
    one device tree a version: failover under ``bench_serving_2b_fleet``'s
    protocol, the rolling refresh controller with its canary under
    ``bench_serving_2b_refresh``'s, the disaggregated pair under
    ``bench_serving_2b_disagg``'s. → (result, {kernel: launches in the
    phase, over every engine})."""
    from deepspeed_tpu_torch.device import gpu_report
    from deepspeed_tpu_torch.serving import (FaultyReplica, FleetConfig, FleetRouter,
                                             GatewayReplica, ServingConfig)
    card = gpu_report()
    cfg, v0 = weights
    L, V = cfg.num_hidden_layers, cfg.vocab_size
    E = FleetEngines(cfg, device)
    torch.cuda.reset_peak_memory_stats(device)
    c0 = serving_counters()
    laps, t_phase = {}, time.perf_counter()

    def lap(name):
        laps[name] = time.perf_counter() - t_phase - sum(laps.values())
    rng = np.random.RandomState(0)
    trace = [rng.randint(0, V, size=FLEET_PROMPT).astype(np.int32)
             for _ in range(3 * FLEET_N_REQ)]
    probe = rng.randint(0, V, size=FLEET_PROMPT).astype(np.int32)
    sampled_prompts = [rng.randint(0, V, size=FLEET_PROMPT).astype(np.int32)
                       for _ in range(FLEET_SAMPLED)]
    spec = {"temperature": 1.1, "top_k": 40}
    cold, uids = {}, iter(range(100_000, 10**9, 1_000))

    def cold_run(params, prompts, new):
        """Greedy streams of a cold-started engine on ``params`` (one kept
        a tree: it never swaps); None drops it."""
        if cold.get("params") is not params:
            if cold.get("engine") is not None:
                cold["engine"].destroy()
            cold.clear()
            if params is None:
                return None
            cold.update(params=params, engine=E.make(params))
        return fleet(cold["engine"], next(uids), prompts, new, burst=FLEET_BURST,
                     budget=FLEET_BUDGET)[1]
    direct_engine = E.make(v0)
    _, want = fleet(direct_engine, 1_000, trace + [probe], FLEET_NEW, burst=FLEET_BURST,
                    budget=FLEET_BUDGET)
    direct = {"engine": direct_engine, "want": want[:-1], "probe": want[-1]}
    lap("direct")
    current = {"params": v0}
    scfg = ServingConfig(token_budget=FLEET_BUDGET, max_burst=FLEET_BURST,
                         drain_timeout_s=600.0)
    reps = [FaultyReplica(GatewayReplica(name, lambda: E.make(current["params"]),
                                         serving_config=scfg)) for name in ("r0", "r1")]
    router = FleetRouter(reps, config=FleetConfig(
        heartbeat_interval_s=0.2, retry_backoff_s=0.05, stream_token_timeout_s=120.0,
        refresh_timeout_s=600.0, refresh_canary_max_new=FLEET_NEW))
    try:
        failover = fleet_failover(router, reps, direct, trace, sampled_prompts, spec)
        direct_engine.destroy()
        lap("31a_failover")
        refresh = fleet_refresh(router, reps, current, cold_run, direct, trace, probe)
        lap("31b_refresh")
    finally:
        router.shutdown()
        cold_run(None, [], 0)
    del current
    gc.collect()
    torch.cuda.empty_cache()
    peak_refresh = torch.cuda.max_memory_allocated(device)
    disagg = fleet_disagg(E, v0, V)
    lap("31c_disagg")
    rec = {"forwards": E.forwards(), "launches": counters_since(c0)}
    check_lane_launches(rec, L, "fleet phase (every engine)")
    launches = {k: rec["launches"][k] for k in ("paged_decode_attention", "dense_matmul",
                                                "rms_norm_fwd")}
    result = {"card": card, "replicas": 2, "trace": [3 * FLEET_N_REQ, FLEET_PROMPT, FLEET_NEW],
              "engines_built": len(E.built), "forwards": rec["forwards"],
              "launches": launches, "launches_by_design": {
                  k: rec["launches"][k] for k in ("paged_by_design", "dense_by_design")},
              "lost_requests": 0, "failover": failover, "refresh": refresh, "disagg": disagg,
              "device_peak_gb": peak_refresh / 1e9, "tree_gb": tree_bytes(v0) / 1e9,
              "phase_s": laps}
    tps = failover["tokens_per_sec"]
    log(f"[fleet] {card}: 31a tokens/s before/during/after the kill {tps['before']:.1f}/"
        f"{tps['during']:.1f}/{tps['after']:.1f}, failovers {failover['failovers']}, retries "
        f"{failover['retries']}, restart {failover['restart_s']:.2f} s")
    log(f"[fleet] {card}: 31b rollouts v0->v1 {refresh['rollouts'][1]['wall_s']:.2f} s, "
        f"v1->v2 {refresh['rollouts'][2]['wall_s']:.2f} s; drain + restart "
        f"{refresh['drain_restart_s']:.2f} s, drain_over_refresh "
        f"{refresh['drain_over_refresh']:.2f}; p99 inter-token gap steady "
        f"{failover['p99_gap_steady_ms']:.1f} ms, during the rollouts "
        f"{refresh['p99_gap_during_refresh_ms']:.1f} ms; faults "
        f"{json.dumps({k: v['reason'] for k, v in refresh['faults'].items()})}")
    log(f"[fleet] {card}: 31c unified p99 TTFT {disagg['unified']['p99_ttft_ms']:.1f} ms, gap "
        f"CoV {disagg['unified']['decode_gap_cov']:.3f}; disagg p99 TTFT "
        f"{disagg['disagg']['p99_ttft_ms']:.1f} ms, gap CoV "
        f"{disagg['disagg']['decode_gap_cov']:.3f}, handoffs {disagg['disagg']['handoffs_acked']}"
        f", fallbacks {disagg['disagg']['unified_fallbacks']}; device peak "
        f"{peak_refresh / 1e9:.2f} GB (a tree {tree_bytes(v0) / 1e9:.2f} GB); launches "
        f"{json.dumps(launches)} over {rec['forwards']} forwards of {len(E.built)} engines")
    log(f"[fleet] {json.dumps(result)}")
    return result, launches


def grid_fraction_of(cfg):
    """The layout density the model's sparse section gives at BERT_S."""
    from deepspeed_tpu_torch.models.bert import _sparse_self_attention
    from deepspeed_tpu_torch.ops.kernels.block_sparse_attention import grid_fraction
    ssa = _sparse_self_attention(cfg.sparse_attention, cfg.num_attention_heads,
                                 cfg.max_position_embeddings, BERT_S)
    return grid_fraction(ssa._layout(BERT_S))


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

    def lap(what):  # where the run's wall time goes, for its limit
        log(f"[time] {what} done {time.perf_counter() - t0:.1f} s into the run")

    with ThreadPoolExecutor(len(build.SOURCES)) as pool:  # one nvcc per source, together
        built = list(pool.map(build.build, build.SOURCES))
    log(f"[build] all sources in {time.perf_counter() - t0:.2f} s")
    for src, (path, report, seconds) in zip(build.SOURCES, built):
        log(f"[build] {src} -> {path.name} in {seconds:.2f} s"
            + ("" if report is not None else " (reused)"))
        for line in (report or "").splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                log(f"[build] {src}: {line.strip()[:160]}")
    designs = flash_designs()
    log(f"[build] flash_attention.cu designs (SASS): {json.dumps(designs)}")
    lap("phase 2 (build)")

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    cases = kernel_phase(device, flush)
    dense_cases = dense_matmul_cases(device, flush)
    train_cases = train_kernel_phase(device, flush)
    lap("phases 3, 4b (a), 6 (kernels)")
    del flush
    torch.cuda.empty_cache()
    parity_phase(device)
    batch_invariance_phase(device)
    serving, launches = serving_phase(device)
    train_parity_phase(device)
    training, train_launches = training_phase(device)
    lap("phases 4, 4b, 5, 7, 8 (serving, training)")

    # quantized and MoE serving; every earlier engine and training state is gone
    torch.cuda.empty_cache()
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    qmm_cases = quant_matmul_cases(device, flush)
    grouped = grouped_cases(device, flush)
    del flush
    torch.cuda.empty_cache()
    moe_parity_phase(device)
    int8_serving, int8_launches = moe_serving_phase(device, "int8", MOE_INT8_LAYERS)
    _, bf16_launches = moe_serving_phase(device, "none", MOE_BF16_LAYERS)
    lap("phases 9-12 (quantized and MoE serving)")

    # multi-tenant LoRA serving of Mistral-7B
    torch.cuda.empty_cache()
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    lora_cases = lora_kernel_cases(device, flush)
    del flush
    torch.cuda.empty_cache()
    lora_parity_phase(device)
    _, lora_launches = lora_serving_phase(device)
    lap("phases 13-15 (LoRA)")

    # the radix prefix cache, the host KV spill tier (bf16, int8) and suspend/resume
    torch.cuda.empty_cache()
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    k7_rows = k7_cases(device, flush)
    del flush
    host_copy_readings(device)
    torch.cuda.empty_cache()
    tier_parity_phase(device)
    _, k7_launches = kv_tier_phase(device)
    lap("phases 16-18 (prefix cache, KV tier)")

    # MoE training at Mixtral-8x7B width: K5's backward kernels
    torch.cuda.empty_cache()
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    bwd = gmm_bwd_cases(device, flush)
    del flush
    torch.cuda.empty_cache()
    moe_train_parity, frozen_launches = moe_train_parity_phase(device)
    grouped["gmm_quant"].append(moe_train_parity["frozen_base"]["forward"])
    _, moe_train_launches_run = mixtral_training_phase(device)
    bench_train_moe_phase(device)
    lap("phases 19-22 (MoE training)")

    # BERT-large training at S 4096 with BigBird block-sparse attention: K8, K2's LayerNorm
    torch.cuda.empty_cache()
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    sparse_cases = sparse_kernel_phase(device, flush)
    del flush
    torch.cuda.empty_cache()
    bert_parity_phase(device)
    bert, bert_launches = bert_training_phase(device)
    lap("phases 23-25 (BERT)")

    # on-device sampling on the Mistral-7B ragged engine
    torch.cuda.empty_cache()
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    _, sampled_launches = sampled_serving_phase(device, flush)
    del flush
    lap("phase 26 (sampled serving)")

    # speculative and constrained decoding on the Mistral-7B ragged engine, one set of weights
    weights = serving_params(device)
    _, spec_launches = spec_serving_phase(device, weights)
    _, json_launches = json_serving_phase(device, weights)
    _, async_launches = async_serving_phase(device, weights)
    lap("phases 27-29 (speculative and constrained decoding, pipelined bursts)")

    # the serving gateway and live weight refresh on the same weights
    _, gateway_launches = gateway_refresh_phase(device, weights)
    gc.collect()
    torch.cuda.empty_cache()
    lap("phase 30 (gateway, weight refresh)")

    # the in-process fleet and its rolling refresh: two replicas on the same weights
    _, fleet_launches = fleet_phase(device, weights)
    del weights
    gc.collect()
    torch.cuda.empty_cache()
    lap("phase 31 (fleet)")

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
                "design": main_case["design"], "first_design_ms": main_case["first_design_ms"],
                "launches_by_design": serving["designs"]["K3"],
                "launches_sampled_serving": sampled_launches["paged_decode_attention"],
                "launches_spec_verify": spec_launches["paged_decode_attention"],
                "launches_constrained_serving": json_launches["paged_decode_attention"],
                "launches_async_serving": async_launches["paged_decode_attention"],
                "launches_gateway": gateway_launches["paged_decode_attention"],
                "launches_fleet": fleet_launches["paged_decode_attention"],
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
        if name in designs:
            kernels[-1]["design"] = designs[name]
            kernels[-1]["library_call"] = main_row["library_call"]
        if name == "rms_norm_fwd":  # the serving path's norms too
            kernels[-1]["launches_spec_verify"] = spec_launches["rms_norm_fwd"]
            kernels[-1]["launches_async_serving"] = async_launches["rms_norm_fwd"]
            kernels[-1]["launches_gateway"] = gateway_launches["rms_norm_fwd"]
            kernels[-1]["launches_fleet"] = fleet_launches["rms_norm_fwd"]
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
    slice3["gmm"][2].extend(bwd["gmm_dx"])  # gmm's dx reads the stack as stored; counted as gmm
    slice3["gmm"][2].extend(bwd["gmm_fwd"])  # and the forward at the training shape
    slice3["gmm"][2].extend(bwd["tables"])  # and the wgmma designs' work-list kernel
    for name, (src, replaces, rows, main_name, n, shape) in slice3.items():
        main_row = next(r for r in rows if r["case"] == main_name)
        kernels.append({"name": name, "route": "cuda",
                        "source": f"deepspeed_tpu_torch/csrc/{src}",
                        "replaces": f"deepspeed_tpu/ops/pallas/{replaces}",
                        "launches": n, "max_abs_err": max(r["max_abs_err"] for r in rows),
                        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
                        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
                        "library_ms": main_row["library_ms"], "shape": shape, "cases": rows})
        if name == "quant_matmul":  # the main case's design, the serving run's K4 launches
            kernels[-1].update(design=main_row["design"],
                               first_design_ms=main_row["first_design_ms"],
                               forwards_by_design=int8_serving["k4_forwards"])
        if name == "gmm_quant":  # the main case's design, and the serving run's forwards by design
            kernels[-1].update(design=main_row["design"],
                               first_design_ms=main_row["first_design_ms"],
                               forwards_by_design=int8_serving["forward_split"],
                               tile_invariance=grouped["tile_invariance"])
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
                             "[4096, 4096], rank 8, 9 slots, bf16",
                    "design": main_row["design"], "first_design_ms": main_row["first_design_ms"],
                    "cases": lora_cases})
    main_row = next(r for r in k7_rows if r["case"] == "slab_bf16_n2")
    kernels.append({"name": "quantize_int8", "route": "cuda",
                    "source": "deepspeed_tpu_torch/csrc/quantization.cu",
                    "replaces": "deepspeed_tpu/ops/pallas/quantization.py:28",
                    "launches": k7_launches["quantize_int8"],
                    "max_abs_err": max(r["quant_max_abs_err"] for r in k7_rows),
                    "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
                    "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
                    "library_ms": None,
                    "shape": "KV tier demotion: one of k, v of 2 Mistral-7B blocks "
                             "[32, 2, 32, 8, 128] bf16, one group a (layer, block) slab",
                    "design": main_row["design"], "first_design_ms": main_row["first_design_ms"],
                    "profiled_us": main_row["profiled_us"],
                    "first_design_profiled_us": main_row["first_design_profiled_us"],
                    "launches_by_design": k7_launches["quantize_int8_by_design"],
                    "cases": k7_rows})
    main_row = next(r for r in k7_rows if r["case"] == "slab_bf16_n12")
    kernels.append({"name": "dequantize_int8", "route": "cuda",
                    "source": "deepspeed_tpu_torch/csrc/quantization.cu",
                    "replaces": "deepspeed_tpu/ops/pallas/quantization.py:48",
                    "launches": k7_launches["dequantize_int8"],
                    "max_abs_err": max(r["max_abs_err"] for r in k7_rows),
                    "ms": main_row["dequant_ms"], "plain_ms": main_row["dequant_plain_ms"],
                    "bound_ms": main_row["dequant_bound_ms"], "bound_by": "bytes",
                    "library_ms": None,
                    "shape": "KV tier promotion: 12 Mistral-7B blocks' int8 k [32, 12, 32, 8, "
                             "128] -> bf16, one scale a (layer, block) slab"})
    slice6 = {  # name: (TPU kernel, cases, main case, launches on the main path, shape)
        "gmm_dw": ("grouped_matmul.py:45", bwd["gmm_dw"], "dw_w1",
                   moe_train_launches_run["gmm_dw"],
                   "MoE training: dW of w1 [8, 4096, 14336] over 8192 rows (B 2 x S 2048, "
                   "top-2), expert 7 empty, 64-row tiles, bf16"),
        "gmm_quant_dx": ("grouped_matmul.py:265", bwd["gmm_quant_dx"], "int8_dx_w1",
                         frozen_launches["gmm_quant_dx"],
                         "frozen int8 base: dx through w1 [8, 4096, 14336] carriers over 8192 "
                         "rows, bf16"),
    }
    for name, (replaces, rows, main_name, n, shape) in slice6.items():
        main_row = next(r for r in rows if r["case"] == main_name)
        kernels.append({"name": name, "route": "cuda",
                        "source": "deepspeed_tpu_torch/csrc/grouped_matmul.cu",
                        "replaces": f"deepspeed_tpu/ops/pallas/{replaces}",
                        "launches": n, "max_abs_err": max(r["max_abs_err"] for r in rows),
                        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
                        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
                        "library_ms": main_row["library_ms"], "shape": shape, "cases": rows})
    main_row = next(r for r in dense_cases if r["case"] == "M16_4096x14336")
    kernels.append({"name": "dense_matmul", "route": "cuda",
                    "source": "deepspeed_tpu_torch/csrc/fused_quant_matmul.cu",
                    "replaces": "deepspeed_tpu/inference/v2/model_runner.py:62 (the dense "
                                "projection, an XLA dot; K4's template, bf16 weight)",
                    "launches": serving["dense_matmul_launches"],
                    "max_abs_err": max(r["max_abs_err"] for r in dense_cases),
                    "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
                    "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
                    "library_ms": main_row["library_ms"],
                    "shape": "serving decode step: M=16 x [4096, 14336] bf16 (gate, up)",
                    "design": main_row["design"], "first_design_ms": main_row["first_design_ms"],
                    "forwards_by_design": serving["k4_forwards"],
                    "launches_sampled_serving": sampled_launches["dense_matmul"],
                    "launches_spec_verify": spec_launches["dense_matmul"],
                    "launches_constrained_serving": json_launches["dense_matmul"],
                    "launches_async_serving": async_launches["dense_matmul"],
                    "launches_gateway": gateway_launches["dense_matmul"],
                    "launches_fleet": fleet_launches["dense_matmul"],
                    "cases": dense_cases})
    slice7 = {  # name: (source, TPU kernel, shape)
        "block_sparse_fwd": ("block_sparse_attention.cu", "block_sparse_attention.py:71",
                             "BERT-large path: B=4, S=4096, H=16, Dh=64, BigBird block 64, bf16"),
        "block_sparse_dq": ("block_sparse_attention.cu", "block_sparse_attention.py:107",
                            "BERT-large path: B=4, S=4096, H=16, Dh=64, BigBird block 64, bf16"),
        "block_sparse_dkv": ("block_sparse_attention.cu", "block_sparse_attention.py:139",
                             "BERT-large path: B=4, S=4096, H=16, Dh=64, BigBird block 64, "
                             "bf16"),
        "layer_norm_fwd": ("fused_norms.cu", "fused_norms.py:26",
                           "BERT-large path: [16384, 1024] bf16, bf16 scale and bias"),
    }
    for name, (src, replaces, shape) in slice7.items():
        rows = sparse_cases[name]
        main_row = next(r for r in rows if r["case"] == "path")
        kernels.append({"name": name, "route": "cuda",
                        "source": f"deepspeed_tpu_torch/csrc/{src}",
                        "replaces": f"deepspeed_tpu/ops/pallas/{replaces}",
                        "launches": bert_launches[name],
                        "max_abs_err": max(r["max_abs_err"] for r in rows),
                        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
                        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
                        "library_ms": main_row["library_ms"], "shape": shape, "cases": rows})
        if name in bert["k8_launches_by_design"]:  # the path's design, the first's time
            kernels[-1].update(design=main_row["design"],
                               first_design_ms=main_row["first_design_ms"],
                               launches_by_design=bert["k8_launches_by_design"][name])
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
