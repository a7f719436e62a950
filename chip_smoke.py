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
   busy share).

The last lines are the card, one JSON object with every kernel's numbers
and, last, ``{"ok": true, "device": {...}}``."""

import json
import math
import sys
import time

import numpy as np
import torch

H, HKV, DH, BS = 32, 8, 128, 32   # Mistral-7B attention, the serving block size
HBM_BYTES_PER_S = 3.35e12         # H100 SXM
BF16_FLOPS_PER_S = 989e12         # H100 SXM, dense
KERNEL_TOL = 2e-2
PATH_TOL_ULPS = 2
N_REQ, PROMPT, NEW, BUDGET, BURST = 16, 128, 64, 512, 16


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
def add_requests(engine, n, plen, ntok, seed):
    from deepspeed_tpu_torch.inference.v2 import DynamicSplitFuseScheduler
    rng = np.random.RandomState(seed)
    sched = DynamicSplitFuseScheduler(engine, token_budget=BUDGET, max_burst=BURST)
    for uid in range(n):
        sched.add_request(uid, rng.randint(0, engine.model_config.vocab_size,
                                           size=plen).astype(np.int32), max_new_tokens=ntok)
    return sched


def run_requests(engine, n, plen, ntok, seed):
    sched = add_requests(engine, n, plen, ntok, seed)
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
    out = {"forwards": forwards, "wall_ms": wall_ms, "device_ms": busy,
           "device_busy_share": busy / wall_ms if rows else None,
           "kernels_launched": sum(r[2] for r in rows),
           "top": [{"name": n[:70], "ms": ms, "calls": c} for n, ms, c in rows[:10]]}
    if not rows:
        out["note"] = "profiler recorded no device time: not measured"
    return out


def profile_steps(engine):
    """The same traffic once more, with torch.profiler around two
    scheduler steps only (its post-processing grows with the events): the
    first (a 512-token prefill step) and the first decode burst. → device
    time by kernel and the device's busy share of each step's wall time."""
    from torch.profiler import ProfilerActivity, profile
    sched = add_requests(engine, N_REQ, PROMPT, NEW, seed=0)
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

    for src in build.SOURCES:
        path, report, seconds = build.build(src)
        log(f"[build] {src} -> {path.name} in {seconds:.2f} s"
            + ("" if report is not None else " (reused)"))
        for line in (report or "").splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                log(f"[build] {src}: {line.strip()[:160]}")

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    cases = kernel_phase(device, flush)
    del flush
    torch.cuda.empty_cache()
    parity_phase(device)
    serving, launches = serving_phase(device)

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
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
