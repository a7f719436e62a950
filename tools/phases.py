"""Runs some of ``chip_smoke.py``'s phases alone, on one GPU.

    python3 tools/phases.py sparse bert k7 invariance sampled spec json async refresh fleet wire

Builds the kernel sources those phases need (one ``nvcc`` each, all
started together), then runs each named phase as ``chip_smoke.py`` runs
it, with its checks, and prints its lines. The phases:

- ``sparse``: phase 23 (``sparse_kernel_phase``: K8's forward, dQ and
  dK/dV, and the LayerNorm forward, at every ``SPARSE_CASES`` case);
- ``bert_parity``: phase 24 (``bert_parity_phase``);
- ``bert``: phase 25 (``bert_training_phase``: bert-large at S 4096 with
  BigBird block 64, K8's device ms a step by kernel and by design);
- ``k7``: phase 16's kernel cases (``k7_cases``: K7's quantize and
  dequantize at the KV tier's shapes, each timed by CUDA events and by
  the profiler);
- ``invariance``: phase 4b (``batch_invariance_phase``: the per-op rows
  reading, K3's chunk reading and the 2-layer engine's trace, gated);
- ``sampled``: phase 26 (``sampled_serving_phase``: on-device sampling on
  the Mistral-7B engine under ``bench_serving_2b_sampled``'s protocol);
- ``spec``: phase 27 (``spec_serving_phase``: speculative decoding on the
  Mistral-7B engine under ``bench_serving_2b_spec``'s protocol);
- ``json``: phase 28 (``json_serving_phase``: constrained decoding on the
  Mistral-7B engine under ``bench_serving_2b_json``'s protocol);
- ``async``: phase 29 (``async_serving_phase``: pipelined decode bursts
  against synchronous ones on the Mistral-7B engine under
  ``bench_serving_v2_ragged``'s protocol, with the ``DS_SANITIZE`` gate);
- ``refresh``: phase 30 (``gateway_refresh_phase``: the serving gateway
  under ``bench_serving_v2_ragged``'s traffic, then a live weight refresh
  under ``bench_serving_2b_refresh``'s protocol, publication faults, an
  int8 swap and the LoRA disk tier, on the Mistral-7B engine);
- ``fleet``: phase 31 (``fleet_phase``: two Mistral-7B replicas behind a
  ``FleetRouter`` under ``bench_serving_2b_fleet``'s protocol with a
  replica killed mid-trace, the ``FleetRefreshController``'s rollouts
  with the canary, a crash mid-swap and a version lie, and a
  prefill/decode pair against a unified fleet).
- ``wire``: phase 32 (``wire_phase``: two Mistral-7B replica processes
  of the port's entry point under a ``FleetSupervisor``, reached over the
  wire behind a ``FleetRouter``, under ``bench_serving_2b_fleet_mp``'s
  protocol with r0 ``kill -9``ed mid-trace and relaunched, against the
  in-process fleet on the same trace).

Run it from the root of a checkout on a machine with a CUDA device. The
last line is ``{"ok": true}`` when every phase passed.
"""

import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from deepspeed_tpu_torch.ops.kernels import build  # noqa: E402

SPARSE = ("block_sparse_attention.cu", "fused_norms.cu", "flash_attention.cu")
SERVING = ("paged_attention.cu", "fused_quant_matmul.cu", "fused_norms.cu")
GATEWAY = SERVING + ("lora_matmul.cu",)
PHASES = {  # name: (sources, run(device, flush))
    "sparse": (SPARSE, cs.sparse_kernel_phase),
    "bert_parity": (SPARSE, lambda device, flush: cs.bert_parity_phase(device)),
    "bert": (SPARSE, lambda device, flush: cs.bert_training_phase(device)),
    "k7": (("quantization.cu",), cs.k7_cases),
    "invariance": (SERVING, lambda device, flush: cs.batch_invariance_phase(device)),
    "sampled": (SERVING, cs.sampled_serving_phase),
    "spec": (SERVING, lambda device, flush: cs.spec_serving_phase(device)),
    "json": (SERVING, lambda device, flush: cs.json_serving_phase(device)),
    "async": (SERVING, lambda device, flush: cs.async_serving_phase(device)),
    "refresh": (GATEWAY, lambda device, flush: cs.gateway_refresh_phase(device)),
    "fleet": (GATEWAY, lambda device, flush: cs.fleet_phase(device, cs.serving_params(device))),
    "wire": (GATEWAY, lambda device, flush: cs.wire_phase(device, cs.serving_params(device))),
}


def main(names):
    if not torch.cuda.is_available():
        print("phases: no CUDA device", file=sys.stderr)
        return 2
    unknown = [n for n in names if n not in PHASES]
    if unknown or not names:
        print(f"phases: name phases among {sorted(PHASES)}, got {names}", file=sys.stderr)
        return 2
    from deepspeed_tpu_torch.device import gpu_report
    device = torch.device("cuda", 0)
    cs.log(f"[device] {gpu_report()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sources = sorted({s for n in names for s in PHASES[n][0]})
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        built = list(pool.map(build.build, sources))
    for src, (_, report, seconds) in zip(sources, built):
        cs.log(f"[build] {src} in {seconds:.2f} s")
        for line in (report or "").splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                cs.log(f"[build] {src}: {line.strip()[:160]}")
    for name in names:
        flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
        PHASES[name][1](device, flush)
        del flush
        torch.cuda.empty_cache()
        cs.log(f"[time] {name} done {time.perf_counter() - t0:.1f} s into the run")
    cs.log(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
