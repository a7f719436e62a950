"""Where K7's quantize spends its time, on one GPU.

Times ``quantize_int8`` (``deepspeed_tpu_torch/csrc/quantization.cu``) at
the KV tier's shapes (one of k or v of n Mistral-7B blocks, [32, n, 32, 8,
128] bf16, one group a 32768-value (layer, block) slab; n = 2 is a
demotion) by the profiler's kernel span (``chip_smoke.profiled_us``, L2
flushed before each call) and prints one JSON line a reading:

- ``groups``: the cluster design and the two-pass design, as built from
  the source, at n = 2, 4, 8, 12 and 16 (64 to 512 groups), on random
  values and with one KV head of every slab all zeros (as
  ``chip_smoke.py``'s K7 cases make them): where one block a group
  (two-pass) starts to beat a cluster a group;
- ``floors`` at n = 2 and 16:
  two one-pass kernels over the same bytes: the dequantize kernel (1 byte
  in, 2 out a value) and ``x.to(torch.int8)`` (2 in, 1 out: the
  quantize's traffic with one conversion a value and no reduction); and
  the cluster design built from copies of the source (under
  ``build/torch_kernels/``; the repository's source is not changed) with
  other block sizes and values a thread: (threads, values) = (256, 16) is
  the source's own, then (512, 8), (512, 16) and (1024, 8), each with the
  cluster size that gives it.

Run it from the root of a checkout on a machine with a CUDA device::

    python3 tools/k7_probe.py
"""

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (the profiler's timer)
from deepspeed_tpu_torch.ops.kernels import build  # noqa: E402
from deepspeed_tpu_torch.ops.kernels import quantization as tq  # noqa: E402

SLAB = 32 * 8 * 128
BLOCKS = (2, 16)
SWEEP = (2, 4, 8, 12, 16)
VARIANTS = ((256, 16), (512, 8), (512, 16), (1024, 8))  # (threads a block, values a thread)


def variant_source(threads, values):
    """The source with the cluster design's block size and values a thread
    changed, and nothing else."""
    src = (build.CSRC / "quantization.cu").read_text()
    a = src.index("// ------------------------------------------------------------ cluster design")
    b = src.index("__device__ __forceinline__ void store8(uint16_t* p")
    part = src[a:b]
    edits = [("kThreads", "kCThreads"),
             ("cs * kCThreads * 16 < gs", f"cs * kCThreads * {values} < gs"),
             ("constexpr int kUnits = 4;", f"constexpr int kUnits = {max(4, values // 4)};")]
    for old, new in edits:
        if old not in part:
            raise RuntimeError(f"variant: the source changed near {old!r}")
        part = part.replace(old, new)
    part = f"constexpr int kCThreads = {threads};\n" + part
    return src[:a] + part + src[b:]


def variant_library(threads, values):
    out = build.BUILD_DIR / "quantization_variants"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / f"t{threads}_v{values}.cu", out / f"t{threads}_v{values}.so"
    cu.write_text(variant_source(threads, values))
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
                           str(so), str(cu)], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise build.KernelBuildError(proc.stdout[-4000:])
    lib = ctypes.CDLL(str(so))
    lib.ds_quantize_int8.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + \
        [ctypes.c_int] * 4 + [ctypes.c_uint, ctypes.c_int, ctypes.c_void_p]
    lib.ds_quantize_int8.restype = ctypes.c_int
    return lib


def main():
    if not torch.cuda.is_available():
        print("k7_probe: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    libs = {v: variant_library(*v) for v in VARIANTS}
    print(json.dumps({"device": torch.cuda.get_device_name(0)}), flush=True)
    for n in SWEEP:
        g = torch.Generator(device=device).manual_seed(n)
        x = (torch.randn((32, n, 32, 8, 128), generator=g, device=device) * 2).to(torch.bfloat16)
        row = {"reading": "groups", "blocks": n, "groups": x.numel() // SLAB}
        for zeros in (False, True):
            if zeros:
                x[:, :, :, 0] = 0
            for design in ("cluster", "two_pass"):
                row[f"{design}{'_zero_head' if zeros else ''}_us"] = cs.profiled_us(
                    lambda: tq.quantize_int8(x, SLAB, design=design), flush, "quant")
        print(json.dumps(row), flush=True)
        del x
    for n in BLOCKS:
        g = torch.Generator(device=device).manual_seed(n)
        x = (torch.randn((32, n, 32, 8, 128), generator=g, device=device) * 2).to(torch.bfloat16)
        groups = x.reshape(-1, SLAB)
        G = groups.shape[0]
        v, s, shape = tq.quantize_int8(x, SLAB)
        row = {"reading": "floors", "blocks": n, "groups": G, "values": x.numel(),
               "bound_us": cs.k7_bound(x.numel(), 2, 1, G)[0] * 1e3}
        for design in ("cluster", "two_pass"):
            row[design + "_us"] = cs.profiled_us(
                lambda: tq.quantize_int8(x, SLAB, design=design), flush, "quant")
        row["dequantize_us"] = cs.profiled_us(lambda: tq.dequantize_int8(v, s, shape), flush,
                                              "dequant")
        row["to_int8_us"] = cs.profiled_us(lambda: x.to(torch.int8), flush, "copy")
        want = tq.quantize_int8_ref(groups)
        for (threads, values), lib in libs.items():
            out_v = torch.empty((G, SLAB), dtype=torch.int8, device=device)
            out_s = torch.empty(G, dtype=torch.float32, device=device)

            def run():
                rc = lib.ds_quantize_int8(groups.data_ptr(), out_v.data_ptr(), out_s.data_ptr(),
                                          G, SLAB, 0, 1, 0, 0, 1,
                                          torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"variant {threads}x{values}: cudaError {rc}")
            key = f"cluster_t{threads}_v{values}"
            row[key + "_us"] = cs.profiled_us(run, flush, "quant")
            torch.cuda.synchronize()
            row[key + "_bitwise"] = bool(torch.equal(out_v, want[0])
                                         and torch.equal(out_s, want[1]))
        print(json.dumps(row), flush=True)
        del x, groups, v, s
    return 0


if __name__ == "__main__":
    sys.exit(main())
