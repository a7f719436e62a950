"""Where K8's wgmma designs spend their time, on one GPU.

Runs ``block_sparse_fwd``, ``block_sparse_dq`` and ``block_sparse_dkv``
(their wgmma designs, ``deepspeed_tpu_torch/csrc/block_sparse_attention.cu``)
at BERT-large's path shape (B 4, S 4096, H 16, Dh 64, block 64) and prints
one JSON line a reading:

- ``layouts``: banded layouts of 1, 2, 6, 16 and 64 blocks a row (64 is
  dense) beside BigBird: µs per 64-row tile and SM. Items of w tiles cost
  a + o / w per tile, so the widths separate a tile's cost from an
  item's; the dense row also times K1's non-causal forward, dQ and dK/dV,
  which do the same work in tiles of their own;
- ``lead``: BigBird with the take order's ``lead`` at 0, the schedule's
  own and rows (every rank leads: rank-major, the first design's grid
  order): what starting the global row and column first, and the head
  groups after them, buy;
- ``trace``: the same kernels built from a copy of the source with
  ``globaltimer`` stamps (the copy goes under ``build/torch_kernels/``; the
  repository's source is not changed): per block and item, when its slot
  and first tile were ready, when its tiles were done and when its stores
  had read its slot.
  Medians over the blocks and items of one BigBird and one 6-wide banded
  call. The timer ticks in 0.256 µs.

Run it from the root of a checkout on a machine with a CUDA device::

    python3 tools/bsa_probe.py
"""

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (the timer, the inputs and the layouts)
from deepspeed_tpu_torch.ops.kernels import block_sparse_attention as bsa  # noqa: E402
from deepspeed_tpu_torch.ops.kernels import build  # noqa: E402
from deepspeed_tpu_torch.ops.kernels import flash_attention as fa  # noqa: E402

B, S, H, D, BLOCK = 4, 4096, 16, 64, 64
WIDTHS = (1, 2, 6, 16, 64)


def band(width):
    """Each row admits the `width` blocks from its own on, wrapping."""
    n = S // BLOCK
    layout = np.zeros((1, n, n), bool)
    for r in range(n):
        layout[0, r, [(r + j) % n for j in range(width)]] = True
    return bsa.full_layout(layout, H, S, BLOCK)


def inputs(device):
    c = cs.flash_case(234, B, S, H, D, False, 0, device)
    return c["q"], c["k"], c["v"], c["do"]


def backward(q, k, v, do, layout):
    """→ the schedule and the three kernels as zero-argument calls."""
    sched = bsa.schedule(layout, q.device)
    o, lse = bsa.block_sparse_fwd(q, k, v, sched, BLOCK)
    delta = fa.flash_delta(o, do)
    return sched, {"fwd": lambda: bsa.block_sparse_fwd(q, k, v, sched, BLOCK),
                   "dq": lambda: bsa.block_sparse_dq(q, k, v, do, lse, delta, sched, BLOCK),
                   "dkv": lambda: bsa.block_sparse_dkv(q, k, v, do, lse, delta, sched, BLOCK)}


def sms(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def layouts_reading(q, k, v, do, flush):
    for name, layout in [(f"band{w}", band(w)) for w in WIDTHS] + \
            [("bigbird", bsa.full_layout(cs.bigbird_layout(H, S, BLOCK), H, S, BLOCK))]:
        _, calls = backward(q, k, v, do, layout)
        tiles = int(layout.sum()) * B
        row = {"reading": "layouts", "layout": name, "tiles": tiles}
        for key, fn in calls.items():
            ms = cs.time_ms(fn, flush)
            row[key + "_ms"] = ms
            row[key + "_us_per_tile_sm"] = ms * 1e3 * sms(q.device) / tiles
        if name == "band64":
            row["k1_fwd_ms"] = cs.time_ms(lambda: fa.flash_fwd(q, k, v, None, False), flush)
            fo, flse = fa.flash_fwd(q, k, v, None, False)
            fdelta = fa.flash_delta(fo, do)
            row["k1_dq_ms"] = cs.time_ms(
                lambda: fa.flash_bwd_dq(q, k, v, do, flse, fdelta, None, False), flush)
            row["k1_dkv_ms"] = cs.time_ms(
                lambda: fa.flash_bwd_dkv(q, k, v, do, flse, fdelta, None, False), flush)
        print(json.dumps(row), flush=True)


def lead_reading(q, k, v, do, flush):
    """BigBird with the take order's ``lead`` at 0, the schedule's own and
    rows (every rank leads: the first design's rank-major order)."""
    sched, calls = backward(q, k, v, do,
                            bsa.full_layout(cs.bigbird_layout(H, S, BLOCK), H, S, BLOCK))
    own = (sched.k_lead, sched.q_lead)
    try:
        for lead in (0, own[0], S // BLOCK):
            sched.k_lead = sched.q_lead = lead
            print(json.dumps({"reading": "lead", "lead": lead, "schedule_lead": own[0],
                              **{key + "_ms": cs.time_ms(fn, flush)
                                 for key, fn in calls.items()}}), flush=True)
    finally:
        sched.k_lead, sched.q_lead = own


# ------------------------------------------------------------------ trace
EVENTS = ("slot", "first_tile", "tiles_done", "stored")  # consumer 0's thread 0, per item


def traced_source():
    """The kernel source with globaltimer stamps: event e of item j of block
    x at g_trace[(x * 32 + j % 32) * 8 + e], and the item's tile count at
    slot 7."""
    src = (build.CSRC / "block_sparse_attention.cu").read_text()
    stamp = ("__device__ unsigned long long g_trace[1 << 22];\n"
             "__device__ __forceinline__ unsigned long long gtime() {\n"
             "  unsigned long long t;\n"
             "  asm volatile(\"mov.u64 %0, %globaltimer;\" : \"=l\"(t));\n  return t;\n}\n")
    src = src.replace("namespace {\n", "namespace {\n" + stamp, 1)

    def rec(e, val="gtime()"):
        return (f"if (threadIdx.x == 128) {{ g_trace[((size_t)blockIdx.x * 32 + (j & 31)) * 8 + "
                f"{e}] = {val}; }}")

    edits = [  # (text, count, what goes after it, or before it when the flag is set)
        # an item's slot is ready
        ("    hopper::mbar_wait(&slot_full[slot], (j >> 1) & 1);\n", 3, rec(0), False),
        # its first tile is in (dK/dV), or its first S (forward), or its
        # first S and dP (dQ) are done
        ("      hopper::mbar_wait(&full[s], ((t + i) / ST) & 1);\n", 1,
         "if (i == 0) { " + rec(1) + " }", False),
        ("    sdp(t);\n    their_turn();\n    hopper::wgmma_wait<0>();\n", 1, rec(1), False),
        ("    qk(t);\n    their_turn();\n    hopper::wgmma_wait<0>();\n", 1, rec(1), False),
        # its tiles are done, and how many
        ("    uint8_t* out = base + slot * 2 * L::kKTile + cw * 64 * BOX_ROW;\n", 1,
         rec(2) + rec(7, "steps"), True),
        ("    uint8_t* out = base + slot * 2 * L::kQTile + cw * 64 * BOX_ROW;\n", 1,
         rec(2) + rec(7, "steps"), True),
        ("    uint8_t* out = base + slot * L::kQTile + cw * 64 * BOX_ROW;\n", 1,
         rec(2) + rec(7, "steps"), True),
        # its stores have read its slot
        ("      hopper::mbar_arrive(&slot_empty[slot]);\n    }\n  }\n", 3, rec(3), False),
    ]
    for text, count, code, before in edits:
        if src.count(text) != count:
            raise RuntimeError(f"trace: the source changed near {text!r}")
        if text.endswith("    }\n  }\n"):  # after the store's commit, still inside the item loop
            src = src.replace(text, text[:-4] + "    " + code + "\n  }\n")
        else:
            src = src.replace(text, ("    " + code + "\n" + text) if before
                              else (text + "    " + code + "\n"))
    src += ('\nextern "C" int bsa_trace_read(void* dst, size_t bytes) {\n'
            '  return (int)cudaMemcpyFromSymbol(dst, g_trace, bytes);\n}\n'
            'extern "C" int bsa_trace_clear() {\n'
            '  void* p = nullptr;\n'
            '  cudaGetSymbolAddress(&p, g_trace);\n'
            '  return (int)cudaMemset(p, 0, sizeof(unsigned long long) << 22);\n}\n')
    return src


def traced_library():
    out = build.BUILD_DIR / "block_sparse_attention_traced"
    out.mkdir(parents=True, exist_ok=True)
    (out / "traced.cu").write_text(traced_source())
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
                           str(out / "traced.so"), str(out / "traced.cu")],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise build.KernelBuildError(proc.stdout[-4000:])
    lib = ctypes.CDLL(str(out / "traced.so"))
    lib.bsa_trace_read.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    lib.bsa_trace_read.restype = ctypes.c_int
    lib.bsa_trace_clear.restype = ctypes.c_int
    return lib


def trace_reading(q, k, v, do, flush):
    lib = traced_library()
    saved = build._loaded.get(bsa._SOURCE)
    build._loaded[bsa._SOURCE] = lib  # the wrappers' entries come from the traced copy
    try:
        for name, layout in (("bigbird", bsa.full_layout(cs.bigbird_layout(H, S, BLOCK), H, S,
                                                         BLOCK)), ("band6", band(6))):
            _, calls = backward(q, k, v, do, layout)
            for key, fn in calls.items():
                fn()
                torch.cuda.synchronize()
                if lib.bsa_trace_clear() != 0:
                    raise RuntimeError("trace: clearing the stamps failed")
                flush.zero_()
                fn()
                torch.cuda.synchronize()
                blocks = 2 * sms(q.device)
                raw = np.zeros((blocks, 32, 8), np.uint64)
                if lib.bsa_trace_read(raw.ctypes.data, raw.nbytes) != 0:
                    raise RuntimeError("trace: reading the stamps failed")
                print(json.dumps({"reading": "trace", "layout": name, "kernel": key,
                                  **summarize(raw.astype(np.int64))}), flush=True)
    finally:
        if saved is None:
            build._loaded.pop(bsa._SOURCE, None)
        else:
            build._loaded[bsa._SOURCE] = saved


def summarize(t):
    """Medians, in µs, of the stamps of the blocks' first 32 items."""
    seen = t[:, :, 0] > 0
    t0 = t[:, :, 0][seen].min()
    ev = {}
    for e, name in enumerate(EVENTS):
        x = (t[:, :, e] - t0).astype(float) / 1e3
        x[~seen | (t[:, :, e] == 0)] = np.nan
        ev[name] = x
    steps = np.where(seen, t[:, :, 7], 0).astype(float)
    ends = np.nanmax(ev["stored"], axis=1)
    long_items = seen & (steps >= 32)
    item = ev["stored"] - ev["slot"]
    return {"items_per_block_mean": float(seen.sum(1).mean()),
            "block_end_us": [float(np.nanmin(ends)), float(np.nanmedian(ends)),
                             float(np.nanmax(ends))],
            "between_items_us": float(np.nanmedian(ev["slot"][:, 1:] - ev["stored"][:, :-1])),
            "slot_to_first_tile_us": float(np.nanmedian(ev["first_tile"] - ev["slot"])),
            "tile_us": float(np.nanmedian((ev["tiles_done"] - ev["first_tile"])
                                          / np.maximum(steps - 1, 1))),
            "store_us": float(np.nanmedian(ev["stored"] - ev["tiles_done"])),
            "tiles_per_item_mean": float(steps[seen].mean()),
            "long_item_us_mean": float(np.nanmean(item[long_items])) if long_items.any()
            else None}


def main():
    if not torch.cuda.is_available():
        print("bsa_probe: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    q, k, v, do = inputs(device)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "sms": sms(device)}), flush=True)
    layouts_reading(q, k, v, do, flush)
    lead_reading(q, k, v, do, flush)
    trace_reading(q, k, v, do, flush)
    return 0


if __name__ == "__main__":
    sys.exit(main())
