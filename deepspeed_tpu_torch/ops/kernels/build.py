"""Build the port's CUDA kernels from the sources in ``deepspeed_tpu_torch/csrc``.

Each ``.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, which the kernel modules load with
``ctypes`` (no PyTorch headers, so a build takes seconds). Libraries go into
``build/torch_kernels/`` at the root of the checkout, named by a hash of the
source, the headers it may include (``csrc/*.cuh``) and the flags, so an
edited source is rebuilt and an unchanged one is reused. Nothing is built at import time: the first call that needs a kernel
builds it, or :func:`build` builds one ahead of use.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# every kernel source the port has
SOURCES = ("paged_attention.cu", "flash_attention.cu", "fused_norms.cu",
           "fused_quant_matmul.cu", "grouped_matmul.cu", "lora_matmul.cu", "quantization.cu",
           "block_sparse_attention.cu")

_loaded = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME
    cand = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    found = shutil.which("nvcc")
    if found:
        cand.append(found)
    for c in cand:
        if os.path.exists(c):
            return c
    raise KernelBuildError("nvcc not found: the CUDA kernels build only where the "
                           "CUDA toolkit is installed (set CUDA_HOME)")


def build(source):
    """Compile ``source`` unless its library exists → ``(path, log,
    seconds)``: what nvcc printed (ptxas registers and spills; None when
    the library was reused) and the wall seconds of its run."""
    src = CSRC / source
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:16]
    out = BUILD_DIR / f"{Path(source).stem}_{digest}.so"
    if out.exists():
        return out, None, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise KernelBuildError(f"nvcc failed on {source} (exit {proc.returncode}):\n"
                               f"{proc.stdout}")
    os.replace(tmp, out)  # atomic: a concurrent builder never sees half a file
    return out, proc.stdout, seconds


def sass_counts(source, ops):
    """How often each SASS opcode in ``ops`` occurs in each kernel of
    ``source``'s library (built on first use), read with the toolkit's
    ``cuobjdump -sass`` → ``{mangled kernel name: {op: count}}``. Shows
    which instructions a design really issues (``HGMMA``: wgmma)."""
    tool = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    proc = subprocess.run([tool, "-sass", str(build(source)[0])], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise KernelBuildError(f"cuobjdump failed on {source}:\n{proc.stdout}")
    out = {}
    for chunk in proc.stdout.split("Function : ")[1:]:
        words = chunk.split()
        out[words[0]] = {op: words.count(op) + sum(w.startswith(op + ".") for w in words)
                         for op in ops}
    return out


def load(source):
    """The ``ctypes.CDLL`` of ``source``, building it on first use."""
    lib = _loaded.get(source)
    if lib is None:
        lib = _loaded[source] = ctypes.CDLL(str(build(source)[0]))
    return lib
