"""Device resolution for the port's entry points.

``device=None`` means the GPU: an entry point given no device runs on
``cuda`` and raises where there is none, instead of quietly running on
the host. Callers that want the plain versions on the CPU (the tests)
pass ``device="cpu"``."""

import subprocess

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run "
                           "the plain PyTorch versions on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: the port runs on 'cuda' or 'cpu'")
    return dev


def gpu_report() -> str:
    """The card's name and power limit, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them (one line per card)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()
