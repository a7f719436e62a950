"""PyTorch and CUDA port of ``deepspeed_tpu`` for NVIDIA Hopper.

A package of its own beside the JAX one, which stays the reference. It
imports torch and numpy, never jax or anything of ``deepspeed_tpu``.
Importing it loads nothing heavy: submodules are imported where used
(``deepspeed_tpu_torch.inference.v2`` for ragged serving). Entry points
run on the GPU unless the caller passes ``device="cpu"``; on the CPU
every kernel is replaced by its plain PyTorch version."""

__version__ = "0.1.0"
