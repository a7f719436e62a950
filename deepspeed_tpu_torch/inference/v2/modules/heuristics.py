"""Kernel-implementation selection for the v2 ragged engine.

Port of ``deepspeed_tpu/inference/v2/modules/heuristics.py``: each
logical op has a REGISTRY of implementations with a ``supports``
predicate; the first supported one in registration (priority) order is
chosen, and the engine config can pin one by name
(``RaggedInferenceEngineConfig.implementation_overrides``).

Implementations registered for ``attention`` (the ragged decode op):

- ``cuda_paged``   — the hand-written CUDA kernel
  (``ops/kernels/paged_attention``), chosen for CUDA tensors; takes any
  head_dim that is a multiple of 8 up to 256.
- ``torch_gather`` — the plain gather version, chosen for CPU tensors,
  and on the GPU only when ``implementation_overrides`` names it (as
  the JAX package's ``xla_gather`` pin does).

ALiBi models (the GPT family) are not ported yet and raise.
"""

REGISTRY = {"attention": []}


def register_implementation(op, name):
    """Decorator: register a class with ``supports(device, head_dim,
    pinned)`` and ``instantiate()`` staticmethods under ``op``."""
    def wrap(impl):
        REGISTRY[op].append((name, impl))
        return impl
    return wrap


def implementations(op):
    return [name for name, _ in REGISTRY[op]]


@register_implementation("attention", "cuda_paged")
class _CudaPaged:

    @staticmethod
    def supports(device, head_dim, pinned=False):
        from deepspeed_tpu_torch.ops.kernels.paged_attention import MAX_HEAD_DIM
        return device.type == "cuda" and head_dim % 8 == 0 and head_dim <= MAX_HEAD_DIM

    @staticmethod
    def instantiate():
        from deepspeed_tpu_torch.ops.kernels.paged_attention import paged_decode_attention
        return paged_decode_attention


@register_implementation("attention", "torch_gather")
class _TorchGather:

    @staticmethod
    def supports(device, head_dim, pinned=False):
        return device.type == "cpu" or pinned

    @staticmethod
    def instantiate():
        from deepspeed_tpu_torch.ops.kernels.paged_attention import paged_attention_ref
        return paged_attention_ref


def instantiate_attn(device, head_dim, alibi=None, override=None):
    """→ ``(impl_name, fn(q, kc, vc, tab, pos))`` — the first supported
    implementation in registration (priority) order, or the named one
    when the config pins ``override``."""
    if alibi is not None:
        raise NotImplementedError(
            "ALiBi attention (GPT family) is not ported yet: ROADMAP.md, port queue "
            "item 6 (GPT family)")
    for name, impl in REGISTRY["attention"]:
        if override is not None and name != override:
            continue
        if impl.supports(device, head_dim, pinned=override is not None):
            return name, impl.instantiate()
        if override is not None:
            raise ValueError(
                f"implementation_overrides pinned attention={override!r}, but it "
                f"does not support this config (device={device}, head_dim={head_dim})")
    if override is None:
        raise ValueError(f"no attention implementation supports device={device}, "
                         f"head_dim={head_dim}")
    raise ValueError(f"no attention implementation named {override!r}; "
                     f"available: {implementations('attention')}")
