"""Token sampling shared by the inference engines.

Port of ``deepspeed_tpu/inference/sampling.py``: the sampling-spec
validator, the spec key of the v1 engine's per-spec programs, and the
static sampler (temperature → top-k → nucleus → categorical) with JAX's
filtering order and random bits. The ragged engine's packed sampler is
``inference.structured.sampling.sample_rows``."""

import numbers

import numpy as np
import torch

from deepspeed_tpu_torch.inference.structured.prng import flat_bits, gumbel_from_bits, key_tensor

_KEYS = ("temperature", "top_k", "top_p", "seed")


def validate_sample_spec(sample):
    """Reject typo'd keys / invalid values in a sampling spec dict —
    unknown keys would otherwise be silently dropped (running unfiltered
    T=1.0 sampling), the opposite of what the caller asked for.

    ``temperature > 0`` is load-bearing beyond plausibility: the v2
    packed sampled step uses temperature bits 0.0 as its greedy-row
    sentinel, so a user temperature of exactly 0 must never reach it."""
    unknown = set(sample) - set(_KEYS)
    if unknown:
        raise ValueError(f"unknown sampling keys {sorted(unknown)}; "
                         f"supported: {list(_KEYS)}")
    t = sample.get("temperature", 1.0)
    k = sample.get("top_k", 0)
    p = sample.get("top_p", 1.0)
    s = sample.get("seed", 0)
    # numbers.Real/Integral so numpy scalars from config pipelines pass
    if not (isinstance(t, numbers.Real) and t > 0):
        raise ValueError(f"temperature must be > 0, got {t!r}")
    if not (isinstance(k, numbers.Integral) and k >= 0):
        raise ValueError(f"top_k must be an int >= 0, got {k!r}")
    if not (isinstance(p, numbers.Real) and 0 < p <= 1):
        raise ValueError(f"top_p must be in (0, 1], got {p!r}")
    if not (isinstance(s, numbers.Integral) and 0 <= s < 2 ** 31):
        raise ValueError(f"seed must be an int in [0, 2**31), got {s!r}")


def sample_spec_key(sample):
    """Normalized hashable static key for per-spec program caching
    (``seed`` is per-request DATA, never part of a program key, so it is
    deliberately excluded)."""
    validate_sample_spec(sample)
    return (float(sample.get("temperature", 1.0)),
            int(sample.get("top_k", 0)),
            float(sample.get("top_p", 1.0)))


def softmax_rows(x):
    """``jax.nn.softmax`` over the last axis: ``exp(x - max) / sum``, a
    true division (``torch.softmax`` multiplies by the reciprocal)."""
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def sample_tokens(logits, rng, temperature=1.0, top_k=0, top_p=1.0):
    """[N, V] logits → [N] int32 sampled token ids, on the logits' device.

    ``rng`` is one key (a host ``uint32[2]`` or a device int64 ``[2]``);
    the Gumbel draws take its bits over the flat ``[N, V]`` index, as
    ``jax.random.categorical`` does. temperature/top_k/top_p are static
    Python numbers."""
    logits = logits.float()
    if temperature != 1.0:
        # a device divisor: CUDA turns a division by a host scalar into a
        # product with its reciprocal
        logits = logits / logits.new_full((1, 1), max(temperature, 1e-6))
    V = logits.shape[-1]
    # a top_k >= vocab filters nothing; clamp so any spec is safe for any
    # model (validation cannot know the vocab size)
    top_k = min(int(top_k), V) if top_k else 0
    nucleus = bool(top_p) and top_p < 1.0
    if top_k > 0 or nucleus:
        # one descending full-vocab sort serves both filters
        sorted_l = torch.sort(logits, dim=-1, descending=True).values
    if top_k > 0:
        kth = sorted_l[:, top_k - 1:top_k]
        logits = torch.where(logits < kth, -torch.inf, logits)
    if nucleus:
        if top_k > 0:
            # nucleus applies to the top-k-filtered distribution
            keep = torch.arange(V, device=logits.device)[None, :] < top_k
            sorted_l = torch.where(keep, sorted_l, -torch.inf)
        cum = torch.cumsum(softmax_rows(sorted_l), dim=-1)
        # smallest set with cumulative prob >= top_p; an index past the
        # row (rounding left every sum short of top_p) filters nothing,
        # as JAX's out-of-bounds gather (NaN) does
        cutoff_idx = (cum < top_p).sum(dim=-1, keepdim=True)
        cutoff = torch.where(cutoff_idx < V,
                             sorted_l.gather(-1, cutoff_idx.clamp_max(V - 1)), -torch.inf)
        logits = torch.where(logits < cutoff, -torch.inf, logits)
    if isinstance(rng, np.ndarray):
        rng = key_tensor(rng, logits.device)
    g = gumbel_from_bits(flat_bits(rng, tuple(logits.shape)))
    return torch.argmax(g + logits, dim=-1).to(torch.int32)
