"""Packed per-sequence sampling: spec parameters as data.

Port of ``deepspeed_tpu/inference/structured/sampling.py``. A sampling
spec rides the batch as DATA: six int32 rows per sequence (float bits for
temperature/top_p, plus top_k, the counter-PRNG seed, and the
constrained-decoding DFA slot/state), packed into the same flat metadata
vector the step and the burst already copy to the device, byte-equal to
the JAX engine's, so one step serves every mix of greedy, sampled and
schema-constrained rows.

Row convention: ``temperature == 0.0`` (all-zero bits — the natural
value of an untouched meta row) marks a GREEDY row, decoded by argmax;
validation forbids 0 in user specs, so the sentinel can never collide
with a real temperature. Pad rows therefore argmax garbage logits
harmlessly."""

import numpy as np
import torch

from deepspeed_tpu_torch.inference.sampling import softmax_rows
from deepspeed_tpu_torch.inference.structured.prng import gumbel_from_bits, row_bits

# meta layout: 6 int32 rows of max_seqs entries each
SAMPLE_META_ROWS = 6
_TEMP_BITS, _TOP_K, _TOP_P_BITS, _SEED, _DFA_SLOT, _DFA_STATE = range(6)


def _f32_bits(x):
    """Host-side float32 → raw int32 bits (inverse of the ``view`` in
    :func:`unpack_sample_meta`)."""
    return int(np.array(x, np.float32).view(np.int32))


def pack_sample_meta(specs, max_seqs, dfa=None):
    """Host pack: per-row sampling specs (+ optional DFA bindings) → one
    flat int32 vector of ``SAMPLE_META_ROWS * max_seqs`` entries.

    ``specs[i]`` is the resolved sampling dict for batch row i (seed
    already present) or None for a greedy row; rows past ``len(specs)``
    are padding. ``dfa[i]`` is ``(schema_slot, dfa_state)`` when
    constrained decoding is live (slot 0 = the trivial all-allow DFA)."""
    meta = np.zeros((SAMPLE_META_ROWS, max_seqs), np.int32)
    for i, spec in enumerate(specs):
        if spec is None:
            continue  # greedy row: temperature bits stay 0.0 == argmax
        meta[_TEMP_BITS, i] = _f32_bits(float(spec.get("temperature", 1.0)))
        meta[_TOP_K, i] = int(spec.get("top_k", 0))
        meta[_TOP_P_BITS, i] = _f32_bits(float(spec.get("top_p", 1.0)))
        meta[_SEED, i] = np.int32(int(spec.get("seed", 0)) & 0x7FFFFFFF)
    if dfa is not None:
        for i, (slot, state) in enumerate(dfa):
            meta[_DFA_SLOT, i] = int(slot)
            meta[_DFA_STATE, i] = int(state)
    return meta.ravel()


def unpack_sample_meta(flat, max_seqs):
    """Device inverse of :func:`pack_sample_meta` → ``(temperature
    f32[N], top_k i32[N], top_p f32[N], seed i32[N], dfa_slot i32[N],
    dfa_state i32[N])``, views of ``flat``."""
    m = flat.reshape(SAMPLE_META_ROWS, max_seqs)
    return (m[_TEMP_BITS].view(torch.float32), m[_TOP_K], m[_TOP_P_BITS].view(torch.float32),
            m[_SEED], m[_DFA_SLOT], m[_DFA_STATE])


def apply_dfa_mask(logits, masks, slots, states):
    """Compose the constrained-decoding logits mask on the device:
    ``masks[slots[i], states[i]]`` is row i's allowed-token row (bool
    ``[V]``); disallowed tokens drop to -inf. Slot 0 is the trivial
    all-allow DFA, so unconstrained rows pass through unchanged."""
    allowed = masks[slots.long(), states.long()]
    return torch.where(allowed, logits, -torch.inf)


def sample_rows(logits, keys, temperature, top_k, top_p):
    """Per-row sampling with per-row parameters on the device: ``[N, V]``
    logits → ``[N]`` int32 tokens. Row i draws with its own
    ``(temperature[i], top_k[i], top_p[i])`` and key ``keys[i]`` (int64
    ``[N, 2]``, from :func:`prng.token_keys`); ``temperature[i] == 0``
    rows take the plain argmax instead (mixed greedy/sampled batches).

    Same filtering semantics as the static
    :func:`deepspeed_tpu_torch.inference.sampling.sample_tokens`:
    temperature scale, then top-k, then nucleus over the top-k-filtered
    distribution — one descending sort serves both filters. ``top_k ==
    0`` disables the k filter; ``top_p == 1`` disables the nucleus;
    ``top_k == 1`` degenerates to exact argmax. Every row runs every op
    and nothing branches on a device value, so a step costs no host sync
    and a row's token does not depend on the other rows."""
    logits = logits.float()
    V = logits.shape[-1]
    greedy = temperature <= 0.0
    scaled = logits / temperature.clamp_min(1e-6)[:, None]
    sorted_l = torch.sort(scaled, dim=-1, descending=True).values
    # top_k >= vocab filters nothing; clamp so any spec fits any model
    k_eff = torch.where(top_k > 0, top_k.clamp(1, V), V).to(torch.int64)
    kth = sorted_l.gather(-1, (k_eff - 1)[:, None])
    filtered = torch.where(scaled < kth, -torch.inf, scaled)
    # nucleus applies to the top-k-filtered distribution
    keep = torch.arange(V, device=logits.device)[None, :] < k_eff[:, None]
    sorted_f = torch.where(keep, sorted_l, -torch.inf)
    cum = torch.cumsum(softmax_rows(sorted_f), dim=-1)
    # smallest set with cumulative prob >= top_p
    cutoff_idx = (cum < top_p[:, None]).sum(dim=-1).clamp_max(V - 1)
    cutoff = sorted_f.gather(-1, cutoff_idx[:, None])
    apply_p = (top_p < 1.0)[:, None]
    filtered = torch.where(apply_p & (scaled < cutoff), -torch.inf, filtered)
    drawn = torch.argmax(gumbel_from_bits(row_bits(keys, V)) + filtered, dim=-1)
    return torch.where(greedy, torch.argmax(logits, dim=-1), drawn).to(torch.int32)
