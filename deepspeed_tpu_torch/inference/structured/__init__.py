"""Structured generation: per-sequence sampling + constrained decoding.

Port of ``deepspeed_tpu/inference/structured``, the subsystem behind
sampled and schema-constrained serving on the v2 ragged engine:

- :mod:`prng` — the counter-based sampling PRNG. Every drawn token's
  randomness is a pure function of ``(DS_SEED, request seed, absolute
  sequence position)``, never of host call order, so any replica
  replaying a stream reproduces it bit-identically; keys and bits equal
  JAX's threefry bit for bit.
- :mod:`sampling` — the packed per-sequence sampler: temperature /
  top-k / top-p / seed / DFA slot and state ride the batch as *data*
  (one int32 meta row per field), and ``apply_dfa_mask`` gathers each
  row's allowed-token mask on the device.
- :mod:`grammar` — the grammar / JSON-schema compiler: regex →
  Brzozowski-derivative char DFA → token-level DFA over vocab ids
  (transition table + per-state allowed-token mask); a copy.
- :mod:`store` — the process-wide :class:`SchemaCompilerCache` and the
  per-engine :class:`StructuredStore` device slabs the burst gathers its
  logits masks from.

``constrained_enabled`` is the subsystem's config gate with the
``DS_CONSTRAINED`` env kill switch; off, no DFA metadata is packed and
no mask is applied."""

from deepspeed_tpu_torch.utils.env_registry import env_opt_bool


def constrained_enabled(config) -> bool:
    """Config gate plus the ``DS_CONSTRAINED`` kill switch: when the env
    var is set it wins in BOTH directions (``0``/``false``/``off``
    forces constrained decoding off, anything else forces it on); unset
    defers to ``config.enabled``."""
    forced = env_opt_bool("DS_CONSTRAINED")
    if forced is not None:
        return forced
    return bool(getattr(config, "enabled", False))


from deepspeed_tpu_torch.inference.structured.grammar import (  # noqa: E402
    CompiledSchema, SchemaCompileError, byte_vocab, detokenize)
from deepspeed_tpu_torch.inference.structured.prng import derive_seed  # noqa: E402
from deepspeed_tpu_torch.inference.structured.store import (  # noqa: E402
    SchemaCompilerCache, StructuredStore, schema_cache)

__all__ = [
    "CompiledSchema", "SchemaCompileError", "SchemaCompilerCache",
    "StructuredStore", "byte_vocab", "constrained_enabled",
    "derive_seed", "detokenize", "schema_cache",
]
