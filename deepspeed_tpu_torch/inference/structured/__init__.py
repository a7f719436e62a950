"""Structured generation: per-sequence sampling.

Port of ``deepspeed_tpu/inference/structured``'s sampling half:

- :mod:`prng` — the counter-based sampling PRNG. Every drawn token's
  randomness is a pure function of ``(DS_SEED, request seed, absolute
  sequence position)``, never of host call order, so any replica
  replaying a stream reproduces it bit-identically; keys and bits equal
  JAX's threefry bit for bit.
- :mod:`sampling` — the packed per-sequence sampler: temperature /
  top-k / top-p / seed ride the batch as *data* (one int32 meta row
  per field).

Constrained decoding (the grammar compiler, the schema store and the
``constrained_enabled`` gate) is not ported yet: ROADMAP.md, port queue
item 4."""

from deepspeed_tpu_torch.inference.structured.prng import derive_seed

__all__ = ["derive_seed"]
