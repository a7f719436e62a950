"""Self-speculative decoding for the v2 ragged engine.

n-gram/prompt-lookup drafting (Saxena 2023) + batched greedy verify
(Leviathan et al. 2023): the host proposes draft tokens from the
sequence's own token log, the engine scores entry + drafts in ONE
ragged forward (``InferenceEngineV2.verify_burst``), and the longest
matching prefix is accepted on device — bit-identical greedy outputs
by construction, no extra weights.

Port of ``deepspeed_tpu/inference/v2/spec``: the drafter and the state
are copies (the state's lock is a plain ``threading.Lock``; the
``DS_SANITIZE`` lock tracking is not ported yet, ROADMAP.md port queue
item 4)."""

from deepspeed_tpu_torch.inference.v2.spec.drafter import NGramDrafter
from deepspeed_tpu_torch.inference.v2.spec.state import SpecDecodeState, spec_decode_enabled

__all__ = ["NGramDrafter", "SpecDecodeState", "spec_decode_enabled"]
