"""Speculative-decoding state: enable gate, drafter, acceptance policy.

The acceptance policy is where self-speculation pays for itself or
doesn't: every drafted token occupies a verify-forward slot whether or
not it is accepted, so a sequence whose drafts rarely survive (high-
entropy generation, no repetition to look up) is strictly better off on
the plain one-token-per-step burst path. :class:`SpecDecodeState`
tracks a per-sequence accept-rate EMA and permanently stops drafting
for sequences below threshold — speculation degrades to a no-op instead
of a slowdown.
"""

import threading

from deepspeed_tpu_torch.inference.v2.spec.drafter import NGramDrafter
from deepspeed_tpu_torch.utils.env import env_int, env_opt_bool


def spec_decode_enabled(config) -> bool:
    """Config gate plus the ``DS_SPEC_DECODE`` kill switch: when the env
    var is set it wins in BOTH directions (``0``/``false``/``off``
    forces speculation off, anything else forces it on); unset defers
    to ``config.enabled``."""
    forced = env_opt_bool("DS_SPEC_DECODE")
    if forced is not None:
        return forced
    return bool(getattr(config, "enabled", False))


class SpecDecodeState:
    """Per-engine speculative-decoding state.

    Owns the host-side drafter, the per-sequence accept-rate EMA that
    auto-disables drafting where speculation loses, and the aggregate
    counters the gateway publishes as ``Serve/Spec/*``.

    Thread-shared: the gateway pump thread drives ``draft_len``/``note``
    while client threads reach ``forget`` through ``engine.flush``
    (cancel, deadline, drain), so every mutation takes the lock.
    """

    def __init__(self, config=None):
        self.draft_len_cfg = env_int("DS_SPEC_DRAFT_LEN") or \
            int(getattr(config, "draft_len", 4))
        if self.draft_len_cfg < 1:
            raise ValueError(f"draft_len must be >= 1, got {self.draft_len_cfg}")
        self.drafter = NGramDrafter(
            max_ngram=int(getattr(config, "max_ngram", 3)),
            min_ngram=int(getattr(config, "min_ngram", 1)))
        self.ema_alpha = float(getattr(config, "ema_alpha", 0.4))
        self.disable_below = float(getattr(config, "disable_below", 0.25))
        self.warmup_steps = int(getattr(config, "warmup_steps", 3))
        self._lock = threading.Lock()
        self._ema = {}        # uid -> (accept-rate EMA, verify steps seen)
        self._disabled = set()  # uids the EMA turned drafting off for
        self.steps = 0        # verify bursts that scored >= 1 draft
        self.accepted = 0     # draft tokens accepted
        self.drafted = 0      # draft tokens scored
        self.emitted = 0      # tokens emitted by verify bursts
        self.disables = 0     # sequences auto-disabled so far

    def draft_len(self, uid) -> int:
        """Draft-token budget for ``uid`` this step (0 = don't draft)."""
        with self._lock:
            if uid in self._disabled:
                return 0
            return self.draft_len_cfg

    def note(self, uid, accepted: int, drafted: int) -> None:
        """Record one verify result for ``uid``: update the global
        counters and the per-sequence EMA, disabling drafting once a
        warmed-up EMA falls below threshold. Draft-free rows (another
        sequence's drafts forced them into the verify batch) are not a
        signal about THIS sequence and are skipped."""
        if drafted < 1:
            return
        rate = accepted / drafted
        with self._lock:
            self.steps += 1
            self.accepted += accepted
            self.drafted += drafted
            self.emitted += accepted + 1
            ema, n = self._ema.get(uid, (rate, 0))
            ema = (1.0 - self.ema_alpha) * ema + self.ema_alpha * rate
            n += 1
            self._ema[uid] = (ema, n)
            if n >= self.warmup_steps and ema < self.disable_below \
                    and uid not in self._disabled:
                self._disabled.add(uid)
                self.disables += 1

    def forget(self, uid) -> None:
        """Drop per-sequence state (engine flush/retire)."""
        with self._lock:
            self._ema.pop(uid, None)
            self._disabled.discard(uid)

    def stats(self) -> dict:
        """``Serve/Spec/*`` snapshot. ``accepted_per_step`` counts the
        tokens each verify burst EMITTED (accepted drafts + the model's
        own token) — 1.0 is parity with plain decoding, anything above
        is speculation's win."""
        with self._lock:
            return {
                "accept_rate": round(self.accepted / self.drafted, 4)
                if self.drafted else 0.0,
                "accepted_per_step": round(self.emitted / self.steps, 4)
                if self.steps else 0.0,
                "draft_wasted": self.drafted - self.accepted,
                "verify_steps": self.steps,
                "tokens_drafted": self.drafted,
                "tokens_accepted": self.accepted,
                "disabled_sequences": self.disables,
            }
