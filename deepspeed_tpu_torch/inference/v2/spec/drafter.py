"""Host-side n-gram (prompt-lookup) drafting.

Saxena's *Prompt Lookup Decoding* (2023) observation: on repetitive and
shared-context serving traffic, the continuation of the current suffix
very often already appears verbatim earlier in the sequence — form
letters, templated answers, code with repeated identifiers. A separate
draft model (Leviathan et al. 2023) is overkill for that regime: the
sequence IS the draft model. The drafter finds the most recent earlier
occurrence of the longest suffix n-gram and proposes the tokens that
followed it. Zero extra weights, microseconds per call, and exactly the
traffic shape the radix prefix cache already optimizes for.
"""


class NGramDrafter:
    """Propose draft continuations by suffix-n-gram lookup over the
    sequence's own token history (prompt + everything generated)."""

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1):
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError(f"need 1 <= min_ngram <= max_ngram, got "
                             f"min={min_ngram} max={max_ngram}")
        self.max_ngram = int(max_ngram)
        self.min_ngram = int(min_ngram)

    def propose(self, history, max_tokens: int):
        """→ up to ``max_tokens`` draft ids continuing ``history``, or
        ``[]`` when no suffix n-gram recurs earlier in the sequence.

        Longest suffix n-gram first (a longer context match predicts
        the continuation better); among matches of the same length the
        MOST RECENT wins — recent repetition (a loop the model is in, a
        phrase it just reused) predicts the next tokens better than an
        occurrence pages back.
        """
        h = history
        L = len(h)
        if max_tokens < 1 or L < self.min_ngram + 1:
            return []
        for n in range(min(self.max_ngram, L - 1), self.min_ngram - 1, -1):
            pat = h[L - n:]
            # candidate matches END at j (exclusive); j == L is the
            # suffix itself, so scan strictly-earlier ends right-to-left
            for j in range(L - 1, n - 1, -1):
                if h[j - n:j] == pat:
                    return [int(t) for t in h[j:j + max_tokens]]
        return []
