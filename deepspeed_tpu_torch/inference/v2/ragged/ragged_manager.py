"""Sequence state manager.

Capability match for the reference's
``deepspeed/inference/v2/ragged/ragged_manager.py`` (``DSStateManager``
at ragged_manager.py:19): tracks live sequences (uid → descriptor),
owns the KV block allocation for each, and hands out batch slots.

When a :class:`PrefixCacheManager` is attached, sequence creation leases
the prompt's longest cached block-aligned prefix (the descriptor starts
with those blocks in its table and ``seen_tokens`` past them), block
allocation reclaims unreferenced cached blocks under pressure, and
flush retires completed blocks INTO the cache instead of freeing them —
shared prefix blocks are decref'd, never hard-freed."""

from deepspeed_tpu_torch.inference.v2.ragged.kv_cache import BlockedKVCache
from deepspeed_tpu_torch.inference.v2.ragged.sequence_descriptor import DSSequenceDescriptor


class DSStateManager:

    def __init__(self, kv_cache: BlockedKVCache, max_tracked_sequences: int):
        self.kv_cache = kv_cache
        self.max_tracked_sequences = max_tracked_sequences
        self._seqs = {}  # uid -> descriptor
        self.prefix_cache = None

    def attach_prefix_cache(self, prefix_cache) -> None:
        """Route allocation/flush through a radix prefix cache."""
        self.prefix_cache = prefix_cache

    @property
    def n_tracked_sequences(self) -> int:
        return len(self._seqs)

    @property
    def free_blocks(self) -> int:
        return self.kv_cache.free_blocks

    def query(self, uid):
        return self._seqs.get(uid)

    def get_or_create_sequence(self, uid, prompt_tokens=None) -> DSSequenceDescriptor:
        """Track ``uid`` (idempotent). With a prefix cache attached and
        ``prompt_tokens`` given, a NEW sequence comes back with its
        longest cached prefix already in its block table: ``seen_tokens``
        (and ``cached_tokens``) point at the first uncached token, so
        prefill starts there."""
        desc = self._seqs.get(uid)
        if desc is not None:
            return desc
        if len(self._seqs) >= self.max_tracked_sequences:
            raise RuntimeError(f"max_tracked_sequences={self.max_tracked_sequences} exceeded")
        desc = DSSequenceDescriptor(uid, self.kv_cache.block_size)
        if self.prefix_cache is not None and prompt_tokens is not None \
                and len(prompt_tokens) > 0:
            blocks, cached = self.prefix_cache.acquire(uid, prompt_tokens)
            if cached:
                desc.extend_blocks(blocks)
                desc.shared_blocks = len(blocks)
                desc.seen_tokens = cached
                desc.cached_tokens = cached
                desc.tokens = [int(t) for t in prompt_tokens[:cached]]
        self._seqs[uid] = desc
        return desc

    def allocate_for(self, desc: DSSequenceDescriptor, new_tokens: int) -> None:
        need = desc.blocks_needed(new_tokens)
        if need > 0:
            if self.prefix_cache is not None:
                desc.extend_blocks(self.prefix_cache.reserve(need))
            else:
                desc.extend_blocks(self.kv_cache.reserve(need))

    def rewind_sequence(self, desc: DSSequenceDescriptor, n_tokens: int) -> None:
        """Drop the last ``n_tokens`` of ``desc``'s KV content: the
        positions past the new length are abandoned in place (the block
        tables make them unreachable — the next tokens overwrite them),
        the token log truncates to match, and trailing blocks beyond the
        new length return to the pool. Never rewinds into cached
        (shared) prefix content — those blocks are the trie's."""
        if n_tokens < 0:
            raise ValueError(f"cannot rewind by {n_tokens} tokens")
        if desc.seen_tokens - n_tokens < desc.cached_tokens:
            raise ValueError(
                f"sequence {desc.uid}: rewinding {n_tokens} of "
                f"{desc.seen_tokens} tokens would cross into the "
                f"{desc.cached_tokens}-token shared prefix")
        if n_tokens:
            desc.rewind(n_tokens)
        self.release_unused_blocks(desc)

    def release_unused_blocks(self, desc: DSSequenceDescriptor) -> None:
        """Free trailing blocks past ``desc``'s current length. Burst
        and verify reservations cover the worst case up front; variable
        acceptance and EOS-mid-burst rewinds can leave the tail unused,
        and holding it would charge the pool for KV nobody will write.
        Shared prefix blocks sit at the FRONT of the table and a live
        sequence always spans them (``seen_tokens >= cached_tokens``),
        so a trailing trim can never touch the trie's blocks."""
        needed = -(-desc.seen_tokens // self.kv_cache.block_size)
        needed = max(needed, desc.shared_blocks)
        extra = desc.blocks[needed:]
        if extra:
            del desc.blocks[needed:]
            self.kv_cache.free(extra)

    def flush_sequence(self, uid) -> None:
        desc = self._seqs.pop(uid, None)
        if desc is None:
            raise KeyError(f"unknown sequence {uid}")
        if self.prefix_cache is not None:
            self.prefix_cache.release(uid, desc)
        else:
            self.kv_cache.free(desc.blocks)

    def drop_sequence(self, uid) -> DSSequenceDescriptor:
        """Stop tracking ``uid`` WITHOUT freeing or caching its blocks —
        the suspend path, where ownership moves to the host handle."""
        desc = self._seqs.pop(uid, None)
        if desc is None:
            raise KeyError(f"unknown sequence {uid}")
        return desc
