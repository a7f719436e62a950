"""Ragged batch assembly.

Capability match for the reference's
``deepspeed/inference/v2/ragged/ragged_wrapper.py``
(``RaggedBatchWrapper``: flat token buffer + per-sequence metadata the
kernels consume). Every array is padded to the STATIC shapes
(max_tokens, max_seqs, max_blocks_per_seq); padding tokens point at a
dedicated pad slot whose block table is all null blocks.

Port: the host side is a copy, so the packed vector is byte-identical to
the JAX package's; :func:`unpack_batch` slices the device copy of it
(one host→device transfer per step). Static shapes per bucket keep the
step ready for capture in a CUDA graph."""

import numpy as np

from deepspeed_tpu_torch.inference.structured.sampling import SAMPLE_META_ROWS
from deepspeed_tpu_torch.inference.v2.ragged.kv_cache import NULL_BLOCK


class RaggedBatchWrapper:

    def __init__(self, max_tokens, max_seqs, max_blocks_per_seq, lora=False):
        self.max_tokens = max_tokens
        self.max_seqs = max_seqs
        self.max_blocks = max_blocks_per_seq
        # multi-tenant LoRA: also pack a per-sequence adapter-slot row.
        # Strictly opt-in — off, the packed vector is byte-identical to
        # the pre-LoRA wire format.
        self.lora = bool(lora)
        self.clear()

    def clear(self):
        self.token_ids = np.zeros(self.max_tokens, np.int32)
        # pad tokens live in the extra pad slot (row max_seqs)
        self.token_seq = np.full(self.max_tokens, self.max_seqs, np.int32)
        self.token_pos = np.zeros(self.max_tokens, np.int32)
        self.block_tables = np.full((self.max_seqs + 1, self.max_blocks), NULL_BLOCK, np.int32)
        self.last_index = np.zeros(self.max_seqs, np.int32)
        self.seq_valid = np.zeros(self.max_seqs, bool)
        if self.lora:
            # pad row (max_seqs) stays 0 = the base slot
            self.seq_adapters = np.zeros(self.max_seqs + 1, np.int32)
        self._cursor = 0
        self._order = []  # slots in insertion order

    @property
    def current_tokens(self):
        return self._cursor

    @property
    def current_sequences(self):
        return len(self._order)

    def insert_sequence(self, desc, tokens):
        """Append ``tokens`` (this step's chunk) for ``desc``; positions
        continue from the tokens already in the KV cache."""
        n = len(tokens)
        if self._cursor + n > self.max_tokens:
            raise ValueError(f"ragged batch overflow: {self._cursor}+{n} > {self.max_tokens}")
        if desc.slot >= self.max_seqs:
            raise ValueError(f"slot {desc.slot} out of range")
        if len(desc.blocks) > self.max_blocks:
            raise ValueError(f"sequence {desc.uid} owns {len(desc.blocks)} blocks > "
                             f"max_blocks_per_seq={self.max_blocks} (context overflow)")
        sl = slice(self._cursor, self._cursor + n)
        self.token_ids[sl] = np.asarray(tokens, np.int32)
        self.token_seq[sl] = desc.slot
        self.token_pos[sl] = desc.seen_tokens + np.arange(n, dtype=np.int32)
        blocks = desc.blocks
        self.block_tables[desc.slot, :len(blocks)] = blocks
        self.last_index[desc.slot] = self._cursor + n - 1
        self.seq_valid[desc.slot] = True
        if self.lora:
            self.seq_adapters[desc.slot] = desc.adapter_slot
        self._cursor += n
        self._order.append(desc.slot)

    def finalize(self):
        """→ dict of numpy arrays for the device step."""
        return {
            "token_ids": self.token_ids,
            "token_seq": self.token_seq,
            "token_pos": self.token_pos,
            "block_tables": self.block_tables,
            "last_index": self.last_index,
            "num_tokens": np.int32(self._cursor),
        }

    def finalize_packed(self, bucket=None):
        """→ ONE flat int32 vector holding the whole batch's metadata —
        a single host→device transfer per step instead of six (the
        reference keeps its metadata in a pinned host struct copied as
        one buffer, ragged_wrapper.py:292 / csrc fast host descriptors;
        this is the same idea for an RPC/PCIe hop). Unpack on device
        with :func:`unpack_batch`.

        ``bucket`` pads the token arrays to that length instead of
        ``max_tokens`` — shape bucketing: a pure-decode step (≤ max_seqs
        real tokens) compiles to a program ~max_tokens/max_seqs× smaller
        than the prefill-chunk program, so decode rounds don't pay the
        full token budget in MLP flops and KV-gather traffic."""
        bucket = self.max_tokens if bucket is None else int(bucket)
        if not self._cursor <= bucket <= self.max_tokens:
            raise ValueError(f"bucket {bucket} must cover the {self._cursor} batched "
                             f"tokens and not exceed max_tokens={self.max_tokens} — "
                             f"a smaller bucket would silently truncate the batch")
        parts = [
            self.token_ids[:bucket], self.token_seq[:bucket], self.token_pos[:bucket],
            self.block_tables.ravel(), self.last_index,
            np.asarray([self._cursor], np.int32)]
        if self.lora:
            parts.append(self.seq_adapters)
        return np.concatenate(parts)

    def slots_in_order(self):
        return list(self._order)


def unpack_batch(packed, max_seqs, max_blocks, lora=False, sampled=False):
    """Inverse of :meth:`RaggedBatchWrapper.finalize_packed`: views of
    the flat (device) tensor back into the step's dict. The token-bucket
    length is derived from the vector's size. ``lora`` must match the
    wrapper's flag: on, the trailing per-sequence adapter-slot row comes
    out as ``seq_adapters``. ``sampled`` parses the per-sequence
    sampling-spec rows the engine's sampled step appends AFTER the
    wrapper's own fields (``SAMPLE_META_ROWS`` int32 rows of ``max_seqs``,
    see ``inference.structured.sampling``) as ``sample_meta``."""
    ms, mb = max_seqs, max_blocks
    extra = (ms + 1) if lora else 0
    if sampled:
        extra += SAMPLE_META_ROWS * ms
    mt = (packed.shape[0] - (ms + 1) * mb - ms - 1 - extra) // 3
    o = 0
    token_ids = packed[o:o + mt]; o += mt
    token_seq = packed[o:o + mt]; o += mt
    token_pos = packed[o:o + mt]; o += mt
    block_tables = packed[o:o + (ms + 1) * mb].reshape(ms + 1, mb); o += (ms + 1) * mb
    last_index = packed[o:o + ms]; o += ms
    num_tokens = packed[o]
    out = {"token_ids": token_ids, "token_seq": token_seq, "token_pos": token_pos,
           "block_tables": block_tables, "last_index": last_index,
           "num_tokens": num_tokens}
    if lora:
        out["seq_adapters"] = packed[o + 1:o + 2 + ms]
    if sampled:
        out["sample_meta"] = packed[packed.shape[0] - SAMPLE_META_ROWS * ms:]
    return out
