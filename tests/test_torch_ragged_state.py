"""Ragged host state in the PyTorch port vs the JAX package.

Allocator, state manager and batch assembly are copies: the same
allocate / free / rewind / flush sequence must hand out the same block
ids and raise the same errors, and ``finalize_packed`` must give the
byte-identical int32 vector the device step consumes."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepspeed_tpu.inference.v2 import ragged as jr
from deepspeed_tpu_torch.inference.v2 import ragged as tr

torch.set_num_threads(1)  # the suite runs in parallel worker processes

BS = 8


def _pair(num_blocks=17, max_tracked=4):
    jc = jr.BlockedKVCache(2, num_blocks, BS, 2, 4, dtype=jnp.float32)
    tc = tr.BlockedKVCache(2, num_blocks, BS, 2, 4, dtype=torch.float32, device="cpu")
    return (jr.DSStateManager(jc, max_tracked), jc), (tr.DSStateManager(tc, max_tracked), tc)


def _script(mgr, cache):
    """One allocate/advance/rewind/flush script; → the observable trace
    (block tables, free counts, error types) for comparison."""
    trace = []
    a = mgr.get_or_create_sequence(1)
    mgr.allocate_for(a, 20)
    a.advance(20)
    b = mgr.get_or_create_sequence(2)
    mgr.allocate_for(b, 9)
    b.advance(9)
    mgr.allocate_for(a, 5)  # fits in a's third block
    a.advance(5)
    trace.append((list(a.blocks), list(b.blocks), cache.free_blocks))
    mgr.rewind_sequence(a, 10)  # 25 → 15 tokens: third block returns
    trace.append((a.seen_tokens, list(a.blocks), cache.free_blocks))
    mgr.flush_sequence(2)
    c = mgr.get_or_create_sequence(3)
    mgr.allocate_for(c, 30)  # FIFO: reuses the oldest freed ids last
    trace.append((list(c.blocks), cache.free_blocks))
    for bad in (lambda: mgr.flush_sequence(2), lambda: mgr.rewind_sequence(a, 99),
                lambda: cache.free([c.blocks[0]]) or cache.free([c.blocks[0]]),
                lambda: cache.free([10 ** 6]), lambda: cache.reserve(10 ** 6)):
        try:
            bad()
            trace.append(None)
        except (KeyError, ValueError) as e:
            trace.append((type(e).__name__, str(e)))
    return trace


def test_allocate_free_rewind_sequence_matches():
    (jm, jc), (tm, tc) = _pair()
    assert _script(tm, tc) == _script(jm, jc)


def test_tracked_sequence_cap_matches():
    for mgr, _ in _pair(max_tracked=1):
        mgr.get_or_create_sequence(1)
        with pytest.raises(RuntimeError, match="max_tracked_sequences=1 exceeded"):
            mgr.get_or_create_sequence(2)


def test_null_block_pinned_and_pool_bytes():
    (_, jc), (_, tc) = _pair()
    assert tc.free_blocks == jc.free_blocks == 16
    assert tc.bytes() == jc.bytes()
    assert tuple(tc.k.shape) == tuple(jc.k.shape)


@pytest.mark.parametrize("bucket", [None, 4, 12])
def test_finalize_packed_byte_equal(bucket):
    outs = []
    for mod in (jr, tr):
        w = mod.RaggedBatchWrapper(max_tokens=16, max_seqs=4, max_blocks_per_seq=3)
        for slot, (seen, blocks, toks) in enumerate(
                [(5, [3, 4], [1, 2, 3]), (0, [7], [9]), (12, [1, 2], [4, 5, 6, 7, 8])][
                    :2 if bucket == 4 else 3]):
            d = mod.DSSequenceDescriptor(uid=slot, block_size=BS, slot=slot)
            d.seen_tokens = seen
            d.extend_blocks(blocks)
            w.insert_sequence(d, toks)
        outs.append(w.finalize_packed(bucket=bucket))
    assert outs[0].dtype == outs[1].dtype == np.int32
    assert outs[0].tobytes() == outs[1].tobytes()


def test_unpack_batch_roundtrip_on_torch_tensor():
    w = tr.RaggedBatchWrapper(max_tokens=8, max_seqs=2, max_blocks_per_seq=3)
    d = tr.DSSequenceDescriptor(uid=0, block_size=BS, slot=0)
    d.seen_tokens = 6
    d.extend_blocks([5, 6])
    w.insert_sequence(d, [11, 12, 13])
    want = w.finalize()
    got = tr.ragged_wrapper.unpack_batch(torch.from_numpy(w.finalize_packed()), 2, 3)
    for key in ("token_ids", "token_seq", "token_pos", "block_tables", "last_index"):
        np.testing.assert_array_equal(got[key].numpy(), want[key])
    assert int(got["num_tokens"]) == 3
