"""KV-cache block allocator.

Capability match for the reference's block allocator backing
``BlockedKVCache`` (``deepspeed/inference/v2/ragged/blocked_allocator.py``):
a free-list over a fixed pool of KV blocks. Pure host-side bookkeeping
(numpy); the device never sees this structure, only the block tables
the scheduler builds from it.

The free list is a FIFO list (allocation order stays deterministic —
tests and block-table goldens rely on it) mirrored by a set, so the
double-free check in ``free()`` is O(1) per block instead of a scan of
the whole free list (O(free²) per call at pool scale)."""

import threading

import numpy as np

from deepspeed_tpu_torch.utils.sanitize import check_allocator, sanitize_enabled


class BlockedAllocator:

    def __init__(self, num_blocks: int):
        if num_blocks < 1:
            raise ValueError(f"need at least 1 block, got {num_blocks}")
        self._num_blocks = num_blocks
        self._free = list(range(num_blocks))
        self._free_set = set(self._free)
        # serving runs allocate/free from both the gateway pump thread
        # and client threads (suspend/flush); mutations stay atomic
        self._lock = threading.Lock()
        self._sanitize = sanitize_enabled()

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def total_blocks(self) -> int:
        return self._num_blocks

    def allocate(self, num_blocks: int) -> np.ndarray:
        with self._lock:
            if self._sanitize:
                check_allocator(self)
            if num_blocks > len(self._free):
                raise ValueError(
                    f"requested {num_blocks} blocks but only {len(self._free)} free")
            out = self._free[:num_blocks]
            self._free = self._free[num_blocks:]
            self._free_set.difference_update(out)
        return np.asarray(out, dtype=np.int32)

    def free(self, blocks) -> None:
        blocks = [int(b) for b in np.atleast_1d(blocks)]
        with self._lock:
            if self._sanitize:
                check_allocator(self)
            # validate the WHOLE batch (including duplicates within it)
            # before mutating, so a failed free leaves the list untouched
            seen = set()
            for b in blocks:
                if b < 0 or b >= self._num_blocks:
                    raise ValueError(f"invalid block id {b}")
                if b in self._free_set or b in seen:
                    raise ValueError(f"double free of block {b}")
                seen.add(b)
            self._free.extend(blocks)
            self._free_set.update(blocks)
