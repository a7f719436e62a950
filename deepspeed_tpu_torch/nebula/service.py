"""Content hashing for the commit protocols.

Port of ``file_sha256`` from ``deepspeed_tpu/nebula/service.py``, copied as
it is; the checkpoint service around it waits with checkpointing
(ROADMAP.md, port queue item 8)."""

import hashlib


def file_sha256(path, chunk_bytes=1 << 20):
    """Streaming sha256 of a file (never loads the shard into memory)."""
    h = hashlib.sha256()
    with open(path, "rb") as fd:
        while True:
            chunk = fd.read(chunk_bytes)
            if not chunk:
                break
            h.update(chunk)
    return h.hexdigest()
