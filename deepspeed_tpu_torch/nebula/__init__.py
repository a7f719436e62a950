"""The checkpoint service's helpers the port needs so far.

Port of ``deepspeed_tpu/nebula``: only :func:`~.service.file_sha256`, which
the weight publication checks hash payloads with. The service itself
(snapshot, persist, the commit protocol) waits with checkpointing
(ROADMAP.md, port queue item 8)."""

from deepspeed_tpu_torch.nebula.service import file_sha256

__all__ = ["file_sha256"]
