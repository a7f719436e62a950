"""The serving stack above the ragged engine.

Port of the parts of ``deepspeed_tpu/serving`` the ported engine uses:
``ServingError`` (:mod:`.admission`) and multi-tenant LoRA serving
(:mod:`.lora`). The gateway, admission control, fleet routing and weight
refresh are not ported yet (ROADMAP.md, port queue item 4)."""
