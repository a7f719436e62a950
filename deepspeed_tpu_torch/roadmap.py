"""The port's queue of work still to do (ROADMAP.md, "Port queue"), for
the errors that name an item when a caller asks for what is not ported."""

PORT_QUEUE = {
    4: "the serving stack: the fleet's wire protocol, the serving autotuner",
    5: "tensor- and expert-parallel serving",
    6: "the GPT family and the rest of the surface",
    7: "ZeRO 1/2/3 across processes over NCCL",
    8: "checkpoint save/load",
    9: "fp16 dynamic loss scaling",
    10: "remat policy 'dots'",
    11: "the other optimizers",
    12: "offload",
    18: "the flat quantized layout and the FP_Quantize API",
}


def not_ported(what, item):
    """→ the ``NotImplementedError`` for ``what``, naming queue ``item``."""
    return NotImplementedError(f"{what} is not ported yet: ROADMAP.md, port queue item "
                               f"{item} ({PORT_QUEUE[item]})")
