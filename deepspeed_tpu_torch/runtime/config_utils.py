"""Typed config-section base, on dataclasses.

Port of ``deepspeed_tpu/runtime/config_utils.py``, whose base is a
pydantic model. The port has no pydantic, so a section is a dataclass
deriving from :class:`DeepSpeedConfigModel`: nested sections given as
dicts are built into their dataclass, and unknown keys raise
``TypeError`` (the dataclass constructor's own check). The JAX base's
deprecated-field forwarding, ``"auto"`` dropping and dict helpers have no
caller in the port yet and come with the training config (ROADMAP.md,
port queue item 2)."""

import dataclasses
import typing


@dataclasses.dataclass
class DeepSpeedConfigModel:

    def __post_init__(self):
        hints = typing.get_type_hints(type(self))
        for f in dataclasses.fields(self):
            value, kind = getattr(self, f.name), hints.get(f.name)
            if isinstance(value, dict) and isinstance(kind, type) and \
                    issubclass(kind, DeepSpeedConfigModel):
                setattr(self, f.name, kind(**value))
