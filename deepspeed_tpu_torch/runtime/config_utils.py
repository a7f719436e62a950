"""Typed config-section base, on dataclasses.

Port of ``deepspeed_tpu/runtime/config_utils.py``, whose base is a
pydantic model. The port has no pydantic, so a section is a dataclass
deriving from :class:`DeepSpeedConfigModel`: nested sections given as
dicts are built into their dataclass, and unknown keys raise
``TypeError`` (the dataclass constructor's own check). The JAX base's
generic deprecated-field forwarding is replaced by explicit forwarding in
the one section that has such fields (``runtime/zero/config.py``).
``get_scalar_param`` and ``dict_raise_error_on_duplicate_keys`` are the
JAX module's helpers, copied."""

import collections
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


def get_scalar_param(param_dict, param_name, param_default_value):
    return param_dict.get(param_name, param_default_value)


def dict_raise_error_on_duplicate_keys(ordered_pairs):
    """Reject duplicate keys when parsing the JSON config."""
    d = dict((k, v) for k, v in ordered_pairs)
    if len(d) != len(ordered_pairs):
        counter = collections.Counter([pair[0] for pair in ordered_pairs])
        keys = [key for key, value in counter.items() if value > 1]
        raise ValueError("Duplicate keys in DeepSpeed config: {}".format(keys))
    return d
