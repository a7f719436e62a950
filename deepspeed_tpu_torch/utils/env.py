"""The ``DS_*`` environment switches the port reads, beside ``DS_SEED``.

A copy of the parsing in ``deepspeed_tpu/utils/env_registry.py``
(``parse_bool``, ``env_opt_bool``, ``env_int``) for the knobs the
speculative and constrained decoding modules read, with the registry's
defaults. The rest of the registry (the knob table, typed schemas,
``DS_SANITIZE``) is not ported yet: ROADMAP.md, port queue item 4."""

import os

# the ONE truthiness rule; everything else is truthy (including "yes",
# "on", "2", and arbitrary junk — kill switches err toward "set means on")
_FALSY = frozenset({"0", "", "false", "off", "no"})

# name -> (kind, default), as the JAX package registers them
KNOBS = {
    "DS_SPEC_DECODE": ("optional_bool", None),
    "DS_SPEC_DRAFT_LEN": ("int", 0),
    "DS_CONSTRAINED": ("optional_bool", None),
}


def parse_bool(raw: str) -> bool:
    """Uniform env-string truthiness: falsy iff in ``_FALSY`` after
    strip+casefold."""
    return raw.strip().lower() not in _FALSY


def _knob(name, kind):
    if name not in KNOBS:
        raise KeyError(f"unregistered environment knob {name!r}")
    if KNOBS[name][0] != kind:
        raise TypeError(f"{name} is a {KNOBS[name][0]} knob, read as {kind}")
    return KNOBS[name][1]


def env_opt_bool(name: str):
    """Tri-state: None when unset, else uniform truthiness."""
    _knob(name, "optional_bool")
    raw = os.environ.get(name)
    if raw is None:
        return None
    return parse_bool(raw)


def env_int(name: str) -> int:
    """The integer value, or the knob's default when unset or not an
    integer."""
    default = _knob(name, "int")
    raw = os.environ.get(name)
    if raw is None:
        return int(default)
    try:
        return int(raw)
    except ValueError:
        return int(default)
