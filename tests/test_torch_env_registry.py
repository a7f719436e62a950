"""The port's ``DS_*`` registry (``deepspeed_tpu_torch/utils/env_registry.py``)
against the JAX package's.

- every knob the JAX package registers is registered, with the same
  name, kind, default, range, choices and tuning tag; the port's
  ``tunable_knobs`` equal JAX's;
- the readers (``env_bool``, ``env_opt_bool``, ``env_int``, ``env_str``,
  ``env_raw``) parse every raw string as the JAX readers do, and an
  unregistered name raises ``KeyError`` in both;
- ``register`` refuses what the JAX one refuses, with nothing added;
- each switch the port reads through the registry (prefix cache, KV tier,
  LoRA, spec and constrained decoding, pipelined bursts, the sanitizer,
  the seed) gives what the JAX switch gives, set either way or unset;
- no port module reads a ``DS_*`` variable around the registry, and every
  knob a port module reads names, as its ``consumer``, a port file that
  reads it."""

import pathlib
import re

import pytest

from deepspeed_tpu.inference.structured import constrained_enabled as jax_constrained
from deepspeed_tpu.inference.v2.kv_tier import (kv_tier_bytes as jax_kv_tier_bytes,
                                                kv_tier_enabled as jax_kv_tier_enabled,
                                                kv_tier_quantized as jax_kv_tier_quantized)
from deepspeed_tpu.inference.v2.prefix_cache import prefix_cache_enabled as jax_prefix_enabled
from deepspeed_tpu.inference.v2.spec import spec_decode_enabled as jax_spec_enabled
from deepspeed_tpu.serving.lora import (lora_hot_set as jax_lora_hot_set,
                                        lora_max_rank as jax_lora_max_rank,
                                        lora_serving_enabled as jax_lora_enabled)
from deepspeed_tpu.utils import env_registry as J
from deepspeed_tpu.utils.sanitize import sanitize_enabled as jax_sanitize_enabled
from deepspeed_tpu_torch.inference.structured import constrained_enabled
from deepspeed_tpu_torch.inference.v2.engine_v2 import async_burst_enabled, ds_seed
from deepspeed_tpu_torch.inference.v2.kv_tier import (kv_tier_bytes, kv_tier_enabled,
                                                      kv_tier_quantized)
from deepspeed_tpu_torch.inference.v2.prefix_cache import prefix_cache_enabled
from deepspeed_tpu_torch.inference.v2.spec import spec_decode_enabled
from deepspeed_tpu_torch.serving.lora import lora_hot_set, lora_max_rank, lora_serving_enabled
from deepspeed_tpu_torch.utils import env_registry as P
from deepspeed_tpu_torch.utils.sanitize import sanitize_enabled

ROOT = pathlib.Path(__file__).resolve().parents[1]
RAWS = [None, "", "0", "1", "2", " 7 ", "-3", "false", "FALSE", " off ", "No", "yes", "on",
        "junk", "inproc"]


def _fields(knob):
    return (knob.name, knob.kind, knob.default, knob.min_value, knob.max_value, knob.choices,
            knob.tuning)


def test_every_knob_matches_jax():
    assert [_fields(k) for k in P.all_knobs()] == [_fields(k) for k in J.all_knobs()]
    assert [k.name for k in P.tunable_knobs()] == [k.name for k in J.tunable_knobs()]
    for tag in ("offline", "online"):
        assert [k.name for k in P.tunable_knobs(tag)] == [k.name for k in J.tunable_knobs(tag)]
    keys = ("name", "type", "default", "range", "choices", "tuning")
    assert [{f: s[f] for f in keys} for s in P.knob_schema()] == \
        [{f: s[f] for f in keys} for s in J.knob_schema()]
    assert all(k.describe_default() == J.get_knob(k.name).describe_default()
               for k in P.all_knobs())


@pytest.mark.parametrize("raw", RAWS, ids=repr)
def test_readers_parse_as_jax(monkeypatch, raw):
    for knob in J.all_knobs():
        if raw is None:
            monkeypatch.delenv(knob.name, raising=False)
        else:
            monkeypatch.setenv(knob.name, raw)
    for knob in P.all_knobs():
        reader = {"bool": "env_bool", "int": "env_int", "str": "env_str",
                  "optional_bool": "env_opt_bool", "optional_str": "env_raw"}[knob.kind]
        assert getattr(P, reader)(knob.name) == getattr(J, reader)(knob.name), knob.name
        assert P.env_raw(knob.name) == J.env_raw(knob.name)
    if raw is not None:
        assert P.parse_bool(raw) == J.parse_bool(raw)


def test_unregistered_names_raise():
    for mod in (P, J):
        for reader in (mod.env_bool, mod.env_int, mod.env_str, mod.env_opt_bool, mod.env_raw,
                       mod.get_knob):
            with pytest.raises(KeyError, match="not registered"):
                reader("DS_NO_SUCH_KNOB")


@pytest.mark.parametrize("args,kw", [
    (("XS_NAME", "bool", False, "d", "c"), {}),
    (("DS_NEW_KNOB", "float", 0.0, "d", "c"), {}),
    (("DS_SEED", "int", 1, "d", "c"), {}),
    (("DS_NEW_KNOB", "bool", False, "d", "c"), {"tuning": "sometimes"}),
    (("DS_NEW_KNOB", "str", "a", "d", "c"), {"min_value": 1}),
    (("DS_NEW_KNOB", "int", 5, "d", "c"), {"min_value": 9, "max_value": 1}),
    (("DS_NEW_KNOB", "int", 5, "d", "c"), {"choices": (1, 2)}),
    (("DS_NEW_KNOB", "str", "a", "d", "c"), {"choices": ()}),
    (("DS_NEW_KNOB", "int", 0, "d", "c"), {"min_value": 1}),
    (("DS_NEW_KNOB", "int", 9, "d", "c"), {"max_value": 1}),
], ids=["prefix", "kind", "twice", "tuning", "range_kind", "range_order", "int_choices",
        "empty_choices", "below", "above"])
def test_register_refuses_as_jax(args, kw):
    before = len(P.all_knobs())
    for mod in (P, J):
        with pytest.raises(ValueError):
            mod.register(*args, **kw)
    assert len(P.all_knobs()) == before
    with pytest.raises(ValueError, match="fixed"):
        P.tunable_knobs("fixed")


class Cfg:
    def __init__(self, **kw):
        self.__dict__.update(kw)


SWITCHES = {  # knob: [(port reader, JAX reader, config)]
    "DS_PREFIX_CACHE": [(prefix_cache_enabled, jax_prefix_enabled, "enabled")],
    "DS_KV_TIER": [(kv_tier_enabled, jax_kv_tier_enabled, "enabled")],
    "DS_KV_TIER_QUANT": [(kv_tier_quantized, jax_kv_tier_quantized, "quantize")],
    "DS_KV_TIER_BYTES": [(kv_tier_bytes, jax_kv_tier_bytes, "host_bytes")],
    "DS_LORA": [(lora_serving_enabled, jax_lora_enabled, "enabled")],
    "DS_LORA_HOT_SET": [(lora_hot_set, jax_lora_hot_set, "hot_set")],
    "DS_LORA_MAX_RANK": [(lora_max_rank, jax_lora_max_rank, "max_rank")],
    "DS_SPEC_DECODE": [(spec_decode_enabled, jax_spec_enabled, "enabled")],
    "DS_CONSTRAINED": [(constrained_enabled, jax_constrained, "enabled")],
}


@pytest.mark.parametrize("knob", sorted(SWITCHES) + ["DS_ASYNC_BURST", "DS_SANITIZE",
                                                     "DS_SEED"])
def test_switches_read_as_jax(monkeypatch, knob):
    from deepspeed_tpu.inference.v2.config_v2 import AsyncBurstConfig as JaxAsync
    from deepspeed_tpu.inference.v2.engine_v2 import async_burst_enabled as jax_async
    from deepspeed_tpu_torch.inference.v2.config_v2 import AsyncBurstConfig
    for raw in ("0", "1", "off", "12", "junk", None):
        if raw is None:
            monkeypatch.delenv(knob, raising=False)
        else:
            monkeypatch.setenv(knob, raw)
        if knob == "DS_ASYNC_BURST":
            for on in (False, True):
                assert async_burst_enabled(AsyncBurstConfig(enabled=on)) == \
                    jax_async(JaxAsync(enabled=on))
        elif knob == "DS_SANITIZE":
            assert sanitize_enabled() == jax_sanitize_enabled()
        elif knob == "DS_SEED":
            assert ds_seed() == J.env_int("DS_SEED")
        else:
            for port, jax_fn, field in SWITCHES[knob]:
                for value in (False, True, 0, 3, 1 << 20):
                    assert port(Cfg(**{field: value})) == jax_fn(Cfg(**{field: value})), \
                        (raw, field, value)


def test_port_reads_ds_variables_only_through_the_registry():
    pkg = ROOT / "deepspeed_tpu_torch"
    for path in pkg.rglob("*.py"):
        if path.name == "env_registry.py":
            continue
        src = path.read_text()
        assert not re.search(r"environ(\.get)?[\[(]\s*[\"']DS_", src), path
        assert not re.search(r"getenv\(\s*[\"']DS_", src), path


def test_consumer_is_a_port_reader():
    """For every knob a module of ``deepspeed_tpu_torch/`` reads through an
    ``env_*("NAME")`` call, ``consumer`` names one of the port files that
    read it, and that file exists."""
    pkg = ROOT / "deepspeed_tpu_torch"
    readers = {}
    for path in pkg.rglob("*.py"):
        for name in re.findall(r"env_(?:raw|bool|int|str|opt_bool)\(\s*[\"'](DS_[A-Z0-9_]+)",
                               path.read_text()):
            readers.setdefault(name, set()).add(path.relative_to(ROOT).as_posix())
    assert {"DS_FLEET_TRANSPORT", "DS_WIRE_TIMEOUT_S", "DS_WIRE_BIND", "DS_REFRESH_KEEP",
            "DS_WATCHDOG_TIMEOUT", "DS_PREEMPT_GRACE_S", "DS_AUTOTUNE",
            "DS_AUTOTUNE_CONFIG"} <= set(readers)
    for name, files in sorted(readers.items()):
        consumer = P.get_knob(name).consumer
        assert consumer in files, (name, consumer, sorted(files))
        assert (ROOT / consumer).is_file(), consumer
