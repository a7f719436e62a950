"""Central registry for every ``DS_*`` environment knob.

A copy of ``deepspeed_tpu/utils/env_registry.py`` (stdlib only), so the
port reads the same switches with the same parsing and defaults:

- parsing is uniform: the falsy strings are exactly ``{"0", "", "false",
  "off", "no"}`` (case- and whitespace-insensitive);
- every knob carries a name, kind, default, description and the module
  that reads it;
- knobs optionally carry a typed schema (legal range or choices and a
  tuning-relevance tag).

The table is data: knobs of features the port does not serve yet are
registered too, with the JAX package's kinds and defaults, and name the
JAX package's module as their consumer until the port reads them; a
knob the port reads names a port file that reads it.
"""

import dataclasses
import os
from typing import Dict, List, Optional, Tuple, Union

# the ONE truthiness rule; everything else is truthy (including "yes",
# "on", "2", and arbitrary junk — kill switches err toward "set means on")
_FALSY = frozenset({"0", "", "false", "off", "no"})


def parse_bool(raw: str) -> bool:
    """Uniform env-string truthiness: falsy iff in ``_FALSY`` after
    strip+casefold."""
    return raw.strip().lower() not in _FALSY


# tuning-relevance tags: None = not a tuning knob; "offline" = changing
# it means rebuilding the engine (the offline tuner's search space);
# "online" = cheap to flip on a live gateway (the SLO controller's
# actuation surface); "fixed" = a determinism anchor the autotuner must
# NEVER search — changing it changes every replayed stream's bits (the
# fleet's failover/canary replay contract), so it is excluded from
# tunable_knobs() entirely
_TUNING_TAGS = (None, "offline", "online", "fixed")


@dataclasses.dataclass(frozen=True)
class EnvKnob:
    """One registered ``DS_*`` environment variable.

    ``min_value``/``max_value`` (int knobs) and ``choices`` (bool /
    str-family knobs) describe the *legal* value space; ``tuning`` marks
    whether — and how — the serving autotuner may search it. All three
    are optional so plain kill switches stay one-line registrations.
    """
    name: str
    kind: str  # bool | int | str | optional_bool | optional_str
    default: Union[bool, int, str, None]
    description: str
    consumer: str  # module that reads it — docs/debugging breadcrumb
    min_value: Optional[int] = None
    max_value: Optional[int] = None
    choices: Optional[Tuple] = None
    tuning: Optional[str] = None  # None | "offline" | "online" | "fixed"

    def describe_default(self) -> str:
        if self.kind in ("optional_bool", "optional_str"):
            return "(unset)"
        if self.kind == "bool":
            return "1" if self.default else "0"
        return str(self.default)

    def doc_row(self) -> str:
        """The knob's MIGRATING.md table row — the ONE format both
        ``ds_lint --list-knobs`` and the knob-docs drift rule key on."""
        return (f"| `{self.name}` | {self.kind} | `{self.describe_default()}` "
                f"| {self.description} (read by `{self.consumer}`) |")

    def schema(self) -> Dict:
        """JSON-serializable typed schema entry (``--format=json`` and
        the offline tuner's knob-space enumeration read this)."""
        rng = (None if self.min_value is None and self.max_value is None
               else [self.min_value, self.max_value])
        return {
            "name": self.name,
            "type": self.kind,
            "default": self.default,
            "range": rng,
            "choices": list(self.choices) if self.choices else None,
            "tuning": self.tuning,
            "description": self.description,
            "consumer": self.consumer,
            "doc_row": self.doc_row(),
        }


_REGISTRY: Dict[str, EnvKnob] = {}


def register(name: str, kind: str, default, description: str,
             consumer: str, *, min_value: Optional[int] = None,
             max_value: Optional[int] = None, choices=None,
             tuning: Optional[str] = None) -> EnvKnob:
    if not name.startswith("DS_"):
        raise ValueError(f"env knob {name!r} must start with DS_")
    if kind not in ("bool", "int", "str", "optional_bool", "optional_str"):
        raise ValueError(f"unknown knob kind {kind!r} for {name}")
    if name in _REGISTRY:
        raise ValueError(f"env knob {name} registered twice")
    if tuning not in _TUNING_TAGS:
        raise ValueError(f"unknown tuning tag {tuning!r} for {name} "
                         f"(expected one of {_TUNING_TAGS})")
    if (min_value is not None or max_value is not None) and kind != "int":
        raise ValueError(f"min/max only apply to int knobs ({name} is "
                         f"{kind})")
    if min_value is not None and max_value is not None \
            and min_value > max_value:
        raise ValueError(f"{name}: min_value {min_value} > max_value "
                         f"{max_value}")
    if choices is not None:
        if kind == "int":
            raise ValueError(f"{name}: int knobs use min/max, not choices")
        choices = tuple(choices)
        if not choices:
            raise ValueError(f"{name}: choices must be non-empty")
    if kind == "int" and min_value is not None \
            and int(default) < min_value:
        raise ValueError(f"{name}: default {default} below min_value "
                         f"{min_value}")
    if kind == "int" and max_value is not None \
            and int(default) > max_value:
        raise ValueError(f"{name}: default {default} above max_value "
                         f"{max_value}")
    knob = EnvKnob(name, kind, default, description, consumer,
                   min_value=min_value, max_value=max_value,
                   choices=choices, tuning=tuning)
    _REGISTRY[name] = knob
    return knob


def get_knob(name: str) -> EnvKnob:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"env knob {name} is not registered; add it to "
            "deepspeed_tpu_torch/utils/env_registry.py") from None


def all_knobs() -> List[EnvKnob]:
    return sorted(_REGISTRY.values(), key=lambda k: k.name)


def tunable_knobs(tag: Optional[str] = None) -> List[EnvKnob]:
    """Knobs carrying a searchable tuning tag (optionally restricted to
    one tag) — the autotuner's search-space enumeration source.
    ``"fixed"`` knobs are determinism anchors (e.g. ``DS_SEED``): tagged
    so their replay-contract role is machine-readable, but NEVER
    enumerated here — an autotuner flipping one would silently break
    every bit-identical-replay guarantee in the fleet."""
    if tag is not None and tag not in _TUNING_TAGS:
        raise ValueError(f"unknown tuning tag {tag!r}")
    if tag == "fixed":
        raise ValueError("'fixed' knobs are excluded from tuning by "
                         "definition — they anchor replay determinism")
    return [k for k in all_knobs()
            if k.tuning is not None and k.tuning != "fixed"
            and (tag is None or k.tuning == tag)]


def knob_schema() -> List[Dict]:
    """The full typed knob schema as JSON-serializable dicts — the one
    artifact ``ds_lint --list-knobs --format=json``, the MIGRATING.md
    knob table, and the offline tuner all derive from."""
    return [k.schema() for k in all_knobs()]


# ------------------------------------------------------------------ readers
def env_raw(name: str) -> Optional[str]:
    """The raw string, or None when unset. The knob must be registered —
    this is the only accessor that exposes "unset" for the tri-state
    knobs (``DS_PALLAS``, ``DS_PREFIX_CACHE``)."""
    get_knob(name)
    return os.environ.get(name)


def env_bool(name: str) -> bool:
    knob = get_knob(name)
    raw = os.environ.get(name)
    if raw is None:
        return bool(knob.default)
    return parse_bool(raw)


def env_opt_bool(name: str) -> Optional[bool]:
    """Tri-state: None when unset, else uniform truthiness."""
    raw = env_raw(name)
    if raw is None:
        return None
    return parse_bool(raw)


def env_int(name: str) -> int:
    knob = get_knob(name)
    raw = os.environ.get(name)
    if raw is None:
        return int(knob.default)
    try:
        return int(raw)
    except ValueError:
        return int(knob.default)


def env_str(name: str) -> str:
    knob = get_knob(name)
    raw = os.environ.get(name)
    if raw is None:
        return str(knob.default)
    return raw


# ------------------------------------------------------------------- knobs
# Runtime / training
register("DS_SEED", "int", 42,
         "Base PRNG seed for parameter init, dropout streams, and the "
         "serving counter-PRNG that keys every sampled token by "
         "(request seed, position) — all replicas in a fleet must share "
         "it or failover replay diverges.",
         "deepspeed_tpu_torch/inference/v2/engine_v2.py",
         tuning="fixed")
register("DS_ACCELERATOR", "optional_str", None,
         "Force the accelerator backend (tpu|cpu); unset auto-detects.",
         "deepspeed_tpu/accelerator/real_accelerator.py")
register("DS_TPU_LOG_LEVEL", "str", "info",
         "Logger level for the framework logger "
         "(debug|info|warning|error).",
         "deepspeed_tpu_torch/utils/logging.py")

# Kernels / inference
register("DS_PALLAS", "optional_bool", None,
         "Force Pallas TPU kernels on/off; unset auto-enables on the "
         "TPU backend only.",
         "deepspeed_tpu/ops/pallas/__init__.py")
register("DS_FUSED_QMM", "bool", True,
         "Kill switch for the fused dequant-matmul Pallas kernels in "
         "quantized serving.",
         "deepspeed_tpu/inference/quantization/quantization.py",
         tuning="offline")
register("DS_FUSED_GMM", "optional_bool", None,
         "Kill switch for the fused quantized grouped (MoE expert) "
         "GEMM: 0 restores dequantize-at-entry for the whole MoE "
         "subtree, 1 forces the boxed fused dispatch; set it wins in "
         "both directions, unset defaults to on.",
         "deepspeed_tpu/ops/grouped_gemm.py",
         tuning="offline")
register("DS_PREFIX_CACHE", "optional_bool", None,
         "Kill switch for the radix prefix cache; set it wins in both "
         "directions, unset defers to the engine config.",
         "deepspeed_tpu_torch/inference/v2/prefix_cache/manager.py",
         tuning="offline")
register("DS_KV_TIER", "optional_bool", None,
         "Kill switch for the host-RAM KV spill tier (tier-2 of the "
         "prefix cache); set it wins in both directions, unset defers "
         "to the engine config.",
         "deepspeed_tpu_torch/inference/v2/kv_tier/__init__.py",
         tuning="offline")
register("DS_KV_TIER_BYTES", "int", 0,
         "Host byte budget for tier-2 KV blocks; 0 defers to the "
         "engine config's kv_tier.host_bytes.",
         "deepspeed_tpu_torch/inference/v2/kv_tier/__init__.py",
         min_value=0, tuning="offline")
register("DS_KV_TIER_QUANT", "optional_bool", None,
         "Store tier-2 KV blocks as per-(layer, block)-grouped int8 "
         "(~2x blocks per byte, lossy, never silently on); set it wins "
         "in both directions, unset defers to the engine config.",
         "deepspeed_tpu_torch/inference/v2/kv_tier/__init__.py",
         tuning="offline")
register("DS_LORA", "optional_bool", None,
         "Kill switch for multi-tenant LoRA serving (segmented adapter "
         "deltas + AdapterStore paging); set it wins in both "
         "directions, unset defers to the engine config. Off builds "
         "the exact pre-LoRA pipeline (program keys unchanged).",
         "deepspeed_tpu_torch/serving/lora/__init__.py",
         tuning="offline")
register("DS_LORA_HOT_SET", "int", 0,
         "Hot adapter slots the AdapterStore keeps resident as HBM "
         "slabs; 0 defers to the engine config's lora.hot_set.",
         "deepspeed_tpu_torch/serving/lora/__init__.py",
         min_value=0, tuning="offline")
register("DS_LORA_MAX_RANK", "int", 0,
         "Rank bucket ceiling for hot adapter slabs (smaller ranks "
         "zero-pad up, larger ranks are rejected at registration); 0 "
         "defers to the engine config's lora.max_rank.",
         "deepspeed_tpu_torch/serving/lora/__init__.py",
         min_value=0, tuning="offline")
register("DS_CONSTRAINED", "optional_bool", None,
         "Kill switch for grammar/JSON-schema constrained decoding "
         "(token-DFA logits masks in the sampled programs); set it wins "
         "in both directions, unset defers to the engine config. Off "
         "builds the exact pre-structured pipeline (program keys "
         "unchanged).",
         "deepspeed_tpu_torch/inference/structured/__init__.py",
         tuning="offline")
register("DS_ASYNC_BURST", "optional_bool", None,
         "Kill switch for pipelined (double-buffered) decode bursts: "
         "the host plans burst k+1 while burst k executes and fences "
         "one burst late; set it wins in both directions, unset defers "
         "to the engine config's async_burst.enabled. Off rebuilds the "
         "exact pre-pipeline loop (program keys unchanged); the emitted "
         "streams are bit-identical either way.",
         "deepspeed_tpu_torch/inference/v2/engine_v2.py",
         tuning="offline")
register("DS_SPEC_DECODE", "optional_bool", None,
         "Kill switch for self-speculative decoding (n-gram drafting + "
         "batched verify); set it wins in both directions, unset defers "
         "to the engine config.",
         "deepspeed_tpu_torch/inference/v2/spec/state.py",
         tuning="offline")
register("DS_SPEC_DRAFT_LEN", "int", 0,
         "Override the max draft tokens proposed per verify step; 0 "
         "defers to the engine config's spec_decode.draft_len.",
         "deepspeed_tpu_torch/inference/v2/spec/state.py",
         min_value=0, max_value=32, tuning="online")
register("DS_FLEET_FAILOVER", "bool", True,
         "Kill switch for cross-replica failover retries in the fleet "
         "router; off, a failed attempt fails the request immediately.",
         "deepspeed_tpu_torch/serving/fleet/router.py")
register("DS_FLEET_PREFIX_ROUTING", "bool", True,
         "Kill switch for prefix-cache-aware replica placement; off, "
         "the router always picks the least-loaded routable replica.",
         "deepspeed_tpu_torch/serving/fleet/router.py")
register("DS_DISAGG", "optional_bool", None,
         "Kill switch for disaggregated prefill/decode serving; set it "
         "wins in both directions, unset defers to fleet.disagg.",
         "deepspeed_tpu_torch/serving/fleet/router.py",
         tuning="offline")
register("DS_DISAGG_HANDOFF_DEADLINE_S", "int", 0,
         "Deadline (seconds) a published prefill->decode KV handoff may "
         "wait before it expires and the request is re-planned; 0 "
         "defers to fleet.handoff_deadline_s.",
         "deepspeed_tpu_torch/serving/fleet/router.py")
register("DS_DISAGG_FALLBACK", "bool", True,
         "Kill switch for graceful degradation to unified serving when "
         "the disagg path fails; off, a failed handoff fails the "
         "request with a typed error instead of falling back.",
         "deepspeed_tpu_torch/serving/fleet/router.py")
register("DS_FLEET_TRANSPORT", "optional_str", None,
         "Fleet replica transport: 'inproc' (default — replicas are "
         "in-process GatewayReplica objects, byte-identical to the "
         "pre-wire fleet) or 'wire' (replicas are separate processes "
         "reached over the framed socket protocol); unset behaves as "
         "'inproc'.",
         "deepspeed_tpu_torch/serving/fleet/wire/__init__.py",
         choices=("inproc", "wire"))
register("DS_WIRE_TIMEOUT_S", "int", 30,
         "Default I/O deadline (seconds) for unary wire calls from "
         "WireReplica to a replica server (submit ack, handoff claim, "
         "import, drain/restart/refresh get this on top of their own "
         "budgets); a blown deadline raises WireTimeoutError.",
         "deepspeed_tpu_torch/serving/fleet/wire/client.py",
         min_value=1, max_value=3600)
register("DS_WIRE_BIND", "optional_str", None,
         "Default bind address for a replica server when the launcher "
         "passes none: 'host:port' (port 0 = ephemeral) or "
         "'unix:/path.sock'; unset falls back to 127.0.0.1:0.",
         "deepspeed_tpu_torch/serving/fleet/wire/server.py")
register("DS_REFRESH_CANARY", "optional_bool", None,
         "Kill switch for the live-weight-refresh canary gate (first "
         "refreshed replica verified bit-identically against a cold-"
         "started engine on the new weights); set it wins in both "
         "directions, unset defers to fleet.refresh_canary.",
         "deepspeed_tpu_torch/serving/refresh/controller.py")
register("DS_REFRESH_TIMEOUT_S", "int", 0,
         "Per-replica budget (seconds) for a staged live weight swap "
         "to land before the attempt is abandoned and retried; 0 "
         "defers to fleet.refresh_timeout_s.",
         "deepspeed_tpu_torch/serving/refresh/controller.py")
register("DS_REFRESH_KEEP", "int", 2,
         "Weight publications the publisher's retention GC keeps on "
         "disk (never fewer than the live and previous versions, so "
         "rollback always has a target).",
         "deepspeed_tpu_torch/serving/refresh/publisher.py")
register("DS_SANITIZE", "bool", False,
         "Enable runtime sanitizers: non-finite and index checks around "
         "the v2 engine's forwards, lock-order tracking, plus "
         "allocator/prefix-cache/KV-tier invariant assertions. Off by "
         "default (zero hot-path cost).",
         "deepspeed_tpu_torch/utils/sanitize.py")

# Launcher / elasticity
register("DS_MASTER_ADDR", "str", "",
         "Default master coordinator address for the launcher.",
         "deepspeed_tpu/launcher/runner.py")
register("DS_MASTER_PORT", "int", 29500,
         "Default master coordinator port for the launcher.",
         "deepspeed_tpu/launcher/runner.py")
register("DS_ELASTIC_RESTART_COUNT", "int", 0,
         "Restart ordinal the elastic agent exports into worker "
         "environments; >0 marks an elastic restart.",
         "deepspeed_tpu/elasticity/elastic_agent.py")
register("DS_ELASTIC_ENABLED", "bool", False,
         "Set by the elastic agent in worker environments when elastic "
         "training is active.",
         "deepspeed_tpu/elasticity/elastic_agent.py")
register("DS_PREEMPT_GRACE_S", "int", 30,
         "Grace budget (seconds) between SIGTERM and SIGKILL: the "
         "worker's emergency-checkpoint deadline, and how long the "
         "agent waits before escalating a forwarded/watchdog SIGTERM.",
         "deepspeed_tpu_torch/serving/fleet/wire/supervisor.py")
register("DS_WATCHDOG_TIMEOUT", "int", 0,
         "Hang watchdog: agent kills+relaunches the worker when the "
         "heartbeat step counter makes no progress for this many "
         "seconds. 0 disables the watchdog.",
         "deepspeed_tpu_torch/serving/fleet/wire/supervisor.py")
register("DS_EMERGENCY_CKPT", "bool", True,
         "Kill switch for the SIGTERM emergency-checkpoint path; off, "
         "a preempted worker exits without saving (resume falls back "
         "to the last periodic checkpoint).",
         "deepspeed_tpu/runtime/engine.py")
register("DS_HEARTBEAT_FILE", "optional_str", None,
         "Path the engine beats its step counter into for the agent's "
         "hang watchdog; exported by the agent, unset disables "
         "heartbeating.",
         "deepspeed_tpu/elasticity/preemption.py")
register("DS_ELASTIC_DOWN_SINCE", "optional_str", None,
         "Unix time the agent detected the previous worker's death; "
         "exported into relaunched workers so the engine can report "
         "Train/Elastic/recovery_s.",
         "deepspeed_tpu/runtime/engine.py")

# Autotuning / build
register("DS_AUTOTUNE", "optional_bool", None,
         "Kill switch for the online SLO controller in the serving "
         "gateway (live adjustment of token budget, admission depth, "
         "and spec draft length); set it wins in both directions, "
         "unset defers to serving.autotune.enabled.",
         "deepspeed_tpu_torch/serving/gateway.py")
register("DS_AUTOTUNE_INTERVAL_S", "int", 0,
         "Seconds between online SLO controller decision ticks; 0 "
         "defers to serving.autotune.interval_s.",
         "deepspeed_tpu/autotuning/online.py",
         min_value=0, max_value=3600)
register("DS_AUTOTUNE_CONFIG", "optional_str", None,
         "Path to a tuned-config JSON emitted by the offline serving "
         "tuner; the gateway applies its serving-scope knobs at "
         "construction, unset leaves the hand-picked config untouched.",
         "deepspeed_tpu_torch/serving/gateway.py")
register("DS_FORCE_PLATFORM", "optional_str", None,
         "Pin the JAX platform (cpu|tpu) in autotuner experiment "
         "runners; unset uses the default backend.",
         "deepspeed_tpu/autotuning/exp_runner.py")
register("DS_CXX", "optional_str", None,
         "C++ compiler for op_builder JIT extension builds; unset "
         "falls back to c++/g++/clang++ on PATH.",
         "op_builder/builder.py")
register("DS_BUILD_DIR", "optional_str", None,
         "Build/cache directory for op_builder JIT extensions; unset "
         "uses ~/.cache/deepspeed_tpu/ops.",
         "op_builder/builder.py")

# Test-only
register("DS_SKIP_MULTIPROC", "bool", False,
         "Test-only: skip multi-process launcher tests.",
         "tests/unit/multiprocess")
register("DS_TEST_CKPT_DIR", "optional_str", None,
         "Test-only: checkpoint directory handed to multi-process "
         "checkpoint tests.",
         "tests/unit/multiprocess")
