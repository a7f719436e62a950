"""The port's in-process serving fleet against the JAX package's, on the CPU.

- State machines in lockstep: ``ReplicaHealth`` given the same calls on a
  fake clock in both packages, every snapshot, state, probe window and
  transition equal after each call; ``FleetConfig`` accepts and rejects
  the same dicts as the JAX model, and keeps an unknown key.
- The router over the JAX package's deterministic ``FakeEngine`` (the
  cases of ``tests/unit/inference/serving/test_fleet.py::TestRouterLogic``):
  each case runs through both packages' routers and replicas, and each
  handle's status, stream, error type and ``reason``, ``replica_trail``
  and ``attempts``, the router's counters and every replica's health are
  compared exactly (a case whose stream length follows a thread's timing
  compares what does not).
- Over real engines (the ``debug`` Llama, fp32, the JAX tree through
  ``params_from_jax``): a two-replica fleet in each package streams what
  the direct run streams; on the port, a crash mid-decode fails over bit
  for bit, a rolling restart loses nothing, prefix-aware placement routes
  to the warm replica, and sampled requests whose replica is killed after
  one token replay bit for bit the JAX fleet's uninterrupted streams (the
  seed derived from the router's uid), under ``DS_SANITIZE=1``. The JAX
  side of those cases is computed once: its direct run and its fleet.
"""

import dataclasses
import threading
import time
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu import serving as jserving
from deepspeed_tpu.inference.v2 import (DSStateManagerConfig as JaxSM,
                                        DynamicSplitFuseScheduler as JaxSched,
                                        InferenceEngineV2 as JaxEngine,
                                        RaggedInferenceEngineConfig as JaxCfg)
from deepspeed_tpu.inference.v2.config_v2 import PrefixCacheConfig as JaxPrefix
from deepspeed_tpu.models import build_llama
from deepspeed_tpu.serving import fleet as jfleet
from deepspeed_tpu_torch import serving
from deepspeed_tpu_torch.inference.v2 import (DSStateManagerConfig, DynamicSplitFuseScheduler,
                                              InferenceEngineV2, PrefixCacheConfig,
                                              RaggedInferenceEngineConfig)
from deepspeed_tpu_torch.models import LlamaConfig, params_from_jax
from deepspeed_tpu_torch.serving import fleet as tfleet
from deepspeed_tpu_torch.utils import sanitize
from unit.common.fault_injection import FaultInjector
from unit.inference.serving.test_admission import FakeEngine

torch.set_num_threads(1)  # the suite runs in parallel worker processes

JAX = types.SimpleNamespace(serving=jserving, fleet=jfleet, name="jax")
PORT = types.SimpleNamespace(serving=serving, fleet=tfleet, name="port")


# ---------------------------------------------------------------------- harness
def fake_replica(P, name, auto_start=True, engine=None, **serving_cfg):
    serving_cfg.setdefault("max_burst", 1)
    return P.fleet.GatewayReplica(name, lambda: engine or FakeEngine(),
                                  serving_config=P.serving.ServingConfig(**serving_cfg),
                                  auto_start=auto_start)


def make_router(P, replicas, auto_heartbeat=False, **cfg):
    cfg.setdefault("retry_backoff_s", 0.005)
    cfg.setdefault("heartbeat_interval_s", 0.05)
    return P.fleet.FleetRouter(replicas, config=P.fleet.FleetConfig(**cfg),
                               auto_heartbeat=auto_heartbeat)


def handle_state(h, stream=True):
    err = h.error
    return (h.status, list(h._collected) if stream else None,
            type(err).__name__ if err is not None else None, getattr(err, "reason", None),
            list(h.replica_trail), h.attempts)


def router_state(router):
    snap = router.snapshot()
    return {"counters": snap["counters"],
            "health": {n: router.health[n].snapshot() for n in sorted(router.replicas)}}


def health_trace(h):
    return [(a, b, why) for _, a, b, why in h.transitions]


# ---------------------------------------------------------------------- config
GOOD = [{}, {"max_attempts": 2}, {"degraded_after": 4, "down_after": 4},
        {"probe_backoff_s": 30.0}, {"retry_backoff_s": 0, "retry_jitter": 1.0},
        {"roles": {"p0": "prefill", "d0": "decode", "u": "unified"}, "disagg": True},
        {"max_attempts": "3", "heartbeat_interval_s": 1}, {"default_priority": -2},
        {"wire_timeout_s": 3}]
BAD = [{"degraded_after": 5, "down_after": 3}, {"probe_backoff_s": 60.0,
                                                "probe_backoff_max_s": 1.0},
       {"roles": {"r0": "router"}}, {"heartbeat_interval_s": 0}, {"degraded_after": 0},
       {"probe_backoff_mult": 0.5}, {"max_attempts": 0}, {"retry_backoff_s": -0.1},
       {"retry_jitter": 1.5}, {"retry_jitter": -0.1}, {"stream_token_timeout_s": 0},
       {"restart_drain_timeout_s": -1}, {"prefill_max_tokens": 0},
       {"handoff_deadline_s": 0}, {"disagg_fallback_after": 0}, {"disagg_recover_after": 0},
       {"disagg_probe_every": 0}, {"refresh_timeout_s": 0}, {"refresh_demote_after": 0},
       {"refresh_canary_max_new": 0}, {"default_max_new_tokens": 0}, {"max_attempts": 2.5},
       {"recovery_probes": 0}, {"retry_backoff_mult": 0.9}, {"retry_backoff_max_s": 0}]


@pytest.mark.parametrize("block", GOOD + BAD, ids=[f"good{i}" for i in range(len(GOOD))]
                         + [f"bad{i}" for i in range(len(BAD))])
def test_fleet_config_matches_jax(block):
    def build(P):
        try:
            return P.fleet.get_fleet_config({"fleet": dict(block)})
        except ValueError:  # pydantic's ValidationError is a ValueError
            return "rejected"
    j, t = build(JAX), build(PORT)
    if isinstance(j, str):
        assert isinstance(t, str), f"the port accepted {block}, JAX rejected it"
        assert block in BAD
        return
    assert not isinstance(t, str), t
    assert block in GOOD
    for f in dataclasses.fields(t):
        assert getattr(t, f.name) == getattr(j, f.name), f.name
    for key, value in block.items():  # an unknown key is kept, as pydantic's extra="allow"
        assert getattr(t, key) == getattr(j, key) == type(getattr(j, key))(value)


# ---------------------------------------------------------------------- health
def health_pair(**cfg):
    clock = [0.0]
    return clock, [P.fleet.ReplicaHealth(P.fleet.FleetConfig(**cfg), now_fn=lambda: clock[0],
                                         name="r") for P in (JAX, PORT)]


HEALTH_SCRIPTS = {
    "thresholds": (dict(degraded_after=2, down_after=4),
                   [("fail", "f1"), ("fail", "f2"), ("ok",), ("fail", "f0"), ("fail", "f1"),
                    ("fail", "f2"), ("fail", "f3"), ("ok",), ("probe", True)]),
    "fatal": ({}, [("fatal", "pump died"), ("fail", "more"), ("probe", True)]),
    "half_open": (dict(probe_backoff_s=0.25, probe_backoff_mult=2.0, probe_backoff_max_s=1.0,
                       recovery_probes=2),
                  [("fatal", "dead"), ("clock", 0.3), ("probe", False), ("clock", 0.7),
                   ("clock", 0.9), ("probe", True), ("probe", True), ("fail", "again"),
                   ("fatal", "again"), ("clock", 1.5), ("probe", False), ("clock", 2.0),
                   ("probe", False), ("clock", 3.1), ("probe", False), ("clock", 4.2),
                   ("probe", True), ("probe", True)]),
    "restart": (dict(down_after=2),
                [("restart",), ("fatal", "drain noise"), ("fail", "drain noise"),
                 ("end", True), ("restart",), ("end", False), ("clock", 0.3), ("probe", True),
                 ("probe", True), ("fail", "x"), ("fail", "y")]),
}


@pytest.mark.parametrize("script", sorted(HEALTH_SCRIPTS))
def test_replica_health_lockstep(script):
    cfg, steps = HEALTH_SCRIPTS[script]
    clock, pair = health_pair(**cfg)
    for step in steps:
        outs = []
        for h in pair:
            if step[0] == "clock":
                clock[0] = step[1]
                outs.append(None)
            elif step[0] == "fail":
                outs.append(h.record_failure(step[1]))
            elif step[0] == "fatal":
                outs.append(h.record_failure(step[1], fatal=True))
            elif step[0] == "ok":
                outs.append(h.record_success())
            elif step[0] == "probe":
                outs.append((h.probe_due(), h.record_probe(step[1])))
            elif step[0] == "restart":
                outs.append(h.begin_restart())
            else:
                outs.append(h.end_restart(step[1]))
        j, t = pair
        assert outs[0] == outs[1], step
        assert t.snapshot() == j.snapshot(), step
        assert (t.state, t.routable, t.probe_due()) == (j.state, j.routable, j.probe_due())
        assert t.transitions == j.transitions
    assert pair[1].transitions  # each script moves the state


# ---------------------------------------------------------------------- router logic
def case_reject_burst(P, monkeypatch):
    r0 = P.fleet.FaultyReplica(fake_replica(P, "r0"), reject_next=3)
    router = make_router(P, [r0, fake_replica(P, "r1")])
    h = router.submit([10, 11, 12], max_new_tokens=3)
    got = h.result(timeout=10)
    router.shutdown()
    assert got == FakeEngine.expected_tokens(0, 3, 3)
    return handle_state(h), router_state(router)


def case_hang_detection(P, monkeypatch):
    r0 = P.fleet.FaultyReplica(fake_replica(P, "r0"), hang_at_token=1)
    router = make_router(P, [r0, fake_replica(P, "r1")], stream_token_timeout_s=0.15)
    h = router.submit([5, 6, 7, 8], max_new_tokens=4)
    got = h.result(timeout=30)
    router.shutdown()
    assert got == FakeEngine.expected_tokens(0, 4, 4) and h.replica_trail == ["r0", "r1"]
    return handle_state(h), router_state(router)


def case_crash_no_survivor(P, monkeypatch):
    r0 = P.fleet.FaultyReplica(fake_replica(P, "r0"), crash_at_token=0)
    router = make_router(P, [r0])
    t0 = time.monotonic()
    h = router.submit([1, 2, 3], max_new_tokens=4, deadline_ms=5000)
    with pytest.raises(P.fleet.NoReplicaAvailableError):
        h.result(timeout=10)
    assert time.monotonic() - t0 < 5.0
    router.shutdown()
    return handle_state(h), router_state(router)


def case_replay_divergence(P, monkeypatch):
    r0 = P.fleet.FaultyReplica(fake_replica(P, "r0"), crash_at_token=2)
    r1 = fake_replica(P, "r1")
    r1.gateway.submit([9, 9], max_new_tokens=1).result(timeout=10)  # burn r1's uid 0
    router = make_router(P, [r0, r1])
    h = router.submit([1, 2, 3], max_new_tokens=4)
    with pytest.raises(P.fleet.ReplayDivergenceError):
        h.result(timeout=10)
    router.shutdown()
    assert h._collected == FakeEngine.expected_tokens(0, 3, 2)
    return handle_state(h), router_state(router)


def case_failover_kill_switch(P, monkeypatch):
    monkeypatch.setenv("DS_FLEET_FAILOVER", "0")
    r0 = P.fleet.FaultyReplica(fake_replica(P, "r0"), crash_at_token=0)
    router = make_router(P, [r0, fake_replica(P, "r1")])
    h = router.submit([1, 2, 3], max_new_tokens=2)
    with pytest.raises(P.fleet.ReplicaDiedError):
        h.result(timeout=10)
    router.shutdown()
    return handle_state(h), router_state(router)


def case_fault_hook(P, monkeypatch):
    inj = FaultInjector(kill_at="token", kill_detail=1)
    r0 = P.fleet.FaultyReplica(fake_replica(P, "r0"), hook=inj)
    router = make_router(P, [r0, fake_replica(P, "r1")])
    h = router.submit([4, 5, 6], max_new_tokens=3)
    assert h.result(timeout=10) == FakeEngine.expected_tokens(0, 3, 3)
    router.shutdown()
    return handle_state(h), router_state(router), inj.killed, inj.trace


def case_heartbeat_half_open(P, monkeypatch):
    clock = [0.0]
    r0, r1 = fake_replica(P, "r0"), fake_replica(P, "r1")
    router = P.fleet.FleetRouter(
        [r0, r1], config=P.fleet.FleetConfig(probe_backoff_s=0.25, recovery_probes=2),
        now_fn=lambda: clock[0], auto_heartbeat=False)
    seen = []
    r0.kill()
    router.tick()
    seen.append(router_state(router))
    h = router.submit([7, 8], max_new_tokens=2)
    assert h.result(timeout=10) == FakeEngine.expected_tokens(0, 2, 2)
    r0.restart(timeout=5)
    for t in (0.0, 0.3, 0.3):
        clock[0] = t
        router.tick()
        seen.append(router_state(router))
    router.shutdown()
    return handle_state(h), seen, health_trace(router.health["r0"])


def case_prefix_placement(P, monkeypatch):
    out = []
    for switch in (None, "0"):
        if switch is not None:
            monkeypatch.setenv("DS_FLEET_PREFIX_ROUTING", switch)
        warm = FakeEngine()
        warm.prefix_match_len = lambda toks: 8  # pretends to cache a block
        router = make_router(P, [fake_replica(P, "r0"), fake_replica(P, "r1", engine=warm)])
        h = router.submit(list(range(12)), max_new_tokens=2)
        h.result(timeout=10)
        router.shutdown()
        out.append((handle_state(h), router_state(router)))
    assert out[0][0][4] == ["r1"] and out[1][0][4] == ["r0"]
    return out


def case_cancel_mid_stream(P, monkeypatch):
    r0 = P.fleet.FaultyReplica(fake_replica(P, "r0"), slow_token_s=0.02)
    router = make_router(P, [r0])
    h = router.submit([1, 2, 3], max_new_tokens=32)
    while not h._collected and not h.done:
        time.sleep(0.005)
    h.cancel()
    with pytest.raises(P.serving.RequestCancelledError):
        h.result(timeout=10)
    router.shutdown()
    c = router.snapshot()["counters"]
    # the tokens streamed before the cancel follow the relay thread's timing
    assert h._collected == FakeEngine.expected_tokens(0, 3, len(h._collected))
    return handle_state(h, stream=False), {k: c[k] for k in c if k != "tokens_relayed"}


def case_drain(P, monkeypatch):
    router = make_router(P, [fake_replica(P, "r0")])
    h = router.submit([1, 2], max_new_tokens=2)
    h.result(timeout=10)
    router.drain(timeout=30)
    with pytest.raises(P.serving.GatewayClosedError) as err:
        router.submit([3, 4])
    return (handle_state(h), router_state(router), err.value.reason,
            router.replicas["r0"].gateway.state)


def case_background_heartbeat(P, monkeypatch):
    r0, r1 = fake_replica(P, "r0"), fake_replica(P, "r1")
    router = make_router(P, [r0, r1], auto_heartbeat=True, heartbeat_interval_s=0.02)
    r0.kill()
    deadline = time.monotonic() + 5
    while router.health["r0"].state != "down" and time.monotonic() < deadline:
        time.sleep(0.01)
    router.shutdown()
    # the probes after DOWN follow the heartbeat thread's timing
    return (router.health["r0"].state, router.health["r1"].state,
            health_trace(router.health["r0"])[:1], router._hb_thread is None)


ROUTER_CASES = {name[5:]: fn for name, fn in dict(globals()).items()
                if name.startswith("case_")}


@pytest.mark.parametrize("case", sorted(ROUTER_CASES))
def test_router_logic_lockstep(case, monkeypatch):
    """One ``TestRouterLogic`` case through both packages: equal
    observations (handles, counters, health)."""
    out = {}
    for P in (JAX, PORT):
        with monkeypatch.context() as m:
            out[P.name] = ROUTER_CASES[case](P, m)
    assert out["port"] == out["jax"]


def test_fleet_handle_is_a_request_handle():
    h = tfleet.FleetHandle(3, [1, 2], 4, 0, None)
    assert isinstance(h, serving.RequestHandle)
    assert (h.replica_trail, h.attempts, h._cancelled, h._inner) == ([], 0, False, None)
    with pytest.raises(ValueError, match="at least one replica"):
        tfleet.FleetRouter([])
    with pytest.raises(ValueError, match="duplicate replica name"):
        tfleet.FleetRouter([fake_replica(PORT, "r0", auto_start=False),
                            fake_replica(PORT, "r0", auto_start=False)],
                           auto_heartbeat=False)


# ---------------------------------------------------------------------- real engines
EOS = 2
SCHEMA = {"type": "object",
          "properties": {"ok": {"type": "boolean"}, "mode": {"enum": ["fast", "safe"]}},
          "required": ["ok", "mode"]}


@pytest.fixture(scope="module")
def debug():
    model = build_llama("debug", remat=False)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    params = jax.tree.map(np.asarray, params)
    return model, params, params_from_jax(params)


def factories(debug, prefix_cache=False, structured=False, max_context=32):
    """→ {package name: engine factory}: the same config and weights."""
    model, params, port_params = debug
    sm = dict(max_ragged_batch_size=96, max_ragged_sequence_count=16, max_tracked_sequences=16,
              max_context=max_context)

    def jax_engine():
        return JaxEngine(model=model, config=JaxCfg(
            kv_block_size=8, state_manager=JaxSM(**sm),
            prefix_cache=JaxPrefix(enabled=prefix_cache), structured={"enabled": structured}),
            params=params, dtype=jnp.float32)

    def port_engine():
        return InferenceEngineV2(LlamaConfig(**dataclasses.asdict(model.config)),
                                 RaggedInferenceEngineConfig(
                                     kv_block_size=8, state_manager=DSStateManagerConfig(**sm),
                                     prefix_cache=PrefixCacheConfig(enabled=prefix_cache),
                                     structured={"enabled": structured}),
                                 params=port_params, dtype=torch.float32, device="cpu")
    return {"jax": jax_engine, "port": port_engine}


@pytest.fixture(scope="module")
def reference(debug):
    """Prompts and the direct scheduler run's greedy streams, equal in
    both packages: the yardstick of every fleet below."""
    rng = np.random.RandomState(0)
    n = 10
    prompts = [rng.randint(0, 250, size=5 + i % 6).astype(np.int32) for i in range(n)]
    max_new = [2 + i % 3 for i in range(n)]
    want = {}
    for name, make in factories(debug).items():
        engine = make()
        cls = JaxSched if name == "jax" else DynamicSplitFuseScheduler
        direct = cls(engine, token_budget=48, max_burst=4)
        for i in range(n):
            direct.add_request(i, prompts[i], max_new_tokens=max_new[i])
        out = direct.run_to_completion()
        want[name] = [list(out[i]) for i in range(n)]
        engine.destroy()
    assert want["port"] == want["jax"]
    return prompts, max_new, want["port"]


def real_replicas(P, factory, names=("r0", "r1"), **serving_cfg):
    scfg = P.serving.ServingConfig(token_budget=48, max_burst=4, **serving_cfg)
    return [P.fleet.GatewayReplica(name, factory, serving_config=scfg) for name in names]


def consume_all(handles):
    """Stream every handle from its own client thread → ({i: tokens},
    {i: error}), asserting no client hangs."""
    streams, errors = {}, {}

    def client(i, h):
        try:
            streams[i] = [int(t) for t in h.tokens(timeout=120)]
        except Exception as e:  # noqa: BLE001 — compared by the caller
            errors[i] = e

    threads = [threading.Thread(target=client, args=(i, h)) for i, h in enumerate(handles)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    assert not any(t.is_alive() for t in threads), "hung client stream"
    return streams, errors


def fleet_run(P, reps, prompts, max_new, **cfg):
    """Submit the traffic to a router over ``reps`` and stream it → (the
    router, streams in order, {i: error})."""
    cfg.setdefault("retry_backoff_s", 0.01)
    router = P.fleet.FleetRouter(reps, config=P.fleet.FleetConfig(**cfg), auto_heartbeat=False)
    handles = [router.submit(prompts[i], max_new_tokens=max_new[i]) for i in range(len(prompts))]
    streams, errors = consume_all(handles)
    assert not errors, {i: str(e) for i, e in errors.items()}
    assert all(h.status == "completed" for h in handles)
    return router, [streams[i] for i in range(len(prompts))]


def test_fleet_streams_equal_direct_run_lockstep(debug, reference):
    """Two healthy replicas in each package: every stream equals the
    direct run's, the counters are equal, and a drained router refuses."""
    prompts, max_new, want = reference
    out = {}
    for P in (JAX, PORT):
        make = factories(debug)[P.name]
        router, streams = fleet_run(P, real_replicas(P, make), prompts, max_new)
        assert streams == want
        router.drain(timeout=60)
        with pytest.raises(P.serving.GatewayClosedError):
            router.submit(prompts[0])
        out[P.name] = router.snapshot()["counters"]
    assert out["port"] == out["jax"]
    c = out["port"]
    assert c["completed"] == len(prompts) and c["failed"] == c["retries"] == 0
    assert c["tokens_relayed"] == sum(max_new)


def test_crash_mid_decode_fails_over_bit_for_bit(debug, reference):
    """A replica killed at its first streamed token: every request ends on
    the survivor with the direct run's stream, in both packages; the dead
    replica is DOWN."""
    prompts, max_new, want = reference
    out = {}
    for P in (JAX, PORT):
        r0, r1 = real_replicas(P, factories(debug)[P.name])
        faulty = P.fleet.FaultyReplica(r0, crash_at_token=1)
        router, streams = fleet_run(P, [faulty, r1], prompts, max_new)
        assert streams == want
        c = router.snapshot()["counters"]
        assert c["failovers"] >= 1 and c["completed"] == len(prompts) and c["failed"] == 0
        out[P.name] = (router.health["r0"].state, router.health["r1"].state, faulty.alive())
        router.shutdown()
    assert out["port"] == out["jax"] == ("down", "healthy", False)


def test_rolling_restart_loses_zero_requests(debug, reference):
    """r0 restarts while traffic flows: its queued work is shed to r1 and
    replayed, its streams drain, it is rebuilt from its factory and comes
    back HEALTHY; every stream equals the direct run's."""
    prompts, max_new, want = reference
    out = {}
    for P in (JAX, PORT):
        reps = real_replicas(P, factories(debug)[P.name])
        router = P.fleet.FleetRouter(reps, config=P.fleet.FleetConfig(
            retry_backoff_s=0.01, restart_drain_timeout_s=60), auto_heartbeat=False)
        handles = {}

        def traffic():
            for i in range(len(prompts)):
                handles[i] = router.submit(prompts[i], max_new_tokens=max_new[i])
                time.sleep(0.01)

        feeder = threading.Thread(target=traffic)
        feeder.start()
        time.sleep(0.03)
        ok = router.restart_replica("r0", timeout=60)
        feeder.join(timeout=60)
        streams, errors = consume_all([handles[i] for i in sorted(handles)])
        assert not errors, {i: str(e) for i, e in errors.items()}
        assert [streams[i] for i in range(len(prompts))] == want
        c = router.snapshot()["counters"]
        out[P.name] = (ok, router.health["r0"].state, reps[0].restarts, c["completed"],
                       c["restarts"], c["failed"])
        router.drain(timeout=60)
    assert out["port"] == out["jax"] == (True, "healthy", 1, len(prompts), 1, 0)


def test_prefix_aware_placement_routes_to_warm_replica(debug):
    """With the prefix cache on, the router sends a prompt to the replica
    whose trie holds its prefix."""
    prompt = np.arange(1, 18, dtype=np.int32)  # 17 tokens = 2 full blocks
    out = {}
    for P in (JAX, PORT):
        r0, r1 = real_replicas(P, factories(debug, prefix_cache=True)[P.name])
        router = P.fleet.FleetRouter([r0, r1], auto_heartbeat=False)
        first = r1.gateway.submit(prompt, max_new_tokens=2).result(timeout=60)
        matches = (r0.prefix_match_len(prompt), r1.prefix_match_len(prompt))
        h = router.submit(prompt, max_new_tokens=2)
        got = h.result(timeout=60)
        out[P.name] = (first, matches, got, handle_state(h),
                       router.snapshot()["counters"]["prefix_routed"])
        router.drain(timeout=60)
    assert out["port"] == out["jax"]
    _, (m0, m1), _, state, routed = out["port"]
    assert m1 >= 8 > m0 and state[4] == ["r1"] and routed == 1


def test_sampled_stream_killed_mid_generation_replays_bit_for_bit(debug, monkeypatch):
    """Sampled and schema-constrained requests through a port fleet whose
    first replica dies after one token: every stream completes on the
    survivor equal to the JAX fleet's uninterrupted run (each seed derived
    from the router's uid, so a replay re-draws the same counter-keyed
    stream), the constrained lanes valid JSON. The port runs under
    ``DS_SANITIZE=1``: relay threads, pumps and the named locks
    order-tracked."""
    import json

    from deepspeed_tpu_torch.inference.structured.grammar import byte_vocab, detokenize
    model = debug[0]
    vocab = byte_vocab(model.config.vocab_size)
    make = factories(debug, structured=True, max_context=64)
    rng = np.random.RandomState(3)
    prompts = [rng.randint(3, 250, size=5 + i % 4).astype(np.int32) for i in range(6)]

    def drive(router):
        handles = []
        for i, p in enumerate(prompts):
            kw = {"sample": {"temperature": 1.2, "top_k": 24}}
            if i % 3 == 2:
                kw.update(schema=SCHEMA, max_new_tokens=48)
            else:
                kw["max_new_tokens"] = 4 + i % 3
            handles.append(router.submit(p, **kw))
        streams, errors = consume_all(handles)
        assert not errors, {i: str(e) for i, e in errors.items()}
        return [streams[i] for i in range(len(prompts))], handles

    # the JAX fleet's no-fault run: one replica, the same router uids
    ref = JAX.fleet.FleetRouter(
        [JAX.fleet.GatewayReplica("ref", make["jax"], serving_config=JAX.serving.ServingConfig(
            token_budget=48, max_burst=4, eos_token_id=EOS, token_strings=vocab))],
        config=JAX.fleet.FleetConfig(retry_backoff_s=0.01), auto_heartbeat=False)
    want, jhandles = drive(ref)
    ref.shutdown()

    monkeypatch.setenv("DS_SANITIZE", "1")
    sanitize.reset_lock_graph()
    scfg = dict(eos_token_id=EOS, token_strings=vocab)
    r0, r1 = real_replicas(PORT, make["port"], **scfg)
    faulty = tfleet.FaultyReplica(r0, crash_at_token=1)
    router = tfleet.FleetRouter([faulty, r1], config=tfleet.FleetConfig(
        retry_backoff_s=0.01, stream_token_timeout_s=9.0), auto_heartbeat=False)
    got, handles = drive(router)
    assert got == want
    assert [h.sample["seed"] for h in handles] == [h.sample["seed"] for h in jhandles]
    for i in range(2, len(prompts), 3):
        assert got[i][-1] == EOS
        doc = json.loads(detokenize(got[i][:-1], vocab))
        assert isinstance(doc["ok"], bool) and doc["mode"] in ("fast", "safe")
    assert router.health["r0"].state == "down"
    c = router.snapshot()["counters"]
    assert c["completed"] == len(prompts) and c["failovers"] >= 1 and c["failed"] == 0
    router.shutdown()
