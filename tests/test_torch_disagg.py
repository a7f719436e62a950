"""The port's disaggregated prefill/decode serving against the JAX package's,
on the CPU.

- ``HandoffManager`` and ``PoolScheduler`` take the same calls on a fake
  clock in both packages: every return, ``stats()``, ``snapshot()`` and
  transition equal after each call.
- The two-stage router over the JAX test's uid-free ``FakeEngine``
  (``tests/unit/inference/serving/test_disagg.py``): the happy path, a
  request that fits in the prefill burst, ``DS_DISAGG`` winning in both
  directions, snapshot and events, a decode that diverges, a dropped
  handoff, a crash after publish, a torn record, a handoff past its
  deadline, the fallback kill switch, a saturated prefill pool and the
  hysteresis; each case through both packages, each handle's status,
  stream, error, ``replica_trail`` and ``attempts``, the router's
  counters, the pools' and handoffs' stats and every replica's health
  compared exactly. Each package's replicas validate an import with its
  own ``check_handoff_record``.
- Over real engines with the prefix cache and the KV tier in the pool
  dtype (the ``debug`` Llama, fp32, the JAX tree through
  ``params_from_jax``): in each package a prefill/decode pair streams
  what a unified two-replica fleet streams, which is the direct run's,
  every handoff acked; and the JAX test's chaos run on the port (a
  prefill replica dying after it publishes, a decode replica stalling,
  then the whole decode pool down and healed) loses nothing under
  ``DS_SANITIZE=1``, its streams the direct run's.
"""

import dataclasses
import itertools
import threading
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
from deepspeed_tpu.inference.v2.config_v2 import (KVTierConfig as JaxTier,
                                                  PrefixCacheConfig as JaxPrefix)
from deepspeed_tpu.models import build_llama
from deepspeed_tpu.serving import fleet as jfleet
from deepspeed_tpu.utils import sanitize as jsanitize
from deepspeed_tpu_torch import serving
from deepspeed_tpu_torch.inference.v2 import (DSStateManagerConfig, DynamicSplitFuseScheduler,
                                              InferenceEngineV2, KVTierConfig, PrefixCacheConfig,
                                              RaggedInferenceEngineConfig)
from deepspeed_tpu_torch.models import LlamaConfig, params_from_jax
from deepspeed_tpu_torch.serving import fleet as tfleet
from deepspeed_tpu_torch.utils import sanitize
from unit.inference.serving.test_admission import FakeEngine
from unit.inference.serving.test_disagg import BS, PROMPT, UidFreeEngine, valid_record

torch.set_num_threads(1)  # the suite runs in parallel worker processes

JAX = types.SimpleNamespace(serving=jserving, fleet=jfleet, sanitize=jsanitize, name="jax")
PORT = types.SimpleNamespace(serving=serving, fleet=tfleet, sanitize=sanitize, name="port")


# ---------------------------------------------------------------------- ledgers
def test_handoff_manager_lockstep():
    clock = [0.0]
    pair = [P.fleet.HandoffManager(deadline_s=2.0, now_fn=lambda: clock[0]) for P in (JAX, PORT)]
    steps = [("publish", 7, {"v": 1}, "p0"), ("record", 7), ("ack", 7), ("record", 7),
             ("publish", 1, {"v": 2}, "p1"), ("clock", 2.5), ("record", 1),
             ("publish", 3, {"v": 3}, "p0"), ("fail", 3, "record_rejected"), ("ack", 3),
             ("publish", 4, {"v": 4}, "p0"), ("clock", 4.0), ("record", 4), ("record", 4),
             ("ack", 4), ("fail", 9)]
    for step in steps:
        outs = []
        for hm in pair:
            if step[0] == "clock":
                clock[0] = step[1]
                outs.append(None)
            else:
                outs.append(getattr(hm, step[0])(*step[1:]))
        assert outs[0] == outs[1], step
        assert pair[1].stats() == pair[0].stats(), step
        assert pair[1].inflight() == pair[0].inflight()
    assert pair[1].stats() == dict(inflight=0, published=4, delivered=3, acked=2, failed=2,
                                   expired=1, deadline_s=2.0)


def test_pool_scheduler_lockstep():
    roles = {"p0": "prefill", "p1": "prefill", "d0": "decode", "u": "unified"}
    pair = [P.fleet.PoolScheduler(roles, fallback_after=2, recover_after=2, probe_every=3,
                                  now_fn=lambda: 0.0) for P in (JAX, PORT)]
    steps = [("decide",), ("note_failure", "handoff_dropped"), ("decide",),
             ("note_failure", "handoff_dropped")] + [("decide",)] * 6 + \
        [("note_success",), ("note_failure", "flap"), ("note_success",), ("decide",),
         ("note_success",), ("decide",), ("note_failure", "x"), ("note_failure", "y"),
         ("decide",), ("note_success",), ("note_success",), ("decide",)]
    for step in steps:
        outs = [getattr(ps, step[0])(*step[1:]) for ps in pair]
        assert outs[0] == outs[1], step
        for name in ("snapshot", "stats"):
            assert getattr(pair[1], name)() == getattr(pair[0], name)(), step
        assert pair[1].transitions == pair[0].transitions
    ps = pair[1]
    assert ps.stats()["degraded_entries"] == 2 and ps.stats()["degraded_exits"] == 2
    assert [ps.role_of(n) for n in ("p0", "d0", "zz")] == ["prefill", "decode", "unified"]
    assert sorted(ps.pool("prefill")) == sorted(pair[0].pool("prefill")) == ["p0", "p1"]


# ---------------------------------------------------------------------- two-stage routing
def disagg_engine(P, validate_import=True):
    """The JAX test's uid-free FakeEngine wearing the handoff surface; an
    import validates with ``P``'s own ``check_handoff_record``."""
    eng = UidFreeEngine()
    eng.export_prefix = lambda prompt, max_blocks=None: valid_record(prompt)
    if validate_import:
        def _imp(record):
            P.sanitize.check_handoff_record(record, block_size=BS, root_key=0)
            return len(record["entries"])
        eng.import_prefix = _imp
    else:
        eng.import_prefix = lambda record: len(record["entries"])
    return eng


def pool_replica(P, name, role, engine=None, auto_start=True, **scfg):
    scfg.setdefault("max_burst", 1)
    eng = engine or disagg_engine(P)
    return P.fleet.GatewayReplica(name, lambda: eng,
                                  serving_config=P.serving.ServingConfig(**scfg),
                                  auto_start=auto_start, role=role)


def disagg_router(P, replicas, now_fn=None, **cfg):
    cfg.setdefault("retry_backoff_s", 0.005)
    cfg.setdefault("disagg", True)
    return P.fleet.FleetRouter(replicas, config=P.fleet.FleetConfig(**cfg), now_fn=now_fn,
                               auto_heartbeat=False)


def handle_state(h):
    err = h.error
    return (h.status, list(h._collected), type(err).__name__ if err is not None else None,
            getattr(err, "reason", None), list(h.replica_trail), h.attempts)


def router_state(router):
    snap = router.snapshot()
    return {"counters": snap["counters"], "disagg": snap.get("disagg"),
            "health": {n: router.health[n].snapshot() for n in sorted(router.replicas)}}


def gateway_counters(rep, *names):
    counters = rep.gateway.metrics.snapshot()["counters"]
    return [counters[n] for n in names]


def case_happy_path(P, monkeypatch):
    p0, d0 = pool_replica(P, "p0", "prefill"), pool_replica(P, "d0", "decode")
    router = disagg_router(P, [p0, d0])
    h = router.submit(PROMPT, max_new_tokens=4)
    assert h.result(timeout=10) == UidFreeEngine.stream(len(PROMPT), 4)
    router.shutdown()
    assert h.replica_trail == ["p0", "d0"]
    return (handle_state(h), router_state(router), gateway_counters(p0, "handoffs_exported"),
            gateway_counters(d0, "handoffs_imported"))


def case_fits_in_prefill_burst(P, monkeypatch):
    router = disagg_router(P, [pool_replica(P, "p0", "prefill"),
                               pool_replica(P, "d0", "decode")])
    h = router.submit(PROMPT, max_new_tokens=1)
    assert h.result(timeout=10) == UidFreeEngine.stream(len(PROMPT), 1)
    router.shutdown()
    assert h.replica_trail == ["p0"]
    return handle_state(h), router_state(router)


def case_ds_disagg_wins_both_ways(P, monkeypatch):
    out = []
    for env, cfg in (("0", True), ("1", False)):
        monkeypatch.setenv("DS_DISAGG", env)
        router = disagg_router(P, [pool_replica(P, "p0", "prefill"),
                                   pool_replica(P, "d0", "decode")], disagg=cfg)
        out.append((router.pools is None, router.handoffs is None,
                    router.pools.roles if router.pools is not None else None))
        router.shutdown()
    assert [o[0] for o in out] == [True, False]
    return out


def case_snapshot_and_events(P, monkeypatch):
    router = disagg_router(P, [pool_replica(P, "p0", "prefill"),
                               pool_replica(P, "d0", "decode")])
    router.submit(PROMPT, max_new_tokens=3).result(timeout=10)
    router.shutdown()

    class Sink:
        def __init__(self):
            self.events = []

        def write_events(self, events):
            self.events.extend(events)

    sink = Sink()
    router.write_events(sink, step=5)
    tags = {t for t, _, _ in sink.events}
    assert {"Serve/Disagg/degraded", "Serve/Disagg/handoff_acked"} <= tags
    return router_state(router), sink.events


def case_divergent_decode(P, monkeypatch):
    p_eng = FakeEngine()  # uid-DEPENDENT tokens: divergence stand-in
    p_eng.export_prefix = lambda prompt, max_blocks=None: valid_record(prompt)
    d_eng = FakeEngine()
    d_eng.import_prefix = lambda record: len(record["entries"])
    p0 = pool_replica(P, "p0", "prefill", engine=p_eng)
    d0 = pool_replica(P, "d0", "decode", engine=d_eng)
    d0.gateway.submit(PROMPT, max_new_tokens=1).result(timeout=10)  # burn d0's uid 0
    router = disagg_router(P, [p0, d0])
    h = router.submit(PROMPT, max_new_tokens=4)
    with pytest.raises(P.fleet.ReplayDivergenceError):
        h.result(timeout=10)
    router.shutdown()
    assert h._collected == FakeEngine.expected_tokens(0, len(PROMPT), 1)
    return handle_state(h), router_state(router)


def case_dropped_handoff(P, monkeypatch):
    p0 = P.fleet.FaultyReplica(pool_replica(P, "p0", "prefill"), drop_handoff=True)
    router = disagg_router(P, [p0, pool_replica(P, "p1", "prefill"),
                               pool_replica(P, "d0", "decode")], disagg_fallback_after=10)
    handles = [router.submit(PROMPT, max_new_tokens=4) for _ in range(1)]
    handles[0].result(timeout=10)
    handles.append(router.submit(PROMPT, max_new_tokens=4))
    handles[1].result(timeout=10)
    states = [router_state(router)]
    handles.append(router.submit(PROMPT, max_new_tokens=4))  # p0 DEGRADED: p1 first now
    handles[2].result(timeout=10)
    router.shutdown()
    assert [h.replica_trail for h in handles] == [["p0", "p1", "d0"]] * 2 + [["p1", "d0"]]
    return [handle_state(h) for h in handles], states, router_state(router)


def case_crash_after_publish(P, monkeypatch):
    p0 = P.fleet.FaultyReplica(pool_replica(P, "p0", "prefill"), crash_after_publish=True)
    router = disagg_router(P, [p0, pool_replica(P, "d0", "decode")])
    h = router.submit(PROMPT, max_new_tokens=4)
    assert h.result(timeout=10) == UidFreeEngine.stream(len(PROMPT), 4)
    alive = p0.alive()
    router.tick()
    router.shutdown()
    return handle_state(h), alive, router_state(router)


def case_torn_record(P, monkeypatch):
    p0 = P.fleet.FaultyReplica(pool_replica(P, "p0", "prefill"), corrupt_handoff=True)
    router = disagg_router(P, [p0, pool_replica(P, "d0", "decode")], disagg_fallback_after=10)
    h = router.submit(PROMPT, max_new_tokens=4)
    assert h.result(timeout=10) == UidFreeEngine.stream(len(PROMPT), 4)
    router.shutdown()
    return handle_state(h), router_state(router)


def case_handoff_past_deadline(P, monkeypatch):
    ticks = itertools.count()  # a clock that advances 1 s a reading
    router = disagg_router(P, [pool_replica(P, "p0", "prefill"),
                               pool_replica(P, "d0", "decode")],
                           handoff_deadline_s=0.5, now_fn=lambda: float(next(ticks)))
    h = router.submit(PROMPT, max_new_tokens=4)
    assert h.result(timeout=10) == UidFreeEngine.stream(len(PROMPT), 4)
    router.shutdown()
    return handle_state(h), router_state(router)


def case_fallback_kill_switch(P, monkeypatch):
    monkeypatch.setenv("DS_DISAGG_FALLBACK", "0")
    p0 = P.fleet.FaultyReplica(pool_replica(P, "p0", "prefill"), drop_handoff=True)
    router = disagg_router(P, [p0, pool_replica(P, "d0", "decode")])
    h = router.submit(PROMPT, max_new_tokens=4)
    with pytest.raises(P.fleet.HandoffFailedError):
        h.result(timeout=10)
    router.shutdown()
    return handle_state(h), router_state(router)


def case_saturated_prefill_pool(P, monkeypatch):
    p0 = pool_replica(P, "p0", "prefill", auto_start=False, max_queue_depth=1)
    p0.gateway.submit(PROMPT, max_new_tokens=1)  # its queue is full now
    router = disagg_router(P, [p0, pool_replica(P, "d0", "decode")])
    h = router.submit(PROMPT, max_new_tokens=3)
    assert h.result(timeout=10) == UidFreeEngine.stream(len(PROMPT), 3)
    router.shutdown()
    return handle_state(h), router_state(router)


def case_hysteresis(P, monkeypatch):
    p0 = P.fleet.FaultyReplica(pool_replica(P, "p0", "prefill"), reject_next=100)
    router = disagg_router(P, [p0, pool_replica(P, "d0", "decode")], max_attempts=6,
                           disagg_fallback_after=2, disagg_recover_after=2,
                           disagg_probe_every=4)
    want = UidFreeEngine.stream(len(PROMPT), 3)
    seen = []
    for n in (2, 4, 8, 1):
        if n == 8:
            p0._reject_left = 0  # the prefill pool heals
        for _ in range(n):
            h = router.submit(PROMPT, max_new_tokens=3)
            assert h.result(timeout=10) == want
            seen.append(handle_state(h))
        seen.append(router.snapshot()["disagg"])
    router.shutdown()
    pools = router.snapshot()["disagg"]["pools"]
    assert pools["mode"] == "normal" and pools["degraded_exits"] == 1
    return seen, router_state(router)


ROUTER_CASES = {name[5:]: fn for name, fn in dict(globals()).items()
                if name.startswith("case_")}


@pytest.mark.parametrize("case", sorted(ROUTER_CASES))
def test_disagg_routing_lockstep(case, monkeypatch):
    out = {}
    for P in (JAX, PORT):
        with monkeypatch.context() as m:
            out[P.name] = ROUTER_CASES[case](P, m)
    assert out["port"] == out["jax"]


# ---------------------------------------------------------------------- real engines
@pytest.fixture(scope="module")
def debug():
    model = build_llama("debug", remat=False)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    params = jax.tree.map(np.asarray, params)
    return model, params, params_from_jax(params)


def tiered_factory(debug, name):
    """The JAX test's tiered engine (block 8, prefix cache, a 4 MB KV tier
    in the pool dtype), in package ``name``."""
    model, params, port_params = debug
    sm = dict(max_ragged_batch_size=96, max_ragged_sequence_count=16, max_tracked_sequences=16,
              max_context=32)
    if name == "jax":
        return lambda: JaxEngine(model=model, config=JaxCfg(
            kv_block_size=8, prefix_cache=JaxPrefix(enabled=True),
            kv_tier=JaxTier(enabled=True, host_bytes=1 << 22), state_manager=JaxSM(**sm)),
            params=params, dtype=jnp.float32)
    return lambda: InferenceEngineV2(
        LlamaConfig(**dataclasses.asdict(model.config)), RaggedInferenceEngineConfig(
            kv_block_size=8, prefix_cache=PrefixCacheConfig(enabled=True),
            kv_tier=KVTierConfig(enabled=True, host_bytes=1 << 22),
            state_manager=DSStateManagerConfig(**sm)),
        params=port_params, dtype=torch.float32, device="cpu")


@pytest.fixture(scope="module")
def reference(debug):
    """Prompts long enough to export a full KV block and the direct run's
    greedy streams, equal in both packages."""
    rng = np.random.RandomState(7)
    n = 6
    prompts = [rng.randint(0, 250, size=9 + i % 5).astype(np.int32) for i in range(n)]
    max_new = [2 + i % 3 for i in range(n)]
    want = {}
    for name, cls in (("jax", JaxSched), ("port", DynamicSplitFuseScheduler)):
        engine = tiered_factory(debug, name)()
        direct = cls(engine, token_budget=48, max_burst=4)
        for i in range(n):
            direct.add_request(i, prompts[i], max_new_tokens=max_new[i])
        out = direct.run_to_completion()
        want[name] = [list(out[i]) for i in range(n)]
        engine.destroy()
    assert want["port"] == want["jax"]
    return prompts, max_new, want["port"]


def consume_all(handles):
    streams, errors = {}, {}

    def client(i, h):
        try:
            streams[i] = [int(t) for t in h.tokens(timeout=120)]
        except Exception as e:  # noqa: BLE001 — asserted by the caller
            errors[i] = e

    threads = [threading.Thread(target=client, args=(i, h)) for i, h in enumerate(handles)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    assert not any(t.is_alive() for t in threads), "hung client stream"
    assert not errors, {i: str(e) for i, e in errors.items()}
    return [streams[i] for i in range(len(handles))]


def test_disagg_fleet_equals_unified_fleet_lockstep(debug, reference):
    """A prefill/decode pair exports real tier records and continues from
    them: every stream equals a unified two-replica fleet's (the direct
    run's), every handoff acked, in both packages, with equal counters."""
    prompts, max_new, want = reference
    out = {}
    for P in (JAX, PORT):
        factory = tiered_factory(debug, P.name)
        scfg = P.serving.ServingConfig(token_budget=48, max_burst=4)
        runs = []
        for roles in ((None, None), ("prefill", "decode")):
            reps = [P.fleet.GatewayReplica(n, factory, serving_config=scfg, role=r)
                    for n, r in zip(("a", "b"), roles)]
            router = P.fleet.FleetRouter(reps, config=P.fleet.FleetConfig(
                disagg=roles[0] is not None, retry_backoff_s=0.01),
                auto_heartbeat=False)
            streams = consume_all([router.submit(prompts[i], max_new_tokens=max_new[i])
                                   for i in range(len(prompts))])
            snap = router.snapshot()
            runs.append((streams, snap["counters"], snap.get("disagg"),
                         gateway_counters(reps[1], "handoffs_imported")))
            router.drain(timeout=60)
        assert runs[0][0] == runs[1][0] == want
        out[P.name] = runs
    assert out["port"] == out["jax"]
    _, counters, disagg, imported = out["port"][1]
    assert counters["disagg_completed"] == counters["completed"] == len(prompts)
    assert disagg["handoffs"]["acked"] == len(prompts) and disagg["handoffs"]["inflight"] == 0
    assert imported == [len(prompts)] and counters["failed"] == 0


def test_chaos_kill_prefill_stall_decode_saturate_recover(debug, reference, monkeypatch):
    """The JAX test's chaos run on the port, under ``DS_SANITIZE=1``: the
    first handoff kills its prefill replica after publish and a decode
    replica stalls mid-stream; then the decode pool dies (unified
    fallback, degraded) and heals (a probe recovers). Nothing is lost,
    every stream is the direct run's."""
    monkeypatch.setenv("DS_SANITIZE", "1")
    sanitize.reset_lock_graph()
    prompts, max_new, want = reference
    factory = tiered_factory(debug, "port")
    scfg = serving.ServingConfig(token_budget=48, max_burst=4)

    def rep(name, role):
        return tfleet.GatewayReplica(name, factory, serving_config=scfg, role=role)

    p0 = tfleet.FaultyReplica(rep("p0", "prefill"), crash_after_publish=True)
    d0 = tfleet.FaultyReplica(rep("d0", "decode"), hang_at_token=1)
    d1 = rep("d1", "decode")
    router = tfleet.FleetRouter([p0, rep("p1", "prefill"), d0, d1], config=tfleet.FleetConfig(
        disagg=True, retry_backoff_s=0.01, max_attempts=5, stream_token_timeout_s=9.0,
        disagg_fallback_after=2, disagg_recover_after=1, disagg_probe_every=2),
        auto_heartbeat=False)
    streams = consume_all([router.submit(prompts[i], max_new_tokens=max_new[i])
                           for i in range(len(prompts))])
    assert streams == want and not p0.alive()
    c = router.snapshot()["counters"]
    assert c["completed"] == len(prompts) and c["failed"] == 0
    d0.kill()
    d1.kill()
    for i in range(2):
        h = router.submit(prompts[i], max_new_tokens=max_new[i])
        assert [int(t) for t in h.tokens(timeout=120)] == want[i]
    assert router.snapshot()["disagg"]["pools"]["mode"] == "degraded"
    assert router.snapshot()["counters"]["unified_fallbacks"] >= 2
    d1.restart(timeout=60)
    for i in range(2):  # the first degraded request serves unified, the second probes
        h = router.submit(prompts[i], max_new_tokens=max_new[i])
        assert [int(t) for t in h.tokens(timeout=120)] == want[i]
    pools = router.snapshot()["disagg"]["pools"]
    assert pools["mode"] == "normal" and pools["degraded_entries"] >= 1
    assert pools["degraded_exits"] == pools["degraded_entries"]
    assert router.snapshot()["counters"]["failed"] == 0
    router.shutdown()
