"""The port's fleet refresh controller against the JAX package's, on the CPU.

- The cases of ``tests/unit/inference/serving/test_refresh.py::TestFleetRollout``
  side by side, over the JAX test's ``VersionedEngine`` (its token stream a
  function of the tokens ingested and the adopted weights): the happy
  path, a rollout from the publisher that pins the lineage (and a torn
  later publication refused with nothing adopted), a version lie that
  trips the canary and rolls back, a crash mid-swap that rolls the fleet
  back, a torn publication at a replica, a slow adopter demoted while the
  rollout continues, no replica adopting (typed), and the canary switches.
  Each case runs through both packages' controllers, routers and
  replicas: the reports (but ``wall_s``), the controllers' versions, every
  engine's adopted versions, the replicas' reported versions and health,
  the router's counters and the streams served after are compared exactly.
  Each package's publisher writes its own publication.
- Over real engines (the ``debug`` Llama, fp32, the JAX tree through
  ``params_from_jax``; v1 is chip_smoke.py's stand-in train step): two
  replicas in each package take a rollout to v1 while client threads
  stream, the canary a cold-started engine on v1. Nothing is lost, every
  stream is one version's direct stream (v0 or v1) and the fleet serves
  v1 after, and both packages' reports are equal but for ``wall_s``.
"""

import dataclasses
import os
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
from deepspeed_tpu.models import build_llama
from deepspeed_tpu.serving import fleet as jfleet
from deepspeed_tpu.serving import refresh as jrefresh
from deepspeed_tpu.utils import sanitize as jsanitize
from chip_smoke import REFRESH_STEP
from deepspeed_tpu_torch import serving
from deepspeed_tpu_torch.inference.v2 import (DSStateManagerConfig, DynamicSplitFuseScheduler,
                                              InferenceEngineV2, RaggedInferenceEngineConfig)
from deepspeed_tpu_torch.models import LlamaConfig, params_from_jax
from deepspeed_tpu_torch.serving import fleet as tfleet
from deepspeed_tpu_torch.serving import refresh as trefresh
from deepspeed_tpu_torch.utils import sanitize
from unit.inference.serving.test_refresh import (BS, PROMPT, VersionedEngine, cold_reference,
                                                 params_for, record_for)

torch.set_num_threads(1)  # the suite runs in parallel worker processes

JAX = types.SimpleNamespace(serving=jserving, fleet=jfleet, refresh=jrefresh,
                            sanitize=jsanitize, name="jax")
PORT = types.SimpleNamespace(serving=serving, fleet=tfleet, refresh=trefresh,
                             sanitize=sanitize, name="port")


# ---------------------------------------------------------------------- harness
def refresh_engine(P):
    """The JAX test's ``VersionedEngine`` with the version-tagged handoff
    surface, importing through ``P``'s own ``check_handoff_record``."""
    eng = VersionedEngine()
    eng.export_prefix = lambda prompt, max_blocks=None: record_for(prompt, eng.weight_version)

    def _imp(record):
        P.sanitize.check_handoff_record(record, block_size=BS, root_key=eng.weight_version)
        return len(record["entries"])
    eng.import_prefix = _imp
    return eng


def fleet(P, n=3, **cfg):
    """``n`` live-pump replicas, each a no-fault ``FaultyReplica`` (the
    cases arm its refresh faults), behind a router → (router, replicas,
    engines)."""
    reps, engines = [], []
    for i in range(n):
        eng = refresh_engine(P)
        engines.append(eng)
        rep = P.fleet.GatewayReplica(f"r{i}", (lambda e=eng: e),
                                     serving_config=P.serving.ServingConfig(max_burst=1),
                                     auto_start=True)
        reps.append(P.fleet.FaultyReplica(rep))
    cfg.setdefault("retry_backoff_s", 0.005)
    router = P.fleet.FleetRouter(reps, config=P.fleet.FleetConfig(**cfg), auto_heartbeat=False)
    return router, reps, engines


def controller(P, router, **kw):
    kw.setdefault("reference_fn", cold_reference)
    kw.setdefault("baseline_params", params_for(0))
    return P.refresh.FleetRefreshController(router, **kw)


def stream(router, n=3):
    return [int(t) for t in router.submit(PROMPT, max_new_tokens=n).tokens(timeout=5.0)]


def report_of(report):
    return {k: v for k, v in report.items() if k != "wall_s"}


def fleet_state(router, reps, engines, ctrl):
    snap = router.snapshot()
    return {"counters": snap["counters"],
            "health": {n: router.health[n].snapshot()["state"] for n in sorted(router.replicas)},
            "swaps": [list(e.swaps) for e in engines],
            "versions": [rep.weight_version() for rep in reps],
            "controller": (ctrl.current_version, ctrl.rollouts)}


def case_happy_path(P, tmp):
    router, reps, engines = fleet(P, 3)
    ctrl = controller(P, router)
    before = stream(router)
    report = ctrl.rollout(version=1, params=params_for(1))
    after = stream(router)
    with pytest.raises(P.refresh.WeightRefreshError, match="already"):
        ctrl.rollout(version=1, params=params_for(1))
    out = (before, report_of(report), after, fleet_state(router, reps, engines, ctrl))
    router.shutdown()
    assert report["refreshed"] == ["r0", "r1", "r2"] and report["canary"] == "passed"
    assert after == VersionedEngine.stream(len(PROMPT), 3, 1)
    return out


def case_publisher_pins_lineage(P, tmp):
    router, reps, engines = fleet(P, 2)
    pub = P.refresh.WeightPublisher(tmp, keep=4)
    ctrl = controller(P, router, publisher=pub)
    pub.publish(params_for(1))
    r1 = ctrl.rollout()  # the latest publication
    pinned = ctrl.current_chain == pub.manifest(1)["chain"]
    pub.publish(params_for(2))
    r2 = ctrl.rollout()
    pub.publish(params_for(3))
    with open(os.path.join(pub.dir, "v00000003", "payload.bin"), "r+b") as fd:
        fd.write(b"\xff")
    with pytest.raises(P.sanitize.WeightPublicationError) as err:
        ctrl.rollout()
    out = (report_of(r1), pinned, report_of(r2), type(err.value).__name__, stream(router),
           fleet_state(router, reps, engines, ctrl))
    router.shutdown()
    assert pinned and r2["canary"] == "passed" and [e.swaps for e in engines] == [[1, 2]] * 2
    return out


def case_version_lie(P, tmp):
    router, reps, engines = fleet(P, 3)
    ctrl = controller(P, router)
    reps[0].lie_version = True
    report = ctrl.rollout(version=1, params=params_for(1))
    out = (report_of(report), stream(router), fleet_state(router, reps, engines, ctrl))
    router.shutdown()
    assert report["canary"] == "diverged" and report["rolled_back_replicas"] == ["r0"]
    return out


def case_crash_mid_swap(P, tmp):
    router, reps, engines = fleet(P, 3)
    ctrl = controller(P, router)
    reps[1].crash_mid_swap = True
    report = ctrl.rollout(version=1, params=params_for(1))
    out = (report_of(report), stream(router), fleet_state(router, reps, engines, ctrl))
    router.shutdown()
    assert engines[0].swaps == [1, 0] and router.health["r1"].state == "down"
    return out


def case_torn_at_replica(P, tmp):
    router, reps, engines = fleet(P, 2)
    ctrl = controller(P, router)
    reps[1].refresh_torn = True
    report = ctrl.rollout(version=1, params=params_for(1))
    out = (report_of(report), fleet_state(router, reps, engines, ctrl))
    router.shutdown()
    assert report["rolled_back"] and engines[0].swaps == [1, 0] and engines[1].swaps == []
    return out


def case_slow_adopter_demoted(P, tmp):
    router, reps, engines = fleet(P, 3, refresh_canary=False, refresh_timeout_s=0.05,
                                  refresh_demote_after=2)
    ctrl = controller(P, router, reference_fn=None)
    reps[1].slow_adopt_s = 5.0
    report = ctrl.rollout(version=1, params=params_for(1))
    out = (report_of(report), fleet_state(router, reps, engines, ctrl))
    router.shutdown()
    assert report["refreshed"] == ["r0", "r2"] and report["demoted"] == ["r1"]
    return out


def case_no_replica_adopts(P, tmp):
    router, reps, engines = fleet(P, 2, refresh_canary=False, refresh_timeout_s=0.05,
                                  refresh_demote_after=1)
    ctrl = controller(P, router, reference_fn=None)
    for rep in reps:
        rep.slow_adopt_s = 5.0
    with pytest.raises(P.refresh.WeightRefreshError, match="no replica adopted") as err:
        ctrl.rollout(version=1, params=params_for(1))
    out = (err.value.reason, fleet_state(router, reps, engines, ctrl))
    router.shutdown()
    return out


def case_canary_switches(P, tmp, monkeypatch):
    router, reps, engines = fleet(P, 1)
    ctrl = P.refresh.FleetRefreshController(router, baseline_params=params_for(0))
    with pytest.raises(P.refresh.WeightRefreshError, match="reference_fn") as err:
        ctrl.rollout(version=1, params=params_for(1))
    refused = (err.value.reason, [list(e.swaps) for e in engines])
    monkeypatch.setenv("DS_REFRESH_CANARY", "0")
    report = ctrl.rollout(version=1, params=params_for(1))
    monkeypatch.setenv("DS_REFRESH_TIMEOUT_S", "7")
    out = (refused, report_of(report), ctrl._timeout(), fleet_state(router, reps, engines, ctrl))
    router.shutdown()
    assert refused[1] == [[]] and report["canary"] == "skipped" and out[2] == 7.0
    return out


CASES = {name[5:]: fn for name, fn in dict(globals()).items() if name.startswith("case_")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fleet_rollout_lockstep(case, tmp_path, monkeypatch):
    out = {}
    for P in (JAX, PORT):
        with monkeypatch.context() as m:
            args = (P, str(tmp_path / P.name)) + ((m,) if case == "canary_switches" else ())
            out[P.name] = CASES[case](*args)
    assert out["port"] == out["jax"]


def test_controller_errors_are_serving_errors():
    assert issubclass(trefresh.CanaryDivergenceError, trefresh.WeightRefreshError)
    assert issubclass(trefresh.WeightRefreshError, serving.ServingError)
    for name in ("WeightRefreshError", "CanaryDivergenceError"):
        t, j = getattr(trefresh, name), getattr(jrefresh, name)
        assert (t.reason, t.retry_elsewhere) == (j.reason, j.retry_elsewhere)


# ---------------------------------------------------------------------- real engines
SM = dict(max_ragged_batch_size=64, max_ragged_sequence_count=8, max_tracked_sequences=8,
          max_context=48)


@pytest.fixture(scope="module")
def trees():
    """The debug model, its v0 tree and v1 (the stand-in train step on its
    floating leaves), numpy and port."""
    model = build_llama("debug", remat=False)
    v0 = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0),
                                             jnp.zeros((1, 8), jnp.int32))["params"])
    rng = np.random.default_rng(1)
    v1 = jax.tree.map(lambda x: (x - np.float32(REFRESH_STEP) * x * rng.standard_normal(
        x.shape, np.float32)).astype(x.dtype) if np.issubdtype(x.dtype, np.floating) else x, v0)
    return model, {0: v0, 1: v1}, {0: params_from_jax(v0), 1: params_from_jax(v1)}


def make_engine(trees, name, params):
    model = trees[0]
    if name == "jax":
        return JaxEngine(model=model, config=JaxCfg(kv_block_size=BS, state_manager=JaxSM(**SM)),
                         params=params, dtype=jnp.float32)
    return InferenceEngineV2(LlamaConfig(**dataclasses.asdict(model.config)),
                             RaggedInferenceEngineConfig(
                                 kv_block_size=BS, state_manager=DSStateManagerConfig(**SM)),
                             params=params, dtype=torch.float32, device="cpu")


def cold_run(trees, name, params, prompts, max_new):
    """Greedy streams of a cold-started engine on ``params``."""
    engine = make_engine(trees, name, params)
    sched = (JaxSched if name == "jax" else DynamicSplitFuseScheduler)(
        engine, token_budget=48, max_burst=4)
    for i, p in enumerate(prompts):
        sched.add_request(i, np.asarray(p, np.int32), max_new_tokens=max_new)
    out = sched.run_to_completion()
    engine.destroy()
    return [[int(t) for t in out[i]] for i in range(len(prompts))]


def test_rollout_under_traffic_lockstep(trees):
    """A rollout v0 → v1 while client threads stream, on two replicas in
    each package, the canary a cold start on v1: nothing lost, every
    stream one version's direct stream, the fleet on v1 after, and equal
    reports but ``wall_s``."""
    _, jtrees, ttrees = trees
    rng = np.random.RandomState(5)
    prompts = [rng.randint(3, 250, size=6 + i % 5).astype(np.int32) for i in range(12)]
    NEW = 6
    direct = {v: cold_run(trees, "port", ttrees[v], prompts, NEW) for v in (0, 1)}
    assert direct == {v: cold_run(trees, "jax", jtrees[v], prompts, NEW) for v in (0, 1)}
    assert direct[0] != direct[1]
    out = {}
    for P, tr in ((JAX, jtrees), (PORT, ttrees)):
        def factory(P=P, tr=tr):
            return make_engine(trees, P.name, tr[0])
        scfg = P.serving.ServingConfig(token_budget=48, max_burst=4)
        reps = [P.fleet.GatewayReplica(n, factory, serving_config=scfg) for n in ("r0", "r1")]
        router = P.fleet.FleetRouter(reps, config=P.fleet.FleetConfig(
            retry_backoff_s=0.01, refresh_timeout_s=120, refresh_canary_max_new=NEW),
            auto_heartbeat=False)

        def reference_fn(params, prompt, max_new, P=P):
            return cold_run(trees, P.name, params, [prompt], max_new)[0]

        ctrl = P.refresh.FleetRefreshController(router, reference_fn=reference_fn,
                                                canary_prompts=[list(p) for p in prompts[:2]],
                                                baseline_params=tr[0])
        results, lost = {}, []
        started = threading.Barrier(5)

        def client(k):
            try:
                started.wait(timeout=60)
                for i in range(k, len(prompts), 4):
                    h = router.submit(prompts[i], max_new_tokens=NEW)
                    results[i] = [int(t) for t in h.tokens(timeout=120)]
            except Exception as e:  # noqa: BLE001 — the zero-lost audit
                lost.append(repr(e))

        threads = [threading.Thread(target=client, args=(k,)) for k in range(4)]
        for t in threads:
            t.start()
        started.wait(timeout=60)
        report = ctrl.rollout(version=1, params=tr[1])
        for t in threads:
            t.join(timeout=180)
        assert not any(t.is_alive() for t in threads) and not lost, lost
        assert sorted(results) == list(range(len(prompts)))
        for i, s in results.items():
            assert s in (direct[0][i], direct[1][i]), f"request {i} is of no one version"
        after = [[int(t) for t in rep.submit(prompts[0], max_new_tokens=NEW).tokens(timeout=60)]
                 for rep in reps]
        assert after == [direct[1][0]] * 2
        out[P.name] = (report_of(report), [rep.weight_version() for rep in reps],
                       router.snapshot()["counters"]["refreshes"], ctrl.current_version)
        router.drain(timeout=60)
    assert out["port"] == out["jax"]
    assert out["port"][0]["refreshed"] == ["r0", "r1"] and out["port"][0]["canary"] == "passed"
