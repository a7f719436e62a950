"""The port's ``ServingGateway`` against the JAX package's, on the CPU.

Both gateways run in manual-pump mode (``auto_start=False``) and take the
same calls in the same order; after every pump (or call) their handles'
statuses, streams and terminal error types, their counters (the JAX
table's), ``inflight()``, state and committed KV blocks must be equal.

- Over the JAX package's deterministic ``FakeEngine``: the three
  admission policies (reject, shed, block: its timeout and its unblock on
  admission), deadlines in the queue and mid-generation, cancels queued
  and running, drain/shutdown/kill/``shed_queued`` with live streams,
  ``inflight`` by stage, a pump crash failing every handle typed (the
  pump thread), the error taxonomy matrix and the queue-full hints.
- Over the real engines (the JAX tree through ``params_from_jax``, fp32):
  streams equal to ``DynamicSplitFuseScheduler`` driving the same engine
  (the port's gateway also under client threads and its own pump thread),
  over-capacity rejections, a cancel mid-decode freeing its KV blocks,
  priority preemption through ``suspend``/``resume``, sampled submits
  (the seed resolved from the uid) and constrained ones (a
  ``CompiledSchema``), and unknown adapters rejected at the door.
- Config validation: every bound and cross-field check of the JAX models
  accepts and rejects the same values. Two JAX-side defects show here
  (ROADMAP.md queue 3): the JAX gateway counts ``rejected_bad_sample``
  and ``rejected_schema``, which its metrics table lacks, so a bad
  sampling spec or a schema on a replica without constrained decoding
  raises ``KeyError`` there; the port raises the typed ``ValueError`` and
  counts it. The port's tests assert both behaviours side by side, and
  the lockstep compares every counter but these two, which the port's
  table alone holds.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.inference.structured import grammar as jgrammar
from deepspeed_tpu.inference.v2 import (DSStateManagerConfig as JaxSM,
                                        DynamicSplitFuseScheduler as JaxSched,
                                        InferenceEngineV2 as JaxEngine,
                                        RaggedInferenceEngineConfig as JaxCfg)
from deepspeed_tpu.inference.v2.config_v2 import (LoRAServingConfig as JaxLoRA,
                                                  StructuredConfig as JaxStructured)
from deepspeed_tpu.models import build_llama
from deepspeed_tpu import serving as jserving
from deepspeed_tpu.serving.fleet import ReplicaDiedError as JaxReplicaDiedError
from deepspeed_tpu_torch import serving
from deepspeed_tpu_torch.inference.structured.grammar import CompiledSchema, byte_vocab
from deepspeed_tpu_torch.inference.v2 import (DSStateManagerConfig, DynamicSplitFuseScheduler,
                                              InferenceEngineV2, LoRAServingConfig,
                                              RaggedInferenceEngineConfig, StructuredConfig)
from deepspeed_tpu_torch.models import LlamaConfig, params_from_jax
from deepspeed_tpu_torch.serving.fleet import ReplicaDiedError
from deepspeed_tpu_torch.serving.lora import UnknownAdapterError
from unit.inference.serving.test_admission import FakeEngine

torch.set_num_threads(1)  # the suite runs in parallel worker processes

ERRORS = ("GatewayClosedError", "QueueFullError", "RequestTooLargeError", "RequestShedError",
          "RequestCancelledError", "DeadlineExceededError", "GatewayFailedError")
EOS = 2
SCHEMA = {"type": "object", "properties": {"ok": {"type": "boolean"}}, "required": ["ok"]}


# ---------------------------------------------------------------------- lockstep harness
class Pair:
    """A JAX and a port gateway over their own engines, driven alike."""

    def __init__(self, engines, **cfg):
        cfg.setdefault("max_burst", 1)
        self.j = jserving.ServingGateway(engines[0], config=jserving.ServingConfig(**cfg),
                                         auto_start=False)
        self.t = serving.ServingGateway(engines[1], config=serving.ServingConfig(**cfg),
                                        auto_start=False)
        self.handles = []

    def submit(self, *args, **kwargs):
        """The same submit on both → (JAX handle, port handle), or the two
        exceptions' class names (equal) raised."""
        out = []
        for gw in (self.j, self.t):
            try:
                out.append(gw.submit(*args, **kwargs))
            except Exception as e:  # noqa: BLE001 — compared by type below
                out.append(e)
        if isinstance(out[0], Exception) or isinstance(out[1], Exception):
            assert type(out[0]).__name__ == type(out[1]).__name__, out
            assert getattr(out[0], "reason", None) == getattr(out[1], "reason", None)
            return out
        self.handles.append(tuple(out))
        return tuple(out)

    def call(self, name, *args):
        return [getattr(gw, name)(*args) for gw in (self.j, self.t)]

    def pump(self, n=1):
        for _ in range(n):
            assert self.t._pump_once() == self.j._pump_once()
            self.check()

    def pump_until(self, cond, n=400):
        for _ in range(n):
            if cond(self.t):
                return
            self.pump()
        raise AssertionError(f"condition not reached in {n} pumps")

    def check(self):
        assert state(self.t, [h for _, h in self.handles]) == \
            state(self.j, [h for h, _ in self.handles])


# the counters the port counts where the JAX gateway raises KeyError
PORT_ONLY_COUNTERS = {"rejected_bad_sample", "rejected_schema"}


def state(gw, handles):
    counters = gw.snapshot()["counters"]
    assert set(counters) - set(jserving.ServingMetrics.COUNTERS) <= PORT_ONLY_COUNTERS
    counters = {k: v for k, v in counters.items() if k in jserving.ServingMetrics.COUNTERS}
    return ([(h.uid, h.status, list(h._collected), type(h.error).__name__ if h.error else None)
             for h in handles], counters, gw.inflight(), gw.state, gw.gate.committed_blocks,
            gw.gate.active)


def fakes(**kw):
    return FakeEngine(**kw), FakeEngine(**kw)


# ---------------------------------------------------------------------- admission policies
def test_reject_policy_queue_full_lockstep():
    p = Pair(fakes(), max_queue_depth=2)
    p.submit([1, 2])
    p.submit([3, 4])
    errs = p.submit([5, 6])
    assert type(errs[1]).__name__ == "QueueFullError"
    assert errs[1].details == errs[0].details  # depth, policy, pool, hints
    p.check()
    p.pump_until(lambda gw: gw.snapshot()["counters"]["completed"] == 2)
    p.submit([1, 2])
    p.submit([3, 4])
    errs = p.submit([5, 6])
    assert set(errs[1].details) == set(errs[0].details)
    assert errs[1].details["est_wait_s"] >= 0.0 and errs[0].details["est_wait_s"] >= 0.0


def test_shed_policy_lockstep():
    p = Pair(fakes(), max_queue_depth=2, admission_policy="shed")
    p.submit([1, 2], priority=0)
    p.submit([3, 4], priority=0)
    p.submit([5, 6], priority=5)  # sheds the youngest priority-0 request
    p.check()
    assert p.handles[1][1].status == "shed"
    assert p.submit([7, 8], priority=0)[1].reason == "queue_full"
    p.pump_until(lambda gw: sum(gw.inflight().values()) == 0)


def test_block_policy_times_out_and_unblocks_lockstep():
    p = Pair(fakes(), max_queue_depth=1, admission_policy="block", block_timeout_s=0.05)
    p.submit([1, 2])
    errs = p.submit([3, 4])
    assert errs[1].details == errs[0].details == {"queue_depth": 1, "policy": "block",
                                                  "pool": "unified", "evictable_blocks": 0,
                                                  "active": 0, "est_wait_s": None}
    p = Pair(fakes(), max_queue_depth=1, admission_policy="block", block_timeout_s=10.0)
    p.submit([1, 2], max_new_tokens=2)
    late = {}

    def client(i, gw):
        late[i] = gw.submit([3, 4], max_new_tokens=2)

    threads = [threading.Thread(target=client, args=(i, gw)) for i, gw in enumerate((p.j, p.t))]
    for t in threads:
        t.start()
    time.sleep(0.05)
    assert all(t.is_alive() for t in threads)  # both parked on the full queue
    p.pump()  # admitting the first request makes room in both
    for t in threads:
        t.join(timeout=5)
    p.handles.append((late[0], late[1]))
    p.pump_until(lambda gw: sum(gw.inflight().values()) == 0)
    assert [h.status for h in p.handles[-1]] == ["completed", "completed"]


def test_deadlines_lockstep():
    p = Pair(fakes())
    p.submit([1, 2], deadline_ms=10)
    p.submit([3, 4], max_new_tokens=20)
    time.sleep(0.03)
    p.pump()  # deadlines run before admission: the first expires queued
    assert p.handles[0][1].status == "deadline"
    p.pump_until(lambda gw: len(gw._active) == 1 and len(p.handles[1][1]._collected) >= 3)
    for h in p.handles[1]:  # expire the running one between pumps, at the same token
        h.deadline = time.monotonic() - 1.0
    p.pump()
    assert p.handles[1][1].status == "deadline" and p.t.gate.committed_blocks == 0
    assert p.t.snapshot()["counters"]["deadline_expired"] == 2


def test_cancel_queued_and_running_lockstep():
    p = Pair(fakes())
    p.submit([1, 2], max_new_tokens=4)
    p.submit([3, 4], max_new_tokens=16)
    for h in p.handles[0]:
        h.cancel()
    p.pump()
    p.pump_until(lambda gw: len(p.handles[1][1]._collected) >= 2)
    for h in p.handles[1]:
        h.cancel()
    p.pump()
    assert [h.status for h in p.handles[1]] == ["cancelled"] * 2
    assert p.t.gate.committed_blocks == 0 and p.t.snapshot()["counters"]["cancelled"] == 2


# ---------------------------------------------------------------------- lifecycle
@pytest.mark.parametrize("how", ["drain", "shutdown", "kill", "kill_typed", "shed_queued"])
def test_lifecycle_with_live_streams_lockstep(how):
    p = Pair(fakes(free_blocks=2))
    for i in range(4):
        p.submit([9, 9, 9], max_new_tokens=3 + i)
    p.pump(2)
    assert p.t.inflight() == {"queued": 2, "active": 2, "paused": 0}
    if how == "drain":
        p.call("drain", 10)
    elif how == "shutdown":
        p.call("shutdown")
    elif how == "kill":
        p.call("kill")
    elif how == "kill_typed":  # each gateway fails with its own package's error
        p.j.kill(JaxReplicaDiedError("induced crash"))
        p.t.kill(ReplicaDiedError("induced crash"))
    else:
        assert p.call("shed_queued", jserving.QueueFullError("handing off")) == [2, 2]
        p.pump_until(lambda gw: all(h.done for _, h in p.handles))
    p.check()
    after = p.submit([1, 2])
    if how in ("drain", "shutdown"):
        assert after[1].reason == "gateway_closed"
    elif how.startswith("kill"):
        assert after[1].reason == "gateway_failed"
    if how.startswith("kill") or how == "shutdown":
        assert p.t.engine.destroyed and p.j.engine.destroyed
        assert all(h.status == "failed" for _, h in p.handles)
    if how == "kill_typed":
        assert all(type(h.error) is ReplicaDiedError for _, h in p.handles)


def test_pump_crash_fails_every_handle_typed():
    """The port's pump thread dies on an engine fault: every handle fails
    with ``GatewayFailedError`` (none hangs), as the JAX pump's."""
    results = []
    for mod in (jserving, serving):
        engine = FakeEngine()

        def boom(uids, chunks, sample=None):
            raise RuntimeError("synthetic engine fault")
        engine.put = boom
        gw = mod.ServingGateway(engine, config=mod.ServingConfig(max_burst=1))
        handles = [gw.submit([1, 2], max_new_tokens=4) for _ in range(3)]
        with pytest.raises(mod.GatewayFailedError, match="synthetic engine fault"):
            handles[0].result(timeout=10)
        for h in handles[1:]:
            with pytest.raises(mod.GatewayFailedError):
                h.result(timeout=10)
        with pytest.raises(mod.GatewayFailedError):
            gw.submit([3, 4])
        results.append((gw.state, gw.snapshot()["counters"]["failed"]))
    assert results[0] == results[1] == ("failed", 3)


def test_error_taxonomy_matrix_matches_jax():
    for name in ERRORS:
        jcls, tcls = getattr(jserving, name), getattr(serving, name)
        assert issubclass(tcls, serving.ServingError)
        assert (tcls.reason, tcls.retry_elsewhere) == (jcls.reason, jcls.retry_elsewhere), name
        assert tcls("x").details == {}
    assert serving.ServingError("x", depth=3).details == {"depth": 3}
    assert (UnknownAdapterError.reason, UnknownAdapterError.retry_elsewhere) == (
        "unknown_adapter", False)
    gates = [m.CapacityGate(FakeEngine(max_ctx_tokens=64, free_blocks=4), 64)
             for m in (jserving, serving)]
    for args in ((60, 8), (32, 16), (0, 8)):
        errs = []
        for gate in gates:
            with pytest.raises(Exception) as ei:
                gate.check_feasible(*args)
            errs.append(ei.value)
        assert (type(errs[1]).__name__, str(errs[1]), errs[1].details) == \
            (type(errs[0]).__name__, str(errs[0]), errs[0].details)
    j, t = gates
    for gate in gates:
        assert gate.footprint(9, 8) == 3 and gate.try_commit(8, 8) and gate.try_commit(8, 8)
        assert not gate.try_commit(1, 1)
    assert (t.committed_blocks, t.active) == (j.committed_blocks, j.active)


# ---------------------------------------------------------------------- config
GOOD = [{}, {"max_queue_depth": 8, "admission_policy": "shed",
             "sampling": {"temperature": 0.7, "top_p": 0.9}},
        {"role": "prefill", "token_budget": 0, "metrics_window": 16},
        {"autotune": {"breach_ticks": 3, "rollback_ticks": 3, "cooldown_ticks": 0}},
        {"max_queue_depth": "8", "block_timeout_s": 1}, {"eos_token_id": 2}]
BAD = [{"admission_policy": "drop"}, {"role": "router"}, {"max_queue_depth": 0},
       {"block_timeout_s": 0}, {"token_budget": -1}, {"max_burst": 0},
       {"default_max_new_tokens": 0}, {"drain_timeout_s": -1.0}, {"idle_poll_s": 0},
       {"metrics_window": 15}, {"metrics_interval_steps": -1}, {"max_queue_depth": 2.5},
       {"sampling": {"top_p": 7.0}}, {"sampling": {"temp": 0.7}},
       {"autotune": {"rollback_ticks": 1, "breach_ticks": 2}},
       {"autotune": {"interval_s": 0}}, {"autotune": {"p99_ttft_slo_ms": 0}},
       {"autotune": {"breach_ticks": 0}}, {"autotune": {"cooldown_ticks": -1}},
       {"autotune": {"min_queue_depth": 0}}, {"autotune": {"min_draft_len": 0}},
       {"autotune": {"min_token_budget": -1}}]


@pytest.mark.parametrize("block", GOOD + BAD, ids=[f"good{i}" for i in range(len(GOOD))]
                         + [f"bad{i}" for i in range(len(BAD))])
def test_config_validation_matches_jax(block):
    def build(mod):
        try:
            return mod.get_serving_config({"serving": block})
        except ValueError:  # pydantic's ValidationError is a ValueError
            return "rejected"
    j, t = build(jserving), build(serving)
    if isinstance(j, str):
        assert isinstance(t, str), f"the port accepted {block}, JAX rejected it"
        assert block in BAD
    else:
        assert not isinstance(t, str), t
        assert block in GOOD
        for f in dataclasses.fields(t):
            v = getattr(t, f.name)
            if dataclasses.is_dataclass(v):
                assert dataclasses.asdict(v) == getattr(j, f.name).model_dump()
            else:
                assert v == getattr(j, f.name), f.name


def test_autotune_raises_until_ported(monkeypatch):
    with pytest.raises(NotImplementedError, match="SLO controller.*port queue item 4"):
        serving.ServingGateway(FakeEngine(), config=serving.ServingConfig(
            autotune={"enabled": True}), auto_start=False)
    monkeypatch.setenv("DS_AUTOTUNE", "1")
    with pytest.raises(NotImplementedError, match="SLO controller"):
        serving.ServingGateway(FakeEngine(), auto_start=False)
    monkeypatch.setenv("DS_AUTOTUNE", "0")
    monkeypatch.setenv("DS_AUTOTUNE_CONFIG", "tuned.json")
    with pytest.raises(NotImplementedError, match="DS_AUTOTUNE_CONFIG.*port queue item 4"):
        serving.ServingGateway(FakeEngine(), auto_start=False)
    monkeypatch.delenv("DS_AUTOTUNE_CONFIG")
    gw = serving.ServingGateway(FakeEngine(), config=serving.ServingConfig(
        autotune={"enabled": True}), auto_start=False)  # DS_AUTOTUNE=0 wins
    assert gw.controller is None


# ---------------------------------------------------------------------- real engines
@pytest.fixture(scope="module")
def debug():
    model = build_llama("debug", remat=False)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    params = jax.tree.map(np.asarray, params)
    return model, params, params_from_jax(params)


def real(debug, num_kv_blocks=0, max_context=32, n_seqs=16, structured=False, lora=False):
    """A JAX and a port engine over the same weights, one config."""
    model, params, port_params = debug
    sm = dict(max_ragged_batch_size=96, max_ragged_sequence_count=n_seqs,
              max_tracked_sequences=n_seqs, max_context=max_context)
    lcfg = dict(enabled=lora, hot_set=2, max_rank=4, prefetch=False)
    jeng = JaxEngine(model=model, config=JaxCfg(
        kv_block_size=8, num_kv_blocks=num_kv_blocks, state_manager=JaxSM(**sm),
        structured=JaxStructured(enabled=structured), lora=JaxLoRA(**lcfg)),
        params=params, dtype=jnp.float32)
    teng = InferenceEngineV2(LlamaConfig(**dataclasses.asdict(model.config)),
                             RaggedInferenceEngineConfig(
                                 kv_block_size=8, num_kv_blocks=num_kv_blocks,
                                 state_manager=DSStateManagerConfig(**sm),
                                 structured=StructuredConfig(enabled=structured),
                                 lora=LoRAServingConfig(**lcfg)),
                             params=port_params, dtype=torch.float32, device="cpu")
    return jeng, teng


def traffic(n=12):
    rng = np.random.RandomState(0)
    return ([rng.randint(0, 250, size=5 + i % 6).astype(np.int32) for i in range(n)],
            [2 + i % 3 for i in range(n)])


def test_streams_match_direct_run_lockstep(debug):
    engines = real(debug)
    prompts, max_new = traffic()
    want = []
    for cls, eng in zip((JaxSched, DynamicSplitFuseScheduler), engines):
        direct = cls(eng, token_budget=48, max_burst=4)
        for i, p in enumerate(prompts):
            direct.add_request(1000 + i, p, max_new_tokens=max_new[i])
        want.append(direct.run_to_completion())
    assert want[0] == want[1]
    free0 = [e.free_blocks for e in engines]
    p = Pair(engines, token_budget=48, max_burst=4)
    for i, prompt in enumerate(prompts):
        p.submit(prompt, max_new_tokens=max_new[i], priority=i % 3)
    p.pump_until(lambda gw: sum(gw.inflight().values()) == 0)
    for i, (_, h) in enumerate(p.handles):
        assert h.result(timeout=1) == want[1][1000 + i], f"request {i} diverged"
    assert [e.free_blocks for e in engines] == free0
    c = p.t.snapshot()["counters"]
    assert c["submitted"] == c["admitted"] == c["completed"] == len(prompts)
    p.call("drain", 10)
    assert engines[1].kv_cache is None and engines[0].kv_cache is None


def test_threaded_clients_and_pump_match_direct_run(debug):
    """The port's gateway with its pump thread and 12 client threads
    streaming: each stream equals the direct run, nothing leaks."""
    _, engine = real(debug)
    prompts, max_new = traffic()
    direct = DynamicSplitFuseScheduler(engine, token_budget=48, max_burst=4)
    for i, p in enumerate(prompts):
        direct.add_request(1000 + i, p, max_new_tokens=max_new[i])
    want = direct.run_to_completion()
    free0 = engine.free_blocks

    class Monitor:
        events = []

        def write_events(self, event_list):
            self.events.extend(event_list)

    monitor = Monitor()
    gw = serving.ServingGateway(engine, config=serving.ServingConfig(
        token_budget=48, max_burst=4, metrics_interval_steps=1), monitor=monitor)
    streams = {}

    def client(i):
        handle = gw.submit(prompts[i], max_new_tokens=max_new[i], priority=i % 3)
        streams[i] = list(handle.tokens(timeout=60))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert all(streams[i] == want[1000 + i] for i in range(len(prompts)))
    assert engine.free_blocks == free0
    snap = gw.snapshot()
    assert snap["ttft"]["count"] == len(prompts) and snap["token_latency"]["count"] > 0
    assert snap["external"]["Serve/Engine"]["tokens_emitted"] > 0
    assert {t for t, _, _ in monitor.events} >= {"serving/ttft/p50_ms", "serving/count/completed"}
    gw.drain(timeout=30)
    assert gw.state == "stopped" and engine.kv_cache is None
    with pytest.raises(serving.GatewayClosedError):
        gw.submit(prompts[0])


def test_over_capacity_rejected_typed_lockstep(debug):
    p = Pair(real(debug, num_kv_blocks=4, max_context=32))
    assert p.submit(list(range(24)), max_new_tokens=8)[1].reason == "too_large"
    assert p.submit(list(range(30)), max_new_tokens=8)[1].reason == "too_large"
    assert p.t.snapshot()["counters"]["rejected_too_large"] == 2
    p.check()


def test_cancel_mid_decode_frees_blocks_lockstep(debug):
    engines = real(debug)
    free0 = [e.free_blocks for e in engines]
    p = Pair(engines)
    p.submit(np.arange(8, dtype=np.int32), max_new_tokens=16)
    p.pump(4)
    assert 1 <= len(p.handles[0][1]._collected) < 16
    for h in p.handles[0]:
        h.cancel()
    p.pump()
    assert [e.free_blocks for e in engines] == free0
    p.submit(np.arange(6, dtype=np.int32), max_new_tokens=2)
    p.pump_until(lambda gw: p.handles[1][1].done)
    assert p.handles[1][1].status == "completed"


def test_priority_preemption_suspends_then_resumes_lockstep(debug):
    engines = real(debug, num_kv_blocks=4, max_context=16, n_seqs=4)
    p = Pair(engines)
    p.submit(np.arange(8, dtype=np.int32), max_new_tokens=8, priority=0)
    p.pump(2)
    p.submit(np.arange(8, dtype=np.int32) + 40, max_new_tokens=4, priority=5)
    p.pump()
    assert all(e.is_suspended(p.handles[0][0].uid) for e in engines)
    p.pump_until(lambda gw: all(h.done for _, h in p.handles))
    c = p.t.snapshot()["counters"]
    assert (c["preemptions"], c["resumes"], c["completed"]) == (1, 1, 2)
    # each stream equals the request served alone
    for (prompt, n), (_, h) in zip(((np.arange(8), 8), (np.arange(8) + 40, 4)), p.handles):
        alone = DynamicSplitFuseScheduler(engines[1], max_burst=1)
        alone.add_request(900, prompt.astype(np.int32), max_new_tokens=n)
        assert h.result(timeout=1) == alone.run_to_completion()[900]


def test_sampled_constrained_and_adapter_submits_lockstep(debug):
    engines = real(debug, structured=True, lora=True)
    vocab = byte_vocab(debug[0].config.vocab_size)
    schemas = (jgrammar.CompiledSchema(SCHEMA, vocab, eos_token_id=EOS),
               CompiledSchema(SCHEMA, vocab, eos_token_id=EOS))
    p = Pair(engines, eos_token_id=EOS, token_strings=vocab)
    prompts, _ = traffic(4)
    p.submit(prompts[0], max_new_tokens=6, sample={"temperature": 0.9, "top_k": 20})
    p.submit(prompts[1], max_new_tokens=6, sample={"temperature": 1.1, "seed": 7})
    hs = [p.j.submit(prompts[2], max_new_tokens=12, schema=schemas[0]),
          p.t.submit(prompts[2], max_new_tokens=12, schema=schemas[1])]
    p.handles.append(tuple(hs))
    p.submit(prompts[3], max_new_tokens=12, schema=SCHEMA)  # raw: compiled at the door
    assert p.handles[0][1].sample["seed"] == p.handles[0][0].sample["seed"]
    p.pump_until(lambda gw: all(h.done for _, h in p.handles))
    assert all(h.status == "completed" for _, h in p.handles)
    assert p.handles[2][1].result()[-1] == EOS
    unknown = p.submit(prompts[0], adapter_id=77)
    assert isinstance(unknown[1], UnknownAdapterError)
    assert p.t.snapshot()["counters"]["rejected_unknown_adapter"] == 1
    # a malformed spec: typed on the port; the JAX gateway's count of an
    # unlisted counter raises KeyError first (ROADMAP.md queue 3)
    with pytest.raises(ValueError, match="top_p"):
        p.t.submit(prompts[0], sample={"top_p": 3.0})
    with pytest.raises(KeyError, match="rejected_bad_sample"):
        p.j.submit(prompts[0], sample={"top_p": 3.0})
    assert p.t.snapshot()["counters"]["rejected_bad_sample"] == 1
    p.call("drain", 10)


def test_schema_without_constrained_decoding_rejected_typed(debug):
    """The port raises the typed ``ValueError`` and counts it; the JAX
    gateway's count of its unlisted counter raises ``KeyError`` first
    (ROADMAP.md queue 3)."""
    p = Pair(real(debug))
    with pytest.raises(ValueError, match="constrained decoding is disabled"):
        p.t.submit([1, 2, 3], schema=SCHEMA)
    with pytest.raises(KeyError, match="rejected_schema"):
        p.j.submit([1, 2, 3], schema=SCHEMA)
    assert p.t.snapshot()["counters"]["rejected_schema"] == 1
    assert set(p.t.snapshot()["counters"]) - set(jserving.ServingMetrics.COUNTERS) == \
        PORT_ONLY_COUNTERS
    p.call("drain", 10)
