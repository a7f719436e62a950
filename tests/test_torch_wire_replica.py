"""The port's wire transport (``ReplicaServer`` and ``WireReplica`` over a
real socket) against the JAX package's, on the CPU.

- Over the JAX test's deterministic ``FakeEngine``
  (``tests/unit/inference/serving/test_wire_replica.py``): streaming,
  multiplexing, cancel, the router's contracts across the wire (a stall
  raises ``queue.Empty``, typed rejections keep their hints, failover
  replays bit for bit), handoff records validated on the importing side,
  the wire faults (server death and reconnect, the JAX test's proxy in
  pass, blackhole and tear modes, a dropped connection) and the
  ``DS_FLEET_TRANSPORT`` knob. Each case runs through both packages'
  servers, clients and gateway replicas; each handle's status, stream,
  error type and ``reason`` and the router's counters are compared
  exactly (a case whose stream length follows a thread's timing compares
  what does not).
- Over real engines (the ``debug`` Llama, fp32, the JAX tree through
  ``params_from_jax``), servers in threads over port engines: a
  ``FleetRouter`` over two ``WireReplica``s streams what the JAX engine
  streams; a replica crashing mid-decode fails over bit for bit; a
  handoff record of a port engine with a bf16 KV tier crosses both frame
  formats byte for byte and imports, and a prefill/decode pair over the
  wire streams what a unified pair streams; a ``PublicationRef`` refresh
  validates and adopts in the server, and a torn publication is
  rejected typed there.
"""

import dataclasses
import io
import queue as _queue
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
from deepspeed_tpu.inference.v2.prefix_cache.radix_index import _chunk_key
from deepspeed_tpu.models import build_llama
from deepspeed_tpu.serving import fleet as jfleet
from deepspeed_tpu.serving.fleet import wire as jwire
from deepspeed_tpu.serving.fleet.wire import codec as jcodec
from deepspeed_tpu.utils import sanitize as jsanitize
from deepspeed_tpu_torch import serving
from deepspeed_tpu_torch.inference.v2 import (DSStateManagerConfig, DynamicSplitFuseScheduler,
                                              InferenceEngineV2, KVTierConfig, PrefixCacheConfig,
                                              RaggedInferenceEngineConfig)
from deepspeed_tpu_torch.models import LlamaConfig, params_from_jax
from deepspeed_tpu_torch.serving import fleet as tfleet
from deepspeed_tpu_torch.serving.fleet import wire as twire
from deepspeed_tpu_torch.serving.fleet.wire import codec as tcodec
from deepspeed_tpu_torch.serving.refresh import WeightPublisher
from deepspeed_tpu_torch.utils import sanitize
from unit.common.fault_injection import WireFaultProxy
from unit.inference.serving.test_admission import FakeEngine

torch.set_num_threads(1)  # the suite runs in parallel worker processes

JAX = types.SimpleNamespace(serving=jserving, fleet=jfleet, wire=jwire, sanitize=jsanitize,
                            name="jax")
PORT = types.SimpleNamespace(serving=serving, fleet=tfleet, wire=twire, sanitize=sanitize,
                             name="port")


class SlowEngine(FakeEngine):
    """Paced generation: a cancel sent mid-stream beats completion."""

    def put(self, uids, chunks, sample=None):
        time.sleep(0.05)
        return super().put(uids, chunks, sample=sample)


# ---------------------------------------------------------------------- harness
class Stacks:
    """The servers and clients a case starts in package ``P``, stopped
    and closed at the end."""

    def __init__(self, P):
        self.P, self.closers = P, []

    def replica(self, name, engine_cls=FakeEngine, **serving_cfg):
        serving_cfg.setdefault("max_burst", 1)
        rep = self.P.fleet.GatewayReplica(name, lambda: engine_cls(),
                                          serving_config=self.P.serving.ServingConfig(
                                              **serving_cfg))
        self.closers.append(rep.shutdown)
        return rep

    def server(self, replica, bind="127.0.0.1:0"):
        srv = self.P.wire.ReplicaServer(replica, bind=bind)
        srv.start()
        self.closers.append(srv.stop)
        return srv

    def client(self, name, address, **kw):
        kw.setdefault("timeout_s", 5.0)
        kw.setdefault("probe_timeout_s", 1.0)
        kw.setdefault("connect_timeout_s", 1.0)
        kw.setdefault("backoff_s", 0.02)
        cli = self.P.wire.WireReplica(name, address, **kw)
        self.closers.append(cli.close)
        return cli

    def serve(self, replica, bind="127.0.0.1:0", **kw):
        srv = self.server(replica, bind)
        return srv, self.client(replica.name, srv.address, **kw)

    def router(self, replicas, **cfg):
        cfg.setdefault("retry_backoff_s", 0.005)
        cfg.setdefault("heartbeat_interval_s", 0.05)
        cfg.setdefault("stream_token_timeout_s", 5.0)
        router = self.P.fleet.FleetRouter(replicas, config=self.P.fleet.FleetConfig(**cfg),
                                          auto_heartbeat=False)
        self.closers.append(router.shutdown)
        return router

    def close(self):
        for fn in reversed(self.closers):
            try:
                fn()
            except Exception:  # noqa: BLE001 — teardown of what may be dead already
                pass


def err_state(err):
    return (type(err).__name__, getattr(err, "reason", None)) if err is not None else None


def handle_state(h, stream=True):
    return (h.status, list(h._collected) if stream else None, err_state(h.error))


def wait_until(cond, timeout, what):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {what}")


# ---------------------------------------------------------------------- streaming
def case_submit_streams_expected_tokens(S, m):
    _srv, cli = S.serve(S.replica("w0"))
    h = cli.submit(np.array([1, 2, 3], np.int32), max_new_tokens=4)
    got = list(h.tokens(timeout=10))
    assert got == FakeEngine.expected_tokens(0, 3, 4)
    h2 = cli.submit([4, 5], max_new_tokens=3)
    assert h2.result(timeout=10) == FakeEngine.expected_tokens(1, 2, 3)
    return got, h.status, h.done, h.uid, handle_state(h2), h2.uid


def case_concurrent_streams_multiplex_one_connection(S, m):
    _srv, cli = S.serve(S.replica("w0"))
    results = {}

    def run():
        h = cli.submit([1] * 3, max_new_tokens=3)
        results[h.uid] = h.result(timeout=30)

    threads = [threading.Thread(target=run) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert all(got == FakeEngine.expected_tokens(uid, 3, 3) for uid, got in results.items())
    return sorted(results.items()), cli.reconnects


def case_probe_alive_load_and_stats(S, m):
    rep = S.replica("w0")
    _srv, cli = S.serve(rep)
    stats = cli.stats()
    assert stats.pop("wire_address") == cli.address
    return cli.probe(), cli.alive(), cli.load(), rep.load(), cli.weight_version(), stats


def case_shutdown_detaches_but_stop_remote_stops_server(S, m):
    srv, cli = S.serve(S.replica("w0"))
    probe_cli = S.client("w0", srv.address)
    cli.shutdown()  # client-side detach only
    seen = [srv.state, probe_cli.probe()]
    probe_cli.stop_remote()
    wait_until(lambda: srv.state == "stopped", 5, "the server to stop")
    return seen + [srv.state, probe_cli.probe()]


def case_cancel_propagates_typed(S, m):
    _srv, cli = S.serve(S.replica("slow", engine_cls=SlowEngine))
    h = cli.submit([1, 2, 3], max_new_tokens=50)
    it = h.tokens(timeout=5.0)
    first = next(it)
    h.cancel()
    with pytest.raises(S.P.serving.RequestCancelledError):
        for _ in it:
            pass
    assert len(h._collected) < 50
    return first, handle_state(h, stream=False)


# ---------------------------------------------------------------------- router contracts
def case_stall_raises_queue_empty(S, m):
    faulty = S.P.fleet.FaultyReplica(S.replica("hang"), hang_at_token=1)
    _srv, cli = S.serve(faulty)
    h = cli.submit([7, 8, 9], max_new_tokens=5)
    it = h.tokens(timeout=0.4)
    first = next(it)
    with pytest.raises(_queue.Empty):
        next(it)
    return first, h.status


def case_typed_reject_crosses_with_hints(S, m):
    _srv, cli = S.serve(S.P.fleet.FaultyReplica(S.replica("rej"), reject_next=1))
    with pytest.raises(S.P.serving.QueueFullError) as ei:
        cli.submit([1], max_new_tokens=1)
    return str(ei.value), ei.value.details, ei.value.retry_elsewhere, ei.value.reason


def case_router_fails_over_wire_replica_bit_identical(S, m):
    _s0, cli0 = S.serve(S.P.fleet.FaultyReplica(S.replica("r0"), crash_at_token=2))
    _s1, cli1 = S.serve(S.replica("r1"))
    router = S.router([cli0, cli1])
    h = router.submit([1, 2, 3], max_new_tokens=4)
    got = h.result(timeout=30)
    assert got == FakeEngine.expected_tokens(0, 3, 4) and h.replica_trail == ["r0", "r1"]
    c = router.snapshot()["counters"]
    assert c["failovers"] >= 1
    return handle_state(h), h.replica_trail, h.attempts, c


def case_router_failover_on_server_death(S, m):
    s0, cli0 = S.serve(S.P.fleet.FaultyReplica(S.replica("r0"), slow_token_s=0.1))
    _s1, cli1 = S.serve(S.replica("r1"))
    router = S.router([cli0, cli1])
    h = router.submit([5, 6, 7], max_new_tokens=6)
    wait_until(lambda: h._collected, 10, "a first token")
    s0.stop()  # the connection dies with frames in flight
    got = h.result(timeout=30)
    assert got == FakeEngine.expected_tokens(0, 3, 6)
    return got, h.status, h.replica_trail[0], h.replica_trail[-1]


# ---------------------------------------------------------------------- handoff
def make_handoff_record(block_size=4, n_entries=3, seed=0):
    """The JAX test's validator-passing record: ndarray KV carriers,
    hash-chained keys."""
    rng = np.random.RandomState(seed)
    entries, pk = [], None
    for _ in range(n_entries):
        tokens = tuple(int(t) for t in rng.randint(0, 997, size=block_size))
        key = _chunk_key(pk, tokens)
        k = rng.randn(2, block_size, 4).astype(np.float32)
        v = rng.randn(2, block_size, 4).astype(np.float32)
        entries.append({"key": key, "parent_key": pk, "tokens": tokens,
                        "handle": {"k": k, "v": v}, "nbytes": int(k.nbytes + v.nbytes),
                        "quant_error": 0.0})
        pk = key
    return {"version": 1, "block_size": block_size, "root_key": None, "quantized": False,
            "entries": entries}


def handoff_endpoint(P, name, record=None):
    """A minimal replica: exports a fixed record, validates an import with
    its package's trust-boundary check before adopting it."""

    class Endpoint(P.fleet.Replica):
        def __init__(self):
            self.name, self.role, self.record, self.imported = name, "unified", record, []

        def take_handoff(self, uid):
            return self.record

        def import_handoff(self, rec):
            P.sanitize.check_handoff_record(rec)
            self.imported.append(rec)
            return sum(len(e["tokens"]) for e in rec["entries"])

        def probe(self):
            return True

        def alive(self):
            return True

        def shutdown(self):
            pass
    return Endpoint()


def _record_bytes(rec):
    return [(e["key"], tuple(e["tokens"]), {c: (a.dtype.str, a.tobytes())
                                            for c, a in e["handle"].items()})
            for e in rec["entries"]]


def case_handoff_record_round_trips_validated(S, m):
    record = make_handoff_record()
    _sa, cli_a = S.serve(handoff_endpoint(S.P, "prefill", record))
    dst = handoff_endpoint(S.P, "decode")
    _sb, cli_b = S.serve(dst)
    taken = cli_a.take_handoff(uid=0)
    assert isinstance(taken["entries"][0]["tokens"], tuple)
    S.P.sanitize.check_handoff_record(taken)
    n = cli_b.import_handoff(taken)
    assert _record_bytes(dst.imported[0]) == _record_bytes(record)
    return n, _record_bytes(dst.imported[0])


def case_torn_record_rejected_typed_on_the_importing_side(S, m):
    src = S.P.fleet.FaultyReplica(handoff_endpoint(S.P, "prefill", make_handoff_record()),
                                  corrupt_handoff=True)
    _sa, cli_a = S.serve(src)
    dst = handoff_endpoint(S.P, "decode")
    _sb, cli_b = S.serve(dst)
    torn = cli_a.take_handoff(uid=0)
    with pytest.raises(S.P.sanitize.KVTierCorruptionError) as ei:
        cli_b.import_handoff(torn)
    assert dst.imported == []
    return err_state(ei.value), ei.value.retry_elsewhere


# ---------------------------------------------------------------------- wire faults
def case_server_death_fails_fast_then_reconnects(S, m):
    bind = f"unix:{m.tmp}/r0_{S.P.name}.sock"
    srv, cli = S.serve(S.replica("w0"), bind=bind)
    seen = [cli.probe()]
    srv.stop()
    seen += [cli.probe(), cli.load(), cli.alive()]
    S.server(S.replica("w0"), bind=bind)  # a replacement binds the SAME address
    wait_until(cli.probe, 5, "the reconnect")
    h = cli.submit([1, 2], max_new_tokens=2)
    seen.append(h.result(timeout=10))
    assert seen[-1] == FakeEngine.expected_tokens(0, 2, 2) and cli.reconnects >= 2
    return seen


def case_blackholed_socket_hits_io_deadline(S, m):
    srv = S.server(S.replica("w0"))
    proxy = WireFaultProxy(srv.address, mode="blackhole")
    S.closers.append(proxy.close)
    cli = S.client("w0", proxy.address, timeout_s=0.5, probe_timeout_s=0.3)
    t0 = time.monotonic()
    probed = cli.probe()
    assert time.monotonic() - t0 < 2.0
    with pytest.raises(S.P.serving.ServingError) as ei:
        cli._call("weight_version")
    assert type(ei.value).__name__ in ("WireTimeoutError", "ReplicaDiedError")
    return probed, ei.value.retry_elsewhere


def case_torn_frame_surfaces_typed(S, m):
    srv = S.server(S.replica("w0"))
    proxy = WireFaultProxy(srv.address, mode="torn", torn_after=20)
    S.closers.append(proxy.close)
    cli = S.client("w0", proxy.address, timeout_s=1.0, probe_timeout_s=1.0)
    with pytest.raises(S.P.serving.ServingError) as ei:
        cli._call("weight_version")
    return ei.value.retry_elsewhere


def case_proxy_pass_mode_is_transparent(S, m):
    srv = S.server(S.replica("w0"))
    proxy = WireFaultProxy(srv.address, mode="pass")
    S.closers.append(proxy.close)
    cli = S.client("w0", proxy.address)
    got = cli.submit([1, 2, 3], max_new_tokens=3).result(timeout=10)
    assert proxy.forwarded > 0
    return got


def case_dropped_connection_fails_pending_typed(S, m):
    srv = S.server(S.P.fleet.FaultyReplica(S.replica("w0"), hang_at_token=0))
    proxy = WireFaultProxy(srv.address, mode="pass")
    S.closers.append(proxy.close)
    cli = S.client("w0", proxy.address)
    h = cli.submit([1, 2], max_new_tokens=4)
    proxy.drop_connections()
    with pytest.raises(S.P.serving.ServingError):
        list(h.tokens(timeout=5.0))
    return handle_state(h)


# ---------------------------------------------------------------------- the knob
def case_unset_and_inproc_build_plain_gateway_replica(S, m):
    m.delenv("DS_FLEET_TRANSPORT", raising=False)
    seen = [S.P.wire.transport_mode()]
    scfg = S.P.serving.ServingConfig(max_burst=1)
    rep = S.P.wire.make_replica("r0", lambda: FakeEngine(), scfg)
    S.closers.append(rep.shutdown)
    m.setenv("DS_FLEET_TRANSPORT", "inproc")
    rep2 = S.P.wire.make_replica("r0", lambda: FakeEngine(), scfg)
    S.closers.append(rep2.shutdown)
    assert type(rep) is type(rep2) is S.P.fleet.GatewayReplica
    seen.append(rep2.submit([1, 2, 3], max_new_tokens=3).result(timeout=10))
    with pytest.raises(ValueError, match="engine_factory"):
        S.P.wire.make_replica("r0")
    return seen


def case_wire_mode_builds_client_for_address(S, m):
    m.setenv("DS_FLEET_TRANSPORT", "wire")
    srv = S.server(S.replica("w0"))
    rep = S.P.wire.make_replica("w0", address=srv.address, timeout_s=5.0)
    S.closers.append(rep.close)
    assert isinstance(rep, S.P.wire.WireReplica)
    with pytest.raises(ValueError, match="address"):
        S.P.wire.make_replica("r0", lambda: FakeEngine())
    return S.P.wire.transport_mode(), rep.role, rep.submit([9, 9], max_new_tokens=2).result(
        timeout=10)


def case_invalid_mode_rejected(S, m):
    m.setenv("DS_FLEET_TRANSPORT", "carrier-pigeon")
    with pytest.raises(ValueError, match="DS_FLEET_TRANSPORT") as ei:
        S.P.wire.transport_mode()
    return str(ei.value)


CASES = {name[5:]: fn for name, fn in dict(globals()).items() if name.startswith("case_")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_wire_lockstep(case, monkeypatch, tmp_path):
    """One case of the JAX wire test through both packages' stacks: equal
    observations."""
    out = {}
    for P in (JAX, PORT):
        S = Stacks(P)
        with monkeypatch.context() as m:
            m.tmp = tmp_path
            try:
                out[P.name] = CASES[case](S, m)
            finally:
                S.close()
    assert out["port"] == out["jax"]


def test_mixed_packages_interoperate(tmp_path):
    """A JAX client drives a port server and a port client a JAX server:
    the frames are one protocol."""
    port, jax_ = Stacks(PORT), Stacks(JAX)
    try:
        psrv = port.server(port.replica("p"))
        jsrv = jax_.server(jax_.replica("j"))
        a = jax_.client("p", psrv.address).submit([1, 2, 3], max_new_tokens=4)
        b = port.client("j", jsrv.address).submit([1, 2, 3], max_new_tokens=4)
        assert a.result(timeout=10) == b.result(timeout=10) == FakeEngine.expected_tokens(0, 3, 4)
        with pytest.raises(jserving.QueueFullError):
            srv = port.server(PORT.fleet.FaultyReplica(port.replica("r"), reject_next=1))
            jax_.client("r", srv.address).submit([1], max_new_tokens=1)
    finally:
        port.close()
        jax_.close()


# ---------------------------------------------------------------------- real engines
@pytest.fixture(scope="module")
def debug():
    model = build_llama("debug", remat=False)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    params = jax.tree.map(np.asarray, params)
    return model, params, params_from_jax(params)


SM = dict(max_ragged_batch_size=96, max_ragged_sequence_count=16, max_tracked_sequences=16,
          max_context=32)


def port_factory(debug, tiered=False, dtype=torch.float32, params=None):
    model, _, port_params = debug
    extra = {}
    if tiered:
        extra = dict(prefix_cache=PrefixCacheConfig(enabled=True),
                     kv_tier=KVTierConfig(enabled=True, host_bytes=1 << 22))
    return lambda: InferenceEngineV2(
        LlamaConfig(**dataclasses.asdict(model.config)), RaggedInferenceEngineConfig(
            kv_block_size=8, state_manager=DSStateManagerConfig(**SM), **extra),
        params=port_params if params is None else params, dtype=dtype, device="cpu")


@pytest.fixture(scope="module")
def reference(debug):
    """Prompts (long enough to export a full KV block) and the JAX
    engine's direct greedy streams: the yardstick of the fleets below."""
    model, params, _ = debug
    rng = np.random.RandomState(0)
    n = 6
    prompts = [rng.randint(0, 250, size=9 + i % 5).astype(np.int32) for i in range(n)]
    max_new = [2 + i % 3 for i in range(n)]
    engine = JaxEngine(model=model, config=JaxCfg(kv_block_size=8, state_manager=JaxSM(**SM)),
                       params=params, dtype=jnp.float32)
    direct = JaxSched(engine, token_budget=48, max_burst=4)
    for i in range(n):
        direct.add_request(i, prompts[i], max_new_tokens=max_new[i])
    out = direct.run_to_completion()
    engine.destroy()
    return prompts, max_new, [list(out[i]) for i in range(n)]


def real_fleet(S, factory, roles=(None, None), faults=(None, None)):
    """Two port ``GatewayReplica``s served in threads, reached by
    ``WireReplica``s (with their roles) → the clients and the replicas."""
    scfg = serving.ServingConfig(token_budget=48, max_burst=4)
    reps, clients = [], []
    for name, role, fault in zip(("r0", "r1"), roles, faults):
        rep = tfleet.GatewayReplica(name, factory, serving_config=scfg, role=role)
        S.closers.append(rep.shutdown)
        served = tfleet.FaultyReplica(rep, **fault) if fault else rep
        srv = S.server(served)
        clients.append(S.client(name, srv.address, role=role or "unified", timeout_s=60.0,
                                probe_timeout_s=5.0))
        reps.append(rep)
    return clients, reps


def stream_all(router, prompts, max_new):
    handles = [router.submit(prompts[i], max_new_tokens=max_new[i]) for i in range(len(prompts))]
    streams, errors = {}, {}

    def client(i, h):
        try:
            streams[i] = [int(t) for t in h.tokens(timeout=120)]
        except Exception as e:  # noqa: BLE001 — asserted below
            errors[i] = e

    threads = [threading.Thread(target=client, args=(i, h)) for i, h in enumerate(handles)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    assert not any(t.is_alive() for t in threads), "hung client stream"
    assert not errors, {i: str(e) for i, e in errors.items()}
    return [streams[i] for i in range(len(prompts))]


def test_wire_fleet_streams_equal_jax_engine(debug, reference):
    """Two wire replicas healthy, then with r0 crashing at its first
    streamed token: every stream equals the JAX engine's direct run; the
    crash fails over, the dead replica is DOWN."""
    prompts, max_new, want = reference
    S = Stacks(PORT)
    try:
        clients, _ = real_fleet(S, port_factory(debug))
        router = S.router(clients, stream_token_timeout_s=60.0)
        assert stream_all(router, prompts, max_new) == want
        c = router.snapshot()["counters"]
        assert c["completed"] == len(prompts) and c["failed"] == c["retries"] == 0
        assert c["tokens_relayed"] == sum(max_new)
    finally:
        S.close()
    S = Stacks(PORT)
    try:
        clients, _ = real_fleet(S, port_factory(debug), faults=(dict(crash_at_token=1), None))
        router = S.router(clients, stream_token_timeout_s=60.0)
        assert stream_all(router, prompts, max_new) == want
        c = router.snapshot()["counters"]
        assert c["failovers"] >= 1 and c["completed"] == len(prompts) and c["failed"] == 0
        router.tick()
        assert (router.health["r0"].state, router.health["r1"].state) == ("down", "healthy")
        assert clients[0].probe() is False and clients[1].probe() is True
    finally:
        S.close()


def test_bf16_handoff_record_crosses_and_disagg_pair_equals_unified(debug, reference):
    """A prefill replica's bf16 tier record crosses JSON and msgpack frames
    byte for byte (the JAX decoder reads bf16 arrays of the same bytes)
    and imports into a bf16 decode engine over the wire; a prefill/decode
    pair over the wire streams what a unified wire pair streams."""
    prompts, max_new, _ = reference
    model, _, port_params = debug
    bf16 = {k: (v.to(torch.bfloat16) if isinstance(v, torch.Tensor) else
                {kk: vv.to(torch.bfloat16) for kk, vv in v.items()})
            for k, v in port_params.items()}
    S = Stacks(PORT)
    try:
        scfg = serving.ServingConfig(token_budget=48, max_burst=4)
        pre = tfleet.GatewayReplica("p", port_factory(debug, True, torch.bfloat16, bf16),
                                    serving_config=scfg, role="prefill")
        dec = tfleet.GatewayReplica("d", port_factory(debug, True, torch.bfloat16, bf16),
                                    serving_config=scfg, role="decode")
        S.closers += [pre.shutdown, dec.shutdown]
        h = pre.submit(prompts[3], max_new_tokens=1)
        h.result(timeout=60)
        record = pre.take_handoff(h.uid)
        assert record is not None and record["entries"]
        carriers = [(c, t) for e in record["entries"] for c, t in e["handle"].items()
                    if isinstance(t, torch.Tensor)]
        assert carriers and all(t.dtype == torch.bfloat16 for _, t in carriers)
        for fmt in (ord("J"), ord("M")):
            frame = tcodec.encode_msg({"v": 1, "id": 1, "type": "ok", "result": record},
                                      prefer=fmt)
            back = tcodec.read_frame(io.BytesIO(frame))["result"]
            assert sanitize.wire_structural_equal(back, record)
            jback = jcodec.read_frame(io.BytesIO(frame))["result"]
            for e, je in zip(record["entries"], jback["entries"]):
                for c, t in e["handle"].items():
                    if isinstance(t, torch.Tensor):
                        assert je["handle"][c].dtype.name == "bfloat16"
                        assert je["handle"][c].tobytes() == \
                            t.reshape(-1).view(torch.uint8).numpy().tobytes()
        cli = S.client("d", S.server(dec).address, role="decode", timeout_s=60.0)
        assert cli.import_handoff(record) == len(record["entries"])
        assert dec.gateway.engine.kv_tier.imported_blocks == len(record["entries"])
        with pytest.raises(sanitize.KVTierCorruptionError):
            cli.import_handoff(tfleet.FaultyReplica._tear(record))
    finally:
        S.close()
    runs = []
    for roles in ((None, None), ("prefill", "decode")):
        S = Stacks(PORT)
        try:
            clients, reps = real_fleet(S, port_factory(debug, tiered=True), roles=roles)
            router = S.router(clients, disagg=roles[0] is not None, stream_token_timeout_s=60.0)
            streams = stream_all(router, prompts, max_new)
            snap = router.snapshot()
            runs.append((streams, snap["counters"]["completed"], snap["counters"]["failed"],
                         (snap.get("disagg") or {}).get("handoffs", {}).get("acked", 0),
                         reps[1].gateway.metrics.snapshot()["counters"].get(
                             "handoffs_imported", 0)))
        finally:
            S.close()
    assert runs[0][0] == runs[1][0]
    assert runs[0][1:] == (len(prompts), 0, 0, 0)
    assert runs[1][1:] == (len(prompts), 0, len(prompts), len(prompts))


def test_publication_ref_refresh_validates_in_the_server(debug, reference, tmp_path):
    """v1 published to disk crosses as a ``PublicationRef``: the server
    loads and verifies it and its replica adopts it (the probe's stream is
    a cold v1 engine's); a publication with a flipped payload byte is
    rejected typed in the server, nothing adopted."""
    prompts, _, _ = reference
    _, _, v0 = debug
    g = torch.Generator().manual_seed(1)

    def step(p):
        return p - 2e-1 * p * torch.randn(p.shape, generator=g)
    v1 = {k: (step(v) if isinstance(v, torch.Tensor) else {kk: step(vv) for kk, vv in v.items()})
          for k, v in v0.items()}
    pub = WeightPublisher(str(tmp_path / "pub"))
    pub.publish(v1, version=1)
    cold = DynamicSplitFuseScheduler(port_factory(debug, params=v1)(), token_budget=48,
                                     max_burst=4)
    cold.add_request(0, prompts[0], max_new_tokens=6)
    want_v1 = list(cold.run_to_completion()[0])
    S = Stacks(PORT)
    try:
        rep = tfleet.GatewayReplica("r0", port_factory(debug),
                                    serving_config=serving.ServingConfig(token_budget=48,
                                                                         max_burst=4))
        S.closers.append(rep.shutdown)
        cli = S.client("r0", S.server(rep).address, timeout_s=60.0)
        before = cli.submit(prompts[0], max_new_tokens=6).result(timeout=60)
        assert cli.refresh(twire.PublicationRef(str(tmp_path / "pub")), 1, timeout=60) == 1
        assert cli.weight_version() == 1 and rep.weight_version() == 1
        after = cli.submit(prompts[0], max_new_tokens=6).result(timeout=60)
        assert after == want_v1 != before
        pub.publish(v0, version=2)
        payload = tmp_path / "pub" / "v00000002" / "payload.bin"
        raw = bytearray(payload.read_bytes())
        raw[len(raw) // 2] ^= 0xFF
        payload.write_bytes(bytes(raw))
        with pytest.raises(sanitize.WeightPublicationError):
            cli.refresh(twire.PublicationRef(str(tmp_path / "pub")), 2, timeout=60)
        assert cli.weight_version() == 1
        assert cli.submit(prompts[0], max_new_tokens=6).result(timeout=60) == want_v1
    finally:
        S.close()
