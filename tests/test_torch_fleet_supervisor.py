"""The port's ``FleetSupervisor`` over real replica processes of the port's
entry point (``python -m deepspeed_tpu_torch.serving.fleet.wire.ds_replica``),
the counterpart of ``tests/unit/multiprocess/test_fleet_supervisor.py``.

- ``--factory`` workers: paced gateway replicas over the JAX test's
  deterministic ``FakeEngine`` (built by :func:`make_slow_replica` below,
  in the child). Spawn, announce and serve; a ``kill -9`` mid-stream
  fails over to the surviving process with a bit-identical stream; the
  killed replica is relaunched on the same address and serves again.
- Stub workers that import neither package: the hang watchdog escalates
  (SIGTERM → grace → SIGKILL) and relaunches; a crash loop exhausts its
  budget while its peer keeps running; the announce falls back to the
  assigned bind; ``stop`` gives every child its grace.
- One ``--config`` worker on the ``debug`` preset with ``"device":
  "cpu"``: its stream equals the in-process port engine's on the same
  seed-0 weights, and its clean stop prints its report line.
- ``test_replica_entry_imports_no_jax``: the entry's config path in a
  fresh interpreter leaves ``jax``, ``flax``, ``pydantic`` and
  ``deepspeed_tpu`` out of ``sys.modules``; without a GPU a config that
  names no device raises there.

``DS_SKIP_MULTIPROC=1`` skips the file, as it skips the JAX one.
"""

import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.serving.fleet import FleetConfig, FleetRouter
from deepspeed_tpu_torch.serving.fleet.wire import (FleetSupervisor, ReplicaProcSpec,
                                                    WireReplica)
from deepspeed_tpu_torch.serving.fleet.wire.supervisor import ENTRY_MODULE
from unit.common.fault_injection import kill_process
from unit.inference.serving.test_admission import FakeEngine

torch.set_num_threads(1)  # the suite runs in parallel worker processes

pytestmark = pytest.mark.skipif(os.environ.get("DS_SKIP_MULTIPROC") == "1",
                                reason="multiprocess tests disabled (DS_SKIP_MULTIPROC=1)")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")
CHILD_ENV = {"PYTHONPATH": f"{REPO}{os.pathsep}{TESTS}", "JAX_PLATFORMS": "cpu",
             "OMP_NUM_THREADS": "1"}


# ---------------------------------------------------------------------- child factories
class SlowFakeEngine(FakeEngine):
    """Paced generation so a kill -9 reliably lands mid-stream."""

    def put(self, uids, chunks, sample=None):
        time.sleep(0.05)
        return super().put(uids, chunks, sample=sample)


def make_slow_replica(name, role="unified"):
    """``--factory test_torch_fleet_supervisor:make_slow_replica``: a port
    gateway replica over the paced ``FakeEngine``."""
    from deepspeed_tpu_torch.serving import GatewayReplica, ServingConfig
    return GatewayReplica(name, lambda: SlowFakeEngine(),
                          serving_config=ServingConfig(max_burst=1), role=role)


def factory_spec(name):
    return ReplicaProcSpec(name, cmd=[sys.executable, "-m", ENTRY_MODULE, "--factory",
                                      "test_torch_fleet_supervisor:make_slow_replica"],
                           env=CHILD_ENV)


def wire_client(sup, name, **kw):
    kw.setdefault("timeout_s", 15.0)
    kw.setdefault("probe_timeout_s", 3.0)
    kw.setdefault("connect_timeout_s", 5.0)
    kw.setdefault("backoff_s", 0.05)
    return WireReplica(name, sup.address(name, timeout=60.0), **kw)


def wait_until(cond, timeout, what):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def log_lines(sup, name):
    with open(sup._children[name].log_file) as fd:
        return fd.read().splitlines()


# ---------------------------------------------------------------------- the entry point's fleet
class TestSupervisedFleet:
    """One two-replica fleet of the port's entry point, shared by the
    ordered tests below."""

    @pytest.fixture(scope="class")
    def fleet(self, tmp_path_factory):
        sup = FleetSupervisor([factory_spec("r0"), factory_spec("r1")],
                              run_dir=str(tmp_path_factory.mktemp("fleet")), max_restarts=3,
                              monitor_interval=0.1, watchdog_timeout=0, grace=5.0)
        sup.start()
        clients = {}
        try:
            for name in ("r0", "r1"):
                clients[name] = wire_client(sup, name)
                wait_until(clients[name].probe, 90.0, f"replica {name} to come up")
            yield sup, clients
        finally:
            for cli in clients.values():
                cli.close()
            sup.stop()

    def test_spawn_announce_and_serve(self, fleet):
        sup, clients = fleet
        for name in ("r0", "r1"):
            assert sup.running(name)
            assert sup.address(name) == f"unix:{os.path.join(sup.run_dir, name)}.sock"
            assert clients[name].alive() is True and clients[name].load() == 0
            assert any(f"[ds_replica] {name} (unified) serving on unix:" in line
                       for line in log_lines(sup, name))

    def test_kill9_midstream_fails_over_bit_identical(self, fleet):
        sup, _ = fleet
        router = FleetRouter([wire_client(sup, "r0"), wire_client(sup, "r1")],
                             config=FleetConfig(retry_backoff_s=0.05, heartbeat_interval_s=0.2,
                                                stream_token_timeout_s=20.0),
                             auto_heartbeat=False)
        try:
            h = router.submit([1, 2, 3], max_new_tokens=40)
            wait_until(lambda: len(h._collected) >= 2, 30.0, "the stream to start")
            victim = h.replica_trail[0]
            kill_process(sup.pid(victim))  # a real SIGKILL, mid-stream
            got = h.result(timeout=60)
            assert got == FakeEngine.expected_tokens(0, 3, 40)
            survivor = ({"r0", "r1"} - {victim}).pop()
            assert h.replica_trail == [victim, survivor] and h.status == "completed"
            c = router.snapshot()["counters"]
            assert c["failovers"] >= 1 and c["completed"] == 1 and c["failed"] == 0
        finally:
            router.shutdown()

    def test_killed_replica_relaunches_on_same_address(self, fleet):
        sup, clients = fleet
        killed = [n for n, s in sup.stats().items() if s["restarts"] > 0]
        assert len(killed) == 1, "the previous test killed one replica"
        name = killed[0]
        wait_until(lambda: sup.running(name), 60.0, f"{name} to be relaunched")
        cli = clients[name]
        wait_until(cli.probe, 90.0, f"{name} to serve again")
        h = cli.submit([1, 2, 3], max_new_tokens=4)  # a fresh gateway: uid 0 again
        assert h.result(timeout=30) == FakeEngine.expected_tokens(0, 3, 4)
        stats = sup.stats()[name]
        assert (stats["state"], stats["restarts"], stats["hangs"]) == ("running", 1, 0)


# ---------------------------------------------------------------------- stub workers
STUB = textwrap.dedent("""\
    import argparse, json, os, signal, sys, time

    p = argparse.ArgumentParser()
    p.add_argument("--name"); p.add_argument("--bind")
    p.add_argument("--heartbeat-file"); p.add_argument("--announce-file")
    p.add_argument("--beats", type=int, default=-1)
    p.add_argument("--exit-rc", type=int, default=None)
    p.add_argument("--ignore-term", action="store_true")
    args = p.parse_args()

    if args.exit_rc is not None:
        sys.exit(args.exit_rc)  # immediate-crash worker
    if args.ignore_term:
        signal.signal(signal.SIGTERM, signal.SIG_IGN)
    else:
        signal.signal(signal.SIGTERM, lambda *_: sys.exit(0))
    if args.announce_file:
        with open(args.announce_file, "w") as fd:
            fd.write(args.bind or "")
    n = 0
    while True:
        if args.beats < 0 or n < args.beats:
            n += 1
            tmp = args.heartbeat_file + ".tmp"
            with open(tmp, "w") as fd:
                json.dump({"beats": n, "time": time.time()}, fd)
            os.replace(tmp, args.heartbeat_file)
        time.sleep(0.1)
""")


@pytest.fixture
def stub(tmp_path):
    path = tmp_path / "stub_worker.py"
    path.write_text(STUB)

    def spec(name, *extra, **kw):
        return ReplicaProcSpec(name, cmd=[sys.executable, str(path)] + list(extra), **kw)
    return spec


def test_crash_loop_exhausts_budget_peers_unaffected(stub, tmp_path):
    sup = FleetSupervisor([stub("crasher", "--exit-rc", "3"), stub("steady")],
                          run_dir=str(tmp_path / "run"), max_restarts=2, failure_window=300.0,
                          monitor_interval=0.05, watchdog_timeout=0, grace=0.5)
    sup.start()
    try:
        wait_until(lambda: sup.stats()["crasher"]["state"] == "failed", 20.0,
                   "the crash loop to exhaust the budget")
        stats = sup.stats()
        assert stats["crasher"]["restarts"] == 2 and stats["crasher"]["failures_in_window"] == 3
        assert stats["steady"]["state"] == "running" and sup.running("steady")
        assert sup.restarts_total == 2
    finally:
        sup.stop()


def test_hang_watchdog_escalates_and_relaunches(stub, tmp_path):
    """Beats 3 times then stops, ignoring SIGTERM: each relaunch takes the
    full SIGTERM → grace → SIGKILL path; the second hang exhausts a budget
    of one restart."""
    sup = FleetSupervisor([stub("wedge", "--beats", "3", "--ignore-term")],
                          run_dir=str(tmp_path / "run"), max_restarts=1,
                          monitor_interval=0.05, watchdog_timeout=1.0, grace=0.3)
    sup.start()
    try:
        wait_until(lambda: sup.stats()["wedge"]["hangs"] >= 1, 30.0, "the watchdog to fire")
        wait_until(lambda: sup.stats()["wedge"]["restarts"] >= 1, 10.0, "the relaunch")
        wait_until(lambda: sup.stats()["wedge"]["state"] == "failed", 30.0,
                   "the second hang to exhaust the budget")
        assert sup.stats()["wedge"]["hangs"] == 2
        assert sup._children["wedge"].popen.returncode == -9  # SIGKILL, after the grace
    finally:
        sup.stop()


def test_sigkill_relaunches_and_stop_is_graceful(stub, tmp_path):
    """``kill`` (SIGKILL through the supervisor) relaunches the victim
    once; ``stop`` sends SIGTERM with the grace and both cooperative
    children exit on their own, well inside it."""
    sup = FleetSupervisor([stub("victim"), stub("b")], run_dir=str(tmp_path / "run"),
                          max_restarts=1, monitor_interval=0.05, watchdog_timeout=0, grace=5.0)
    sup.start()
    try:
        # the announce file is written after the SIGTERM handler is set
        ready = lambda: all(os.path.exists(sup._children[n].announce_file)  # noqa: E731
                            for n in ("victim", "b"))
        wait_until(ready, 20.0, "both workers ready")
        pid = sup.pid("victim")
        sup.kill("victim")
        wait_until(lambda: sup.running("victim") and sup.pid("victim") != pid, 20.0,
                   "the relaunch")
        assert sup.stats()["victim"]["restarts"] == 1
        wait_until(ready, 20.0, "the relaunched worker ready")
    finally:
        t0 = time.monotonic()
        sup.stop()
    assert time.monotonic() - t0 < 4.0  # SIGTERM honoured: nobody sat out the grace
    for name in ("victim", "b"):
        assert sup._children[name].popen.poll() == 0
        assert sup.stats()[name]["state"] == "stopped"


def test_announce_fallback_is_the_assigned_bind(stub, tmp_path):
    sup = FleetSupervisor([stub("mute", "--exit-rc", "0")], run_dir=str(tmp_path / "run"),
                          max_restarts=0, monitor_interval=0.05, watchdog_timeout=0, grace=0.5)
    sup.start()
    try:
        assert sup.address("mute", timeout=0.3) == f"unix:{tmp_path / 'run' / 'mute.sock'}"
    finally:
        sup.stop()


def test_child_env_puts_the_port_on_pythonpath(tmp_path):
    """A ``--config`` spec launches ``python -m <the port's entry>``, and
    every child's PYTHONPATH leads with the port package's parent."""
    probe = tmp_path / "env_probe.py"
    probe.write_text("import os, sys\n"
                     "ann = sys.argv[sys.argv.index('--announce-file') + 1]\n"
                     "open(ann, 'w').write(os.environ['PYTHONPATH'])\n")
    sup = FleetSupervisor([ReplicaProcSpec("e", cmd=[sys.executable, str(probe)],
                                           env={"PYTHONPATH": "/elsewhere"}),
                           ReplicaProcSpec("c", config={"preset": "debug"})],
                          run_dir=str(tmp_path / "run"), max_restarts=0, watchdog_timeout=0,
                          grace=0.5)
    cmd = sup._build_cmd(sup._children["c"])
    assert cmd[:3] == [sys.executable, "-m", ENTRY_MODULE] and "--config" in cmd
    with open(cmd[cmd.index("--config") + 1]) as fd:
        assert json.load(fd) == {"preset": "debug"}
    sup._children.pop("c")
    sup.start()
    try:
        assert sup.address("e", timeout=30.0) == os.pathsep.join([REPO, "/elsewhere"])
    finally:
        sup.stop()


# ---------------------------------------------------------------------- the config path
CONFIG = {"preset": "debug", "device": "cpu", "dtype": "float32",
          "engine": {"kv_block_size": 8,
                     "state_manager": {"max_ragged_batch_size": 48,
                                       "max_ragged_sequence_count": 4,
                                       "max_tracked_sequences": 4, "max_context": 32}},
          "serving": {"token_budget": 48, "max_burst": 4}}
PROMPTS = [np.random.RandomState(0).randint(0, 250, size=9 + i).astype(np.int32)
           for i in range(3)]


def in_process_streams():
    from deepspeed_tpu_torch.inference.v2 import (DSStateManagerConfig, DynamicSplitFuseScheduler,
                                                  InferenceEngineV2, RaggedInferenceEngineConfig)
    eng = InferenceEngineV2("debug", RaggedInferenceEngineConfig(
        kv_block_size=8, state_manager=DSStateManagerConfig(
            **CONFIG["engine"]["state_manager"])), dtype=torch.float32, device="cpu")
    sched = DynamicSplitFuseScheduler(eng, token_budget=48, max_burst=4)
    for i, p in enumerate(PROMPTS):
        sched.add_request(i, p, max_new_tokens=5)
    out = sched.run_to_completion()
    eng.destroy()
    return [list(out[i]) for i in range(len(PROMPTS))]


def test_config_worker_streams_equal_in_process_engine(tmp_path):
    """The entry point's ``--config`` path in its own process: the seed-0
    weights of ``InferenceEngineV2(params=None)``, served over the wire,
    stream what the in-process port engine streams; a clean stop prints
    the report line (no card on the CPU, no kernel launched)."""
    sup = FleetSupervisor([ReplicaProcSpec("cfg", config=dict(CONFIG), env=CHILD_ENV)],
                          run_dir=str(tmp_path / "run"), max_restarts=0, monitor_interval=0.1,
                          watchdog_timeout=0, grace=10.0)
    sup.start()
    cli = None
    try:
        cli = wire_client(sup, "cfg", timeout_s=60.0)
        wait_until(cli.probe, 90.0, "the config worker to come up")
        got = [cli.submit(p, max_new_tokens=5).result(timeout=60) for p in PROMPTS]
        assert got == in_process_streams()
        assert cli.stats()["restarts"] == 0
        cli.restart(timeout=30)  # a rebuild on the tree the process already holds
        assert cli.submit(PROMPTS[0], max_new_tokens=5).result(timeout=60) == got[0]
    finally:
        if cli is not None:
            cli.close()
        sup.stop()
    stop = [line for line in log_lines(sup, "cfg") if line.startswith("[ds_replica] cfg stopped ")]
    assert len(stop) == 1 and sup._children["cfg"].popen.returncode == 0
    report = json.loads(stop[0][len("[ds_replica] cfg stopped "):])
    assert report["card"] is None and report["device"] == "cpu" and report["engines"] == 2
    assert report["forwards"] > 0
    assert set(report["launches"]) == {"paged_decode_attention", "dense_matmul", "rms_norm_fwd"}
    assert not any(report["launches"].values())  # the CPU runs the plain versions


def test_replica_entry_imports_no_jax(tmp_path):
    """The entry point's config path, its server and a stream, in a fresh
    interpreter: nothing of JAX, flax, pydantic or the JAX package is
    imported on the way. Without a GPU, a config that names no device
    raises at start-up (the default is the GPU; no CPU fallback)."""
    no_device = tmp_path / "no_device.json"
    no_device.write_text(json.dumps({"preset": "debug"}))
    code = textwrap.dedent(f"""\
        import json, sys
        import torch
        from deepspeed_tpu_torch.serving.fleet.wire import ds_replica
        if not torch.cuda.is_available():
            try:
                ds_replica.main(["--config", "{no_device}", "--bind", "unix:{tmp_path}/x.sock"])
                raise SystemExit("the entry point started without a GPU")
            except RuntimeError as e:
                assert "no CUDA device" in str(e), e
        from deepspeed_tpu_torch.serving.fleet.wire import ReplicaServer, WireReplica
        cfg = json.loads({json.dumps(json.dumps(CONFIG))})
        rep, engines, device = ds_replica._build_from_config(cfg, "r", "unified")
        srv = ReplicaServer(rep, bind="unix:{tmp_path}/r.sock")
        cli = WireReplica("r", srv.start(), timeout_s=60)
        toks = cli.submit([1, 2, 3, 4, 5, 6, 7, 8, 9], max_new_tokens=3).result(timeout=60)
        cli.close(); srv.stop(); rep.shutdown()
        report = ds_replica.stop_report("r", "unified", engines, device)
        print(json.dumps([len(toks), report["forwards"],
                          sorted(m for m in ("jax", "jaxlib", "flax", "pydantic",
                                             "deepspeed_tpu", "ml_dtypes")
                                 if m in sys.modules)]))
        """)
    res = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env={**os.environ, "PYTHONPATH": REPO}, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    n, forwards, imported = json.loads(res.stdout.strip().splitlines()[-1])
    assert n == 3 and forwards > 0 and imported == []
