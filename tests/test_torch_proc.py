"""The port's process-supervision primitives
(``deepspeed_tpu_torch/utils/proc.py``) against the JAX package's.

- ``HeartbeatWatchdog``: the cases of ``tests/unit/common/test_proc.py``'s
  ``TestHeartbeatWatchdog``, each as a script of injected heartbeat reads
  and clock readings fed to both packages' watchdogs; every ``armed`` and
  ``stalled()`` answer is compared. The file-backed cases (the writer,
  torn files) run through both packages too.
- ``terminate_with_grace`` and ``killpg``: the cases of
  ``TestTerminateWithGrace`` on real child processes, each through both
  packages. A child says it is ready by writing a file once its SIGTERM
  handler is installed, and the test waits for that file, never for a
  fixed sleep (the JAX agent test that sleeps a fixed second before its
  SIGTERM fails when its worker imports slowly). Every wait has a
  timeout of its own.
"""

import os
import signal
import subprocess
import sys
import time
import types

import pytest
import torch

from deepspeed_tpu.utils import proc as jproc
from deepspeed_tpu_torch.utils import proc as tproc

torch.set_num_threads(1)  # the suite runs in parallel worker processes

PACKAGES = [types.SimpleNamespace(proc=jproc, name="jax"),
            types.SimpleNamespace(proc=tproc, name="port")]


# ---------------------------------------------------------------------- watchdog
SCRIPTS = {  # name: (timeout_s, [(payload the read returns, now)])
    "not_armed_before_first_beat": (1.0, [(None, 0.0), (None, 100.0), (None, 1e6)]),
    "progress_resets_clock_and_stall_fires": (5.0, [
        ({"beats": 1}, 0.0), ({"beats": 1}, 4.0), ({"beats": 2}, 6.0), ({"beats": 2}, 10.0),
        ({"beats": 2}, 11.5), ({"beats": 2}, 12.0)]),
    "exactly_at_timeout_is_not_stalled": (2.0, [
        ({"beats": 1}, 0.0), ({"beats": 1}, 2.0), ({"beats": 1}, 2.0001)]),
    "torn_read_in_the_middle": (1.0, [
        ({"beats": 1}, 0.0), (None, 5.0), ({"beats": 1}, 5.5), ({"beats": 3}, 6.0),
        (None, 8.0), ({"beats": 3}, 8.1)]),
    "zero_timeout_disables": (0.0, [({"beats": 1}, 0.0), ({"beats": 1}, 1e9)]),
    "negative_timeout_disables": (-1.0, [({"beats": 1}, 0.0), ({"beats": 1}, 1e9)]),
    "any_payload_change_is_progress": (1.0, [
        ({"step": 1, "time": 1.0}, 0.0), ({"step": 1, "time": 2.0}, 0.9),
        ({"step": 1, "time": 2.0}, 1.5), ({"step": 1, "time": 2.0}, 2.0)]),
    "reset_forgets_previous_incarnation": (1.0, [
        ({"beats": 1}, 0.0), ("reset", None), (None, 50.0), ({"beats": 1}, 51.0),
        ({"beats": 1}, 51.5), ({"beats": 1}, 52.5)]),
}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_watchdog_lockstep(script):
    """The same reads and clock through both watchdogs: equal answers
    after every poll."""
    timeout, steps = SCRIPTS[script]
    out = {}
    for P in PACKAGES:
        feed = []
        dog = P.proc.HeartbeatWatchdog("hb.json", timeout, read=lambda path: feed.pop(0))
        seen = [dog.armed]
        for payload, now in steps:
            if payload == "reset":
                dog.reset()
                seen.append(("reset", dog.armed))
                continue
            feed.append(payload)
            stalled = dog.stalled(now=now)
            seen.append((stalled, dog.armed, not feed))  # did the poll read the file
            feed.clear()
        out[P.name] = seen
    assert out["port"] == out["jax"]
    answers = [s[0] for s in out["port"][1:] if s[0] != "reset"]
    if script == "progress_resets_clock_and_stall_fires":
        assert answers == [False, False, False, False, True, True]
    if script.endswith("disables") or script == "not_armed_before_first_beat":
        assert not any(answers)


def _disabled_read_is_skipped(P):
    reads = []
    dog = P.proc.HeartbeatWatchdog(None, 5.0, read=lambda p: reads.append(p))
    dog2 = P.proc.HeartbeatWatchdog("x", 0, read=lambda p: reads.append(p))
    return dog.stalled(now=1.0), dog2.stalled(now=1.0), reads


def test_disabled_watchdog_reads_nothing():
    assert _disabled_read_is_skipped(PACKAGES[0]) == _disabled_read_is_skipped(PACKAGES[1]) \
        == (False, False, [])


def test_writer_and_file_reads_lockstep(tmp_path):
    """Each package's writer beats a file the other's reader and watchdog
    read alike; a torn file reads as absent; no temporary file is left."""
    out = {}
    for W in PACKAGES:
        path = str(tmp_path / f"hb_{W.name}.json")
        writer = W.proc.HeartbeatFileWriter(path)
        seen = []
        for P in PACKAGES:
            dog = P.proc.HeartbeatWatchdog(path, timeout_s=5.0)
            writer.beat({"name": "r0"})
            first = P.proc.read_heartbeat_file(path)
            seen.append((dog.stalled(now=0.0), dog.armed, dog.stalled(now=4.0)))
            writer.beat({"name": "r0"})
            second = P.proc.read_heartbeat_file(path)
            seen.append((dog.stalled(now=6.0), dog.stalled(now=10.0), dog.stalled(now=11.5)))
            assert first["name"] == "r0" and second["beats"] == first["beats"] + 1
            assert first != second
        assert not [p for p in os.listdir(tmp_path) if ".tmp." in p]
        assert W.proc.HeartbeatFileWriter(None).beat() is None
        out[W.name] = seen
    assert out["port"] == out["jax"]
    assert out["port"][1] == (False, False, True)
    torn = tmp_path / "torn.json"
    torn.write_text('{"beats": 3,')
    for P in PACKAGES:
        assert P.proc.read_heartbeat_file(str(torn)) is None
        assert P.proc.read_heartbeat_file(None) is None
        assert P.proc.read_heartbeat_file(str(tmp_path / "missing")) is None
        assert P.proc.HeartbeatWatchdog(str(torn), 1.0).stalled(now=100.0) is False


# ---------------------------------------------------------------------- escalation
CHILD = """
import signal, sys, time
mode, ready = sys.argv[1], sys.argv[2]
if mode == "cooperative":
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(0))
elif mode == "ignore":
    signal.signal(signal.SIGTERM, signal.SIG_IGN)
open(ready, "w").close()
time.sleep(60)
"""


def spawn_ready(tmp_path, mode):
    """A child in its own session, returned once it has written its
    ready file (after setting its SIGTERM disposition)."""
    ready = tmp_path / f"ready_{mode}_{time.monotonic_ns()}"
    child = subprocess.Popen([sys.executable, "-c", CHILD, mode, str(ready)],
                             start_new_session=True)
    deadline = time.monotonic() + 30.0
    while not ready.exists():
        if child.poll() is not None or time.monotonic() > deadline:
            child.kill()
            child.wait(timeout=10)
            raise AssertionError(f"the {mode} child never became ready")
        time.sleep(0.005)
    return child


def reap(child):
    if child.poll() is None:
        child.kill()
    child.wait(timeout=10)


@pytest.mark.parametrize("P", PACKAGES, ids=lambda P: P.name)
def test_sigterm_exits_within_grace(P, tmp_path):
    child = spawn_ready(tmp_path, "cooperative")
    try:
        t0 = time.monotonic()
        rc = P.proc.terminate_with_grace(child, grace_s=10.0)
        assert rc == 0 and child.poll() == 0  # its own exit, no SIGKILL
        assert time.monotonic() - t0 < 5.0  # did not sit out the grace
    finally:
        reap(child)


@pytest.mark.parametrize("P", PACKAGES, ids=lambda P: P.name)
def test_grace_expiry_escalates_to_sigkill(P, tmp_path):
    child = spawn_ready(tmp_path, "ignore")
    try:
        t0 = time.monotonic()
        rc = P.proc.terminate_with_grace(child, grace_s=0.3)
        assert rc == -signal.SIGKILL and child.poll() is not None
        assert 0.3 <= time.monotonic() - t0 < 10.0
    finally:
        reap(child)


@pytest.mark.parametrize("P", PACKAGES, ids=lambda P: P.name)
def test_custom_kill_hook_is_used(P, tmp_path):
    child = spawn_ready(tmp_path, "default")
    sigs = []

    def kill(sig):
        sigs.append(sig)
        child.send_signal(sig)

    try:
        rc = P.proc.terminate_with_grace(child, grace_s=5.0, kill=kill)
        assert rc == -signal.SIGTERM and sigs == [signal.SIGTERM]
    finally:
        reap(child)


@pytest.mark.parametrize("P", PACKAGES, ids=lambda P: P.name)
def test_killpg_reaches_the_group_and_is_a_noop_after_exit(P, tmp_path):
    child = spawn_ready(tmp_path, "ignore")
    try:
        P.proc.killpg(child, signal.SIGKILL)
        assert child.wait(timeout=10) == -signal.SIGKILL
        P.proc.killpg(child, signal.SIGKILL)  # exited: no-op, no raise
        P.proc.killpg(None, signal.SIGKILL)
    finally:
        reap(child)


def test_port_module_is_stdlib_only():
    """``utils/proc.py`` imports the stdlib and the port's logger only."""
    import ast
    tree = ast.parse(open(tproc.__file__).read())
    names = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    names |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    assert names == {"json", "os", "signal", "subprocess", "time",
                     "deepspeed_tpu_torch.utils.logging"}
