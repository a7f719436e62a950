"""Process supervision for wire-transport replica fleets.

Port of ``deepspeed_tpu/serving/fleet/wire/supervisor.py``.
:class:`FleetSupervisor` spawns each replica server in its own process
group, monitors it, and relaunches it on failure:

- **crashes** (non-zero exit, ``kill -9``): relaunch, charged to a
  per-replica failure budget (``max_restarts`` within
  ``failure_window`` seconds); a steady crash loop marks the replica
  ``failed`` and stops relaunching — the router's health layer keeps
  it DOWN and traffic flows to its peers;
- **hangs**: each replica server beats a heartbeat file; no payload
  progress for ``watchdog_timeout`` seconds → SIGTERM → grace →
  SIGKILL → relaunch (the escalation in
  ``deepspeed_tpu_torch/utils/proc.py``, the JAX elastic agent's clock
  and arming rules);
- **shutdown**: every child gets the SIGTERM-with-grace budget to
  drain before SIGKILL.

Workers speak the replica entry point's argv contract (the JAX
package's ``bin/ds_replica``'s): the supervisor appends
``--name/--bind/--heartbeat-file/--announce-file`` to the spec's
command, binds each replica to a unix socket under the run directory
(stable across relaunches, so ``WireReplica`` reconnect logic needs no
re-discovery), and reads the announce file for the actually-bound
address. A spec given a ``config`` launches the port's own entry point,
``python -m deepspeed_tpu_torch.serving.fleet.wire.ds_replica``, and
every child finds the port's package on its ``PYTHONPATH``."""

import os
import signal
import subprocess
import sys
import threading
import time

from deepspeed_tpu_torch.utils import proc
from deepspeed_tpu_torch.utils.env_registry import env_int
from deepspeed_tpu_torch.utils.logging import logger
from deepspeed_tpu_torch.utils.sanitize import tracked_lock

# the directory holding the port's package: every child gets it on its
# PYTHONPATH, so ``-m deepspeed_tpu_torch...`` resolves from any cwd
_PKG_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))))
ENTRY_MODULE = "deepspeed_tpu_torch.serving.fleet.wire.ds_replica"


class ReplicaProcSpec:
    """How to launch one replica process.

    ``cmd`` is the worker argv (it must accept the supervisor-appended
    ``--name/--bind/--heartbeat-file/--announce-file`` flags).
    ``config`` instead launches the port's replica entry point with
    ``--config <json>`` (a dict serialized to the run directory).
    ``bind`` overrides the default unix socket."""

    def __init__(self, name, cmd=None, config=None, role="unified",
                 bind=None, env=None):
        if (cmd is None) == (config is None):
            raise ValueError(
                f"replica {name!r}: exactly one of cmd/config required")
        self.name = str(name)
        self.cmd = list(cmd) if cmd is not None else None
        self.config = config
        self.role = role
        self.bind = bind
        self.env = dict(env or {})


class _Child:
    """One supervised replica's mutable state (owned by the supervisor
    lock)."""

    def __init__(self, spec, bind, heartbeat_file, announce_file,
                 log_file):
        self.spec = spec
        self.bind = bind
        self.heartbeat_file = heartbeat_file
        self.announce_file = announce_file
        self.log_file = log_file
        self.popen = None
        self.watchdog = None
        self.failures = []  # monotonic timestamps inside the window
        self.restarts = 0
        self.hangs = 0
        self.state = "new"  # new | running | failed | stopped


class FleetSupervisor:
    """Spawn, watch and relaunch a fleet of replica server processes."""

    def __init__(self, specs, run_dir, max_restarts=3,
                 failure_window=300.0, monitor_interval=0.25,
                 watchdog_timeout=None, grace=None, python=None):
        self.run_dir = str(run_dir)
        os.makedirs(self.run_dir, exist_ok=True)
        self.max_restarts = int(max_restarts)
        self.failure_window = float(failure_window)
        self.monitor_interval = float(monitor_interval)
        self.watchdog_timeout = float(
            watchdog_timeout if watchdog_timeout is not None
            else env_int("DS_WATCHDOG_TIMEOUT"))
        self.grace = float(grace if grace is not None
                           else env_int("DS_PREEMPT_GRACE_S"))
        self.python = python or sys.executable
        self._lock = tracked_lock(threading.Lock(), "FleetSupervisor._lock")
        self._children = {}
        self._stopped = False
        self._monitor = None
        self.restarts_total = 0
        for spec in specs:
            if not isinstance(spec, ReplicaProcSpec):
                spec = ReplicaProcSpec(**spec)
            if spec.name in self._children:
                raise ValueError(f"duplicate replica name {spec.name!r}")
            base = os.path.join(self.run_dir, spec.name)
            bind = spec.bind or f"unix:{base}.sock"
            self._children[spec.name] = _Child(
                spec, bind, f"{base}.heartbeat", f"{base}.addr",
                f"{base}.log")

    # ------------------------------------------------------------- spawning
    def _build_cmd(self, child):
        spec = child.spec
        if spec.cmd is not None:
            cmd = list(spec.cmd)
        else:
            cfg_path = os.path.join(self.run_dir,
                                    f"{spec.name}.config.json")
            if not os.path.exists(cfg_path):
                import json
                with open(cfg_path, "w") as fd:
                    json.dump(spec.config, fd)
            cmd = [self.python, "-m", ENTRY_MODULE,
                   "--config", cfg_path, "--role", spec.role]
        cmd += ["--name", spec.name, "--bind", child.bind,
                "--heartbeat-file", child.heartbeat_file,
                "--announce-file", child.announce_file]
        return cmd

    def _spawn_locked(self, child):
        for stale in (child.heartbeat_file, child.announce_file):
            # a previous incarnation's beat must not arm the watchdog
            # against (or announce for) a still-starting replacement
            try:
                os.remove(stale)
            except OSError:
                pass
        env = dict(os.environ)
        env.update(child.spec.env)
        path = [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
        if _PKG_PARENT not in path:
            env["PYTHONPATH"] = os.pathsep.join([_PKG_PARENT] + path)
        cmd = self._build_cmd(child)
        log_fd = open(child.log_file, "ab")
        try:
            child.popen = subprocess.Popen(cmd, env=env,
                                           start_new_session=True,
                                           stdout=log_fd, stderr=log_fd)
        finally:
            log_fd.close()
        child.watchdog = proc.HeartbeatWatchdog(child.heartbeat_file,
                                               self.watchdog_timeout)
        child.state = "running"
        logger.info(f"[fleet-supervisor] launched replica "
                    f"{child.spec.name} (pid {child.popen.pid}, "
                    f"restart {child.restarts}/{self.max_restarts}) on "
                    f"{child.bind}")

    def start(self):
        with self._lock:
            if self._stopped:
                raise RuntimeError("supervisor already stopped")
            for child in self._children.values():
                if child.state == "new":
                    self._spawn_locked(child)
            if self._monitor is None:
                self._monitor = threading.Thread(
                    target=self._monitor_loop, name="ds-fleet-supervisor",
                    daemon=True)
                monitor = self._monitor
        monitor.start()
        return self

    # ------------------------------------------------------------ monitoring
    def _monitor_loop(self):
        while not self._stopped:
            time.sleep(self.monitor_interval)
            with self._lock:
                children = list(self._children.values())
            for child in children:
                if self._stopped or child.state != "running":
                    continue
                popen = child.popen
                rc = popen.poll() if popen is not None else None
                hang = False
                if rc is None and self.watchdog_timeout > 0:
                    hang = child.watchdog.stalled()
                    if hang:
                        proc.terminate_with_grace(
                            popen, self.grace,
                            f"replica {child.spec.name} hung (no "
                            f"heartbeat progress in "
                            f"{self.watchdog_timeout:.0f}s)",
                            log_prefix="[fleet-supervisor]")
                        rc = popen.returncode
                if rc is None:
                    continue
                self._on_exit(child, rc, hang)

    def _on_exit(self, child, rc, hang):
        if rc is not None and rc < 0:
            rc = 128 - rc  # died by signal N → shell convention
        now = time.monotonic()
        with self._lock:
            if self._stopped or child.state != "running":
                return
            if hang:
                child.hangs += 1
            child.failures = [t for t in child.failures
                              if now - t < self.failure_window] + [now]
            over_budget = len(child.failures) > self.max_restarts
            if over_budget:
                child.state = "failed"
            else:
                child.restarts += 1
                self.restarts_total += 1
        kind = "hung" if hang else "died"
        if over_budget:
            logger.error(f"[fleet-supervisor] replica {child.spec.name} "
                         f"{kind} rc={rc}: {len(child.failures)} failures "
                         f"within {self.failure_window:.0f}s — giving up "
                         f"(replica stays down; peers keep serving)")
            return
        logger.warning(f"[fleet-supervisor] replica {child.spec.name} "
                       f"{kind} rc={rc}; relaunching "
                       f"({len(child.failures)}/{self.max_restarts} "
                       f"recent failures)")
        with self._lock:
            if not self._stopped and child.state == "running":
                self._spawn_locked(child)

    # -------------------------------------------------------------- queries
    def address(self, name, timeout=5.0):
        """The replica's announced wire address (waits for the announce
        file on first launch; falls back to the assigned bind)."""
        child = self._children[name]
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            try:
                with open(child.announce_file) as fd:
                    text = fd.read().strip()
                if text:
                    return text
            except OSError:
                pass
            time.sleep(0.01)
        return child.bind

    def pid(self, name):
        child = self._children[name]
        return child.popen.pid if child.popen is not None else None

    def running(self, name):
        child = self._children[name]
        return (child.state == "running" and child.popen is not None
                and child.popen.poll() is None)

    def kill(self, name, sig=signal.SIGKILL):
        """Hard-kill one replica process (chaos testing / bench kill -9
        injection). The monitor loop sees the death and relaunches it
        inside the failure budget."""
        child = self._children[name]
        proc.killpg(child.popen, sig)

    def stats(self):
        with self._lock:
            return {name: {"state": c.state, "restarts": c.restarts,
                           "hangs": c.hangs,
                           "pid": c.popen.pid if c.popen else None,
                           "failures_in_window": len(c.failures)}
                    for name, c in self._children.items()}

    def wait(self, timeout=None):
        """Block until every replica left the running state (tests)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while any(c.state == "running"
                  for c in self._children.values()):
            if deadline is not None and time.monotonic() > deadline:
                return False
            time.sleep(self.monitor_interval)
        return True

    # ------------------------------------------------------------- teardown
    def stop(self):
        """Graceful fleet stop: SIGTERM with the grace budget, then
        SIGKILL, every replica."""
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
            children = list(self._children.values())
        monitor = self._monitor
        if monitor is not None and monitor.is_alive() and \
                monitor is not threading.current_thread():
            monitor.join(timeout=self.monitor_interval * 4 + 1.0)
        for child in children:
            if child.popen is not None and child.popen.poll() is None:
                proc.terminate_with_grace(
                    child.popen, self.grace,
                    f"stopping replica {child.spec.name}",
                    log_prefix="[fleet-supervisor]")
            child.state = "stopped"
