"""Shared process-supervision primitives.

A copy of ``deepspeed_tpu/utils/proc.py`` for the port (stdlib only, plus
the port's logger). The serving fleet's
:class:`~deepspeed_tpu_torch.serving.fleet.wire.FleetSupervisor` (one
replica server a process) leans on two pieces, kept here so the
escalation and arming semantics match the JAX package's elastic agent:

- :func:`terminate_with_grace` — the SIGTERM → grace wait → SIGKILL
  escalation (the worker's drain budget lives in the grace window);
- :class:`HeartbeatWatchdog` — hang detection over a heartbeat file.
  Progress is *any change* in the beaten payload, and the stall clock
  only arms once the worker has beaten at least once, so startup time
  (a replica drawing its weights and loading its kernels) is never
  mistaken for a hang.
"""

import json
import os
import signal
import subprocess
import time

from deepspeed_tpu_torch.utils.logging import logger


def killpg(child, sig=signal.SIGTERM):
    """Signal ``child``'s whole process group (the supervisors spawn
    with ``start_new_session=True``, so grandchildren die with the
    worker instead of leaking). Already-gone processes are a no-op."""
    if child is None or child.poll() is not None:
        return
    try:
        os.killpg(os.getpgid(child.pid), sig)
    except ProcessLookupError:
        pass


def terminate_with_grace(child, grace_s, reason="terminating",
                         log_prefix="[proc]", kill=None):
    """SIGTERM ``child``, wait up to ``grace_s`` for it to exit on its
    own (emergency checkpoint / connection drain), then SIGKILL.
    Returns the child's exit code. ``kill(sig)`` overrides how signals
    are delivered (default: :func:`killpg` on ``child``)."""
    if kill is None:
        kill = lambda sig: killpg(child, sig)  # noqa: E731
    logger.warning(f"{log_prefix} {reason}: SIGTERM with "
                   f"{float(grace_s):.0f}s grace")
    kill(signal.SIGTERM)
    try:
        return child.wait(timeout=max(float(grace_s), 0.05))
    except subprocess.TimeoutExpired:
        logger.error(f"{log_prefix} {reason}: grace expired, SIGKILL")
        kill(signal.SIGKILL)
        return child.wait()


def read_heartbeat_file(path):
    """Watchdog-side reader: parsed JSON payload, or None when the file
    is missing or torn (writers rename atomically, but a worker dying
    before its first write leaves nothing behind)."""
    if path is None:
        return None
    try:
        with open(path) as fd:
            return json.load(fd)
    except (OSError, ValueError):
        return None


class HeartbeatWatchdog:
    """Stall detection over one worker's heartbeat file.

    The arming rules (the JAX package's ``DSElasticAgent``'s):

    - no payload yet → **not armed**: a worker that never beat is
      starting up (or compiling), not hung;
    - payload changed since the last poll → progress, clock resets;
    - payload unchanged for more than ``timeout_s`` after the first
      observed beat → **stalled**.

    Call :meth:`reset` when the worker is (re)launched so a previous
    incarnation's beats cannot arm the clock against the replacement;
    ``read`` overrides the file reader."""

    def __init__(self, path, timeout_s, read=None):
        self.path = path
        self.timeout_s = float(timeout_s)
        self._read = read or read_heartbeat_file
        self._progress_t = None
        self._payload = None

    def reset(self):
        self._progress_t = None
        self._payload = None

    @property
    def armed(self):
        """True once the worker has beaten at least once."""
        return self._payload is not None

    def stalled(self, now=None):
        """Poll the heartbeat file; True when the worker stopped making
        progress for longer than ``timeout_s``."""
        if self.timeout_s <= 0 or self.path is None:
            return False
        payload = self._read(self.path)
        if now is None:
            now = time.monotonic()
        if payload is None:
            return False  # not armed yet
        if payload != self._payload:
            self._progress_t, self._payload = now, payload
            return False
        if self._progress_t is not None and \
                now - self._progress_t > self.timeout_s:
            return True
        if self._progress_t is None:
            self._progress_t = now
        return False


class HeartbeatFileWriter:
    """Worker-side beater for supervisors that watch with
    :class:`HeartbeatWatchdog`: atomically rewrites ``path`` with a
    monotonically growing payload so every ``beat()`` is progress (a
    serving replica server beats on a timer of its own)."""

    def __init__(self, path):
        self.path = path
        self._beats = 0

    def beat(self, extra=None):
        if self.path is None:
            return
        self._beats += 1
        payload = {"beats": self._beats, "time": time.time()}
        if extra:
            payload.update(extra)
        tmp = f"{self.path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as fd:
                json.dump(payload, fd)
            os.replace(tmp, self.path)
        except OSError:
            pass  # heartbeat is best-effort; the watchdog tolerates gaps
