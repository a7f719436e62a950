"""Router-side client of the fleet wire transport.

Port of ``deepspeed_tpu/serving/fleet/wire/client.py``.
:class:`WireReplica` implements the full :class:`Replica` interface
over a socket, so :class:`FleetRouter`, :class:`ReplicaHealth`,
:class:`HandoffManager` and :class:`FleetRefreshController` run
unchanged against a replica that lives in another OS process:

- one multiplexed connection, a reader thread demuxing reply frames
  into per-request queues (the router's per-request relay threads each
  block on their own queue, never on the socket);
- deadline-bounded I/O: every unary call is bounded by
  ``DS_WIRE_TIMEOUT_S`` (probes by the shorter ``probe_timeout_s`` so
  a blackholed socket cannot wedge the heartbeat thread), and a blown
  deadline surfaces as a typed retryable :class:`WireTimeoutError`;
- reconnect-with-backoff: a dead/unreachable server fails calls fast
  with :class:`ReplicaDiedError` while the backoff window is open and
  transparently reconnects after it — the health layer's
  DOWN/half-open probing drives recovery exactly as in-process;
- streaming handles preserve the :class:`RequestHandle` contract the
  router's failover logic keys on: ``tokens(timeout=...)`` raises
  ``queue.Empty`` on a per-token stall and the decoded terminal
  :class:`ServingError` on abnormal endings, and ``.uid`` is the
  *remote gateway-local* uid so disagg handoff claims work across the
  boundary.
"""

import queue as _queue
import socket as _socket
import threading
import time

import numpy as np

from deepspeed_tpu_torch.serving.fleet.replica import Replica, ReplicaDiedError
from deepspeed_tpu_torch.serving.fleet.wire import address as _address
from deepspeed_tpu_torch.serving.fleet.wire.codec import WIRE_VERSION, read_frame, write_frame
from deepspeed_tpu_torch.serving.fleet.wire.errors import (WireProtocolError, WireTimeoutError,
                                                           decode_error, encode_error)
from deepspeed_tpu_torch.utils.env_registry import env_int
from deepspeed_tpu_torch.utils.logging import logger
from deepspeed_tpu_torch.utils.sanitize import tracked_lock


class PublicationRef:
    """Ship a weight refresh as a *reference* to an on-disk publication
    instead of an inline tree: the adopting process re-validates it
    through ``WeightPublisher.load`` (manifest, chain, payload hashes)
    before anything is adopted. ``expect_chain`` pins the lineage
    (``False`` = don't check, ``None``/str = require that parent)."""

    def __init__(self, publish_dir, expect_chain=False):
        self.publish_dir = str(publish_dir)
        self.expect_chain = expect_chain


class WireReplica(Replica):
    """A remote replica process behind the :class:`Replica` seam."""

    def __init__(self, name, address, role="unified", timeout_s=None,
                 probe_timeout_s=2.0, connect_timeout_s=1.0,
                 backoff_s=0.05, max_backoff_s=2.0):
        self.name = name
        self.address = str(address)
        self.role = role
        if timeout_s is None:
            timeout_s = env_int("DS_WIRE_TIMEOUT_S")
        self.timeout_s = float(timeout_s) if timeout_s else 30.0
        self.probe_timeout_s = min(float(probe_timeout_s), self.timeout_s)
        self.connect_timeout_s = float(connect_timeout_s)
        self._base_backoff = float(backoff_s)
        self._max_backoff = float(max_backoff_s)
        self._lock = tracked_lock(threading.Lock(), "WireReplica._lock")
        self._sock = None
        self._wfile = None
        self._wlock = threading.Lock()  # frame-write atomicity only
        self._reader = None
        self._pending = {}  # rid -> reply queue
        self._next_rid = 1
        self._backoff = self._base_backoff
        self._retry_at = 0.0  # monotonic time the next connect may run
        self._closed = False
        self.reconnects = 0

    # ---------------------------------------------------------- connection
    def _ensure_conn(self):
        """Return the write file of a live connection, (re)connecting
        with backoff. Fails fast (typed, retryable) while the backoff
        window from the previous failed connect is still open."""
        with self._lock:
            if self._closed:
                raise ReplicaDiedError(
                    f"replica {self.name}: client closed")
            if self._wfile is not None:
                return self._wfile
            if time.monotonic() < self._retry_at:
                raise ReplicaDiedError(
                    f"replica {self.name} at {self.address} is "
                    f"unreachable (reconnect backing off)")
        try:  # connect OUTSIDE the lock — it blocks
            sock = _address.connect(self.address,
                                    timeout=self.connect_timeout_s)
        except OSError as e:
            with self._lock:
                self._retry_at = time.monotonic() + self._backoff
                self._backoff = min(self._backoff * 2, self._max_backoff)
            raise ReplicaDiedError(
                f"replica {self.name} at {self.address} is "
                f"unreachable: {e}")
        rfile = sock.makefile("rb")
        wfile = sock.makefile("wb")
        with self._lock:
            if self._closed or self._wfile is not None:
                # lost the install race (or closed meanwhile)
                installed = self._wfile
                try:
                    sock.close()
                except OSError:
                    pass
                if self._closed or installed is None:
                    raise ReplicaDiedError(
                        f"replica {self.name}: client closed")
                return installed
            self._sock = sock
            self._wfile = wfile
            self._backoff = self._base_backoff
            self._retry_at = 0.0
            self.reconnects += 1
            reader = threading.Thread(
                target=self._read_loop, args=(sock, rfile),
                name=f"ds-wire-reader-{self.name}", daemon=True)
            self._reader = reader
        reader.start()
        return wfile

    def _read_loop(self, sock, rfile):
        while True:
            try:
                msg = read_frame(rfile)
            except (WireProtocolError, OSError, ValueError) as e:
                err = e if isinstance(e, WireProtocolError) else \
                    ReplicaDiedError(
                        f"replica {self.name}: connection lost: {e}")
                self._drop_conn(sock, err)
                return
            if msg is None:
                self._drop_conn(sock, ReplicaDiedError(
                    f"replica {self.name}: connection closed by peer"))
                return
            with self._lock:
                q = self._pending.get(msg.get("id"))
            if q is not None:
                q.put(msg)

    def _drop_conn(self, sock, err):
        """Tear down the (possibly already-replaced) connection and fail
        every pending call with a typed error."""
        with self._lock:
            if self._sock is not sock:
                return  # a newer connection already replaced this one
            self._sock = None
            self._wfile = None
            self._reader = None
            waiters = list(self._pending.values())
            self._pending.clear()
        try:  # shutdown actually interrupts a reader blocked in recv
            sock.shutdown(_socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            sock.close()
        except OSError:
            pass
        down = {"v": WIRE_VERSION, "type": "conn_dead", "error_obj": err}
        for q in waiters:
            q.put(down)

    def close(self):
        """Tear down the client side (does not touch the server)."""
        with self._lock:
            self._closed = True
            sock = self._sock
        if sock is not None:
            self._drop_conn(sock, ReplicaDiedError(
                f"replica {self.name}: client closed"))

    # --------------------------------------------------------------- calls
    def _register(self):
        q = _queue.Queue()
        with self._lock:
            rid = self._next_rid
            self._next_rid += 1
            self._pending[rid] = q
        return rid, q

    def _release(self, rid):
        with self._lock:
            self._pending.pop(rid, None)

    def _send(self, rid, op, args):
        wfile = self._ensure_conn()
        msg = {"v": WIRE_VERSION, "id": rid, "type": "req", "op": op,
               "args": args}
        try:
            write_frame(wfile, msg, lock=self._wlock)
        except (OSError, ValueError) as e:
            with self._lock:
                sock = self._sock
            if sock is not None:
                self._drop_conn(sock, ReplicaDiedError(
                    f"replica {self.name}: send failed: {e}"))
            raise ReplicaDiedError(
                f"replica {self.name}: send failed: {e}")

    @staticmethod
    def _reply(q, timeout, op, name):
        try:
            msg = q.get(timeout=timeout)
        except _queue.Empty:
            raise WireTimeoutError(
                f"replica {name}: {op} got no reply in {timeout:.1f}s",
                op=op, timeout_s=timeout)
        if msg.get("type") == "conn_dead":
            raise msg["error_obj"]
        if msg.get("type") == "err":
            raise decode_error(msg.get("error") or {})
        return msg

    def _call(self, op, args=None, timeout=None):
        """One unary round-trip → decoded result; typed raises."""
        timeout = self.timeout_s if timeout is None else timeout
        rid, q = self._register()
        try:
            self._send(rid, op, args or {})
            msg = self._reply(q, timeout, op, self.name)
            return msg.get("result")
        finally:
            self._release(rid)

    # ------------------------------------------------------------ routing API
    def submit(self, prompt_tokens, max_new_tokens=None, priority=None,
               deadline_ms=None, adapter_id=None, sample=None, schema=None):
        prompt = [int(t) for t in np.atleast_1d(np.asarray(prompt_tokens))]
        args = {"prompt": prompt, "max_new_tokens": max_new_tokens,
                "priority": priority, "deadline_ms": deadline_ms,
                "adapter_id": adapter_id, "sample": sample,
                "schema": schema}
        rid, q = self._register()
        try:
            self._send(rid, "submit", args)
            msg = self._reply(q, self.timeout_s, "submit", self.name)
        except BaseException:
            self._release(rid)
            raise
        uid = msg["result"]["uid"]
        return _WireHandle(self, rid, q, uid)

    def has_adapter(self, adapter_id):
        try:
            return bool(self._call("has_adapter",
                                   {"adapter_id": adapter_id},
                                   timeout=self.probe_timeout_s))
        except Exception:
            return False  # unreachable replica is not a placement target

    def prefetch_adapter(self, adapter_id):
        try:
            self._call("prefetch_adapter", {"adapter_id": adapter_id})
        except Exception:
            pass  # warm-up is best-effort

    def take_handoff(self, uid):
        record = self._call("take_handoff", {"uid": uid})
        if isinstance(record, dict) and isinstance(
                record.get("entries"), list):
            record["entries"] = [
                dict(e, tokens=tuple(e["tokens"]))
                if isinstance(e, dict) and isinstance(e.get("tokens"), list)
                else e
                for e in record["entries"]]
        return record

    def import_handoff(self, record):
        return int(self._call("import_handoff", {"record": record}) or 0)

    def prefix_match_len(self, prompt_tokens):
        try:
            prompt = [int(t) for t in
                      np.atleast_1d(np.asarray(prompt_tokens))]
            return int(self._call("prefix_match_len", {"prompt": prompt},
                                  timeout=self.probe_timeout_s))
        except Exception:
            return 0  # an unreachable replica stops being a prefix target

    def load(self):
        try:
            return self._call("load", timeout=self.probe_timeout_s)
        except Exception:
            # unreachable → worst possible placement score; the health
            # layer decides whether it is actually DOWN
            return float("inf")

    def alive(self):
        try:
            return bool(self._call("alive", timeout=self.probe_timeout_s))
        except Exception:
            return False

    def probe(self):
        try:
            return bool(self._call("probe", timeout=self.probe_timeout_s))
        except Exception:
            return False

    # -------------------------------------------------------------- lifecycle
    def drain(self, timeout=None):
        budget = (timeout if timeout is not None else 30.0) + self.timeout_s
        self._call("drain", {"timeout": timeout}, timeout=budget)

    def shutdown(self):
        """Detach from the replica: close THIS client. The replica
        process keeps serving — its lifecycle belongs to the
        :class:`FleetSupervisor` (SIGTERM-with-grace), not to whichever
        router happens to be connected. A router shutdown over wire
        replicas therefore never tears down the fleet processes."""
        self.close()

    def stop_remote(self):
        """Ask the replica process to stop serving and exit (admin /
        test hook; production stops go through the supervisor so the
        exit is not charged to the failure budget)."""
        try:
            self._call("shutdown")
        finally:
            self.close()

    def kill(self, error=None):
        try:
            self._call("kill", {"error": encode_error(error)
                                if error is not None else None})
        except Exception:
            pass  # killing an already-dead replica is a success

    def restart(self, timeout=None, shed_error=None):
        budget = (timeout if timeout is not None else 30.0) + self.timeout_s
        self._call("restart",
                   {"timeout": timeout,
                    "shed_error": encode_error(shed_error)
                    if shed_error is not None else None},
                   timeout=budget)

    def refresh(self, params, version, timeout=None):
        if isinstance(params, PublicationRef):
            args = {"version": int(version), "timeout": timeout,
                    "publication": {"dir": params.publish_dir,
                                    "expect_chain": params.expect_chain}}
        else:
            args = {"version": int(version), "timeout": timeout,
                    "params": params}
        budget = (timeout if timeout is not None else 60.0) + self.timeout_s
        return int(self._call("refresh", args, timeout=budget))

    def weight_version(self):
        return int(self._call("weight_version"))

    def stats(self):
        try:
            out = dict(self._call("stats", timeout=self.probe_timeout_s)
                       or {})
        except Exception as e:
            out = {"wire_error": str(e)}
        out["wire_address"] = self.address
        out["wire_reconnects"] = self.reconnects
        return out


class _WireHandle:
    """Client half of one remote stream. ``uid`` is the REMOTE
    gateway-local uid (handoff claims key on it). The stream-frame
    queue is fed by the reader thread; ``tokens(timeout=...)`` keeps the
    in-process stall contract by letting ``queue.Empty`` escape."""

    def __init__(self, replica, rid, q, uid):
        self._replica = replica
        self._rid = rid
        self._q = q
        self.uid = uid
        self.status = "running"
        self.error = None
        self._collected = []
        self._done = threading.Event()

    @property
    def done(self):
        return self._done.is_set()

    def _finish(self, status, error=None):
        self.status = status
        self.error = error
        self._done.set()
        self._replica._release(self._rid)

    def tokens(self, timeout=None):
        """Yield streamed token ids. ``queue.Empty`` escapes on a
        per-token stall (the router's hang detection); the decoded
        terminal :class:`ServingError` is raised on abnormal endings."""
        while not self._done.is_set():
            msg = self._q.get(timeout=timeout)  # Empty escapes: stall
            mtype = msg.get("type")
            if mtype == "tok":
                tok = int(msg["t"])
                self._collected.append(tok)
                yield tok
            elif mtype == "done":
                self._finish(msg.get("status", "completed"))
                return
            elif mtype == "err":
                err = decode_error(msg.get("error") or {})
                self._finish("failed", err)
                raise err
            elif mtype == "conn_dead":
                err = msg["error_obj"]
                self._finish("failed", err)
                raise err
            # unknown stream frame types are skipped (forward compat)
        if self.error is not None:
            raise self.error

    def result(self, timeout=None):
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            for _tok in self.tokens(timeout=timeout):
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(
                        f"request {self.uid} still running after "
                        f"{timeout}s")
        except _queue.Empty:
            raise TimeoutError(
                f"request {self.uid} still running after {timeout}s")
        return list(self._collected)

    def cancel(self):
        """Best-effort remote cancel; the terminal
        ``RequestCancelledError`` comes back through the stream."""
        try:
            self._replica._call("cancel", {"uid": self.uid},
                                timeout=self._replica.probe_timeout_s)
        except Exception as e:
            logger.debug(f"wire cancel for {self.uid} failed: {e}")
