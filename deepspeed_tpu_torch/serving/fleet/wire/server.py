"""Worker-process side of the fleet wire transport.

Port of ``deepspeed_tpu/serving/fleet/wire/server.py``.
:class:`ReplicaServer` wraps any
:class:`~deepspeed_tpu_torch.serving.fleet.replica.Replica` (in
production a :class:`GatewayReplica` built from a serialized config — see
``deepspeed_tpu_torch/serving/fleet/wire/ds_replica.py``) and serves the
framed wire protocol over a TCP or unix socket:

- one handler thread per accepted connection, one dispatch thread per
  request frame, so a slow ``restart``/``refresh`` never starves the
  health probes multiplexed on the same connection;
- ``submit`` replies with the gateway-local request uid, then a relay
  thread streams ``tok`` frames as the handle produces them and closes
  the stream with a ``done`` or typed ``err`` frame;
- handoff records and weight trees cross as tagged bytes
  (bit-identical tensor and ndarray round-trips: an inline tree arrives
  as CPU tensors, and the replica's ``refresh`` places them);
  ``import_handoff`` runs the
  unconditional ``check_handoff_record`` validation inside the
  gateway exactly as in-process, and a publication-referenced
  ``refresh`` re-validates through ``WeightPublisher.load`` before
  anything is adopted — typed rejections travel back as wire errors;
- the server beats a heartbeat file (counter payload, so every beat is
  progress) for the :class:`FleetSupervisor`'s hang watchdog.
"""

import queue as _queue
import socket as _socket
import threading
import time

import numpy as np

from deepspeed_tpu_torch.serving.admission import ServingError
from deepspeed_tpu_torch.serving.fleet.wire import address as _address
from deepspeed_tpu_torch.serving.fleet.wire.codec import WIRE_VERSION, read_frame, write_frame
from deepspeed_tpu_torch.serving.fleet.wire.errors import (WireProtocolError, decode_error,
                                                           encode_error)
from deepspeed_tpu_torch.utils import proc
from deepspeed_tpu_torch.utils.env_registry import env_raw
from deepspeed_tpu_torch.utils.logging import logger
from deepspeed_tpu_torch.utils.sanitize import tracked_lock

# relay-side poll for the next token: bounds how long a relay thread
# blocks before noticing a dead connection / server stop. The CLIENT'S
# stall detection is the router's stream_token_timeout_s — this poll
# only affects teardown latency, not semantics.
_STREAM_POLL_S = 0.1


class _Conn:
    """One accepted connection: buffered files + a write lock that makes
    concurrently-relayed frames interleave at frame granularity."""

    def __init__(self, sock, peer):
        self.sock = sock
        self.peer = peer
        self.rfile = sock.makefile("rb")
        self.wfile = sock.makefile("wb")
        self.wlock = threading.Lock()
        self.open = True

    def send(self, msg):
        write_frame(self.wfile, msg, lock=self.wlock)

    def close(self):
        self.open = False
        # shutdown first: it wakes any thread blocked inside a buffered
        # read on this socket, so the file closes below can't deadlock
        # on the reader's buffer lock (and the blocked recv actually
        # returns — close() alone does not interrupt it on Linux)
        try:
            self.sock.shutdown(_socket.SHUT_RDWR)
        except OSError:
            pass
        for closer in (self.rfile.close, self.wfile.close, self.sock.close):
            try:
                closer()
            except OSError:
                pass


class ReplicaServer:
    """Serve one replica over the wire protocol.

    ``bind`` defaults to ``DS_WIRE_BIND`` (then ``127.0.0.1:0``); the
    actually-bound address is available as ``.address`` after
    :meth:`start` (ephemeral TCP ports and the supervisor's announce
    file depend on this). ``heartbeat_file`` arms the supervisor-side
    hang watchdog."""

    def __init__(self, replica, bind=None, heartbeat_file=None,
                 heartbeat_interval_s=0.5):
        self.replica = replica
        self.name = getattr(replica, "name", "replica")
        if bind is None:
            bind = env_raw("DS_WIRE_BIND") or "127.0.0.1:0"
        self._bind = str(bind)
        self.address = None
        self._lock = tracked_lock(threading.Lock(), "ReplicaServer._lock")
        self._state = "new"  # new | serving | stopped
        self._listener = None
        self._conns = set()
        self._streams = {}  # gateway-local uid -> live handle (cancel)
        self.served = 0  # requests dispatched (all ops)
        self._accept_thread = None
        self._hb_thread = None
        self._hb = proc.HeartbeatFileWriter(heartbeat_file)
        self._hb_interval = float(heartbeat_interval_s)

    # ------------------------------------------------------------ lifecycle
    def start(self):
        """Bind + start the accept loop; returns the bound address."""
        listener, bound = _address.listen(self._bind)
        # bounded accept: close() does not wake a thread blocked in
        # accept() on Linux, so the loop polls _state on this cadence
        listener.settimeout(0.5)
        with self._lock:
            if self._state != "new":
                listener.close()
                raise RuntimeError(f"ReplicaServer is {self._state}")
            self._state = "serving"
        self._listener = listener
        self.address = bound
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name=f"ds-wire-accept-{self.name}",
            daemon=True)
        self._accept_thread.start()
        if self._hb.path is not None:
            self._hb_thread = threading.Thread(
                target=self._heartbeat_loop,
                name=f"ds-wire-heartbeat-{self.name}", daemon=True)
            self._hb_thread.start()
        logger.info(f"[wire] replica {self.name} serving on {bound}")
        return bound

    def serve_forever(self):
        if self._state == "new":
            self.start()
        while True:
            thread = self._accept_thread
            if thread is None or not thread.is_alive():
                return
            thread.join(timeout=0.5)

    def stop(self):
        with self._lock:
            if self._state == "stopped":
                return
            self._state = "stopped"
            conns = list(self._conns)
            self._conns.clear()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        for conn in conns:
            conn.close()
        if self.address is not None:
            _address.cleanup(self.address)

    @property
    def state(self):
        return self._state

    # ---------------------------------------------------------- accept loop
    def _accept_loop(self):
        while self._state == "serving":
            try:
                sock, peer = self._listener.accept()
            except TimeoutError:
                continue  # periodic _state re-check
            except OSError:
                return  # listener closed by stop()
            sock.settimeout(None)  # conn I/O is deadline'd by the peer
            conn = _Conn(sock, peer)
            with self._lock:
                if self._state != "serving":
                    conn.close()
                    return
                self._conns.add(conn)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             name=f"ds-wire-conn-{self.name}",
                             daemon=True).start()

    def _heartbeat_loop(self):
        while self._state == "serving":
            self._hb.beat({"name": self.name})
            time.sleep(self._hb_interval)

    def _serve_conn(self, conn):
        try:
            while conn.open and self._state == "serving":
                try:
                    msg = read_frame(conn.rfile)
                except WireProtocolError as e:
                    # framing is lost — reply typed (id -1 reaches no
                    # pending call but lands in the client log) and drop
                    # the connection; the client reconnects with backoff
                    self._safe_send(conn, {"v": WIRE_VERSION, "id": -1,
                                           "type": "err",
                                           "error": encode_error(e)})
                    return
                except OSError:
                    return
                if msg is None:
                    return  # clean EOF
                with self._lock:
                    self.served += 1
                threading.Thread(target=self._dispatch, args=(conn, msg),
                                 name=f"ds-wire-req-{self.name}",
                                 daemon=True).start()
        finally:
            conn.close()
            with self._lock:
                self._conns.discard(conn)

    # ------------------------------------------------------------- dispatch
    def _safe_send(self, conn, msg):
        try:
            conn.send(msg)
            return True
        except (OSError, ValueError):
            conn.close()
            return False

    def _dispatch(self, conn, msg):
        rid = msg.get("id", -1)
        op = msg.get("op")
        args = msg.get("args") or {}
        try:
            if op == "submit":
                self._op_submit(conn, rid, args)
                return
            result = self._unary(op, args)
        except Exception as e:  # typed across the wire, never silent
            if not isinstance(e, ServingError):
                logger.exception(f"[wire] replica {self.name}: op {op} "
                                 f"failed")
            self._safe_send(conn, {"v": WIRE_VERSION, "id": rid,
                                   "type": "err", "error": encode_error(e)})
            return
        self._safe_send(conn, {"v": WIRE_VERSION, "id": rid, "type": "ok",
                               "result": result})
        if op == "shutdown":
            self.stop()

    def _unary(self, op, args):
        rep = self.replica
        if op == "probe":
            return bool(rep.probe())
        if op == "alive":
            return bool(rep.alive())
        if op == "load":
            return rep.load()
        if op == "stats":
            return rep.stats()
        if op == "weight_version":
            return int(rep.weight_version())
        if op == "prefix_match_len":
            return int(rep.prefix_match_len(
                [int(t) for t in args["prompt"]]))
        if op == "has_adapter":
            return bool(rep.has_adapter(args.get("adapter_id")))
        if op == "prefetch_adapter":
            rep.prefetch_adapter(args.get("adapter_id"))
            return None
        if op == "cancel":
            with self._lock:
                handle = self._streams.get(args.get("uid"))
            if handle is not None:
                handle.cancel()
            return None
        if op == "take_handoff":
            return rep.take_handoff(args.get("uid"))
        if op == "import_handoff":
            return int(rep.import_handoff(_retuple_record(args["record"])))
        if op == "drain":
            rep.drain(timeout=args.get("timeout"))
            return None
        if op == "shutdown":
            rep.shutdown()
            return None
        if op == "kill":
            err = (decode_error(args["error"])
                   if args.get("error") is not None else None)
            rep.kill(err)
            return None
        if op == "restart":
            shed = (decode_error(args["shed_error"])
                    if args.get("shed_error") is not None else None)
            rep.restart(timeout=args.get("timeout"), shed_error=shed)
            return None
        if op == "refresh":
            return self._op_refresh(args)
        raise WireProtocolError(f"unknown wire op {op!r}", op=op)

    def _op_refresh(self, args):
        version = int(args["version"])
        timeout = args.get("timeout")
        pub = args.get("publication")
        if pub is not None:
            # publication-referenced refresh: the bytes on the shared
            # filesystem are untrusted until WeightPublisher.load
            # re-validates manifest, chain and payload hashes HERE, in
            # the adopting process — same typed-reject boundary as the
            # in-process path
            from deepspeed_tpu_torch.serving.refresh.publisher import WeightPublisher
            publisher = WeightPublisher(pub["dir"])
            expect = pub.get("expect_chain", False)
            params, _manifest = publisher.load(
                version=version, expect_parent_chain=expect)
        else:
            params = args.get("params")
        return int(self.replica.refresh(params, version, timeout=timeout))

    # --------------------------------------------------------------- submit
    def _op_submit(self, conn, rid, args):
        prompt = np.asarray([int(t) for t in args["prompt"]], dtype=np.int32)
        try:
            handle = self.replica.submit(
                prompt,
                max_new_tokens=args.get("max_new_tokens"),
                priority=args.get("priority"),
                deadline_ms=args.get("deadline_ms"),
                adapter_id=args.get("adapter_id"),
                sample=args.get("sample"),
                schema=args.get("schema"))
        except Exception as e:
            self._safe_send(conn, {"v": WIRE_VERSION, "id": rid,
                                   "type": "err", "error": encode_error(e)})
            return
        uid = handle.uid
        with self._lock:
            self._streams[uid] = handle
        try:
            if not self._safe_send(conn, {"v": WIRE_VERSION, "id": rid,
                                          "type": "ok",
                                          "result": {"uid": uid}}):
                handle.cancel()
                return
            self._relay(conn, rid, handle)
        finally:
            with self._lock:
                self._streams.pop(uid, None)

    def _relay(self, conn, rid, handle):
        """Pump ``handle.tokens()`` into ``tok`` frames until the stream
        ends. Each poll round builds a fresh iterator: a generator that
        raised ``queue.Empty`` is finished, but nothing was consumed
        from the underlying stream, so resuming is loss-free."""
        while True:
            try:
                for tok in handle.tokens(timeout=_STREAM_POLL_S):
                    if not self._safe_send(conn, {"v": WIRE_VERSION,
                                                  "id": rid, "type": "tok",
                                                  "t": int(tok)}):
                        handle.cancel()
                        return
                self._safe_send(conn, {"v": WIRE_VERSION, "id": rid,
                                       "type": "done",
                                       "status": getattr(handle, "status",
                                                         "completed")})
                return
            except _queue.Empty:
                if not conn.open or self._state != "serving":
                    handle.cancel()
                    return
                continue  # nothing arrived within the poll; keep relaying
            except Exception as e:
                self._safe_send(conn, {"v": WIRE_VERSION, "id": rid,
                                       "type": "err",
                                       "error": encode_error(e)})
                return


def _retuple_record(record):
    """The wire flattens tuples to lists; the handoff validators
    re-derive chained keys over ``tuple(entry["tokens"])`` themselves,
    but the store adopts ``tokens`` as given — normalize so an imported
    record is indistinguishable from a locally-exported one."""
    if not isinstance(record, dict) or not isinstance(
            record.get("entries"), list):
        return record
    out = dict(record)
    out["entries"] = [
        dict(e, tokens=tuple(e["tokens"]))
        if isinstance(e, dict) and isinstance(e.get("tokens"), list) else e
        for e in record["entries"]]
    return out
