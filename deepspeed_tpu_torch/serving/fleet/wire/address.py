"""Socket-address handling for the fleet wire transport.

A copy of ``deepspeed_tpu/serving/fleet/wire/address.py``.

Addresses are strings so they survive argv / env / config files:

- ``"host:port"`` — TCP (``port`` 0 binds an ephemeral port; the bound
  address is what :func:`listen` returns / the replica entry point
  announces);
- ``"unix:/path/to.sock"`` — unix domain socket (the
  shared-filesystem-adjacent default the supervisor uses: one socket
  file per replica under its run directory).
"""

import os
import socket


def is_unix(address):
    return str(address).startswith("unix:")


def listen(address, backlog=16):
    """Bind + listen → ``(server_socket, bound_address_str)``."""
    address = str(address)
    if is_unix(address):
        path = address[len("unix:"):]
        try:
            os.unlink(path)
        except OSError:
            pass
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.bind(path)
        sock.listen(backlog)
        return sock, address
    host, _, port = address.rpartition(":")
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    sock.bind((host or "127.0.0.1", int(port)))
    sock.listen(backlog)
    bound_host, bound_port = sock.getsockname()[:2]
    return sock, f"{bound_host}:{bound_port}"


def connect(address, timeout=None):
    """Connect → socket (raises ``OSError`` family on failure)."""
    address = str(address)
    if is_unix(address):
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.settimeout(timeout)
        sock.connect(address[len("unix:"):])
    else:
        host, _, port = address.rpartition(":")
        sock = socket.create_connection((host or "127.0.0.1", int(port)),
                                        timeout=timeout)
    sock.settimeout(None)  # per-call deadlines live above the socket
    if not is_unix(address):
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return sock


def cleanup(address):
    """Remove a unix socket file (listener teardown); TCP is a no-op."""
    if is_unix(str(address)):
        try:
            os.unlink(str(address)[len("unix:"):])
        except OSError:
            pass
