"""Length-prefixed framed codec for the fleet wire protocol.

Port of ``deepspeed_tpu/serving/fleet/wire/codec.py``: the same frames, so
a port process and a JAX one read each other's. One frame = a 4-byte
big-endian payload length, a 1-byte format marker (``M`` = msgpack, ``J``
= JSON), then the encoded message. Every message is a dict envelope
``{"v": WIRE_VERSION, "type": <str>, "id": <int>, ...}``; the version is
checked on decode so a future protocol bump surfaces as a typed
:class:`WireProtocolError` instead of a KeyError three layers down.

Payload encoding is msgpack when the module is importable, JSON
otherwise — the *decoder* always accepts both (the marker byte travels
with every frame), so mixed fleets interoperate. No dependency is ever
installed for this: JSON is the guaranteed floor.

numpy arrays are tagged before packing exactly as the JAX codec tags
them — ``{"__nd__": 1, "dtype": <dtype.str>, "shape": [...], "data":
<raw-bytes | base64>}`` — and rebuilt with ``np.frombuffer``, so a
message of plain values and numpy arrays encodes to the JAX codec's
bytes. A torch tensor (KV handoff carriers, weight trees; a CUDA tensor
is copied to the host first) is tagged ``{"__nd__": 1, "torch": 1,
"dtype": <name>, "shape": [...], "data": ...}`` with the dtype's *name*
(``"bfloat16"``, ``"float8_e4m3fn"``: the publisher's names), and this
decoder rebuilds it as a CPU tensor of that dtype; the JAX decoder
ignores the extra key and, with ml_dtypes imported, rebuilds a bf16
ndarray of the same bytes. (The JAX codec's own ``dtype.str`` for a
bf16 ndarray is ``'<V2'``, which comes back as ``|V2``: the dtype is
lost there.) Round-trips are **bit-identical**. Plain ``bytes`` values
get the same treatment under a ``__bytes__`` tag. Tuples arrive as
lists on the far side (both payload formats flatten them); consumers
that need tuples re-tuple, exactly like the handoff validators already
do for records that crossed a process boundary.
"""

import base64
import json
import struct

import numpy as np
import torch

from deepspeed_tpu_torch.serving.fleet.wire.errors import WireProtocolError
from deepspeed_tpu_torch.serving.refresh.publisher import _DTYPE_NAMES, _TORCH_DTYPES

try:  # optional: the machine may or may not ship msgpack
    import msgpack as _msgpack
except ImportError:  # pragma: no cover - environment-dependent
    _msgpack = None

WIRE_VERSION = 1

_HEADER = struct.Struct("!IB")  # payload length, format marker
_FMT_MSGPACK = ord("M")
_FMT_JSON = ord("J")
# a frame larger than this is garbage (a torn stream re-synced mid
# payload, or a length field read off random bytes) — reject typed
# instead of trying to allocate it
MAX_FRAME_BYTES = 1 << 31


def frame_format():
    """The marker byte :func:`encode_msg` writes by default, as a
    letter: ``"M"`` where msgpack imports, else ``"J"``."""
    return "M" if _msgpack is not None else "J"


# ------------------------------------------------------------------ tagging
def _tag_tensor(t):
    name = _DTYPE_NAMES.get(t.dtype)
    if name is None:
        raise TypeError(f"a {t.dtype} tensor has no wire dtype name")
    flat = t.detach().contiguous().reshape(-1).cpu()
    data = flat.view(torch.uint8).numpy().tobytes() if flat.numel() else b""
    return {"__nd__": 1, "torch": 1, "dtype": name, "shape": list(t.shape), "data": data}


def _tag(obj):
    """Recursively replace wire-opaque values (tensors, ndarrays, bytes)
    with tagged dicts; tuples become lists."""
    if isinstance(obj, torch.Tensor):
        return _tag_tensor(obj)
    if isinstance(obj, np.ndarray):
        return {"__nd__": 1, "dtype": obj.dtype.str,
                "shape": list(obj.shape), "data": obj.tobytes()}
    if isinstance(obj, np.generic):  # numpy scalar -> python scalar
        return obj.item()
    if isinstance(obj, (bytes, bytearray)):
        return {"__bytes__": 1, "data": bytes(obj)}
    if isinstance(obj, dict):
        return {k: _tag(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_tag(v) for v in obj]
    return obj


def _untag_tensor(obj, data):
    dtype = _TORCH_DTYPES.get(obj["dtype"])
    if dtype is None:
        raise WireProtocolError(f"tensor frame names dtype {obj['dtype']!r}, which this "
                                f"build does not know")
    shape = tuple(obj["shape"])
    if not data:
        return torch.empty(shape, dtype=dtype)
    return torch.frombuffer(bytearray(data), dtype=torch.uint8).view(dtype).reshape(shape)


def _untag(obj):
    if isinstance(obj, dict):
        if obj.get("__nd__") == 1:
            data = obj["data"]
            if isinstance(data, str):  # JSON carried it base64
                data = base64.b64decode(data)
            if obj.get("torch") == 1:
                return _untag_tensor(obj, data)
            arr = np.frombuffer(data, dtype=np.dtype(obj["dtype"]))
            return arr.reshape(tuple(obj["shape"])).copy()
        if obj.get("__bytes__") == 1:
            data = obj["data"]
            return base64.b64decode(data) if isinstance(data, str) else data
        return {k: _untag(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_untag(v) for v in obj]
    return obj


class _JSONBytes(json.JSONEncoder):
    """Tagged payloads still hold raw bytes under ``data`` when JSON is
    the frame format — base64 them at the encoder seam."""

    def default(self, o):
        if isinstance(o, (bytes, bytearray)):
            return base64.b64encode(bytes(o)).decode("ascii")
        return super().default(o)


# ------------------------------------------------------------------ messages
def encode_msg(msg, prefer=None):
    """Envelope dict → one wire frame (header + payload bytes).
    ``prefer`` forces a format (tests); default is msgpack when
    available."""
    payload = _tag(msg)
    fmt = prefer if prefer is not None else \
        (_FMT_MSGPACK if _msgpack is not None else _FMT_JSON)
    if fmt == _FMT_MSGPACK and _msgpack is not None:
        body = _msgpack.packb(payload, use_bin_type=True)
    else:
        fmt = _FMT_JSON
        body = json.dumps(payload, cls=_JSONBytes,
                          separators=(",", ":")).encode("utf-8")
    return _HEADER.pack(len(body), fmt) + body


def decode_body(fmt, body):
    """Frame body bytes → envelope dict (version-checked)."""
    if fmt == _FMT_MSGPACK:
        if _msgpack is None:
            raise WireProtocolError(
                "peer sent a msgpack frame but msgpack is unavailable "
                "here — restart the peer with JSON frames")
        try:
            payload = _msgpack.unpackb(body, raw=False, strict_map_key=False)
        except Exception as e:
            raise WireProtocolError(f"undecodable msgpack frame: {e}")
    elif fmt == _FMT_JSON:
        try:
            payload = json.loads(body.decode("utf-8"))
        except (UnicodeDecodeError, ValueError) as e:
            raise WireProtocolError(f"undecodable JSON frame: {e}")
    else:
        raise WireProtocolError(
            f"unknown frame format marker {fmt!r} — torn stream or "
            f"incompatible peer")
    msg = _untag(payload)
    if not isinstance(msg, dict) or msg.get("v") != WIRE_VERSION:
        got = msg.get("v") if isinstance(msg, dict) else type(msg).__name__
        raise WireProtocolError(
            f"wire message version {got!r} is not {WIRE_VERSION} — "
            f"incompatible peer", got_version=got,
            want_version=WIRE_VERSION)
    return msg


# -------------------------------------------------------------------- stream
def read_exact(rfile, n):
    """Read exactly ``n`` bytes; '' on clean EOF at the FIRST byte,
    :class:`WireProtocolError` on EOF mid-read (a torn frame)."""
    buf = b""
    while len(buf) < n:
        chunk = rfile.read(n - len(buf))
        if not chunk:
            if not buf:
                return b""
            raise WireProtocolError(
                f"torn frame: stream closed after {len(buf)} of {n} "
                f"bytes")
        buf += chunk
    return buf


def read_frame(rfile):
    """Blocking frame read → envelope dict, or None on clean EOF at a
    frame boundary. Torn frames, garbage lengths, undecodable payloads
    and version mismatches all raise :class:`WireProtocolError`."""
    header = read_exact(rfile, _HEADER.size)
    if not header:
        return None
    length, fmt = _HEADER.unpack(header)
    if length > MAX_FRAME_BYTES:
        raise WireProtocolError(
            f"frame length {length} exceeds {MAX_FRAME_BYTES} — torn "
            f"stream or garbage header")
    body = read_exact(rfile, length)
    if length and not body:
        raise WireProtocolError("torn frame: stream closed before payload")
    return decode_body(fmt, body)


# DS_SANITIZE self-check seam: the frame encoder write_frame uses.
# Resolved lazily at the first write (not at import) so tests can flip
# the env knob; when sanitize is OFF this IS encode_msg — verbatim, no
# wrapper — so the off-state has zero per-frame overhead.
_frame_encoder = None


def _reparse_frame(data):
    """The receive path applied to an in-memory frame: header split +
    decode_body (version check included) — what the peer would see."""
    _length, fmt = _HEADER.unpack(data[:_HEADER.size])
    return decode_body(fmt, data[_HEADER.size:])


def _encoder():
    global _frame_encoder
    if _frame_encoder is None:
        from deepspeed_tpu_torch.utils.sanitize import checked_frame_encoder
        _frame_encoder = checked_frame_encoder(encode_msg, _reparse_frame)
    return _frame_encoder


def _reset_frame_encoder():
    """Test hook: re-sample DS_SANITIZE at the next write_frame."""
    global _frame_encoder
    _frame_encoder = None


def write_frame(wfile, msg, lock=None, prefer=None):
    """Serialize + write one frame. ``lock`` (when given) makes the
    write atomic against other threads sharing the connection —
    responses from per-request relay threads interleave at frame
    granularity, never mid-frame. Under DS_SANITIZE=1 every frame is
    round-trip-verified before the first byte is written."""
    data = _encoder()(msg, prefer=prefer)
    if lock is not None:
        with lock:
            wfile.write(data)
            wfile.flush()
    else:
        wfile.write(data)
        wfile.flush()
