"""The port's wire codec and error taxonomy
(``deepspeed_tpu_torch/serving/fleet/wire/{codec,errors}.py``) against the
JAX package's, on the CPU.

- Framing: every case of ``tests/unit/inference/serving/test_wire_protocol.py``
  runs through both codecs (round-trips, torn frames, garbage lengths,
  unknown markers, version mismatches, each raising typed; JSON and
  msgpack frames).
- Byte equality: a message of plain values and numpy arrays encodes to
  the same bytes in both packages, in both formats, and each package
  decodes the other's frames to equal messages.
- Torch tensors round-trip bit for bit with their dtype kept, and a
  port-encoded bf16 tensor decodes in the JAX decoder as an ml_dtypes
  bf16 array of the same bytes, where the JAX codec's own bf16 ndarray
  comes back as ``|V2`` (ROADMAP.md queue 3, "Disagreements inside the
  reference").
- The ``DS_SANITIZE`` seam: off, the frame encoder is ``encode_msg``
  itself; on, a value JSON mangles raises ``WireFrameCorruptionError``
  before a byte is written.
- Errors: every type in the port's registry round-trips with its type,
  message, reason, ``retry_elsewhere`` and details; the registry names
  the JAX registry's types plus ``SanitizerIndexError``; an unknown code
  decodes as ``WireProtocolError`` carrying ``remote_code``.

Frames, messages and error payloads are compared exactly.
"""

import io
import threading
import types

import ml_dtypes
import numpy as np
import pytest
import torch

from deepspeed_tpu.serving import admission as jadmission
from deepspeed_tpu.serving.fleet.wire import codec as jcodec
from deepspeed_tpu.serving.fleet.wire import errors as jerrors
from deepspeed_tpu.utils import sanitize as jsanitize
from deepspeed_tpu_torch.serving import admission as tadmission
from deepspeed_tpu_torch.serving.fleet.wire import codec as tcodec
from deepspeed_tpu_torch.serving.fleet.wire import errors as terrors
from deepspeed_tpu_torch.utils import sanitize as tsanitize

torch.set_num_threads(1)  # the suite runs in parallel worker processes

JAX = types.SimpleNamespace(codec=jcodec, errors=jerrors, admission=jadmission,
                            sanitize=jsanitize, name="jax")
PORT = types.SimpleNamespace(codec=tcodec, errors=terrors, admission=tadmission,
                             sanitize=tsanitize, name="port")
PACKAGES = [JAX, PORT]
FORMATS = [ord("J"), ord("M")]
V = tcodec.WIRE_VERSION

assert tcodec._msgpack is not None and jcodec._msgpack is not None, \
    "both frame formats are tested: msgpack must import here"


def roundtrip(P, msg, prefer=None):
    return P.codec.read_frame(io.BytesIO(P.codec.encode_msg(msg, prefer=prefer)))


def fmt_id(f):
    return chr(f)


# ---------------------------------------------------------------------- framing
def test_constants_match_jax():
    assert (tcodec.WIRE_VERSION, tcodec.MAX_FRAME_BYTES, tcodec._FMT_MSGPACK,
            tcodec._FMT_JSON, tcodec._HEADER.format) == \
        (jcodec.WIRE_VERSION, jcodec.MAX_FRAME_BYTES, jcodec._FMT_MSGPACK, jcodec._FMT_JSON,
         jcodec._HEADER.format) == (1, 1 << 31, ord("M"), ord("J"), "!IB")
    assert tcodec.frame_format() == "M"


def case_basic_envelope(P, fmt):
    msg = {"v": V, "id": 7, "type": "req", "op": "probe",
           "args": {"nested": {"list": [1, 2.5, None, "s", True]}}}
    out = roundtrip(P, msg, prefer=fmt)
    assert out == msg
    return out


def case_ndarrays(P, fmt):
    rng = np.random.RandomState(0)
    got = []
    for dtype in ("int32", "int8", "float32", "float16", "uint16"):
        arr = (rng.randint(-120, 120, size=(3, 5, 2)).astype(dtype)
               if np.issubdtype(np.dtype(dtype), np.integer) else rng.randn(3, 5, 2).astype(dtype))
        out = roundtrip(P, {"v": V, "id": 1, "type": "ok", "result": {"k": arr}},
                        prefer=fmt)["result"]["k"]
        assert out.dtype == arr.dtype and out.shape == arr.shape
        assert out.tobytes() == arr.tobytes()
        got.append((out.dtype.str, out.shape, out.tobytes()))
    return got


def case_bytes_and_tuples(P, fmt):
    msg = {"v": V, "id": 1, "type": "ok", "result": {"blob": b"\x00\xffraw", "tup": (1, 2, 3)}}
    out = roundtrip(P, msg, prefer=fmt)["result"]
    assert out["blob"] == b"\x00\xffraw" and out["tup"] == [1, 2, 3]
    return out


def case_version_mismatch(P, fmt):
    frame = P.codec.encode_msg({"v": V + 1, "id": 1, "type": "ok"}, prefer=fmt)
    with pytest.raises(P.errors.WireProtocolError) as ei:
        P.codec.read_frame(io.BytesIO(frame))
    assert ei.value.details == {"got_version": V + 1, "want_version": V}
    return str(ei.value), ei.value.reason, ei.value.retry_elsewhere


def case_mixed_formats_one_stream(P, fmt):
    buf = io.BytesIO()
    for i, f in enumerate(FORMATS * 2):
        P.codec.write_frame(buf, {"v": V, "id": i, "type": "ok"}, prefer=f)
    buf.seek(0)
    ids = []
    while (msg := P.codec.read_frame(buf)) is not None:
        ids.append(msg["id"])
    assert ids == [0, 1, 2, 3]
    return buf.getvalue()


FRAME_CASES = {name[5:]: fn for name, fn in dict(globals()).items() if name.startswith("case_")}


@pytest.mark.parametrize("fmt", FORMATS, ids=fmt_id)
@pytest.mark.parametrize("case", sorted(FRAME_CASES))
def test_framing_lockstep(case, fmt):
    """One framing case of the JAX test through both codecs: the same
    observations."""
    out = {P.name: FRAME_CASES[case](P, fmt) for P in PACKAGES}
    assert out["port"] == out["jax"]


def _bad_streams(P):
    frame = P.codec.encode_msg({"v": V, "id": 1, "type": "ok", "result": list(range(64))},
                               prefer=ord("J"))
    garbage = P.codec._HEADER.pack(P.codec.MAX_FRAME_BYTES + 1, ord("J")) + b"x" * 16
    marker = P.codec._HEADER.pack(2, ord("Z")) + b"{}"
    body = b"\xff\xfe not a payload"
    undecodable = {f: P.codec._HEADER.pack(len(body), f) + body for f in FORMATS}
    return {"torn_header": frame[:3], "torn_payload": frame[:-5], "garbage_length": garbage,
            "unknown_marker": marker, "undecodable_json": undecodable[ord("J")],
            "undecodable_msgpack": undecodable[ord("M")]}


@pytest.mark.parametrize("stream", ["torn_header", "torn_payload", "garbage_length",
                                    "unknown_marker", "undecodable_json",
                                    "undecodable_msgpack"])
def test_bad_streams_raise_typed_lockstep(stream):
    """Torn frames, a garbage length, an unknown marker and undecodable
    payloads raise ``WireProtocolError`` in both codecs, with the same
    message; a clean EOF reads as None."""
    out = {}
    for P in PACKAGES:
        data = _bad_streams(P)[stream]
        with pytest.raises(P.errors.WireProtocolError) as ei:
            P.codec.read_frame(io.BytesIO(data))
        assert isinstance(ei.value, P.admission.ServingError)
        assert P.codec.read_frame(io.BytesIO(b"")) is None
        msg = str(ei.value)
        if stream.startswith("undecodable_msgpack"):
            msg = msg.split(":")[0]  # the rest is msgpack's own wording
        out[P.name] = (msg, ei.value.details)
    assert out["port"] == out["jax"]
    if stream == "garbage_length":
        assert "torn stream" in out["port"][0]
    if stream == "unknown_marker":
        assert "format marker" in out["port"][0]


def test_write_frame_lock_serializes_whole_frames():
    class Chunky:
        def __init__(self):
            self.chunks = []

        def write(self, data):
            self.chunks.append(bytes(data))

        def flush(self):
            pass

    out, lock = Chunky(), threading.Lock()
    threads = [threading.Thread(target=tcodec.write_frame,
                                args=(out, {"v": V, "id": i, "type": "ok",
                                            "result": list(range(100))}),
                                kwargs={"lock": lock}) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert {tcodec.read_frame(io.BytesIO(c))["id"] for c in out.chunks} == set(range(8))
    assert {c for c in out.chunks} == {jcodec.encode_msg({"v": V, "id": i, "type": "ok",
                                                          "result": list(range(100))})
                                       for i in range(8)}


# ---------------------------------------------------------------------- byte equality
def plain_messages():
    rng = np.random.RandomState(1)
    return {
        "envelope": {"v": V, "id": 3, "type": "req", "op": "submit",
                     "args": {"prompt": [1, 2, 3], "max_new_tokens": 4, "priority": None,
                              "deadline_ms": 2.5, "sample": {"temperature": 1.1, "seed": 7},
                              "schema": None, "adapter_id": "a-1"}},
        "numpy": {"v": V, "id": 4, "type": "ok",
                  "result": {"f32": rng.randn(2, 3).astype(np.float32),
                             "i8": rng.randint(-9, 9, 5).astype(np.int8),
                             "u16": np.arange(4, dtype=np.uint16), "empty": np.zeros((0, 4)),
                             "f64": np.array([np.nan, np.inf, -0.0]),
                             "scalar": np.float32(1.5), "i64": np.int64(-3)}},
        "record": {"v": V, "id": 5, "type": "ok",
                   "result": {"version": 1, "block_size": 4, "root_key": None,
                              "entries": [{"key": -1234567890123, "parent_key": None,
                                           "tokens": (1, 2, 3, 4),
                                           "handle": {"k": rng.randn(2, 4, 2).astype(np.float32)},
                                           "nbytes": 64, "quant_error": None}]}},
        "error": {"v": V, "id": 6, "type": "err",
                  "error": {"code": "QueueFullError", "message": "full", "reason": "queue_full",
                            "retry_elsewhere": True, "details": {"queue_depth": 17}}},
        "bytes": {"v": V, "id": -1, "type": "tok", "t": 42, "blob": b"\x00\x01",
                  "text": "ünïcode"},
    }


@pytest.mark.parametrize("fmt", FORMATS, ids=fmt_id)
@pytest.mark.parametrize("name", sorted(plain_messages()))
def test_plain_frames_byte_equal_and_cross_decode(name, fmt):
    msg = plain_messages()[name]
    port, jax_ = tcodec.encode_msg(msg, prefer=fmt), jcodec.encode_msg(msg, prefer=fmt)
    assert port == jax_
    a = tcodec.read_frame(io.BytesIO(jax_))
    b = jcodec.read_frame(io.BytesIO(port))
    assert jsanitize.wire_structural_equal(a, b) and tsanitize.wire_structural_equal(a, msg)
    assert tcodec.encode_msg(a, prefer=fmt) == jcodec.encode_msg(b, prefer=fmt) == port


# ---------------------------------------------------------------------- tensors
TENSOR_DTYPES = [torch.float32, torch.float16, torch.bfloat16, torch.float8_e4m3fn, torch.int8,
                 torch.int32, torch.uint8]


def _tensor(dtype, shape=(3, 5, 2)):
    g = torch.Generator().manual_seed(0)
    if dtype.is_floating_point:
        return (torch.randn(shape, generator=g) * 3).to(dtype)
    info = torch.iinfo(dtype)
    return torch.randint(max(info.min, -1000), min(info.max, 1000), shape, generator=g,
                         dtype=torch.int64).to(dtype)


def _bits(t):
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


@pytest.mark.parametrize("fmt", FORMATS, ids=fmt_id)
@pytest.mark.parametrize("dtype", TENSOR_DTYPES, ids=str)
def test_tensor_roundtrip_bit_identical(dtype, fmt):
    t = _tensor(dtype)
    msg = {"v": V, "id": 1, "type": "ok",
           "result": {"k": t, "t": t[1:, :, 0], "empty": t[:0], "scalar": t[0, 0, 0]}}
    out = roundtrip(PORT, msg, prefer=fmt)["result"]
    for key, want in msg["result"].items():
        got = out[key]
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        assert got.dtype == dtype and got.shape == want.shape, key
        assert _bits(got) == _bits(want), key
    assert tsanitize.wire_structural_equal(out, msg["result"])
    # the JAX decoder reads the same frame: same bytes, a numpy dtype of the same name
    jout = jcodec.read_frame(io.BytesIO(tcodec.encode_msg(msg, prefer=fmt)))["result"]["k"]
    assert jout.dtype == np.dtype(str(dtype).split(".")[1]) and jout.shape == t.shape
    assert jout.tobytes() == _bits(t)


@pytest.mark.parametrize("fmt", FORMATS, ids=fmt_id)
def test_bf16_tag_fault_in_the_reference(fmt):
    """The port tags a bf16 tensor by its name and the JAX decoder reads
    it as true bf16; the JAX codec's own bf16 ndarray is tagged
    ``dtype.str`` = ``'<V2'`` and comes back as ``|V2``: same bytes, dtype
    lost (ROADMAP.md queue 3)."""
    t = _tensor(torch.bfloat16)
    port = jcodec.read_frame(io.BytesIO(tcodec.encode_msg({"v": V, "id": 1, "type": "ok",
                                                           "result": t}, prefer=fmt)))["result"]
    assert port.dtype == np.dtype(ml_dtypes.bfloat16) and port.tobytes() == _bits(t)
    arr = np.frombuffer(_bits(t), dtype=ml_dtypes.bfloat16).reshape(t.shape)
    assert arr.dtype.str == "<V2"
    jax_ = roundtrip(JAX, {"v": V, "id": 1, "type": "ok", "result": arr}, prefer=fmt)["result"]
    assert jax_.dtype == np.dtype("|V2") and jax_.dtype != arr.dtype
    assert jax_.tobytes() == arr.tobytes()
    # the port decodes the JAX frame as JAX does (numpy, dtype.str kept)
    port_read = roundtrip(PORT, {"v": V, "id": 1, "type": "ok", "result": arr},
                          prefer=fmt)["result"]
    assert port_read.dtype == jax_.dtype and port_read.tobytes() == jax_.tobytes()


def test_unnamed_dtypes_raise():
    with pytest.raises(TypeError, match="wire dtype name"):
        tcodec.encode_msg({"v": V, "id": 1, "type": "ok",
                           "result": torch.zeros(2, dtype=torch.complex32)})
    for fmt in FORMATS:
        frame = tcodec.encode_msg({"v": V, "id": 1, "type": "ok", "result": torch.zeros(2)},
                                  prefer=fmt)
        bad = frame.replace(b"float32", b"float99")  # same length: a frame of a newer peer
        with pytest.raises(tcodec.WireProtocolError, match="float99"):
            tcodec.read_frame(io.BytesIO(bad))


# ---------------------------------------------------------------------- sanitizer seam
@pytest.fixture
def fresh_encoder(monkeypatch):
    yield monkeypatch
    for P in PACKAGES:
        P.codec._reset_frame_encoder()


def test_sanitizer_seam(fresh_encoder):
    fresh_encoder.delenv("DS_SANITIZE", raising=False)
    for P in PACKAGES:
        P.codec._reset_frame_encoder()
        assert P.codec._encoder() is P.codec.encode_msg  # off: no wrapper at all
    fresh_encoder.setenv("DS_SANITIZE", "1")
    mangled = {"v": V, "id": 1, "type": "ok", "result": {1: "int key"}}
    tensors = {"v": V, "id": 2, "type": "ok", "result": {"k": _tensor(torch.bfloat16)}}
    for P in PACKAGES:
        P.codec._reset_frame_encoder()
        assert P.codec._encoder() is not P.codec.encode_msg
        buf = io.BytesIO()
        with pytest.raises(P.sanitize.WireFrameCorruptionError, match="round-trip"):
            P.codec.write_frame(buf, mangled, prefer=ord("J"))
        assert buf.getvalue() == b""  # nothing written
        P.codec.write_frame(buf, mangled, prefer=ord("M"))  # msgpack keeps int keys
        assert P.codec.read_frame(io.BytesIO(buf.getvalue()))["result"] == {1: "int key"}
    buf = io.BytesIO()
    tcodec.write_frame(buf, tensors, prefer=ord("J"))  # a tensor survives its check
    assert tsanitize.wire_structural_equal(tcodec.read_frame(io.BytesIO(buf.getvalue())),
                                           tensors)
    assert issubclass(tsanitize.WireFrameCorruptionError, tsanitize.SanitizerError)


# ---------------------------------------------------------------------- errors
def _family(base, module):
    out = {}

    def walk(cls):
        if cls.__module__.startswith(module):
            out[cls.__name__] = cls
        for sub in cls.__subclasses__():
            walk(sub)
    walk(base)
    return out


def test_registry_names_are_jax_plus_sanitizer_index_error():
    port = terrors._error_registry()
    jax_ = jerrors._error_registry()
    port_names = {n for n, c in port.items()
                  if c.__module__.startswith(("deepspeed_tpu_torch.", "builtins"))}
    jax_names = {n for n, c in jax_.items()
                 if c.__module__.startswith(("deepspeed_tpu.", "builtins"))}
    assert port_names - jax_names == {"SanitizerIndexError"}
    assert jax_names - port_names == set()
    assert len([c for c in port.values() if issubclass(c, tadmission.ServingError)]) >= 20
    assert set(_family(tsanitize.SanitizerError, "deepspeed_tpu_torch")) <= set(port)
    tsanitize.check_error_registry(port, tadmission.ServingError)  # the audit passes


def _error_cases():
    reg = terrors._error_registry()
    return sorted(n for n, c in reg.items()
                  if c.__module__.startswith(("deepspeed_tpu_torch.", "builtins")))


@pytest.mark.parametrize("fmt", FORMATS, ids=fmt_id)
@pytest.mark.parametrize("name", _error_cases())
def test_every_error_round_trips_lockstep(name, fmt):
    """Each registered type through the full frame path in both packages:
    the same payload, the same type name, message, reason,
    ``retry_elsewhere`` and details; the payload a JAX peer sends decodes
    to the port type of that name."""
    out = {}
    for P in PACKAGES:
        reg = P.errors._error_registry()
        cls = reg.get(name)
        if cls is None:
            assert P is JAX and name == "SanitizerIndexError"
            continue
        serving = issubclass(cls, P.admission.ServingError)
        exc = cls(f"{name} happened", hint_a=3, hint_b="x") if serving else cls(f"{name} no")
        payload = P.errors.encode_error(exc)
        frame = P.codec.encode_msg({"v": V, "id": 3, "type": "err", "error": payload},
                                   prefer=fmt)
        back = P.errors.decode_error(P.codec.read_frame(io.BytesIO(frame))["error"])
        assert type(back) is cls and str(back) == str(exc)
        assert getattr(back, "details", None) == getattr(exc, "details", None)
        assert getattr(back, "reason", None) == getattr(exc, "reason", None)
        assert getattr(back, "retry_elsewhere", None) == getattr(exc, "retry_elsewhere", None)
        out[P.name] = (payload, frame, type(back).__name__, str(back),
                       getattr(back, "details", None), getattr(back, "reason", None),
                       getattr(back, "retry_elsewhere", None))
    if "jax" in out:
        assert out["port"] == out["jax"]
        cross = terrors.decode_error(jcodec.read_frame(io.BytesIO(out["jax"][1]))["error"])
        assert type(cross) is terrors._error_registry()[name]
    else:  # the port's index check: a JAX peer decodes it as an unknown code
        back = jerrors.decode_error(out["port"][0])
        assert type(back) is jerrors.WireProtocolError
        assert back.details["remote_code"] == "SanitizerIndexError"


@pytest.mark.parametrize("payload", [
    {"code": "FutureFancyError", "message": "from the future", "reason": "fancy",
     "retry_elsewhere": True, "details": {"x": 1}},
    {}, None])
def test_unknown_codes_decode_typed_lockstep(payload):
    out = {}
    for P in PACKAGES:
        p = P.errors.encode_error(ValueError("surprise")) if payload is None else payload
        back = P.errors.decode_error(p)
        assert type(back) is P.errors.WireProtocolError
        assert isinstance(back, P.admission.ServingError)
        out[P.name] = (p, str(back), back.details, back.reason, back.retry_elsewhere)
    assert out["port"] == out["jax"]
    if payload:
        assert out["port"][2]["remote_code"] == "FutureFancyError" and out["port"][2]["x"] == 1
    if payload is None:
        assert out["port"][0]["retry_elsewhere"] is True
        assert out["port"][2]["remote_code"] == "ValueError"


def test_sanitizer_family_and_schema_errors_are_not_retryable():
    from deepspeed_tpu_torch.inference.structured.grammar import SchemaCompileError
    reg = terrors._error_registry()
    for name, cls in _family(tsanitize.SanitizerError, "deepspeed_tpu_torch").items():
        assert reg[name] is cls
        back = terrors.decode_error(terrors.encode_error(cls("invariant tripped")))
        assert type(back) is cls and back.retry_elsewhere is False
    payload = terrors.encode_error(SchemaCompileError("unsupported keyword: x"))
    assert payload["reason"] == "schema_compile" and payload["retry_elsewhere"] is False
    back = terrors.decode_error(payload)
    assert type(back) is SchemaCompileError and isinstance(back, ValueError)
