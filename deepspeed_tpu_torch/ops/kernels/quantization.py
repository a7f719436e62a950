"""Group-wise symmetric int8 quantization (int8 values, one fp32 scale a group).

Port of ``deepspeed_tpu/ops/pallas/quantization.py``. The tensor is
flattened, zero-padded to a whole number of groups and viewed as
``[G, group_size]``; each group gets ``scale = absmax / 127`` (1 for an
all-zero group) and ``q = clip(round(x / scale), -127, 127)`` with round
half to even, or stochastic rounding from a seed.

:func:`quantize_int8` and :func:`dequantize_int8` are the JAX package's
entry points. A CUDA tensor launches the CUDA C++ kernels of
``csrc/quantization.cu`` (its header says what bounds them and what the
designs do about that) or raises; a CPU tensor takes the plain versions
:func:`quantize_int8_ref` and :func:`dequantize_int8_ref`. The quantize
kernel has three designs, named by :func:`k7_design` from the group size,
the dtype, the group count and the alignment, and counted in
``k7_design_launches``: "warp" (a warp a group, up to 1024 values),
"cluster" (a group of 4097 to 65536 values in 8-value units split over a
thread block cluster of 2-8 blocks, :func:`k7_cluster_size`: each value
read once into registers, the group's absmax reduced across the cluster
through distributed shared memory; where the groups' blocks fit in one
wave, as a KV tier demotion's do) and "two_pass" (one block a group: an
absmax pass, then the codes; every other group).
:func:`dequantize_int8_rows` writes each group into a chosen row of
another tensor (the KV pool's blocks on a restore) through the same
dequantize kernel.

The deterministic path equals the JAX package's eager path bit for bit:
both divisions are true divisions (``absmax / 127`` is divided by a tensor,
so that no backend turns it into a product with a reciprocal) and
``torch.round`` rounds half to even. Under ``jax.jit`` (and in the Pallas
kernel's interpret mode) XLA may fold ``/ 127`` into a product, so the JAX
package's own results can sit one fp32 rounding off its eager path; the
port follows the eager path. The TPU's hardware PRNG is not carried over:
stochastic rounding draws ``u`` in [0, 1) from a counter-based hash of
(seed, group, index), the same integers in the kernel and in
:func:`_uniform`, so the two agree bit for bit on the card and only the
distribution compares with the TPU's.
"""

import ctypes
import math

import torch

_SOURCE = "quantization.cu"
_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
_VEC = {torch.bfloat16: 8, torch.float32: 4}  # values per 16-byte vector
_M32 = 0xFFFFFFFF

# the quantize kernel's designs (the C entry's codes 0, 1, 2) and their launches
DESIGNS = ("warp", "cluster", "two_pass")
k7_design_launches = dict.fromkeys(DESIGNS, 0)
WARP_MAX = 1024                  # a warp a group up to here
CLUSTER_THREADS = 256            # threads a block of the cluster design
MAX_CLUSTER = 8                  # blocks a cluster at most (the portable size)
CLUSTER_MAX = MAX_CLUSTER * CLUSTER_THREADS * 32  # values a group at most: 32 a thread
CLUSTER_MIN = CLUSTER_THREADS * 16 + 1             # values a group at least: two blocks
WAVE_BLOCKS_PER_SM = 4           # the cluster design's blocks an SM runs at once


def k7_design(gs, dtype, groups, sms, aligned=True):
    """The quantize design for ``groups`` groups of ``gs`` values of
    ``dtype`` (bf16 or fp32) on a card of ``sms`` SMs: "warp" (one warp a
    group) up to WARP_MAX values; "cluster" (a group split over a thread
    block cluster of 2-8 blocks, every value read once into registers) for
    groups of CLUSTER_MIN to CLUSTER_MAX values in whole 8-value units,
    ``aligned`` (16-byte vectors), few enough that their blocks run in one
    wave (WAVE_BLOCKS_PER_SM an SM): a KV tier demotion's 64 slabs; else
    "two_pass" (one block a group: an absmax pass, then the codes), whose
    blocks stream with 8 loads in flight a thread once the groups alone
    fill the card. On the H100 the cluster design took 7.7 µs against
    10.4 at 64 slab groups, and 13.3 against 11.8 at 128 (``PERF.md``)."""
    if gs <= WARP_MAX:
        return "warp"
    if cluster_takes(gs, dtype, aligned) and \
            groups * k7_cluster_size(gs) <= WAVE_BLOCKS_PER_SM * sms:
        return "cluster"
    return "two_pass"


def cluster_takes(gs, dtype, aligned=True):
    """Whether the cluster design can take groups of ``gs`` values of
    ``dtype`` (whatever their count): CLUSTER_MIN to CLUSTER_MAX values in
    whole 8-value units, bf16 or fp32, 16-byte ``aligned``."""
    return aligned and gs % 8 == 0 and CLUSTER_MIN <= gs <= CLUSTER_MAX and dtype in _VEC


def k7_cluster_size(gs):
    """Blocks in the cluster design's cluster (``k7_cluster_size`` in the
    source): the least power of two up to MAX_CLUSTER that gives each thread
    at most 16 values."""
    cs = 1
    while cs < MAX_CLUSTER and cs * CLUSTER_THREADS * 16 < gs:
        cs *= 2
    return cs


def _group_view(x, group_size):
    """``x`` flattened and zero-padded to whole groups → ([G, gs], n)."""
    flat = x.reshape(-1)
    n = flat.numel()
    pad = (-n) % group_size
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(-1, group_size), n


# ------------------------------------------------------------ the hash
def _mul32(a, c):
    """(a * c) mod 2^32 for int64 ``a`` in [0, 2^32) without overflowing int64."""
    return ((a & 0xFFFF) * c + ((((a >> 16) * c) & 0xFFFF) << 16)) & _M32


def _mix32(x):
    """lowbias32 on int64 tensors holding uint32 values (the kernel's ``mix32``)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _mix32_int(x):
    x &= _M32
    x ^= x >> 16
    x = (x * 0x7FEB352D) & _M32
    x ^= x >> 15
    x = (x * 0x846CA68B) & _M32
    return x ^ (x >> 16)


def _seed_key(seed):
    return _mix32_int((int(seed) & _M32) ^ 0x9E3779B9)


def _uniform(seed, groups, gs, device):
    """u [groups, gs] in [0, 1): 23 bits of mix32(mix32(key ^ g) ^ index)."""
    g = torch.arange(groups, dtype=torch.int64, device=device)
    key = _mix32(g ^ _seed_key(seed))
    idx = torch.arange(gs, dtype=torch.int64, device=device)
    bits = _mix32(key[:, None] ^ idx[None, :]) >> 9
    return bits.to(torch.float32) * (2.0 ** -23)


# ------------------------------------------------------- plain versions
def quantize_int8_ref(groups, stochastic=False, seed=0):
    """Plain version: ``groups`` [G, gs] (any float dtype) → (int8 [G, gs],
    fp32 scales [G])."""
    x = groups.float()
    absmax = x.abs().amax(dim=-1)
    scales = torch.where(absmax == 0, torch.ones_like(absmax),
                         absmax / torch.full_like(absmax, 127.0))
    scaled = x / scales[:, None]
    if stochastic:
        low = torch.floor(scaled)
        u = _uniform(seed, x.shape[0], x.shape[1], x.device)
        scaled = low + (u < (scaled - low)).to(torch.float32)
    else:
        scaled = torch.round(scaled)
    return scaled.clamp(-127, 127).to(torch.int8), scales


def dequantize_int8_ref(values, scales, dtype=torch.bfloat16):
    """Plain version: ``(float(values) * scales[:, None])`` cast to ``dtype``."""
    return (values.to(torch.float32) * scales[:, None]).to(dtype)


# ------------------------------------------------------------ kernels
def _lib():
    from deepspeed_tpu_torch.ops.kernels.build import load
    lib = load(_SOURCE)
    if lib.ds_quantize_int8.argtypes is None:
        lib.ds_quantize_int8.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_uint, ctypes.c_int,
                                                       ctypes.c_void_p]
        lib.ds_quantize_int8.restype = ctypes.c_int
        lib.ds_dequantize_int8.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_longlong] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.ds_dequantize_int8.restype = ctypes.c_int
    return lib


_SMS = {}


def sm_count(device):
    """The card's SM count (``k7_design``'s ``sms``), asked once a device."""
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return _SMS[device]


def _check_cuda(name, *tensors):
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: every tensor must be on {dev}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def _quant_kernel(groups, stochastic, seed, design=None):
    if groups.dtype not in _DTYPE_CODE:
        raise TypeError(f"quantize_int8 kernel takes bf16 or fp32, got {groups.dtype}")
    groups = groups.contiguous()
    _check_cuda("quantize_int8", groups)
    G, gs = groups.shape
    vec = gs % _VEC[groups.dtype] == 0 and groups.data_ptr() % 16 == 0
    named = k7_design(gs, groups.dtype, G, sm_count(groups.device), vec)
    if design is None:
        design = named
    elif design not in DESIGNS or (design == "cluster" and not cluster_takes(gs, groups.dtype,
                                                                               vec)):
        raise ValueError(f"quantize design {design!r} cannot take groups of {gs} "
                         f"{groups.dtype} values (aligned {vec}); k7_design names {named!r}")
    values = torch.empty((G, gs), dtype=torch.int8, device=groups.device)
    scales = torch.empty(G, dtype=torch.float32, device=groups.device)
    with torch.cuda.device(groups.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().ds_quantize_int8(groups.data_ptr(), values.data_ptr(), scales.data_ptr(),
                                     G, gs, _DTYPE_CODE[groups.dtype], int(vec),
                                     int(bool(stochastic)), _seed_key(seed),
                                     DESIGNS.index(design), stream)
    if rc != 0:
        raise RuntimeError(f"int8 quantize kernel ({design} design) failed to launch: "
                           f"cudaError {rc}")
    quantize_int8.launches += 1
    k7_design_launches[design] += 1
    return values, scales


def _dequant_kernel(values, scales, out, rows):
    """out viewed as [R, gs]; rows int32 [G] on the device or None (row g)."""
    if out.dtype not in _DTYPE_CODE:
        raise TypeError(f"dequantize_int8 kernel writes bf16 or fp32, got {out.dtype}")
    if values.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError("dequantize_int8 takes int8 values and fp32 scales")
    ts = (values, scales, out) + ((rows,) if rows is not None else ())
    _check_cuda("dequantize_int8", *ts)
    G, gs = values.shape
    vec = (gs % 8 == 0 and values.data_ptr() % 8 == 0 and out.data_ptr() % 16 == 0)
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().ds_dequantize_int8(values.data_ptr(), scales.data_ptr(),
                                       rows.data_ptr() if rows is not None else None,
                                       out.data_ptr(), G, gs, _DTYPE_CODE[out.dtype],
                                       int(vec), stream)
    if rc != 0:
        raise RuntimeError(f"int8 dequantize kernel failed to launch: cudaError {rc}")
    dequantize_int8.launches += 1


def _device_kind(t, name):
    if t.is_cuda:
        return "cuda"
    if t.device.type == "cpu":
        return "cpu"
    raise ValueError(f"{name}: unsupported device {t.device}")


# -------------------------------------------------------- entry points
def quantize_int8(x, group_size=2048, stochastic=False, seed=0, design=None):
    """→ ``(values int8 [G, group_size], scales fp32 [G], orig_shape)``.
    Groups are taken over the flattened tensor, zero-padded to a group
    multiple. Pass a step-varying ``seed`` when ``stochastic``. On the card
    the kernel's design is the one :func:`k7_design` names, or ``design``
    where that design can take the groups (measurements, tests)."""
    groups, _ = _group_view(x, int(group_size))
    if _device_kind(groups, "quantize_int8") == "cuda":
        values, scales = _quant_kernel(groups, stochastic, seed, design)
    else:
        values, scales = quantize_int8_ref(groups, stochastic, seed)
    return values, scales, tuple(x.shape)


quantize_int8.launches = 0


def dequantize_int8(values, scales, orig_shape, dtype=None):
    """Inverse of :func:`quantize_int8`. ``dtype`` defaults to bf16, the
    serving dtype, as in the JAX package; pass ``torch.float32`` where
    full precision matters (round-trip bounds)."""
    dtype = torch.bfloat16 if dtype is None else dtype
    if _device_kind(values, "dequantize_int8") == "cuda":
        out = torch.empty(values.shape, dtype=dtype, device=values.device)
        _dequant_kernel(values, scales, out, None)
    else:
        out = dequantize_int8_ref(values, scales, dtype)
    n = math.prod(orig_shape)
    return out.reshape(-1)[:n].reshape(orig_shape)


dequantize_int8.launches = 0


def dequantize_int8_rows(values, scales, out, rows):
    """Dequantize group ``g`` of ``values`` [G, gs] into row ``rows[g]`` of
    ``out`` [R, gs] (a contiguous bf16 or fp32 tensor, written in place:
    the KV pool's restore). Launches the dequantize kernel on CUDA tensors
    (counted in ``dequantize_int8.launches``); the plain version on CPU."""
    if out.dim() != 2 or out.shape[1] != values.shape[1]:
        raise ValueError(f"out must be [R, {values.shape[1]}], got {tuple(out.shape)}")
    if _device_kind(values, "dequantize_int8_rows") == "cuda":
        _dequant_kernel(values, scales, out, rows.to(torch.int32).contiguous())
    else:
        out[rows.long()] = dequantize_int8_ref(values, scales, out.dtype)
    return out
