"""Weight-only quantization of the serving params: grouped int8, fp8 and
fp6 carriers.

Port of ``deepspeed_tpu/inference/quantization/quantization.py`` for
the grouped (structure-preserving) layout: groups run along the LAST
axis only, every leading dim is kept, so a stacked ``[L, ...]`` leaf
quantizes once and each layer's slice (``qw[i]``) is itself a carrier.
int8 and fp8 keep the weight's shape; fp6 packs the last dim to 3/4 of
its bytes; scales are fp32 with the group count in place of the last
dim. The carriers are byte for byte the JAX package's. The flat layout
is not ported yet (ROADMAP.md, port queue item 18).

:func:`quantize_params_tree` quantizes the port's serving param dict
(``models.llama`` layout) leaf by leaf; :func:`matmul_any` and
:meth:`QuantizedWeight.matmul` run ``x @ w`` through the fused kernel
(``ops/kernels/fused_quant_matmul``) for a carrier and as a plain matmul
for a dense tensor. A carrier is a plain object, not a tensor: code that
casts every floating leaf to the serving dtype must skip it, or it would
cast ``float8_e4m3fn`` carriers (``is_floating_point`` is True for them)
into garbage.
"""

import re

import torch

from deepspeed_tpu_torch.ops.fp_quantizer.quantize import FP6_MAX, _encode_e3m2, pack_fp6
from deepspeed_tpu_torch.ops.kernels.fused_quant_matmul import (SCHEMES, dequantize_grouped,
                                                                 quant_matmul)
from deepspeed_tpu_torch.roadmap import not_ported

_FMAX = {"int8": 127.0, "fp8": 448.0, "fp6": FP6_MAX}

# The port's names for the leaves the JAX pattern ``kernel|embed|experts_w``
# matches: every projection kernel (the router's ``gate.wg.kernel``
# included), the embedding and the head; not the norm scales or biases.
QUANTIZED_LEAVES = r"^(embed_tokens|lm_head|w[qkvo]|w_gate|w_up|w_down|gate_wg|experts_w[123])$"


class QuantizedWeight:
    """One grouped-layout quantized leaf: ``values`` (int8,
    ``float8_e4m3fn``, or packed fp6 uint8) and fp32 ``scales``, for a
    weight of ``shape``. ``dequant_dtype`` is what :meth:`dequantized`
    and :meth:`matmul` decode to unless told otherwise."""

    def __init__(self, values, scales, shape, scheme, layout="grouped",
                 dequant_dtype=torch.bfloat16):
        if layout != "grouped":
            raise not_ported(f"the {layout!r} quantized layout", 18)
        if scheme not in SCHEMES:
            raise ValueError(f"unknown quantization scheme {scheme!r}: expected {SCHEMES}")
        self.values = values
        self.scales = scales
        self.shape = tuple(shape)
        self.scheme = scheme
        self.layout = layout
        self.dequant_dtype = dequant_dtype

    def __getitem__(self, i):
        """The carrier of ``w[i]`` (one layer, or one expert, of a stack)."""
        if not isinstance(i, int):
            raise TypeError(f"a carrier is indexed by an int (one leading slice), got {i!r}")
        return QuantizedWeight(self.values[i], self.scales[i], self.shape[1:], self.scheme,
                               self.layout, self.dequant_dtype)

    @property
    def device(self):
        return self.values.device

    def to(self, device):
        return QuantizedWeight(self.values.to(device), self.scales.to(device), self.shape,
                               self.scheme, self.layout, self.dequant_dtype)

    def dequantized(self, dtype=None):
        return dequantize_grouped(self.values, self.scales, self.scheme,
                                  dtype or self.dequant_dtype)

    def matmul(self, x, dtype=None):
        """``x @ dequant(self)`` through :func:`quant_matmul`: the fused
        kernel on the card (2-D carriers only; a stacked one raises there),
        the plain version on the CPU. ``dtype`` overrides
        ``dequant_dtype``."""
        return quant_matmul(x, self.values, self.scales, self.scheme,
                            dequant_dtype=dtype or self.dequant_dtype)

    def nbytes(self):
        return (self.values.numel() * self.values.element_size() +
                self.scales.numel() * self.scales.element_size())

    def __repr__(self):
        return (f"QuantizedWeight({self.scheme}, shape={self.shape}, "
                f"values={tuple(self.values.shape)}, scales={tuple(self.scales.shape)})")


def _pick_group(last, group_size, multiple=1):
    """Largest group g <= group_size with last % g == 0 and g % multiple
    == 0 (no padding); None if there is none."""
    last, group_size = int(last), int(group_size)
    if last % group_size == 0 and group_size % multiple == 0:
        return group_size
    best = None
    d = multiple
    while d <= min(last, group_size):
        if last % d == 0:
            best = d
        d += multiple
    return best


def _quantize_grouped(x, scheme, group_size, dequant_dtype=torch.bfloat16):
    """Group quantization along the last axis → a :class:`QuantizedWeight`,
    or ``x`` unchanged when no legal group exists (fp6 needs groups of a
    multiple of 4 codes)."""
    if scheme not in SCHEMES:
        raise ValueError(f"unknown quantization scheme {scheme!r}: expected {SCHEMES}")
    last = x.shape[-1]
    g = _pick_group(last, group_size, multiple=4 if scheme == "fp6" else 1)
    if g is None:
        return x
    gx = x.float().reshape(x.shape[:-1] + (last // g, g))
    absmax = gx.abs().amax(dim=-1, keepdim=True)
    scales = torch.where(absmax == 0.0, torch.ones_like(absmax), absmax / _FMAX[scheme])
    scaled = gx / scales
    if scheme == "fp6":
        v = pack_fp6(_encode_e3m2(scaled)).reshape(x.shape[:-1] + (last * 3 // 4,))
    elif scheme == "fp8":
        v = scaled.to(torch.float8_e4m3fn).reshape(x.shape)
    else:
        v = torch.clamp(torch.round(scaled), -127, 127).to(torch.int8).reshape(x.shape)
    return QuantizedWeight(v, scales[..., 0], x.shape, scheme, dequant_dtype=dequant_dtype)


def matmul_any(x, w, dtype=None):
    """``x @ w`` for a dense tensor or a :class:`QuantizedWeight`, ``w``
    taken in ``dtype`` when given."""
    if isinstance(w, QuantizedWeight):
        return w.matmul(x, dtype=dtype)
    return x @ (w.to(dtype) if dtype is not None else w)


def quantize_params_tree(params, scheme, dequant_dtype=torch.bfloat16, group_size=512,
                         pattern=QUANTIZED_LEAVES, device=None):
    """The port's serving params with every >= 2-D floating leaf whose
    name matches ``pattern`` as a grouped carrier, every other floating
    leaf cast to ``dequant_dtype``. Leaves that already are carriers pass
    through (moved to ``device``). Leaf by leaf: each source leaf is
    moved to ``device`` (its own device when None), quantized and let go
    before the next, so only one full-precision leaf is live at a time
    besides the caller's own tree."""
    pat = re.compile(pattern)

    def leaf(name, x):
        if isinstance(x, QuantizedWeight):
            return x if device is None else x.to(device)
        x = torch.as_tensor(x) if device is None else torch.as_tensor(x).to(device)
        if x.dim() >= 2 and x.is_floating_point() and pat.search(name):
            q = _quantize_grouped(x, scheme, group_size, dequant_dtype=dequant_dtype)
            if isinstance(q, QuantizedWeight):
                return q
        return x.to(dequant_dtype) if x.is_floating_point() else x

    return {k: ({n: leaf(n, w) for n, w in v.items()} if isinstance(v, dict) else leaf(k, v))
            for k, v in params.items()}


def quantized_bytes(tree):
    """Resident bytes of a param tree: carriers and scales for quantized
    leaves, the storage of every other tensor."""
    total = 0
    for v in tree.values():
        if isinstance(v, dict):
            total += quantized_bytes(v)
        elif isinstance(v, QuantizedWeight):
            total += v.nbytes()
        else:
            total += v.numel() * v.element_size()
    return total

