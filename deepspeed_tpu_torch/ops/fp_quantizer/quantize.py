"""FP6 e3m2 codes: encode, decode, pack and unpack, bit for bit.

Port of the codec half of ``deepspeed_tpu/ops/fp_quantizer/quantize.py``
as torch integer ops. A code is 6 bits, ``sign << 5 | E << 2 | M`` (the
FP6-LLM e3m2 format, exponent bias 3, largest magnitude 28); four codes
pack into one little-endian 24-bit word at bit offsets 0/6/12/18, stored
as 3 bytes. Encoding rounds to nearest even, with the carry into the
exponent field handled by the integer add; decoding assembles fp32 bits
directly. The grouped weight carriers (``inference/quantization``) and
the fused kernels' decode (``csrc/quant_gemm.cuh``) use these exact
rules. The flat ``FP_Quantize`` API is not on the serving path and is
not ported yet (ROADMAP.md, port queue item 18)."""

import torch

FP6_MAX = 28.0  # e3m2 bias 3: (1 + 3/4) * 2^(7-3)

_FP6_CODE_SHIFTS = (0, 6, 12, 18)
_E3M2_EXP_BIAS = 3
_E3M2_SUBNORMAL_STEP = 0.0625  # codes 0..7: the linear grid n * 2^-4


def _encode_e3m2(x):
    """fp32 → uint8 codes 0..63 (sign<<5 | E<<2 | M), RNE, |x| clipped to 28."""
    sign = (x < 0).to(torch.uint8)
    a = torch.clamp(x.abs(), max=FP6_MAX).float()
    # codes 0..7 form the linear grid n * 0.0625, so below 0.5 the code is
    # plain RNE division (0.46875.. rounds to code 8 = 0.5 seamlessly)
    code_small = torch.round(a / _E3M2_SUBNORMAL_STEP).to(torch.int32)
    # normals >= 0.5: RNE the fp32 mantissa to 2 bits by adding
    # (2^20 - 1) + the kept lsb and truncating; the carry runs into the
    # exponent field, which handles mantissa overflow exactly
    bits = a.contiguous().view(torch.int32)
    keep_lsb = (bits >> 21) & 1
    r = bits + 0x0FFFFF + keep_lsb
    exp = ((r >> 23) & 0xFF) - 127  # [-1, 4] for a in [0.5, 28]
    man = (r >> 21) & 0x3
    code_normal = ((exp + _E3M2_EXP_BIAS) << 2) | man
    code = torch.where(a < 0.5, code_small, code_normal).to(torch.uint8)
    return code | (sign << 5)


def _decode_e3m2(code):
    """uint8 codes → fp32 values. Magnitudes >= 8 are assembled as fp32
    bits (sign into bit 31, ``E - 3 + 127`` into the exponent, M into the
    top of the mantissa); codes 0..7 are the grid ±mag * 2^-4."""
    c = code.to(torch.int32)
    neg = (c & 0x20) != 0
    mag = c & 0x1F
    e = mag >> 2
    m = mag & 3
    # the sign goes on by negation (flipping bit 31), which keeps the
    # int32 assembly clear of bit 31
    normal = (((e + (127 - _E3M2_EXP_BIAS)) << 23) | (m << 21)).view(torch.float32)
    normal = torch.where(neg, -normal, normal)
    small = torch.where(neg, -_E3M2_SUBNORMAL_STEP, _E3M2_SUBNORMAL_STEP) * mag.float()
    return torch.where(mag < 8, small, normal)


def pack_fp6(codes):
    """uint8 codes [..., 4n] → packed carrier bytes [..., 3n]: each quad
    of codes is one little-endian 24-bit word, emitted as 3 bytes."""
    if codes.shape[-1] % 4:
        raise ValueError(f"fp6 pack needs a multiple of 4 codes, got last dim "
                         f"{codes.shape[-1]}")
    c = codes.reshape(codes.shape[:-1] + (-1, 4)).to(torch.int32)
    u = c[..., 0]
    for i, s in enumerate(_FP6_CODE_SHIFTS[1:], start=1):
        u = u | (c[..., i] << s)
    b = torch.stack([u & 0xFF, (u >> 8) & 0xFF, (u >> 16) & 0xFF], dim=-1)
    return b.reshape(codes.shape[:-1] + (codes.shape[-1] // 4 * 3,)).to(torch.uint8)


def unpack_fp6(packed):
    """packed bytes [..., 3n] → uint8 codes [..., 4n] (inverse of
    :func:`pack_fp6`); raises when the length cannot hold whole words."""
    if packed.shape[-1] % 3:
        raise ValueError(f"packed fp6 carrier last dim {packed.shape[-1]} is not divisible "
                         f"by 3 (4 codes pack into 3 bytes)")
    b = packed.reshape(packed.shape[:-1] + (-1, 3)).to(torch.int32)
    u = b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16)
    codes = torch.stack([(u >> s) & 0x3F for s in _FP6_CODE_SHIFTS], dim=-1)
    return codes.reshape(packed.shape[:-1] + (packed.shape[-1] // 3 * 4,)).to(torch.uint8)
