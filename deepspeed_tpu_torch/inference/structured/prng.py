"""Counter-based sampling PRNG.

Port of ``deepspeed_tpu/inference/structured/prng.py``. Every sampled
token's randomness is a counter lookup:

    key(token) = fold_in(fold_in(PRNGKey(DS_SEED), request_seed),
                         absolute_position)

``request_seed`` is resolved once per request and ``absolute_position``
is the token's index in the sequence, so stepwise decode and k-step
bursts draw the same token at every position, on any replica.

The keys and bits equal JAX's bit for bit: the threefry2x32 hash (20
rounds, JAX's ``_threefry2x32_lowering``), keys as two 32-bit words,
``fold_in``/``split`` as JAX's threefry implementation computes them,
and random bits in the partitionable layout (``jax_threefry_partitionable``,
on by default in jax 0.9.0): ``bits[j] = b1 ^ b2`` where ``(b1, b2) =
threefry2x32(key, (hi(j), lo(j)))`` over the flat index ``j``.

One hash serves two representations of a 32-bit word: numpy ``uint32``
arrays on the host (the base key, ``draw_seed``: no device sync) and
``int64`` tensors on the device (``torch.uint32`` lacks most CUDA ops),
masked to 32 bits after every add and shift. A key is a pair of words;
on the device, per-row keys are an ``int64`` tensor ``[N, 2]``."""

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# domain-separation constant: keeps the sampling counter stream disjoint
# from the param-init / dropout streams that also hang off DS_SEED
_SAMPLING_DOMAIN = 0x5A3
_F32_TINY = float(np.finfo(np.float32).tiny)


def _rotl(x, r):
    return ((x << r) & M32) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """The threefry2x32 hash of counter words ``(x0, x1)`` under key
    ``(k0, k1)`` → ``(y0, y1)``. Arguments broadcast; numpy ``uint32``
    arrays or ``int64`` tensors holding values in [0, 2**32)."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


# ------------------------------------------------------------------ host
def _words(*xs):
    return tuple(np.asarray(x, np.uint32).reshape(-1) for x in xs)


def prng_key(seed):
    """``jax.random.PRNGKey(seed)`` → ``uint32[2]`` (the seed as a 64-bit
    integer split into its high and low words)."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return np.array([seed >> 32, seed & M32], np.uint32)


def fold_in(key, data):
    """``jax.random.fold_in(key, data)`` on the host → ``uint32[2]``."""
    k0, k1, d = _words(key[0], key[1], int(data) & M32)
    y0, y1 = threefry2x32(k0, k1, np.zeros_like(d), d)
    return np.concatenate([y0, y1])


def split(key, n=2):
    """``jax.random.split(key, n)`` on the host → ``uint32[n, 2]``: row i
    is ``threefry2x32(key, (0, i))``."""
    k0, k1 = _words(key[0], key[1])
    i = np.arange(n, dtype=np.uint32)
    y0, y1 = threefry2x32(k0, k1, np.zeros_like(i), i)
    return np.stack([y0, y1], axis=1)


def random_bits(key, shape):
    """``jax.random.bits(key, shape, uint32)`` on the host."""
    k0, k1 = _words(key[0], key[1])
    j = np.arange(int(np.prod(shape)), dtype=np.uint64)
    y0, y1 = threefry2x32(k0, k1, (j >> np.uint64(32)).astype(np.uint32),
                          (j & np.uint64(M32)).astype(np.uint32))
    return (y0 ^ y1).reshape(shape)


def randint31(key):
    """``jax.random.randint(key, (), 0, 2**31 - 1)`` (int32): two bits
    draws from the key's split, span ``2**31 - 1``, and JAX's ``uint32``
    arithmetic: the multiplier ``(2**16 % span)**2`` wraps to 0 before
    its remainder, and the sum wraps modulo 2**32 before its last one."""
    span = 2 ** 31 - 1
    k1, k2 = split(key, 2)
    hi, lo = int(random_bits(k1, ())), int(random_bits(k2, ()))
    mult = (((2 ** 16 % span) ** 2) & M32) % span
    return (((((hi % span) * mult) & M32) + lo % span) & M32) % span


def base_sampling_key(seed):
    """The engine-wide root key all per-token keys fold into, from
    ``DS_SEED``: every replica shares it, and the per-request ``seed``
    is what decorrelates requests."""
    return fold_in(prng_key(seed), _SAMPLING_DOMAIN)


def derive_seed(base: int, uid: int) -> int:
    """Deterministic per-request sampling seed from a stable request
    identity (splitmix-style integer hash — NOT Python ``hash``, which
    is salted for some types). Gateways and the fleet router call this
    at submit time for requests whose sampling spec carries no explicit
    ``seed``; deriving from the *router* uid makes every failover
    attempt replay with the identical seed."""
    x = (int(base) * 0x9E3779B1 + int(uid) * 0x85EBCA77) & 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x7FEB352D) & 0xFFFFFFFF
    x ^= x >> 15
    x = (x * 0x846CA68B) & 0xFFFFFFFF
    x ^= x >> 16
    return int(x & 0x7FFFFFFF)


# ---------------------------------------------------------------- device
def key_tensor(key, device):
    """A host ``uint32[2]`` key → ``int64[2]`` on ``device``."""
    return torch.tensor(np.asarray(key, np.int64), device=device)


def fold_in_rows(keys, data):
    """Row-wise ``fold_in``: ``keys`` int64 ``[2]`` or ``[N, 2]``,
    ``data`` integer ``[N]`` (non-negative, < 2**32) → int64 ``[N, 2]``."""
    d = data.to(torch.int64) & M32
    y0, y1 = threefry2x32(keys[..., 0], keys[..., 1], torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=-1)


def token_keys(base, seeds, positions):
    """Per-row keys for a batch of draws, on the device: ``base`` int64
    ``[2]``, ``seeds``/``positions`` integer ``[N]`` → int64 ``[N, 2]``,
    row i = ``fold_in(fold_in(base, seeds[i]), positions[i])``."""
    return fold_in_rows(fold_in_rows(base, seeds), positions)


def row_bits(keys, n):
    """Row i's ``jax.random.bits(keys[i], (n,))``: ``keys`` int64 ``[N,
    2]`` → int64 ``[N, n]`` in [0, 2**32)."""
    j = torch.arange(n, dtype=torch.int64, device=keys.device)
    y0, y1 = threefry2x32(keys[:, :1], keys[:, 1:], torch.zeros_like(j), j)
    return y0 ^ y1


def flat_bits(key, shape):
    """``jax.random.bits(key, shape)`` for one key (int64 ``[2]``): the
    counter runs over the flat index."""
    j = torch.arange(int(np.prod(shape)), dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[0], key[1], j >> 32, j & M32)
    return (y0 ^ y1).reshape(shape)


def uniform_from_bits(bits):
    """``jax.random.uniform(·, minval=tiny, maxval=1)`` in float32 from its
    bits: the top 23 bits as a mantissa in [1, 2), minus one, scaled to
    [tiny, 1): JAX's ``u * (1 - tiny) + tiny``, where ``1 - tiny`` rounds
    to 1 in float32."""
    u = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(u + _F32_TINY, _F32_TINY)


def gumbel_from_bits(bits):
    """``jax.random.gumbel`` in mode ``"low"`` (the default) from its bits:
    ``-log(-log(u))``."""
    return -torch.log(-torch.log(uniform_from_bits(bits)))
