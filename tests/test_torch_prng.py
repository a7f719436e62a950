"""The port's counter PRNG against JAX's threefry, bit for bit.

``deepspeed_tpu_torch.inference.structured.prng`` re-implements the
threefry2x32 hash, keys, ``fold_in``, ``split``, random bits in the
partitionable layout, uniforms and ``randint`` without jax. Each is held
against the installed jax on the same inputs (numpy seed): integers and
uniforms bitwise, on the host (numpy ``uint32``) and as the int64 tensors
the device path uses. The Gumbel draw's two logs are the only inexact
step: torch's ``log`` and XLA's differ by at most 1 ulp (a reading: 14%
of float32 inputs differ), so a Gumbel value lies within 1 ulp of
``max(|g|, 1)`` of JAX's."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax._src import prng as jax_prng

from deepspeed_tpu.inference.structured import prng as jprng
from deepspeed_tpu_torch.inference.structured import derive_seed
from deepspeed_tpu_torch.inference.structured import prng

SEEDS = (0, 42, 2 ** 31 - 1)


def _u32(rng, *shape):
    return rng.randint(0, 2 ** 32, size=shape, dtype=np.uint64).astype(np.uint32)


def test_jax_defaults_the_port_follows():
    """A jax upgrade that flips the bits layout or the Gumbel mode shows
    here first: the port follows jax 0.9.0's defaults."""
    assert jax.config.jax_threefry_partitionable is True
    assert jax.config.jax_high_dynamic_range_gumbel is False
    assert jax.config.jax_default_prng_impl == "threefry2x32"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_threefry2x32_matches_jax(seed):
    rng = np.random.RandomState(seed)
    k, x = _u32(rng, 2), _u32(rng, 2, 4096)
    want = jax_prng.threefry2x32_p.bind(jnp.uint32(k[0]), jnp.uint32(k[1]), jnp.asarray(x[0]),
                                        jnp.asarray(x[1]))
    host = prng.threefry2x32(k[:1], k[1:], x[0], x[1])
    dev = prng.threefry2x32(*(torch.tensor(v.astype(np.int64)) for v in (k[0], k[1], x[0], x[1])))
    for w, h, d in zip(want, host, dev):
        np.testing.assert_array_equal(h, np.asarray(w))
        np.testing.assert_array_equal(d.numpy(), np.asarray(w).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_fold_in_split_bits_match_jax(seed):
    rng = np.random.RandomState(seed % 1000)
    jkey = jax.random.PRNGKey(seed)
    key = prng.prng_key(seed)
    np.testing.assert_array_equal(key, np.asarray(jkey))
    for d in (0, 7, 0x5A3, 2 ** 20, 2 ** 31 - 1, int(rng.randint(2 ** 31))):
        np.testing.assert_array_equal(prng.fold_in(key, d), np.asarray(jax.random.fold_in(jkey, d)))
    np.testing.assert_array_equal(prng.split(key, 7), np.asarray(jax.random.split(jkey, 7)))
    for shape in ((), (5,), (3, 17)):
        np.testing.assert_array_equal(prng.random_bits(key, shape),
                                      np.asarray(jax.random.bits(jkey, shape)))
        np.testing.assert_array_equal(
            prng.flat_bits(prng.key_tensor(key, "cpu"), shape).numpy(),
            np.asarray(jax.random.bits(jkey, shape)).astype(np.int64))
    np.testing.assert_array_equal(prng.base_sampling_key(seed),
                                  np.asarray(jprng.base_sampling_key(seed)))


@pytest.mark.parametrize("seed", SEEDS)
def test_token_keys_bits_uniform_match_jax(seed):
    rng = np.random.RandomState(seed % 997)
    n, V = 16, 2048
    seeds = rng.randint(0, 2 ** 31, n).astype(np.int32)
    pos = rng.randint(0, 2 ** 20 + 1, n).astype(np.int32)
    pos[0], pos[1] = 0, 2 ** 20
    jbase = jprng.base_sampling_key(seed)
    jkeys = np.asarray(jprng.token_keys(jbase, jnp.asarray(seeds), jnp.asarray(pos)))
    keys = prng.token_keys(prng.key_tensor(prng.base_sampling_key(seed), "cpu"),
                           torch.from_numpy(seeds), torch.from_numpy(pos))
    np.testing.assert_array_equal(keys.numpy(), jkeys.astype(np.int64))
    bits = prng.row_bits(keys, V)
    jbits = np.stack([np.asarray(jax.random.bits(k, (V,))) for k in jkeys])
    np.testing.assert_array_equal(bits.numpy(), jbits.astype(np.int64))
    tiny = np.finfo(np.float32).tiny
    ju = np.stack([np.asarray(jax.random.uniform(k, (V,), minval=tiny, maxval=1.0))
                   for k in jkeys])
    np.testing.assert_array_equal(prng.uniform_from_bits(bits).numpy().view(np.int32),
                                  ju.view(np.int32))


def test_gumbel_within_one_ulp_of_jax():
    rng = np.random.RandomState(3)
    keys = rng.randint(0, 2 ** 32, size=(8, 2), dtype=np.uint64).astype(np.uint32)
    V = 8192
    jg = np.stack([np.asarray(jax.random.gumbel(k, (V,))) for k in keys])
    g = prng.gumbel_from_bits(prng.row_bits(torch.from_numpy(keys.astype(np.int64)), V)).numpy()
    ulp = np.maximum(np.abs(jg), 1.0) * 2.0 ** -23
    assert np.all(np.abs(g - jg) <= ulp), np.max(np.abs(g - jg) / ulp)
    # each log alone is within 1 ulp of XLA's
    u = prng.uniform_from_bits(prng.row_bits(torch.from_numpy(keys.astype(np.int64)), V))
    jl = np.asarray(jax.jit(lambda x: -jnp.log(x))(u.numpy()))
    d = np.abs(jl.view(np.int32).astype(np.int64) - (-torch.log(u)).numpy().view(np.int32))
    assert d.max() <= 1


def test_draw_seed_stream_matches_jax():
    """The engine's ``draw_seed`` stream: ``split`` then ``randint(0, 2**31
    - 1)`` from ``fold_in(PRNGKey(42), 7)``, 64 draws."""
    jkey = jax.random.fold_in(jax.random.PRNGKey(42), 7)
    key = prng.fold_in(prng.prng_key(42), 7)
    for _ in range(64):
        jkey, jsub = jax.random.split(jkey)
        key, sub = prng.split(key, 2)
        assert prng.randint31(sub) == int(jax.random.randint(jsub, (), 0, 2 ** 31 - 1))
    np.testing.assert_array_equal(key, np.asarray(jkey))


def test_derive_seed_matches_jax():
    rng = np.random.RandomState(0)
    for base, uid in zip(rng.randint(0, 2 ** 31, 10_000), rng.randint(0, 2 ** 62, 10_000)):
        assert derive_seed(int(base), int(uid)) == jprng.derive_seed(int(base), int(uid))
