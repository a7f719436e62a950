"""The port's sampling modules against the JAX package's.

- ``validate_sample_spec`` accepts and rejects the same specs, with the
  same messages; ``sample_spec_key`` agrees.
- ``pack_sample_meta`` gives the same int32 bytes; ``unpack_sample_meta``
  reads them back.
- ``sample_rows`` (the ragged engine's packed sampler) and the static
  ``sample_tokens`` give the same tokens as JAX's on ``[64, V]`` fp32
  logits from a numpy seed, over greedy rows, ``top_k`` 1 and past the
  vocabulary, ``top_p`` 1 and 0.05, and temperatures 0.3-1.5.

The keys and bits are bitwise JAX's (``test_torch_prng.py``). Three
steps are not: the Gumbel logs (within 1 ulp), the softmax's ``exp`` and
sum (within SOFTMAX_ULPS of XLA's, reading 10) and the nucleus's
``cumsum`` (within CUMSUM_ABS of XLA's, reading 4.2e-7: torch sums a
float32 row in double on the CPU). A token could flip only where two
candidates' Gumbel-perturbed logits, or a cumulative probability and
``top_p``, lie within those bounds; no case here does."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.inference import sampling as jsampling
from deepspeed_tpu.inference.structured import prng as jprng
from deepspeed_tpu.inference.structured import sampling as jstructured
from deepspeed_tpu_torch.inference import sampling
from deepspeed_tpu_torch.inference.structured import prng
from deepspeed_tpu_torch.inference.structured import sampling as structured

SOFTMAX_ULPS = 16
CUMSUM_ABS = 2.0 ** -20

SPECS = [
    {}, {"temperature": 0.7}, {"temperature": np.float32(1.5), "top_k": np.int64(3)},
    {"top_k": 0, "top_p": 1.0, "seed": 0}, {"top_p": 0.05, "seed": 2 ** 31 - 1},
    {"temperature": 0}, {"temperature": -1.0}, {"temperature": "1"}, {"top_k": -1},
    {"top_k": 1.5}, {"top_p": 0.0}, {"top_p": 1.01}, {"seed": -1}, {"seed": 2 ** 31},
    {"seed": 1.0}, {"temp": 1.0}, {"temperature": 1.0, "topk": 3},
]


def _outcome(fn, spec):
    try:
        return ("ok", fn(dict(spec)))
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("spec", SPECS, ids=[str(s) for s in SPECS])
def test_validate_sample_spec_matches_jax(spec):
    assert _outcome(sampling.validate_sample_spec, spec) == \
        _outcome(jsampling.validate_sample_spec, spec)
    assert _outcome(sampling.sample_spec_key, spec) == _outcome(jsampling.sample_spec_key, spec)


def _specs(rng, n, V):
    """A spec per row: greedy rows, top_k 1, top_k past V, top_p 1 and
    0.05, top-k with a nucleus, temperatures 0.3-1.5."""
    out = []
    for i in range(n):
        kind = i % 8
        if kind == 0:
            out.append(None)
            continue
        s = {"temperature": float(rng.uniform(0.3, 1.5)), "seed": int(rng.randint(0, 2 ** 31))}
        s.update([{}, {"top_k": 1}, {"top_k": V + 5}, {"top_p": 0.05}, {"top_p": 1.0},
                  {"top_k": 20, "top_p": 0.9}, {"top_p": 0.7}, {}][kind])
        out.append(s)
    return out


def test_pack_sample_meta_is_byte_equal():
    rng = np.random.RandomState(0)
    specs = _specs(rng, 12, 100) + [{"temperature": 0.9, "seed": 2 ** 31 + 5}]
    for n in (13, 16):
        got, want = structured.pack_sample_meta(specs, n), jstructured.pack_sample_meta(specs, n)
        assert got.dtype == want.dtype == np.int32
        assert got.tobytes() == want.tobytes()
        for a, b in zip(structured.unpack_sample_meta(torch.from_numpy(got), n),
                        jstructured.unpack_sample_meta(jnp.asarray(want), n)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert structured.SAMPLE_META_ROWS == jstructured.SAMPLE_META_ROWS


@pytest.mark.parametrize("V", [256, 32000])
def test_sample_rows_tokens_equal_jax(V):
    rng = np.random.RandomState(V)
    n = 64
    base = prng.key_tensor(prng.base_sampling_key(42), "cpu")
    jbase = jprng.base_sampling_key(42)
    run = jax.jit(jstructured.sample_rows)
    for trial in range(3):
        logits = (rng.randn(n, V) * (1 + trial)).astype(np.float32)
        meta = structured.pack_sample_meta(_specs(rng, n, V), n)
        pos = rng.randint(0, 2 ** 20, n).astype(np.int32)
        temp, top_k, top_p, seed, _, _ = jstructured.unpack_sample_meta(jnp.asarray(meta), n)
        want = np.asarray(run(jnp.asarray(logits), jprng.token_keys(jbase, seed, jnp.asarray(pos)),
                              temp, top_k, top_p))
        t = structured.unpack_sample_meta(torch.from_numpy(meta), n)
        keys = prng.token_keys(base, t[3], torch.from_numpy(pos))
        got = structured.sample_rows(torch.from_numpy(logits), keys, t[0], t[1], t[2])
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        # greedy rows (temperature bits 0) and top_k 1 rows are the argmax
        arg = logits.argmax(-1)
        np.testing.assert_array_equal(got.numpy()[0::8], arg[0::8])
        np.testing.assert_array_equal(got.numpy()[1::8], arg[1::8])


@pytest.mark.parametrize("t,k,p", [(1.0, 0, 1.0), (0.3, 0, 1.0), (1.0, 1, 1.0), (1.2, 20, 1.0),
                                   (0.8, 0, 0.9), (1.5, 50, 0.05), (0.5, 40000, 0.3)])
def test_sample_tokens_equal_jax(t, k, p):
    rng = np.random.RandomState(int(t * 10) + k)
    logits = (rng.randn(64, 32000) * 2).astype(np.float32)
    key = jax.random.PRNGKey(int(rng.randint(1000)))
    want = np.asarray(jsampling.sample_tokens(jnp.asarray(logits), key, t, k, p))
    got = sampling.sample_tokens(torch.from_numpy(logits), np.asarray(key), t, k, p)
    np.testing.assert_array_equal(got.numpy(), want)


def test_softmax_and_cumsum_within_stated_bounds():
    rng = np.random.RandomState(0)
    x = -np.sort(-(rng.randn(64, 32000) * 3).astype(np.float32), axis=-1)
    x[:8, 50:] = -np.inf  # a top-k row
    want = np.asarray(jax.jit(jax.nn.softmax)(x))
    got = sampling.softmax_rows(torch.from_numpy(x)).numpy()
    spacing = np.spacing(np.maximum(np.abs(want), np.finfo(np.float32).tiny))
    assert np.max(np.abs(got - want) / spacing) <= SOFTMAX_ULPS
    want_cum = np.asarray(jax.jit(lambda p: jnp.cumsum(p, axis=-1))(want))
    got_cum = torch.cumsum(torch.from_numpy(want.copy()), dim=-1).numpy()
    assert np.max(np.abs(got_cum - want_cum)) <= CUMSUM_ABS
