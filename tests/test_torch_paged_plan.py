"""The tiled design of K3 (``csrc/paged_attention.cu``'s
``paged_tiled_kernel``), on the CPU: how it cuts the tokens into query
tiles (``paged_tiles_ref``, the plain version of what each block finds
out by itself), the shape predicate ``paged_design``, the cut of a long
context into chunks of ``CHUNK`` absolute positions, and its arithmetic.

The arithmetic is emulated in fp32 in the kernel's cut and order: one
(tile, KV head) packs the tile's tokens x G query heads as rows; each
chunk of CHUNK positions walks KT-row KV tiles from its first position
(m from NEG_INF, masked scores -inf, alpha = exp2(m - m_new), P as two
bf16 terms for P·V, hi = bf16(p) and lo = bf16(p - hi), when asked, and
else in fp32, l summed from fp32 P in four partial sums,
one a quarter of the KV tile's rows, added in order at the end); a tile
whose context spans several chunks merges their states in ascending
order, s = c0, s = merge(s, c1), .... Every product is written as one
element at a time in a fixed order, so the emulation's bits depend on a
row's own data and the cut alone, as the kernel's do (mma.sync computes
each element by itself).

The emulation is held against the JAX package's ``xla_paged_attention``
and its Pallas kernel ``paged_decode_attention(..., interpret=True)`` on
fp32 inputs made with numpy from a seed: within 1e-5 with P in fp32
(sums in another order), and within 2^-16 x max|v| + 1e-5 with P as hi +
lo (hi + lo is off p by at most 2^-18 of p, so the weighted mean of V
moves by at most 2^-18 of V's largest magnitude; the bound leaves room). A row's emulated output
is bitwise equal alone, in a tile of any length, first or last in it,
beside other sequences and across a chunk cut."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepspeed_tpu.ops.pallas.paged_attention import (paged_decode_attention as jax_pallas,
                                                      xla_paged_attention)
from deepspeed_tpu_torch.ops.kernels import paged_attention as pa

NEG_INF = -1e30
LOG2E = 1.4426950408889634


# ---------------------------------------------------------------- emulation
def _rows_dot(a, b):
    """[R, D] x [N, D] -> [R, N], each element summed over D in order."""
    out = torch.zeros(a.shape[0], b.shape[0], dtype=torch.float32)
    for d in range(a.shape[1]):
        out = out + a[:, d:d + 1] * b[None, :, d]
    return out


def _weighted(p, v):
    """[R, N] x [N, D] -> [R, D], each element summed over N in order."""
    out = torch.zeros(p.shape[0], v.shape[1], dtype=torch.float32)
    for j in range(p.shape[1]):
        out = out + p[:, j:j + 1] * v[None, j]
    return out


def _exp2(x):
    """exp2 with every element on the vectorized path (torch's CPU loop
    takes a scalar exp2 for the tail of a length that is not a multiple
    of its vector width, which can differ in the last bit)."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % 64
    return torch.exp2(torch.cat([flat, flat.new_zeros(pad)]))[:flat.numel()].reshape(x.shape)


def emulate(q, kc, vc, tables, pos, round_p=True, chunk=pa.CHUNK, record=None):
    """The tiled kernel's arithmetic → [T, H, Dh] fp32. ``record``, a
    dict, gets each (token, head)'s chunk states' kv ranges."""
    T, H, Dh = q.shape
    _, bs, Hkv, _ = kc.shape
    MB = tables.shape[1]
    G, KT = H // Hkv, pa.kv_tile(Dh)
    scale_log2 = LOG2E / math.sqrt(Dh)
    out = torch.zeros(T, H, Dh, dtype=torch.float32)
    for t0, n in pa.paged_tiles_ref(tables, pos, G, bs):
        tl, p0 = t0 + n - 1, int(pos[t0])
        ctx = min(p0 + n, MB * bs)
        nc = -(-ctx // chunk)
        tab = tables[tl].long()
        for kvh in range(Hkv):
            Q = torch.stack([q[t0 + r // G, kvh * G + r % G] for r in range(n * G)]).float()
            lim = torch.tensor([min(p0 + r // G + 1, MB * bs) for r in range(n * G)])
            states = []
            for c in range(nc):
                kv_b, kv_e = c * chunk, min(c * chunk + chunk, ctx)
                m = torch.full((n * G,), NEG_INF)
                lq = [torch.zeros(n * G) for _ in range(4)]  # a quarter of each KV tile
                acc = torch.zeros(n * G, Dh)
                for col0 in range(kv_b, kv_e, KT):
                    cols = torch.arange(col0, col0 + KT)
                    live = cols < kv_e
                    blk = tab[torch.where(live, cols, 0) // bs]
                    K = torch.where(live[:, None], kc[blk, cols % bs, kvh].float(), 0.0)
                    V = torch.where(live[:, None], vc[blk, cols % bs, kvh].float(), 0.0)
                    s = _rows_dot(Q, K)
                    ok = cols[None, :] < torch.minimum(lim, torch.tensor(kv_e))[:, None]
                    s = torch.where(ok, s * scale_log2, torch.tensor(-math.inf))
                    m_new = torch.maximum(m, s.max(1).values)
                    alpha = _exp2(m - m_new)
                    p = _exp2(s - m_new[:, None])
                    for w in range(4):
                        lq[w] = lq[w] * alpha
                        for j in range(w * KT // 4, (w + 1) * KT // 4):
                            lq[w] = lq[w] + p[:, j]
                    if round_p:
                        hi = p.to(torch.bfloat16).float()
                        lo = (p - hi).to(torch.bfloat16).float()
                        acc = (acc * alpha[:, None] + _weighted(hi, V)) + _weighted(lo, V)
                    else:
                        acc = acc * alpha[:, None] + _weighted(p, V)
                    m = m_new
                states.append((m, ((lq[0] + lq[1]) + lq[2]) + lq[3], acc))
                if record is not None:
                    for r in range(n * G):
                        record.setdefault((t0 + r // G, kvh * G + r % G), []).append(
                            (kv_b, min(kv_e, int(lim[r]))))
            sm, sl, sa = states[0]
            for mc, lc, ac in states[1:]:
                mn = torch.maximum(sm, mc)
                fa, fb = _exp2(sm - mn), _exp2(mc - mn)
                sl = sl * fa + lc * fb
                sa = sa * fa[:, None] + ac * fb[:, None]
                sm = mn
            res = sa * (1.0 / sl)[:, None]
            for r in range(n * G):
                out[t0 + r // G, kvh * G + r % G] = res[r]
    return out


def make_case(seed, seqs, H, Hkv, Dh, bs, MB, pad_rows=0, share=None):
    """``seqs``: (first position, tokens) a sequence, each on its own
    random blocks of one pool (``share``: (i, j, blocks) gives sequence j
    sequence i's first table entries); then ``pad_rows`` pad rows (all-null
    table, position 0). → fp32 numpy q, kc, vc, int32 tables, pos."""
    rng = np.random.RandomState(seed)
    NB = 1 + len(seqs) * MB
    perm = rng.permutation(np.arange(1, NB)).astype(np.int32).reshape(len(seqs), MB)
    if share is not None:
        i, j, nb = share
        perm[j, :nb] = perm[i, :nb]
    tabs, poss = [], []
    for s, (p0, n) in enumerate(seqs):
        for p in range(p0, p0 + n):
            tabs.append(perm[s])
            poss.append(p)
    for _ in range(pad_rows):
        tabs.append(np.zeros(MB, np.int32))
        poss.append(0)
    T = len(poss)
    q = rng.randn(T, H, Dh).astype(np.float32)
    kc = rng.randn(NB, bs, Hkv, Dh).astype(np.float32)
    vc = rng.randn(NB, bs, Hkv, Dh).astype(np.float32)
    return q, kc, vc, np.stack(tabs).astype(np.int32), np.asarray(poss, np.int32)


def _torch(case):
    return [torch.from_numpy(a) for a in case]


# ---------------------------------------------------------------- the cut into tiles
def test_tiles_of_a_prefill_chunk_are_cut_at_multiples_of_tq():
    # G 4 → TQ 16: positions 10..45 cut at 16 and 32
    _, _, _, tab, pos = make_case(0, [(10, 36)], 8, 2, 16, 8, 8)
    assert pa.tile_tokens(4) == 16
    assert pa.paged_tiles_ref(tab, pos, 4, 8) == [(0, 6), (6, 16), (22, 14)]


def test_decode_tokens_and_pad_rows_are_tiles_of_one():
    _, _, _, tab, pos = make_case(1, [(5, 1), (6, 1), (40, 1)], 8, 2, 16, 8, 8, pad_rows=3)
    # 5 and 6 are consecutive positions but on private tables
    assert pa.paged_tiles_ref(tab, pos, 4, 8) == [(i, 1) for i in range(6)]


def test_non_consecutive_positions_break_a_tile():
    _, _, _, tab, pos = make_case(2, [(3, 4)], 8, 8, 16, 8, 4)
    pos[2:] += 1  # 3, 4, 6, 7
    assert pa.paged_tiles_ref(tab, pos, 1, 8) == [(0, 2), (2, 2)]


def test_a_shared_table_prefix_joins_two_sequences_only_when_it_covers_the_reads():
    # sequence 1 decodes at position 20, sequence 0 at 19; bs 8: token 0 reads blocks 0-2
    case = make_case(3, [(19, 1), (20, 1)], 8, 2, 16, 8, 4, share=(0, 1, 3))
    assert pa.paged_tiles_ref(case[3], case[4], 4, 8) == [(0, 2)]
    case = make_case(3, [(19, 1), (20, 1)], 8, 2, 16, 8, 4, share=(0, 1, 2))
    assert pa.paged_tiles_ref(case[3], case[4], 4, 8) == [(0, 1), (1, 1)]


@pytest.mark.parametrize("G,tq", [(1, 64), (2, 32), (3, 21), (4, 16), (8, 8)])
def test_tiles_never_exceed_tq_tokens_or_64_rows(G, tq):
    _, _, _, tab, pos = make_case(4, [(0, 150), (7, 90)], G, 1, 16, 8, 24)
    tiles = pa.paged_tiles_ref(tab, pos, G, 8)
    assert pa.tile_tokens(G) == tq
    assert sum(n for _, n in tiles) == len(pos)
    assert all(n <= tq and n * G <= pa.TILE_ROWS for _, n in tiles)
    assert all(pos[t] % tq == 0 or t in (0, 150) for t, _ in tiles)  # cut at multiples


@pytest.mark.parametrize("H,Hkv,Dh,bs,design", [
    (32, 8, 128, 32, "tiled"), (32, 8, 128, 16, "tiled"), (8, 8, 64, 16, "tiled"),
    (8, 1, 64, 8, "tiled"), (8, 4, 256, 8, "tiled"), (12, 4, 128, 32, "tiled"),
    (32, 2, 128, 32, "token"),   # G 16
    (24, 4, 8, 32, "token"), (16, 2, 40, 16, "token"),  # Dh % 16
    (16, 16, 16, 1, "token"), (8, 2, 64, 12, "token"),  # bs % 8
    (8, 2, 272, 16, "token"), (8, 2, 16, 16, "token"), (8, 2, 96, 16, "tiled")])
def test_paged_design_by_shape(H, Hkv, Dh, bs, design):
    assert pa.paged_design(H, Hkv, Dh, bs) == design


# ---------------------------------------------------------------- the chunk cut
@pytest.mark.parametrize("chunk_len", [1, 7, 16, 64])
def test_the_chunk_cut_is_the_same_at_every_T(chunk_len):
    """A token's chunk states cover [c C, min(c C + C, pos + 1)) for c =
    0, 1, ..., whatever its tile and batch; states past its position are
    empty (they merge as the identity)."""
    p_last = 1100
    seqs = [(p_last - chunk_len + 1, chunk_len)]
    want = [(c * 64, min(c * 64 + 64, p_last + 1)) for c in range(-(-(p_last + 1) // 64))]
    for extra in ([], [(30, 5)], [(0, 1), (700, 9)]):
        q, kc, vc, tab, pos = make_case(5, extra + seqs, 4, 2, 32, 8, 140)
        rec = {}
        emulate(*_torch((q, kc, vc, tab, pos)), chunk=64, record=rec)
        t = len(pos) - 1  # the sequence's last token
        got = rec[(t, 0)]
        assert [r for r in got if r[1] > r[0]] == want
        assert all(r[1] <= r[0] for r in got[len(want):])


# ---------------------------------------------------------------- arithmetic
ARITH = {
    # name: (seqs, H, Hkv, Dh, bs, MB, pad rows)
    "decode_g4": ([(0, 1), (37, 1), (63, 1), (150, 1)], 8, 2, 32, 8, 24, 1),
    "prefill_g4_midblock": ([(5, 30)], 8, 2, 32, 16, 4, 0),
    "chunk_across_cut_g2": ([(500, 24), (9, 3)], 4, 2, 32, 16, 40, 2),
    "long_decode_g1": ([(1030, 1), (600, 2)], 2, 2, 32, 16, 72, 0),
    "g8_dh64": ([(17, 12)], 16, 2, 64, 8, 8, 1),
}


@pytest.mark.parametrize("name", sorted(ARITH))
def test_emulation_matches_xla_reference(name):
    case = make_case(10, *ARITH[name])
    want = np.asarray(xla_paged_attention(*[jnp.asarray(a) for a in case]))
    exact = emulate(*_torch(case), round_p=False).numpy()
    np.testing.assert_allclose(exact, want, atol=1e-5, rtol=0)
    rounded = emulate(*_torch(case), round_p=True).numpy()
    tol = 2.0 ** -16 * np.abs(case[2]).max() + 1e-5
    np.testing.assert_allclose(rounded, want, atol=tol, rtol=0)


@pytest.mark.parametrize("name", ["prefill_g4_midblock", "chunk_across_cut_g2"])
def test_emulation_matches_pallas_interpret(name):
    case = make_case(11, *ARITH[name])
    want = np.asarray(jax_pallas(*[jnp.asarray(a) for a in case], interpret=True))
    np.testing.assert_allclose(emulate(*_torch(case), round_p=False).numpy(), want,
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("seqs,pick", [
    ([(500, 24)], 0), ([(500, 24)], 11), ([(500, 24)], 23),  # across the cut at 512
    ([(96, 16)], 0), ([(96, 16)], 15), ([(90, 7)], 3)])
def test_a_row_gives_the_same_bits_in_every_placement(seqs, pick):
    """Token ``pick`` of the first sequence: alone (T 1), in its chunk,
    beside other sequences before and after, and in a chunk cut short to
    end at it: the same bits."""
    q, kc, vc, tab, pos = make_case(12, seqs + [(40, 9), (7, 1)], 8, 2, 32, 16, 40,
                                    pad_rows=2)
    args = _torch((q, kc, vc, tab, pos))
    n, T = seqs[0][1], len(pos)

    def rows(idx):  # the tokens at ``idx``, in that order, on the same pool
        idx = torch.as_tensor(idx)
        return args[0][idx], args[1], args[2], args[3][idx], args[4][idx]

    outs = [emulate(*args)[pick],
            emulate(*rows([pick]))[0],                                  # alone
            emulate(*rows(range(n)))[pick],                             # its sequence only
            emulate(*rows(range(pick + 1)))[pick],                      # last in its tile
            emulate(*rows(list(range(n, T)) + list(range(n))))[T - n + pick]]  # after others
    for o in outs[1:]:
        assert torch.equal(o, outs[0])


def test_wrapper_counts_no_design_on_cpu():
    case = _torch(make_case(13, [(3, 5)], 8, 2, 16, 8, 4))
    before = dict(pa.paged_design_launches)
    got = pa.paged_decode_attention(*case)
    assert pa.paged_design_launches == before  # the plain version: no kernel
    assert torch.equal(got, pa.paged_attention_ref(*case))
