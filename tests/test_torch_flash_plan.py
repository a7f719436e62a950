"""The schedule of K1's wgmma designs (``csrc/flash_attention.cu``:
``flash_fwd_kernel``, ``flash_bwd_dkv_kernel``, ``flash_bwd_dq_kernel``)
and their tiled arithmetic, on the CPU.

The CUDA kernels run only on the card. What their grids visit is plain
integer arithmetic, emulated here in Python exactly as the kernels write
it: the forward's block owns 128 query rows (the longest causal rows
first) and walks 128-key tiles up to its last row; the dQ block does the
same with 64-key tiles at head dim 128 and 128-key tiles at 64; the dK/dV
block owns 128 keys (the most-visited keys first) and walks 64-row query
tiles from its first key on (causal) or from 0. Over ragged, tile-sized and
sub-tile S, causal and not: every (query, key) pair the mask admits is
visited exactly once, a causal schedule skips only tiles the mask
wholly rejects, the work per block never grows with the tile rank, and a
tile that the kernels leave unmasked admits every pair in it. The 1-D
grid's order (``block_tile``: heads in groups of 16, each group's tiles
longest first) visits each (tile, head) once, and on 132 SMs finishes a
causal forward at the training path within 3% of a perfect balance.

The forward's arithmetic at the new tile sizes (128 x 128: online softmax
in the exp2 domain from a running max of NEG_INF, the mask applied only
on the tiles the kernel masks, a fully masked tile's p = 1 wiped by the
next valid tile's alpha = 0, lse = m ln2 + log(l)) is emulated in fp32 and
held against the JAX package's ``flash_attention`` with its Pallas
kernels in interpret mode (fp32 inputs, so the kernel's bf16 rounding of
p is off in both): o and lse within 1e-5. With p rounded to bf16, as the
CUDA kernel rounds it before P·V, o stays within ``row_scaled_err`` 6 of
the same reference (the limit chip_smoke.py's phase 6 holds the kernel
to). The cases put a whole 128-key tile out of some rows' segments, and
S off a multiple of 128.

dQ's arithmetic at its tile sizes (128 query rows, 64 or 128 keys a
tile: p = exp2(s scale log2(e) - lse log2(e)) where the mask admits the
pair, 0 where it does not, the mask applied only on the tiles the kernel
masks, dS = p (dP - delta) sm_scale, dQ += dS K tile by tile) is emulated
in fp32 and held against the JAX package's ``_bwd_impl`` with its Pallas
kernels in interpret mode, on the lse and o of its forward: dQ within
1e-5 with fp32 inputs, and within ``row_scaled_err`` 6 of it with dS
rounded to bf16, as the CUDA kernel rounds it before dS K; at head dims
64 and 128, causal and not, S off a multiple of 128, and segments that put
whole key tiles out of some rows'."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepspeed_tpu.ops.pallas.flash_attention import _bwd_impl, _fwd_impl
from deepspeed_tpu_torch.ops.kernels import flash_attention as fa

ROWS = 128       # query rows (forward) or keys (dK/dV) a block: WG_ROWS
FWD_KEYS = 128   # keys a forward stage
DKV_QROWS = 64   # query rows a dK/dV stage
DQ_KEYS = {64: 128, 128: 64}  # keys a dQ stage, by head dim (DqSmem::kKeys)
NEG_INF = -1e30
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453

SIZES = (1, 37, 64, 127, 128, 129, 200, 384, 1000, 2049)


def _cdiv(a, b):
    return -(-a // b)


HEAD_GROUP = 16  # heads a group of the 1-D grid


def block_tile(L, tiles, heads):
    """``block_tile`` in the kernels: block ``L`` of the 1-D grid → (tile
    rank, head index b * H + h); rank 0 is the longest tile."""
    group = L // (tiles * HEAD_GROUP)
    size = min(HEAD_GROUP, heads - group * HEAD_GROUP)
    r = L - group * tiles * HEAD_GROUP
    rank = r // size
    return rank, group * HEAD_GROUP + r - rank * size


def fwd_schedule(S, causal, keys=FWD_KEYS):
    """``flash_fwd_kernel``'s grid in blockIdx.x order (and, with ``keys``
    keys a tile, ``flash_bwd_dq_kernel``'s) → [(q0, [k0, ...], [masked,
    ...])]: its query rows, key tiles and which tiles it masks (without
    segment ids)."""
    nx = _cdiv(S, ROWS)
    out = []
    for bx in range(nx):
        q0 = (nx - 1 - bx) * ROWS
        kv_end = min(S, q0 + ROWS) if causal else S
        tiles = [i * keys for i in range(_cdiv(kv_end, keys))]
        masked = [k0 + keys > S or (causal and k0 + keys > q0) for k0 in tiles]
        out.append((q0, tiles, masked))
    return out


def dkv_schedule(S, causal):
    """``flash_bwd_dkv_kernel``'s grid in blockIdx.x order → [(k0, [q0,
    ...], [masked, ...])]."""
    out = []
    for bx in range(_cdiv(S, ROWS)):
        k0 = bx * ROWS
        qs = k0 if causal else 0
        tiles = [qs + i * DKV_QROWS for i in range(_cdiv(S - qs, DKV_QROWS))]
        masked = [q0 + DKV_QROWS > S or k0 + ROWS > S or (causal and q0 < k0 + ROWS)
                  for q0 in tiles]
        out.append((k0, tiles, masked))
    return out


def _admitted(S, causal):
    ok = np.ones((S, S), bool)
    return np.tril(ok) if causal else ok


def _check_schedule(items, S, causal, rows_of, keys_of):
    admitted = _admitted(S, causal)
    seen = np.zeros((S, S), np.int64)
    work = []
    for own, tiles, masked in items:
        work.append(len(tiles))
        for other, m in zip(tiles, masked):
            qs, ks = rows_of(own, other), keys_of(own, other)
            block = admitted[np.ix_(qs, ks)]
            assert block.any(), (own, other)      # causal skips only wholly masked tiles
            if not m:
                assert block.all(), (own, other)  # an unmasked tile admits every pair
            seen[np.ix_(qs, ks)] += block
    assert (seen == admitted).all()               # every admitted pair exactly once
    assert work == sorted(work, reverse=True)     # the longest blocks first
    return work


def _span(start, n, S):
    return np.arange(start, min(start + n, S))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", SIZES)
def test_fwd_grid_visits_each_admitted_pair_once(S, causal):
    items = fwd_schedule(S, causal)
    work = _check_schedule(items, S, causal, lambda q0, k0: _span(q0, ROWS, S),
                           lambda q0, k0: _span(k0, FWD_KEYS, S))
    if causal:  # a query block walks exactly the key tiles up to its last row
        assert work == [_cdiv(min(S, q0 + ROWS), FWD_KEYS) for q0, _, _ in items]


@pytest.mark.parametrize("D", sorted(DQ_KEYS))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", SIZES)
def test_dq_grid_visits_each_admitted_pair_once(S, causal, D):
    keys = DQ_KEYS[D]
    items = fwd_schedule(S, causal, keys)
    work = _check_schedule(items, S, causal, lambda q0, k0: _span(q0, ROWS, S),
                           lambda q0, k0: _span(k0, keys, S))
    if causal:  # a query block walks exactly the key tiles up to its last row
        assert work == [_cdiv(min(S, q0 + ROWS), keys) for q0, _, _ in items]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", SIZES)
def test_dkv_grid_visits_each_admitted_pair_once(S, causal):
    items = dkv_schedule(S, causal)
    _check_schedule(items, S, causal, lambda k0, q0: _span(q0, DKV_QROWS, S),
                    lambda k0, q0: _span(k0, ROWS, S))


@pytest.mark.parametrize("tiles, heads", [(1, 1), (16, 64), (16, 20), (3, 16), (33, 5),
                                          (2, 100)])
def test_block_order_covers_each_tile_once_longest_first(tiles, heads):
    """Each (tile, head) once; heads in groups of HEAD_GROUP whose blocks are
    contiguous; within a group the tile ranks never decrease, so the
    longest causal tiles start first."""
    order = [block_tile(L, tiles, heads) for L in range(tiles * heads)]
    assert sorted(order) == [(r, h) for r in range(tiles) for h in range(heads)]
    groups = [h // HEAD_GROUP for _, h in order]
    assert groups == sorted(groups)
    for g in set(groups):
        ranks = [r for (r, h), gg in zip(order, groups) if gg == g]
        assert ranks == sorted(ranks)


def _makespan(durations, sms=132):
    """Greedy list scheduling of blocks in launch order onto ``sms`` SMs."""
    free = [0] * sms
    for d in durations:
        free.sort()
        free[0] += d
    return max(free)


def test_block_order_shortens_the_causal_tail():
    """At the training path (S 2048: 16 tiles, B·H = 64) on 132 SMs, one
    block an SM, the grouped longest-first order finishes the causal
    forward within 3% of the perfect balance; a head-major order (each
    head's tiles in turn, longest first) does not."""
    tiles, heads, S = 16, 64, 2048
    work = {q0: len(t) for q0, t, _ in fwd_schedule(S, True)}
    grouped = [work[(tiles - 1 - block_tile(L, tiles, heads)[0]) * ROWS]
               for L in range(tiles * heads)]
    head_major = [work[(tiles - 1 - r) * ROWS] for _ in range(heads) for r in range(tiles)]
    ideal = sum(grouped) / 132
    assert _makespan(grouped) <= 1.03 * ideal < _makespan(head_major)


def tiled_fwd(q, k, v, seg, causal, round_p):
    """The forward kernel's arithmetic on fp32 [B, S, H, D] tensors, tile by
    tile over its schedule → (o [B, S, H, D], lse [B, H, S])."""
    B, S, H, D = q.shape
    scale_log2 = LOG2E / np.sqrt(D)
    o = torch.zeros(B, S, H, D)
    lse = torch.zeros(B, H, S)
    for q0, tiles, _ in fwd_schedule(S, causal):
        rows = torch.arange(q0, q0 + ROWS)
        live = rows < S
        for b in range(B):
            for h in range(H):
                qt = torch.zeros(ROWS, D)
                qt[live] = q[b, rows[live], h]
                m = torch.full((ROWS,), NEG_INF)
                l = torch.zeros(ROWS)
                acc = torch.zeros(ROWS, D)
                for k0 in tiles:
                    keys = torch.arange(k0, k0 + FWD_KEYS)
                    kin = keys < S
                    kt, vt = torch.zeros(FWD_KEYS, D), torch.zeros(FWD_KEYS, D)
                    kt[kin], vt[kin] = k[b, keys[kin], h], v[b, keys[kin], h]
                    x = (qt @ kt.T) * scale_log2
                    masked = seg is not None or k0 + FWD_KEYS > S or \
                        (causal and k0 + FWD_KEYS > q0)
                    if masked:
                        valid = kin[None, :].expand(ROWS, -1).clone()
                        if causal:
                            valid &= rows[:, None] >= keys[None, :]
                        if seg is not None:
                            sq = torch.zeros(ROWS, dtype=torch.int64)
                            sk = torch.zeros(FWD_KEYS, dtype=torch.int64)
                            sq[live], sk[kin] = seg[b, rows[live]], seg[b, keys[kin]]
                            valid &= sq[:, None] == sk[None, :]
                        x = torch.where(valid, x, torch.tensor(NEG_INF))
                    m_new = torch.maximum(m, x.max(-1).values)
                    alpha = torch.exp2(m - m_new)
                    p = torch.exp2(x - m_new[:, None])
                    l = l * alpha + p.sum(-1)
                    if round_p:
                        p = p.to(torch.bfloat16).float()
                    acc = acc * alpha[:, None] + p @ vt
                    m = m_new
                l_safe = torch.where(l == 0, torch.ones_like(l), l)
                o[b, rows[live], h] = (acc / l_safe[:, None])[live]
                lse[b, h, rows[live]] = (m * LN2 + torch.log(l_safe))[live]
    return o, lse


CASES = {
    # name: (B, S, H, D, causal, segment cuts): the cuts put keys 0-255 out of
    # the last segment's rows (two whole 128-key tiles), and S is off 128
    "segments_causal": (1, 300, 2, 16, True, (150, 270)),
    "segments_noncausal": (1, 300, 2, 16, False, (150, 270)),
    "ragged_causal": (2, 200, 2, 16, True, None),
    "ragged_noncausal": (1, 130, 2, 8, False, None),
}


def _case(B, S, H, D, cuts, seed):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, S, H, D).astype(np.float32) for _ in range(3))
    seg = None
    if cuts is not None:
        seg = np.tile(np.searchsorted(np.array(cuts), np.arange(S), side="right")
                      .astype(np.int32), (B, 1))
    return q, k, v, seg


def _jax_fwd(q, k, v, seg, causal):
    """The JAX package's forward kernel in interpret mode → (o [B, S, H,
    D], lse [B, H, S]), numpy."""
    B, S, H, D = q.shape

    def bh(x):
        return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(B * H, S, D))

    seg_bh = jnp.repeat(jnp.asarray(seg if seg is not None else np.zeros((B, S), np.int32)),
                        H, axis=0)
    o, lse = _fwd_impl(bh(q), bh(k), bh(v), seg_bh, causal, 1.0 / np.sqrt(D), 64, 64, True)
    o = np.asarray(o).reshape(B, H, S, D).transpose(0, 2, 1, 3)
    return o, np.asarray(lse)[:, :S].reshape(B, H, S)


@pytest.mark.parametrize("case", sorted(CASES))
def test_tiled_forward_matches_jax_kernel(case):
    B, S, H, D, causal, cuts = CASES[case]
    q, k, v, seg = _case(B, S, H, D, cuts, seed=len(case))
    o_j, lse_j = _jax_fwd(q, k, v, seg, causal)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    tseg = None if seg is None else torch.from_numpy(seg).long()
    o, lse = tiled_fwd(*t, tseg, causal, round_p=False)
    np.testing.assert_allclose(o.numpy(), o_j, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(lse.numpy(), lse_j, atol=1e-5, rtol=1e-5)
    o_bf16, lse_bf16 = tiled_fwd(*t, tseg, causal, round_p=True)
    assert fa.row_scaled_err(o_bf16, torch.tensor(o_j)) <= 6.0
    np.testing.assert_allclose(lse_bf16.numpy(), lse_j, atol=1e-5, rtol=1e-5)


def test_a_wholly_masked_first_tile_is_wiped():
    """A row whose first key tile lies wholly outside its segment takes p = 1
    there (every score is NEG_INF, so is the running max); the next tile's
    alpha = exp2(NEG_INF - m) = 0 wipes it, so o and lse are the plain
    version's."""
    B, S, H, D, causal, cuts = CASES["segments_causal"]
    q, k, v, seg = _case(B, S, H, D, cuts, seed=3)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    tseg = torch.from_numpy(seg).long()
    o, lse = tiled_fwd(*t, tseg, causal, round_p=False)
    o_ref, lse_ref = fa.flash_fwd_ref(*t, torch.from_numpy(seg), causal)
    torch.testing.assert_close(o, o_ref, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(lse, lse_ref, atol=1e-5, rtol=1e-5)
    assert seg[0, -1] == 2 and seg[0, :256].max() < 2  # the last rows see no key of tiles 0, 1


def tiled_dq(q, k, v, do, lse, delta, seg, causal, round_ds):
    """The dQ kernel's arithmetic on fp32 [B, S, H, D] tensors (lse and
    delta [B, H, S]), tile by tile over its schedule → dq [B, S, H, D]."""
    B, S, H, D = q.shape
    keys = DQ_KEYS[D]
    sm_scale = 1.0 / np.sqrt(D)
    scale_log2 = LOG2E * sm_scale
    dq = torch.zeros(B, S, H, D)
    for q0, tiles, _ in fwd_schedule(S, causal, keys):
        rows = torch.arange(q0, q0 + ROWS)
        live = rows < S
        for b in range(B):
            for h in range(H):
                qt, dot = torch.zeros(ROWS, D), torch.zeros(ROWS, D)
                qt[live], dot[live] = q[b, rows[live], h], do[b, rows[live], h]
                lse2, dlt = torch.zeros(ROWS), torch.zeros(ROWS)
                lse2[live] = lse[b, h, rows[live]] * LOG2E
                dlt[live] = delta[b, h, rows[live]]
                acc = torch.zeros(ROWS, D)
                for k0 in tiles:
                    kk = torch.arange(k0, k0 + keys)
                    kin = kk < S
                    kt, vt = torch.zeros(keys, D), torch.zeros(keys, D)
                    kt[kin], vt[kin] = k[b, kk[kin], h], v[b, kk[kin], h]
                    p = torch.exp2((qt @ kt.T) * scale_log2 - lse2[:, None])
                    if seg is not None or k0 + keys > S or (causal and k0 + keys > q0):
                        valid = kin[None, :].expand(ROWS, -1).clone()
                        if causal:
                            valid &= rows[:, None] >= kk[None, :]
                        if seg is not None:
                            sq = torch.zeros(ROWS, dtype=torch.int64)
                            sk = torch.zeros(keys, dtype=torch.int64)
                            sq[live], sk[kin] = seg[b, rows[live]], seg[b, kk[kin]]
                            valid &= sq[:, None] == sk[None, :]
                        p = torch.where(valid, p, torch.zeros_like(p))
                    ds = p * ((dot @ vt.T) - dlt[:, None]) * sm_scale
                    if round_ds:
                        ds = ds.to(torch.bfloat16).float()
                    acc = acc + ds @ kt
                dq[b, rows[live], h] = acc[live]
    return dq


DQ_CASES = {
    # name: (B, S, H, D, causal, segment cuts): the cuts put keys 0-255 (four
    # 64-key tiles, two 128-key ones) out of the last segment's rows; S is
    # off 128
    "segments_causal_d128": (1, 300, 2, 128, True, (150, 270)),
    "segments_noncausal_d64": (1, 300, 2, 64, False, (150, 270)),
    "ragged_causal_d64": (2, 200, 1, 64, True, None),
    "ragged_noncausal_d128": (1, 130, 2, 128, False, None),
}


def _jax_dq(q, k, v, do, seg, causal):
    """The JAX package's backward kernels in interpret mode, on its
    forward's o and lse → (dq [B, S, H, D], lse and delta [B, H, S]),
    numpy."""
    B, S, H, D = q.shape

    def bh(x):
        return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(B * H, S, D))

    def unbh(x):
        return np.asarray(x).reshape(B, H, S, D).transpose(0, 2, 1, 3)

    seg_bh = jnp.repeat(jnp.asarray(seg if seg is not None else np.zeros((B, S), np.int32)),
                        H, axis=0)
    sm_scale = 1.0 / np.sqrt(D)
    o, lse = _fwd_impl(bh(q), bh(k), bh(v), seg_bh, causal, sm_scale, 128, 128, True)
    dq, _, _ = _bwd_impl(bh(q), bh(k), bh(v), seg_bh, o, lse, bh(do), causal, sm_scale,
                         128, 128, True)
    delta = (unbh(o) * do).sum(-1).transpose(0, 2, 1)
    return unbh(dq), np.array(lse)[:, :S].reshape(B, H, S), np.ascontiguousarray(delta)


@pytest.mark.parametrize("case", sorted(DQ_CASES))
def test_tiled_dq_matches_jax_kernel(case):
    B, S, H, D, causal, cuts = DQ_CASES[case]
    q, k, v, seg = _case(B, S, H, D, cuts, seed=len(case))
    do = np.random.RandomState(len(case) + 1).randn(B, S, H, D).astype(np.float32)
    dq_j, lse, delta = _jax_dq(q, k, v, do, seg, causal)
    t = [torch.from_numpy(x) for x in (q, k, v, do, lse, delta)]
    tseg = None if seg is None else torch.from_numpy(seg).long()
    dq = tiled_dq(*t, tseg, causal, round_ds=False)
    np.testing.assert_allclose(dq.numpy(), dq_j, atol=1e-5, rtol=1e-5)
    dq_bf16 = tiled_dq(*t, tseg, causal, round_ds=True)
    assert fa.row_scaled_err(dq_bf16, torch.tensor(dq_j)) <= 6.0
