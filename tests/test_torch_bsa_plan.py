"""The schedule of K8's wgmma backward designs (``csrc/block_sparse_attention.cu``:
``bsa_dq_wgmma_kernel``, ``bsa_dkv_wgmma_kernel``) and their tiled
arithmetic, on the CPU.

The CUDA kernels run only on the card. What their grids visit is plain
integer arithmetic, emulated here in Python exactly as the kernels write
it. The grid is persistent: its blocks take work items from a counter in
``item_at``'s order: the ``lead_ranks`` ranks of every head-row first
(BigBird's global row or column), rank-major, then the rest in groups of
16 head-rows, rank-major within a group; a head's ranks follow the ranked
lists of ``Schedule`` (row r of head h is the list of row ``order[h,
r]``, longest first). The producer warp reads an item's nnz
admitted blocks into shared memory once (``stage_list``) and asks for its
tiles in list order; an item with an empty list only stores zeros. dQ:
consumer cw owns the item's query rows 64 cw .. 64 cw + 63; a key tile is
64 keys, 128 at block 128 and head dim 64, so a key block of 128 at head
dim 128 is two tiles. dK/dV: consumer cw owns the item's keys 64 cw .. 64
cw + 63 and sees every tile of the list; a query tile is 64 rows, so a
query block of 128 is two tiles. Over BigBird (shared and per head),
Fixed, and a layout with an empty row and a key block no row admits: every
admitted (query, key) pair is visited exactly once by dQ and once by
dK/dV, no other pair is visited, every row and key block of every head is
one item, and ranks run longest list first. Taken greedily by 264 blocks
(two on each of 132 SMs) in that order, the items of BERT-large's path
(B 4, H 16, S 4096, BigBird block 64) finish within 3% of a perfect
balance of their tiles with the short items of at most two groups of
head-rows in flight; taken by head-row and unranked, they do not finish
so.

The tiles' arithmetic (dQ: p = exp2(s scale log2(e) - lse log2(e)), dS = p
(dP - delta) sm_scale, dQ += dS K tile by tile; dK/dV: the transposed
products, dV += P^T dO and dK += dS^T Q, p in fp32 until both are rounded)
is emulated in fp32 over that schedule and held against the JAX package's
``_bwd_impl`` with its Pallas kernels in interpret mode, on its own
forward's o and lse: dq, dk and dv within 1e-5 with fp32 inputs, and
within ``row_scaled_err`` 6 (ROW_TOL, the limit chip_smoke.py's phase 23
holds the kernels to) with p and dS rounded to bf16 as the kernels round
them, at head dims 64 and 128 and blocks 64 and 128."""

import heapq

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepspeed_tpu.ops.pallas.block_sparse_attention import _bwd_impl, _fwd_impl
from deepspeed_tpu_torch.ops.kernels import block_sparse_attention as bsa
from deepspeed_tpu_torch.ops.kernels.flash_attention import row_scaled_err
from deepspeed_tpu_torch.ops.sparse_attention import (BigBirdSparsityConfig,
                                                      FixedSparsityConfig)

ROWS = 64        # rows a consumer warpgroup owns
DKV_QROWS = 64   # query rows a dK/dV tile
ROW_TOL = 6.0
LOG2E = 1.4426950408889634


def dq_keys(block, D):
    """Keys a dQ tile (``WgDq::kKeys``)."""
    return 128 if block == 128 and D == 64 else 64


def _bigbird(H, S, block, per_head=False):
    return BigBirdSparsityConfig(num_heads=H, block=block, different_layout_per_head=per_head,
                                 num_random_blocks=1, num_sliding_window_blocks=3,
                                 num_global_blocks=1).make_layout(S)


def _fixed(H, S, block):
    return FixedSparsityConfig(num_heads=H, block=block, num_local_blocks=4,
                               num_global_blocks=1).make_layout(S)


def _unreached(H, n):
    """chip_smoke.unreached_layout: an empty row (2) and a key block no row
    admits (n - 2); the heads differ."""
    layout = np.zeros((H, n, n), bool)
    for r in range(n):
        if r != 2:
            layout[:, r, [0, r if r != n - 2 else n - 1]] = True
    layout[:, 0, :n - 2] = True
    layout[1:, 1, 3] = True
    return layout


LAYOUTS = {  # name: (H, S, block, layout maker)
    "bigbird_b64": (2, 1024, 64, lambda: _bigbird(1, 1024, 64)),
    "bigbird_per_head_b64": (3, 1024, 64, lambda: _bigbird(3, 1024, 64, True)),
    "bigbird_per_head_b128": (3, 2048, 128, lambda: _bigbird(3, 2048, 128, True)),
    "fixed_b128": (2, 1024, 128, lambda: _fixed(1, 1024, 128)),
    "unreached_b64": (2, 640, 64, lambda: _unreached(2, 10)),
    "unreached_b128": (2, 1024, 128, lambda: _unreached(2, 8)),
}


def ranked(idx, nnz):
    """``Schedule``'s ranked lists, from the numpy lists: (idx [H, rows, A],
    nnz [H, rows], order [H, rows]) with row r of head h the list of row
    order[h, r]."""
    order = np.argsort(-nnz, axis=-1, kind="stable")
    return (np.take_along_axis(idx, order[..., None], 1), np.take_along_axis(nnz, order, 1),
            order)


def stage_list(list_row, nnz):
    """``stage_list``: the producer warp's copy of a block's list in shared
    memory, lane j taking entries j, j + 32, ... below nnz."""
    smem = [None] * len(list_row)
    for lane in range(32):
        for j in range(lane, nnz, 32):
            smem[j] = int(list_row[j])
    return smem


HEAD_GROUP = 16  # head-rows a group of the take order


def item_at(w, BH, rows, lead):
    """``item_at``: item w of the take order → (b H + h, rank)."""
    if w < lead * BH:
        return w % BH, w // BH
    w -= lead * BH
    per = rows - lead
    group = w // (HEAD_GROUP * per)
    size = min(HEAD_GROUP, BH - group * HEAD_GROUP)
    r = w - group * HEAD_GROUP * per
    return group * HEAD_GROUP + r % size, lead + r // size


def take_order(BH, rows, lead):
    """The items in the order the counter hands them out → [(b H + h,
    rank)]."""
    return [item_at(w, BH, rows, lead) for w in range(BH * rows)]


def dq_plan(layout, block, D):
    """``bsa_dq_wgmma_kernel``'s items over one batch row, in take order →
    [(h, rank, row, nnz, [(first row, [keys, ...]) per consumer])]: each
    consumer's query rows and the key rows of its tiles, in the order it
    takes them."""
    H, nb, _ = layout.shape
    k_idx, k_nnz, _, _ = bsa.layout_to_indices(layout)
    idx, nnz, order = ranked(k_idx, k_nnz)
    keys = dq_keys(block, D)
    tpb = block // keys
    out = []
    for h, rank in take_order(H, nb, bsa.lead_ranks(k_nnz)):
        row, n = int(order[h, rank]), int(nnz[h, rank])
        smem = stage_list(idx[h, rank], n)
        tiles = [smem[i // tpb] * block + (i % tpb) * keys for i in range(n * tpb)]
        work = [(row * block + ROWS * cw, [np.arange(k0, k0 + keys) for k0 in tiles])
                for cw in range(block // ROWS)]
        out.append((h, rank, row, n, work))
    return out


def dkv_plan(layout, block):
    """``bsa_dkv_wgmma_kernel``'s items over one batch row, in take order →
    [(h, rank, key block, nnz, [(first key, [query rows, ...]) per
    consumer])]."""
    H, nb, _ = layout.shape
    _, _, q_idx, q_nnz = bsa.layout_to_indices(layout)
    idx, nnz, order = ranked(q_idx, q_nnz)
    tpb = block // DKV_QROWS
    out = []
    for h, rank in take_order(H, nb, bsa.lead_ranks(q_nnz)):
        kb, n = int(order[h, rank]), int(nnz[h, rank])
        smem = stage_list(idx[h, rank], n)
        tiles = [smem[i // tpb] * block + (i % tpb) * DKV_QROWS for i in range(n * tpb)]
        work = [(kb * block + ROWS * cw, [np.arange(q0, q0 + DKV_QROWS) for q0 in tiles])
                for cw in range(block // ROWS)]
        out.append((h, rank, kb, n, work))
    return out


def _layout(name):
    H, S, block, make = LAYOUTS[name]
    return bsa.full_layout(make(), H, S, block), S, block


def _check_owners_and_order(plan, H, nb):
    owned = sorted((h, own) for h, _, own, _, _ in plan)
    assert owned == [(h, r) for h in range(H) for r in range(nb)]  # each row one item
    for h in range(H):  # a head's ranks in turn, longest list first
        assert [rank for hh, rank, _, _, _ in plan if hh == h] == list(range(nb))
        counts = [n for hh, _, _, n, _ in plan if hh == h]
        assert counts == sorted(counts, reverse=True)


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_dq_plan_visits_each_admitted_pair_once(name, D):
    layout, S, block = _layout(name)
    H = layout.shape[0]
    plan = dq_plan(layout, block, D)
    _check_owners_and_order(plan, H, S // block)
    admitted = bsa.block_mask(layout, block).numpy()
    seen = np.zeros_like(admitted, np.int64)
    for h, _, row, n, work in plan:
        if n == 0:  # an empty row: the block stores zeros and asks for no tile
            assert not admitted[h, row * block:(row + 1) * block].any()
        for r0, tiles in work:
            assert len(tiles) == n * block // dq_keys(block, D)
            for keys in tiles:
                seen[h, r0:r0 + ROWS, keys[0]:keys[-1] + 1] += 1
    assert (seen == admitted).all()


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_dkv_plan_visits_each_admitted_pair_once(name):
    layout, S, block = _layout(name)
    H = layout.shape[0]
    plan = dkv_plan(layout, block)
    _check_owners_and_order(plan, H, S // block)
    admitted = bsa.block_mask(layout, block).numpy()
    seen = np.zeros_like(admitted, np.int64)
    for h, _, kb, n, work in plan:
        if n == 0:  # a key block no query admits: the block stores zeros
            assert not admitted[h, :, kb * block:(kb + 1) * block].any()
        for k0, tiles in work:
            assert len(tiles) == n * block // DKV_QROWS  # every consumer sees every tile
            for rows in tiles:
                seen[h, rows[0]:rows[-1] + 1, k0:k0 + ROWS] += 1
    assert (seen == admitted).all()


def test_unreached_layout_has_an_empty_row_and_an_unreached_key_block():
    layout, S, block = _layout("unreached_b64")
    n = S // block
    assert not layout[:, 2].any() and not layout[:, :, n - 2].any()
    assert [n_ for _, _, _, n_, _ in dq_plan(layout, block, 64)].count(0) == layout.shape[0]
    assert [n_ for _, _, _, n_, _ in dkv_plan(layout, block)].count(0) == layout.shape[0]


def test_the_global_column_leads_the_dkv_grid():
    """BigBird's global key block 0 is admitted by every query block: it is
    each head's rank 0 in dK/dV, with the whole column as its list."""
    layout, S, block = _layout("bigbird_b64")
    nb = S // block
    for h, rank, kb, n, _ in dkv_plan(layout, block):
        if rank == 0:
            assert kb == 0 and n == nb
        else:
            assert n < nb


def _greedy(order, costs, workers):
    """Each item, in take order, to the block that frees first (the
    counter's dynamic take) → (the time the last block finishes, the most
    head-rows with a short item in flight: items past the lead ranks, which
    share their tiles with their head-row's other short items)."""
    free = [(0.0, i) for i in range(workers)]
    heapq.heapify(free)
    running = {}  # block → (finish, head-row, short)
    widest = 0
    for (bh, rank), cost in zip(order, costs):
        start, blk = heapq.heappop(free)
        running[blk] = (start + cost, bh, rank >= LEAD)
        widest = max(widest, len({h for end, h, short in running.values()
                                  if short and end > start}))
        heapq.heappush(free, (start + cost, blk))
    return max(end for end, _, _ in running.values()), widest


LEAD = 1  # bsa.lead_ranks at the BERT path (BigBird's global row and column)


@pytest.mark.parametrize("kind", ["dq", "dkv"])
def test_take_order_balances_the_bert_path_and_keeps_few_heads_in_flight(kind):
    """B 4, H 16, S 4096, BigBird block 64: 4096 items, 264 blocks (two on
    each of 132 SMs), each item costing its tiles. The take order (the
    global row or column of every head-row first, then groups of 16
    head-rows) finishes within 3% of a perfect balance with the short items
    of at most two groups of head-rows in flight, so a group's shared tiles
    can stay in L2. Rank-major alone (``lead`` = rows, the first design's
    order) balances as well but has short items of all 64 in flight; a
    head-major order (each head-row's rows in turn, unranked) leaves a
    tail."""
    B, H, S, block = 4, 16, 4096, 64
    rows, BH = S // block, B * H
    layout = bsa.full_layout(_bigbird(H, S, block), H, S, block)
    k_idx, k_nnz, q_idx, q_nnz = bsa.layout_to_indices(layout)
    plain = k_nnz if kind == "dq" else q_nnz
    _, nnz, _ = ranked(k_idx, k_nnz) if kind == "dq" else ranked(q_idx, q_nnz)
    assert bsa.lead_ranks(plain) == LEAD

    def cost(order):
        return [int(nnz[bh % H, rank]) for bh, rank in order]

    grouped = take_order(BH, rows, LEAD)
    ideal = sum(cost(grouped)) / 264
    assert max(cost(grouped)) < ideal  # a global row fits in one block's share
    span, widest = _greedy(grouped, cost(grouped), 264)
    assert span <= 1.03 * ideal and widest <= 2 * HEAD_GROUP
    rank_major = take_order(BH, rows, rows)
    span, widest = _greedy(rank_major, cost(rank_major), 264)
    assert span <= 1.03 * ideal and widest == BH
    head_major = [(bh, r) for bh in range(BH) for r in range(rows)]
    span, _ = _greedy(head_major, [int(plain[bh % H, r]) for bh, r in head_major], 264)
    assert span > 1.03 * ideal


def test_item_at_visits_every_item_once():
    for BH, rows, lead in ((64, 64, 1), (20, 8, 0), (5, 7, 2), (33, 3, 3), (16, 1, 0)):
        items = take_order(BH, rows, lead)
        assert sorted(items) == [(bh, r) for bh in range(BH) for r in range(rows)]
        assert [r for _, r in items[:lead * BH]] == sorted(r for _, r in items[:lead * BH])


def test_stage_list_copies_the_admitted_blocks_in_order():
    layout, S, block = _layout("bigbird_per_head_b64")
    k_idx, k_nnz, _, _ = bsa.layout_to_indices(layout)
    idx, nnz, order = ranked(k_idx, k_nnz)
    for h in range(layout.shape[0]):
        for r in range(layout.shape[1]):
            got = stage_list(idx[h, r], int(nnz[h, r]))[:nnz[h, r]]
            assert got == list(np.nonzero(layout[h, order[h, r]])[0])


def test_schedule_ranked_lists_are_the_plans():
    """``Schedule.k_ranked`` and ``q_ranked`` (what the wrapper passes the
    wgmma entries) are the ranked lists the plans read, with their lead."""
    layout, _, _ = _layout("unreached_b128")
    sched = bsa.Schedule(layout, "cpu")
    k_idx, k_nnz, q_idx, q_nnz = bsa.layout_to_indices(layout)
    for got, lead, (idx, nnz) in ((sched.k_ranked, sched.k_lead, (k_idx, k_nnz)),
                                  (sched.q_ranked, sched.q_lead, (q_idx, q_nnz))):
        want = ranked(idx, nnz)
        for g, w in zip(got[:3], want):
            np.testing.assert_array_equal(g.numpy(), w)
        assert got[3] == idx.shape[-1] and lead == bsa.lead_ranks(nnz)


def test_lead_ranks_takes_the_long_lists():
    assert bsa.lead_ranks(np.zeros((2, 5), np.int32)) == 0
    assert bsa.lead_ranks(np.full((2, 5), 3)) == 0
    assert bsa.lead_ranks(np.array([[40, 1, 2, 1, 1, 1, 1, 1, 1, 1]])) == 1
    assert bsa.lead_ranks(np.array([[1, 40, 30, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1]])) == 2


def test_bsa_design_names_wgmma_at_blocks_64_and_128():
    assert {(b, d): bsa.bsa_design(b, d) for b in bsa.BLOCKS for d in bsa.HEAD_DIMS} == {
        (b, d): "wgmma" if b in (64, 128) else "first" for b in bsa.BLOCKS
        for d in bsa.HEAD_DIMS}


def test_forcing_a_design_the_call_cannot_take_raises():
    with pytest.raises(ValueError):
        bsa._design(32, 64, "wgmma")
    with pytest.raises(ValueError):
        bsa._design(64, 64, "tiled")
    assert bsa._design(64, 64, "first") == "first" and bsa._design(128, 128, None) == "wgmma"


def _bf16(x, on):
    return x.to(torch.bfloat16).float() if on else x


def tiled_dq(q, k, v, do, lse, delta, layout, block, round_ds):
    """dQ's wgmma design on fp32 [B, S, H, D] tensors (lse, delta [B, H,
    S]), tile by tile over ``dq_plan`` → dq."""
    B, S, H, D = q.shape
    sm_scale = 1.0 / np.sqrt(D)
    dq = torch.zeros(B, S, H, D)
    for b in range(B):
        for h, _, _, _, work in dq_plan(layout, block, D):
            for r0, tiles in work:
                rows = slice(r0, r0 + ROWS)
                qt, dot = q[b, rows, h], do[b, rows, h]
                lse2, dlt = lse[b, h, rows] * LOG2E, delta[b, h, rows]
                acc = torch.zeros(ROWS, D)
                for keys in tiles:
                    kt, vt = k[b, keys, h], v[b, keys, h]
                    p = torch.exp2((qt @ kt.T) * (sm_scale * LOG2E) - lse2[:, None])
                    ds = p * ((dot @ vt.T) - dlt[:, None]) * sm_scale
                    acc = acc + _bf16(ds, round_ds) @ kt
                dq[b, rows, h] = acc
    return dq


def tiled_dkv(q, k, v, do, lse, delta, layout, block, round_p):
    """dK/dV's wgmma design on fp32 tensors, tile by tile over
    ``dkv_plan`` → (dk, dv)."""
    B, S, H, D = q.shape
    sm_scale = 1.0 / np.sqrt(D)
    dk, dv = torch.zeros(B, S, H, D), torch.zeros(B, S, H, D)
    for b in range(B):
        for h, _, _, _, work in dkv_plan(layout, block):
            for k0, tiles in work:
                keys = slice(k0, k0 + ROWS)
                kt, vt = k[b, keys, h], v[b, keys, h]
                dk_acc, dv_acc = torch.zeros(ROWS, D), torch.zeros(ROWS, D)
                for rows in tiles:
                    qt, dot = q[b, rows, h], do[b, rows, h]
                    lse2, dlt = lse[b, h, rows] * LOG2E, delta[b, h, rows]
                    pt = torch.exp2((kt @ qt.T) * (sm_scale * LOG2E) - lse2[None, :])
                    dst = pt * ((vt @ dot.T) - dlt[None, :]) * sm_scale
                    dv_acc = dv_acc + _bf16(pt, round_p) @ dot
                    dk_acc = dk_acc + _bf16(dst, round_p) @ qt
                dk[b, keys, h], dv[b, keys, h] = dk_acc, dv_acc
    return dk, dv


ARITH_CASES = {  # name: (B, S, H, D, block, layout maker)
    "bigbird_b64_d64": (2, 512, 2, 64, 64, lambda: _bigbird(1, 512, 64)),
    "per_head_b64_d128": (1, 512, 2, 128, 64, lambda: _bigbird(2, 512, 64, True)),
    "fixed_b128_d64": (1, 1024, 2, 64, 128, lambda: _fixed(1, 1024, 128)),
    "unreached_b128_d128": (1, 1024, 2, 128, 128, lambda: _unreached(2, 8)),
    "unreached_b64_d64": (1, 640, 2, 64, 64, lambda: _unreached(2, 10)),
}


def _jax_bwd(q, k, v, do, layout, block):
    """The JAX package's forward and backward kernels in interpret mode →
    (dq, dk, dv [B, S, H, D], lse and delta [B, H, S]), numpy; delta =
    sum(do * o) over the forward's o, as ``_bwd_impl`` forms it."""
    def bhsd(x):
        return jnp.asarray(x.transpose(0, 2, 1, 3))

    def bshd(x):
        return np.array(x).transpose(0, 2, 1, 3)

    k_idx, k_nnz, q_idx, q_nnz = (jnp.asarray(a) for a in bsa.layout_to_indices(layout))
    o, lse = _fwd_impl(bhsd(q), bhsd(k), bhsd(v), k_idx, k_nnz, block, True)
    dq, dk, dv = _bwd_impl(bhsd(q), bhsd(k), bhsd(v), o, lse, bhsd(do), k_idx, k_nnz, q_idx,
                           q_nnz, block, True)
    delta = (np.asarray(o) * do.transpose(0, 2, 1, 3)).sum(-1)
    return bshd(dq), bshd(dk), bshd(dv), np.array(lse), np.ascontiguousarray(delta)


@pytest.mark.parametrize("case", sorted(ARITH_CASES))
def test_tiled_backward_matches_jax_kernels(case):
    B, S, H, D, block, make = ARITH_CASES[case]
    layout = bsa.full_layout(make(), H, S, block)
    rng = np.random.RandomState(len(case))
    q, k, v, do = (rng.randn(B, S, H, D).astype(np.float32) for _ in range(4))
    dq_j, dk_j, dv_j, lse, delta = _jax_bwd(q, k, v, do, layout, block)
    t = [torch.from_numpy(x) for x in (q, k, v, do, lse, delta)]
    dq = tiled_dq(*t, layout, block, round_ds=False)
    dk, dv = tiled_dkv(*t, layout, block, round_p=False)
    for got, want in ((dq, dq_j), (dk, dk_j), (dv, dv_j)):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    dq16 = tiled_dq(*t, layout, block, round_ds=True)
    dk16, dv16 = tiled_dkv(*t, layout, block, round_p=True)
    for got, want in ((dq16, dq_j), (dk16, dk_j), (dv16, dv_j)):
        assert row_scaled_err(got, torch.from_numpy(want)) <= ROW_TOL


# ---------------------------------------------------------------- the forward
# ``bsa_fwd_wgmma_kernel`` walks dQ's items: the ranked query-row lists in
# ``item_at``'s order, Q loaded once into an item's slot, key tiles of
# ``WgFwd::kKeys`` (dQ's ``kKeys``) keys, each stage's K and V together;
# an item whose list is empty is stored by the fetcher as o = 0 and lse =
# NEG_INF and never reaches a consumer.
def tiled_fwd(q, k, v, layout, block, round_p, seen=None):
    """The forward's wgmma design on fp32 [B, S, H, D] tensors, tile by tile
    over ``dq_plan``, in the exp2 domain: m starts at NEG_INF, the row max
    of the raw scores times scale log2(e), alpha = exp2(m_prev - m_new), p =
    exp2(s scale log2(e) - m_new), l = l alpha + sum(p) with fp32 p, O = O
    alpha + p V (p rounded to bf16 when ``round_p``) → (o, lse [B, H, S]),
    o = O / l and lse = m ln 2 + log(l). ``seen`` [H, S, S] counts the
    (query, key) pairs batch row 0 visits."""
    B, S, H, D = q.shape
    scale_log2 = LOG2E / np.sqrt(D)
    o = torch.full((B, S, H, D), float("nan"))
    lse = torch.full((B, H, S), float("nan"))
    for b in range(B):
        for h, _, row, n, work in dq_plan(layout, block, D):
            if n == 0:  # the fetcher's store
                o[b, row * block:(row + 1) * block, h] = 0.0
                lse[b, h, row * block:(row + 1) * block] = bsa.NEG_INF
                continue
            for r0, tiles in work:
                rows = slice(r0, r0 + ROWS)
                qt = q[b, rows, h]
                m = torch.full((ROWS,), bsa.NEG_INF)
                l, acc = torch.zeros(ROWS), torch.zeros(ROWS, D)
                for keys in tiles:
                    if seen is not None and b == 0:
                        seen[h, r0:r0 + ROWS, keys[0]:keys[-1] + 1] += 1
                    s = qt @ k[b, keys, h].T
                    m_new = torch.maximum(m, s.max(1).values * scale_log2)
                    alpha = torch.exp2(m - m_new)
                    p = torch.exp2(s * scale_log2 - m_new[:, None])
                    l = l * alpha + p.sum(1)
                    acc = acc * alpha[:, None] + _bf16(p, round_p) @ v[b, keys, h]
                    m = m_new
                o[b, rows, h] = acc / torch.where(l == 0, 1.0, l)[:, None]
                lse[b, h, rows] = torch.where(l == 0, bsa.NEG_INF, m * np.log(2.0) + torch.log(l))
    return o, lse


def _jax_fwd(q, k, v, layout, block):
    """The JAX package's forward kernel in interpret mode → (o [B, S, H, D],
    lse [B, H, S]) numpy."""
    k_idx, k_nnz, _, _ = (jnp.asarray(a) for a in bsa.layout_to_indices(layout))
    o, lse = _fwd_impl(*(jnp.asarray(x.transpose(0, 2, 1, 3)) for x in (q, k, v)), k_idx, k_nnz,
                       block, True)
    return np.array(o).transpose(0, 2, 1, 3), np.array(lse)


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_fwd_visits_each_admitted_pair_once(name, D):
    """Over dQ's plan the forward visits every admitted (query, key) pair
    exactly once and no other pair, and writes every row once: by a
    consumer, or as o = 0 and lse = NEG_INF by the fetcher where the row
    admits nothing."""
    layout, S, block = _layout(name)
    H = layout.shape[0]
    rng = np.random.RandomState(S + D)
    q, k, v = (torch.from_numpy(rng.randn(1, S, H, D).astype(np.float32)) for _ in range(3))
    seen = torch.zeros(H, S, S, dtype=torch.int64)
    o, lse = tiled_fwd(q, k, v, layout, block, False, seen)
    admitted = torch.from_numpy(bsa.block_mask(layout, block).numpy().astype(np.int64))
    assert torch.equal(seen, admitted)
    empty = ~bsa.block_mask(layout, block).any(-1)  # [H, S]
    assert not torch.isnan(o).any() and not torch.isnan(lse).any()
    assert torch.equal(lse[0] == bsa.NEG_INF, empty)
    assert torch.all(o[0].transpose(0, 1)[empty] == 0)


@pytest.mark.parametrize("name", ["unreached_b64", "unreached_b128"])
def test_fwd_empty_row_item_is_zeros_and_neg_inf(name):
    """An item whose list is empty never reaches a consumer: its o is 0 and
    its lse NEG_INF, exactly the JAX kernel's (interpret mode)."""
    layout, S, block = _layout(name)
    H, D = layout.shape[0], 64
    items = [it for it in dq_plan(layout, block, D) if it[3] == 0]
    assert len(items) == H  # row 2 of every head
    rng = np.random.RandomState(3)
    q, k, v = (rng.randn(1, S, H, D).astype(np.float32) for _ in range(3))
    o, lse = tiled_fwd(*(torch.from_numpy(x) for x in (q, k, v)), layout, block, False)
    o_j, lse_j = _jax_fwd(q, k, v, layout, block)
    for h, _, row, _, _ in items:
        rows = slice(row * block, (row + 1) * block)
        assert torch.all(o[0, rows, h] == 0) and np.all(o_j[0, rows, h] == 0)
        assert torch.all(lse[0, h, rows] == bsa.NEG_INF)
        np.testing.assert_array_equal(lse[0, h, rows].numpy(), lse_j[0, h, rows])


@pytest.mark.parametrize("case", sorted(ARITH_CASES))
def test_tiled_forward_matches_jax_kernel(case):
    """The forward's tiles against the JAX package's ``_fwd_impl`` (its
    Pallas kernel in interpret mode): o and lse within 1e-5 with fp32
    inputs; with p rounded to bf16 before P V, as the kernel rounds it, o
    within ``row_scaled_err`` ROW_TOL and lse still within 1e-5."""
    B, S, H, D, block, make = ARITH_CASES[case]
    layout = bsa.full_layout(make(), H, S, block)
    rng = np.random.RandomState(len(case) + 11)
    q, k, v = (rng.randn(B, S, H, D).astype(np.float32) for _ in range(3))
    o_j, lse_j = _jax_fwd(q, k, v, layout, block)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    o, lse = tiled_fwd(*t, layout, block, round_p=False)
    np.testing.assert_allclose(o.numpy(), o_j, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(lse.numpy(), lse_j, atol=1e-5, rtol=1e-5)
    o16, lse16 = tiled_fwd(*t, layout, block, round_p=True)
    assert row_scaled_err(o16, torch.from_numpy(o_j)) <= ROW_TOL
    np.testing.assert_allclose(lse16.numpy(), lse_j, atol=1e-5, rtol=1e-5)
