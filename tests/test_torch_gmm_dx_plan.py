"""The work list of K5's wgmma forward and dx designs (``gmm_plan``), the
run each block of its wgmma dW design finds for its expert
(``gmm_dw_runs_ref``) and the shape predicates that choose the designs
(``dx_design``, ``wgmma_design``), on the CPU.

The plan is checked here through its plain version (``gmm_plan_ref``:
torch ops on the layout tensors' device, which ``gmm_plan`` takes on CPU
tensors; on the card a one-thread kernel builds the same integers, held
against it in ``tests/test_torch_gpu.py`` and ``chip_smoke.py`` phase
19): over random skewed routings like chip_smoke's MOE_TRAIN_SIZES (empty
experts, 8192 rows) at 16- and 64-row tiles, every used tile is covered
by exactly one item, no item holds two experts' tiles, the items stay
within the static bound, and the kernel's block numbering (emulated in
Python) visits each (item, column block) once, for dx's columns and for
the forward's, and zero-fills each row past the used tiles once. Running
the products item by item through the plan, fp32, gives the JAX
package's input gradient (``jax.grad`` through ``grouped_gemm``) within
1e-5 of its largest magnitude. The runs give each expert the padded rows
of the JAX package's ``tile_layout`` (only the used tiles when
``used_tiles`` stops short), and summing each expert's run, fp32, gives
the JAX package's weight gradient within 1e-5."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu.ops.grouped_gemm as jgg
import deepspeed_tpu.ops.pallas.grouped_matmul as jgm
from deepspeed_tpu_torch.ops.kernels import grouped_matmul as gm

FIELDS = 5  # first row, rows, expert, group's first item, group's item count


def _routing(seed, E=8, rows=8192):
    """Skewed rows per expert summing to ``rows``, some experts empty."""
    rng = np.random.RandomState(seed)
    p = rng.dirichlet(np.full(E, 0.7))
    p[rng.rand(E) < 0.25] = 0.0
    if not p.any():
        p[0] = 1.0
    return np.bincount(rng.choice(E, rows, p=p / p.sum()), minlength=E)


def _plan(sizes, tm):
    sizes_t = torch.tensor(sizes)
    _, te, Mp = gm.tile_layout(sizes_t, int(sizes_t.sum()), tm)
    used = gm.used_tiles(sizes_t, tm)
    return gm.gmm_plan(te, used, tm, len(sizes)), te, int(used), Mp


def _blocks(plan, cols):
    """The kernel's block → (item, column block) map over the grid."""
    out = []
    for b in range(cols * len(plan)):
        first, count = plan[b // cols][3], plan[b // cols][4]
        local = b - first * cols
        out.append((first + local % count, local // count))
    return out


def _check_plan(sizes, tm):
    plan, te, used, Mp = _plan(sizes, tm)
    P, T = gm.PLAN_ROWS // tm, Mp // tm
    assert plan.dtype == torch.int32 and plan.shape == (min(T, -(-T // P) + len(sizes)), FIELDS)
    p = plan.tolist()
    live = [r for r in p if r[2] >= 0]
    n = len(live)
    assert p[:n] == live  # the items first, then the zero-fill slots
    covered = []
    for j, (row0, rows, e, first, count) in enumerate(live):
        assert row0 % tm == 0 and rows % tm == 0 and 0 < rows <= gm.PLAN_ROWS
        tiles = list(range(row0 // tm, (row0 + rows) // tm))
        assert all(int(te[t]) == e for t in tiles)  # one expert an item
        assert first <= j < first + count
        assert all(q[2] == e and q[3] == first and q[4] == count
                   for q in live[first:first + count])
        covered += tiles
    assert covered == list(range(used))  # every used tile once, in order
    for row0, rows, e, first, count in p[n:]:
        assert (row0, rows, e, first, count) == (used * tm, 0, -1, n, len(p) - n)
    return plan, used, Mp


@pytest.mark.parametrize("tm", (16, 64))
@pytest.mark.parametrize("seed", range(6))
def test_plan_covers_each_used_tile_once(seed, tm):
    _check_plan(_routing(seed), tm)


@pytest.mark.parametrize("tm", (16, 64))
@pytest.mark.parametrize("sizes", [
    (2048, 1638, 1229, 1065, 819, 737, 656, 0),  # chip_smoke's MOE_TRAIN_SIZES
    (0, 0, 0, 0),                                 # no rows at all
    (0, 0, 300, 0),                               # every row on one expert
    (1, 1, 1, 1, 1, 1, 1, 1),                     # one partial tile an expert
    (64, 65, 127, 128, 129),                      # items of exactly 128 rows and past them
])
def test_plan_edge_routings(sizes, tm):
    plan, used, Mp = _check_plan(sizes, tm)
    if not sum(sizes):
        assert used == 0 and (plan[:, 2] == -1).all()


@pytest.mark.parametrize("tm", (16, 64))
def test_plan_without_spare_slots(tm):
    """A layout of one-tile runs filled to its last tile: as many items as
    slots, so no zero-fill slot, and no row needs one."""
    te = torch.tensor([0, 1], dtype=torch.int32)
    plan = gm.gmm_plan(te, torch.tensor([2], dtype=torch.int32), tm, 2)
    assert plan.tolist() == [[0, tm, 0, 0, 1], [tm, tm, 1, 1, 1]]


@pytest.mark.parametrize("cols", (1, 3, 16))
@pytest.mark.parametrize("tm", (16, 64))
@pytest.mark.parametrize("seed", (0, 1))
def test_block_map_visits_each_item_and_zero_row_once(seed, tm, cols):
    sizes = _routing(seed, rows=2048)
    plan, used, Mp = _check_plan(sizes, tm)
    p = plan.tolist()
    n = sum(r[2] >= 0 for r in p)
    blocks = _blocks(p, cols)
    work = [(i, k) for i, k in blocks if i < n]
    assert sorted(work) == [(i, k) for i in range(n) for k in range(cols)]
    zeroed = {k: [] for k in range(cols)}
    for i, k in blocks:
        if i >= n:  # the kernel's zero fill: 128-row chunks, strided over the spare items
            row0, _, _, first, count = p[i]
            for r in range(row0 + gm.PLAN_ROWS * (i - first), Mp, gm.PLAN_ROWS * count):
                zeroed[k] += range(r, min(r + gm.PLAN_ROWS, Mp))
    for k in range(cols):
        assert sorted(zeroed[k]) == list(range(used * tm, Mp))


def _emulate(dy, w, plan, K, Mp):
    """The kernel's work through the plan, fp32: each item's rows times
    its expert's W transposed, the rows past the items zero."""
    out = torch.zeros((Mp, K))
    for row0, rows, e, _, _ in plan.tolist():
        if e >= 0:
            out[row0:row0 + rows] = dy[row0:row0 + rows] @ w[e].t()
    return out


@pytest.mark.parametrize("tm", (16, 64))
@pytest.mark.parametrize("sizes", [(90, 0, 33, 140, 7), (0, 0, 200, 0)])
def test_plan_products_match_jax_input_gradient(sizes, tm):
    E, K, N = len(sizes), 48, 40
    rng = np.random.RandomState(3)
    n = int(sum(sizes))
    gs = rng.randn(n, N).astype(np.float32)
    xs = rng.randn(n, K).astype(np.float32)
    w = rng.randn(E, K, N).astype(np.float32)
    sizes_t = torch.tensor(sizes)
    dst, te, Mp = gm.pad_groups_to_tiles(sizes_t, n, tm)
    dyp = torch.zeros((Mp, N))
    dyp[dst.long()] = torch.from_numpy(gs)
    plan = gm.gmm_plan(te, gm.used_tiles(sizes_t, tm), tm, E)
    got = _emulate(dyp, torch.from_numpy(w), plan, K, Mp)
    want = jax.grad(lambda x_: (jgg.grouped_gemm(x_, jnp.asarray(w), jnp.asarray(sizes))
                                * jnp.asarray(gs)).sum())(jnp.asarray(xs))
    rows = got[dst.long()].numpy()
    err = np.abs(rows - np.asarray(want)).max() / np.abs(np.asarray(want)).max()
    assert err <= 1e-5, err
    assert not got[int(gm.used_tiles(sizes_t, tm)) * tm:].any()


@pytest.mark.parametrize("scheme,N,design", [
    ("bf16", 4096, "wgmma"), ("bf16", 14336, "wgmma"), ("bf16", 200, "wgmma"),
    ("bf16", 136, "wgmma"), ("bf16", 36, "general"),
    ("int8", 4096, "wgmma"), ("int8", 384, "wgmma"), ("int8", 200, "general"),
    ("int8", 136, "general"), ("fp8", 512, "wgmma"), ("fp8", 24, "general"),
    ("fp6", 14336, "wgmma"), ("fp6", 320, "wgmma"), ("fp6", 200, "general"),
    ("fp6", 96, "general"),
])
def test_dx_design_by_shape(scheme, N, design):
    """TMA needs rows of dy and W a multiple of 16 bytes."""
    assert gm.dx_design(scheme, N, 0, 256) == design


@pytest.mark.parametrize("ptrs", [(8, 0), (0, 4), (2, 2)])
def test_dx_design_needs_aligned_bases(ptrs):
    assert gm.dx_design("bf16", 4096, *ptrs) == "general"


@pytest.mark.parametrize("N", (14336, 4096, 200, 72))
@pytest.mark.parametrize("seed", (0, 1))
def test_forward_block_map_visits_each_item_and_zero_row_once(seed, N):
    """The forward's blocks: each (item, 256-wide column block of N) once,
    each row past the used tiles zeroed once per column block (64-row
    tiles, the only ones the forward's wgmma design takes)."""
    tm, cols = 64, -(-N // 256)
    plan, used, Mp = _check_plan(_routing(seed), tm)
    p = plan.tolist()
    n = sum(r[2] >= 0 for r in p)
    blocks = _blocks(p, cols)
    assert len(blocks) == len(set(blocks)) == cols * len(p)
    assert sorted((i, k) for i, k in blocks if i < n) == [(i, k) for i in range(n)
                                                           for k in range(cols)]
    for k in range(cols):
        zeroed = []
        for i, kk in blocks:
            if i >= n and kk == k:
                row0, _, _, first, count = p[i]
                for r in range(row0 + gm.PLAN_ROWS * (i - first), Mp, gm.PLAN_ROWS * count):
                    zeroed += range(r, min(r + gm.PLAN_ROWS, Mp))
        assert sorted(zeroed) == list(range(used * tm, Mp))


def _runs_by_hand(te, used, tm, E):
    """Each expert's (first row, rows) among the first ``used`` tiles."""
    out = [[0, 0] for _ in range(E)]
    for t in range(used):
        e = int(te[t])
        if out[e][1] == 0:
            out[e][0] = t * tm
        out[e][1] += tm
    return out


@pytest.mark.parametrize("tm", (16, 64))
@pytest.mark.parametrize("seed", range(6))
def test_dw_runs_match_jax_tile_layout(seed, tm):
    """With every tile used, each expert's run is its padded group in the
    JAX package's tile layout; with ``used_tiles`` below the layout's
    tiles, only the tiles before it count."""
    sizes = _routing(seed)
    E, n = len(sizes), int(sizes.sum())
    starts, te, Mp = jgm.tile_layout(jnp.asarray(sizes, jnp.int32), n, tm)
    te = torch.tensor(np.asarray(te), dtype=torch.int32)
    padded = -(-sizes // tm) * tm
    used = torch.tensor([int(padded.sum()) // tm], dtype=torch.int32)
    runs = gm.gmm_dw_runs_ref(te, used, tm, E)
    assert runs.dtype == torch.int32 and runs.shape == (E, 2)
    want = [[int(s) if p else 0, int(p)] for s, p in zip(np.asarray(starts), padded)]
    assert runs.tolist() == want
    for cut in (0, 1, int(used) // 3, int(used) - 1):
        got = gm.gmm_dw_runs_ref(te, torch.tensor([cut], dtype=torch.int32), tm, E).tolist()
        assert got == _runs_by_hand(te, cut, tm, E)


@pytest.mark.parametrize("tm", (16, 64))
def test_dw_runs_edge_routings(tm):
    """No rows at all, every row on the last expert, and tiles whose
    expert is out of range (they count for none)."""
    none = torch.tensor([0], dtype=torch.int32)
    assert gm.gmm_dw_runs_ref(torch.zeros(4, dtype=torch.int32), none, tm, 3).tolist() == \
        [[0, 0]] * 3
    sizes = torch.tensor([0, 0, 300])
    _, te, _ = gm.tile_layout(sizes, 300, tm)
    runs = gm.gmm_dw_runs_ref(te, gm.used_tiles(sizes, tm), tm, 3).tolist()
    assert runs == [[0, 0], [0, 0], [0, -(-300 // tm) * tm]]
    te = torch.tensor([0, 5, -1, 1], dtype=torch.int32)
    assert gm.gmm_dw_runs_ref(te, torch.tensor([4], dtype=torch.int32), tm, 2).tolist() == \
        [[0, tm], [3 * tm, tm]]


@pytest.mark.parametrize("tm", (16, 64))
@pytest.mark.parametrize("sizes", [(90, 0, 33, 140, 7), (0, 0, 200, 0)])
def test_dw_runs_products_match_jax_weight_gradient(sizes, tm):
    """dW summed run by run, fp32, against ``jax.grad``
    of the JAX package's ``grouped_gemm`` in the stack (an empty expert's
    dW zero)."""
    E, K, N = len(sizes), 48, 40
    rng = np.random.RandomState(5)
    n = int(sum(sizes))
    gs = rng.randn(n, N).astype(np.float32)
    xs = rng.randn(n, K).astype(np.float32)
    w = rng.randn(E, K, N).astype(np.float32)
    sizes_t = torch.tensor(sizes)
    dst, te, Mp = gm.pad_groups_to_tiles(sizes_t, n, tm)
    xp, dyp = torch.zeros((Mp, K)), torch.zeros((Mp, N))
    xp[dst.long()], dyp[dst.long()] = torch.from_numpy(xs), torch.from_numpy(gs)
    runs = gm.gmm_dw_runs_ref(te, gm.used_tiles(sizes_t, tm), tm, E).tolist()
    got = torch.stack([xp[r0:r0 + r].t() @ dyp[r0:r0 + r] for r0, r in runs])
    want = np.asarray(jax.grad(lambda w_: (jgg.grouped_gemm(jnp.asarray(xs), w_, jnp.asarray(sizes))
                                           * jnp.asarray(gs)).sum())(jnp.asarray(w)))
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err <= 1e-5, err
    for e, s in enumerate(sizes):
        if s == 0:
            assert not got[e].any()


@pytest.mark.parametrize("tm,K,N,design", [
    (64, 4096, 14336, "wgmma"), (64, 14336, 4096, "wgmma"),   # Mixtral's w1/w3 and w2
    (64, 768, 2048, "wgmma"), (64, 128, 200, "wgmma"),         # bench_train_moe; N past 256
    (64, 96, 136, "wgmma"), (64, 8, 8, "wgmma"),
    (16, 4096, 14336, "general"), (16, 128, 200, "general"),   # decode tiles keep the first
    (64, 100, 64, "general"), (64, 64, 36, "general"),         # rows not 16 bytes
    (64, 4, 4096, "general"),
])
def test_wgmma_design_by_shape(tm, K, N, design):
    """The forward's and dW's design: 64-row tiles, K % 8 and N % 8."""
    assert gm.wgmma_design(tm, K, N, 0, 256) == design


@pytest.mark.parametrize("ptrs", [(8, 0), (0, 4), (2, 2), (0, 16, 24)])
def test_wgmma_design_needs_aligned_bases(ptrs):
    assert gm.wgmma_design(64, 4096, 4096, *ptrs) == "general"


def test_wgmma_design_ignores_rows_and_routing():
    """The predicate takes no row count or routing: the same shape names
    the same design for any batch."""
    import inspect
    assert list(inspect.signature(gm.wgmma_design).parameters) == ["tm", "K", "N", "ptrs"]
