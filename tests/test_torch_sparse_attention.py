"""Block-sparse attention in the PyTorch port vs the JAX package, on the CPU.

- Every ``SparsityConfig`` layout is bit-equal to the JAX package's (BigBird
  seeds and its stateful second draw, per-head layouts, unidirectional,
  BSLongformer end indices), and so are ``layout_to_indices`` and
  ``grid_fraction`` (the 4k BigBird work ratio too).
- ds_config section parsing gives the same config, or None, for the same
  inputs; ``freeze_section``/``thaw_section``, ``pad_to_block_size``,
  ``unpad_sequence_output`` and ``extend_position_embedding`` agree.
- K8's plain versions (the forward with its lse, and the dQ and dK/dV
  versions the CUDA kernels are held against) match the JAX
  ``block_sparse_attention`` run in interpret mode, gradients through
  ``jax.grad``, in the JAX test's cases (BigBird, Fixed, Fixed
  unidirectional, per-head, ragged and empty rows), in fp32 within
  atol/rtol 2e-5 (outputs) and 5e-5 (gradients): fp32 sums in another order.
- ``SparseSelfAttention`` dispatch: with no mask the port takes K8's plain
  version (held to JAX's kernel path); key-padding and attention masks in
  the 'add' and 'mul' modes take the masked-dense path (held to JAX's,
  fully-masked rows included).
- The launchers raise on CPU tensors."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.ops.pallas import block_sparse_attention as jbsa
from deepspeed_tpu.ops import sparse_attention as jsa
from deepspeed_tpu.ops.sparse_attention import sparse_attention_utils as jutils
from deepspeed_tpu_torch.ops.kernels import block_sparse_attention as bsa
from deepspeed_tpu_torch.ops.kernels.flash_attention import flash_delta
from deepspeed_tpu_torch.ops import sparse_attention as sa
from deepspeed_tpu_torch.ops.sparse_attention import sparse_attention_utils as utils

FWD_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=5e-5, atol=5e-5)

LAYOUTS = {  # name: (config class name, kwargs, seq_len)
    "dense": ("DenseSparsityConfig", dict(num_heads=2, block=16), 64),
    "fixed": ("FixedSparsityConfig", dict(num_heads=2, block=16, num_local_blocks=4,
                                          num_global_blocks=1), 256),
    "fixed_uni": ("FixedSparsityConfig", dict(num_heads=2, block=16, num_local_blocks=4,
                                              num_global_blocks=2, attention="unidirectional"),
                  256),
    "fixed_horizontal": ("FixedSparsityConfig", dict(num_heads=3, block=32, num_local_blocks=2,
                                                     horizontal_global_attention=True), 256),
    "variable": ("VariableSparsityConfig", dict(num_heads=2, block=16, num_local_blocks=3), 128),
    "bigbird": ("BigBirdSparsityConfig", dict(num_heads=2, block=16, num_random_blocks=1,
                                              num_sliding_window_blocks=3,
                                              num_global_blocks=1), 256),
    "bigbird_seed7_per_head": ("BigBirdSparsityConfig", dict(
        num_heads=4, block=16, different_layout_per_head=True, num_random_blocks=2,
        num_sliding_window_blocks=1, num_global_blocks=2, seed=7), 256),
    "bigbird_uni": ("BigBirdSparsityConfig", dict(num_heads=1, block=64, num_random_blocks=3,
                                                  attention="unidirectional", seed=3), 1024),
    "bigbird_4k": ("BigBirdSparsityConfig", dict(num_heads=16, block=64, num_random_blocks=1,
                                                 num_sliding_window_blocks=3,
                                                 num_global_blocks=1), 4096),
    "bslongformer": ("BSLongformerSparsityConfig", dict(num_heads=2, block=16,
                                                        num_sliding_window_blocks=3,
                                                        global_block_indices=[0, 5]), 256),
    "bslongformer_ends": ("BSLongformerSparsityConfig", dict(
        num_heads=2, block=16, global_block_indices=[0, 6], global_block_end_indices=[2, 8],
        attention="unidirectional"), 256),
}


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_layouts_bit_equal_jax(name):
    cls, kw, S = LAYOUTS[name]
    mine, ref = getattr(sa, cls)(**kw), getattr(jsa, cls)(**kw)
    for _ in range(2):  # BigBird draws anew on each call, in the same order
        a, b = mine.make_layout(S), ref.make_layout(S)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_bigbird_is_stateful():
    cfg = sa.BigBirdSparsityConfig(num_heads=1, block=16)
    assert not np.array_equal(cfg.make_layout(512), cfg.make_layout(512))


@pytest.mark.parametrize("name", ["fixed_uni", "bigbird_seed7_per_head", "bslongformer_ends",
                                  "bigbird_4k"])
def test_indices_and_grid_fraction_bit_equal_jax(name):
    cls, kw, S = LAYOUTS[name]
    layout = getattr(jsa, cls)(**kw).make_layout(S)
    for a, b in zip(bsa.layout_to_indices(layout), jbsa.layout_to_indices(layout)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert bsa.grid_fraction(layout) == jbsa.grid_fraction(layout)


def test_bigbird_4k_work_ratio():
    """BigBird block 64 at S 4096 (the card's path): 9.13% of the block
    pairs, 374 of 4096 a head, 5 blocks in the median row."""
    layout = sa.BigBirdSparsityConfig(num_heads=1, block=64).make_layout(4096)
    k_idx, k_nnz, q_idx, q_nnz = bsa.layout_to_indices(layout)
    assert int(k_nnz.sum()) == int(q_nnz.sum()) == int(layout.sum()) == 374
    assert bsa.grid_fraction(layout) == pytest.approx(374 / 4096)
    assert int(np.median(k_nnz)) == 5 and int(k_nnz.max()) == 64 and int(q_nnz[0, 0]) == 64


SECTIONS = [
    {"sparse_attention": {"mode": "bigbird", "block": 32, "num_random_blocks": 2,
                          "num_sliding_window_blocks": 3, "num_global_blocks": 1}},
    {"sparse_attention": {}},
    {"sparse_attention": None},
    {"mode": "bslongformer", "global_block_indices": [0, 3]},
    {"num_local_blocks": 2, "block": 8},
    {"mode": "variable"},
    {"seed": 1},
    {"block": 8},
    {},
    {"train_batch_size": 4},
    None,
    [1, 2],
]


def _vars(cfg):
    return None if cfg is None else (type(cfg).__name__,
                                     {k: v for k, v in vars(cfg).items() if k != "_rng"})


@pytest.mark.parametrize("i", range(len(SECTIONS)))
def test_section_parsing_matches_jax(i):
    assert _vars(utils.get_sparse_attention_config(SECTIONS[i], 4)) == \
        _vars(jutils.get_sparse_attention_config(SECTIONS[i], 4))


def test_unknown_mode_raises_like_jax():
    bad = {"sparse_attention": {"mode": "nope"}}
    for fn in (utils.get_sparse_attention_config, jutils.get_sparse_attention_config):
        with pytest.raises(NotImplementedError, match="sparsity mode"):
            fn(bad, 4)


def test_freeze_thaw_match_jax():
    section = {"mode": "bslongformer", "global_block_indices": [0, 3], "block": 16}
    frozen = utils.freeze_section(section)
    assert frozen == jutils.freeze_section(section)
    assert utils.thaw_section(frozen) == jutils.thaw_section(frozen) == section


@pytest.mark.parametrize("S,block", [(45, 16), (48, 16), (50, 32)])
def test_pad_unpad_match_jax(S, block):
    rng = np.random.RandomState(S)
    ids = rng.randint(0, 100, (2, S))
    tt = rng.randint(0, 2, (2, S))
    emb = rng.randn(2, S, 4).astype(np.float32)
    mine = utils.SparseAttentionUtils.pad_to_block_size(block, torch.from_numpy(ids),
                                                        token_type_ids=tt, inputs_embeds=emb,
                                                        pad_token_id=9)
    ref = jutils.SparseAttentionUtils.pad_to_block_size(block, ids, token_type_ids=tt,
                                                        inputs_embeds=emb, pad_token_id=9)
    assert mine[0] == ref[0]
    for a, b in zip(mine[1:], ref[1:]):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), b)
    out = rng.randn(2, S + mine[0], 8)
    np.testing.assert_array_equal(
        utils.SparseAttentionUtils.unpad_sequence_output(mine[0], torch.from_numpy(out)).numpy(),
        jutils.SparseAttentionUtils.unpad_sequence_output(ref[0], out))


def test_extend_position_embedding_matches_jax():
    table = np.arange(12.0, dtype=np.float32).reshape(6, 2)
    tree = {"model": {"embed_positions": table, "layers": {"w": np.ones((2, 2))}}}
    want = jutils.SparseAttentionUtils.extend_position_embedding(tree, 15)
    state = {"model.embed_positions": torch.from_numpy(table), "model.layers.0.w": torch.ones(2)}
    got = utils.SparseAttentionUtils.extend_position_embedding(state, 15)
    np.testing.assert_array_equal(got["model.embed_positions"].numpy(),
                                  want["model"]["embed_positions"])
    assert torch.equal(got["model.layers.0.w"], torch.ones(2))
    nested = utils.SparseAttentionUtils.extend_position_embedding(tree, 15)
    np.testing.assert_array_equal(nested["model"]["embed_positions"],
                                  want["model"]["embed_positions"])
    for fn, arg in ((utils.SparseAttentionUtils.extend_position_embedding, state),
                    (jutils.SparseAttentionUtils.extend_position_embedding, tree)):
        with pytest.raises(ValueError, match="must exceed"):
            fn(arg, 6)
    with pytest.raises(ValueError, match="no 2-D"):
        utils.SparseAttentionUtils.extend_position_embedding({"w": torch.ones(2, 2)}, 8)


# ------------------------------------------------------------- K8 numerics
def _ragged_layout():
    """The JAX test's ragged rows: 4 admitted, 1, none, 1; key block 2 is
    admitted by row 0 only, and key block 0 by row 0 only."""
    layout = np.zeros((1, 4, 4), bool)
    layout[0, 0] = True
    layout[0, 1, 1] = True
    layout[0, 3, 3] = True
    return layout


def _unreached_layout():
    """A layout with an empty row and a key block no row admits."""
    layout = np.zeros((2, 4, 4), bool)
    layout[:, 0, [0, 1]] = True
    layout[:, 1, 1] = True
    layout[:, 3, [0, 3]] = True
    layout[1, 1, 0] = True  # heads differ
    return layout


CASES = {  # name: (layout maker, B, S, H, D, block)
    "bigbird": (lambda: jsa.BigBirdSparsityConfig(
        num_heads=2, block=16, num_random_blocks=1, num_sliding_window_blocks=3,
        num_global_blocks=1).make_layout(128), 2, 128, 2, 32, 16),
    "fixed": (lambda: jsa.FixedSparsityConfig(num_heads=2, block=16, num_local_blocks=4,
                                              num_global_blocks=1).make_layout(128),
              2, 128, 2, 32, 16),
    "fixed_uni": (lambda: jsa.FixedSparsityConfig(
        num_heads=2, block=16, num_local_blocks=4, num_global_blocks=1,
        attention="unidirectional").make_layout(128), 2, 128, 2, 32, 16),
    "per_head": (lambda: jsa.BigBirdSparsityConfig(
        num_heads=3, block=16, different_layout_per_head=True, num_random_blocks=1,
        num_sliding_window_blocks=1, num_global_blocks=1).make_layout(64), 1, 64, 3, 16, 16),
    "ragged_empty_row": (_ragged_layout, 1, 64, 1, 16, 16),
    "unreached_key_block": (_unreached_layout, 2, 64, 2, 16, 16),
    "broadcast_block32": (lambda: jsa.BigBirdSparsityConfig(
        num_heads=1, block=32, num_random_blocks=1).make_layout(256), 1, 256, 3, 16, 32),
}


def _inputs(B, S, H, D, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, S, H, D).astype(np.float32) for _ in range(4)]  # q, k, v, do


def _jax_run(q, k, v, do, layout, block):
    """JAX interpret-mode kernel → (o, lse [B, H, S], dq, dk, dv)."""
    H = q.shape[2]
    full = np.broadcast_to(layout, (H,) + layout.shape[1:]) if layout.shape[0] == 1 else layout
    k_idx, k_nnz, _, _ = jbsa.layout_to_indices(full)
    bhsd = lambda x: jnp.asarray(x).transpose(0, 2, 1, 3)
    _, lse = jbsa._fwd_impl(bhsd(q), bhsd(k), bhsd(v), jnp.asarray(k_idx), jnp.asarray(k_nnz),
                            block, True)

    def loss(q, k, v):
        o = jbsa.block_sparse_attention(q, k, v, layout, block, interpret=True)
        return jnp.sum(o * do), o

    (_, o), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return (np.asarray(o), np.asarray(lse)) + tuple(np.asarray(g) for g in grads)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_k8_matches_jax_kernel(case):
    make, B, S, H, D, block = CASES[case]
    layout = make()
    q, k, v, do = _inputs(B, S, H, D, seed=len(case))
    o_j, lse_j, dq_j, dk_j, dv_j = _jax_run(q, k, v, do, layout, block)

    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    tdo = torch.from_numpy(do)
    o, lse = bsa.block_sparse_fwd_ref(tq, tk, tv, layout, block)
    np.testing.assert_allclose(o.detach().numpy(), o_j, **FWD_TOL)
    np.testing.assert_array_equal(lse.detach().numpy() == bsa.NEG_INF, lse_j == bsa.NEG_INF)
    np.testing.assert_allclose(lse.detach().numpy(), lse_j, **FWD_TOL)
    # autograd through the plain version: the CPU path of block_sparse_attention
    out = bsa.block_sparse_attention(tq, tk, tv, layout, block)
    (out * tdo).sum().backward()
    for got, want, name in ((tq.grad, dq_j, "dq"), (tk.grad, dk_j, "dk"), (tv.grad, dv_j, "dv")):
        np.testing.assert_allclose(got.numpy(), want, err_msg=name, **GRAD_TOL)
    # the plain versions of the backward kernels, from the saved o and lse
    args = (tq.detach(), tk.detach(), tv.detach(), tdo, lse.detach(),
            flash_delta(o.detach(), tdo), layout, block)
    np.testing.assert_allclose(bsa.block_sparse_dq_ref(*args).numpy(), dq_j, **GRAD_TOL)
    dk, dv = bsa.block_sparse_dkv_ref(*args)
    np.testing.assert_allclose(dk.numpy(), dk_j, **GRAD_TOL)
    np.testing.assert_allclose(dv.numpy(), dv_j, **GRAD_TOL)


def test_empty_row_and_unreached_key_block_give_zeros():
    layout = _unreached_layout()
    q, k, v, do = (torch.from_numpy(x).requires_grad_(True) for x in _inputs(1, 64, 2, 16, 3))
    o, lse = bsa.block_sparse_fwd_ref(q, k, v, layout, 16)
    assert torch.all(o[:, 32:48] == 0) and torch.all(lse[:, :, 32:48] == bsa.NEG_INF)
    (o * do.detach()).sum().backward()
    assert torch.all(k.grad[:, 32:48] == 0) and torch.all(v.grad[:, 32:48] == 0)
    assert torch.all(q.grad[:, 32:48] == 0)


# ----------------------------------------------------- SparseSelfAttention
def _ssa_pair(cls, kw, force=None):
    return (sa.SparseSelfAttention(getattr(sa, cls)(**kw), force_kernel=force),
            jsa.SparseSelfAttention(getattr(jsa, cls)(**kw), force_kernel=force))


FIXED = ("FixedSparsityConfig", dict(num_heads=2, block=16, num_local_blocks=2,
                                     num_global_blocks=1))


def test_no_mask_takes_the_kernel_path():
    mine, ref = _ssa_pair(*FIXED)
    _, ref_kernel = _ssa_pair(*FIXED, force=True)
    q, k, v, _ = _inputs(2, 64, 2, 16, 7)
    calls = []
    real = bsa.block_sparse_attention
    bsa.block_sparse_attention = lambda *a: calls.append(1) or real(*a)
    try:
        got = mine(*map(torch.from_numpy, (q, k, v)))
    finally:
        bsa.block_sparse_attention = real
    assert calls == [1]
    want = ref_kernel(*map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref(*map(jnp.asarray, (q, k, v)))),
                               **FWD_TOL)


def _masks(B, S, seed):
    rng = np.random.RandomState(seed)
    keep = rng.rand(B, S) > 0.3
    keep[1, :] = False  # batch row 1: every key padded → fully-masked rows
    attn = rng.rand(S, S) > 0.2
    attn[5, :] = False  # query 5 attends nothing
    return {
        "kpm_add": (dict(key_padding_mask=np.where(keep, 0.0, -10000.0).astype(np.float32)),
                    "add", "mul"),
        "kpm_mul": (dict(key_padding_mask=keep.astype(np.int32)), "mul", "mul"),
        "kpm_bool": (dict(key_padding_mask=keep), "add", "mul"),
        "attn_mul": (dict(attn_mask=attn.astype(np.float32)), "add", "mul"),
        "attn_add_batched": (dict(attn_mask=np.where(
            np.stack([attn, attn.T]), 0.0, -1e9).astype(np.float32)), "add", "add"),
        "both": (dict(key_padding_mask=keep, attn_mask=attn), "add", "mul"),
    }


@pytest.mark.parametrize("kind", sorted(_masks(2, 64, 0)))
def test_masks_take_the_masked_dense_path_like_jax(kind):
    B, S = 2, 64
    masks, kpm_mode, am_mode = _masks(B, S, 11)[kind]
    q, k, v, _ = _inputs(B, S, 2, 16, 13)
    cls, kw = FIXED
    mine = sa.SparseSelfAttention(getattr(sa, cls)(**kw), key_padding_mask_mode=kpm_mode,
                                  attn_mask_mode=am_mode)
    ref = jsa.SparseSelfAttention(getattr(jsa, cls)(**kw), key_padding_mask_mode=kpm_mode,
                                  attn_mask_mode=am_mode)
    real = bsa.block_sparse_attention
    bsa.block_sparse_attention = None  # the masked-dense path must not reach the kernel
    try:
        got = mine(*map(torch.from_numpy, (q, k, v)),
                   **{n: torch.from_numpy(np.asarray(m)) for n, m in masks.items()})
    finally:
        bsa.block_sparse_attention = real
    want = ref(*map(jnp.asarray, (q, k, v)), **{n: jnp.asarray(m) for n, m in masks.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


def test_seq_not_a_block_multiple_takes_masked_dense():
    cls, kw = FIXED
    mine = sa.SparseSelfAttention(getattr(sa, cls)(**kw))
    assert not mine._use_kernel(72) and mine._use_kernel(64)


def test_layout_to_mask_matches_jax():
    layout = _unreached_layout()
    np.testing.assert_array_equal(sa.layout_to_mask(layout, 16, 60).numpy(),
                                  np.asarray(jsa.layout_to_mask(layout, 16, 60)))


def test_launchers_take_cuda_tensors_only():
    layout = np.ones((1, 4, 4), bool)
    x = torch.zeros(1, 64, 1, 64, dtype=torch.bfloat16)
    lse = torch.zeros(1, 1, 64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        bsa.block_sparse_fwd(x, x, x, layout, 16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        bsa.block_sparse_dq(x, x, x, x, lse, lse, layout, 16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        bsa.block_sparse_dkv(x, x, x, x, lse, lse, layout, 16)


@pytest.mark.parametrize("section", [None, {}, {"mode": "bigbird", "block": 64}])
def test_config_keeps_the_raw_section_like_jax(section):
    from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
    cfg = {"train_batch_size": 4}
    if section is not None:
        cfg["sparse_attention"] = section
    assert DeepSpeedConfig(cfg).sparse_attention == JaxConfig(cfg).sparse_attention
