"""The training engine in the PyTorch port vs the JAX engine, on the CPU.

``initialize`` + 3 ``train_batch`` steps of ``build_llama("debug")``
(gas 2, ``gradient_clipping``, Adam with weight decay, ``WarmupLR``) in
both packages from the same weights (the JAX init) and the same three
batches made with numpy, in fp32. The JAX engine gets a 1-device mesh
(``tests/conftest.py`` gives JAX 8 CPU devices, and its default mesh would
span them all), so both resolve the batch triple with a data-parallel
world of 1 and see the same micro-batches. Per-step losses and global
grad norms must agree within rtol 1e-5, the final params leaf by leaf
within atol/rtol 1e-4. Adam's ``eps`` is 1e-5 here, not 1e-8: a few
gradient elements are sums that cancel to fp32 noise (~1e-9), and with a
tiny ``eps`` Adam normalises that noise up to a full step of either sign,
so the two packages' summation orders would decide those elements.

In the port alone: the forward/backward/step loop gives exactly what
``train_batch`` gives, ZeRO stages 0-3 give exactly the same result on one
device, and under bf16 the fp32 master starts from the bf16-rounded
params."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import build_llama as jax_build_llama
from deepspeed_tpu.parallel import groups
from deepspeed_tpu_torch.models import build_llama, load_jax_params, params_to_jax

B, S, GAS, STEPS = 2, 16, 2, 3


def config(stage=0, **extra):
    cfg = {"train_batch_size": B * GAS, "train_micro_batch_size_per_gpu": B,
           "gradient_accumulation_steps": GAS, "gradient_clipping": 0.5,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-2, "weight_decay": 0.01,
                                                      "eps": 1e-5}},
           "scheduler": {"type": "WarmupLR",
                         "params": {"warmup_num_steps": 2, "warmup_max_lr": 1e-2}},
           "zero_optimization": {"stage": stage}, "steps_per_print": 1000}
    cfg.update(extra)
    return cfg


def batches():
    rng = np.random.RandomState(0)
    out = []
    for _ in range(STEPS):
        ids = rng.randint(0, 256, size=(B * GAS, S)).astype(np.int32)
        out.append((ids, ids.copy()))
    return out


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v, np.float32)


@pytest.fixture(scope="module")
def jax_run():
    model = jax_build_llama("debug")
    tree = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0),
                                               jnp.zeros((1, 8), jnp.int32))["params"])
    mesh = groups.initialize_mesh({"data_parallel_size": 1}, devices=jax.devices()[:1])
    try:
        engine, *_ = deepspeed_tpu.initialize(model=model, config=config(),
                                              model_parameters=jax.tree.map(jnp.asarray, tree),
                                              mesh=mesh)
        losses, norms = [], []
        for ids, labels in batches():
            losses.append(float(engine.train_batch(batch=(ids, labels))))
            norms.append(float(engine.global_grad_norm))
        final = dict(_flat(jax.tree.map(np.asarray, engine.params)))
        counters = (engine.global_steps, engine.global_samples, engine.micro_steps)
    finally:
        groups.destroy_mesh()
    return tree, losses, norms, final, counters


def port_engine(tree, **cfg_extra):
    model = load_jax_params(build_llama("debug", device="cpu"), tree)
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=config(**cfg_extra),
                                                device="cpu")
    return engine


def run_port(engine, loop=False):
    losses, norms = [], []
    for ids, labels in batches():
        if loop:
            micro = []
            for g in range(GAS):
                sl = slice(g * B, (g + 1) * B)
                loss = engine(ids[sl], labels[sl])
                engine.backward(loss)
                engine.step()
                micro.append(loss.item())
            losses.append(float(np.mean(micro)))
        else:
            losses.append(engine.train_batch(batch=(ids, labels)).item())
        norms.append(engine.global_grad_norm)
    return losses, norms, dict(_flat(params_to_jax(engine.module.named_parameters())))


def test_three_steps_match_the_jax_engine(jax_run):
    tree, losses_j, norms_j, final_j, counters_j = jax_run
    engine = port_engine(tree)
    losses, norms, final = run_port(engine)
    np.testing.assert_allclose(losses, losses_j, rtol=1e-5)
    np.testing.assert_allclose(norms, norms_j, rtol=1e-5)
    assert (engine.global_steps, engine.global_samples, engine.micro_steps) == counters_j
    assert sorted(final) == sorted(final_j)
    for path, x in final_j.items():
        np.testing.assert_allclose(final[path], x, atol=1e-4, rtol=1e-4, err_msg=path)


def test_forward_backward_step_loop_equals_train_batch(jax_run):
    tree = jax_run[0]
    a = run_port(port_engine(tree))
    b = run_port(port_engine(tree), loop=True)
    np.testing.assert_allclose(a[0], b[0], rtol=1e-6)
    assert a[1] == b[1]
    for path, x in a[2].items():
        np.testing.assert_array_equal(b[2][path], x, err_msg=path)


def test_zero_stages_are_identical_on_one_device(jax_run):
    tree = jax_run[0]
    runs = [run_port(port_engine(tree, zero_optimization={"stage": s})) for s in range(4)]
    for other in runs[1:]:
        assert other[0] == runs[0][0] and other[1] == runs[0][1]
        for path, x in runs[0][2].items():
            np.testing.assert_array_equal(other[2][path], x, err_msg=path)


def test_bf16_master_starts_from_the_rounded_params(jax_run):
    engine = port_engine(jax_run[0], bf16={"enabled": True})
    assert all(p.dtype == torch.bfloat16 for p in engine.params)
    for p, m in zip(engine.params, engine.master_params):
        assert m.dtype == torch.float32 and torch.equal(m, p.float())
    loss = engine.train_batch(batch=batches()[0])
    assert torch.isfinite(loss) and engine.global_steps == 1
    for p, m in zip(engine.params, engine.master_params):
        assert torch.equal(p, m.to(torch.bfloat16))
