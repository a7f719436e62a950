"""The PyTorch port stands alone.

- No file of ``deepspeed_tpu_torch`` (nor ``chip_smoke.py``) imports jax,
  flax, pydantic or the JAX package (AST scan).
- Every port module imports in a fresh interpreter where ``jax`` cannot
  be imported at all.
- Entry points given no device run on the GPU: on a machine without one
  they raise instead of quietly running on the CPU.
- Each config switch of a feature the port does not serve or train yet
  raises ``NotImplementedError`` at engine (or model) construction, naming
  its ROADMAP item (MoE models serve, and train only once item 17 is
  ported); so do the training engine's checkpoint methods."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2, DynamicSplitFuseScheduler,
                                              RaggedInferenceEngineConfig)
import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import build_llama, init_params, llama_config
from deepspeed_tpu_torch.models.llama import init_quantized_params

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "deepspeed_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "pydantic", "deepspeed_tpu", "optax", "orbax"}


def _port_files():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _modules():
    return sorted(".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
                  for p in PKG.rglob("*.py"))


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}:{node.lineno} imports {name}"


def test_every_module_imports_without_jax():
    code = ("import importlib, sys\n"
            "for name in ('jax', 'jaxlib', 'flax', 'pydantic', 'deepspeed_tpu'):\n"
            "    sys.modules[name] = None\n"
            f"for mod in {_modules()!r}:\n"
            "    importlib.import_module(mod)\n"
            "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


SLICE3_MODULES = ("deepspeed_tpu_torch.ops.fp_quantizer.quantize",
                  "deepspeed_tpu_torch.inference.quantization.quantization",
                  "deepspeed_tpu_torch.ops.kernels.fused_quant_matmul",
                  "deepspeed_tpu_torch.ops.kernels.grouped_matmul",
                  "deepspeed_tpu_torch.ops.grouped_gemm")


def test_scans_cover_the_quantized_moe_slice():
    """The AST scan and the jax-free import above reach the quantized and
    MoE serving modules and their CUDA sources' wrappers."""
    assert set(SLICE3_MODULES) <= set(_modules())
    from deepspeed_tpu_torch.ops.kernels import build
    assert {"fused_quant_matmul.cu", "grouped_matmul.cu"} <= set(build.SOURCES)
    for src in build.SOURCES:
        assert (build.CSRC / src).exists(), src


def test_default_device_is_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None would rightly use it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngineV2("debug")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(llama_config("debug"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_quantized_params(llama_config("mixtral-debug"), "int8")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_llama("debug")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        deepspeed_tpu_torch.initialize(model=build_llama("debug", device="cpu"),
                                       config=TRAIN_CONFIG)


OFF_SLICE = {
    "prefix_cache": dict(prefix_cache={"enabled": True}),
    "kv_tier": dict(kv_tier={"enabled": True}),
    "spec_decode": dict(spec_decode={"enabled": True}),
    "lora": dict(lora={"enabled": True, "publish_root": "adapters"}),  # the disk tier
    "structured": dict(structured={"enabled": True}),
    "async_burst": dict(async_burst={"enabled": True}),
    "tensor_parallel_degree": dict(tensor_parallel_degree=2),
    "expert_parallel_degree": dict(expert_parallel_degree=2),
}


@pytest.mark.parametrize("flag", sorted(OFF_SLICE))
def test_off_slice_feature_raises(flag):
    cfg = RaggedInferenceEngineConfig(**OFF_SLICE[flag])
    with pytest.raises(NotImplementedError, match=f"{flag}.*ROADMAP.md, port queue item"):
        InferenceEngineV2("debug", cfg, dtype=torch.float32, device="cpu")


def test_off_slice_model_and_sampling_raise():
    eng = InferenceEngineV2("debug", dtype=torch.float32, device="cpu")
    with pytest.raises(NotImplementedError, match="sampling"):
        eng.put([1], [[1, 2, 3]], sample={"temperature": 1.0})
    with pytest.raises(NotImplementedError, match="sampling"):
        DynamicSplitFuseScheduler(eng, sampling={"temperature": 0.7})
    sched = DynamicSplitFuseScheduler(eng)
    with pytest.raises(NotImplementedError, match="sampling"):
        sched.add_request(1, [1, 2], sample={"temperature": 0.7})
    cfg = RaggedInferenceEngineConfig(implementation_overrides={"attention": "cuda_paged"})
    with pytest.raises(ValueError, match="cuda_paged"):
        InferenceEngineV2("debug", cfg, dtype=torch.float32, device="cpu")


TRAIN_CONFIG = {"train_batch_size": 4, "train_micro_batch_size_per_gpu": 2,
                "bf16": {"enabled": True}, "zero_optimization": {"stage": 3}}

TRAIN_OFF_SLICE = {
    "fp16": ({"fp16": {"enabled": True}, "bf16": {"enabled": False}}, 9),
    "offload_optimizer": ({"zero_optimization": {"stage": 3,
                                                 "offload_optimizer": {"device": "cpu"}}}, 12),
    "offload_param": ({"zero_optimization": {"stage": 3, "offload_param": {"device": "nvme"}}},
                      12),
    "cpu_offload_deprecated": ({"zero_optimization": {"stage": 2, "cpu_offload": True}}, 12),
    "mesh_data": ({"mesh": {"data_parallel_size": 2}}, 7),
    "mesh_tensor": ({"mesh": {"tensor_parallel_size": 2}}, 6),
    "zero_quantized_gradients": ({"zero_optimization": {"stage": 3,
                                                        "zero_quantized_gradients": True}}, 7),
    "monitor": ({"tensorboard": {"enabled": True}}, 6),
    "hybrid_engine": ({"hybrid_engine": {"enabled": True}}, 6),
    "flops_profiler": ({"flops_profiler": {"enabled": True}}, 6),
    "optimizer_lamb": ({"optimizer": {"type": "Lamb", "params": {"lr": 1e-3}}}, 11),
}


@pytest.mark.parametrize("flag", sorted(TRAIN_OFF_SLICE))
def test_off_slice_training_config_raises(flag):
    extra, item = TRAIN_OFF_SLICE[flag]
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md, port queue item {item} "):
        deepspeed_tpu_torch.initialize(model=build_llama("debug", device="cpu"),
                                       config={**TRAIN_CONFIG, **extra}, device="cpu")


@pytest.mark.parametrize("overrides,item", [
    (dict(remat_policy="dots"), 10), (dict(sp_impl="ring"), 6), (dict(offload_params=True), 12)])
def test_off_slice_training_model_raises(overrides, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md, port queue item {item} "):
        build_llama("debug", device="cpu", **overrides)
    with pytest.raises(NotImplementedError, match="ROADMAP.md, port queue item 17 "):
        build_llama("mixtral-debug", device="cpu")


def test_checkpointing_raises():
    engine, *_ = deepspeed_tpu_torch.initialize(model=build_llama("debug", device="cpu"),
                                                config=TRAIN_CONFIG, device="cpu")
    for method in (engine.save_checkpoint, engine.load_checkpoint):
        with pytest.raises(NotImplementedError, match="ROADMAP.md, port queue item 8 "):
            method("ckpt")
