"""The PyTorch port stands alone.

- No file of ``deepspeed_tpu_torch`` (nor ``chip_smoke.py``) imports jax,
  flax, pydantic or the JAX package (AST scan).
- Every port module imports in a fresh interpreter where ``jax`` cannot
  be imported at all.
- Entry points given no device run on the GPU: on a machine without one
  they raise instead of quietly running on the CPU.
- Each config switch of a feature the port does not serve or train yet
  raises ``NotImplementedError`` at engine (or model) construction, naming
  its ROADMAP item; so do the training engine's checkpoint methods. The
  prefix cache, the KV spill tier, speculative decoding, constrained
  decoding, pipelined decode bursts and the LoRA disk tier are ported:
  their configs build an engine that serves. MoE
  models serve and train, dropless or capacity-routed. On-device sampling
  is ported: an invalid spec raises ``ValueError`` at the engine and the
  scheduler."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2, DynamicSplitFuseScheduler,
                                              RaggedInferenceEngineConfig)
import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import build_bert, build_llama, init_params, llama_config
from deepspeed_tpu_torch.models.llama import init_quantized_params

torch.set_num_threads(1)  # the suite runs in parallel worker processes

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


SLICE5_MODULES = ("deepspeed_tpu_torch.ops.kernels.quantization",
                  "deepspeed_tpu_torch.utils.sanitize",
                  "deepspeed_tpu_torch.inference.v2.prefix_cache",
                  "deepspeed_tpu_torch.inference.v2.prefix_cache.radix_index",
                  "deepspeed_tpu_torch.inference.v2.prefix_cache.manager",
                  "deepspeed_tpu_torch.inference.v2.kv_tier",
                  "deepspeed_tpu_torch.inference.v2.kv_tier.quant",
                  "deepspeed_tpu_torch.inference.v2.kv_tier.host_store",
                  "deepspeed_tpu_torch.inference.v2.kv_tier.tier_manager")


def test_scans_cover_the_kv_tier_slice():
    """The AST scan and the jax-free import above reach the prefix cache,
    the spill tier and kernel K7's wrapper and source."""
    assert set(SLICE5_MODULES) <= set(_modules())
    from deepspeed_tpu_torch.ops.kernels import build
    assert "quantization.cu" in build.SOURCES


SLICE6_MODULES = ("deepspeed_tpu_torch.moe", "deepspeed_tpu_torch.moe.sharded_moe",
                  "deepspeed_tpu_torch.moe.layer")


def test_scans_cover_the_moe_training_slice():
    """The AST scan and the jax-free import above reach the MoE package,
    and kernel K5's source carries its backward entries."""
    assert set(SLICE6_MODULES) <= set(_modules())
    assert {PKG / "moe" / "sharded_moe.py", PKG / "moe" / "layer.py"} <= set(_port_files())
    from deepspeed_tpu_torch.ops.kernels import build
    src = (build.CSRC / "grouped_matmul.cu").read_text()
    assert "ds_gmm_dw" in src and "ds_gmm_dx" in src


SLICE7_MODULES = ("deepspeed_tpu_torch.models.bert",
                  "deepspeed_tpu_torch.ops.kernels.block_sparse_attention",
                  "deepspeed_tpu_torch.ops.sparse_attention",
                  "deepspeed_tpu_torch.ops.sparse_attention.sparsity_config",
                  "deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention",
                  "deepspeed_tpu_torch.ops.sparse_attention.sparse_attention_utils")


def test_scans_cover_the_bert_sparse_slice():
    """The AST scan and the jax-free import above reach BERT, the sparse
    attention package and kernel K8's wrapper; K8's source is built, and
    K2's source carries the LayerNorm entry."""
    assert set(SLICE7_MODULES) <= set(_modules())
    from deepspeed_tpu_torch.ops.kernels import build
    assert "block_sparse_attention.cu" in build.SOURCES
    src = (build.CSRC / "block_sparse_attention.cu").read_text()
    assert all(f"ds_bsa_{k}_bf16" in src for k in ("fwd", "dq", "dkv"))
    assert "ds_layer_norm_fwd" in (build.CSRC / "fused_norms.cu").read_text()


SLICE17_MODULES = ("deepspeed_tpu_torch.inference.sampling",
                   "deepspeed_tpu_torch.inference.structured",
                   "deepspeed_tpu_torch.inference.structured.prng",
                   "deepspeed_tpu_torch.inference.structured.sampling")


def test_scans_cover_the_sampling_slice():
    """The AST scan and the jax-free import above reach the sampling
    modules; the structured package exports what the JAX package's does."""
    assert set(SLICE17_MODULES) <= set(_modules())
    from deepspeed_tpu_torch.inference import structured
    assert structured.__all__ == [
        "CompiledSchema", "SchemaCompileError", "SchemaCompilerCache", "StructuredStore",
        "byte_vocab", "constrained_enabled", "derive_seed", "detokenize", "schema_cache"]
    assert all(hasattr(structured, name) for name in structured.__all__)


SLICE18_MODULES = ("deepspeed_tpu_torch.utils.env_registry",
                   "deepspeed_tpu_torch.inference.v2.spec",
                   "deepspeed_tpu_torch.inference.v2.spec.drafter",
                   "deepspeed_tpu_torch.inference.v2.spec.state",
                   "deepspeed_tpu_torch.inference.structured.grammar",
                   "deepspeed_tpu_torch.inference.structured.store")


def test_scans_cover_the_spec_and_structured_slice():
    """The AST scan and the jax-free import above reach the speculative
    and constrained decoding modules; the spec package exports what the
    JAX package's does, and the switches read registered knobs of their
    own kinds."""
    assert set(SLICE18_MODULES) <= set(_modules())
    from deepspeed_tpu_torch.inference.v2 import spec
    from deepspeed_tpu_torch.utils import env_registry
    assert spec.__all__ == ["NGramDrafter", "SpecDecodeState", "spec_decode_enabled"]
    kinds = {k: env_registry.get_knob(k).kind
             for k in ("DS_CONSTRAINED", "DS_SPEC_DECODE", "DS_SPEC_DRAFT_LEN")}
    assert kinds == {"DS_CONSTRAINED": "optional_bool", "DS_SPEC_DECODE": "optional_bool",
                     "DS_SPEC_DRAFT_LEN": "int"}
    with pytest.raises(KeyError, match="not registered"):
        env_registry.env_int("DS_SPEC_DRAFT")


SLICE19_MODULES = ("deepspeed_tpu_torch.utils.env_registry", "deepspeed_tpu_torch.utils.sanitize",
                   "deepspeed_tpu_torch.inference.v2.engine_v2",
                   "deepspeed_tpu_torch.inference.v2.scheduler")


def test_scans_cover_the_async_and_sanitize_slice():
    """The AST scan and the jax-free import above reach the registry, the
    sanitizer and the pipelined engine; the old partial copy of the
    registry is gone, and the sanitizer's gate and lock tracker exist."""
    assert set(SLICE19_MODULES) <= set(_modules())
    assert "deepspeed_tpu_torch.utils.env" not in _modules()
    from deepspeed_tpu_torch.inference.v2.engine_v2 import AsyncBurstHandle, InferenceEngineV2
    from deepspeed_tpu_torch.utils import sanitize
    assert callable(InferenceEngineV2.decode_burst_async) and AsyncBurstHandle.fetch
    assert all(callable(getattr(sanitize, n)) for n in ("maybe_checkify", "tracked_lock",
                                                         "check_allocator", "sanitize_enabled"))


SLICE20_MODULES = ("deepspeed_tpu_torch.serving", "deepspeed_tpu_torch.serving.admission",
                   "deepspeed_tpu_torch.serving.config", "deepspeed_tpu_torch.serving.metrics",
                   "deepspeed_tpu_torch.serving.gateway", "deepspeed_tpu_torch.serving.refresh",
                   "deepspeed_tpu_torch.serving.refresh.publisher",
                   "deepspeed_tpu_torch.serving.lora.publisher",
                   "deepspeed_tpu_torch.serving.lora.store", "deepspeed_tpu_torch.nebula",
                   "deepspeed_tpu_torch.nebula.service",
                   "deepspeed_tpu_torch.runtime.checkpoint_engine",
                   "deepspeed_tpu_torch.runtime.checkpoint_engine.sharded_checkpoint_engine")


def test_scans_cover_the_serving_and_refresh_slice():
    """The AST scan and the jax-free import above reach every module under
    ``serving/``, ``nebula/`` and ``runtime/checkpoint_engine/`` (the
    gateway, admission, config, metrics, the publishers and the helpers
    they copy), none of which imports ml_dtypes either; the engine swaps
    weights and the gateway stages a refresh."""
    mods = set(_modules())
    assert set(SLICE20_MODULES) <= mods
    for sub in ("serving", "nebula", "runtime/checkpoint_engine"):
        files = sorted((PKG / sub).rglob("*.py"))
        assert files and set(files) <= set(_port_files())
        for path in files:
            tree = ast.parse(path.read_text())
            names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
            names += [n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
            assert not any(m.split(".")[0] == "ml_dtypes" for m in names), path
    from deepspeed_tpu_torch.serving import ServingGateway, WeightPublisher
    assert callable(InferenceEngineV2.swap_params) and callable(ServingGateway.refresh_weights)
    assert callable(WeightPublisher.publish) and callable(WeightPublisher.load)


SLICE21_MODULES = ("deepspeed_tpu_torch.serving.fleet", "deepspeed_tpu_torch.serving.fleet.config",
                   "deepspeed_tpu_torch.serving.fleet.health",
                   "deepspeed_tpu_torch.serving.fleet.handoff",
                   "deepspeed_tpu_torch.serving.fleet.replica",
                   "deepspeed_tpu_torch.serving.fleet.router",
                   "deepspeed_tpu_torch.serving.refresh.controller")


def test_scans_cover_the_fleet_slice():
    """The AST scan and the jax-free import above reach every module of
    ``serving/fleet/`` and the refresh controller; what the router and the
    controller export is the JAX package's list (the wire, in its own
    package, has a test of its own below)."""
    assert set(SLICE21_MODULES) <= set(_modules())
    files = sorted((PKG / "serving" / "fleet").glob("*.py"))
    assert {p.stem for p in files} == {"__init__", "config", "health", "handoff", "replica",
                                       "router"}
    assert set(files) | {PKG / "serving" / "refresh" / "controller.py"} <= set(_port_files())
    from deepspeed_tpu_torch.serving import fleet, refresh
    assert fleet.__all__ and all(callable(getattr(fleet, n)) or isinstance(getattr(fleet, n), str)
                                 for n in fleet.__all__)
    assert {"FleetRefreshController", "WeightRefreshError", "CanaryDivergenceError",
            "WeightPublisher"} == set(refresh.__all__)
    assert callable(fleet.FleetRouter.rolling_restart)
    assert callable(refresh.FleetRefreshController.rollout)


FORBIDDEN_WIRE = FORBIDDEN | {"ml_dtypes"}
SLICE22_MODULES = ("deepspeed_tpu_torch.utils.proc", "deepspeed_tpu_torch.serving.fleet.wire",
                   "deepspeed_tpu_torch.serving.fleet.wire.address",
                   "deepspeed_tpu_torch.serving.fleet.wire.client",
                   "deepspeed_tpu_torch.serving.fleet.wire.codec",
                   "deepspeed_tpu_torch.serving.fleet.wire.ds_replica",
                   "deepspeed_tpu_torch.serving.fleet.wire.errors",
                   "deepspeed_tpu_torch.serving.fleet.wire.server",
                   "deepspeed_tpu_torch.serving.fleet.wire.supervisor")


def test_scans_cover_the_wire_slice():
    """The AST scan and the jax-free import above reach every module of
    ``serving/fleet/wire/`` (the replica entry point among them) and
    ``utils/proc.py``, none of which imports ml_dtypes either; the wire
    package exports the JAX package's list, and the sanitizer carries the
    wire checks."""
    assert set(SLICE22_MODULES) <= set(_modules())
    files = sorted((PKG / "serving" / "fleet" / "wire").glob("*.py"))
    assert {p.stem for p in files} == {"__init__", "address", "client", "codec", "ds_replica",
                                       "errors", "server", "supervisor"}
    files.append(PKG / "utils" / "proc.py")
    assert set(files) <= set(_port_files())
    for path in files:
        tree = ast.parse(path.read_text())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        names += [n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
        assert not any(m.split(".")[0] in FORBIDDEN_WIRE for m in names), path
    from deepspeed_tpu_torch.serving.fleet import wire
    from deepspeed_tpu_torch.utils import sanitize
    assert wire.__all__ == ["FleetSupervisor", "PublicationRef", "ReplicaProcSpec",
                            "ReplicaServer", "WireProtocolError", "WireReplica",
                            "WireTimeoutError", "make_replica", "transport_mode"]
    assert all(callable(getattr(sanitize, n)) for n in ("wire_structural_equal",
                                                         "checked_frame_encoder",
                                                         "check_error_registry"))
    assert issubclass(sanitize.WireFrameCorruptionError, sanitize.SanitizerError)
    assert issubclass(sanitize.WireRegistryError, sanitize.SanitizerError)


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
        build_bert("bert-debug")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        deepspeed_tpu_torch.initialize(model=build_llama("debug", device="cpu"),
                                       config=TRAIN_CONFIG)


OFF_SLICE = {
    "tensor_parallel_degree": dict(tensor_parallel_degree=2),
    "expert_parallel_degree": dict(expert_parallel_degree=2),
}


@pytest.mark.parametrize("flag", sorted(OFF_SLICE))
def test_off_slice_feature_raises(flag):
    cfg = RaggedInferenceEngineConfig(**OFF_SLICE[flag])
    with pytest.raises(NotImplementedError, match=f"{flag}.*ROADMAP.md, port queue item"):
        InferenceEngineV2("debug", cfg, dtype=torch.float32, device="cpu")


ON_SLICE = {  # flag: (config, the engine's attribute, prompt tokens the second request reuses)
    "prefix_cache": (dict(prefix_cache={"enabled": True}), "prefix_cache", 8),
    "kv_tier": (dict(prefix_cache={"enabled": True},
                     kv_tier={"enabled": True, "quantize": True}), "kv_tier", 8),
    "spec_decode": (dict(spec_decode={"enabled": True}), "spec", 0),
    "structured": (dict(structured={"enabled": True}), "structured", 0),
    "async_burst": (dict(async_burst={"enabled": True}), "async_burst", 0),
    "lora": (dict(lora={"enabled": True, "publish_root": "adapters"}), "lora_store", 0),
}
# the engine at small state-manager sizes: the plain paged attention
# gathers every token's whole table, which the defaults make 8192 long
SMALL = dict(max_ragged_batch_size=64, max_ragged_sequence_count=4, max_tracked_sequences=4,
             max_context=128)


@pytest.mark.parametrize("flag", sorted(ON_SLICE))
def test_ported_feature_builds_and_serves(flag, tmp_path):
    config, attr, cached = ON_SLICE[flag]
    if "lora" in config:  # the disk tier's publish root, under the test's directory
        config = {"lora": dict(config["lora"], publish_root=str(tmp_path / "adapters"))}
    cfg = RaggedInferenceEngineConfig(kv_block_size=4, state_manager=SMALL, **config)
    eng = InferenceEngineV2("debug", cfg, dtype=torch.float32, device="cpu")
    assert getattr(eng, attr) not in (None, False)
    sched = DynamicSplitFuseScheduler(eng)
    for uid in (1, 2):  # with a prefix cache, the second request finds the first one's prompt
        sched.add_request(uid, list(range(3, 14)), max_new_tokens=3)
        out = sched.run_to_completion()
    assert out[1] == out[2] and len(out[1]) == 3
    assert sched.requests[2].prefix_cached_tokens == cached
    eng.destroy()


def test_off_slice_model_and_sampling_raise():
    """Sampling is ported: an invalid spec raises ``ValueError`` at the
    engine and the scheduler, as the JAX validator does."""
    eng = InferenceEngineV2("debug", dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="temperature must be > 0"):
        eng.put([1], [[1, 2, 3]], sample={"temperature": 0.0})
    with pytest.raises(ValueError, match="unknown sampling keys"):
        DynamicSplitFuseScheduler(eng, sampling={"temp": 0.7})
    sched = DynamicSplitFuseScheduler(eng)
    with pytest.raises(ValueError, match="top_p must be in"):
        sched.add_request(1, [1, 2], sample={"top_p": 1.5})
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


@pytest.mark.parametrize("drop_tokens", [False, True], ids=["dropless", "capacity"])
def test_moe_model_trains_one_step_through_initialize(drop_tokens):
    """An MoE model builds and takes one ``train_batch`` on the CPU: a
    finite loss, every parameter updated, the gate's router among them."""
    model = build_llama("mixtral-debug", device="cpu", moe_drop_tokens=drop_tokens,
                        remat_policy="moe")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    cfg = {"train_batch_size": 4, "train_micro_batch_size_per_gpu": 2,
           "gradient_accumulation_steps": 2, "optimizer": {"type": "Adam",
                                                           "params": {"lr": 1e-3}}}
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=cfg, device="cpu")
    ids = torch.randint(0, 256, (4, 16), generator=torch.Generator().manual_seed(0))
    loss = engine.train_batch(batch=(ids, ids))
    assert torch.isfinite(loss) and engine.global_steps == 1
    moved = [n for n, p in model.named_parameters() if not torch.equal(p, before[n])]
    assert len(moved) == len(before), sorted(set(before) - set(moved))
    assert any("deepspeed_moe.gate.wg.kernel" in n for n in moved)


def test_checkpointing_raises():
    engine, *_ = deepspeed_tpu_torch.initialize(model=build_llama("debug", device="cpu"),
                                                config=TRAIN_CONFIG, device="cpu")
    for method in (engine.save_checkpoint, engine.load_checkpoint):
        with pytest.raises(NotImplementedError, match="ROADMAP.md, port queue item 8 "):
            method("ckpt")
