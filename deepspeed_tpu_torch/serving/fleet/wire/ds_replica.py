"""Fleet replica worker process: serve one ServingGateway over the wire
protocol (see ``deepspeed_tpu_torch/serving/fleet/wire/``). The port's
counterpart of the JAX package's ``bin/ds_replica``, with its argv
contract. Normally launched and supervised by ``FleetSupervisor``;
runnable by hand:

    python -m deepspeed_tpu_torch.serving.fleet.wire.ds_replica \\
        --config replica.json --bind 127.0.0.1:7431
    python -m deepspeed_tpu_torch.serving.fleet.wire.ds_replica \\
        --factory pkg.mod:fn --bind unix:/tmp/r0.sock

Two ways to build the replica:

- ``--config FILE``: JSON with optional keys ``preset`` (a
  ``models.llama_config`` preset, default "debug"), ``model``
  (``llama_config`` overrides), ``engine`` (RaggedInferenceEngineConfig
  fields; ``state_manager`` nests DSStateManagerConfig fields),
  ``serving`` (ServingConfig fields), ``device`` (default the GPU: the
  process raises without one) and ``dtype`` (default ``"bfloat16"``).
  The weights are drawn once, as ``InferenceEngineV2(params=None)``
  draws them (seed 0), by the first engine; every later engine (a
  ``restart`` op's rebuild) serves from that same tree, so a restart on
  the card places no second copy.
- ``--factory pkg.mod:fn``: import ``fn`` and call
  ``fn(name=..., role=...)`` for the Replica object — the fast path
  for tests (fake gateways, fault-injection wrappers).

The bound address is written atomically to ``--announce-file``
(ephemeral TCP ports become discoverable), liveness is beaten into
``--heartbeat-file`` for the supervisor's hang watchdog (the start line
names the frame format the codec writes: ``M``sgpack or ``J``SON), and
SIGTERM stops the server, then the replica shuts down. On a clean stop the
process prints one line, ``[ds_replica] <name> stopped {json}``: the
card, its engines' forwards, and the launches of K2's RMS forward, K3
and K4's ``dense_matmul`` in this process, K3's and K4's by design.
"""

import argparse
import importlib
import json
import os
import signal
import sys
import threading


def _build_from_config(cfg, name, role):
    """→ (a GatewayReplica over engines built from ``cfg``, the engines
    built so far, the device)."""
    from deepspeed_tpu_torch.device import resolve_device
    from deepspeed_tpu_torch.inference.v2 import (DSStateManagerConfig, InferenceEngineV2,
                                                  RaggedInferenceEngineConfig)
    from deepspeed_tpu_torch.models import llama_config
    from deepspeed_tpu_torch.serving import ServingConfig
    from deepspeed_tpu_torch.serving.fleet.replica import GatewayReplica
    from deepspeed_tpu_torch.serving.refresh.publisher import _TORCH_DTYPES

    model = llama_config(cfg.get("preset", "debug"), **cfg.get("model", {}))
    engine_kw = dict(cfg.get("engine", {}))
    sm_kw = engine_kw.pop("state_manager", None)
    if sm_kw is not None:
        engine_kw["state_manager"] = DSStateManagerConfig(**sm_kw)
    engine_cfg = RaggedInferenceEngineConfig(**engine_kw)
    device = resolve_device(cfg.get("device"))
    dtype_name = cfg.get("dtype", "bfloat16")
    dtype = _TORCH_DTYPES.get(dtype_name)
    if dtype is None or not dtype.is_floating_point:
        raise ValueError(f"replica config dtype {dtype_name!r} is not a floating dtype")
    built, shared = [], {}

    def factory():
        engine = InferenceEngineV2(model, engine_cfg, params=shared.get("params"),
                                   dtype=dtype, device=device)
        shared.setdefault("params", engine.params)
        built.append(engine)
        return engine

    scfg = ServingConfig(**cfg.get("serving", {}))
    return GatewayReplica(name, factory, serving_config=scfg, role=role), built, device


def _build_from_factory(spec, name, role):
    mod_name, _, fn_name = spec.partition(":")
    if not fn_name:
        raise SystemExit(f"--factory {spec!r}: expected pkg.mod:fn")
    fn = getattr(importlib.import_module(mod_name), fn_name)
    return fn(name=name, role=role)


def stop_report(name, role, engines, device):
    """The clean-stop line's record: the card, the engines' forwards and
    the serving kernels' launches in this process, by design."""
    from deepspeed_tpu_torch.ops.kernels.fused_norms import rms_norm_fwd
    from deepspeed_tpu_torch.ops.kernels.fused_quant_matmul import (dense_matmul,
                                                                    k4_design_launches)
    from deepspeed_tpu_torch.ops.kernels.paged_attention import (paged_decode_attention,
                                                                 paged_design_launches)
    card = None
    if device is not None and device.type == "cuda":
        from deepspeed_tpu_torch.device import gpu_report
        card = gpu_report()
    return {"name": name, "role": role, "card": card,
            "device": None if device is None else str(device),
            "engines": None if engines is None else len(engines),
            "forwards": None if engines is None else sum(e.forward_steps for e in engines),
            "launches": {"paged_decode_attention": paged_decode_attention.launches,
                         "dense_matmul": dense_matmul.launches,
                         "rms_norm_fwd": rms_norm_fwd.launches},
            "paged_by_design": dict(paged_design_launches),
            "dense_by_design": dict(k4_design_launches["dense"])}


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", help="JSON replica config file")
    p.add_argument("--factory",
                   help="pkg.mod:fn returning a Replica (test path)")
    p.add_argument("--name", default="replica")
    p.add_argument("--role", default="unified",
                   choices=["unified", "prefill", "decode"])
    p.add_argument("--bind", default=None,
                   help="host:port (0 = ephemeral) or unix:/path.sock; "
                        "default DS_WIRE_BIND or 127.0.0.1:0")
    p.add_argument("--heartbeat-file", default=None)
    p.add_argument("--announce-file", default=None,
                   help="write the bound address here once listening")
    args = p.parse_args(argv)

    if (args.config is None) == (args.factory is None):
        raise SystemExit("exactly one of --config/--factory required")

    engines = device = None
    if args.config is not None:
        with open(args.config) as fd:
            cfg = json.load(fd)
        replica, engines, device = _build_from_config(cfg, cfg.get("name", args.name),
                                                      args.role)
    else:
        replica = _build_from_factory(args.factory, args.name, args.role)

    from deepspeed_tpu_torch.serving.fleet.wire.server import ReplicaServer
    server = ReplicaServer(replica, bind=args.bind,
                           heartbeat_file=args.heartbeat_file)
    bound = server.start()
    if args.announce_file:
        tmp = args.announce_file + ".tmp"
        with open(tmp, "w") as fd:
            fd.write(bound + "\n")
        os.replace(tmp, args.announce_file)
    from deepspeed_tpu_torch.serving.fleet.wire.codec import frame_format
    print(f"[ds_replica] {args.name} ({args.role}) serving on {bound}, "
          f"{frame_format()} frames", flush=True)

    stop_once = threading.Event()

    def _on_term(signum, frame):
        if stop_once.is_set():
            return
        stop_once.set()
        # stop() is thread-safe; the shutdown below happens on the main
        # thread after serve_forever returns
        server.stop()

    signal.signal(signal.SIGTERM, _on_term)
    signal.signal(signal.SIGINT, _on_term)

    try:
        server.serve_forever()
    finally:
        try:
            replica.shutdown()
        except Exception:
            pass
    report = stop_report(args.name, args.role, engines, device)
    print(f"[ds_replica] {args.name} stopped {json.dumps(report)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
