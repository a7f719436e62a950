"""The LoRA adapter disk tier on the port against the JAX package's, on the
CPU.

- ``AdapterPublisher``: the same adapter publishes to the same manifest
  (tree spec, sha256, chain) on both packages, and each loads the other's
  publication with the same arrays.
- ``AdapterStore`` with a ``publish_root``: ``known`` sees a published-only
  adapter, a bind promotes it through the lazy adopt, ``adopt`` of a new
  version hot-swaps a hot slot in place, a rollback adopts the old one;
  after every step the two stores agree on slots, counters and slabs bit
  for bit (bf16 and fp32). Each store adopts the other package's
  publications.
- Torn, bit-flipped and forged adapter publications: rejected typed by
  both stores (``WeightPublicationError``), counted in
  ``publish_rejects``, nothing adopted (the slabs and the adopted version
  unchanged).
- The gateway over engines whose store has a ``publish_root``: adapters
  published to disk and adopted lazily at ``submit(adapter_id=...)``
  stream what the same adapters registered in memory stream, on the port
  and the JAX package alike; adopting v2 of one adapter changes its
  stream to the in-memory v2's.
- A hot swap adopted from a second thread while a forward is between its
  layers: that forward ends on the old version and the next one starts on
  the new, as the JAX store's rebinding gives.
"""

import dataclasses
import json
import os
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu import serving as jserving
from deepspeed_tpu.inference.v2 import (DSStateManagerConfig as JaxSM,
                                        InferenceEngineV2 as JaxEngine,
                                        RaggedInferenceEngineConfig as JaxCfg)
from deepspeed_tpu.inference.v2.config_v2 import LoRAServingConfig as JaxLoRA
from deepspeed_tpu.models import build_llama
from deepspeed_tpu.serving.lora import AdapterPublisher as JaxAdapterPublisher
from deepspeed_tpu.serving.lora import AdapterStore as JaxStore
from deepspeed_tpu.utils.sanitize import WeightPublicationError as JaxPublicationError
from deepspeed_tpu_torch import serving
from deepspeed_tpu_torch.inference.v2 import (DSStateManagerConfig, DynamicSplitFuseScheduler,
                                              InferenceEngineV2,
                                              LoRAServingConfig, RaggedInferenceEngineConfig)
from deepspeed_tpu_torch.models import LlamaConfig, params_from_jax
from deepspeed_tpu_torch.serving.lora import AdapterPublisher, AdapterStore
from deepspeed_tpu_torch.utils.sanitize import WeightPublicationError

from test_torch_lora_store import DIMS, DTYPES, L, assert_same, mk_layers

torch.set_num_threads(1)  # the suite runs in parallel worker processes


def disk_stores(root, dtype="fp32", **kw):
    """A JAX and a port store over one publish root (each publishes into
    it; either reads the other's publications)."""
    kw.setdefault("n_hot", 2)
    kw.setdefault("max_rank", 4)
    kw.setdefault("prefetch", False)
    jd, td = DTYPES[dtype]
    return (JaxStore(DIMS, L, dtype=jd, publish_root=str(root), **kw),
            AdapterStore(DIMS, L, dtype=td, device="cpu", publish_root=str(root), **kw))


def test_adapter_publications_are_the_jax_format(tmp_path):
    layers = mk_layers(5, 3)
    jm = JaxAdapterPublisher(tmp_path / "jax").publish(11, layers, 6.0)
    tm = AdapterPublisher(tmp_path / "port").publish(11, layers, 6.0)
    assert tm == jm
    for src, dst in (("jax", AdapterPublisher), ("port", JaxAdapterPublisher)):
        alpha, rank, got, m = dst(tmp_path / src).load(11)
        assert (alpha, rank, m) == (6.0, 3, jm)
        for site, (a, b) in layers.items():
            np.testing.assert_array_equal(np.asarray(got[site][0]), a)
            np.testing.assert_array_equal(np.asarray(got[site][1]), b)
    assert AdapterPublisher(tmp_path / "jax").published_adapters() == [11]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_lazy_adopt_hot_swap_and_rollback_match_jax(tmp_path, dtype):
    js, ts = disk_stores(tmp_path, dtype)
    js.publish(11, mk_layers(1, 4), alpha=8.0)   # JAX publishes v1 of 11
    ts.publish(12, mk_layers(2, 2), alpha=4.0)   # the port publishes v1 of 12
    for st in (js, ts):
        assert st.known(11) and st.known(12) and not st.known(13)
        assert not st.has_adapter(11)
    assert ts.bind(1, 11) == js.bind(1, 11)      # lazy adopt at promotion
    assert ts.bind(2, 12) == js.bind(2, 12)
    assert_same(js, ts, (1, 2))
    assert ts.version_of(11) == js.version_of(11) == 1
    js.publish(11, mk_layers(3, 4), alpha=8.0)   # v2 of a hot adapter
    assert ts.adopt(11) == js.adopt(11) == 2     # hot-swapped in place
    assert_same(js, ts, (1, 2))
    assert ts.stats()["swaps"] == 1
    assert ts.adopt(11, version=1) == js.adopt(11, version=1) == 1  # rollback
    assert_same(js, ts, (1, 2))


@pytest.mark.parametrize("fault", ["torn", "bitflip", "forged"])
def test_broken_adapter_publications_rejected_typed(tmp_path, fault):
    def hook(point, detail=None):
        if fault == "torn" and point == "before_manifest" and detail == 2:
            raise RuntimeError("injected crash")

    js, ts = disk_stores(tmp_path, test_hook=hook)
    ts.publish(11, mk_layers(1, 4), alpha=8.0)
    for st in (js, ts):
        st.bind(1, 11)
    if fault == "torn":
        with pytest.raises(RuntimeError, match="injected crash"):
            ts.publish(11, mk_layers(2, 4), alpha=8.0)
    else:
        ts.publish(11, mk_layers(2, 4), alpha=8.0)
        pub_dir = os.path.join(str(tmp_path), "adapter_000011", "v00000002")
        if fault == "bitflip":
            path = os.path.join(pub_dir, "payload.bin")
            with open(path, "r+b") as fd:
                fd.seek(100)
                byte = fd.read(1)
                fd.seek(100)
                fd.write(bytes([byte[0] ^ 0x10]))
        else:
            path = os.path.join(pub_dir, "weight_manifest.json")
            with open(path) as fd:
                manifest = json.load(fd)
            manifest["files"]["payload.bin"]["sha256"] = "0" * 64
            with open(path, "w") as fd:
                json.dump(manifest, fd)
    for st, err in ((js, JaxPublicationError), (ts, WeightPublicationError)):
        with pytest.raises(err):
            st.adopt(11, version=2)
        assert st.stats()["publish_rejects"] == 1
        assert st.version_of(11) == 1  # nothing adopted
    assert_same(js, ts, (1,))


# ---------------------------------------------------------------------- the gateway, real engines
@pytest.fixture(scope="module")
def debug():
    model = build_llama("debug", remat=False)
    params = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0),
                                                 jnp.zeros((1, 8), jnp.int32))["params"])
    return model, params, params_from_jax(params)


SM = dict(max_ragged_batch_size=64, max_ragged_sequence_count=4, max_tracked_sequences=6,
          max_context=64)


def lora_config(root):
    return dict(enabled=True, hot_set=2, max_rank=8, prefetch=False,
                publish_root=str(root) if root else "")


def port_lora_engine(debug, root):
    """A port engine whose store has ``publish_root`` ``root`` (None: no
    disk tier)."""
    model, _, port_params = debug
    return InferenceEngineV2(LlamaConfig(**dataclasses.asdict(model.config)),
                             RaggedInferenceEngineConfig(
                                 kv_block_size=8, state_manager=DSStateManagerConfig(**SM),
                                 lora=LoRAServingConfig(**lora_config(root))),
                             params=port_params, dtype=torch.float32, device="cpu")


def lora_engines(debug, root):
    """A JAX and a port engine whose stores have ``publish_root`` ``root``
    (None: no disk tier)."""
    model, params, _ = debug
    jeng = JaxEngine(model=model, config=JaxCfg(kv_block_size=8, state_manager=JaxSM(**SM),
                                                lora=JaxLoRA(**lora_config(root))),
                     params=params, dtype=jnp.float32)
    return jeng, port_lora_engine(debug, root)


def adapter(store, seed, scale=0.08):
    rs = np.random.RandomState(seed)
    return {s: (rs.randn(store.num_layers, din, 8).astype(np.float32) * scale,
                rs.randn(store.num_layers, 8, dout).astype(np.float32) * scale)
            for s, (din, dout) in store.dims.items()}


def serve(gws, prompts, adapters):
    """Each (prompt, adapter) through each gateway (manual pump) → streams."""
    out = []
    for gw in gws:
        hs = [gw.submit(p, max_new_tokens=8, adapter_id=a) for p, a in zip(prompts, adapters)]
        while not all(h.done for h in hs):
            gw._pump_once()
        out.append([h.result(timeout=1) for h in hs])
    return out


def test_gateway_serves_disk_adapters_as_in_memory_ones(debug, tmp_path):
    disk = lora_engines(debug, tmp_path)
    _, mem = lora_engines(debug, None)
    st = disk[1].lora_store
    layers = {11: adapter(st, 1), 12: adapter(st, 2), 13: adapter(st, 3)}
    st.publish(11, layers[11], alpha=16.0)
    disk[0].lora_store.publish(12, layers[12], alpha=16.0)  # the JAX package publishes one
    mem.register_adapter(11, layers[11], alpha=16.0)
    mem.register_adapter(12, layers[12], alpha=16.0)
    gws = [jserving.ServingGateway(disk[0], config=jserving.ServingConfig(max_burst=4),
                                   auto_start=False)]
    gws += [serving.ServingGateway(e, config=serving.ServingConfig(max_burst=4),
                                   auto_start=False) for e in (disk[1], mem)]
    prompts = [(np.arange(9) * 7 + 3) % 200, (np.arange(6) * 5 + 1) % 200,
               (np.arange(9) * 7 + 3) % 200]
    j, t, m = serve(gws, prompts, [11, 12, None])
    assert t == j == m
    assert t[0] != t[2]  # the adapter moves the stream
    assert disk[1].lora_store.stats()["promotions"] == 2
    # v2 of adapter 11 adopted on the disk engines; in memory, registered
    st.publish(11, layers[13], alpha=16.0)
    for e in disk:
        assert e.adopt_adapter(11) == 2
    mem.lora_store.invalidate()  # a registration installs the host tier only
    mem.register_adapter(11, layers[13], alpha=16.0, version=2)
    j2, t2, m2 = serve(gws, prompts[:1], [11])
    assert t2 == j2 == m2 and t2[0] != t[0]
    with pytest.raises(serving.ServingError, match="not registered"):
        gws[1].submit(prompts[0], adapter_id=99)
    for gw in gws:
        gw.drain(timeout=10)


def test_hot_swap_from_another_thread_lands_between_forwards(debug, tmp_path, monkeypatch):
    """``adopt_adapter`` of a HOT adapter, called from a second thread while
    the serving thread's forward is between its layers (the thread is
    started from that forward's second layer and joined there): the
    forward ends on v1 in every layer and v2 takes over at the next
    ``slabs()``. The streams equal a run whose swap landed just before
    that ``slabs()``, and differ from the all-v1 and all-v2 runs."""
    from deepspeed_tpu_torch.inference.v2 import model_runner
    rs = np.random.RandomState(5)
    prompts = [rs.randint(0, 200, n).astype(np.int32) for n in (9, 14, 6)]
    ids = [11, 11, None]
    SWAP_AT = 3  # v2 from the third slabs() on: after the prefill and one burst
    real_delta = model_runner.lora_delta

    def run(tag, swap=None):
        """→ streams; ``swap``: None (all v1), "v2" (all v2), "between"
        (adopted just before the SWAP_AT-th slabs()), "mid" (adopted on a
        second thread from inside the forward before it)."""
        engine = port_lora_engine(debug, tmp_path / tag)
        store = engine.lora_store
        v1, v2 = adapter(store, 1), adapter(store, 3)
        store.publish(11, v1, alpha=16.0)
        store.publish(11, v2, alpha=16.0)
        engine.adopt_adapter(11, version=2 if swap == "v2" else 1)
        taken, deltas = [0], [0]
        real_slabs = store.slabs

        def slabs():
            taken[0] += 1
            deltas[0] = 0
            if swap == "between" and taken[0] == SWAP_AT:
                engine.adopt_adapter(11, version=2)
            return real_slabs()

        def delta(*args, **kw):
            deltas[0] += 1
            # the first site of layer 1, inside the forward before the swap
            if swap == "mid" and taken[0] == SWAP_AT - 1 and deltas[0] == len(store.sites) + 1:
                t = threading.Thread(target=engine.adopt_adapter, args=(11, 2))
                t.start()
                t.join(timeout=60)
                assert store.version_of(11) == 2
            return real_delta(*args, **kw)
        monkeypatch.setattr(store, "slabs", slabs)
        monkeypatch.setattr(model_runner, "lora_delta", delta)
        sched = DynamicSplitFuseScheduler(engine, token_budget=64, max_burst=4)
        for i, (p, a) in enumerate(zip(prompts, ids)):
            sched.add_request(i, p, max_new_tokens=12, adapter_id=a)
        out = sched.run_to_completion()
        assert taken[0] > SWAP_AT
        if swap in ("between", "mid"):
            assert store.stats()["swaps"] == 1
        return [out[i] for i in range(len(prompts))]

    all_v1, all_v2 = run("v1"), run("v2", "v2")
    between, mid = run("between", "between"), run("mid", "mid")
    assert mid == between
    assert mid[:2] != all_v1[:2] and mid[:2] != all_v2[:2]
    assert mid[2] == all_v1[2] == all_v2[2]  # the base request reads slot 0
