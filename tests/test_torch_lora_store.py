"""The port's ``AdapterStore`` vs the JAX package's, on the CPU.

The same register / bind / release / evict / promote sequence runs on both
stores, in fp32 and in bf16. After every step the two must agree on the
slot each bind returns, the counters (``stats()``), ``signature()``, the
hot set, each uid's slot, and the slabs and scales bit for bit: rank
padding is exact zeros on both sides and the cast to bf16 rounds half to
even on both (numpy's ``astype`` of ml_dtypes, torch's ``.to``).

Also: ``AdapterCapacityError`` with the JAX store's ``details``; unknown,
over-rank, wrong-site and wrong-shape adapters rejected; ``invalidate``;
a prefetch followed by a bind counts a ``stage_hit`` and writes the same
rows; ``publish_root``, ``publish`` and ``adopt`` raise naming ROADMAP.md
port queue item 4; and a time-bounded stress of prefetch kicks from
several threads against binds and releases on the caller's thread keeps
every lease count exact.
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepspeed_tpu.serving.lora import AdapterCapacityError as JaxCapacityError
from deepspeed_tpu.serving.lora import AdapterStore as JaxStore
from deepspeed_tpu.serving.lora import UnknownAdapterError as JaxUnknownError
from deepspeed_tpu_torch.serving.lora import (AdapterCapacityError, AdapterStore,
                                              UnknownAdapterError)

DIMS = {"q_proj": (8, 12), "k_proj": (8, 4), "v_proj": (8, 4), "o_proj": (12, 8)}
L = 2
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def mk_layers(seed, r, sites=DIMS):
    rs = np.random.RandomState(seed)
    return {s: (rs.randn(L, DIMS[s][0], r).astype(np.float32),
                rs.randn(L, r, DIMS[s][1]).astype(np.float32)) for s in sites}


def stores(dtype="fp32", **kw):
    kw.setdefault("n_hot", 2)
    kw.setdefault("max_rank", 4)
    kw.setdefault("prefetch", False)
    jd, td = DTYPES[dtype]
    return JaxStore(DIMS, L, dtype=jd, **kw), AdapterStore(DIMS, L, dtype=td, device="cpu", **kw)


def _bits(x):
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.itemsize == 2 else x.view(np.uint32)


def assert_same(js, ts, uids=()):
    assert ts.stats() == js.stats()
    assert ts.signature() == js.signature()
    assert ts.hot_set() == js.hot_set()
    for uid in uids:
        assert ts.slot_of(uid) == js.slot_of(uid)
    ja, jb, jsc = js.slabs()
    ta, tb, tsc = ts.slabs()
    assert sorted(ta) == sorted(ja)
    for site in ta:
        t_a = ta[site].view(torch.int16 if ta[site].dtype == torch.bfloat16 else torch.int32)
        t_b = tb[site].view(torch.int16 if tb[site].dtype == torch.bfloat16 else torch.int32)
        np.testing.assert_array_equal(t_a.numpy().view(_bits(ja[site]).dtype), _bits(ja[site]))
        np.testing.assert_array_equal(t_b.numpy().view(_bits(jb[site]).dtype), _bits(jb[site]))
    np.testing.assert_array_equal(tsc.numpy().view(np.uint32), _bits(jsc))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_lease_evict_promote_sequence_matches_jax(dtype):
    js, ts = stores(dtype)
    uids = (1, 2, 3, 4, 5)
    steps = [
        ("register", 11, mk_layers(1, 4), 8.0),
        ("register", 12, mk_layers(2, 2, ("q_proj", "v_proj")), 4.0),  # rank 2, two sites
        ("register", 13, mk_layers(3, 3), 6.0),
        ("bind", 1, 11), ("bind", 2, 12), ("bind", 3, 11),   # hit
        ("bind", 1, 11),                                     # idempotent re-bind
        ("release", 2),                                      # 12's slot unleased
        ("bind", 4, 13),                                     # evicts 12 (LRU, unleased)
        ("release", 1), ("release", 3),
        ("bind", 5, 12),                                     # evicts 11, promotes 12 again
        ("bind", 2, 0),                                      # base: slot 0, no lease
        ("release", 5),
        ("bind", 4, 11),                                     # uid 4's lease moves slots
    ]
    for step in steps:
        outs = []
        for st in (js, ts):
            if step[0] == "register":
                outs.append(st.register(step[1], step[2], alpha=step[3]))
            elif step[0] == "bind":
                outs.append(st.bind(step[1], step[2]))
            else:
                outs.append(st.release(step[1]))
        assert outs[1] == outs[0], step
        assert_same(js, ts, uids)
    assert ts.version_of(11) == js.version_of(11) == 0
    assert ts.known(13) and not ts.known(99) and ts.has_adapter(13) and not ts.has_adapter(12)


def test_capacity_error_carries_the_same_details():
    js, ts = stores()
    for st in (js, ts):
        for aid in (11, 12, 13):
            st.register(aid, mk_layers(aid, 2), alpha=4.0)
        st.bind(1, 11)
        st.bind(2, 12)
    with pytest.raises(JaxCapacityError) as jerr:
        js.bind(3, 13)
    with pytest.raises(AdapterCapacityError) as terr:
        ts.bind(3, 13)
    assert terr.value.details == jerr.value.details == {
        "adapter_id": 13, "hot_slots": 2, "leased_slots": 2}
    assert (terr.value.reason, terr.value.retry_elsewhere) == ("adapter_capacity", True)
    assert_same(js, ts, (1, 2, 3))


def test_bad_adapters_rejected():
    js, ts = stores()
    with pytest.raises(JaxUnknownError):
        js.bind(1, 77)
    with pytest.raises(UnknownAdapterError) as err:
        ts.bind(1, 77)
    assert err.value.details == {"adapter_id": 77}
    bad = [(11, mk_layers(1, 5)),                                    # over the rank bucket
           (0, mk_layers(1, 2)),                                     # 0 is the base slot
           (11, {"w_up": mk_layers(1, 2)["q_proj"]}),               # not a served site
           (11, {"q_proj": (np.zeros((L, 9, 2)), np.zeros((L, 2, 12)))}),  # wrong in-dim
           (11, {}),
           (11, {"q_proj": mk_layers(1, 2)["q_proj"], "k_proj": mk_layers(1, 3)["k_proj"]})]
    for aid, layers in bad:
        for st in (js, ts):
            with pytest.raises(ValueError):
                st.register(aid, layers, alpha=1.0)
    assert ts.stats() == js.stats()


def test_invalidate_drops_hot_slots_and_leases():
    js, ts = stores("bf16")
    for st in (js, ts):
        st.register(11, mk_layers(1, 4), alpha=8.0)
        st.bind(1, 11)
        st.invalidate()
    assert_same(js, ts, (1,))
    assert ts.hot_set() == [] and ts.slot_of(1) == 0 and not ts.slabs()[2].any()
    assert ts.bind(2, 11) == js.bind(2, 11)  # host payload kept: re-promotes
    assert_same(js, ts, (1, 2))


def _wait_staged(st, n, timeout=10.0):
    t0 = time.monotonic()
    while st.stats()["prefetched"] < n:
        assert time.monotonic() - t0 < timeout, "prefetch worker did not stage in time"
        time.sleep(0.01)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_prefetch_then_bind_counts_a_stage_hit(dtype):
    js, ts = stores(dtype, prefetch=True)
    try:
        for st in (js, ts):
            st.register(11, mk_layers(1, 3), alpha=6.0)
            st.prefetch(11)
            _wait_staged(st, 1)
            assert st.bind(1, 11) == 1
        assert ts.stats()["stage_hits"] == 1
        assert_same(js, ts, (1,))
    finally:
        js.shutdown()
        ts.shutdown()
    assert ts._worker is None or not ts._worker.is_alive()


def test_disk_tier_raises_naming_its_item():
    with pytest.raises(NotImplementedError, match="ROADMAP.md, port queue item 4 "):
        AdapterStore(DIMS, L, publish_root="adapters", device="cpu")
    _, ts = stores()
    for call in (lambda: ts.publish(11, mk_layers(1, 2), 4.0), lambda: ts.adopt(11)):
        with pytest.raises(NotImplementedError, match="disk tier.*port queue item 4 "):
            call()


def test_prefetch_kicks_race_binds_and_releases():
    """Threads kick prefetches while the caller binds and releases: every
    lease count stays exact and the worker stops at shutdown."""
    _, ts = stores(n_hot=3, prefetch=True)
    for aid in range(11, 17):
        ts.register(aid, mk_layers(aid, 2), alpha=2.0)
    stop = threading.Event()

    def kick():
        while not stop.is_set():
            for aid in range(11, 17):
                ts.prefetch(aid)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    threads = [threading.Thread(target=kick) for _ in range(4)]
    try:
        for t in threads:
            t.start()
        deadline = time.monotonic() + 2.0
        rs = np.random.RandomState(0)
        live = {}
        while time.monotonic() < deadline:
            uid = int(rs.randint(0, 3))
            if uid in live:
                ts.release(uid)
                del live[uid]
            else:
                live[uid] = ts.bind(uid, int(rs.randint(11, 17)))
            assert ts.stats()["leases"] == len(live)
            for u, slot in live.items():
                assert ts.slot_of(u) == slot and ts.hot_set().count(
                    ts._slot_meta[slot]["adapter_id"]) == 1
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=5.0)
        sys.setswitchinterval(old)
        ts.shutdown()
    assert not any(t.is_alive() for t in threads)
    assert ts._worker is None or not ts._worker.is_alive()
    assert ts.stats()["prefetch_errors"] == 0


def test_default_device_is_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None would rightly use it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AdapterStore(DIMS, L)
