"""``DS_SANITIZE`` on the port: the forward gate, the invariant audits and
the lock-order tracker, held against the JAX package.

- on: a NaN-poisoned weight raises ``SanitizerNaNError`` at the next
  forward (put, burst, pipelined burst); a forged out-of-range block id
  or token id raises ``SanitizerIndexError`` (a ``SanitizerNaNError``,
  as checkify's index check is) before the gather; a clean run emits the
  streams an unsanitized engine emits; forged allocator, radix-trie and
  spill-tier corruption raise their typed errors at the next mutation,
  on the same forged states where the JAX package's raise;
- off: the gate returns the forward itself (no wrapper, so no branch and
  no launch a call), poisoned weights propagate silently, and forged
  corruption goes unseen, as in the JAX package;
- locks: a forged inversion raises ``LockOrderViolationError`` naming
  both stacks, a transitive cycle is found, a consistent order and RLock
  reentrancy stay silent, a plain lock's blocking re-acquire raises
  instead of hanging, a Condition over a tracked lock keeps the held
  stack right, the off state returns the lock itself; every lock the
  port tracks carries the JAX package's name for it, letter for letter.
  (The wire-frame checks wait for the fleet.)"""

import pathlib
import re
import threading

import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2.kv_tier.host_store import HostKVStore as JaxHostKVStore
from deepspeed_tpu.inference.v2.prefix_cache.radix_index import \
    RadixPrefixIndex as JaxRadixPrefixIndex
from deepspeed_tpu.inference.v2.ragged.blocked_allocator import \
    BlockedAllocator as JaxBlockedAllocator
from deepspeed_tpu.utils import sanitize as JS
from deepspeed_tpu_torch.inference.structured.store import SchemaCompilerCache
from deepspeed_tpu_torch.inference.v2 import (DSStateManagerConfig, DynamicSplitFuseScheduler,
                                              InferenceEngineV2, RaggedInferenceEngineConfig)
from deepspeed_tpu_torch.inference.v2.kv_tier.host_store import HostKVStore
from deepspeed_tpu_torch.inference.v2.prefix_cache.manager import PrefixCacheManager
from deepspeed_tpu_torch.inference.v2.prefix_cache.radix_index import RadixPrefixIndex
from deepspeed_tpu_torch.inference.v2.ragged.blocked_allocator import BlockedAllocator
from deepspeed_tpu_torch.utils import sanitize as S
from deepspeed_tpu_torch.utils.sanitize import (AllocatorCorruptionError,
                                                KVTierCorruptionError, LockOrderViolationError,
                                                PrefixCacheCorruptionError, SanitizerError,
                                                SanitizerIndexError, SanitizerNaNError,
                                                check_prefix_index, lock_graph_snapshot,
                                                maybe_checkify, reset_lock_graph,
                                                sanitize_enabled, tracked_lock)

torch.set_num_threads(1)  # the suite runs in parallel worker processes

ROOT = pathlib.Path(__file__).resolve().parents[1]
SM = dict(max_ragged_batch_size=64, max_ragged_sequence_count=4, max_tracked_sequences=4,
          max_context=64)
PROMPT = [5, 6, 7, 8, 9, 10, 11]


@pytest.fixture(autouse=True)
def _isolated_lock_graph():
    reset_lock_graph()
    yield
    reset_lock_graph()
    S._HELD.stack = []


def small_engine(**sections):
    cfg = RaggedInferenceEngineConfig(kv_block_size=8,
                                      state_manager=DSStateManagerConfig(**SM), **sections)
    return InferenceEngineV2("debug", cfg, dtype=torch.float32, device="cpu")


def poison(engine):
    engine.params["layers"]["wq"][0, 0, 0] = float("nan")


def run(engine, prompts, max_new=10):
    sched = DynamicSplitFuseScheduler(engine, token_budget=32, max_burst=4)
    for uid, p in enumerate(prompts):
        sched.add_request(uid, p, max_new_tokens=max_new)
    return sched.run_to_completion()


@pytest.mark.parametrize("raw", [None, "1", "0", "", "true", "off", "No", "yes", "junk"])
def test_flag_parsing_matches_jax(monkeypatch, raw):
    if raw is None:
        monkeypatch.delenv("DS_SANITIZE", raising=False)
    else:
        monkeypatch.setenv("DS_SANITIZE", raw)
    assert sanitize_enabled() == JS.sanitize_enabled()


# ------------------------------------------------------------ the forward gate
@pytest.mark.parametrize("path", ["put", "burst", "async_burst"])
def test_poisoned_weight_raises_nan_error(monkeypatch, path):
    monkeypatch.setenv("DS_SANITIZE", "1")
    engine = small_engine(async_burst={"enabled": True})
    assert engine._sanitize and engine._forward._ds_sanitized
    t = int(engine.put([1], [PROMPT], sample="greedy")[0])  # a clean forward passes
    poison(engine)
    with pytest.raises(SanitizerNaNError, match="non-finite"):
        if path == "put":
            engine.put([2], [PROMPT])
        elif path == "burst":
            engine.decode_burst([1], [[t]], 2)
        else:
            engine.decode_burst_async([1], [[t]], 2)


def test_forged_indices_raise_index_errors(monkeypatch):
    """checkify's index check: an out-of-range block id in a sequence's
    table, or a token id past the vocabulary, raises before the gather."""
    monkeypatch.setenv("DS_SANITIZE", "1")
    engine = small_engine()
    engine.put([1], [PROMPT], sample="greedy")
    engine.state_manager.query(1).blocks[0] = engine.kv_cache.num_blocks + 3
    with pytest.raises(SanitizerIndexError, match="block_tables out of bounds"):
        engine.put([1], [[3]], sample="greedy")
    assert issubclass(SanitizerIndexError, SanitizerNaNError)
    with pytest.raises(SanitizerIndexError, match="token_ids out of bounds"):
        engine.put([2], [[engine.model_config.vocab_size + 1]], sample="greedy")


def test_sanitized_clean_run_equals_unsanitized(monkeypatch):
    prompts = [PROMPT, [9, 8, 7, 6, 5]]
    outs = {}
    for flag in ("1", "0"):
        monkeypatch.setenv("DS_SANITIZE", flag)
        for async_on in (False, True):
            engine = small_engine(async_burst={"enabled": async_on})
            assert engine._sanitize == (flag == "1")
            outs[flag, async_on] = run(engine, prompts)
    assert len(set(map(str, outs.values()))) == 1


def test_off_gate_is_the_forward_itself(monkeypatch):
    """Off, the gate returns the callable itself: no wrapper object, so
    no branch and no launch a call; NaN propagates silently."""
    monkeypatch.delenv("DS_SANITIZE", raising=False)
    engine = small_engine()
    assert not engine._sanitize
    assert engine._forward.__func__ is InferenceEngineV2._forward
    assert engine._forward.__self__ is engine
    assert not getattr(engine._forward, "_ds_sanitized", False)
    poison(engine)
    assert np.isnan(engine.put([1], [PROMPT])).any()

    def f(x):
        return x + 1
    assert maybe_checkify(f, enabled=False) is f
    checked = maybe_checkify(f, enabled=True)
    assert checked._ds_sanitized and checked.__wrapped__ is f
    assert torch.equal(checked(torch.ones(3)), f(torch.ones(3)))
    with pytest.raises(SanitizerNaNError):
        checked(torch.tensor([float("inf")]))


# ------------------------------------------------------------ invariant audits
@pytest.mark.parametrize("cls", [BlockedAllocator, JaxBlockedAllocator], ids=["port", "jax"])
@pytest.mark.parametrize("flag", ["1", "0"])
def test_forged_allocator_mirror(monkeypatch, cls, flag):
    monkeypatch.setenv("DS_SANITIZE", flag)
    alloc = cls(8)
    blocks = alloc.allocate(4)
    alloc.free(blocks)
    alloc._free.append(int(blocks[0]))  # the list and its mirror now disagree
    if flag == "1":
        with pytest.raises(Exception) as err:
            alloc.allocate(1)
        assert type(err.value).__name__ == "AllocatorCorruptionError"
    else:
        alloc.allocate(1)  # no audit, no error
    assert issubclass(AllocatorCorruptionError, SanitizerError)


@pytest.mark.parametrize("cls,check", [(RadixPrefixIndex, check_prefix_index),
                                       (JaxRadixPrefixIndex, JS.check_prefix_index)],
                         ids=["port", "jax"])
def test_forged_refcount_skew_in_trie(cls, check):
    index = cls(2)
    node = index.insert_child(index.root, (11, 12), block_id=3)
    check(index)  # consistent: one node at ref 0
    node.ref += 1  # forged: past incref's ref-0 bookkeeping
    with pytest.raises(Exception) as err:
        check(index)
    assert type(err.value).__name__ == "PrefixCacheCorruptionError"


class PoolStub:
    block_size = 2
    free_blocks = 64
    device = torch.device("cpu")

    def free(self, blocks):
        pass


@pytest.mark.parametrize("flag", ["1", "0"])
def test_prefix_manager_audits_every_mutation(monkeypatch, flag):
    monkeypatch.setenv("DS_SANITIZE", flag)
    mgr = PrefixCacheManager(PoolStub())
    node = mgr.index.insert_child(mgr.index.root, (1, 2), block_id=0)
    node.ref = 5  # forged skew
    if flag == "1":
        with pytest.raises(PrefixCacheCorruptionError):
            mgr.acquire("u1", [1, 2, 3])
    else:
        mgr.acquire("u1", [1, 2, 3])


@pytest.mark.parametrize("cls", [HostKVStore, JaxHostKVStore], ids=["port", "jax"])
@pytest.mark.parametrize("forge", ["key", "bytes"])
def test_host_store_audits_every_mutation(monkeypatch, cls, forge):
    monkeypatch.setenv("DS_SANITIZE", "1")
    store = cls(1 << 20)
    store.put("root", (1, 2), {"k": None, "v": None}, 100)
    if forge == "key":
        next(iter(store._records.values()))["key"] = "forged"
    else:
        store.bytes_resident += 1
    with pytest.raises(Exception) as err:
        store.put("root", (3, 4), {"k": None, "v": None}, 100)
    assert type(err.value).__name__ == "KVTierCorruptionError"
    assert issubclass(KVTierCorruptionError, SanitizerError)


def test_host_store_off_is_silent(monkeypatch):
    monkeypatch.setenv("DS_SANITIZE", "0")
    store = HostKVStore(1 << 20)
    store.put("root", (1, 2), {"k": None, "v": None}, 100)
    store.bytes_resident += 1
    assert store.put("root", (3, 4), {"k": None, "v": None}, 100)


# --------------------------------------------------------------- lock order
def _establish(first, second, thread_name):
    """Record first -> second in the global graph from a worker thread."""
    def body():
        with first:
            with second:
                pass
    th = threading.Thread(target=body, name=thread_name)
    th.start()
    th.join()


def test_forged_inversion_raises_with_both_stacks():
    mgr = tracked_lock(threading.Lock(), "PrefixCacheManager._lock", enabled=True)
    tier = tracked_lock(threading.Lock(), "TierManager._lock", enabled=True)
    _establish(mgr, tier, thread_name="mgr-then-tier")
    with pytest.raises(LockOrderViolationError) as err, tier:
        with mgr:
            pass
    msg = str(err.value)
    for part in ("PrefixCacheManager._lock", "TierManager._lock", "mgr-then-tier",
                 threading.current_thread().name, "current acquisition stack",
                 "conflicting acquisition stack"):
        assert part in msg
    assert S._held_stack() == []  # raised before acquiring
    assert issubclass(LockOrderViolationError, SanitizerError)


def test_transitive_cycle_detected():
    a, b, c = (tracked_lock(threading.Lock(), f"{n}._lock", enabled=True) for n in "ABC")
    _establish(a, b, "a-then-b")
    _establish(b, c, "b-then-c")
    with pytest.raises(LockOrderViolationError), c:
        with a:  # closes c -> a against the recorded a -> b -> c
            pass


def test_consistent_order_and_reentrancy_stay_silent():
    a = tracked_lock(threading.Lock(), "A._lock", enabled=True)
    b = tracked_lock(threading.Lock(), "B._lock", enabled=True)
    for _ in range(3):
        with a:
            with b:
                pass
    snap = lock_graph_snapshot()
    assert "B._lock" in snap["A._lock"] and "A._lock" not in snap.get("B._lock", {})
    r = tracked_lock(threading.RLock(), "AdapterStore._lock", enabled=True)
    with r:
        with r:
            assert len(S._held_stack()) == 2
    assert S._held_stack() == []
    assert "AdapterStore._lock" not in lock_graph_snapshot()  # no self-edge


def test_plain_lock_blocking_reacquire_raises_instead_of_hanging():
    lk = tracked_lock(threading.Lock(), "SchemaCompilerCache._lock", enabled=True)
    with lk:
        with pytest.raises(LockOrderViolationError, match="self-deadlock"):
            lk.acquire()
        assert lk.acquire(False) is False  # a non-blocking probe is fine
    assert S._held_stack() == []


def test_condition_over_tracked_plain_lock():
    lk = tracked_lock(threading.Lock(), "X._lock", enabled=True)
    cv = threading.Condition(lk)
    done = []

    def waiter():
        with cv:
            while not done:
                cv.wait(timeout=1.0)

    th = threading.Thread(target=waiter, name="waiter")
    th.start()
    with cv:
        done.append(1)
        cv.notify()
    th.join(timeout=5.0)
    assert not th.is_alive() and S._held_stack() == []


def test_off_state_returns_the_lock_itself(monkeypatch):
    plain = threading.Lock()
    assert tracked_lock(plain, "X._lock", enabled=False) is plain
    monkeypatch.setenv("DS_SANITIZE", "0")
    lk = SchemaCompilerCache()._lock
    assert type(lk) is type(threading.Lock())
    monkeypatch.setenv("DS_SANITIZE", "1")
    lk = SchemaCompilerCache()._lock
    assert isinstance(lk, S._TrackedLock) and lk._name == "SchemaCompilerCache._lock"


# (port module, its JAX counterpart): the names tracked_lock is given
WIRED = {"inference/v2/prefix_cache/manager.py": ["PrefixCacheManager._lock"],
         "inference/v2/kv_tier/host_store.py": ["HostKVStore._lock"],
         "inference/v2/kv_tier/tier_manager.py": ["TierManager._lock"],
         "inference/structured/store.py": ["SchemaCompilerCache._lock"],
         "serving/lora/store.py": ["AdapterStore._lock"]}


def _tracked_names(path):
    src = re.sub(r"\s+", " ", path.read_text())
    return re.findall(r'tracked_lock\([^()]*\(\), "([^"]+)"\)', src)


@pytest.mark.parametrize("module", sorted(WIRED))
def test_each_port_lock_carries_the_jax_name(module):
    port = _tracked_names(ROOT / "deepspeed_tpu_torch" / module)
    assert port == _tracked_names(ROOT / "deepspeed_tpu" / module) == WIRED[module]


def test_engine_locks_are_tracked_under_sanitize(monkeypatch):
    """A sanitized engine with the prefix cache, the spill tier and LoRA
    serving tracks each of their locks under its JAX name, and serves."""
    monkeypatch.setenv("DS_SANITIZE", "1")
    engine = small_engine(prefix_cache={"enabled": True},
                          kv_tier={"enabled": True, "prefetch": False},
                          lora={"enabled": True, "hot_set": 2, "max_rank": 4,
                                "prefetch": False})
    locks = {"PrefixCacheManager._lock": engine.prefix_cache._lock,
             "TierManager._lock": engine.kv_tier._lock,
             "HostKVStore._lock": engine.kv_tier.store._lock,
             "AdapterStore._lock": engine.lora_store._lock}
    for name, lk in locks.items():
        assert isinstance(lk, S._TrackedLock) and lk._name == name
    out = run(engine, [PROMPT, PROMPT], max_new=4)
    assert out[0] == out[1]
    edges = lock_graph_snapshot()
    assert all(src in locks or src == "SchemaCompilerCache._lock" for src in edges)
