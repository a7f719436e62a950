"""The port's ``WeightPublisher`` against the JAX package's, on the CPU.

- Every case of the JAX package's ``TestWeightPublisher`` runs on the
  port: round trip and chain, lineage advance, torn publications
  invisible, a crash between promote and ``LATEST``, a payload bit flip,
  a forged manifest and a wrong lineage, GC keeping the rollback target,
  the keep floor.
- Cross reads: a publication by either package loads in the other with
  every leaf byte-equal, shape, dtype and 0-d leaves included; a fixed
  tree gives the same manifest (tree spec, sha256, chain) in both,
  whether the port's leaves are numpy arrays or torch tensors (bf16
  without ``ml_dtypes`` on the port's side).
- Faults on both packages: a crash at every hook point leaves the same
  committed versions and ``LATEST`` in both directories, and a load of
  the torn version is rejected typed by both; a bit flip, a forged
  manifest and a wrong lineage are rejected typed by both, each
  package's ``rejects`` counting them.
"""

import io
import json
import os

import ml_dtypes
import numpy as np
import pytest
import torch

from deepspeed_tpu.serving.refresh.publisher import WeightPublisher as JaxPublisher
from deepspeed_tpu.utils.sanitize import WeightPublicationError as JaxPublicationError
from deepspeed_tpu_torch.runtime.checkpoint_engine.sharded_checkpoint_engine import flatten_named
from deepspeed_tpu_torch.serving import WeightPublisher
from deepspeed_tpu_torch.serving.refresh.publisher import LATEST, MANIFEST_NAME, PAYLOAD_NAME
from deepspeed_tpu_torch.utils.sanitize import WeightPublicationError

torch.set_num_threads(1)  # the suite runs in parallel worker processes

HOOK_POINTS = ("before_write", "after_payload", "before_manifest", "before_promote",
               "before_latest", "after_commit")


def params_for(v):
    """The param tree published as weight version ``v``."""
    return {"v": np.asarray(int(v))}


def tree_for(v):
    """A richer publication tree (nested dicts + a list), deterministic in
    ``v`` (the JAX test's)."""
    rng = np.random.default_rng(1000 + v)
    return {"v": np.asarray(int(v)),
            "layers": [{"w": rng.standard_normal((3, 4)).astype(np.float32),
                        "b": np.arange(4, dtype=np.int32) + v}
                       for _ in range(2)],
            "head": {"scale": np.float32(0.5 + v)}}


def mixed_tree(v, as_torch):
    """Every dtype a serving tree carries (bf16, fp32, int8, bool, int64,
    a 0-d leaf, an empty leaf), as numpy (bf16 through ml_dtypes, as the
    JAX package holds it) or as torch tensors."""
    rng = np.random.default_rng(7 + v)
    w = rng.standard_normal((2, 5, 3)).astype(np.float32)
    tree = {"layers": {"wq": w.astype(ml_dtypes.bfloat16), "norm": w[0, 0] * 0.5},
            "q": rng.integers(-128, 127, (4, 6)).astype(np.int8),
            "mask": np.array([True, False, True]), "step": np.asarray(np.int64(v)),
            "empty": np.zeros((0, 3), np.float32)}
    if not as_torch:
        return tree

    def to_torch(x):
        if x.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
        return torch.from_numpy(np.array(x))  # a copy keeps a 0-d leaf 0-d
    return {k: ({n: to_torch(w) for n, w in v.items()} if isinstance(v, dict) else to_torch(v))
            for k, v in tree.items()}


def host_bytes(x):
    """A leaf's shape, dtype name and raw bytes."""
    if isinstance(x, torch.Tensor):
        raw = x.contiguous().reshape(-1)
        data = raw.view(torch.uint8).numpy().tobytes() if raw.numel() else b""
        name = str(x.dtype).replace("torch.", "")
        return tuple(x.shape), name, data
    x = np.asarray(x)
    return x.shape, x.dtype.name, np.ascontiguousarray(x).tobytes()


def assert_trees_equal(a, b):
    fa, fb = flatten_named(a), flatten_named(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (path, x), (_, y) in zip(fa, fb):
        assert host_bytes(x) == host_bytes(y), path


# ---------------------------------------------------------------------- the JAX cases, on the port
def test_publish_load_roundtrip_and_chain(tmp_path):
    pub = WeightPublisher(tmp_path)
    m1 = pub.publish(tree_for(1))
    m2 = pub.publish(tree_for(2))
    assert pub.versions() == [1, 2]
    assert pub.latest_version() == 2
    assert m1["parent_chain"] is None and m2["parent_chain"] == m1["chain"]
    assert m2["chain"] != m1["chain"]
    assert pub.verify_chain() == [1, 2]
    with open(os.path.join(pub.dir, LATEST)) as fd:
        assert fd.read().strip() == "v00000002"
    tree, manifest = pub.load(expect_parent_chain=m1["chain"])
    assert manifest["weight_version"] == 2
    assert_trees_equal(tree, tree_for(2))
    assert isinstance(tree["layers"], list) and len(tree["layers"]) == 2
    assert tree["v"].shape == () and tree["head"]["scale"].shape == ()
    assert all(isinstance(leaf, torch.Tensor) and leaf.device.type == "cpu"
               for _, leaf in flatten_named(tree))
    assert pub.publishes == 2 and pub.rejects == 0


def test_version_must_advance_lineage(tmp_path):
    pub = WeightPublisher(tmp_path)
    pub.publish(params_for(1), version=3)
    with pytest.raises(WeightPublicationError, match="advance"):
        pub.publish(params_for(2), version=3)
    with pytest.raises(WeightPublicationError, match="advance"):
        pub.publish(params_for(2), version=2)
    assert pub.versions() == [3]


def test_torn_publication_invisible_and_rejected(tmp_path):
    armed = {"point": "before_manifest"}

    def hook(point, detail=None):
        if point == armed.get("point") and detail == 2:
            raise RuntimeError(f"injected crash at {point}")

    pub = WeightPublisher(tmp_path, test_hook=hook)
    pub.publish(params_for(1))
    with pytest.raises(RuntimeError, match="injected crash"):
        pub.publish(params_for(2))
    assert pub.versions() == [1] and pub.latest_version() == 1
    with pytest.raises(WeightPublicationError, match="nothing to adopt"):
        pub.load(2)
    assert pub.rejects == 1
    armed["point"] = None
    m2 = pub.publish(params_for(2))
    assert pub.versions() == [1, 2] and m2["weight_version"] == 2
    pub.verify_chain()


def test_crash_between_promote_and_latest_still_committed(tmp_path):
    def hook(point, detail=None):
        if point == "before_latest":
            raise RuntimeError("injected crash before LATEST")

    pub = WeightPublisher(tmp_path, test_hook=hook)
    with pytest.raises(RuntimeError):
        pub.publish(params_for(1))
    assert not os.path.exists(os.path.join(pub.dir, LATEST))
    assert pub.latest_version() == 1
    tree, _ = pub.load()
    assert int(tree["v"]) == 1


def flip_byte(pub_dir, version):
    payload = os.path.join(pub_dir, f"v{version:08d}", PAYLOAD_NAME)
    size = os.path.getsize(payload)
    with open(payload, "r+b") as fd:
        fd.seek(size // 2)
        byte = fd.read(1)
        fd.seek(size // 2)
        fd.write(bytes([byte[0] ^ 0xFF]))
    assert os.path.getsize(payload) == size


def forge_manifest(pub_dir, version):
    mpath = os.path.join(pub_dir, f"v{version:08d}", MANIFEST_NAME)
    with open(mpath) as fd:
        forged = json.load(fd)
    forged["files"][PAYLOAD_NAME]["bytes"] += 1
    with open(mpath, "w") as fd:
        json.dump(forged, fd)


def test_payload_bitflip_rejected(tmp_path):
    pub = WeightPublisher(tmp_path)
    pub.publish(tree_for(1))
    flip_byte(pub.dir, 1)
    with pytest.raises(WeightPublicationError, match="corruption"):
        pub.load(1)
    assert pub.rejects == 1


def test_load_verifies_the_bytes_it_returns(tmp_path, monkeypatch):
    """``load`` reads the payload once, a chunk at a time on a helper
    thread, and checks the sha256 of the buffer its leaves view: the file
    is opened once and never hashed from disk again, and a bit flip is
    still rejected. A digest the caller passes decides over the file on
    disk."""
    from deepspeed_tpu_torch.nebula import service
    from deepspeed_tpu_torch.serving.refresh import publisher
    from deepspeed_tpu_torch.utils.sanitize import check_weight_publication

    def no_second_read(path, chunk_bytes=None):
        raise AssertionError(f"{path} hashed from disk")
    opened = []

    def counting_open(path, mode="r", *args, **kw):
        if str(path).endswith(PAYLOAD_NAME) and "r" in mode and "+" not in mode:
            opened.append(path)
        return open(path, mode, *args, **kw)
    pub = WeightPublisher(tmp_path)
    manifest = pub.publish(tree_for(1))
    monkeypatch.setattr(publisher, "_READ_CHUNK", 40)
    monkeypatch.setattr(service, "file_sha256", no_second_read)
    monkeypatch.setattr(publisher, "open", counting_open, raising=False)
    tree, m = pub.load(1)
    assert m == manifest and len(opened) == 1
    assert_trees_equal(tree, tree_for(1))
    info = manifest["files"][PAYLOAD_NAME]
    with pytest.raises(WeightPublicationError, match="corruption"):
        check_weight_publication(manifest, pub_dir=os.path.join(pub.dir, "v00000001"),
                                 digests={PAYLOAD_NAME: (info["bytes"], "0" * 64)})
    flip_byte(pub.dir, 1)
    with pytest.raises(WeightPublicationError, match="corruption"):
        pub.load(1)
    assert len(opened) == 2 and pub.rejects == 1


def test_load_read_error_rejected_typed(tmp_path, monkeypatch):
    """An I/O error on the reading thread reaches ``load`` as a typed
    rejection, counted, instead of hanging the hash."""
    from deepspeed_tpu_torch.serving.refresh import publisher

    class Failing(io.FileIO):
        def readinto(self, b):
            raise OSError(5, "Input/output error")
    pub = WeightPublisher(tmp_path)
    pub.publish(tree_for(1))
    monkeypatch.setattr(publisher, "open", lambda path, mode="r", **kw: Failing(path, "r"),
                        raising=False)
    with pytest.raises(WeightPublicationError, match="could not be read"):
        pub.load(1)
    assert pub.rejects == 1


def test_forged_manifest_rejected(tmp_path):
    pub = WeightPublisher(tmp_path)
    m1 = pub.publish(params_for(1))
    pub.publish(params_for(2))
    forge_manifest(pub.dir, 2)
    with pytest.raises(WeightPublicationError):
        pub.load(2)
    with pytest.raises(WeightPublicationError):
        pub.verify_chain()
    with pytest.raises(WeightPublicationError, match="lineage"):
        pub.load(1, expect_parent_chain=m1["chain"])
    assert pub.rejects == 2


def test_gc_keeps_rollback_target(tmp_path):
    pub = WeightPublisher(tmp_path, keep=2)
    for v in (1, 2, 3):
        pub.publish(params_for(v))
    assert pub.versions() == [2, 3]
    assert not os.path.isdir(os.path.join(pub.dir, "v00000001"))
    pub.load(2)
    assert pub.verify_chain() == [2, 3]


def test_keep_floor_is_two(tmp_path):
    assert WeightPublisher(tmp_path, keep=1).keep == 2


def test_keep_reads_ds_refresh_keep(tmp_path, monkeypatch):
    monkeypatch.setenv("DS_REFRESH_KEEP", "3")
    assert WeightPublisher(tmp_path / "a").keep == JaxPublisher(tmp_path / "b").keep == 3


# ---------------------------------------------------------------------- cross reads
@pytest.mark.parametrize("as_torch", [False, True], ids=["numpy_leaves", "torch_leaves"])
def test_same_tree_same_manifest_bytes_and_chain(tmp_path, as_torch):
    """Two versions of one tree through both publishers: equal manifests
    (tree spec, sizes, sha256, chain) and byte-equal payload files."""
    jpub, tpub = JaxPublisher(tmp_path / "jax"), WeightPublisher(tmp_path / "port")
    for v in (1, 2):
        jm = jpub.publish(mixed_tree(v, False))
        tm = tpub.publish(mixed_tree(v, as_torch))
        assert tm == jm
        assert sorted(os.listdir(os.path.join(tpub.dir, f"v{v:08d}"))) == \
            sorted(os.listdir(os.path.join(jpub.dir, f"v{v:08d}")))
        with open(os.path.join(jpub.dir, f"v{v:08d}", PAYLOAD_NAME), "rb") as a, \
                open(os.path.join(tpub.dir, f"v{v:08d}", PAYLOAD_NAME), "rb") as b:
            assert a.read() == b.read()
    assert tm["tree"]["layers/wq"]["dtype"] == "bfloat16"
    assert tpub.verify_chain() == jpub.verify_chain() == [1, 2]


def test_jax_publishes_port_loads(tmp_path):
    jpub = JaxPublisher(tmp_path)
    jm = jpub.publish(mixed_tree(1, False))
    tpub = WeightPublisher(tmp_path)
    tree, tm = tpub.load(1, expect_parent_chain=None)
    assert tm == jm
    assert_trees_equal(tree, mixed_tree(1, False))
    assert tree["layers"]["wq"].dtype == torch.bfloat16 and tree["step"].shape == ()
    assert tree["empty"].shape == (0, 3)


def test_port_publishes_jax_loads(tmp_path):
    tpub = WeightPublisher(tmp_path)
    tm = tpub.publish(mixed_tree(1, True))
    tpub.publish(mixed_tree(2, True))
    jtree, jm = JaxPublisher(tmp_path).load(2, expect_parent_chain=tm["chain"])
    assert_trees_equal(jtree, mixed_tree(2, False))
    ttree, tm2 = tpub.load(2, expect_parent_chain=tm["chain"])
    assert tm2 == jm
    assert_trees_equal(ttree, jtree)


# ---------------------------------------------------------------------- faults on both packages
@pytest.mark.parametrize("point", HOOK_POINTS)
def test_crash_at_every_hook_point_matches_jax(tmp_path, point):
    """v1 commits, v2's publish crashes at ``point``: both packages leave
    the same committed versions and LATEST, and a load of v2 either
    succeeds in both (the crash came after the promote) or is rejected
    typed by both, nothing adopted."""
    def hook(p, detail=None):
        if p == point and detail == 2:
            raise RuntimeError(f"injected crash at {p}")

    pubs = {"jax": JaxPublisher(tmp_path / "jax", test_hook=hook),
            "port": WeightPublisher(tmp_path / "port", test_hook=hook)}
    for pub in pubs.values():
        pub.publish(tree_for(1))
        with pytest.raises(RuntimeError, match="injected crash"):
            pub.publish(tree_for(2))
    jpub, tpub = pubs["jax"], pubs["port"]
    assert tpub.versions() == jpub.versions()

    def latest(pub):
        path = os.path.join(pub.dir, LATEST)
        return open(path).read() if os.path.exists(path) else None
    assert latest(tpub) == latest(jpub)
    if 2 in jpub.versions():
        assert_trees_equal(tpub.load(2)[0], jpub.load(2)[0])
    else:
        with pytest.raises(JaxPublicationError):
            jpub.load(2)
        with pytest.raises(WeightPublicationError):
            tpub.load(2)
        assert tpub.rejects == jpub.rejects == 1
    assert_trees_equal(tpub.load(1)[0], tree_for(1))


@pytest.mark.parametrize("fault", ["bitflip", "forged", "lineage"])
def test_faults_rejected_typed_on_both(tmp_path, fault):
    """The same fault on a port publication and a JAX one: each package
    rejects both directories' copy typed and counts its rejects."""
    dirs = {"jax": tmp_path / "jax", "port": tmp_path / "port"}
    chains = {}
    chains["jax"] = JaxPublisher(dirs["jax"]).publish(tree_for(1))["chain"]
    chains["port"] = WeightPublisher(dirs["port"]).publish(tree_for(1))["chain"]
    JaxPublisher(dirs["jax"]).publish(tree_for(2))
    WeightPublisher(dirs["port"]).publish(tree_for(2))
    assert chains["jax"] == chains["port"]
    for d in dirs.values():
        if fault == "bitflip":
            flip_byte(str(d), 2)
        elif fault == "forged":
            forge_manifest(str(d), 2)
    for d in dirs.values():
        for cls, err in ((JaxPublisher, JaxPublicationError),
                         (WeightPublisher, WeightPublicationError)):
            pub = cls(d)
            if fault == "lineage":  # v1 grafted where v2's parent is pinned
                with pytest.raises(err, match="lineage"):
                    pub.load(1, expect_parent_chain=chains["jax"])
            else:
                with pytest.raises(err, match="corruption" if fault == "bitflip" else None):
                    pub.load(2)
            assert pub.rejects == 1
            assert pub.load(1)[1]["weight_version"] == 1  # the earlier version still adopts


def test_tensor_leaves_on_any_device_write_in_chunks(tmp_path, monkeypatch):
    """A leaf larger than the staging chunk writes in pieces with the
    same bytes and sha256 as one numpy write."""
    from deepspeed_tpu_torch.serving.refresh import publisher
    monkeypatch.setattr(publisher, "_CHUNK_BYTES", 40)
    w = torch.arange(60, dtype=torch.float32).reshape(6, 10).to(torch.bfloat16)
    tm = WeightPublisher(tmp_path / "port").publish({"w": w})
    jm = JaxPublisher(tmp_path / "jax").publish({"w": w.float().numpy().astype(ml_dtypes.bfloat16)})
    assert tm == jm
    with pytest.raises(TypeError, match="object dtype"):
        WeightPublisher(tmp_path / "bad").publish({"x": np.array([object()])})
