"""Weight publisher: versioned, integrity-checked weight publications.

Port of ``deepspeed_tpu/serving/refresh/publisher.py``. The training side
turns a live param tree into a *publication* — an on-disk directory a
serving engine can adopt without ever trusting it blindly. The commit
protocol is the JAX publisher's, step for step:

1. payloads are written into a per-publication temp dir under
   ``.refresh_tmp/`` (a crash leaves no half-publication where a reader
   could find it);
2. the manifest — carrying per-file sizes + sha256 AND a chain hash
   over the publication's entire version lineage — is written LAST
   (tmp + ``os.replace``), so its presence certifies every payload
   byte landed;
3. the temp dir is promoted into place with one atomic ``os.rename``;
4. ``LATEST`` is rotated (tmp + replace) only after the promote;
5. retention GC keeps the newest ``DS_REFRESH_KEEP`` publications —
   never fewer than two, so rollback always has a target.

The on-disk format is the JAX publisher's byte for byte (the same
payload, tree spec, sha256 and chain hash for the same tree), so either
package reads the other's publications. Leaves may be torch tensors (on
any device: their bytes are copied to the host and written a chunk at a
time, so a device tree never has a second whole copy on the host) or
numpy arrays and scalars. Dtype names in the manifest are numpy's and
``ml_dtypes``' (``"bfloat16"``, ``"float8_e4m3fn"``, …) without importing
``ml_dtypes``: torch names the same formats. :meth:`WeightPublisher.load`
returns CPU torch tensors viewing one host buffer of the payload.

A torn, truncated, or forged publication — or one grafted onto the
wrong lineage — is rejected **typed** (:class:`WeightPublicationError`)
with nothing adopted. Load-side validation is unconditional, not
DS_SANITIZE-gated: publications cross a process/filesystem boundary and
are untrusted input.
"""

import hashlib
import json
import os
import queue
import shutil
import threading

import numpy as np
import torch

from deepspeed_tpu_torch.runtime.checkpoint_engine.sharded_checkpoint_engine import flatten_named
from deepspeed_tpu_torch.utils.env_registry import env_int
from deepspeed_tpu_torch.utils.logging import logger
from deepspeed_tpu_torch.utils.sanitize import (WeightPublicationError, check_weight_publication,
                                                publication_chain_hash, tracked_lock)

MANIFEST_NAME = "weight_manifest.json"
PAYLOAD_NAME = "payload.bin"
TMP_ROOT = ".refresh_tmp"
LATEST = "LATEST"
_CHUNK_BYTES = 64 << 20  # host staging of a device leaf, a chunk at a time
_READ_CHUNK = 16 << 20   # a load's read, a chunk ahead of the hash

# torch dtype <-> the dtype name numpy (with ml_dtypes) gives the same format
_DTYPE_NAMES = {torch.float64: "float64", torch.float32: "float32", torch.float16: "float16",
                torch.bfloat16: "bfloat16", torch.float8_e4m3fn: "float8_e4m3fn",
                torch.float8_e5m2: "float8_e5m2", torch.int64: "int64", torch.int32: "int32",
                torch.int16: "int16", torch.int8: "int8", torch.uint8: "uint8",
                torch.bool: "bool", torch.complex64: "complex64",
                torch.complex128: "complex128"}
for _name in ("uint16", "uint32", "uint64"):
    if hasattr(torch, _name):
        _DTYPE_NAMES[getattr(torch, _name)] = _name
_TORCH_DTYPES = {name: dt for dt, name in _DTYPE_NAMES.items()}


def _tag(version):
    return f"v{int(version):08d}"


def _unflatten(pairs):
    """Inverse of :func:`flatten_named`: ``[(path, leaf)]`` back into
    nested dicts / lists (``#i`` path segments are list positions)."""
    root = {}
    for path, leaf in pairs:
        parts = path.split("/")
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf

    def rebuild(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.startswith("#") for k in node):
            idx = sorted(node, key=lambda k: int(k[1:]))
            if [int(k[1:]) for k in idx] != list(range(len(idx))):
                raise WeightPublicationError(
                    f"publication tree has a gap in sequence positions: "
                    f"{sorted(node)}")
            return [rebuild(node[k]) for k in idx]
        return {k: rebuild(v) for k, v in node.items()}

    return rebuild(root)


def _write_leaf(fd, digest, path, leaf):
    """Append one leaf's bytes to the payload → its spec entry (without
    the offset)."""
    if isinstance(leaf, torch.Tensor):
        name = _DTYPE_NAMES.get(leaf.dtype)
        if name is None:
            raise TypeError(f"publication leaf '{path}' has dtype {leaf.dtype}, which has no "
                            f"numpy name")
        flat = leaf.detach().contiguous().reshape(-1)
        raw = flat.view(torch.uint8) if flat.numel() else flat
        for i in range(0, raw.numel(), _CHUNK_BYTES):
            chunk = raw[i:i + _CHUNK_BYTES].cpu().numpy()
            fd.write(chunk)
            digest.update(chunk)
        return {"nbytes": int(leaf.numel() * leaf.element_size()), "shape": list(leaf.shape),
                "dtype": name}
    arr = np.asarray(leaf)
    if arr.dtype.hasobject:
        raise TypeError(
            f"publication leaf '{path}' has object dtype "
            f"{arr.dtype} — only numeric arrays publish")
    # ascontiguousarray promotes 0-d to (1,): record the ORIGINAL shape so
    # scalar leaves round-trip exactly
    data = np.ascontiguousarray(arr).tobytes()
    fd.write(data)
    digest.update(data)
    return {"nbytes": int(arr.nbytes), "shape": list(arr.shape), "dtype": arr.dtype.name}


def _read_hashed(path, nbytes):
    """The payload, read once, into one host buffer that
    ``torch.frombuffer`` views, hashed as it lands → ``(buffer, sha256
    hex)``. A helper thread reads a chunk ahead of the hash (both release
    the GIL), so a load takes about the hash's time, not the hash's plus
    the read's. A file whose size is not the manifest's ``nbytes`` is not
    read."""
    try:
        size = os.path.getsize(path)
    except FileNotFoundError:
        raise WeightPublicationError(f"publication payload '{path}' is missing on disk — torn "
                                     f"publication") from None
    if size != nbytes:
        raise WeightPublicationError(f"publication payload '{path}' is {size} bytes, manifest "
                                     f"says {nbytes} — truncated")
    buf = np.empty(size, np.uint8)  # uninitialized: the read writes every byte
    view = memoryview(buf)
    ready = queue.Queue(maxsize=8)  # (offset, bytes) of each chunk read; None at the end

    def read():
        got = 0
        try:
            with open(path, "rb", buffering=0) as fd:
                while got < size:
                    n = fd.readinto(view[got:got + _READ_CHUNK])
                    if not n:
                        break
                    ready.put((got, n))
                    got += n
        except BaseException as err:  # noqa: BLE001 — raised on the hashing thread
            ready.put(err)
            return
        ready.put(None)
    reader = threading.Thread(target=read, name="ds-publication-read", daemon=True)
    reader.start()
    digest = hashlib.sha256()
    got = 0
    while (item := ready.get()) is not None:
        if isinstance(item, OSError):
            raise WeightPublicationError(f"publication payload '{path}' could not be read: "
                                         f"{item}") from item
        if isinstance(item, BaseException):
            raise item
        off, n = item
        digest.update(view[off:off + n])
        got += n
    reader.join()
    if got != size:
        raise WeightPublicationError(f"publication payload '{path}' shrank while it was read "
                                     f"({got} of {size} bytes)")
    return buf, digest.hexdigest()


class WeightPublisher:
    """Publishes and loads versioned weight publications under one
    directory. Thread-safe; one publisher per publish root.

    ``tree`` leaves may be torch tensors on any device, numpy arrays or
    scalars.

    ``test_hook(point, detail)`` is the fault seam: anything it raises
    aborts the publication at that point, which is how tests manufacture
    torn publications.
    """

    def __init__(self, publish_dir, keep=None, test_hook=None):
        self.dir = str(publish_dir)
        os.makedirs(self.dir, exist_ok=True)
        # rollback always needs the previous version on disk: floor 2
        self.keep = max(2, int(keep if keep is not None
                               else env_int("DS_REFRESH_KEEP")))
        self._hook = test_hook or (lambda point, detail=None: None)
        self._lock = tracked_lock(threading.Lock(), "WeightPublisher._lock")
        self.publishes = 0   # committed publications this process
        self.rejects = 0     # typed load-side rejections

    # ----------------------------------------------------------- inventory
    def _pub_dir(self, version):
        return os.path.join(self.dir, _tag(version))

    def versions(self):
        """Committed (manifest-bearing) versions, ascending. A payload
        dir without a manifest is a torn publication and is invisible
        here — exactly the 'nothing adopted' contract."""
        out = []
        for name in os.listdir(self.dir):
            if not (name.startswith("v") and name[1:].isdigit()):
                continue
            if os.path.isfile(os.path.join(self.dir, name, MANIFEST_NAME)):
                out.append(int(name[1:]))
        return sorted(out)

    def latest_version(self):
        """Newest committed version, or None. ``LATEST`` is a hint;
        the manifest scan is authoritative (a crash between promote and
        the LATEST rotation must not hide a committed publication)."""
        versions = self.versions()
        return versions[-1] if versions else None

    def manifest(self, version):
        path = os.path.join(self._pub_dir(version), MANIFEST_NAME)
        try:
            with open(path) as fd:
                return json.load(fd)
        except FileNotFoundError:
            raise WeightPublicationError(
                f"no committed publication for version {version} under "
                f"{self.dir} — the publish never finished (nothing to "
                f"adopt)") from None
        except json.JSONDecodeError as e:
            raise WeightPublicationError(
                f"torn manifest for version {version}: {e} — the publish "
                f"was interrupted mid-write (nothing adopted)") from e

    # ------------------------------------------------------------- publish
    def publish(self, tree, version=None):
        """Publish ``tree`` as the next version (or an explicit
        ``version`` > every committed one). Returns the manifest."""
        with self._lock:
            latest = self.latest_version()
            if version is None:
                version = (latest or 0) + 1
            version = int(version)
            if latest is not None and version <= latest:
                raise WeightPublicationError(
                    f"publication version {version} does not advance the "
                    f"lineage (latest committed is {latest})")
            parent_chain = None
            parent_version = latest or 0
            if latest is not None:
                parent_chain = self.manifest(latest)["chain"]

            tmp = os.path.join(self.dir, TMP_ROOT, _tag(version))
            if os.path.isdir(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            self._hook("before_write", version)

            tree_spec = {}
            offset = 0
            payload = os.path.join(tmp, PAYLOAD_NAME)
            # the payload's sha256 accumulates as it is written: the
            # manifest certifies the bytes this publisher wrote, without
            # reading a multi-GB payload back
            digest = hashlib.sha256()
            with open(payload, "wb") as fd:
                for path, leaf in flatten_named(tree):
                    spec = _write_leaf(fd, digest, path, leaf)
                    tree_spec[path] = {"offset": offset, **spec}
                    offset += spec["nbytes"]
            self._hook("after_payload", version)

            files = {PAYLOAD_NAME: {"bytes": os.path.getsize(payload),
                                    "sha256": digest.hexdigest()}}
            manifest = {
                "version": 1,
                "weight_version": version,
                "tag": _tag(version),
                "parent_version": parent_version,
                "parent_chain": parent_chain,
                "chain": publication_chain_hash(parent_chain, files),
                "files": files,
                "tree": tree_spec,
            }
            self._hook("before_manifest", version)
            mpath = os.path.join(tmp, MANIFEST_NAME)
            with open(mpath + ".tmp", "w") as fd:
                json.dump(manifest, fd, indent=1)
            os.replace(mpath + ".tmp", mpath)

            self._hook("before_promote", version)
            final = self._pub_dir(version)
            if os.path.isdir(final):
                shutil.rmtree(final)  # a torn (manifest-less) leftover
            os.rename(tmp, final)

            self._hook("before_latest", version)
            lpath = os.path.join(self.dir, LATEST)
            with open(lpath + ".tmp", "w") as fd:
                fd.write(_tag(version) + "\n")
            os.replace(lpath + ".tmp", lpath)
            self._hook("after_commit", version)

            self.publishes += 1
            self._gc_locked()
            logger.info(f"refresh: published weight version {version} "
                        f"({len(tree_spec)} leaves, "
                        f"{files[PAYLOAD_NAME]['bytes']} bytes)")
            return manifest

    # ---------------------------------------------------------------- load
    def load(self, version=None, expect_parent_chain=False):
        """Validate and materialize a publication → ``(tree, manifest)``,
        the tree's leaves CPU torch tensors.

        Everything is checked before anything is returned: manifest
        shape, chain re-derivation, payload size + sha256, and that the
        tree spec tiles the payload exactly. The payload is read once:
        the sha256 is taken over the buffer the leaves then view, so the
        bytes returned are the bytes verified. Any failure raises
        :class:`WeightPublicationError` with nothing adopted. Pass
        ``expect_parent_chain=<chain|None>`` to also pin the lineage
        (a publication grafted onto a different history is forged)."""
        if version is None:
            version = self.latest_version()
            if version is None:
                raise WeightPublicationError(
                    f"no committed publications under {self.dir}")
        version = int(version)
        try:
            manifest = self.manifest(version)
            kwargs = {}
            if expect_parent_chain is not False:
                kwargs["parent_chain"] = expect_parent_chain
            # the manifest's fields and chain before a payload byte is read
            check_weight_publication(manifest, expect_version=version, **kwargs)
            info = manifest["files"].get(PAYLOAD_NAME)
            if not isinstance(info, dict):
                raise WeightPublicationError(
                    f"publication v{version} manifest lists no {PAYLOAD_NAME} — forged "
                    f"or torn manifest")
            buf, digest = _read_hashed(os.path.join(self._pub_dir(version), PAYLOAD_NAME),
                                       int(info["bytes"]))
            check_weight_publication(manifest, pub_dir=self._pub_dir(version),
                                     expect_version=version,
                                     digests={PAYLOAD_NAME: (len(buf), digest)}, **kwargs)
            tree = self._materialize(manifest, version, buf)
        except WeightPublicationError:
            with self._lock:
                self.rejects += 1
            raise
        return tree, manifest

    def _materialize(self, manifest, version, buf):
        spec = manifest.get("tree")
        if not isinstance(spec, dict) or not spec:
            raise WeightPublicationError(
                f"publication v{version} manifest has no tree spec")
        covered = 0
        pairs = []
        for path, info in sorted(spec.items()):
            off, nbytes = int(info["offset"]), int(info["nbytes"])
            dtype = _TORCH_DTYPES.get(info["dtype"])
            shape = tuple(int(d) for d in info["shape"])
            if dtype is None:
                raise WeightPublicationError(
                    f"publication v{version}: tree spec for '{path}' names dtype "
                    f"{info['dtype']!r}, which no torch dtype matches — forged spec")
            count = int(np.prod(shape, dtype=np.int64))
            want = count * dtype.itemsize
            if want != nbytes or off < 0 or off + nbytes > len(buf):
                raise WeightPublicationError(
                    f"publication v{version}: tree spec for '{path}' does "
                    f"not fit the payload (offset {off}, {nbytes} bytes, "
                    f"shape {shape} {info['dtype']}) — forged or torn spec")
            leaf = (torch.frombuffer(buf, dtype=dtype, count=count, offset=off) if count
                    else torch.empty(0, dtype=dtype))
            pairs.append((path, leaf.reshape(shape)))
            covered += nbytes
        if covered != len(buf):
            raise WeightPublicationError(
                f"publication v{version}: tree spec covers {covered} of "
                f"{len(buf)} payload bytes — torn or forged publication")
        return _unflatten(pairs)

    def verify_chain(self):
        """Walk every committed publication oldest→newest, re-deriving
        each chain hash and checking each ``parent_chain`` links to its
        predecessor. Returns the verified versions; raises typed on the
        first break."""
        prev_chain = None
        versions = self.versions()
        for v in versions:
            m = self.manifest(v)
            check_weight_publication(m, expect_version=v,
                                     parent_chain=prev_chain)
            prev_chain = m["chain"]
        return versions

    # ------------------------------------------------------------------ gc
    def gc(self):
        with self._lock:
            return self._gc_locked()

    def _gc_locked(self):
        versions = self.versions()
        doomed = versions[:-self.keep] if len(versions) > self.keep else []
        for v in doomed:
            shutil.rmtree(self._pub_dir(v), ignore_errors=True)
        tmp_root = os.path.join(self.dir, TMP_ROOT)
        if os.path.isdir(tmp_root) and not os.listdir(tmp_root):
            shutil.rmtree(tmp_root, ignore_errors=True)
        if doomed:
            logger.info(f"refresh: gc removed publications "
                        f"{[_tag(v) for v in doomed]} (keep={self.keep})")
        return doomed
