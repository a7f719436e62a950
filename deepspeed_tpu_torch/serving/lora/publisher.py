"""Adapter publications: LoRA adapters roll out (and back) like weights.

Port of ``deepspeed_tpu/serving/lora/publisher.py``. An adapter
publication is a :class:`WeightPublisher` publication — the same commit
protocol (tmp-dir staging, manifest-last with per-file sha256 + a chain
hash over the adapter's version lineage, atomic promote, retention GC) —
rooted per adapter under ``<root>/<adapter_id>/``, byte for byte the JAX
package's. A tenant's fine-tune update is therefore the same operation as
a base-weight refresh: publish a new version, adopt it, roll back by
adopting the previous one. A torn, truncated, or forged publication is
rejected **typed** (:class:`WeightPublicationError`) with nothing adopted.

The published tree is ``{"alpha": (), "rank": (), "layers": {site:
{"lora_a": [L, in, r], "lora_b": [L, r, out]}}}`` — true (unbucketed)
rank; the :class:`~deepspeed_tpu_torch.serving.lora.store.AdapterStore`
pads to its rank bucket at promotion time.
"""

import os

import numpy as np
import torch

from deepspeed_tpu_torch.serving.refresh.publisher import WeightPublisher
from deepspeed_tpu_torch.utils.sanitize import WeightPublicationError


def _adapter_tag(adapter_id):
    return f"adapter_{int(adapter_id):06d}"


def _host(x):
    """A loaded leaf (a CPU tensor) → numpy; formats numpy lacks widen to
    fp32 (exact), which the store casts to its slab dtype."""
    if isinstance(x, torch.Tensor):
        if x.dtype in (torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2):
            x = x.float()
        return x.numpy()
    return np.asarray(x)


class AdapterPublisher:
    """One publish root fanning out to per-adapter WeightPublishers."""

    def __init__(self, root, keep=None, test_hook=None):
        self.root = str(root)
        self.keep = keep
        self._hook = test_hook
        self._pubs = {}

    def _pub(self, adapter_id):
        pub = self._pubs.get(int(adapter_id))
        if pub is None:
            pub = WeightPublisher(
                os.path.join(self.root, _adapter_tag(adapter_id)),
                keep=self.keep, test_hook=self._hook)
            self._pubs[int(adapter_id)] = pub
        return pub

    def publish(self, adapter_id, layers, alpha, version=None):
        """Publish one adapter version. ``layers`` is ``{site: (a, b)}``
        with ``a`` [L, in, r] / ``b`` [L, r, out]; returns the committed
        manifest (its ``weight_version`` is the adapter version)."""
        ranks = {site: int(np.shape(a)[-1]) for site, (a, _b) in layers.items()}
        if len(set(ranks.values())) != 1:
            raise WeightPublicationError(
                f"adapter {adapter_id}: sites disagree on rank ({ranks}) — "
                "one adapter publishes one rank")
        tree = {"alpha": np.float32(alpha),
                "rank": np.int32(next(iter(ranks.values()))),
                "layers": {site: {"lora_a": np.asarray(a),
                                  "lora_b": np.asarray(b)}
                           for site, (a, b) in layers.items()}}
        return self._pub(adapter_id).publish(tree, version=version)

    def load(self, adapter_id, version=None):
        """Validate + materialize one adapter version →
        ``(alpha, rank, {site: (a, b)}, manifest)``; typed rejection
        with nothing adopted on any integrity failure."""
        tree, manifest = self._pub(adapter_id).load(version=version)
        layers = tree.get("layers")
        if not isinstance(layers, dict) or not layers:
            raise WeightPublicationError(
                f"adapter {adapter_id} publication "
                f"v{manifest['weight_version']} has no layers")
        out = {}
        for site, pair in layers.items():
            if not isinstance(pair, dict) or \
                    "lora_a" not in pair or "lora_b" not in pair:
                raise WeightPublicationError(
                    f"adapter {adapter_id} site '{site}' publication is "
                    f"missing lora_a/lora_b")
            out[site] = (_host(pair["lora_a"]), _host(pair["lora_b"]))
        return (float(_host(tree["alpha"])), int(_host(tree["rank"])), out, manifest)

    def versions(self, adapter_id):
        return self._pub(adapter_id).versions()

    def latest_version(self, adapter_id):
        return self._pub(adapter_id).latest_version()

    def published_adapters(self):
        """Adapter ids with at least one committed publication on disk."""
        if not os.path.isdir(self.root):
            return []
        out = []
        for name in os.listdir(self.root):
            if name.startswith("adapter_") and name[8:].isdigit():
                aid = int(name[8:])
                if self._pub(aid).latest_version() is not None:
                    out.append(aid)
        return sorted(out)
