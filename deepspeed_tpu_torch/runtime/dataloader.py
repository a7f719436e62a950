"""Data loading with data-parallel sharding.

Copy of ``deepspeed_tpu/runtime/dataloader.py`` (numpy only):
``DeepSpeedDataLoader`` wraps a dataset into micro-batches, sharding
samples across data-parallel replicas; ``RepeatingLoader`` and
``DistributedSampler`` as there. Accepts torch Datasets/DataLoaders,
numpy array tuples, or any iterable of batches.
"""

import math

import numpy as np

from deepspeed_tpu_torch.utils.logging import logger


class RepeatingLoader:
    """Wraps an iterator to restart automatically when exhausted
    (reference ``deepspeed/runtime/pipe/module.py`` helper)."""

    def __init__(self, loader):
        self.loader = loader
        self.data_iter = iter(self.loader)

    def __iter__(self):
        return self

    def __len__(self):
        return len(self.loader)

    def __next__(self):
        try:
            batch = next(self.data_iter)
        except StopIteration:
            self.data_iter = iter(self.loader)
            batch = next(self.data_iter)
        return batch


class DistributedSampler:
    """Deterministic strided sampler over dataset indices for a dp rank.

    The *global* sample order is the seed+epoch permutation of the
    dataset (padded to ``total_size``) — a function of the seed alone,
    never of the replica count; each rank strides over it. That makes
    ``consumed_samples`` (a count of globally consumed samples) a
    world-size-independent resume coordinate: restoring it at a
    different ``num_replicas`` neither repeats nor skips samples, as
    long as the padded ``total_size`` is width-invariant (dataset size
    divisible by every width, or ``drop_last`` layouts that agree).
    """

    def __init__(self, num_samples, num_replicas, rank, shuffle=True, seed=0, drop_last=False):
        self.num_samples_total = num_samples
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.drop_last = drop_last
        self.consumed_samples = 0  # global samples consumed since set_epoch
        if drop_last:
            self.num_samples = num_samples // num_replicas
        else:
            self.num_samples = math.ceil(num_samples / num_replicas)
        self.total_size = self.num_samples * num_replicas

    def set_epoch(self, epoch):
        """Torch-style: start epoch ``epoch`` from its beginning."""
        self.epoch = epoch
        self.consumed_samples = 0

    def advance(self, n_global_samples):
        """Record ``n_global_samples`` consumed across ALL replicas (the
        loader calls this per yielded batch); past ``total_size`` the
        sampler rolls into the next epoch's permutation by itself."""
        self.consumed_samples += int(n_global_samples)

    def _global_order(self, epoch):
        if self.shuffle:
            rng = np.random.RandomState(self.seed + epoch)
            indices = rng.permutation(self.num_samples_total).tolist()
        else:
            indices = list(range(self.num_samples_total))
        if not self.drop_last:
            padding = self.total_size - len(indices)
            if padding > 0:
                indices += indices[:padding]
        else:
            indices = indices[:self.total_size]
        return indices

    def __iter__(self):
        # resume-aware: skip the globally-consumed prefix of the current
        # effective epoch, then stride the unconsumed tail for this rank
        epoch = self.epoch + self.consumed_samples // self.total_size
        offset = self.consumed_samples % self.total_size
        indices = self._global_order(epoch)[offset:]
        return iter(indices[self.rank::self.num_replicas])

    def __len__(self):
        return self.num_samples

    # -- checkpoint state ----------------------------------------------
    def state_dict(self):
        return {"epoch": self.epoch,
                "consumed_samples": self.consumed_samples,
                "seed": self.seed,
                "shuffle": self.shuffle}

    def load_state_dict(self, sd, num_replicas=None, rank=None):
        """Restore the resume coordinate, optionally onto a different
        replica layout (elastic re-mesh)."""
        self.epoch = int(sd.get("epoch", 0))
        self.consumed_samples = int(sd.get("consumed_samples", 0))
        self.seed = sd.get("seed", self.seed)
        self.shuffle = sd.get("shuffle", self.shuffle)
        if num_replicas is not None:
            self.num_replicas = int(num_replicas)
        if rank is not None:
            self.rank = int(rank)
        if num_replicas is not None or rank is not None:
            if self.drop_last:
                self.num_samples = self.num_samples_total // self.num_replicas
            else:
                self.num_samples = math.ceil(self.num_samples_total / self.num_replicas)
            self.total_size = self.num_samples * self.num_replicas


class DeepSpeedDataLoader:

    def __init__(self,
                 dataset,
                 batch_size,
                 local_rank=0,
                 tput_timer=None,
                 collate_fn=None,
                 num_local_io_workers=None,
                 data_sampler=None,
                 data_parallel_world_size=None,
                 data_parallel_rank=None,
                 dataloader_drop_last=False,
                 deepspeed_dataloader_config={}):
        self.tput_timer = tput_timer
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.dataset = dataset
        self.drop_last = dataloader_drop_last
        self.dp_world_size = data_parallel_world_size or 1
        self.dp_rank = data_parallel_rank or 0

        if data_sampler is None:
            data_sampler = DistributedSampler(
                num_samples=len(dataset),
                num_replicas=self.dp_world_size,
                rank=self.dp_rank,
                drop_last=dataloader_drop_last,
            )
        self.data_sampler = data_sampler
        self.len = len(self.data_sampler) // self.batch_size if self.drop_last \
            else math.ceil(len(self.data_sampler) / self.batch_size)
        self.data = None

    def __len__(self):
        return self.len

    def __iter__(self):
        self._create_dataloader()
        return self

    def __next__(self):
        if self.tput_timer:
            self.tput_timer.start()
        return next(self.data)

    def _default_collate(self, samples):
        first = samples[0]
        if isinstance(first, (tuple, list)):
            cols = list(zip(*samples))
            return tuple(np.stack([np.asarray(x) for x in col]) for col in cols)
        if isinstance(first, dict):
            return {k: np.stack([np.asarray(s[k]) for s in samples]) for k in first}
        return np.stack([np.asarray(s) for s in samples])

    def _advance(self, n_local):
        """Account ``n_local`` samples yielded to THIS rank: every other
        replica consumed the same count in the same global batch."""
        if hasattr(self.data_sampler, "advance"):
            replicas = getattr(self.data_sampler, "num_replicas", self.dp_world_size)
            self.data_sampler.advance(n_local * replicas)

    def _create_dataloader(self):
        collate = self.collate_fn or self._default_collate

        def gen():
            buf = []
            for idx in iter(self.data_sampler):
                buf.append(self.dataset[idx])
                if len(buf) == self.batch_size:
                    batch = collate(buf)
                    self._advance(len(buf))
                    buf = []
                    yield batch
            if buf and not self.drop_last:
                batch = collate(buf)
                self._advance(len(buf))
                yield batch

        self.data = gen()
        return self.data

    # -- checkpoint state ----------------------------------------------
    def state_dict(self):
        """Resume coordinate for the data stream: the sampler's consumed
        count + RNG configuration (see ``DistributedSampler``); custom
        samplers contribute their own ``state_dict``."""
        sd = {"batch_size": self.batch_size}
        if hasattr(self.data_sampler, "state_dict"):
            sd["sampler"] = self.data_sampler.state_dict()
        return sd

    def load_state_dict(self, sd):
        if not sd:
            return
        if sd.get("batch_size") not in (None, self.batch_size):
            logger.warning(f"[dataloader] resuming with micro-batch "
                           f"{self.batch_size} != checkpointed {sd['batch_size']}")
        sampler_sd = sd.get("sampler")
        if sampler_sd is not None and hasattr(self.data_sampler, "load_state_dict"):
            try:
                # DistributedSampler re-targets the current replica layout
                self.data_sampler.load_state_dict(
                    sampler_sd, num_replicas=self.dp_world_size, rank=self.dp_rank)
            except TypeError:
                self.data_sampler.load_state_dict(sampler_sd)
        # any in-flight iterator predates the restored coordinate
        self.data = None
