"""Deterministic multi-dataset distributed sampler.

Rebuild of VILADistributedSampler (llava/train/llava_trainer.py:129-241):
each constituent dataset is contiguously sharded per replica with
batch-aligned drop-last, shuffled with seed+epoch, then the per-dataset
index streams are interleaved evenly (largest dataset spread first) so a
global batch mixes datasets in stable proportions.  Deterministic given
(seed, epoch, rank).

The port's own copy of ``spatialrgpt_tpu/data/sampler.py``.
"""

from __future__ import annotations

import random
from typing import List, Sequence


class DistributedMixtureSampler:
    def __init__(
        self,
        sample_len_list: Sequence[int],
        num_replicas: int,
        rank: int,
        batch_size: int,
        seed: int = 0,
    ):
        assert 0 <= rank < num_replicas
        self.org_sample_len_list = list(sample_len_list)
        self.num_replicas = num_replicas
        self.rank = rank
        self.batch_size = batch_size
        self.seed = seed
        self.epoch = 0

        self.per_replica_samples = [
            n // (num_replicas * batch_size) * batch_size for n in sample_len_list
        ]
        self.num_samples = sum(self.per_replica_samples)
        self.total_samples = [n * num_replicas for n in self.per_replica_samples]

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return self.num_samples

    def __iter__(self):
        offsets = [0]
        for n in self.org_sample_len_list:
            offsets.append(offsets[-1] + n)

        # contiguous per-dataset slices, truncated to the droppable size
        indices_list: List[List[int]] = []
        for i in range(len(self.org_sample_len_list)):
            ds_indices = list(range(offsets[i], offsets[i] + self.total_samples[i]))
            # per-replica contiguous shard
            lo = self.rank * self.per_replica_samples[i]
            hi = (self.rank + 1) * self.per_replica_samples[i]
            indices_list.append(ds_indices[lo:hi])

        rnd = random.Random(self.seed + self.epoch)
        for sub in indices_list:
            rnd.shuffle(sub)

        # spread each dataset's stream evenly over the remaining slots,
        # longest first (reference llava_trainer.py:215-227)
        indices_list = sorted(indices_list, key=lambda x: -len(x))
        all_indices = [-1] * self.num_samples
        available = list(range(self.num_samples))
        for stream in indices_list:
            if not stream:
                continue
            transformed = [i * len(available) // len(stream) for i in range(len(stream))]
            mapped = [available[t] for t in transformed]
            for t in reversed(transformed):
                del available[t]
            for slot, idx in zip(mapped, stream):
                all_indices[slot] = idx
        assert -1 not in all_indices
        return iter(all_indices)
