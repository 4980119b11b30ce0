"""P x K identity batch samplers (copy of agrl_tpu/data/samplers.py).

Parity targets (torchreid/samplers.py):
  RandomIdentitySampler   (:18-76) — chunk each pid's tracklet indices into
    groups of K; every batch draws P pids and pops one K-group per pid;
    pids leave the pool when exhausted; epoch ends when fewer than P pids
    remain. Exact P x K batch structure, no partial batches.
  RandomIdentitySamplerV1 (:79-111, the one all vmgn scripts use) — permute
    identities once, emit K instances per identity (with replacement if the
    pid has fewer than K tracklets); epoch length = num_ids * K.

Both yield flat index sequences; the loader chops them into batches.
For the same seed they yield agrl_tpu's index stream (same numpy
RandomState draws in the same order).
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np


class RandomIdentitySampler:
    def __init__(self, data_source, batch_size: int, num_instances: int, seed=None):
        self.batch_size = batch_size
        self.num_instances = num_instances
        self.num_pids_per_batch = batch_size // num_instances
        self.rng = np.random.RandomState(seed)
        self.index_dic: dict = defaultdict(list)
        for index, (_, pid, _) in enumerate(data_source):
            self.index_dic[pid].append(index)
        self.pids = list(self.index_dic.keys())

        self.length = 0
        for pid in self.pids:
            num = max(len(self.index_dic[pid]), num_instances)
            self.length += num - num % num_instances

    def __iter__(self):
        batch_idxs_dict = defaultdict(list)
        for pid in self.pids:
            idxs = list(self.index_dic[pid])
            if len(idxs) < self.num_instances:
                idxs = list(
                    self.rng.choice(idxs, size=self.num_instances, replace=True)
                )
            self.rng.shuffle(idxs)
            group = []
            for idx in idxs:
                group.append(int(idx))
                if len(group) == self.num_instances:
                    batch_idxs_dict[pid].append(group)
                    group = []

        avai_pids = list(self.pids)
        final_idxs = []
        while len(avai_pids) >= self.num_pids_per_batch:
            selected = self.rng.choice(
                len(avai_pids), self.num_pids_per_batch, replace=False
            )
            # iterate over a stable copy; removal happens after selection
            selected_pids = [avai_pids[i] for i in selected]
            for pid in selected_pids:
                final_idxs.extend(batch_idxs_dict[pid].pop(0))
                if not batch_idxs_dict[pid]:
                    avai_pids.remove(pid)
        return iter(final_idxs)

    def __len__(self):
        return self.length


class RandomIdentitySamplerV1:
    def __init__(self, data_source, num_instances: int = 4, seed=None, **kwargs):
        self.num_instances = num_instances
        self.rng = np.random.RandomState(seed)
        self.index_dic: dict = defaultdict(list)
        for index, (_, pid, _) in enumerate(data_source):
            self.index_dic[pid].append(index)
        self.pids = list(self.index_dic.keys())
        self.num_identities = len(self.pids)

    def __iter__(self):
        order = self.rng.permutation(self.num_identities)
        ret = []
        for i in order:
            candidates = self.index_dic[self.pids[int(i)]]
            replace = len(candidates) < self.num_instances
            picks = self.rng.choice(candidates, size=self.num_instances, replace=replace)
            ret.extend(int(p) for p in picks)
        return iter(ret)

    def __len__(self):
        return self.num_identities * self.num_instances


SAMPLER_REGISTRY = {
    "RandomIdentitySampler": RandomIdentitySampler,
    "RandomIdentitySamplerV1": RandomIdentitySamplerV1,
}


def init_sampler(name: str, data_source, batch_size: int, num_instances: int, seed=None):
    """Resolve a sampler by name (replaces the reference's eval() of the
    --train-sampler flag, train_vidreid_xent_htri.py:227)."""
    if name not in SAMPLER_REGISTRY:
        raise KeyError(f"Unknown sampler: {name}. Choices: {list(SAMPLER_REGISTRY)}")
    if batch_size < num_instances:
        # batch_size // num_instances == 0 would make RandomIdentitySampler
        # loop forever selecting zero pids per batch
        raise ValueError(
            f"batch_size ({batch_size}) must be >= num_instances ({num_instances})"
        )
    cls = SAMPLER_REGISTRY[name]
    if name == "RandomIdentitySamplerV1":
        return cls(data_source, num_instances=num_instances, seed=seed)
    return cls(data_source, batch_size=batch_size, num_instances=num_instances, seed=seed)
