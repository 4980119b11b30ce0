"""Clip dataset + sequential batched loader for evaluation (counterpart
of agrl_tpu/data/loader.py, `evenly` sampling).

Item contract (parity with dataset_loader.py:83-215): imgs (S, H, W, 3)
uint8, pid, camid, adj (V, V) float32; enable_pose=False -> all-ones
adjacency. Frames are decoded with PIL; agrl_tpu's RAM/disk frame caches,
native decoder and the other sampling strategies follow in later slices.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

from agrl_torch.data.graph import GraphBuilder
from agrl_torch.data.pose import pose_key_for_path
from agrl_torch.data.sampling import sample_clip_indices
from agrl_torch.data.transforms import host_decode_resize


class VideoClipDataset:
    """Host-side per-tracklet item assembly."""

    def __init__(
        self,
        tracklets: list,
        seq_len: int = 8,
        sample: str = "evenly",
        height: int = 256,
        width: int = 128,
        pose_info: dict | None = None,
        num_split: int = 4,
        num_parts: int = 3,
        num_scale: int = 1,
        pyramid_part: bool = True,
        enable_pose: bool = True,
        max_len: int = 1000,
    ):
        if sample != "evenly":
            raise NotImplementedError(f"sample={sample!r} is not ported yet (evenly only)")
        self.tracklets = tracklets
        self.seq_len = seq_len
        self.sample = sample
        self.height = height
        self.width = width
        self.pose_info = pose_info if pose_info is not None else {}
        self.max_len = max_len
        self.graph_builder = GraphBuilder(
            num_split=num_split,
            num_parts=num_parts,
            num_scale=num_scale,
            pyramid_part=pyramid_part,
            enable_pose=enable_pose,
        )

    def __len__(self):
        return len(self.tracklets)

    @property
    def num_vertices(self):
        return self.graph_builder.num_vertices(self.seq_len)

    def _clip_adj(self, paths, sizes):
        if not self.graph_builder.enable_pose:
            return self.graph_builder.ones(len(paths))
        keys = []
        for p in paths:
            try:
                keys.append(pose_key_for_path(p))
            except ValueError:
                keys.append(None)  # unparseable path -> empty part sets
        # missing/malformed poses degrade per frame (reference fallback,
        # dataset_loader.py:332-333) — from_pose_dict owns that contract
        return self.graph_builder.from_pose_dict(keys, sizes, self.pose_info)

    def get_item(self, index: int):
        img_paths, pid, camid = self.tracklets[index]
        num = min(len(img_paths), self.max_len)
        indices = sample_clip_indices(num, self.seq_len, self.sample, None, self.max_len)
        chosen = [img_paths[int(i)] for i in indices]
        imgs, sizes = host_decode_resize(chosen, self.height, self.width)
        return imgs, pid, camid, self._clip_adj(chosen, sizes)


class ClipLoader:
    """Sequential batched iterator over a VideoClipDataset, yielding
    (imgs_u8 (B, S, H, W, 3), pids (B,), camids (B,), adjs (B, V, V));
    the last batch may be short. `num_workers` > 1 decodes the items of a
    batch on a thread pool (PIL releases the interpreter lock)."""

    def __init__(self, dataset: VideoClipDataset, batch_size: int, num_workers: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)

    def __len__(self):
        return -(-len(self.dataset) // self.batch_size)

    def __iter__(self):
        n = len(self.dataset)
        pool = ThreadPoolExecutor(self.num_workers) if self.num_workers > 1 else None
        try:
            for start in range(0, n, self.batch_size):
                idxs = range(start, min(start + self.batch_size, n))
                get = self.dataset.get_item
                items = list(pool.map(get, idxs)) if pool else [get(i) for i in idxs]
                yield self._collate(items)
        finally:
            if pool is not None:
                pool.shutdown(wait=True, cancel_futures=True)

    @staticmethod
    def _collate(items):
        imgs = np.stack([it[0] for it in items])
        pids = np.asarray([it[1] for it in items], dtype=np.int32)
        camids = np.asarray([it[2] for it in items], dtype=np.int32)
        adjs = np.stack([it[3] for it in items]).astype(np.float32)
        return imgs, pids, camids, adjs
