"""Shared catalog infrastructure (copy of agrl_tpu/data/datasets/base.py).

Every catalog exposes the reference's dataset contract: `.train/.query/
.gallery` as lists of (img_paths_tuple, pid, camid), `.num_train_pids`
(+query/gallery), and `.process_poses` ({image_key: (K,3) pose array}).

The stats table format matches the reference's console block
(e.g. data_manager/mars.py:99-111)."""

from __future__ import annotations

import numpy as np


class VidReidDataset:
    """Base class: the split lists, poses and the stats table."""

    name = "base"

    def __init__(self):
        self.train: list = []
        self.query: list = []
        self.gallery: list = []
        self.num_train_pids = 0
        self.num_query_pids = 0
        self.num_gallery_pids = 0
        self.process_poses: dict = {}

    def print_stats(
        self, title: str, num_imgs_per_tracklet,
        total_pids: int | None = None, total_tracklets: int | None = None,
    ) -> None:
        n = np.asarray(num_imgs_per_tracklet)
        if n.size == 0:
            raise ValueError(f"{title}: dataset has no tracklets (empty split?)")
        if total_pids is None:
            total_pids = self.num_train_pids + self.num_query_pids
        if total_tracklets is None:
            total_tracklets = len(self.train) + len(self.query) + len(self.gallery)
        print(f"=> {title} loaded")
        print("Dataset statistics:")
        print("  ------------------------------")
        print("  subset   | # ids | # tracklets")
        print("  ------------------------------")
        print(f"  train    | {self.num_train_pids:5d} | {len(self.train):8d}")
        print(f"  query    | {self.num_query_pids:5d} | {len(self.query):8d}")
        print(f"  gallery  | {self.num_gallery_pids:5d} | {len(self.gallery):8d}")
        print("  ------------------------------")
        print(f"  total    | {total_pids:5d} | {total_tracklets:8d}")
        print(
            "  number of images per tracklet: "
            f"{n.min()} ~ {n.max()}, average {n.mean():.1f}"
        )
        print("  ------------------------------")
