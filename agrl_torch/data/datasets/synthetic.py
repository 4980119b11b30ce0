"""Synthetic video re-id dataset — the test/bench fixture (copy of
agrl_tpu/data/datasets/synthetic.py; same frames, poses and layout for
the same arguments).

Generates (or fabricates in-memory) tiny tracklets with the same contract
as the real catalogs: (img_paths, pid, camid) tuples + a process_poses
dict. When `materialize=True` it writes real PNG frames and a pose.json
under `root/synthetic-mars/...` using the MARS path layout so the pose-key
rules and the image loader run the exact production code path.

The reference has no such fixture; this is the repo's synthetic-dataset
strategy.
"""

from __future__ import annotations

import os
import os.path as osp

import numpy as np

from agrl_torch.data.datasets.base import VidReidDataset


def _make_pose(rng, width, height):
    """A plausible standing pose: head high, legs low."""
    kps = np.zeros((18, 3))
    y_bands = {
        0: (0.05, 0.15), 1: (0.15, 0.25),
        2: (0.2, 0.3), 3: (0.3, 0.4), 4: (0.4, 0.5),
        5: (0.2, 0.3), 6: (0.3, 0.4), 7: (0.4, 0.5),
        8: (0.5, 0.6), 9: (0.65, 0.8), 10: (0.85, 0.98),
        11: (0.5, 0.6), 12: (0.65, 0.8), 13: (0.85, 0.98),
        14: (0.02, 0.1), 15: (0.02, 0.1), 16: (0.03, 0.12), 17: (0.03, 0.12),
    }
    for k, (lo, hi) in y_bands.items():
        kps[k, 0] = rng.uniform(0.2, 0.8) * width
        kps[k, 1] = rng.uniform(lo, hi) * height
        kps[k, 2] = rng.uniform(0.3, 0.9)
    return kps


class SyntheticVidReid(VidReidDataset):
    name = "synthetic"

    def __init__(
        self,
        root="data",
        num_pids=8,
        tracklets_per_pid=3,
        frames_per_tracklet=(6, 20),
        num_cams=3,
        height=128,
        width=64,
        seed=0,
        materialize=True,
        verbose=True,
        use_pose=True,
        **kwargs,
    ):
        super().__init__()
        rng = np.random.RandomState(seed)
        self.dataset_dir = osp.join(root, "synthetic-mars")
        self.height, self.width = height, width

        if num_cams < 2:
            # the MARS protocol keeps only cross-camera matches; a single
            # camera leaves every query without a valid gallery candidate
            raise ValueError("synthetic dataset needs num_cams >= 2")

        def build_split(split_name, relabelled_pids, cam_offset=0, file_pid_offset=0):
            # file_pid_offset keeps test-split BASENAMES disjoint from the
            # train split (real MARS has disjoint train/test raw pids), so
            # the basename-keyed pose dict never aliases across splits
            tracklets, num_imgs = [], []
            for pid in relabelled_pids:
                fpid = pid + file_pid_offset
                for t in range(tracklets_per_pid):
                    camid = int((t + cam_offset) % num_cams)
                    n = int(rng.randint(*frames_per_tracklet))
                    paths = tuple(
                        osp.join(
                            self.dataset_dir,
                            split_name,
                            f"{fpid:04d}",
                            f"{fpid:04d}C{camid + 1}T{t:04d}F{f:03d}.jpg",
                        )
                        for f in range(n)
                    )
                    tracklets.append((paths, pid, camid))
                    num_imgs.append(n)
            return tracklets, num_imgs

        self.train, n_train = build_split("bbox_train", range(num_pids))
        self.query, n_query = build_split(
            "bbox_test", range(num_pids), cam_offset=0, file_pid_offset=num_pids
        )
        self.gallery, n_gallery = build_split(
            "bbox_test", range(num_pids), cam_offset=1, file_pid_offset=num_pids
        )
        self.num_train_pids = num_pids
        self.num_query_pids = num_pids
        self.num_gallery_pids = num_pids

        # poses for every frame, keyed like MARS (basename)
        self.process_poses = {}
        if use_pose:
            for split in (self.train, self.query, self.gallery):
                for paths, _, _ in split:
                    for p in paths:
                        self.process_poses[osp.basename(p)] = _make_pose(
                            rng, width, height
                        )

        if materialize:
            self._write_frames(rng)
        if verbose:
            self.print_stats("Synthetic", n_train + n_query + n_gallery)

    def _write_frames(self, rng):
        """Write PNG-encoded JPG-named frames: per-pid base color + noise,
        so identity is visually recoverable (features can overfit)."""
        from PIL import Image

        for split in (self.train, self.query, self.gallery):
            for paths, pid, _ in split:
                base = np.array(
                    [((pid * 53) % 200) + 30, ((pid * 101) % 200) + 30, ((pid * 37) % 200) + 30]
                )
                for p in paths:
                    if osp.exists(p):
                        continue
                    os.makedirs(osp.dirname(p), exist_ok=True)
                    img = base[None, None, :] + rng.randint(
                        -20, 20, (self.height, self.width, 3)
                    )
                    Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(p)
