"""Shared catalog infrastructure (copy of agrl_tpu/data/datasets/base.py).

Every catalog exposes the reference's dataset contract: `.train/.query/
.gallery` as lists of (img_paths_tuple, pid, camid), `.num_train_pids`
(+query/gallery), and `.process_poses` ({image_key: (K,3) pose array}).

The stats table format matches the reference's console block
(e.g. data_manager/mars.py:99-111)."""

from __future__ import annotations

import os.path as osp

import numpy as np

from agrl_torch.data.pose import load_pose_json


class VidReidDataset:
    """Base class: pose loading, existence checks, stats printing."""

    name = "base"

    def __init__(self):
        self.train: list = []
        self.query: list = []
        self.gallery: list = []
        self.num_train_pids = 0
        self.num_query_pids = 0
        self.num_gallery_pids = 0
        self.process_poses: dict = {}

    # -- helpers ----------------------------------------------------------

    @staticmethod
    def _require(*paths: str) -> None:
        for p in paths:
            if not osp.exists(p):
                raise RuntimeError(f"'{p}' is not available")

    def _load_poses(self, pose_file: str, use_pose: bool = True) -> None:
        self.process_poses = load_pose_json(pose_file) if use_pose else {}

    def print_stats(
        self, title: str, num_imgs_per_tracklet,
        total_pids: int | None = None, total_tracklets: int | None = None,
    ) -> None:
        n = np.asarray(num_imgs_per_tracklet)
        if n.size == 0:
            raise ValueError(f"{title}: dataset has no tracklets (empty split?)")
        # default totals convention of ilidsvid/prid/duke (reference
        # ilidsvid.py:94-95); MARS overrides with train+gallery (mars.py:96-97)
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


def scan_two_camera_dirs(
    dirnames: list[str],
    cam_paths: tuple[str, str],
    cams: tuple[bool, bool],
    ext: str = "*.png",
):
    """iLIDS-VID / PRID2011 style: one directory of frames per (person,
    camera); pid = index within the split's dir list; query=cam1-only,
    gallery=cam2-only (ilidsvid.py:188-215, prid2011.py:117-144)."""
    import glob

    tracklets = []
    num_imgs = []
    dir2pid = {d: i for i, d in enumerate(dirnames)}
    for dirname in dirnames:
        for camid, (cam_path, enabled) in enumerate(zip(cam_paths, cams)):
            if not enabled:
                continue
            person_dir = osp.join(cam_path, dirname)
            img_names = sorted(glob.glob(osp.join(person_dir, ext)))
            assert len(img_names) > 0, f"no frames in {person_dir}"
            tracklets.append((tuple(img_names), dir2pid[dirname], camid))
            num_imgs.append(len(img_names))
    return tracklets, len(tracklets), len(dirnames), num_imgs
