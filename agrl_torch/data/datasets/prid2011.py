"""PRID2011 catalog (copy of
agrl_tpu/data/datasets/prid2011.py).

Behavioral parity with reference data_manager/prid2011.py:22-144:
  * 10-fold splits read from splits_prid2011.json (ships with the data);
  * tracklet dirs under prid_2011/multi_shot/cam_{a,b};
  * query = test ids' cam_a tracklets, gallery = cam_b.
"""

from __future__ import annotations

import os.path as osp

from agrl_torch.data.datasets.base import VidReidDataset, scan_two_camera_dirs
from agrl_torch.utils.iotools import read_json


class PRID2011(VidReidDataset):
    name = "prid2011"

    def __init__(self, root="data", split_id=0, min_seq_len=0, verbose=True, use_pose=True, **kwargs):
        super().__init__()
        self.dataset_dir = osp.join(root, "prid2011")
        self.split_path = osp.join(self.dataset_dir, "splits_prid2011.json")
        self.cam_a_path = osp.join(self.dataset_dir, "prid_2011", "multi_shot", "cam_a")
        self.cam_b_path = osp.join(self.dataset_dir, "prid_2011", "multi_shot", "cam_b")

        self._require(self.dataset_dir)
        self._load_poses(osp.join(self.dataset_dir, "pose.json"), use_pose)

        splits = read_json(self.split_path)
        if split_id >= len(splits):
            raise ValueError(
                f"split_id exceeds range, received {split_id}, "
                f"but expected between 0 and {len(splits) - 1}"
            )
        split = splits[split_id]
        train_dirs, test_dirs = split["train"], split["test"]
        print(f"# train identites: {len(train_dirs)}, # test identites {len(test_dirs)}")

        cams = (self.cam_a_path, self.cam_b_path)
        self.train, _, self.num_train_pids, n_train = scan_two_camera_dirs(
            train_dirs, cams, (True, True)
        )
        self.query, _, self.num_query_pids, n_query = scan_two_camera_dirs(
            test_dirs, cams, (True, False)
        )
        self.gallery, _, self.num_gallery_pids, n_gallery = scan_two_camera_dirs(
            test_dirs, cams, (False, True)
        )
        if verbose:
            self.print_stats("PRID2011", n_train + n_query + n_gallery)
