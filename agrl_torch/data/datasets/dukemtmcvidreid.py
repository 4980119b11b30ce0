"""DukeMTMC-VideoReID catalog (copy of
agrl_tpu/data/datasets/dukemtmcvidreid.py).

Behavioral parity with reference data_manager/dukemtmcvidreid.py:22-206:
  * walks train|query|gallery/<pid>/<tracklet>/*.jpg; frames re-ordered by
    the F#### index in the filename (some tracklets start at F0002 —
    missing indices are warned and skipped);
  * camid parsed from either naming format (0001C6F0099X30823.jpg or
    0001_C6_F0099_X30823.jpg);
  * result cached as split_{train,query,gallery}.json;
  * train pids relabeled; min_seq_len filter.
"""

from __future__ import annotations

import glob
import os.path as osp

from agrl_torch.data.datasets.base import VidReidDataset
from agrl_torch.utils.iotools import read_json, write_json


class DukeMTMCVidReID(VidReidDataset):
    name = "dukemtmcvidreid"

    def __init__(self, root="data", min_seq_len=0, verbose=True, use_pose=True, **kwargs):
        super().__init__()
        self.dataset_dir = osp.join(root, "dukemtmc-vidreid")
        base = osp.join(self.dataset_dir, "DukeMTMC-VideoReID")
        self.train_dir = osp.join(base, "train")
        self.query_dir = osp.join(base, "query")
        self.gallery_dir = osp.join(base, "gallery")
        self.min_seq_len = min_seq_len

        self._require(self.dataset_dir, self.train_dir, self.query_dir, self.gallery_dir)
        self._load_poses(osp.join(self.dataset_dir, "pose.json"), use_pose)

        self.train, _, self.num_train_pids, n_train = self._process_dir(
            self.train_dir, osp.join(self.dataset_dir, "split_train.json"), relabel=True
        )
        self.query, _, self.num_query_pids, n_query = self._process_dir(
            self.query_dir, osp.join(self.dataset_dir, "split_query.json"), relabel=False
        )
        self.gallery, _, self.num_gallery_pids, n_gallery = self._process_dir(
            self.gallery_dir, osp.join(self.dataset_dir, "split_gallery.json"), relabel=False
        )
        if verbose:
            self.print_stats("DukeMTMC-VideoReID", n_train + n_query + n_gallery)

    def _process_dir(self, dir_path, json_path, relabel):
        if osp.exists(json_path):
            print(f"=> {json_path} generated before, awesome!")
            split = read_json(json_path)
            return (
                [(tuple(p), pid, camid) for p, pid, camid in split["tracklets"]],
                split["num_tracklets"],
                split["num_pids"],
                split["num_imgs_per_tracklet"],
            )

        print("=> Generating split (may take a while the first time)")
        pdirs = glob.glob(osp.join(dir_path, "*"))
        print(f"Processing {dir_path} with {len(pdirs)} person identities")

        pid_container = {int(osp.basename(p)) for p in pdirs}
        pid2label = {pid: label for label, pid in enumerate(pid_container)}

        tracklets, num_imgs_per_tracklet = [], []
        for pdir in pdirs:
            pid = int(osp.basename(pdir))
            if relabel:
                pid = pid2label[pid]
            for tdir in glob.glob(osp.join(pdir, "*")):
                raw = glob.glob(osp.join(tdir, "*.jpg"))
                num_imgs = len(raw)
                if num_imgs < self.min_seq_len:
                    continue
                num_imgs_per_tracklet.append(num_imgs)
                img_paths = []
                for img_idx in range(num_imgs):
                    # frames may start at F0002; missing indices skipped
                    name = "F" + str(img_idx + 1).zfill(4)
                    res = glob.glob(osp.join(tdir, f"*{name}*.jpg"))
                    if not res:
                        print(f"Warn: index name {name} in {tdir} is missing, jump to next")
                        continue
                    img_paths.append(res[0])
                img_name = osp.basename(img_paths[0])
                if "_" not in img_name:
                    camid = int(img_name[5]) - 1  # 0001C6F0099X30823.jpg
                else:
                    camid = int(img_name[6]) - 1  # 0001_C6_F0099_X30823.jpg
                tracklets.append((tuple(img_paths), pid, camid))

        split = {
            "tracklets": [[list(p), pid, camid] for p, pid, camid in tracklets],
            "num_tracklets": len(tracklets),
            "num_pids": len(pid_container),
            "num_imgs_per_tracklet": num_imgs_per_tracklet,
        }
        print(f"Saving split to {json_path}")
        write_json(split, json_path)
        return tracklets, len(tracklets), len(pid_container), num_imgs_per_tracklet
