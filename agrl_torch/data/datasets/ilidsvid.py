"""iLIDS-VID catalog (copy of
agrl_tpu/data/datasets/ilidsvid.py).

Behavioral parity with reference data_manager/ilidsvid.py:22-215:
  * 300 ids / 600 tracklets / 2 cameras;
  * 10-fold splits converted once from train_test_splits_ilidsvid.mat to
    splits.json — indices are 1-based into the SORTED cam1 person dirs;
    first half of each row is the TEST set (Wang et al. ECCV'14);
  * query = test ids' cam1 tracklets, gallery = cam2;
  * optional auto-download of the original tar (reference
    ilidsvid.py:119-133) behind `download=True` — OFF by default (it
    needs network access; a deployment that has it can opt in).
"""

from __future__ import annotations

import glob
import os.path as osp

from agrl_torch.data.datasets.base import VidReidDataset, scan_two_camera_dirs
from agrl_torch.utils.iotools import read_json, write_json


class iLIDSVID(VidReidDataset):
    name = "ilidsvid"

    dataset_url = "http://www.eecs.qmul.ac.uk/~xiatian/iLIDS-VID/iLIDS-VID.tar"

    def __init__(self, root="data", split_id=0, verbose=True, use_pose=True,
                 download=False, **kwargs):
        super().__init__()
        self.dataset_dir = osp.join(root, "ilids-vid")
        self.data_dir = osp.join(self.dataset_dir, "i-LIDS-VID")
        self.split_dir = osp.join(self.dataset_dir, "train-test people splits")
        self.split_mat_path = osp.join(self.split_dir, "train_test_splits_ilidsvid.mat")
        self.split_path = osp.join(self.dataset_dir, "splits.json")
        self.cam_1_path = osp.join(self.data_dir, "sequences/cam1")
        self.cam_2_path = osp.join(self.data_dir, "sequences/cam2")

        if download:
            self._download_data()
        self._require(self.dataset_dir, self.data_dir, self.split_dir)
        self._load_poses(osp.join(self.dataset_dir, "pose.json"), use_pose)
        self._prepare_split()

        splits = read_json(self.split_path)
        if split_id >= len(splits):
            raise ValueError(
                f"split_id exceeds range, received {split_id}, "
                f"but expected between 0 and {len(splits) - 1}"
            )
        split = splits[split_id]
        train_dirs, test_dirs = split["train"], split["test"]
        print(f"# train identites: {len(train_dirs)}, # test identites {len(test_dirs)}")

        cams = (self.cam_1_path, self.cam_2_path)
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
            self.print_stats("iLIDS-VID", n_train + n_query + n_gallery)

    def _download_data(self) -> None:
        """Fetch + extract the original tar (reference ilidsvid.py:119-133).

        The presence check is CONTENT-based (the sequences + splits dirs
        the catalog actually reads) — the reference checks the bare
        dataset dir, which an interrupted download leaves behind,
        wedging every later attempt. The tar downloads to a `.part`
        name and is removed after extraction (or on failure), so a
        retry always re-fetches cleanly. Extraction goes into a temp
        directory that is PROMOTED by per-entry rename only after the
        whole tar extracted: an extraction interrupted partway can never
        leave both content dirs present-but-truncated (which would make
        the next run print 'already downloaded' over a broken tree)."""
        if osp.exists(self.data_dir) and osp.exists(self.split_dir):
            print("This dataset has been downloaded.")
            return
        import os
        import shutil
        import tarfile
        import urllib.request

        from agrl_torch.utils.iotools import mkdir_if_missing

        mkdir_if_missing(self.dataset_dir)
        fpath = osp.join(
            self.dataset_dir, osp.basename(self.dataset_url) + ".part"
        )
        tmp_dir = osp.join(self.dataset_dir, ".extract_tmp")
        print("Downloading iLIDS-VID dataset")
        try:
            urllib.request.urlretrieve(self.dataset_url, fpath)
            print("Extracting files")
            if osp.exists(tmp_dir):  # stale partial from an interrupted run
                shutil.rmtree(tmp_dir)
            with tarfile.open(fpath) as tar:
                # 'data' filter: refuse absolute paths / .. traversal / devices
                tar.extractall(path=tmp_dir, filter="data")
            # promote: per-entry rename. An interruption between renames
            # leaves at most ONE of (data_dir, split_dir) present, so the
            # content check above stays false and the next run re-extracts.
            for name in os.listdir(tmp_dir):
                dst = osp.join(self.dataset_dir, name)
                if osp.exists(dst):  # partial promote from a previous run
                    shutil.rmtree(dst)
                os.rename(osp.join(tmp_dir, name), dst)
        finally:
            if osp.exists(fpath):
                os.remove(fpath)
            if osp.exists(tmp_dir):
                shutil.rmtree(tmp_dir, ignore_errors=True)

    def _prepare_split(self):
        if osp.exists(self.split_path):
            return
        from scipy.io import loadmat

        print("Creating splits ...")
        mat = loadmat(self.split_mat_path)["ls_set"]
        num_splits, num_total_ids = mat.shape
        assert num_splits == 10 and num_total_ids == 300
        half = num_total_ids // 2

        person_dirs = sorted(
            osp.basename(d) for d in glob.glob(osp.join(self.cam_1_path, "*"))
        )
        person_dirs2 = sorted(
            osp.basename(d) for d in glob.glob(osp.join(self.cam_2_path, "*"))
        )
        assert set(person_dirs) == set(person_dirs2), "cam1/cam2 person mismatch"

        splits = []
        for row in mat:
            # first 50% test, rest train (Wang et al. ECCV'14); 1-based
            test_idxs = sorted(int(i) - 1 for i in row[:half])
            train_idxs = sorted(int(i) - 1 for i in row[half:])
            splits.append(
                {
                    "train": [person_dirs[i] for i in train_idxs],
                    "test": [person_dirs[i] for i in test_idxs],
                }
            )
        print(f"Totally {len(splits)} splits are created, following Wang et al. ECCV'14")
        write_json(splits, self.split_path)
