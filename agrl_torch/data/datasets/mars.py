"""MARS catalog (copy of
agrl_tpu/data/datasets/mars.py).

Behavioral parity with reference data_manager/mars.py:20-180:
  * metadata from info/{train,test}_name.txt + tracks_{train,test}_info.mat
    + query_IDX.mat (1-based -> 0-based);
  * gallery = ALL test tracklets, query = the query_IDX subset;
  * train pids relabeled to 0..N-1; camid from 1..6 -> 0..5;
  * per-tracklet integrity asserts (single person, single camera);
  * min_seq_len filter.

Dataset statistics: 1261 ids; 8298 train / 1980 query / 9330 gallery
tracklets; 6 cameras.
"""

from __future__ import annotations

import os.path as osp

from agrl_torch.data.datasets.base import VidReidDataset


class Mars(VidReidDataset):
    name = "mars"

    def __init__(self, root="data", min_seq_len=0, verbose=True, use_pose=True, **kwargs):
        super().__init__()
        from scipy.io import loadmat

        self.dataset_dir = osp.join(root, "mars")
        info = lambda f: osp.join(self.dataset_dir, "info", f)  # noqa: E731
        self._require(
            self.dataset_dir,
            info("train_name.txt"),
            info("test_name.txt"),
            info("tracks_train_info.mat"),
            info("tracks_test_info.mat"),
            info("query_IDX.mat"),
        )
        self._load_poses(osp.join(self.dataset_dir, "pose.json"), use_pose)

        train_names = self._read_names(info("train_name.txt"))
        test_names = self._read_names(info("test_name.txt"))
        track_train = loadmat(info("tracks_train_info.mat"))["track_train_info"]
        track_test = loadmat(info("tracks_test_info.mat"))["track_test_info"]
        query_idx = loadmat(info("query_IDX.mat"))["query_IDX"].squeeze() - 1

        self.train, n_train_imgs = self._tracklets(
            train_names, track_train, "bbox_train", relabel=True, min_seq_len=min_seq_len
        )
        self.num_train_pids = len(set(track_train[:, 2].tolist()))
        self.query, _ = self._tracklets(
            test_names, track_test[query_idx], "bbox_test", relabel=False, min_seq_len=min_seq_len
        )
        self.num_query_pids = len(set(track_test[query_idx][:, 2].tolist()))
        self.gallery, n_gal_imgs = self._tracklets(
            test_names, track_test, "bbox_test", relabel=False, min_seq_len=min_seq_len
        )
        self.num_gallery_pids = len(set(track_test[:, 2].tolist()))

        if verbose:
            # MARS totals = train + gallery (reference mars.py:96-97)
            self.print_stats(
                "MARS", n_train_imgs + n_gal_imgs,
                total_pids=self.num_train_pids + self.num_gallery_pids,
                total_tracklets=len(self.train) + len(self.gallery),
            )

    @staticmethod
    def _read_names(fpath):
        with open(fpath, "r") as f:
            return [line.rstrip() for line in f]

    def _tracklets(self, names, meta, home_dir, relabel, min_seq_len):
        assert home_dir in ("bbox_train", "bbox_test")
        pid_list = list(set(meta[:, 2].tolist()))
        pid2label = {pid: label for label, pid in enumerate(pid_list)}
        tracklets, num_imgs = [], []
        for start, end, pid, camid in meta:
            assert 1 <= camid <= 6
            img_names = names[start - 1 : end]
            # integrity: one person, one camera per tracklet
            assert len({n[:4] for n in img_names}) == 1, (
                "Error: a single tracklet contains different person images"
            )
            assert len({n[5] for n in img_names}) == 1, (
                "Error: images are captured under different cameras!"
            )
            if len(img_names) < min_seq_len:
                continue
            paths = tuple(
                osp.join(self.dataset_dir, home_dir, n[:4], n) for n in img_names
            )
            label = pid2label[pid] if relabel else int(pid)
            tracklets.append((paths, label, int(camid) - 1))
            num_imgs.append(len(paths))
        return tracklets, num_imgs
