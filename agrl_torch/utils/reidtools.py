"""Re-id helpers: split pyramids and ranked-result visualization (copy of
agrl_tpu/utils/reidtools.py).

`calc_splits` parity: reference torchreid/utils/reidtools.py:13-15 —
for a power-of-two n it returns the divisor pyramid [n, n/2, ..., 1].
"""

from __future__ import annotations

import os.path as osp
import shutil

import numpy as np

from agrl_torch.utils.iotools import mkdir_if_missing


def calc_splits(num_split: int) -> list[int]:
    """Pyramid of split counts: 4 -> [4, 2, 1]; 1 -> [1]."""
    if num_split < 1 or num_split & (num_split - 1):
        raise ValueError(f"num_split must be a positive power of 2, got {num_split}")
    return [num_split >> i for i in range(num_split.bit_length())]


def visualize_ranked_results(
    distmat: np.ndarray,
    query: list,
    gallery: list,
    save_dir: str = "ranked_results",
    topk: int = 20,
) -> None:
    """Copy top-k ranked gallery tracklets per query into a directory tree.

    Parity with reference torchreid/utils/reidtools.py:18-80. `query` and
    `gallery` are lists of (img_paths, pid, camid) tracklet tuples.
    """
    num_q, num_g = distmat.shape
    if num_q != len(query) or num_g != len(gallery):
        raise ValueError(f"distmat {distmat.shape} does not match {len(query)} query and "
                         f"{len(gallery)} gallery tracklets")
    indices = np.argsort(distmat, axis=1)
    mkdir_if_missing(save_dir)

    def _cp_img_to(src, dst, rank: int, prefix: str) -> None:
        if isinstance(src, (tuple, list)):
            dst = osp.join(dst, f"{prefix}_top{rank:03d}")
            mkdir_if_missing(dst)
            for img_path in src:
                shutil.copy(img_path, dst)
        else:
            dst = osp.join(dst, f"{prefix}_top{rank:03d}_name_{osp.basename(src)}")
            shutil.copy(src, dst)

    for q_idx in range(num_q):
        qimg_path, qpid, qcamid = query[q_idx]
        # reference: tracklets key by their PARENT (tracklet) directory +
        # camid (reidtools.py:62-66) — frame basenames like 0001.png
        # repeat across tracklets and would collide
        if isinstance(qimg_path, (tuple, list)):
            qimg_index = osp.basename(osp.dirname(qimg_path[0]))
        else:
            qimg_index = osp.basename(qimg_path)
        qdir = osp.join(save_dir, f"id{qimg_index}_cam{qcamid}")
        mkdir_if_missing(qdir)
        _cp_img_to(qimg_path, qdir, rank=0, prefix="query")

        rank_idx = 1
        for g_idx in indices[q_idx, :]:
            gimg_path, gpid, gcamid = gallery[g_idx]
            invalid = (qpid == gpid) and (qcamid == gcamid)
            if not invalid:
                _cp_img_to(gimg_path, qdir, rank=rank_idx, prefix="gallery")
                rank_idx += 1
                if rank_idx > topk:
                    break
    print(f"Saved ranked results to {save_dir}")
