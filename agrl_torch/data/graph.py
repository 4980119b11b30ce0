"""Pose-guided adjacency construction — vectorized (copy of
agrl_tpu/data/graph.py).

Behavioral parity with the reference's graph pipeline
(torchreid/dataset_loader.py:218-404):

  1. Each of the 18 AlphaPose keypoints belongs to a body part
     (head / body / leg). Keypoints with confidence > threshold vote for the
     horizontal stripe their y-coordinate falls into: stripe id =
     bisect_right(arange(0, H+1, H/num_split), y), clamped to
     [1, num_split]   (dataset_loader.py:308-326).
  2. Each part's stripe set is made contiguous (min..max fill,
     dataset_loader.py:327-331).
  3. Pyramid extension: base stripe s additionally activates the coarser
     pyramid vertices ceil(s / 2^i) + (2^(k+1) - 2^(k+1-i)) for i = 1..k,
     k = log2(num_split)   (dataset_loader.py:354-368).
  4. All vertices sharing a part, across ALL frames of the clip, form a
     clique (off-diagonal 1s; method='same'); method='adjacent' additionally
     merges neighboring parts   (dataset_loader.py:371-388).
  5. Multi-scale expansion: block matrix with the adjacency on the diagonal
     blocks and identity off-diagonal   (dataset_loader.py:391-404).

Vertex ordering is frame-major: frame f's `total_split` pyramid vertices
occupy rows [f * total_split, (f+1) * total_split) — the same layout the
model's pyramid pooling produces (reference vmgn.py:305-308).

Everything here is NumPy on host: the computation is data-dependent,
string-keyed, and tiny (V <= ~64), but it is *batched over frames and
parts* instead of looping over keypoints/sets/permutations, which makes it
fast enough to never bottleneck the device input pipeline.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from agrl_torch.utils.reidtools import calc_splits

# AlphaPose/COCO-18 keypoint -> part id (0 head, 1 body, 2 leg)
# head: nose, neck, eyes, ears; body: shoulders/elbows/wrists; leg: hips/knees/ankles
KEYPOINT_PART = np.array(
    [0, 0, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 2, 2, 0, 0, 0, 0], dtype=np.int64
)
NUM_PARTS = 3


@lru_cache(maxsize=None)
def pyramid_expansion_map(num_split: int, pyramid_part: bool) -> np.ndarray:
    """Bool map (num_split, total_split): base stripe s-1 -> which pyramid
    vertices (0-based) it activates, including itself."""
    if not pyramid_part:
        return np.eye(num_split, dtype=bool)
    total_split = sum(calc_splits(num_split))
    k = int(np.log2(num_split))
    m = np.zeros((num_split, total_split), dtype=bool)
    for s in range(1, num_split + 1):
        m[s - 1, s - 1] = True
        for i in range(1, k + 1):
            pid = int(np.ceil(s / 2**i)) + (2 ** (k + 1) - 2 ** (k + 1 - i))
            m[s - 1, pid - 1] = True
    return m


def stripe_membership(
    poses: np.ndarray,
    heights: np.ndarray,
    num_split: int,
    threshold: float = 0.1,
) -> np.ndarray:
    """Vectorized stripe voting + contiguity fill.

    Args:
      poses: (S, 18, 3) keypoints as (x, y, confidence); rows of zeros (or a
        fully sub-threshold frame) reproduce the reference's
        missing-pose fallback (empty part sets).
      heights: (S,) original image heights (PIL size[1]).
    Returns: bool (S, NUM_PARTS, num_split) — part p of frame f contains
      base stripe b.
    """
    poses = np.asarray(poses, dtype=np.float64)
    heights = np.asarray(heights, dtype=np.float64)
    S = poses.shape[0]

    y = poses[..., 1]  # (S, 18)
    conf = poses[..., 2]
    # bisect_right(arange(0, H+1, H/num_split), y) = number of boundaries
    # <= y; computed with the same i*step boundary values for bit-exactness.
    step = heights / num_split  # (S,)
    bounds = np.arange(num_split + 1, dtype=np.float64)[None, :] * step[:, None]
    stripe = (y[:, :, None] >= bounds[:, None, :]).sum(axis=-1)
    stripe = np.clip(stripe, 1, num_split)  # (S, 18), 1-based
    valid = conf > threshold

    member = np.zeros((S, NUM_PARTS, num_split), dtype=bool)
    f_idx, k_idx = np.nonzero(valid)
    member[f_idx, KEYPOINT_PART[k_idx], stripe[f_idx, k_idx] - 1] = True

    # contiguity: fill min..max per (frame, part)
    any_part = member.any(axis=2)
    idx = np.arange(num_split)
    lo = np.where(member, idx, num_split).min(axis=2)  # (S, P)
    hi = np.where(member, idx, -1).max(axis=2)
    filled = (idx[None, None, :] >= lo[..., None]) & (idx[None, None, :] <= hi[..., None])
    return np.where(any_part[..., None], filled, False)


def build_adjacency(
    poses: np.ndarray,
    heights: np.ndarray,
    num_split: int = 4,
    num_parts: int = 3,
    num_scale: int = 1,
    pyramid_part: bool = True,
    threshold: float = 0.1,
    method: str = "same",
) -> np.ndarray:
    """Pose-guided adjacency for one clip. Returns float32 (V, V) with
    V = num_scale * seq_len * total_split."""
    if num_parts != NUM_PARTS:
        raise ValueError("only head/body/leg parts are defined")
    S = np.asarray(poses).shape[0]
    base = stripe_membership(poses, heights, num_split, threshold)  # (S,P,ns)
    pmap = pyramid_expansion_map(num_split, pyramid_part)  # (ns, ts)
    ext = base @ pmap  # bool matmul -> (S, P, total_split)
    total_split = pmap.shape[1]

    # frame-major vertex vector per part: (P, S*total_split)
    part_vertices = ext.transpose(1, 0, 2).reshape(NUM_PARTS, S * total_split)

    if method == "same":
        groups = part_vertices
    elif method == "adjacent":
        pair_union = part_vertices[:-1] | part_vertices[1:]
        groups = np.concatenate([part_vertices, pair_union], axis=0)
    else:
        raise ValueError(f"Unknown graph method: {method}")

    # clique per group, union over groups, zero diagonal
    adj = np.einsum("pi,pj->ij", groups.astype(np.float32), groups.astype(np.float32))
    adj = (adj > 0).astype(np.float32)
    np.fill_diagonal(adj, 0.0)

    return multiscale_expand(adj, num_scale)


def multiscale_expand(adj: np.ndarray, num_scale: int) -> np.ndarray:
    """Block matrix: adjacency on diagonal blocks, identity off-diagonal."""
    if num_scale == 1:
        return adj
    size = adj.shape[0]
    eye = np.eye(size, dtype=adj.dtype)
    rows = []
    for si in range(num_scale):
        rows.append(
            np.concatenate(
                [adj if si == sj else eye for sj in range(num_scale)], axis=1
            )
        )
    return np.concatenate(rows, axis=0)


class GraphBuilder:
    """Stateful builder: precomputes config-dependent maps, converts pose
    dicts from dataset catalogs into clip adjacencies.

    `enable_pose=False` reproduces the reference's all-ones fallback
    (dataset_loader.py:198-201, 209-212)."""

    def __init__(
        self,
        num_split: int = 4,
        num_parts: int = 3,
        num_scale: int = 1,
        pyramid_part: bool = True,
        enable_pose: bool = True,
        threshold: float = 0.1,
        method: str = "same",
    ):
        self.num_split = num_split
        self.num_parts = num_parts
        self.num_scale = num_scale
        self.pyramid_part = pyramid_part
        self.enable_pose = enable_pose
        self.threshold = threshold
        self.method = method
        self.total_split = (
            sum(calc_splits(num_split)) if pyramid_part else num_split
        )

    def num_vertices(self, seq_len: int) -> int:
        return self.num_scale * seq_len * self.total_split

    def ones(self, seq_len: int) -> np.ndarray:
        v = self.num_vertices(seq_len)
        return np.ones((v, v), dtype=np.float32)

    def __call__(self, poses: np.ndarray, heights: np.ndarray) -> np.ndarray:
        if not self.enable_pose:
            return self.ones(np.asarray(poses).shape[0])
        return build_adjacency(
            poses,
            heights,
            num_split=self.num_split,
            num_parts=self.num_parts,
            num_scale=self.num_scale,
            pyramid_part=self.pyramid_part,
            threshold=self.threshold,
            method=self.method,
        )

    def from_pose_dict(
        self,
        keys: list[str],
        sizes: list[tuple[int, int]],
        pose_dict: dict,
    ) -> np.ndarray:
        """Look up per-frame poses by key (missing OR malformed entries ->
        empty pose — the reference wraps per-frame pose processing in a
        bare except (dataset_loader.py:332-333), so a detector output with
        the wrong keypoint count degrades the frame's part sets instead of
        killing the loader)."""
        S = len(keys)
        poses = np.zeros((S, 18, 3), dtype=np.float64)
        for i, key in enumerate(keys):
            p = pose_dict.get(key)
            if p is not None:
                try:
                    arr = np.asarray(p, dtype=np.float64)[:18]
                    poses[i, : arr.shape[0]] = arr
                except (ValueError, IndexError, TypeError):
                    # ragged/short pose (ValueError/IndexError) or
                    # non-numeric content like JSON nulls (TypeError)
                    # -> empty part sets, matching the reference's
                    # bare-except degradation
                    pass
        heights = np.asarray([s[1] for s in sizes], dtype=np.float64)
        return self(poses, heights)
