"""Materialize a synthetic dataset in the EXACT on-disk MARS layout (copy
of agrl_tpu/data/datasets/synthetic_mars.py: the same bytes for the same
arguments).

Unlike datasets/synthetic.py (a standalone catalog for smoke tests), this
writes the real MARS file structure the reference's own catalog
(reference data_manager/mars.py:36-89) reads:

    <root>/mars/info/train_name.txt          frame basenames, one per line
    <root>/mars/info/test_name.txt
    <root>/mars/info/tracks_train_info.mat   'track_train_info' (N, 4)
    <root>/mars/info/tracks_test_info.mat    'track_test_info'  (M, 4)
    <root>/mars/info/query_IDX.mat           'query_IDX' 1-based rows
    <root>/mars/pose.json                    AlphaPose-style best bodies
    <root>/mars/bbox_train/<pid>/<name>.jpg  real JPEG frames
    <root>/mars/bbox_test/<pid>/<name>.jpg

so every framework (the imported reference, agrl_tpu, agrl_torch) can catalog,
decode, and evaluate the SAME bytes — the substrate for whole-pipeline
cross-framework parity tests.

The content is deliberately DISCRIMINATIVE-but-confusable, not trivially
separable: each identity is a 3-band "person" (head / torso / legs) whose
band colors are drawn from a small shared palette (distinct ids share
bands), with identity texture on the torso, a per-camera color gain +
brightness nuisance, and per-frame jitter/noise. A converged small model
lands in an informative mAP band (not 100%), so ranking-quality
regressions of a few mAP points are visible.
"""

from __future__ import annotations

import json
import os.path as osp

import numpy as np

from agrl_torch.utils.iotools import mkdir_if_missing

# a small shared palette: distinct identities share band colors, which is
# what makes the fixture confusable (hard pairs differ in one band only)
_PALETTE = np.array(
    [
        [190, 60, 50],   # red
        [55, 110, 185],  # blue
        [60, 160, 70],   # green
        [200, 180, 60],  # yellow
    ],
    dtype=np.float32,
)

# head 0-22%, torso 22-55%, legs 55-100% of the crop height
_BANDS = (0.0, 0.22, 0.55, 1.0)


def _appearance(pid: int, rng: np.random.RandomState):
    """Identity = (head, torso, legs) palette picks + jitter + texture.

    Consecutive pids share two of three bands by construction, so the
    nearest-confuser for every identity differs in a single band; the
    jitter is small (+-4) so shared bands are nearly identical — what
    separates confusers must survive the camera nuisance + occlusion."""
    k = len(_PALETTE)
    head = _PALETTE[pid % k]
    torso = _PALETTE[(pid // 2) % k]
    legs = _PALETTE[(pid // 4 + pid) % k]
    jitter = rng.uniform(-4, 4, (3, 3)).astype(np.float32)
    freq = 2 + (pid % 3)  # torso texture frequency, shared across ids
    return np.stack([head, torso, legs]) + jitter, freq


def _cam_nuisance(camid: int, rng: np.random.RandomState):
    """Per-camera color gain + brightness (the cross-camera gap). Strong
    on purpose: the MARS protocol scores CROSS-camera matches only, so
    the tint is what a model must learn invariance to."""
    gain = 1.0 + rng.uniform(-0.35, 0.35, 3).astype(np.float32)
    bright = rng.uniform(-35, 35)
    return gain, bright


def _render_frame(colors, freq, gain, bright, rng, height, width):
    img = np.empty((height, width, 3), np.float32)
    # background margins (constant gray): resize has real content to blend
    img[:] = 110.0
    x0, x1 = int(width * 0.12), int(width * 0.88)
    edges = [
        int(height * b + rng.uniform(-0.03, 0.03) * height) for b in _BANDS
    ]
    edges[0], edges[-1] = 0, height
    for b in range(3):
        lo, hi = max(0, edges[b]), min(height, edges[b + 1])
        img[lo:hi, x0:x1] = colors[b]
    # identity texture on the torso (vertical stripes, random phase)
    t_lo, t_hi = max(0, edges[1]), min(height, edges[2])
    xs = np.arange(width, dtype=np.float32)
    phase = rng.uniform(0, 2 * np.pi)
    stripe = 18.0 * np.sin(2 * np.pi * freq * xs / width + phase)
    img[t_lo:t_hi, x0:x1] += stripe[None, x0:x1, None]
    # random occlusion: a gray box over part of the person (real re-id
    # ambiguity — an occluded band removes the cue that separates the
    # nearest confuser)
    if rng.rand() < 0.35:
        oh = int(height * rng.uniform(0.15, 0.4))
        oy = rng.randint(0, height - oh)
        img[oy : oy + oh, x0:x1] = rng.uniform(80, 140)
    # camera nuisance then per-frame sensor noise
    img = img * gain[None, None, :] + bright
    img += rng.normal(0, 18.0, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _pose_body(rng, width, height):
    """18 AlphaPose keypoints laid out like the rendered person (head kps
    in the head band, etc.), flat [x, y, conf] * 18 list + score."""
    bands_for_kp = {
        **{k: (0.02, 0.20) for k in (0, 1, 14, 15, 16, 17)},  # head
        **{k: (0.24, 0.52) for k in (2, 3, 4, 5, 6, 7)},      # body
        **{k: (0.58, 0.97) for k in (8, 9, 10, 11, 12, 13)},  # leg
    }
    joints = []
    for k in range(18):
        lo, hi = bands_for_kp[k]
        x = rng.uniform(0.2, 0.8) * width
        y = rng.uniform(lo, hi) * height
        # occasionally below the 0.1 confidence threshold (exercised in
        # reference dataset_loader.py:321)
        conf = rng.uniform(0.3, 0.95) if rng.rand() > 0.12 else rng.uniform(0.0, 0.08)
        joints += [float(x), float(y), float(conf)]
    return {"joints": joints, "score": float(rng.uniform(1.0, 3.0))}


def materialize_mars_layout(
    root: str,
    num_train_pids: int = 4,
    num_test_pids: int = 6,
    num_cams: int = 2,
    tracklets_per_cam: int = 1,
    frames_range=(6, 10),
    height: int = 128,
    width: int = 64,
    seed: int = 0,
    include_junk: bool = True,
    pose_dropout: float = 0.05,
) -> str:
    """Write the dataset; returns the `<root>/mars` directory.

    Test pids are offset by 500 so raw train/test pids are disjoint (as in
    real MARS). Every test pid appears under every camera, so each query
    (its cam-1 tracklet) has cross-camera good matches. `include_junk`
    adds one pid=-1 noise tracklet to the gallery (reference keeps junk
    tracklets in the gallery and evaluate_mars filters them, rank.py:169).
    `pose_dropout`: fraction of frames left OUT of pose.json (both
    frameworks must fall back to an empty part set, dataset_loader.py:
    332-333)."""
    from scipy.io import savemat
    from PIL import Image

    rng = np.random.RandomState(seed)
    mars = osp.join(root, "mars")
    info = osp.join(mars, "info")
    mkdir_if_missing(info)

    cam_nuis = {c: _cam_nuisance(c, rng) for c in range(1, num_cams + 1)}
    poses = {}

    def write_split(home_dir, pid_values):
        names, tracks = [], []
        tid = 0
        for pid in pid_values:
            pid_str = f"{pid:04d}" if pid >= 0 else "00-1"
            colors, freq = _appearance(max(pid, 0), np.random.RandomState(1000 + pid))
            # junk (pid -1) is a single noise tracklet, not one per camera
            cams = [1] if pid < 0 else range(1, num_cams + 1)
            per_cam = 1 if pid < 0 else tracklets_per_cam
            for cam in cams:
                for _ in range(per_cam):
                    tid += 1
                    n = int(rng.randint(frames_range[0], frames_range[1] + 1))
                    start = len(names) + 1  # 1-based inclusive
                    gain, bright = cam_nuis[cam]
                    for f in range(n):
                        name = f"{pid_str}C{cam}T{tid:04d}F{f + 1:03d}.jpg"
                        names.append(name)
                        fdir = osp.join(mars, home_dir, pid_str)
                        mkdir_if_missing(fdir)
                        if pid < 0:
                            img = rng.randint(0, 255, (height, width, 3)).astype(np.uint8)
                        else:
                            img = _render_frame(
                                colors, freq, gain, bright, rng, height, width
                            )
                        Image.fromarray(img).save(
                            osp.join(fdir, name), quality=90
                        )
                        if rng.rand() >= pose_dropout:
                            poses[name] = {"bodies": [_pose_body(rng, width, height)]}
                    tracks.append([start, len(names), int(pid), cam])
        return names, np.asarray(tracks, np.int64)

    train_names, track_train = write_split(
        "bbox_train", range(1, num_train_pids + 1)
    )
    test_pids = list(range(501, 501 + num_test_pids)) + ([-1] if include_junk else [])
    test_names, track_test = write_split("bbox_test", test_pids)

    with open(osp.join(info, "train_name.txt"), "w") as f:
        f.write("\n".join(train_names) + "\n")
    with open(osp.join(info, "test_name.txt"), "w") as f:
        f.write("\n".join(test_names) + "\n")
    savemat(osp.join(info, "tracks_train_info.mat"), {"track_train_info": track_train})
    savemat(osp.join(info, "tracks_test_info.mat"), {"track_test_info": track_test})
    # query = every real test pid's first cam-1 tracklet (1-based rows)
    query_rows = []
    for pid in test_pids:
        if pid < 0:
            continue
        rows = np.flatnonzero((track_test[:, 2] == pid) & (track_test[:, 3] == 1))
        query_rows.append(int(rows[0]) + 1)
    savemat(
        osp.join(info, "query_IDX.mat"),
        {"query_IDX": np.asarray(query_rows, np.int64)[None, :]},
    )
    with open(osp.join(mars, "pose.json"), "w") as f:
        json.dump(poses, f)
    return mars
