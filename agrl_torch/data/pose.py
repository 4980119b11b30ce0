"""AlphaPose pose.json loading and best-body selection (copy of
agrl_tpu/data/pose.py).

Parity: each of the reference's four catalogs duplicates the same block
(e.g. data_manager/mars.py:46-70): for every image key, if several bodies
were detected keep the one chosen by a score/area walk: a body replaces
the current pick only when its score exceeds 1.1x the best score so far
(the area term is vestigial in the reference — maxarea is never updated —
and is preserved as dead logic for exactness).

Also centralizes the image-path -> pose-key rules that the reference's
graph builder hardcodes per dataset (dataset_loader.py:249-258).
"""

from __future__ import annotations

import json

import numpy as np


def select_best_body(bodies: list[dict]) -> np.ndarray:
    """Pick one body's joints as an (K, 3) array of (x, y, confidence)."""
    if not bodies:
        raise ValueError("pose entry is empty")
    if len(bodies) == 1:
        return np.asarray(bodies[0]["joints"], dtype=np.float64).reshape(-1, 3)
    maxidx = -1
    maxarea = -1.0
    maxscore = -1.0
    for idx, body in enumerate(bodies):
        kps = np.asarray(body["joints"], dtype=np.float64).reshape(-1, 3)
        area = (kps[:, 0].max() - kps[:, 0].min()) * (kps[:, 1].max() - kps[:, 1].min())
        score = body["score"]
        if score > maxscore:
            # maxarea is never updated (reference quirk, kept): the area
            # test is always true, so this is a >1.1x score walk
            if area > maxarea and score > 1.1 * maxscore:
                maxscore = score
                maxidx = idx
    return np.asarray(bodies[maxidx]["joints"], dtype=np.float64).reshape(-1, 3)


def load_pose_json(pose_file: str) -> dict:
    """pose.json -> {image_key: (K, 3) array} with best-body selection."""
    with open(pose_file, "r") as f:
        raw = json.load(f)
    return {key: select_best_body(entry["bodies"]) for key, entry in raw.items()}


def pose_key_for_path(path: str) -> str:
    """Image path -> pose.json key (dataset inferred from the path).

    Rules (dataset_loader.py:249-258):
      ilids-vid : basename                       cam1_person238_02519.png
      prid2011  : last 3 components '-'-joined   cam_a-person_0115-0006.png
      mars      : basename                       0999C1T0001F002.jpg
      duke      : last 3 components '-'-joined   0148-0212-0148_C5_...jpg
    """
    parts = path.replace("\\", "/").split("/")
    if "ilids-vid" in path:
        return parts[-1]
    if "prid2011" in path:
        return "-".join(parts[-3:])
    if "mars" in path:
        return parts[-1]
    if "duke" in path:
        return "-".join(parts[-3:])
    raise ValueError(f"{path} is not from a known dataset layout")
