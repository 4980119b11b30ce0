"""Clip decode and eval preprocessing (counterpart of
agrl_tpu/data/transforms.py, eval part).

Host side decodes and resizes frames with PIL (bilinear, as the
reference's reader + GroupResize do, dataset_loader.py:23-36 and
train_vidreid_xent_htri.py:216); the device side turns the uint8
(B, S, H, W, 3) batch into normalized float32 with the ImageNet
constants. The train augmentations (flip, erase, crop, misalign)
follow in a later slice.
"""

from __future__ import annotations

import os.path as osp

import numpy as np
import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def robust_read(path: str):
    """PIL RGB image; retries IO errors like the reference's reader."""
    from PIL import Image

    if not osp.exists(path):
        raise IOError(f"{path} does not exist")
    while True:
        try:
            return Image.open(path).convert("RGB")
        except IOError:
            print(f"IOError reading '{path}'; retrying.")


def host_decode_resize(paths, height: int, width: int) -> tuple[np.ndarray, list]:
    """Read + bilinear-resize frames. Returns (S, H, W, 3) uint8 and the
    ORIGINAL (w, h) sizes (the graph builder needs them)."""
    from PIL import Image

    frames, sizes = [], []
    for p in paths:
        img = robust_read(p)
        sizes.append(img.size)
        frames.append(np.asarray(img.resize((width, height), Image.BILINEAR)))
    return np.stack(frames), sizes


def preprocess_clips(imgs_u8: torch.Tensor) -> torch.Tensor:
    """Eval preprocessing on the tensor's device: (B, S, H, W, 3) uint8 ->
    float32 `(x / 255 - mean) / std`."""
    x = imgs_u8.to(torch.float32) / 255.0
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)
    return (x - mean) / std
