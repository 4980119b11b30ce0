"""Clip decode and on-device preprocessing (counterpart of
agrl_tpu/data/transforms.py).

Host side decodes and resizes frames with PIL (bilinear, as the
reference's reader + GroupResize do, dataset_loader.py:23-36 and
train_vidreid_xent_htri.py:216); the device side turns the uint8
(B, S, H, W, 3) batch into normalized float32 with the ImageNet
constants, and in training flips whole clips (one decision per clip, as
GroupOperation draws one parameter per clip). Random erasing, random
crop and misalign augmentation are not ported yet: the paper recipe uses
none of them.
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


def preprocess_clips(
    imgs_u8: torch.Tensor,
    train: bool = False,
    flip_aug: bool = True,
    generator: torch.Generator | None = None,
    flip: torch.Tensor | None = None,
    rand_erase: bool = False,
    misalign_aug: bool = False,
    rand_translate: bool = False,
) -> torch.Tensor:
    """(B, S, H, W, 3) uint8 -> float32 `(x / 255 - mean) / std` on the
    tensor's device. With `train` and `flip_aug`, each clip is mirrored
    along W with probability 0.5: `flip` (B,) bool gives the decisions,
    else `generator` draws them (agrl_tpu draws them with jax.random, whose
    numbers torch cannot reproduce). Mirroring commutes with the
    per-channel normalization, so flipping after it gives agrl_tpu's
    pixels bit for bit."""
    for name, on in (("rand_erase", rand_erase), ("misalign_aug", misalign_aug),
                     ("rand_translate", rand_translate)):
        if train and on:
            raise NotImplementedError(f"{name} is not ported yet (a later slice; "
                                      "the paper recipe does not use it)")
    dev = imgs_u8.device
    neg_mean = torch.from_numpy(-np.float32(IMAGENET_MEAN)).to(dev)
    inv_std = torch.from_numpy(np.float32(1.0) / np.float32(IMAGENET_STD)).to(dev)
    # fma(x, 1/255, -mean) * (1/std): the arithmetic XLA compiles the
    # division into, so the pixels equal agrl_tpu's bit for bit
    x = torch.addcmul(neg_mean, imgs_u8.to(torch.float32),
                      torch.tensor(np.float32(1.0 / 255.0), device=dev)) * inv_std
    if not (train and flip_aug):
        return x
    B = x.shape[0]
    if flip is None:
        if generator is None:
            raise ValueError("train flips need a torch.Generator or explicit `flip`")
        flip = torch.rand(B, generator=generator) < 0.5
    flip = torch.as_tensor(flip, dtype=torch.bool).to(x.device)
    if flip.shape != (B,):
        raise ValueError(f"flip must be ({B},) bool, got {tuple(flip.shape)}")
    return torch.where(flip[:, None, None, None, None], x.flip(3), x)
