"""Clip decode and on-device preprocessing (counterpart of
agrl_tpu/data/transforms.py).

Host side decodes and resizes frames (`host_decode_resize`): through the
batched libjpeg decoder (`data/jpeg_native.py`) or PIL (bilinear, as the
reference's reader + GroupResize do, dataset_loader.py:23-36 and
train_vidreid_xent_htri.py:216), with agrl_tpu's three decode modes and
its RAM and disk frame caches (`data/cache.py`). The device side turns
the uint8 (B, S, H, W, 3) batch into normalized float32 with the ImageNet
constants, and in training flips whole clips (one decision per clip, as
GroupOperation draws one parameter per clip). Random erasing, random crop
and misalign augmentation are not ported yet (ROADMAP A2): the paper
recipe uses none of them.
"""

from __future__ import annotations

import os.path as osp

import numpy as np
import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
DECODE_MODES = ("auto", "native", "pil")


def host_decode_resize(
    paths, height: int, width: int, cache=None, disk_cache=None,
    threads: int = 1, decode: str = "auto",
) -> tuple[np.ndarray, list]:
    """Read + resize frames on the host. Returns (S, H, W, 3) uint8 and the
    ORIGINAL (w, h) sizes (the graph builder needs them); agrl_tpu's
    function (agrl_tpu/data/transforms.py:40-127) line for line.

    `decode`: which decoder produces the pixels —
      * "auto"   — the native libjpeg decoder when it is built, PIL
        otherwise;
      * "pil"    — PIL: bit-identical to the reference's reader +
        GroupResize, the choice for a migrated reference checkpoint (the
        native DCT-scaled downscale drifts a few gray levels from PIL);
      * "native" — the native decoder or an error (unbuilt library, or a
        frame that is not a JPEG).
    Frames the native decoder fails on are retried through the robust PIL
    reader.

    `cache`: optional {path: (img_u8, (w, h))} mapping (a dict or a
    data.cache.BoundedCache), consulted first; `disk_cache`: optional
    data.cache.FrameDiskCache, consulted next. Decoded frames are written
    back to both, so a repeat epoch decodes nothing. Each distinct path is
    decoded once, and every source fills rows of one preallocated clip
    array in place (disk hits through preadv). The caches hold DECODED
    pixels: a FrameDiskCache records its decoder tag (`effective_decoder`)
    and never serves the other decoder's pixels; a RAM cache lives for one
    run, whose decode mode is fixed.

    `threads`: the native decoder's OpenMP width (0 = hardware default;
    1 when the caller already decodes on a thread pool)."""
    if cache is None and disk_cache is None:
        return _decode_batch(paths, height, width, threads, decode)

    n = len(paths)
    out = np.empty((n, height, width, 3), np.uint8)
    sizes: list = [None] * n
    missing: list[int] = []
    for i, p in enumerate(paths):
        v = cache.get(p) if cache is not None else None
        if v is None:
            missing.append(i)
        else:
            out[i] = v[0]
            sizes[i] = v[1]
    if missing and disk_cache is not None:
        got = disk_cache.read_many_into([paths[i] for i in missing], out, missing)
        still = []
        for k, i in enumerate(missing):
            if got[k] is None:
                still.append(i)
            else:
                sizes[i] = got[k]
                if cache is not None:
                    # its own copy: a view would pin the whole clip array in
                    # the LRU under one frame's accounting
                    cache[paths[i]] = (out[i].copy(), got[k])
        missing = still
    if missing:
        # each distinct path once (dense padding repeats frames)
        uniq = list(dict.fromkeys(paths[i] for i in missing))
        imgs_m, sizes_m = _decode_batch(uniq, height, width, threads, decode)
        by_path = {p: j for j, p in enumerate(uniq)}
        for i in missing:
            j = by_path[paths[i]]
            out[i] = imgs_m[j]
            sizes[i] = sizes_m[j]
        for p, j in by_path.items():
            if cache is not None:
                cache[p] = (imgs_m[j].copy(), sizes_m[j])
            if disk_cache is not None:
                disk_cache.put(p, imgs_m[j], sizes_m[j])
    return out, sizes


def _native_unbuilt_error() -> RuntimeError:
    from agrl_torch.data import jpeg_native

    return RuntimeError(
        "decode='native' but the native decoder is not built: "
        f"{jpeg_native.why_unavailable()}"
    )


def effective_decoder(decode: str) -> str:
    """Which decoder a run's JPEG pixels come from: 'native' unless PIL
    was asked for or the native decoder cannot be built. The tag
    `FrameDiskCache` keeps its store single-decoder with. (Frames that are
    not JPEGs decode through PIL in every mode.)

    decode='native' with the decoder unbuilt raises HERE, before any
    FrameDiskCache opens: opening a native-tagged store under a fallback
    'pil' tag would wipe it for a run that fails at its first decode."""
    from agrl_torch.data import jpeg_native

    if decode not in DECODE_MODES:
        raise ValueError(f"decode must be one of {DECODE_MODES}, got {decode!r}")
    if decode == "pil":
        return "pil"
    if not jpeg_native.available():
        if decode == "native":
            raise _native_unbuilt_error()
        return "pil"
    return "native"


def _is_jpeg(path: str) -> bool:
    return path.lower().endswith((".jpg", ".jpeg"))


def _decode_batch(paths, height: int, width: int, threads: int = 1,
                  decode: str = "auto") -> tuple[np.ndarray, list]:
    from agrl_torch.data import jpeg_native

    if decode == "native":
        if not jpeg_native.available():
            raise _native_unbuilt_error()
        bad = next((p for p in paths if not _is_jpeg(p)), None)
        if bad is not None:
            raise ValueError(
                f"decode='native' but '{bad}' is not a JPEG; the native decoder only "
                "handles .jpg/.jpeg — use --decode auto or pil for this dataset"
            )
    if decode != "pil" and all(_is_jpeg(p) for p in paths) and jpeg_native.available():
        imgs, sizes, ok = jpeg_native.decode_resize_batch(paths, height, width, threads=threads)
        for i in np.flatnonzero(~ok):  # corrupt or missing -> the robust PIL reader
            imgs[i], sizes[i] = _pil_decode_one(paths[i], height, width)
        return imgs, [tuple(s) for s in sizes]

    frames, sizes = [], []
    for p in paths:
        img, size = _pil_decode_one(p, height, width)
        sizes.append(size)
        frames.append(img)
    return np.stack(frames), sizes


def _pil_decode_one(path: str, height: int, width: int):
    from PIL import Image

    img = robust_read(path)
    return np.asarray(img.resize((width, height), Image.BILINEAR)), img.size


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
