"""Clip decode and on-device preprocessing (counterpart of
agrl_tpu/data/transforms.py).

Host side decodes and resizes frames (`host_decode_resize`): through the
batched libjpeg decoder (`data/jpeg_native.py`) or PIL (bilinear, as the
reference's reader + GroupResize do, dataset_loader.py:23-36 and
train_vidreid_xent_htri.py:216), with agrl_tpu's three decode modes and
its RAM and disk frame caches (`data/cache.py`). The device side turns
the uint8 (B, S, H, W, 3) batch into normalized float32 with the ImageNet
constants, and in training applies agrl_tpu's augmentations: misalign,
random crop and flips per clip (as GroupOperation draws one parameter per
clip), random erasing per frame, all on the device.
"""

from __future__ import annotations

import os.path as osp

import numpy as np
import torch
import torch.nn.functional as F

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


# misalign: the share of the height cropped or edge-padded
# (GroupMisAlignAugment, transforms.py:327-361); random crop: the window
# GroupRandomCrop((240, 120)) takes at 256x128 (the reference's train
# script, train_vidreid_xent_htri.py:198-200); random
# erasing: Zhong et al.'s area and aspect ranges and candidates drawn
MISALIGN_RATIO = 0.05
CROP_FRAC = (240 / 256, 120 / 128)
ERASE_AREA, ERASE_R1, ERASE_ATTEMPTS = (0.02, 0.4), 0.3, 10


def draw_misalign(B: int, generator: torch.Generator) -> torch.Tensor:
    """(B, 3) bool per clip: apply (p 0.5), top (else bottom), crop (else
    pad), agrl_tpu's three draws (`_misalign`)."""
    return torch.rand(B, 3, generator=generator) < 0.5


def crop_window(H: int, W: int) -> tuple[int, int]:
    return max(1, int(round(H * CROP_FRAC[0]))), max(1, int(round(W * CROP_FRAC[1])))


def draw_translate(B: int, H: int, W: int, generator: torch.Generator) -> torch.Tensor:
    """(B, 2) int64 per clip: the crop window's top and left offsets,
    uniform over the positions that fit (agrl_tpu's `_random_crop`)."""
    ch, cw = crop_window(H, W)
    return torch.stack([torch.randint(0, H - ch + 1, (B,), generator=generator),
                        torch.randint(0, W - cw + 1, (B,), generator=generator)], dim=1)


def draw_erase(B: int, S: int, H: int, W: int, generator: torch.Generator) -> torch.Tensor:
    """(B, S, 5) int64 per frame: apply (p 0.5), top, left, height, width
    of the rectangle (agrl_tpu's `_erase_mask`): ERASE_ATTEMPTS (area,
    aspect) candidates, the first that fits (0 < h < H, 0 < w < W) wins,
    none fitting erases nothing; the corner is uniform over where it fits."""
    lo, hi = ERASE_AREA
    area = (torch.rand(B, S, ERASE_ATTEMPTS, generator=generator) * (hi - lo) + lo) * (H * W)
    aspect = torch.rand(B, S, ERASE_ATTEMPTS, generator=generator) * (
        1 / ERASE_R1 - ERASE_R1) + ERASE_R1
    hs = torch.sqrt(area * aspect).to(torch.int64)
    ws = torch.sqrt(area / aspect).to(torch.int64)
    valid = (hs < H) & (ws < W) & (hs > 0) & (ws > 0)
    first = valid.to(torch.int8).argmax(dim=2, keepdim=True)
    fits = valid.any(dim=2)
    h = torch.where(fits, hs.gather(2, first)[..., 0], 0)
    w = torch.where(fits, ws.gather(2, first)[..., 0], 0)
    top = (torch.rand(B, S, generator=generator) * (H - h + 1)).to(torch.int64)
    left = (torch.rand(B, S, generator=generator) * (W - w + 1)).to(torch.int64)
    apply = (torch.rand(B, S, generator=generator) < 0.5).to(torch.int64)
    return torch.stack([apply, top, left, h, w], dim=2)


def _stretch(clips: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(n, S, h, w, C) -> (n, S, H, W, C) bilinear, half-pixel centres, as
    jax.image.resize(..., "bilinear"): antialiased where it shrinks (a
    triangle kernel widened by the scale), plain interpolation where it
    enlarges."""
    n, S, h, w, C = clips.shape
    x = clips.reshape(n * S, h, w, C).permute(0, 3, 1, 2)
    y = F.interpolate(x, size=(H, W), mode="bilinear", align_corners=False,
                      antialias=h > H or w > W)
    return y.permute(0, 2, 3, 1).reshape(n, S, H, W, C)


def _edge_pad(clips: torch.Tensor, d: int, top: bool) -> torch.Tensor:
    """Repeat the first (top) or last row d times along H (jnp.pad edge)."""
    edge = clips[:, :, :1] if top else clips[:, :, -1:]
    edge = edge.expand(-1, -1, d, -1, -1)
    return torch.cat([edge, clips] if top else [clips, edge], dim=2)


def misalign(x: torch.Tensor, draws: torch.Tensor) -> torch.Tensor:
    """GroupMisAlignAugment on (B, S, H, W, C) pixels in [0, 1]: per clip,
    with draws (B, 3) [apply, top, crop], crop d = max(int(0.05 H), 1)
    rows at the top or bottom, or edge-pad d rows there, and stretch back
    to (H, W). Each variant resizes only the clips that drew it."""
    B, S, H, W, C = x.shape
    d = max(int(H * MISALIGN_RATIO), 1)
    draws = torch.as_tensor(draws, dtype=torch.bool).cpu()
    if draws.shape != (B, 3):
        raise ValueError(f"misalign draws must be ({B}, 3) bool, got {tuple(draws.shape)}")
    out = x.clone()
    for crop in (True, False):
        for top in (True, False):
            sel = torch.nonzero(draws[:, 0] & (draws[:, 2] == crop) & (draws[:, 1] == top))
            if len(sel) == 0:
                continue
            sel = sel[:, 0].to(x.device)
            clips = x.index_select(0, sel)
            if crop:
                clips = clips[:, :, d:] if top else clips[:, :, :-d]
            else:
                clips = _edge_pad(clips, d, top)
            out.index_copy_(0, sel, _stretch(clips, H, W))
    return out


def translate(x: torch.Tensor, draws: torch.Tensor) -> torch.Tensor:
    """GroupRandomCrop((240, 120)) after the resize, on (B, S, H, W, C)
    pixels: per clip, the window at draws (B, 2) [top, left], stretched
    back to (H, W)."""
    B, S, H, W, C = x.shape
    ch, cw = crop_window(H, W)
    draws = torch.as_tensor(draws, dtype=torch.int64).cpu()
    if draws.shape != (B, 2) or (draws < 0).any() or (draws[:, 0] > H - ch).any() or (
            draws[:, 1] > W - cw).any():
        raise ValueError(f"translate draws must be ({B}, 2) window offsets within "
                         f"({H - ch}, {W - cw}), got {draws.tolist()}")
    windows = torch.stack([x[b, :, t:t + ch, l:l + cw] for b, (t, l) in
                           enumerate(draws.tolist())])
    return _stretch(windows, H, W)


def erase(x: torch.Tensor, draws: torch.Tensor) -> torch.Tensor:
    """Random erasing on normalized (B, S, H, W, C) clips, per frame, with
    draws (B, S, 5) [apply, top, left, h, w]: the rectangle takes
    IMAGENET_MEAN (the raw means, in post-normalization units, as the
    reference erases after GroupNormalize)."""
    B, S, H, W, C = x.shape
    draws = torch.as_tensor(draws, dtype=torch.int64)
    if draws.shape != (B, S, 5):
        raise ValueError(f"erase draws must be ({B}, {S}, 5), got {tuple(draws.shape)}")
    apply, top, left, h, w = draws.to(x.device)[..., None, None].unbind(2)
    rows = torch.arange(H, device=x.device)[:, None]
    cols = torch.arange(W, device=x.device)[None, :]
    mask = (apply > 0) & (rows >= top) & (rows < top + h) & (cols >= left) & (cols < left + w)
    fill = torch.tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device)
    return torch.where(mask[..., None], fill, x)


def preprocess_clips(
    imgs_u8: torch.Tensor,
    train: bool = False,
    flip_aug: bool = True,
    generator: torch.Generator | None = None,
    flip: torch.Tensor | None = None,
    rand_erase: bool = False,
    misalign_aug: bool = False,
    rand_translate: bool = False,
    misalign_draws: torch.Tensor | None = None,
    translate_draws: torch.Tensor | None = None,
    erase_draws: torch.Tensor | None = None,
) -> torch.Tensor:
    """(B, S, H, W, 3) uint8 -> float32 `(x / 255 - mean) / std` on the
    tensor's device, with agrl_tpu's train augmentations
    (agrl_tpu/data/transforms.py:216-330), in its order: misalign,
    translate (`rand_translate`, the CLI's --rand-crop) and flip on the
    pixels in [0, 1], then the normalization, then erasing.

    Each augmentation's draws are injected (`flip` (B,) bool,
    `misalign_draws`, `translate_draws`, `erase_draws`: see draw_*) or
    drawn from `generator` in that order (agrl_tpu draws them with
    jax.random, whose numbers torch cannot reproduce; the draws are small
    CPU tensors, the pixels stay on their device). Flips mirror whole
    clips along W, misalign and translate act per clip, erasing per frame.

    Without misalign and translate the normalization is
    fma(x, 1/255, -mean) * (1/std), the arithmetic XLA compiles agrl_tpu's
    into, so the pixels equal agrl_tpu's bit for bit; mirroring and
    erasing commute with it. A resize in between splits it into
    x * (1/255) and (x - mean) * (1/std) around the resize."""
    dev = imgs_u8.device
    B, S, H, W, _ = imgs_u8.shape
    misalign_aug, rand_translate, flip_aug, rand_erase = (
        train and on for on in (misalign_aug, rand_translate, flip_aug, rand_erase))
    undrawn = [on and d is None for on, d in ((misalign_aug, misalign_draws),
                                             (rand_translate, translate_draws),
                                             (flip_aug, flip), (rand_erase, erase_draws))]
    if generator is None and any(undrawn):
        raise ValueError("train augmentations need a torch.Generator or their injected draws")
    neg_mean = torch.from_numpy(-np.float32(IMAGENET_MEAN)).to(dev)
    inv_std = torch.from_numpy(np.float32(1.0) / np.float32(IMAGENET_STD)).to(dev)
    inv_255 = torch.tensor(np.float32(1.0 / 255.0), device=dev)
    if misalign_aug or rand_translate:
        x = imgs_u8.to(torch.float32) * inv_255
        if misalign_aug:
            if misalign_draws is None:
                misalign_draws = draw_misalign(B, generator)
            x = misalign(x, misalign_draws)
        if rand_translate:
            if translate_draws is None:
                translate_draws = draw_translate(B, H, W, generator)
            x = translate(x, translate_draws)
        x = (x + neg_mean) * inv_std
    else:
        # fma(x, 1/255, -mean) * (1/std): the arithmetic XLA compiles the
        # division into, so the pixels equal agrl_tpu's bit for bit
        x = torch.addcmul(neg_mean, imgs_u8.to(torch.float32), inv_255) * inv_std
    if flip_aug:
        if flip is None:
            flip = torch.rand(B, generator=generator) < 0.5
        flip = torch.as_tensor(flip, dtype=torch.bool).to(dev)
        if flip.shape != (B,):
            raise ValueError(f"flip must be ({B},) bool, got {tuple(flip.shape)}")
        x = torch.where(flip[:, None, None, None, None], x.flip(3), x)
    if rand_erase:
        if erase_draws is None:
            erase_draws = draw_erase(B, S, H, W, generator)
        x = erase(x, erase_draws)
    return x
