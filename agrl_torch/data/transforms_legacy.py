"""Legacy single-image transforms, host-side NumPy/PIL/SciPy (a copy of
agrl_tpu/data/transforms_legacy.py).

Behavioral parity with the reference's image-level ops
(torchreid/transforms.py:391-624), which serve the image re-id pipeline
and historical experiments. The video path preprocesses on the device
(agrl_torch.data.transforms); these stay for the surface's completeness
and for CPU-side experiments.

Every class works on numpy HWC uint8/float arrays (or CHW float where the
reference took tensors) or PIL images, and draws from an explicit
`np.random.RandomState`, so a seed reproduces agrl_tpu's draws.
"""

from __future__ import annotations

import numpy as np


class ToSpaceBGR:
    """Swap RGB->BGR on a CHW tensor (transforms.py:391-403)."""

    def __init__(self, is_bgr: bool = True):
        self.is_bgr = is_bgr

    def __call__(self, chw: np.ndarray) -> np.ndarray:
        if self.is_bgr:
            return chw[[2, 1, 0]]
        return chw


class ToRange255:
    """Scale [0,1] -> [0,255] (transforms.py:405-414)."""

    def __init__(self, is_255: bool = True):
        self.is_255 = is_255

    def __call__(self, t: np.ndarray) -> np.ndarray:
        return t * 255.0 if self.is_255 else t


class Random2DTranslation:
    """Resize to 1.125x then random-crop back, with prob p
    (transforms.py:416-447)."""

    def __init__(self, height: int, width: int, p: float = 0.5, rng=None):
        self.height = height
        self.width = width
        self.p = p
        self.rng = rng or np.random.RandomState()

    def __call__(self, img):
        from PIL import Image

        if self.rng.uniform(0, 1) > self.p:
            return img.resize((self.width, self.height), Image.BILINEAR)
        nw, nh = int(round(self.width * 1.125)), int(round(self.height * 1.125))
        resized = img.resize((nw, nh), Image.BILINEAR)
        x1 = int(round(self.rng.uniform(0, nw - self.width)))
        y1 = int(round(self.rng.uniform(0, nh - self.height)))
        return resized.crop((x1, y1, x1 + self.width, y1 + self.height))


class RectScale:
    """Resize to exactly (height, width) unless already there
    (transforms.py:449-459)."""

    def __init__(self, height: int, width: int):
        self.height = height
        self.width = width

    def __call__(self, img):
        from PIL import Image

        w, h = img.size
        if h == self.height and w == self.width:
            return img
        return img.resize((self.width, self.height), Image.BILINEAR)


class ElasticTransform:
    """Gaussian-filtered random displacement field (Simard 2003;
    transforms.py:462-484)."""

    def __init__(self, alpha: float = 2000, sigma: float = 20, order: int = 1,
                 mode: str = "nearest", rng=None):
        self.alpha = alpha
        self.sigma = sigma
        self.order = order
        self.mode = mode
        self.rng = rng or np.random.RandomState()

    def __call__(self, img):
        from PIL import Image
        from scipy.ndimage import gaussian_filter, map_coordinates

        image = np.asarray(img)
        shape = image.shape
        dx = gaussian_filter(self.rng.rand(*shape) * 2 - 1, self.sigma,
                             mode="constant", cval=0) * self.alpha
        dy = gaussian_filter(self.rng.rand(*shape) * 2 - 1, self.sigma,
                             mode="constant", cval=0) * self.alpha
        x, y, z = np.meshgrid(
            np.arange(shape[1]), np.arange(shape[0]), np.arange(shape[2])
        )
        indices = (
            np.reshape(y + dy, (-1, 1)),
            np.reshape(x + dx, (-1, 1)),
            np.reshape(z, (-1, 1)),
        )
        distorted = map_coordinates(image, indices, order=self.order,
                                    mode=self.mode).reshape(shape)
        return Image.fromarray(distorted)


class RandomErasing:
    """Zhong et al. random erasing on a CHW float tensor
    (transforms.py:487-531) — WITH the early return the reference's group
    variant forgot."""

    def __init__(self, probability=0.5, sl=0.02, sh=0.4, r1=0.3,
                 mean=(0.4914, 0.4822, 0.4465), rng=None):
        self.probability = probability
        self.sl, self.sh, self.r1 = sl, sh, r1
        self.mean = mean
        self.rng = rng or np.random.RandomState()

    def __call__(self, chw: np.ndarray) -> np.ndarray:
        if self.rng.uniform(0, 1) > self.probability:
            return chw
        C, H, W = chw.shape
        for _ in range(100):
            area = H * W
            target_area = self.rng.uniform(self.sl, self.sh) * area
            aspect = self.rng.uniform(self.r1, 1 / self.r1)
            h = int(round(np.sqrt(target_area * aspect)))
            w = int(round(np.sqrt(target_area / aspect)))
            if w < W and h < H:
                x1 = self.rng.randint(0, H - h + 1)
                y1 = self.rng.randint(0, W - w + 1)
                out = chw.copy()
                for c in range(min(C, 3)):
                    out[c, x1 : x1 + h, y1 : y1 + w] = self.mean[c]
                return out
        return chw


class MisAlignAugment:
    """Crop `ratio` off the top or bottom and pad the opposite side with
    zeros, with prob 0.5 (transforms.py:534-562)."""

    def __init__(self, ratio: float = 0.05, rng=None):
        self.ratio = ratio
        self.rng = rng or np.random.RandomState()

    def __call__(self, hwc: np.ndarray) -> np.ndarray:
        if self.rng.uniform(0, 1) > 0.5:
            return hwc
        H = hwc.shape[0]
        d = max(int(H * self.ratio), 1)
        if self.rng.uniform(0, 1) < 0.5:
            return np.pad(hwc[d:], ((0, d), (0, 0), (0, 0)))
        return np.pad(hwc[:-d], ((d, 0), (0, 0), (0, 0)))


class RandomPoseAugmentation:
    """Swap keypoint-centered patches between two frames of a clip, with
    prob p (transforms.py:565-624 semantics): pick a confident keypoint,
    exchange the (2*radius)^2 patches around it between two random frames."""

    def __init__(self, pose_info: dict, key_fn, radius: int = 8,
                 threshold: float = 0.1, p: float = 0.5, rng=None):
        self.pose_info = pose_info
        self.key_fn = key_fn
        self.radius = radius
        self.threshold = threshold
        self.p = p
        self.rng = rng or np.random.RandomState()

    def __call__(self, frames: np.ndarray, paths: list[str],
                 sizes: list[tuple[int, int]]) -> np.ndarray:
        """frames: (S, H, W, C) uint8; returns same shape."""
        S, H, W, _ = frames.shape
        if S < 2 or self.rng.uniform(0, 1) > self.p:
            return frames
        i, j = self.rng.choice(S, 2, replace=False)
        pose = self.pose_info.get(self.key_fn(paths[i]))
        if pose is None:
            return frames
        conf = np.asarray(pose)[:, 2]
        cand = np.flatnonzero(conf > self.threshold)
        if len(cand) == 0:
            return frames
        k = int(self.rng.choice(cand))
        ow, oh = sizes[i]
        x = int(pose[k][0] * W / ow)
        y = int(pose[k][1] * H / oh)
        r = self.radius
        x0, x1 = max(0, x - r), min(W, x + r)
        y0, y1 = max(0, y - r), min(H, y + r)
        out = frames.copy()
        out[i, y0:y1, x0:x1] = frames[j, y0:y1, x0:x1]
        out[j, y0:y1, x0:x1] = frames[i, y0:y1, x0:x1]
        return out
