"""In-process serving API for the eval forward (counterpart of
agrl_tpu/engine/export.py:FeatureExtractor, live-model path).

`FeatureExtractor` serves the exact forward the Evaluator runs
(engine/evaluator.py `make_eval_forward`) behind one fixed batch shape:
a request of any size runs in ceil(N / batch_size) forwards of
`batch_size` clips; ragged chunks are padded with zero frames and an
all-ones adjacency, and the padding rows are sliced off the output.
Artifact export (agrl_tpu's jax.export path; torch.export here) follows
later.
"""

from __future__ import annotations

import numpy as np
import torch

from agrl_torch import resolve_device
from agrl_torch.engine.evaluator import make_eval_forward
from agrl_torch.models import default_num_vertices


class FeatureExtractor:
    """Serving-facing feature extraction: `fx(clips_u8, adjs)` -> (N, D)
    float32 numpy features. Runs on the card unless device="cpu"."""

    def __init__(
        self,
        model,
        *,
        batch_size: int = 64,
        seq_len: int = 8,
        num_vertices: int | None = None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.batch_size = batch_size
        self.seq_len = seq_len
        self._num_vertices = (
            num_vertices if num_vertices is not None else default_num_vertices(model, seq_len)
        )
        self._hw = None  # frame H/W: locked in by the first request
        self._fwd = make_eval_forward(self.model, self.device)

    def __call__(self, imgs, adjs=None) -> np.ndarray:
        """imgs: (N, S, H, W, 3) uint8; adjs: (N, V, V) or None (all-ones).
        Returns (N, D) float32 features. N = 0 is served (one padded
        forward, empty result)."""
        imgs = np.asarray(imgs)
        n = imgs.shape[0]
        # reject shape drift up front: one batch shape serves every request
        if imgs.ndim != 5 or imgs.shape[1] != self.seq_len or imgs.shape[4] != 3:
            raise ValueError(
                f"expected clips of shape (N, {self.seq_len}, H, W, 3), got {imgs.shape}"
            )
        if self._hw is None:
            self._hw = (imgs.shape[2], imgs.shape[3])
        elif tuple(imgs.shape[2:4]) != self._hw:
            raise ValueError(
                f"this extractor serves {self._hw[0]}x{self._hw[1]} frames, "
                f"got {imgs.shape[2]}x{imgs.shape[3]}"
            )
        v = self._num_vertices
        if adjs is not None:
            adjs = np.asarray(adjs, np.float32)
            if adjs.shape != (n, v, v):
                raise ValueError(f"expected adjacency of shape ({n}, {v}, {v}), got {adjs.shape}")
        bs = self.batch_size
        ones = np.ones((bs, v, v), np.float32)  # dummy/padding adjacency
        out = []
        for start in range(0, max(n, 1), bs):  # n == 0 -> one padded run
            im = imgs[start:start + bs]
            ad = ones if adjs is None else adjs[start:start + bs]
            take = im.shape[0]
            if take < bs:
                im = np.concatenate([im, np.zeros((bs - take, *imgs.shape[1:]), imgs.dtype)])
                if adjs is not None:
                    ad = np.concatenate([ad, ones[: bs - take]])
            out.append(self._fwd(im, ad)[:take])  # async on the card
        return torch.cat(out).cpu().numpy()
