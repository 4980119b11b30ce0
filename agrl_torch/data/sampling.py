"""Clip frame-index sampling (copy of agrl_tpu/data/sampling.py) — the
reference's 7 strategies as pure NumPy functions with an explicit RNG.

Parity targets (torchreid/dataset_loader.py:91-170):
  random      — sorted choice of seq_len frames (with replacement iff short)
  evenly      — truncate to a multiple of seq_len, stride num/seq_len;
                short tracklets pad with the last frame
  all         — every frame (batch_size must be 1)
  consecutive — random seq_len-frame window; short tracklets are padded
                with the last frame (the reference's padding loop is dead
                code, dataset_loader.py:134-136 — a deliberate fix)
  dense       — all frames padded with the last frame into n full clips;
                when num %% seq_len == 0 a FULL extra clip of the last
                frame is appended (reference quirk, kept for parity)
  restricted  — dense-style padding, then one random frame per temporal
                chunk (the training strategy all vmgn scripts use)
  skipdense   — n interleaved clips with stride n over the padded list

All return int64 arrays: (seq_len,) for clip strategies, (n * seq_len,)
for dense/skipdense, (num,) for 'all'.
"""

from __future__ import annotations

import numpy as np

SAMPLE_METHODS = (
    "evenly",
    "random",
    "all",
    "consecutive",
    "dense",
    "restricted",
    "skipdense",
)


def _dense_padded(num: int, seq_len: int) -> np.ndarray:
    """All frames, padded with the last frame to the next multiple of
    seq_len; num %% seq_len == 0 appends a full extra clip (parity quirk)."""
    append_size = seq_len - num % seq_len
    return np.concatenate(
        [np.arange(num), np.full(append_size, num - 1)]
    ).astype(np.int64)


def sample_clip_indices(
    num: int,
    seq_len: int,
    method: str,
    rng: np.random.RandomState | None = None,
    max_len: int = 1000,
) -> np.ndarray:
    """Sample frame indices for one tracklet of `num` frames."""
    if rng is None:
        rng = np.random.RandomState()
    num = min(num, max_len)  # over-length truncation (dataset_loader.py:77-89)

    if method == "random":
        replace = num < seq_len
        indices = rng.choice(np.arange(num), size=seq_len, replace=replace)
        return np.sort(indices).astype(np.int64)

    if method == "evenly":
        if num >= seq_len:
            num -= num % seq_len
            indices = np.arange(0, num, num / seq_len)
        else:
            indices = np.concatenate(
                [np.arange(num), np.full(seq_len - num, num - 1)]
            )
        return indices.astype(np.int64)

    if method == "all":
        return np.arange(num, dtype=np.int64)

    if method == "consecutive":
        rand_end = max(0, num - seq_len - 1)
        begin = int(rng.randint(0, rand_end + 1))
        end = min(begin + seq_len, num)
        indices = np.arange(begin, end)
        if len(indices) < seq_len:  # deliberate fix of reference dead code
            indices = np.concatenate(
                [indices, np.full(seq_len - len(indices), indices[-1])]
            )
        return indices.astype(np.int64)

    if method == "dense":
        return _dense_padded(num, seq_len)

    if method == "restricted":
        # one random frame per temporal chunk of the dense-padded list;
        # bit-identical to the reference's per-chunk np.random.choice
        # (dataset_loader.py:145-156): one randint(size=S) draws the same
        # stream as S scalar calls, and padded[i] = min(i, num-1)
        chunk_size = (num + (seq_len - num % seq_len)) // seq_len
        rs = rng.randint(0, chunk_size, size=seq_len)
        return np.minimum(
            np.arange(seq_len, dtype=np.int64) * chunk_size + rs, num - 1
        )

    if method == "skipdense":
        padded = _dense_padded(num, seq_len)
        skip_len = len(padded) // seq_len
        clips = [padded[np.arange(i, len(padded), skip_len)] for i in range(skip_len)]
        return np.concatenate(clips).astype(np.int64)

    raise KeyError(
        f"Unknown sample method: {method}. Expected one of {SAMPLE_METHODS}"
    )


def num_clips(num: int, seq_len: int, method: str, max_len: int = 1000) -> int:
    """How many seq_len clips a tracklet yields under dense/skipdense."""
    num = min(num, max_len)
    if method in ("dense", "skipdense"):
        return (num + (seq_len - num % seq_len)) // seq_len
    return 1
