"""Re-id helpers (copy of agrl_tpu/utils/reidtools.py:calc_splits).

`calc_splits` parity: reference torchreid/utils/reidtools.py:13-15 —
for a power-of-two n it returns the divisor pyramid [n, n/2, ..., 1].
"""

from __future__ import annotations


def calc_splits(num_split: int) -> list[int]:
    """Pyramid of split counts: 4 -> [4, 2, 1]; 1 -> [1]."""
    if num_split < 1 or num_split & (num_split - 1):
        raise ValueError(f"num_split must be a positive power of 2, got {num_split}")
    return [num_split >> i for i in range(num_split.bit_length())]
