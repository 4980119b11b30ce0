"""ctypes binding of the batched JPEG decoder, `native/jpeg_decode.cpp`
(counterpart of agrl_tpu/data/jpeg_native.py).

One C call decodes a whole batch of frames through libjpeg: no per-image
Python, DCT-domain downscaling when a source exceeds the target, a
fixed-point bilinear resize; bit-exact with PIL when the source is already
at the target size. The library is built with g++ into
`agrl_torch/_build/` at first use (`kernels/build.py`); where that cannot
be done (no g++, no libjpeg headers) `available()` is False and
`why_unavailable()` says why. Per-image failures (ok=0) are retried by
the caller through the robust PIL reader.
"""

from __future__ import annotations

import ctypes

import numpy as np

from agrl_torch.kernels.build import HostLibrary

_u8p = ctypes.POINTER(ctypes.c_uint8)


def _declare(cdll):
    cdll.decode_resize_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        _u8p, ctypes.POINTER(ctypes.c_int32), _u8p, ctypes.c_int64,
    ]
    cdll.decode_resize_batch.restype = None


LIBRARY = HostLibrary("jpeg_decode", _declare)


def available() -> bool:
    """True when the decoder is built (building it at the first call)."""
    return LIBRARY.available()


def why_unavailable() -> str | None:
    """The reason the decoder cannot be built, or None when it is."""
    return LIBRARY.why_unavailable()


def decode_resize_batch(paths, height: int, width: int, threads: int = 1):
    """Decode `paths` (JPEG files) to a (N, height, width, 3) uint8 batch.

    Returns (imgs, sizes (N, 2) int32 original (w, h), ok (N,) bool).
    Entries with ok=False are zero-filled; the caller must fall back.

    `threads` is the decoder's OpenMP width (0: the hardware default). It
    defaults to 1: under the loader's worker threads a wider team would
    oversubscribe the host; the ClipLoader passes 0 when it runs one
    worker."""
    lib = LIBRARY.lib()
    n = len(paths)
    imgs = np.empty((n, height, width, 3), np.uint8)
    sizes = np.empty((n, 2), np.int32)
    ok = np.empty(n, np.uint8)
    cpaths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    lib.decode_resize_batch(
        cpaths, n, height, width,
        imgs.ctypes.data_as(_u8p),
        sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ok.ctypes.data_as(_u8p),
        threads,
    )
    return imgs, sizes, ok.astype(bool)
