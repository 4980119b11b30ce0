"""ctypes binding of the C++ ranking scorers, `native/rank_eval.cpp`
(counterpart of agrl_tpu/metrics/rank_native.py).

Role parity with the reference's rank_cylib import shim
(torchreid/metrics/rank.py:11-19): mars, market1501 and cuhk03 scoring in
C++, with the NumPy scorers of metrics/rank.py where the library cannot
be had. The library is built with g++ into `agrl_torch/_build/` at first
use (`kernels/build.py`); `available()` / `why_unavailable()` say whether
it could be. The scorers agree with the NumPy ones to ~1e-6 (they sort
and sum in float32), and cuhk03 draws from the global np.random stream
exactly as the NumPy path does.
"""

from __future__ import annotations

import ctypes

import numpy as np

from agrl_torch.kernels.build import HostLibrary


def _declare(lib):
    f32 = ctypes.POINTER(ctypes.c_float)
    i64 = ctypes.POINTER(ctypes.c_int64)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    i32 = ctypes.POINTER(ctypes.c_int32)
    lib.evaluate_mars_c.argtypes = [
        f32, i64, i64, i64, i64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, f32, f32,
    ]
    lib.evaluate_market1501_c.argtypes = [
        f32, i64, i64, i64, i64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, f32, f32, u8,
    ]
    lib.cuhk03_prepare_c.argtypes = [
        f32, i64, i64, i64, i64, ctypes.c_int64, ctypes.c_int64,
        f32, u8, i32, i32, i32, i32,
    ]
    for fn in (lib.evaluate_mars_c, lib.evaluate_market1501_c, lib.cuhk03_prepare_c):
        fn.restype = None


LIBRARY = HostLibrary("rank_eval", _declare)


def available() -> bool:
    """True when the scorers are built (building them at the first call)."""
    return LIBRARY.available()


def why_unavailable() -> str | None:
    return LIBRARY.why_unavailable()


def _prep(distmat, q_pids, g_pids, q_camids, g_camids):
    dm = np.ascontiguousarray(distmat, dtype=np.float32)
    arrs = [
        np.ascontiguousarray(a, dtype=np.int64)
        for a in (q_pids, g_pids, q_camids, g_camids)
    ]
    return dm, arrs


def evaluate_mars_native(distmat, q_pids, g_pids, q_camids, g_camids, max_rank=50):
    _lib = LIBRARY.lib()
    dm, (qp, gp, qc, gc) = _prep(distmat, q_pids, g_pids, q_camids, g_camids)
    Q, G = dm.shape
    cmc = np.zeros((Q, max_rank), dtype=np.float32)
    ap = np.zeros(Q, dtype=np.float32)
    c_f = ctypes.POINTER(ctypes.c_float)
    c_i = ctypes.POINTER(ctypes.c_int64)
    _lib.evaluate_mars_c(
        dm.ctypes.data_as(c_f),
        qp.ctypes.data_as(c_i), gp.ctypes.data_as(c_i),
        qc.ctypes.data_as(c_i), gc.ctypes.data_as(c_i),
        Q, G, max_rank,
        cmc.ctypes.data_as(c_f), ap.ctypes.data_as(c_f),
    )
    return cmc.mean(axis=0).astype(np.float64), float(ap.mean())


def evaluate_market1501_native(distmat, q_pids, g_pids, q_camids, g_camids, max_rank=50):
    _lib = LIBRARY.lib()
    dm, (qp, gp, qc, gc) = _prep(distmat, q_pids, g_pids, q_camids, g_camids)
    Q, G = dm.shape
    max_rank = min(max_rank, G)
    cmc = np.zeros((Q, max_rank), dtype=np.float32)
    ap = np.zeros(Q, dtype=np.float32)
    valid = np.zeros(Q, dtype=np.uint8)
    c_f = ctypes.POINTER(ctypes.c_float)
    c_i = ctypes.POINTER(ctypes.c_int64)
    c_u = ctypes.POINTER(ctypes.c_uint8)
    _lib.evaluate_market1501_c(
        dm.ctypes.data_as(c_f),
        qp.ctypes.data_as(c_i), gp.ctypes.data_as(c_i),
        qc.ctypes.data_as(c_i), gc.ctypes.data_as(c_i),
        Q, G, max_rank,
        cmc.ctypes.data_as(c_f), ap.ctypes.data_as(c_f), valid.ctypes.data_as(c_u),
    )
    n_valid = valid.sum()
    if n_valid == 0:
        raise RuntimeError("Error: all query identities do not appear in gallery")
    mask = valid.astype(bool)
    return cmc[mask].mean(axis=0).astype(np.float32), float(ap[mask].mean())


def evaluate_cuhk03_native(
    distmat, q_pids, g_pids, q_camids, g_camids, max_rank=50, num_repeats=10
):
    """cuhk03 protocol through the native extension — draw-for-draw equal
    to the reference eval_cuhk03 (torchreid/metrics/rank.py:22-92) under a
    shared global np.random state.

    Split of labor: cuhk03_prepare_c does everything deterministic
    (argsort, same-pid+same-cam removal, full-kept-list AP, pid-group
    structure in first-appearance order); here the 10x single-gallery-shot
    draws replay the reference's RNG stream exactly — np.random.choice on
    a list consumes one randint(0, len) per call, so one np.random.randint
    per (valid query, repeat, group) in the same order reproduces the
    reference's chosen slots bit-for-bit. Each repeat's masked CMC is a
    step function starting at the own-group chosen slot's rank among all
    chosen slots (the kept list has exactly one matching slot selected per
    repeat), so CMC assembly is O(ngroups) per repeat instead of a
    cumsum over the kept list.

    Ragged edge (ngroups < max_rank): rows pad with the final CMC value
    (=1) like this repo's numpy eval_cuhk03; the reference python would
    build a ragged array there (its galleries never trigger it)."""
    _lib = LIBRARY.lib()
    dm, (qp, gp, qc, gc) = _prep(distmat, q_pids, g_pids, q_camids, g_camids)
    Q, G = dm.shape
    if G < max_rank:
        max_rank = G
        print(f"Note: number of gallery samples is quite small, got {G}")

    ap = np.zeros(Q, dtype=np.float32)
    valid = np.zeros(Q, dtype=np.uint8)
    ngroups = np.zeros(Q, dtype=np.int32)
    own_group = np.zeros(Q, dtype=np.int32)
    group_sizes = np.zeros((Q, G), dtype=np.int32)
    group_slots = np.zeros((Q, G), dtype=np.int32)
    c_f = ctypes.POINTER(ctypes.c_float)
    c_i = ctypes.POINTER(ctypes.c_int64)
    c_u = ctypes.POINTER(ctypes.c_uint8)
    c_i32 = ctypes.POINTER(ctypes.c_int32)
    _lib.cuhk03_prepare_c(
        dm.ctypes.data_as(c_f),
        qp.ctypes.data_as(c_i), gp.ctypes.data_as(c_i),
        qc.ctypes.data_as(c_i), gc.ctypes.data_as(c_i),
        Q, G,
        ap.ctypes.data_as(c_f), valid.ctypes.data_as(c_u),
        ngroups.ctypes.data_as(c_i32), own_group.ctypes.data_as(c_i32),
        group_sizes.ctypes.data_as(c_i32), group_slots.ctypes.data_as(c_i32),
    )
    if not valid.any():
        raise RuntimeError("Error: all query identities do not appear in gallery")

    randint = np.random.randint  # the reference uses the GLOBAL stream
    cmc_sum = np.zeros(max_rank, dtype=np.float64)
    ranks = np.arange(max_rank)
    for q in np.flatnonzero(valid):
        ng = int(ngroups[q])
        sizes = group_sizes[q, :ng]
        offs = np.concatenate(([0], np.cumsum(sizes[:-1]))) if ng else np.zeros(0, int)
        slots = group_slots[q]
        own = int(own_group[q])
        cmc_q = np.zeros(max_rank, dtype=np.float64)
        for _ in range(num_repeats):
            # one draw per group, reference order; chosen slot of group g
            chosen = np.asarray(
                [slots[offs[g] + randint(0, sizes[g])] for g in range(ng)]
            )
            r_star = int((chosen < chosen[own]).sum())
            cmc_q += ranks >= r_star
        cmc_sum += cmc_q / num_repeats
    n_valid = int(valid.sum())
    return (cmc_sum / n_valid).astype(np.float32), float(ap[valid.astype(bool)].mean())
