"""Batch-hard triplet mining: the CUDA kernel and its plain twin.

Counterpart of agrl_tpu/ops/triplet.py (hard_mine_pallas), whose jnp
twin is agrl_tpu/losses/__init__.py (pairwise_euclidean + hard_mine).
For features (B, D) and labels (B,), per anchor: the distance to the
farthest sample of its label (self included) and to the nearest sample
of another label, on Euclidean distances sqrt(max(d2, 1e-12)).

On the card this op IS the hand-written kernel (csrc/triplet.cu); the
plain version (`hard_mine_reference`) serves CPU tensors and checks the
kernel. `hard_mine_fused` dispatches on the tensor's device: CPU -> the
plain version under autograd, CUDA -> the kernel inside `_HardMine` (an
autograd.Function whose backward scatters the gradient onto the two
picked rows), or an exception — never a fallback.
"""

from __future__ import annotations

import ctypes
import functools

import torch

# Launches of the CUDA kernel (one per `hard_mine_kernel` call). A plain
# integer: callers reset it to 0 and read it back.
launches = 0

D2_MIN = 1e-12  # the clamp under the square root, as the JAX package has it
# the distance the clamp leaves; a pick at it carries no gradient (the
# clamp's gradient is 0 there, as jnp.clip's is)
_DIST_MIN = float(torch.sqrt(torch.tensor(D2_MIN, dtype=torch.float32)))
_BIG = float(torch.finfo(torch.float32).max)


def pairwise_euclidean(x: torch.Tensor) -> torch.Tensor:
    """(B, D) -> (B, B) distances sqrt(max(sq_i + sq_j - 2 <x_i, x_j>,
    1e-12)). The Gram must be full fp32 (TF32 off): the quadratic form
    cancels near zero distance, where the hardest positive lives."""
    sq = (x * x).sum(dim=1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * torch.matmul(x, x.t())
    return torch.sqrt(torch.clamp(d2, min=D2_MIN))


def hard_mine(dist: torch.Tensor, labels: torch.Tensor):
    """(B, B) distances, (B,) labels -> (d_ap, d_an), each (B,), with the
    JAX package's masks. amax/amin split the gradient evenly among ties,
    as JAX's max/min do."""
    pos = labels[:, None] == labels[None, :]
    d_ap = torch.where(pos, dist, -_BIG).amax(dim=1)
    d_an = torch.where(pos, _BIG, dist).amin(dim=1)
    return d_ap, d_an


def hard_mine_reference(features: torch.Tensor, labels: torch.Tensor):
    """Plain version of the kernel: (d_ap, d_an, i_ap, i_an). The values
    are differentiable; the indices take the lowest of tied entries."""
    dist = pairwise_euclidean(features)
    d_ap, d_an = hard_mine(dist, labels)
    pos = labels[:, None] == labels[None, :]
    i_ap = torch.where(pos, dist, -_BIG).argmax(dim=1)
    i_an = torch.where(pos, _BIG, dist).argmin(dim=1)
    return d_ap, d_an, i_ap, i_an


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """csrc/triplet.cu, built at first use, with its C signatures."""
    from agrl_torch.kernels.build import load_library

    lib = load_library("triplet")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.hard_mine_forward.argtypes = [p, p, i, i, p, p, p, p, p]
    lib.hard_mine_forward.restype = i
    lib.hard_mine_error_string.argtypes = [i]
    lib.hard_mine_error_string.restype = ctypes.c_char_p
    lib.hard_mine_max_batch.restype = i
    lib.hard_mine_max_dim.restype = i
    return lib


def hard_mine_kernel(features: torch.Tensor, labels: torch.Tensor):
    """Run csrc/triplet.cu on CUDA tensors: (d_ap, d_an, i_ap, i_an), no
    autograd. Raises on anything the kernel does not take."""
    global launches
    lib = _lib()
    if features.dim() != 2 or labels.shape != features.shape[:1]:
        raise ValueError(f"features must be (B, D) and labels (B,), got "
                         f"{tuple(features.shape)}, {tuple(labels.shape)}")
    B, D = features.shape
    b_max, d_max = lib.hard_mine_max_batch(), lib.hard_mine_max_dim()
    if not (0 < B <= b_max and 0 < D <= d_max and D % 4 == 0):
        raise ValueError(f"kernel takes 0 < B <= {b_max}, 0 < D <= {d_max}, D % 4 == 0; "
                         f"got B={B} D={D}")
    dev = features.device
    if features.dtype != torch.float32 or not features.is_contiguous():
        raise ValueError(f"features must be contiguous float32, got {features.dtype}")
    if features.data_ptr() % 16:
        raise ValueError("features must be 16-byte aligned")
    if labels.device != dev or labels.dtype != torch.int64 or not labels.is_contiguous():
        raise ValueError(f"labels must be contiguous int64 on {dev}, got {labels.dtype} "
                         f"on {labels.device}")

    d_ap = torch.empty(B, dtype=torch.float32, device=dev)
    d_an = torch.empty_like(d_ap)
    i_ap = torch.empty(B, dtype=torch.int64, device=dev)
    i_an = torch.empty_like(i_ap)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.hard_mine_forward(
            features.data_ptr(), labels.data_ptr(), B, D, d_ap.data_ptr(),
            d_an.data_ptr(), i_ap.data_ptr(), i_an.data_ptr(), stream,
        )
    if rc != 0:
        msg = lib.hard_mine_error_string(rc).decode()
        raise RuntimeError(f"hard_mine kernel launch failed: {msg} ({rc})")
    launches += 1
    return d_ap, d_an, i_ap, i_an


class _HardMine(torch.autograd.Function):
    """(d_ap, d_an) of `mine(features, labels)`, which returns them with
    the picked indices. Backward: the gradient of dist(i, j) = |f_i - f_j|
    for each picked pair, g (f_i - f_j) / dist onto row i and its negative
    onto row j; zero where the clamp holds (dist at its floor) or no pick
    exists (d_an = FLT_MAX for an anchor without negatives). The TPU
    kernel has no backward; this one is plain torch on the picks."""

    @staticmethod
    def forward(ctx, features, labels, mine):
        d_ap, d_an, i_ap, i_an = mine(features, labels)
        ctx.save_for_backward(features, d_ap, d_an, i_ap, i_an)
        return d_ap, d_an

    @staticmethod
    def backward(ctx, g_ap, g_an):
        features, d_ap, d_an, i_ap, i_an = ctx.saved_tensors
        # M[i, j] = g_i / dist_ij at each anchor's two picks (distinct
        # columns: a positive is never a negative). With S = M + M^T,
        # grad = rowsum(S) * f - S @ f: a dense product, so the sum order is
        # fixed (a scatter with atomics would make it vary from run to run).
        B = features.shape[0]
        M = features.new_zeros(B, B)
        rows = torch.arange(B, device=features.device)
        for g, d, j in ((g_ap, d_ap, i_ap), (g_an, d_an, i_an)):
            if g is not None:
                live = (d > _DIST_MIN) & (d < _BIG)
                M[rows, j] = torch.where(live, g / d, torch.zeros_like(d))
        S = M + M.t()
        return S.sum(dim=1, keepdim=True) * features - S @ features, None, None


def hard_mine_fused(features: torch.Tensor, labels: torch.Tensor):
    """(d_ap, d_an), differentiable in `features`. CPU tensors: the plain
    version. CUDA tensors: the kernel (csrc/triplet.cu), or an
    exception."""
    if features.device.type == "cpu":
        return hard_mine(pairwise_euclidean(features), labels)
    if features.device.type != "cuda":
        raise ValueError(f"no hard_mine_fused for device {features.device}")
    return _HardMine.apply(features, labels, hard_mine_kernel)
