"""Batch-hard triplet mining: the CUDA kernels and their plain twins.

Counterpart of agrl_tpu/ops/triplet.py (hard_mine_pallas), whose jnp
twin is agrl_tpu/losses/__init__.py (pairwise_euclidean + hard_mine).
For features (B, D) and labels (B,), per anchor: the distance to the
farthest sample of its label (self included) and to the nearest sample
of another label, on Euclidean distances sqrt(max(d2, 1e-12)).

On the card this op IS the hand-written kernels (csrc/triplet.cu): one
call mines the H heads of a train step (`hard_mine_heads_kernel`), one
more gives their gradient (`hard_mine_heads_backward_kernel`), for any
number of heads, batch and width: the forward's cluster schedule up to
B = 256, above it a long schedule whose Gram tiles run in 3xTF32 on the
tensor cores and mine in their epilogue; the backward's S-matrix kernel
up to B = 96, above it pick lists built once and walked row by row (the
kernel side picks each by B, and the head table by H; none is a
setting). A width that is not a multiple of 4 is padded with
zero columns, which change no distance, and the gradient sliced back.
The plain versions (`hard_mine_heads_reference`,
`hard_mine_backward_reference`) serve CPU tensors and check the kernels.
`hard_mine_heads` takes CUDA tensors to the kernels inside
`_HardMineHeads` (an autograd.Function) and raises on any other device;
`hard_mine_fused` takes CPU tensors to the plain version and CUDA ones
to `hard_mine_heads` — never a fallback.
"""

from __future__ import annotations

import ctypes
import functools

import torch

# Launches of the CUDA kernels: the forward (one per `hard_mine_heads_kernel`
# call, whatever the number of heads or the schedule) and the backward.
# Plain integers: callers reset them to 0 and read them back.
launches = 0
backward_launches = 0

# What the kernels take (csrc/triplet.cu states the same): heads and batch
# up to grid dimensions (65535, 65535 x 16 rows), any width; the cluster
# schedule's largest batch; heads the launch's own parameter table holds
# (more go through a device table of pointers)
MAX_HEADS, MAX_BATCH = 65535, 65535 * 16
SHORT_MAX_BATCH, PARAM_HEADS = 256, 64


def hard_mine_scratch_bytes(H: int, B: int) -> int:
    """Device memory the forward takes at (H, B) beside its inputs and
    outputs: the long schedule's partials (a float2 and an int2 per head,
    64-row tile and anchor, about B^2 / 4 bytes a head) and its norms (a
    float per head and anchor), none for the cluster schedule. The
    backward's pick lists (48 B + 4 bytes a head past B = 96) take less.
    csrc/triplet.cu's function of the same name, which the wrapper
    compares with this one at first use."""
    return 0 if B <= SHORT_MAX_BATCH else H * B * (16 * -(-B // 64) + 4)


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
    """Plain version of one head: (d_ap, d_an, i_ap, i_an). The values
    are differentiable; the indices take the lowest of tied entries."""
    dist = pairwise_euclidean(features)
    d_ap, d_an = hard_mine(dist, labels)
    pos = labels[:, None] == labels[None, :]
    i_ap = torch.where(pos, dist, -_BIG).argmax(dim=1)
    i_an = torch.where(pos, _BIG, dist).argmin(dim=1)
    return d_ap, d_an, i_ap, i_an


def hard_mine_heads_reference(features, labels: torch.Tensor):
    """Plain version of the forward kernel: `hard_mine_reference` per head,
    stacked into (d_ap, d_an, i_ap, i_an), each (H, B)."""
    per_head = [hard_mine_reference(f, labels) for f in features]
    return tuple(torch.stack(x) for x in zip(*per_head))


def hard_mine_backward_reference(features, d_ap, d_an, i_ap, i_an, g_ap, g_an):
    """Plain version of the backward kernel: for each head h, the gradient
    of dist(i, j) = |f_i - f_j| at each anchor's two picks, g (f_i - f_j) /
    dist onto row i and its negative onto row j. With M[i, j] = g_i /
    dist_ij at the picks, S = M + M^T: grad = rowsum(S) * f - S @ f, a dense
    product, so the sum order is fixed (a scatter with atomics would vary
    from run to run). A pick carries nothing where the clamp holds (dist at
    its floor), where none exists (d_an = FLT_MAX for an anchor without
    negatives) or at the anchor itself (its distance's gradient is 0); such
    a pick writes its 0 onto the diagonal. g_ap or g_an None: zero. d_*,
    i_*, g_* are (H, B); returns one (B, D) gradient per head."""
    grads = []
    for h, f in enumerate(features):
        B = f.shape[0]
        M = f.new_zeros(B, B)
        rows = torch.arange(B, device=f.device)
        for g, d, j in ((g_ap, d_ap, i_ap), (g_an, d_an, i_an)):
            if g is not None:
                live = (d[h] > _DIST_MIN) & (d[h] < _BIG) & (j[h] != rows)
                M[rows, torch.where(live, j[h], rows)] = torch.where(
                    live, g[h] / d[h], torch.zeros_like(d[h]))
        S = M + M.t()
        grads.append(S.sum(dim=1, keepdim=True) * f - S @ f)
    return grads


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """csrc/triplet.cu, built at first use, with its C signatures."""
    from agrl_torch.kernels.build import load_library

    lib = load_library("triplet")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.hard_mine_heads_forward.argtypes = [p, p, i, p, i, i, p, p, p, p, p, p]
    lib.hard_mine_heads_forward.restype = i
    lib.hard_mine_heads_backward.argtypes = [p, p, p, i, i, i, p, p, p, p, p, p, f, p, p]
    lib.hard_mine_heads_backward.restype = i
    for fn in (lib.hard_mine_scratch_bytes, lib.hard_mine_backward_scratch_bytes):
        fn.argtypes = [i, i]
        fn.restype = ctypes.c_longlong
    lib.hard_mine_empty_launch.argtypes = [p]
    lib.hard_mine_empty_launch.restype = i
    lib.hard_mine_error_string.argtypes = [i]
    lib.hard_mine_error_string.restype = ctypes.c_char_p
    limits = (lib.hard_mine_max_heads(), lib.hard_mine_max_batch(),
              lib.hard_mine_short_max_batch(), lib.hard_mine_param_heads())
    if limits != (MAX_HEADS, MAX_BATCH, SHORT_MAX_BATCH, PARAM_HEADS):
        raise RuntimeError(f"csrc/triplet.cu states (heads, B, short B, table) {limits}, the "
                           f"wrapper {(MAX_HEADS, MAX_BATCH, SHORT_MAX_BATCH, PARAM_HEADS)}")
    for H, B in ((1, 256), (3, 300), (94, 4096)):
        if lib.hard_mine_scratch_bytes(H, B) != hard_mine_scratch_bytes(H, B):
            raise RuntimeError(f"csrc/triplet.cu's scratch at (H, B) = ({H}, {B}) is "
                               f"{lib.hard_mine_scratch_bytes(H, B)} bytes, the wrapper's "
                               f"{hard_mine_scratch_bytes(H, B)}")
    return lib


def _pointers(tensors):
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def _device_table(tensors, dev):
    """A device array of the tensors' addresses, copied up on the current
    stream (the kernels read it in place of their parameter table)."""
    ptrs = torch.tensor([t.data_ptr() for t in tensors], dtype=torch.int64)
    return ptrs.pin_memory().to(dev, non_blocking=True)


def _check(rc: int, what: str) -> None:
    if rc != 0:
        msg = _lib().hard_mine_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({rc})")


def _check_heads(features, labels: torch.Tensor):
    """Raises ValueError on anything the kernels do not take; returns
    (H, B, D)."""
    H = len(features)
    if not 0 < H <= MAX_HEADS:
        raise ValueError(f"the kernel takes 1 to {MAX_HEADS} heads, got {H}")
    f0 = features[0]
    if f0.dim() != 2 or labels.shape != f0.shape[:1]:
        raise ValueError(f"features must be (B, D) and labels (B,), got "
                         f"{tuple(f0.shape)}, {tuple(labels.shape)}")
    if any(f.shape != f0.shape or f.dtype != f0.dtype or f.device != f0.device
           for f in features):
        raise ValueError("the heads must share one (B, D), dtype and device")
    B, D = f0.shape
    if not (0 < B <= MAX_BATCH and D > 0):
        raise ValueError(f"kernel takes 0 < B <= {MAX_BATCH}, D > 0; got B={B} D={D}")
    dev = f0.device
    if dev.type != "cuda":
        raise ValueError(f"the kernel takes CUDA tensors, got {dev}")
    if f0.dtype != torch.float32 or not all(f.is_contiguous() for f in features):
        raise ValueError(f"features must be contiguous float32, got {f0.dtype}")
    if D % 4 == 0 and any(f.data_ptr() % 16 for f in features):
        raise ValueError("features must be 16-byte aligned")
    if labels.device != dev or labels.dtype != torch.int64 or not labels.is_contiguous():
        raise ValueError(f"labels must be contiguous int64 on {dev}, got {labels.dtype} "
                         f"on {labels.device}")
    return H, B, D


def _padded(features, D):
    """The heads with D rounded up to a multiple of 4 by zero columns (new
    tensors), or as they are."""
    pad = -D % 4
    return features if pad == 0 else [torch.nn.functional.pad(f, (0, pad)) for f in features]


def hard_mine_heads_kernel(features, labels: torch.Tensor):
    """Run csrc/triplet.cu's forward on H CUDA heads of one (B, D) in one
    call: (d_ap, d_an, i_ap, i_an), each (H, B), no autograd. Raises on
    anything the kernel does not take."""
    global launches
    features = list(features)
    H, B, D = _check_heads(features, labels)
    features = _padded(features, D)
    lib = _lib()
    dev = labels.device
    d_ap = torch.empty(H, B, dtype=torch.float32, device=dev)
    d_an = torch.empty_like(d_ap)
    i_ap = torch.empty(H, B, dtype=torch.int64, device=dev)
    i_an = torch.empty_like(i_ap)
    nbytes = lib.hard_mine_scratch_bytes(H, B)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev) if nbytes else None
    with torch.cuda.device(dev):
        dtab = _device_table(features, dev) if H > PARAM_HEADS else None
        rc = lib.hard_mine_heads_forward(
            _pointers(features), None if dtab is None else dtab.data_ptr(), H,
            labels.data_ptr(), B, features[0].shape[1], d_ap.data_ptr(), d_an.data_ptr(),
            i_ap.data_ptr(), i_an.data_ptr(), None if scratch is None else scratch.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _check(rc, "hard_mine_heads")
    launches += 1
    return d_ap, d_an, i_ap, i_an


def hard_mine_heads_backward_kernel(features, d_ap, d_an, i_ap, i_an, g_ap, g_an):
    """Run csrc/triplet.cu's backward on the forward's outputs and the
    incoming gradients g_ap, g_an (H, B; None counts as zero) in one
    launch: one (B, D) gradient per head."""
    global backward_launches
    features = list(features)
    H, B, D = _check_heads(features, i_ap[0])
    dev = features[0].device
    # autograd may hand over an expanded (stride 0) gradient
    g_ap, g_an = (None if g is None else g.contiguous() for g in (g_ap, g_an))
    for name, t, dtype in (("d_ap", d_ap, torch.float32), ("d_an", d_an, torch.float32),
                           ("i_ap", i_ap, torch.int64), ("i_an", i_an, torch.int64),
                           ("g_ap", g_ap, torch.float32), ("g_an", g_an, torch.float32)):
        if t is not None and (t.shape != (H, B) or t.dtype != dtype or t.device != dev
                              or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous {dtype} ({H}, {B}) on {dev}")
    features = _padded(features, D)
    lib = _lib()
    grads = [torch.empty_like(f) for f in features]
    nbytes = lib.hard_mine_backward_scratch_bytes(H, B)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev) if nbytes else None
    with torch.cuda.device(dev):
        dtab = _device_table(features + grads, dev) if H > PARAM_HEADS else None
        rc = lib.hard_mine_heads_backward(
            _pointers(features), _pointers(grads), None if dtab is None else dtab.data_ptr(),
            H, B, features[0].shape[1], d_ap.data_ptr(), d_an.data_ptr(), i_ap.data_ptr(),
            i_an.data_ptr(), None if g_ap is None else g_ap.data_ptr(),
            None if g_an is None else g_an.data_ptr(), _DIST_MIN,
            None if scratch is None else scratch.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _check(rc, "hard_mine_heads_backward")
    backward_launches += 1
    return [g[:, :D] for g in grads] if grads[0].shape[1] != D else grads


def empty_launch(device) -> None:
    """One launch of an empty kernel on the current stream: the floor of
    a launch, as a yardstick for the kernels' times."""
    device = torch.device(device)
    with torch.cuda.device(device):
        _check(_lib().hard_mine_empty_launch(torch.cuda.current_stream(device).cuda_stream),
               "empty")


def hard_mine_kernel(features: torch.Tensor, labels: torch.Tensor):
    """The forward kernel on one head: (d_ap, d_an, i_ap, i_an), each (B,)."""
    return tuple(x[0] for x in hard_mine_heads_kernel([features], labels))


class _HardMineHeads(torch.autograd.Function):
    """(d_ap, d_an), each (H, B), of `mine(features, labels)`, which
    returns them with the picked indices; the backward is
    `mine_backward(features, d_ap, d_an, i_ap, i_an, g_ap, g_an)`, one
    gradient per head. The kernels on the card, the plain twins in the
    CPU tests."""

    @staticmethod
    def forward(ctx, labels, mine, mine_backward, *features):
        d_ap, d_an, i_ap, i_an = mine(features, labels)
        ctx.mine_backward = mine_backward
        ctx.save_for_backward(d_ap, d_an, i_ap, i_an, *features)
        return d_ap, d_an

    @staticmethod
    def backward(ctx, g_ap, g_an):
        d_ap, d_an, i_ap, i_an, *features = ctx.saved_tensors
        grads = ctx.mine_backward(features, d_ap, d_an, i_ap, i_an, g_ap, g_an)
        return (None, None, None, *grads)


def hard_mine_heads(features, labels: torch.Tensor):
    """(d_ap, d_an), each (H, B), differentiable in every head, from one
    forward and one backward kernel launch (csrc/triplet.cu) on CUDA
    tensors; any other device raises (CPU callers take the plain version
    head by head)."""
    features = list(features)
    if features[0].device.type != "cuda":
        raise ValueError(f"no hard_mine_heads for device {features[0].device}")
    return _HardMineHeads.apply(labels, hard_mine_heads_kernel, hard_mine_heads_backward_kernel,
                                *features)


def hard_mine_fused(features: torch.Tensor, labels: torch.Tensor):
    """(d_ap, d_an), differentiable in `features`. CPU tensors: the plain
    version. CUDA tensors: the kernels with H = 1, or an exception."""
    if features.device.type == "cpu":
        return hard_mine(pairwise_euclidean(features), labels)
    d_ap, d_an = hard_mine_heads([features], labels)
    return d_ap[0], d_an[0]
