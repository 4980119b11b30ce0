"""Min-plus product ms[q, j] = sum_c min(a[q, c], b[j, c]): the CUDA
kernel and its plain twin.

Counterpart of agrl_tpu/ops/minsum.py (min_sum_pallas) and of the scan
in agrl_tpu/ops/rerank.py (_min_sum): the Jaccard term of k-reciprocal
re-ranking, a (Q, C) x (J, C) -> (Q, J) product over the (min, +)
semiring, with Q the queries and J = C = Q + G at re-ranking.

On the card this op IS the hand-written kernel (csrc/minsum.cu);
`min_sum_reference` is its plain PyTorch version, used for CPU tensors
and to check the kernel. `min_sum` dispatches on the tensor's device:
CPU -> the plain version, CUDA -> the kernel or an exception, never a
fallback.
"""

from __future__ import annotations

import ctypes
import functools

import torch

# Launches of the CUDA kernel (one per `min_sum_kernel` call). A plain
# integer: callers reset it to 0 and read it back.
launches = 0

# Elements of the plain version's broadcast temporary (256 MB in fp32).
BLOCK_ELEMS = 1 << 26


def min_sum_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: a broadcast minimum and a sum over C, tiled over q
    and j so that the (tq, tj, C) temporary stays under BLOCK_ELEMS
    elements. Untiled, the MARS shape's temporary would be Q x J x C =
    2.5e11 floats; the JAX scan fuses it away, eager torch does not."""
    Q, C = a.shape
    J = b.shape[0]
    if b.shape[1] != C:
        raise ValueError(f"a is (Q, {C}) but b is {tuple(b.shape)}")
    out = a.new_empty(Q, J)
    tq = min(Q, 64)
    tj = max(1, min(J, BLOCK_ELEMS // max(tq * C, 1)))
    for q0 in range(0, Q, tq):
        aq = a[q0:q0 + tq, None, :]
        for j0 in range(0, J, tj):
            out[q0:q0 + tq, j0:j0 + tj] = torch.minimum(aq, b[None, j0:j0 + tj, :]).sum(dim=2)
    return out


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """csrc/minsum.cu, built at first use, with its C signatures."""
    from agrl_torch.kernels.build import load_library

    lib = load_library("minsum")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.min_sum_forward.argtypes = [p, p, i, i, i, p, p]
    lib.min_sum_forward.restype = i
    lib.min_sum_error_string.argtypes = [i]
    lib.min_sum_error_string.restype = ctypes.c_char_p
    lib.min_sum_max_rows.restype = ctypes.c_longlong
    return lib


def min_sum_kernel(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Run csrc/minsum.cu on CUDA tensors: (Q, C), (J, C) contiguous fp32
    on one device -> (Q, J). Raises on anything the kernel does not take."""
    global launches
    lib = _lib()
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[1]:
        raise ValueError(f"a must be (Q, C) and b (J, C), got {tuple(a.shape)}, {tuple(b.shape)}")
    (Q, C), J = a.shape, b.shape[0]
    if not (0 < Q < 2**31 and 0 < C < 2**31 and 0 < J <= lib.min_sum_max_rows()):
        raise ValueError(f"kernel takes 0 < Q, C < 2^31 and 0 < J <= "
                         f"{lib.min_sum_max_rows()}; got Q={Q} J={J} C={C}")
    dev = a.device
    for name, t in (("a", a), ("b", b)):
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name} must be on the CUDA device {dev}, got {t.device}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32, got {t.dtype}")
    out = torch.empty(Q, J, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.min_sum_forward(a.data_ptr(), b.data_ptr(), Q, J, C, out.data_ptr(), stream)
    if rc != 0:
        msg = lib.min_sum_error_string(rc).decode()
        raise RuntimeError(f"min_sum kernel launch failed: {msg} ({rc})")
    launches += 1
    return out


def min_sum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(Q, C), (J, C) -> (Q, J). CPU tensors: the plain version. CUDA
    tensors: the kernel (csrc/minsum.cu), or an exception."""
    if a.device.type == "cpu":
        return min_sum_reference(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"no min_sum for device {a.device}")
    return min_sum_kernel(a, b)
