"""Min-plus product ms[q, j] = sum_c min(a[q, c], b[j, c]): the CUDA
kernels and their plain twin.

Counterpart of agrl_tpu/ops/minsum.py (min_sum_pallas) and of the scan
in agrl_tpu/ops/rerank.py (_min_sum): the Jaccard term of k-reciprocal
re-ranking, a (Q, C) x (J, C) -> (Q, J) product over the (min, +)
semiring, with Q the queries and J = C = Q + G at re-ranking.

Two entries compute the same function for non-negative inputs:

  * `min_sum`, the dense kernel (csrc/minsum.cu): every Q J C term, for
    dense inputs;
  * `min_sum_sparse`, the sparse kernels (csrc/minsum_sparse.cu): only
    the terms whose two operands are non-zero, through CSR of a and an
    inverted index of b, for inputs that are mostly zeros, such as
    re-ranking's membership matrix (ops/rerank.py calls it).

The caller, which knows its data, picks the entry. `min_sum_reference`
is the plain PyTorch version of both, used for CPU tensors and to check
the kernels. Each entry dispatches on the tensor's device: CPU -> the
plain version, CUDA -> its kernel or an exception, never a fallback.
"""

from __future__ import annotations

import ctypes
import functools

import torch

# Launches of the dense kernel (one per `min_sum_kernel` call) and of the
# sparse kernels (one per `min_sum_sparse_kernel` call, which runs three
# kernels and a sort). Plain integers: callers reset them to 0 and read
# them back.
launches = 0
sparse_launches = 0

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


def _check_operands(a: torch.Tensor, b: torch.Tensor, max_rows: int) -> tuple:
    """(Q, C, J) of two contiguous fp32 CUDA operands on one device;
    raises on anything the kernels do not take."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[1]:
        raise ValueError(f"a must be (Q, C) and b (J, C), got {tuple(a.shape)}, {tuple(b.shape)}")
    (Q, C), J = a.shape, b.shape[0]
    if not (0 < Q < 2**31 and 0 < C < 2**31 and 0 < J <= max_rows):
        raise ValueError(f"kernel takes 0 < Q, C < 2^31 and 0 < J <= {max_rows}; "
                         f"got Q={Q} J={J} C={C}")
    for name, t in (("a", a), ("b", b)):
        if t.device != a.device or t.device.type != "cuda":
            raise ValueError(f"{name} must be on the CUDA device {a.device}, got {t.device}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32, got {t.dtype}")
    return Q, C, J


def min_sum_kernel(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Run csrc/minsum.cu on CUDA tensors: (Q, C), (J, C) contiguous fp32
    on one device -> (Q, J). Raises on anything the kernel does not take."""
    global launches
    lib = _lib()
    Q, C, J = _check_operands(a, b, lib.min_sum_max_rows())
    dev = a.device
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


@functools.lru_cache(maxsize=None)
def _sparse_lib() -> ctypes.CDLL:
    """csrc/minsum_sparse.cu, built at first use, with its C signatures."""
    from agrl_torch.kernels.build import load_library

    lib = load_library("minsum_sparse")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sparse_count.argtypes = [p, i, i, p, p, p, p]
    lib.sparse_fill.argtypes = [p, i, i, p, p, p, p, p]
    lib.sparse_accumulate.argtypes = [p, p, p, p, p, p, i, i, p, p]
    for fn in (lib.sparse_count, lib.sparse_fill, lib.sparse_accumulate):
        fn.restype = i
    lib.min_sum_sparse_error_string.argtypes = [i]
    lib.min_sum_sparse_error_string.restype = ctypes.c_char_p
    lib.min_sum_sparse_range.restype = ctypes.c_longlong
    return lib


def _require_non_negative(a: torch.Tensor, b: torch.Tensor, bad: int | None = None) -> None:
    if bad is None:
        bad = int((~(a >= 0)).sum()) + int((~(b >= 0)).sum())
    if bad:
        raise ValueError(f"min_sum_sparse takes non-negative inputs: {bad} entries are < 0 or NaN")


def min_sum_sparse_kernel(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Run csrc/minsum_sparse.cu on CUDA tensors: (Q, C), (J, C)
    contiguous non-negative fp32 on one device -> (Q, J), the same sums
    as min_sum over the terms whose two operands are non-zero, each
    output summed over ascending c (deterministic).

    One device -> host sync per call: the non-zero totals (and the count
    of negative or NaN entries, which raises) are read back once to size
    the CSR buffers. Raises on anything the kernels do not take."""
    global sparse_launches
    lib = _sparse_lib()
    Q, C, J = _check_operands(a, b, lib.min_sum_sparse_range() * 65535)
    dev = a.device
    i32 = dict(dtype=torch.int32, device=dev)

    def run(fn, *args):
        rc = fn(*args, stream)
        if rc != 0:
            msg = lib.min_sum_sparse_error_string(rc).decode()
            raise RuntimeError(f"min_sum_sparse kernel launch failed: {msg} ({rc})")

    # re-ranking passes v[:Q] and v: then a's CSR is the first Q rows of b's
    prefix = a.data_ptr() == b.data_ptr() and a.stride() == b.stride() and Q <= J
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        # 1. counts: b's rows and columns, a's rows; then the scans
        rows_a = 0 if prefix else Q
        counts = torch.zeros(J + C + rows_a, **i32)
        b_nnz, col_nnz, a_nnz = counts.split([J, C, rows_a])
        bad = torch.zeros(1, dtype=torch.int64, device=dev)
        run(lib.sparse_count, b.data_ptr(), J, C, b_nnz.data_ptr(), col_nnz.data_ptr(),
            bad.data_ptr())
        if not prefix:
            run(lib.sparse_count, a.data_ptr(), Q, C, a_nnz.data_ptr(), None, bad.data_ptr())
        ptrs = torch.zeros(J + C + 2 + (0 if prefix else Q + 1), dtype=torch.int64, device=dev)
        b_ptr, col_ptr, a_ptr = ptrs.split([J + 1, C + 1, ptrs.numel() - J - C - 2])
        for nnz, ptr in ((b_nnz, b_ptr), (col_nnz, col_ptr), (a_nnz, a_ptr)):
            if nnz.numel():
                torch.cumsum(nnz, 0, out=ptr[1:])
        if prefix:
            a_ptr = b_ptr[:Q + 1]
        # the one read-back: the totals size the buffers
        nnz_b, nnz_a, n_bad = torch.stack([b_ptr[-1], a_ptr[-1], bad[0]]).tolist()
        _require_non_negative(a, b, n_bad)

        # 2. CSR of a; b's entries by row, then stably by column
        b_col, b_row = torch.empty(nnz_b, **i32), torch.empty(nnz_b, **i32)
        b_val = torch.empty(nnz_b, dtype=torch.float32, device=dev)
        run(lib.sparse_fill, b.data_ptr(), J, C, b_ptr.data_ptr(), b_col.data_ptr(),
            b_val.data_ptr(), b_row.data_ptr())
        if prefix:
            a_col, a_val = b_col, b_val
        else:
            a_col = torch.empty(nnz_a, **i32)
            a_val = torch.empty(nnz_a, dtype=torch.float32, device=dev)
            run(lib.sparse_fill, a.data_ptr(), Q, C, a_ptr.data_ptr(), a_col.data_ptr(),
                a_val.data_ptr(), None)
        order = torch.sort(b_col, stable=True).indices
        inv_row, inv_val = b_row[order], b_val[order]

        # 3. the ordered accumulation
        out = torch.empty(Q, J, dtype=torch.float32, device=dev)
        run(lib.sparse_accumulate, a_ptr.data_ptr(), a_col.data_ptr(), a_val.data_ptr(),
            col_ptr.data_ptr(), inv_row.data_ptr(), inv_val.data_ptr(), Q, J, out.data_ptr())
    sparse_launches += 1
    return out


def min_sum_sparse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(Q, C), (J, C) non-negative -> (Q, J), for inputs that are mostly
    zeros. CPU tensors: the plain version. CUDA tensors: the sparse
    kernels (csrc/minsum_sparse.cu), or an exception. Both raise on an
    entry that is negative or NaN."""
    if a.device.type == "cpu":
        _require_non_negative(a, b)
        return min_sum_reference(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"no min_sum_sparse for device {a.device}")
    return min_sum_sparse_kernel(a, b)
