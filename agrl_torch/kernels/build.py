"""Build and load the port's native libraries.

CUDA kernels: each `agrl_torch/csrc/<name>.cu` has a plain C interface and
is compiled by nvcc into `agrl_torch/_build/lib<name>-<hash>.so`, then
loaded with ctypes.

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared \
         -Xcompiler -fPIC -Xptxas -v -o lib<name>-<hash>.so <name>.cu

`-Xptxas -v` output (registers, shared memory, spills per kernel) is
kept beside the library as `lib<name>-<hash>.log`.

Host libraries: the repo's `native/jpeg_decode.cpp` (batched libjpeg
decode, linked with -ljpeg) and `native/rank_eval.cpp` (CMC/mAP scorers)
are compiled by g++ with `native/Makefile`'s flags into
`agrl_torch/_build/lib{jpeg_decode,rank_eval}-<hash>.so` (without
-fopenmp where the compiler has no OpenMP runtime); `native/` is only
read. `HostLibrary` loads one at first use and, where it cannot be built
(no g++, no libjpeg headers), keeps the reason for `why_unavailable`.

Every hash covers the source and the flags, so an edited source rebuilds
at its next first use; an unchanged one loads the cached library.
Libraries land by an atomic rename, so concurrent builders (test
workers) see all or nothing. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NATIVE_DIR = PACKAGE_DIR.parent / "native"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# native/Makefile's CXXFLAGS
GXX_FLAGS = ("-O3", "-march=native", "-fopenmp", "-fPIC", "-shared", "-std=c++17", "-Wall")
# libraries linked after the source, per host library (the Makefile's rules)
HOST_LINK = {"jpeg_decode": ("-ljpeg",), "rank_eval": ()}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        candidate = Path(cuda_home) / "bin" / "nvcc"
        if candidate.exists():
            nvcc = str(candidate)
    if nvcc is None:
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")
    return nvcc


def _hashed_path(name: str, src: Path, flags) -> Path:
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _compile(cmd_head: list, src: Path, lib: Path, tail=()) -> Path:
    """Run `cmd_head -o tmp src tail` into `lib` unless it exists; the
    compiler's output is kept as `lib`'s .log. Raises with its stderr."""
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".so.tmp{os.getpid()}.{threading.get_ident()}")
    proc = subprocess.run([*cmd_head, "-o", str(tmp), str(src), *tail],
                          capture_output=True, text=True)
    log = lib.with_suffix(".log")
    log_tmp = log.with_suffix(f".log.tmp{os.getpid()}.{threading.get_ident()}")
    log_tmp.write_text(proc.stdout + proc.stderr)
    os.replace(log_tmp, log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"{Path(cmd_head[0]).name} failed ({proc.returncode}) for {src.name}:\n"
            f"{proc.stderr[-4000:]}"
        )
    os.replace(tmp, lib)  # atomic: a concurrent build sees all or nothing
    return lib


def library_path(name: str) -> Path:
    """Where `<name>.cu` builds to, keyed by the hash of source + flags."""
    return _hashed_path(name, CSRC_DIR / f"{name}.cu", NVCC_FLAGS)


def build(name: str) -> Path:
    """Compile `<name>.cu` if its library is not there yet; return its path."""
    return _compile([find_nvcc(), *NVCC_FLAGS], CSRC_DIR / f"{name}.cu", library_path(name))


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Build (at first use) and load the kernel library `<name>`."""
    return ctypes.CDLL(str(build(name)))


def host_library_path(name: str, flags=GXX_FLAGS) -> Path:
    """Where `native/<name>.cpp` builds to, keyed by the hash of source + flags."""
    return _hashed_path(name, NATIVE_DIR / f"{name}.cpp", tuple(flags) + HOST_LINK[name])


def build_host(name: str) -> tuple[Path, str | None]:
    """Compile `native/<name>.cpp` with g++ if its library is not there yet.
    Returns (library, note). A compiler without OpenMP's runtime (no
    libgomp) builds the library without -fopenmp, serial, and the note
    says so; any other failure raises with the compiler's output."""
    gxx = shutil.which(os.environ.get("CXX", "g++"))
    if gxx is None:
        raise RuntimeError("g++ not found on PATH (the host libraries build with it)")
    src = NATIVE_DIR / f"{name}.cpp"
    if not src.exists():
        raise RuntimeError(f"{src} is missing (the repo's native/ sources)")
    try:
        return _compile([gxx, *GXX_FLAGS], src, host_library_path(name), HOST_LINK[name]), None
    except RuntimeError as e:
        if "libgomp" not in str(e):
            raise
        why = next(line for line in str(e).splitlines() if "libgomp" in line).strip()
    serial = tuple(f for f in GXX_FLAGS if f != "-fopenmp")
    lib = _compile([gxx, *serial], src, host_library_path(name, serial), HOST_LINK[name])
    return lib, f"built without -fopenmp, serial ({why})"


class HostLibrary:
    """One host library of `native/`, built and loaded at first use.

    `lib()` returns the ctypes handle or raises RuntimeError with the
    reason it cannot be had; `available()` / `why_unavailable()` report
    the same without raising; `path` and `note` (e.g. a serial build)
    describe the library once loaded. The outcome is kept, so a machine
    without g++ or libjpeg's headers pays one failed build, not one per
    call. `declare(cdll)` sets the argtypes/restypes of the C interface."""

    def __init__(self, name: str, declare):
        self.name = name
        self._declare = declare
        self._lock = threading.Lock()
        self._outcome = None  # (cdll, None) or (None, reason)
        self.path: Path | None = None
        self.note: str | None = None

    def _load(self):
        with self._lock:
            if self._outcome is None:
                try:
                    self.path, self.note = build_host(self.name)
                    cdll = ctypes.CDLL(str(self.path))
                    self._declare(cdll)
                    self._outcome = (cdll, None)
                except (RuntimeError, OSError) as e:
                    # the compiler's first error line; its whole output is in the .log
                    lines = str(e).splitlines()
                    why = next((ln.strip() for ln in lines if "error" in ln), lines[0])
                    self._outcome = (None, f"lib{self.name} not built: {why}")
            return self._outcome

    def lib(self) -> ctypes.CDLL:
        cdll, reason = self._load()
        if cdll is None:
            raise RuntimeError(reason)
        return cdll

    def available(self) -> bool:
        return self._load()[0] is not None

    def why_unavailable(self) -> str | None:
        return self._load()[1]
