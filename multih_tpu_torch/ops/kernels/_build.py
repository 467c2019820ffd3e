"""Build and load the port's CUDA kernels.

At first use, every ``multih_tpu_torch/csrc/*.cu`` is compiled by nvcc for
Hopper (``sm_90a``) into one shared library with a plain C interface,
under ``build/multih_tpu_torch/`` at the repository root, named by a hash
of the sources and flags — an unchanged tree reuses its build. The
library is loaded with ctypes: every pointer and the CUDA stream go in as
``c_void_p``, and every entry point returns ``cudaGetLastError()`` after
its launch, which `check` turns into an exception.

Nothing here runs at import time: CPU-only installs import every module
and have no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "multih_tpu_torch"
FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
# entry point -> argtypes; each returns cudaError_t as int
_SIGNATURES = {
    "multih_inlier_counts": [_P, _I, _P, _I, _P, _I, _P, _P],
    "multih_dlt_4pt": [_P, _I, _P, _P],
    "multih_eig9_smallest": [_P, _I, _P, _P],
}


class _Library:
    """The loaded kernel library plus what its build printed (one per
    process: a shared library is process-wide state by nature)."""

    lib = None
    log = ""
    seconds = 0.0
    path = None


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "on a host with the CUDA toolkit")
    return found


def _digest(srcs) -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for p in srcs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def load():
    """The ctypes library, building it first if this tree has no build."""
    if _Library.lib is not None:
        return _Library.lib
    srcs = sources()
    so = BUILD_DIR / f"libmultih_kernels_{_digest(srcs)}.so"
    log_path = so.with_suffix(".log")
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *FLAGS, "-o", tmp, *map(str, srcs)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stderr}"
            )
        os.replace(tmp, so)  # atomic: concurrent builders agree
        log_path.write_text(proc.stdout + proc.stderr)
        _Library.seconds = seconds
    _Library.log = log_path.read_text() if log_path.exists() else ""
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _Library.lib = lib
    _Library.path = so
    return lib


def build_report() -> tuple[float, str, Path | None]:
    """(build seconds — 0.0 when an existing build was reused, the
    nvcc/ptxas log, the library path) of the loaded library."""
    return _Library.seconds, _Library.log, _Library.path


def check(rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def stream_handle(t: torch.Tensor) -> int:
    """The current CUDA stream of t's device, as a pointer-sized int."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(*tensors: torch.Tensor, dtype=torch.float32) -> None:
    """Checks the kernels' inputs: CUDA, `dtype`, contiguous."""
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"expected a CUDA tensor, got {t.device}")
        if t.dtype != dtype:
            raise ValueError(f"expected {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("expected a contiguous tensor")
