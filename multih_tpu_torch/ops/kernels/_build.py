"""Build and load the port's CUDA kernels.

At first use, every ``multih_tpu_torch/csrc/*.cu`` is compiled by nvcc for
Hopper (``sm_90a``), one nvcc process per source, all started together,
and the objects are linked into one shared library with a plain C
interface. The library lives under a cache root, by default
``build/multih_tpu_torch`` at the repository root, in a directory keyed
by the host's CPU flags (``utils/cache.compile_cache_dir``:
``build/multih_tpu_torch-<fingerprint>``), and its file name hashes the
sources, the nvcc flags, nvcc's release and ``torch.version.cuda``: an
unchanged tree on the same host and toolkit reuses its build, and
nothing built on another host or toolkit is loaded. The flags fix the
card's architecture (``sm_90a``), so `load` refuses a card whose
compute capability is not 9.0. A library that does not load (a
truncated or foreign file under its name) is rebuilt once from the
sources, with a warning in the log. The library is loaded with ctypes:
every pointer and the CUDA stream go in as ``c_void_p``, and every
entry point returns ``cudaGetLastError()`` after its launch, which
`check` turns into an exception.

Nothing here runs at import time: CPU-only installs import every module
and have no nvcc.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import logging
import os
import shutil
import struct
import subprocess
import tempfile
import time
from pathlib import Path

import torch

from multih_tpu_torch.utils import cache

log = logging.getLogger(__name__)

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
# the default cache root; the library's directory is keyed by the host
BUILD_ROOT = _PKG.parent / "build" / "multih_tpu_torch"
FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# entry point -> argtypes; each returns cudaError_t as int
_SIGNATURES = {
    "multih_inlier_counts": [_P] + [_I] * 4 + ([_P] + [_I] * 2) * 3
                            + [_P] + [_I] * 4 + [_P, _P],
    "multih_inlier_counts_limits": [_P],
    "multih_dlt_4pt_gt": [_P, _I, _I, _I, _P, _P, _P],
    "multih_eig9_smallest": [_P, _I, _P, _P],
    "multih_band_list": [_P, _I, _I, _P, _P, _P, _P],
    "multih_mean_field": [_P] * 5 + [_I, _P, _I, _I, _I, _F] + [_P] * 3,
    # q0; x1, x2 and their strides; valid, deg; Hs; active; thr and the
    # list; cap, inv_temps, the sizes and weights; the outputs, scratch
    # and stream
    "multih_mean_field_front": [_P] + [_P, _I, _I] * 2 + [_P, _I] * 2
                               + [_P, _I, _I, _I, _P, _I] + [_P] * 4
                               + [_I, _P, _I, _I, _I, _F, _F, _I]
                               + [_P] * 5,
    "multih_icm": [_P] * 5 + [_I] * 6 + [_F] + [_P] * 3,
    "multih_window_gather": [_P, _P] + [_I] * 7 + [_P, _P],
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


def library_dir(root=None) -> Path:
    """The host-keyed directory of the library under a cache root
    (`BUILD_ROOT` by default)."""
    return Path(cache.compile_cache_dir(str(root or BUILD_ROOT)))


@functools.lru_cache(maxsize=None)
def _toolchain() -> str:
    """nvcc's release line and the CUDA version torch was built for: a
    library built by another toolkit gets another name."""
    out = subprocess.run([_nvcc(), "--version"], capture_output=True,
                         text=True).stdout
    release = next((line.strip() for line in out.splitlines()
                    if "release" in line), out.strip())
    return f"{release}|torch.version.cuda {torch.version.cuda}"


def _digest(srcs) -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(_toolchain().encode())
    for p in srcs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path(root=None) -> Path:
    """Where the library of this tree, host and toolkit lives under the
    cache root `root` (`BUILD_ROOT` by default), built or not."""
    return library_dir(root) / f"libmultih_kernels_{_digest(sources())}.so"


def _check_card() -> None:
    """Refuse a card the library's code does not run on: FLAGS build
    sm_90a, compute capability 9.0 (Hopper) only."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the kernel library runs only on "
                           "a card")
    cap = torch.cuda.get_device_capability()
    if cap != (9, 0):
        raise RuntimeError(
            f"the kernel library is built for sm_90a (compute capability "
            f"9.0, Hopper); {torch.cuda.get_device_name()} has compute "
            f"capability {cap[0]}.{cap[1]}")


def _compile(srcs, so: Path) -> float:
    """nvcc every source (one process each, all at once) and link them
    into `so`; returns the seconds it took."""
    so.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=so.parent) as tmpdir:
        t0 = time.perf_counter()
        objs = [Path(tmpdir) / f"{p.stem}.o" for p in srcs]
        procs = [
            subprocess.Popen([_nvcc(), *FLAGS, "-c", str(p), "-o", str(o)],
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for p, o in zip(srcs, objs)
        ]
        logs = [proc.communicate()[0] for proc in procs]
        text = "".join(logs)
        failed = [p.name for p, proc in zip(srcs, procs)
                  if proc.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{text}")
        tmp = Path(tmpdir) / so.name
        proc = subprocess.run(
            [_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{proc.stderr}")
        so.with_suffix(".log").write_text(text)
        os.replace(tmp, so)  # atomic: concurrent builders agree
        return time.perf_counter() - t0


def _check_whole(so: Path) -> None:
    """OSError unless `so` holds the whole ELF image its header
    describes: dlopen maps a truncated library without complaint and the
    process dies of SIGBUS on the first page past the end."""
    with open(so, "rb") as fh:
        hdr = fh.read(64)
    if len(hdr) < 64 or hdr[:4] != b"\x7fELF" or hdr[4] != 2:
        raise OSError(f"{so}: not a whole 64-bit ELF file")
    phoff, shoff = struct.unpack_from("<QQ", hdr, 0x20)
    phsize, phnum, shsize, shnum = struct.unpack_from("<HHHH", hdr, 0x36)
    need = max(phoff + phsize * phnum, shoff + shsize * shnum)
    if so.stat().st_size < need:
        raise OSError(f"{so}: truncated ({so.stat().st_size} of {need} "
                      f"bytes)")


def _open(so: Path):
    _check_whole(so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def open_library(root=None):
    """(lib, path, build seconds, rebuilt) of the library under the cache
    root `root` (`BUILD_ROOT` by default): built first if its keyed file
    is missing, and rebuilt once, with a warning, if the file does not
    load. Leaves the process's library (`load`) alone."""
    srcs = sources()
    so = library_path(root)
    seconds = 0.0 if so.exists() else _compile(srcs, so)
    try:
        return _open(so), so, seconds, False
    except (OSError, AttributeError) as e:
        log.warning("kernel library %s does not load (%s); rebuilding it "
                    "from %s", so, e, CSRC)
    seconds = _compile(srcs, so)
    return _open(so), so, seconds, True


def load(root=None):
    """The process's ctypes library, built first if the cache root
    `root` (`BUILD_ROOT` by default) has no build for this host and
    toolkit. One library a process: the first call picks the root."""
    if _Library.lib is not None:
        return _Library.lib
    _check_card()
    lib, so, _Library.seconds, _ = open_library(root)
    log_path = so.with_suffix(".log")
    _Library.log = log_path.read_text() if log_path.exists() else ""
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
    """The current CUDA stream of t's device, as a pointer-sized int: the
    same handle as torch.cuda.current_stream(t.device).cuda_stream,
    without building a torch.cuda.Stream object on every launch (the
    raw accessor Triton's launcher takes)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def require_cuda(*tensors: torch.Tensor, dtype=torch.float32,
                 contiguous: bool = True) -> None:
    """Checks the kernels' inputs: CUDA, `dtype`, contiguous (unless the
    kernel takes strides)."""
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"expected a CUDA tensor, got {t.device}")
        if t.dtype != dtype:
            raise ValueError(f"expected {dtype}, got {t.dtype}")
        if contiguous and not t.is_contiguous():
            raise ValueError("expected a contiguous tensor")
