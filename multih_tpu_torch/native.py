"""ctypes binding of the C++ alpha-expansion solver: the host parity
oracle of the port's relaxation.

Counterpart of ``multih_tpu/native.py``, with the same functions and
results, built from the port's own copy of the source
(``multih_tpu_torch/csrc/expansion.cpp``). The reference's discrete
optimizer is gco-v3.0's alpha-expansion; the fits replace it with
mean-field and ICM, and this solver gives the exact-move answer those are
held against (tests/test_torch_native.py). It runs on the host only.

The library is built with g++ at first use into a host-keyed directory
under the build root (``build/multih_tpu_torch_native-<host>/``,
``utils/cache.compile_cache_dir``), named by a hash of the source and the
flags, so that another host or an edited source builds anew.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

from multih_tpu_torch.utils import cache

_PKG = Path(__file__).resolve().parent
_SRC = _PKG / "csrc" / "expansion.cpp"
BUILD_ROOT = _PKG.parent / "build" / "multih_tpu_torch_native"
_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-Wall"]

_lib = None


def library_path() -> Path:
    """The library's path: the host-keyed directory under BUILD_ROOT, the
    file named by a hash of the source and the flags."""
    h = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode())
    return (Path(cache.compile_cache_dir(str(BUILD_ROOT)))
            / f"libexpansion_{h.hexdigest()[:16]}.so")


def _build(so: Path) -> None:
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", str(tmp)], check=True,
                   capture_output=True)
    os.replace(tmp, so)  # whole, also under concurrent first uses


def available() -> bool:
    try:
        load()
        return True
    except Exception:
        return False


def load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    so = library_path()
    if not so.exists():
        _build(so)
    lib = ctypes.CDLL(str(so))
    lib.expansion_solve.restype = ctypes.c_double
    lib.expansion_solve.argtypes = [
        ctypes.c_int32,                                   # n
        ctypes.c_int32,                                   # L
        np.ctypeslib.ndpointer(np.float64, flags="C"),    # data_costs
        ctypes.c_int32,                                   # n_edges
        np.ctypeslib.ndpointer(np.int32, flags="C"),      # edge_pq
        np.ctypeslib.ndpointer(np.float64, flags="C"),    # edge_w
        ctypes.c_double,                                  # lambda
        np.ctypeslib.ndpointer(np.float64, flags="C"),    # label_costs
        np.ctypeslib.ndpointer(np.int32, flags="C"),      # init_labels
        ctypes.c_int32,                                   # max_cycles
        np.ctypeslib.ndpointer(np.int32, flags="C"),      # out_labels
    ]
    _lib = lib
    return lib


def expansion_solve(
    data_costs: np.ndarray,
    edge_pq: np.ndarray,
    edge_w: np.ndarray,
    spatial_weight: float,
    label_costs: np.ndarray,
    init_labels: np.ndarray | None = None,
    max_cycles: int = 10,
):
    """Minimize E(L) = sum D[p,L(p)] + lambda/2 * sum_directed w[L(p)!=L(q)]
    + sum_{used l} h_l via alpha-expansion with label costs.

    Args:
      data_costs: (N, L) float64.
      edge_pq: (E, 2) int32 directed edges (both directions of the k-NN
        graph, exactly as the port's symmetrized energy counts them).
      edge_w: (E,) float64 edge weights.
      spatial_weight: lambda.
      label_costs: (L,) float64 per-label cost (0 to disable).
      init_labels: (N,) int32 start labeling (default: per-point argmin).

    Returns:
      (labels (N,) int32, energy float)
    """
    lib = load()
    d = np.ascontiguousarray(data_costs, np.float64)
    n, L = d.shape
    pq = np.ascontiguousarray(edge_pq, np.int32).reshape(-1, 2)
    w = np.ascontiguousarray(edge_w, np.float64).reshape(-1)
    assert pq.shape[0] == w.shape[0]
    h = np.ascontiguousarray(label_costs, np.float64)
    assert h.shape == (L,)
    if init_labels is None:
        init_labels = d.argmin(axis=1).astype(np.int32)
    init = np.ascontiguousarray(init_labels, np.int32)
    out = np.empty(n, np.int32)
    e = lib.expansion_solve(
        n, L, d, pq.shape[0], pq, w, float(spatial_weight), h, init,
        int(max_cycles), out,
    )
    return out, float(e)
