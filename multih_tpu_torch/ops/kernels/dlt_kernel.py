"""Batched minimal 4-point DLT homography solves: the CUDA kernel and its
plain PyTorch version.

Replaces ``multih_tpu/ops/kernels/dlt_kernel.py`` (``_dlt_kernel`` via
``homography_4pt_pallas_packed``). The kernel (``csrc/dlt_kernel.cu``)
is bound by registers and latency, not memory: each solve is ~1.5k
flops over 72 matrix entries with 25 floats of traffic. One thread per
hypothesis keeps the whole 8x9 system in registers, fully unrolled with
the JAX kernel's EPS guards and rotation order; thread s reads and
writes column s of the (16, S) / (9, S) layouts, so accesses coalesce.

Tolerance against the plain version: max-abs entry error < 5e-4 on
non-degenerate quads (the JAX kernel's own against its jnp path).
"""

from __future__ import annotations

import torch

from multih_tpu_torch.ops import geometry
from multih_tpu_torch.ops.kernels import _build


def _unpack(packed):
    """(16, S) -> two (S, 4, 2) point quads."""
    s = packed.shape[1]
    return packed[:8].T.reshape(s, 4, 2), packed[8:].T.reshape(s, 4, 2)


def homography_4pt_packed_reference(packed: torch.Tensor) -> torch.Tensor:
    """Plain version: geometry.homography_4pt_batch_qr on the unpacked
    quads. (16, S) -> (S, 3, 3)."""
    return geometry.homography_4pt_batch_qr(*_unpack(packed))


def homography_4pt_packed(packed: torch.Tensor) -> torch.Tensor:
    """Minimal solves from coordinate-major packed coords: (16, S) rows
    [x1: xa ya xb yb xc yc xd yd; then x2 likewise] -> (S, 3, 3).
    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel."""
    if packed.dim() != 2 or packed.shape[0] != 16:
        raise ValueError(f"packed quads must be (16, S), got "
                         f"{tuple(packed.shape)}")
    if packed.device.type == "cpu":
        return homography_4pt_packed_reference(packed)
    _build.require_cuda(packed)
    s = packed.shape[1]
    out = torch.empty((9, s), dtype=torch.float32, device=packed.device)
    rc = _build.load().multih_dlt_4pt(
        packed.data_ptr(), s, out.data_ptr(), _build.stream_handle(packed)
    )
    _build.check(rc, "homography_4pt_packed")
    homography_4pt_packed.launches += 1
    return out.T.reshape(s, 3, 3)


homography_4pt_packed.launches = 0
