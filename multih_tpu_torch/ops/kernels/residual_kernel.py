"""Inlier counts of hypotheses over correspondences: the CUDA count
kernel and its plain PyTorch version.

Replaces ``multih_tpu/ops/kernels/residual_kernel.py`` (``_count_kernel``
via ``inlier_counts`` / ``inlier_counts_padded``), every kind: the
homography ``symmetric``, ``transfer`` and ``sampson`` and the
fundamental-matrix ``f_symmetric``, ``f_transfer`` and ``f_sampson``
(the model's residual kind with an ``f_`` prefix, as the JAX pipeline
names it). The kernel (``csrc/residual_kernel.cu``) is bound by fp32
arithmetic and IEEE division, not by memory: it reads S*9 + 5*N floats
and never writes the (S, N) residual matrix. One thread per hypothesis
holds H (or F) and H's adjugate in registers, point tiles are staged in
shared memory, and the point axis is split over the grid so small pools
still fill the card; partial counts meet in an int32 atomicAdd, so the
result is exact and deterministic.

Counts may differ from the plain version by threshold-boundary ties
(FMA contraction moves the last bit of a residual); the JAX kernel's own
tolerance against its jnp path applies: max |dcount| <= 2, mean < 0.5.
"""

from __future__ import annotations

import torch

from multih_tpu_torch.ops import fmodel, geometry
from multih_tpu_torch.ops.kernels import _build

KINDS = {"symmetric": 0, "transfer": 1, "sampson": 2,
         "f_symmetric": 3, "f_transfer": 4, "f_sampson": 5}


def pack_points(x1, x2, valid):
    """(N, 2) x2 + (N,) -> (8, N) rows [x1, y1, x2, y2, valid, 0, 0, 0]."""
    zeros = torch.zeros((3, x1.shape[0]), dtype=x1.dtype, device=x1.device)
    return torch.cat([x1.T, x2.T, valid[None, :].to(x1.dtype), zeros])


def inlier_counts_reference(Hs, x1, x2, valid, threshold_sq,
                            kind: str = "symmetric", chunk: int = 512):
    """Plain version: hypothesis chunks through geometry.residual_matrix
    (fmodel.residual_matrix_f for an ``f_`` kind), thresholded and
    reduced at once — the algebra of the JAX pipeline's non-kernel
    count_inliers branch. Returns (S,) float32 counts."""
    if kind.startswith("f_"):
        def residuals(h):
            return fmodel.residual_matrix_f(h, x1, x2, kind[2:])
    else:
        def residuals(h):
            return geometry.residual_matrix(h, x1, x2, kind)
    out = []
    for c0 in range(0, Hs.shape[0], chunk):
        r = residuals(Hs[c0:c0 + chunk])
        out.append(((r < threshold_sq).to(x1.dtype) * valid[None, :]).sum(1))
    if not out:
        return torch.zeros(0, dtype=x1.dtype, device=x1.device)
    return torch.cat(out)


def inlier_counts(Hs, packed_pts, threshold_sq, kind: str = "symmetric"):
    """Per-hypothesis inlier counts, residual < threshold_sq and valid.

    Hs: (S, 3, 3) or (S, 9) float32; packed_pts: (8, N) from
    `pack_points`; threshold_sq: 0-dim float32 tensor. Returns (S,)
    float32. A CPU tensor takes the plain version; a CUDA tensor launches
    the kernel."""
    if kind not in KINDS:
        raise ValueError(f"unsupported residual kind {kind!r}")
    s = Hs.shape[0]
    if Hs.device.type == "cpu":
        p = packed_pts
        return inlier_counts_reference(
            Hs.reshape(s, 3, 3), p[0:2].T, p[2:4].T, p[4], threshold_sq, kind
        )
    h_flat = Hs.reshape(s, 9)
    thr = torch.as_tensor(threshold_sq, dtype=torch.float32,
                          device=Hs.device).reshape(())
    _build.require_cuda(h_flat, packed_pts, thr)
    if packed_pts.dim() != 2 or packed_pts.shape[0] != 8:
        raise ValueError(f"packed points must be (8, N), got "
                         f"{tuple(packed_pts.shape)}")
    n = packed_pts.shape[1]
    out = torch.zeros(s, dtype=torch.int32, device=Hs.device)  # atomics
    rc = _build.load().multih_inlier_counts(
        h_flat.data_ptr(), s, packed_pts.data_ptr(), n, thr.data_ptr(),
        KINDS[kind], out.data_ptr(), _build.stream_handle(Hs),
    )
    _build.check(rc, "inlier_counts")
    inlier_counts.launches += 1
    inlier_counts.kind_launches[kind] = (
        inlier_counts.kind_launches.get(kind, 0) + 1)
    return out.to(torch.float32)


inlier_counts.launches = 0
inlier_counts.kind_launches = {}  # the same launches, by residual kind


def inlier_counts_padded(Hs, x1, x2, valid, threshold_sq,
                         kind: str = "symmetric"):
    """Counts of (S, 3, 3) hypotheses over (N, 2) correspondences: packs
    the points and calls `inlier_counts` (the kernel needs no padding)."""
    return inlier_counts(
        Hs.contiguous(), pack_points(x1, x2, valid).contiguous(),
        threshold_sq, kind,
    )
