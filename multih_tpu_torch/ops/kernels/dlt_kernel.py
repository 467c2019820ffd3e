"""Batched minimal 4-point DLT homography solves: the CUDA kernel and its
plain PyTorch version.

Replaces ``multih_tpu/ops/kernels/dlt_kernel.py`` (``_dlt_kernel`` via
``homography_4pt_pallas_packed``). The kernel (``csrc/dlt_kernel.cu``)
is bound by the serial chain of its Givens rotations, not by memory or
flops. It exploits the DLT rows' block structure: the 6 rotations that
triangularise the quad's 4x3 point matrix triangularise both blocks of
the 8x9 system, and one more finishes it (7 steps of the chain in place
of the plain version's 28, the same R up to row signs and the same EPS
guards). One thread per solve works in registers, in double, and each
step takes a reciprocal square root (the hardware's float32 estimate
and a Newton step) in place of a square root and two divisions.

The entry, `homography_4pt_gt`, solves the sampler's (32, S) rows as
the pipeline holds them and returns the usable-quad mask beside the
H's, in one launch (the degeneracy and padded-point tests inside, bit
for bit as the plain version's).

Tolerance against the plain version: max-abs entry error < 5e-4 on
non-degenerate quads whose float32 solve is well conditioned (the JAX
kernel's own against its jnp path); ok exact. The kernel's H's are
within ~3e-8 of a float64 solve (float32 solves are not: ~1 random quad
in 50k is beyond 5e-4 of float64 in float32).
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
    """Plain version of the solves: geometry.homography_4pt_batch_qr on
    coordinate-major quads, (16, S) rows [x1: xa ya xb yb xc yc xd yd;
    then x2 likewise] -> (S, 3, 3)."""
    return geometry.homography_4pt_batch_qr(*_unpack(packed))


def homography_4pt_gt_reference(gt: torch.Tensor):
    """Plain version of `homography_4pt_gt`: the degeneracy test
    (geometry.quad_degenerate_t at 1e-4, both images), the padded-point
    test and `homography_4pt_packed_reference` on the quads, as eager
    ops. Returns (Hs (S, 3, 3), ok (S,))."""
    def row(q, c):
        return gt[8 * q + c]

    x1x = torch.stack([row(q, 0) for q in range(4)])  # (4, S)
    x1y = torch.stack([row(q, 1) for q in range(4)])
    x2x = torch.stack([row(q, 2) for q in range(4)])
    x2y = torch.stack([row(q, 3) for q in range(4)])
    degenerate = geometry.quad_degenerate_t(x1x, x1y, 1e-4) | \
        geometry.quad_degenerate_t(x2x, x2y, 1e-4)
    uses_pad = ((row(0, 4) == 0) | (row(1, 4) == 0)
                | (row(2, 4) == 0) | (row(3, 4) == 0))
    ok = (~(degenerate | uses_pad)).to(gt.dtype)
    packed = torch.cat(
        [torch.stack([x1x, x1y], dim=1).reshape(8, -1),
         torch.stack([x2x, x2y], dim=1).reshape(8, -1)], dim=0
    )  # (16, S): xa ya xb yb ... per image
    return homography_4pt_packed_reference(packed), ok


def homography_4pt_gt(gt: torch.Tensor):
    """Minimal solves of the sampler's (32, S) rows (row 8q + c = channel
    c of quad point q: x1, y1, x2, y2, avail; any strides) -> (Hs (S, 3,
    3), ok (S,)): ok is 0 where a quad has 3 (near-)collinear points in
    either image or uses a point whose avail is 0. A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel once and runs no
    other device op."""
    if gt.dim() != 2 or gt.shape[0] != 32:
        raise ValueError(f"sampler rows must be (32, S), got "
                         f"{tuple(gt.shape)}")
    if gt.device.type == "cpu":
        return homography_4pt_gt_reference(gt)
    _build.require_cuda(gt, contiguous=False)
    s = gt.shape[1]
    out = torch.empty((s, 3, 3), dtype=torch.float32, device=gt.device)
    ok = torch.empty(s, dtype=torch.float32, device=gt.device)
    rs, cs = gt.stride()
    rc = _build.load().multih_dlt_4pt_gt(
        gt.data_ptr(), s, rs, cs, out.data_ptr(), ok.data_ptr(),
        _build.stream_handle(gt)
    )
    _build.check(rc, "homography_4pt_gt")
    homography_4pt_gt.launches += 1
    return out, ok


homography_4pt_gt.launches = 0
