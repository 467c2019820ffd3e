"""Inlier counts of hypotheses over correspondences: the CUDA count
kernel and its plain PyTorch version.

Replaces ``multih_tpu/ops/kernels/residual_kernel.py`` (``_count_kernel``
via ``inlier_counts`` / ``inlier_counts_padded``), every kind: the
homography ``symmetric``, ``transfer`` and ``sampson`` and the
fundamental-matrix ``f_symmetric``, ``f_transfer`` and ``f_sampson``
(the model's residual kind with an ``f_`` prefix, as the JAX pipeline
names it). The kernel (``csrc/residual_kernel.cu``) is bound by
instruction issue, not by memory: it reads S*9 + 5*N floats and never
writes the (S, N) residual matrix. One warp (or a few, for a small
pool) per hypothesis holds H (or F) and H's adjugate in registers and
strides the points, which a block stages once in shared memory (past
one tile, or for a pool too small to fill the card, the points are
split over a thread-block cluster); the counts meet in an exact integer
sum, written once as float32.
A call is one launch: the kernel reads x1, x2, valid and the threshold
where they lie (any strides) and allocates nothing beside its output.

``approx_rcp`` (``cfg.pallas_approx_rcp``, default True) takes the
hardware fast reciprocal where the TPU kernel takes
``pl.reciprocal(..., approx=approx_rcp)``; False divides exactly. The
plain version always divides exactly. Counts may differ from it by
threshold-boundary ties (the fast reciprocal, or FMA contraction moving
the last bit of a residual); the JAX kernel's own tolerance against its
jnp path applies: max |dcount| <= 2, mean < 0.5.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from multih_tpu_torch.ops import fmodel, geometry
from multih_tpu_torch.ops.kernels import _build

KINDS = {"symmetric": 0, "transfer": 1, "sampson": 2,
         "f_symmetric": 3, "f_transfer": 4, "f_sampson": 5}


def launch_shape(s: int, n: int, sms: int, warps: int, tile: int,
                 max_split: int) -> tuple[int, int]:
    """(warps a hypothesis r, CTAs a cluster on the point axis) of the
    kernel, for a card of `sms` SMs and the kernel's `warps` a block,
    `tile` points staged at once and `max_split` CTAs a cluster: enough
    CTAs that each stages its share of the points once (up to
    max_split), then the most warps and CTAs that keep S * r * split
    within 32 warps an SM and >= 4 points a lane, so a small pool still
    fills the card."""
    def chunk(k):
        return -(-n // k)

    target = 32 * sms
    split = min(max_split, max(1, chunk(tile)))
    r = 1
    while (r < warps and s * 2 * r * split <= target
           and chunk(split) >= 2 * r * 128):
        r *= 2
    while (split < max_split and s * r * (split + 1) <= target
           and chunk(split + 1) >= r * 128):
        split += 1
    return r, split


@functools.lru_cache(maxsize=None)
def _limits(device_index: int) -> tuple[int, int, int, int]:
    """(SMs of the card, and the kernel's warps a block, tile and CTAs a
    cluster, as csrc/residual_kernel.cu defines them)."""
    buf = (ctypes.c_int * 3)()
    _build.check(_build.load().multih_inlier_counts_limits(buf),
                 "inlier_counts limits")
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return (sms, *buf)


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


def _check_kind(kind):
    if kind not in KINDS:
        raise ValueError(f"unsupported residual kind {kind!r}")


def _launch(Hs, x1, x2, valid, threshold_sq, kind, approx_rcp):
    """One kernel launch. Returns (S,) float32 counts."""
    if not (torch.is_tensor(threshold_sq) and threshold_sq.numel() == 1):
        raise ValueError("threshold_sq must be a one-element tensor on the "
                         "card")
    _build.require_cuda(Hs, x1, x2, valid, threshold_sq, contiguous=False)
    if len({t.device for t in (Hs, x1, x2, valid, threshold_sq)}) != 1:
        raise ValueError("inlier_counts: inputs on different devices")
    s, n = Hs.shape[0], x1.shape[0]
    r, split = launch_shape(s, n, *_limits(Hs.device.index))
    out = torch.empty(s, dtype=torch.float32, device=Hs.device)
    rc = _build.load().multih_inlier_counts(
        Hs.data_ptr(), s, *Hs.stride(), x1.data_ptr(), *x1.stride(),
        x2.data_ptr(), *x2.stride(), valid.data_ptr(), valid.stride(0), n,
        threshold_sq.data_ptr(), KINDS[kind], int(approx_rcp), r, split,
        out.data_ptr(), _build.stream_handle(Hs),
    )
    _build.check(rc, "inlier_counts")
    inlier_counts_padded.launches += 1
    inlier_counts_padded.kind_launches[kind] = (
        inlier_counts_padded.kind_launches.get(kind, 0) + 1)
    return out


def inlier_counts_padded(Hs, x1, x2, valid, threshold_sq,
                         kind: str = "symmetric", approx_rcp: bool = True):
    """Counts of (S, 3, 3) hypotheses over (N, 2) correspondences with
    (N,) float32 validity, as the pipeline holds them (the kernel needs
    no padding and no packing). A CPU tensor takes the plain version
    (which ignores `approx_rcp`); a CUDA tensor launches the kernel once
    and runs no other device op."""
    _check_kind(kind)
    n = x1.shape[0]
    if (x1.dim() != 2 or x1.shape[1] != 2 or x2.shape != x1.shape
            or valid.shape != (n,)):
        raise ValueError(f"expected x1, x2 (N, 2) and valid (N,), got "
                         f"{tuple(x1.shape)}, {tuple(x2.shape)}, "
                         f"{tuple(valid.shape)}")
    if Hs.device.type == "cpu":
        return inlier_counts_reference(Hs.reshape(-1, 3, 3), x1, x2, valid,
                                       threshold_sq, kind)
    return _launch(Hs.reshape(Hs.shape[0], 3, 3), x1, x2, valid,
                   threshold_sq, kind, approx_rcp)


inlier_counts_padded.launches = 0
inlier_counts_padded.kind_launches = {}  # the same launches, by kind
