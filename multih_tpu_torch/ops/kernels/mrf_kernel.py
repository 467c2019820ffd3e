"""Fused PEARL relaxation sweeps over the banded adjacency: the CUDA
mean-field and red-black ICM kernels and their plain PyTorch versions.

Replaces ``multih_tpu/ops/kernels/mrf_kernel.py`` (``_mf_kernel`` via
``mean_field_fused``, ``_icm_kernel`` via ``icm_fused``). Both need a
far-edge-free band (the windowed k-NN graph's): per Morton block b the
agreement is the (L, 3B) window of the state times band[b]^T, and block
0's left third and block nb-1's right third read zeros (labels -1).

The TPU grid runs (sweep, block) in order with the state in VMEM; on the
card, sweep s+1 of block b needs sweep s of blocks b-1, b, b+1, so the
kernels (``csrc/mrf_kernel.cu``) take one launch per sweep (per
half-sweep for ICM), the state double-buffered in device memory, all
launches issued from one C entry point: one ctypes call per function.
Each launch is one warp per point: the lanes stream the point's band row
in coalesced loads, add the non-zero entries' neighbour state into L
per-lane sums, and meet in a shuffle butterfly.

The plain versions repeat the kernels' arithmetic order (they are the
parity oracle on the card and the CPU tests' stand-in for the Pallas
kernels): mean-field z = -(base - sw*agree) * inv_temp[s], minus its max
over labels, exp, divided by the sum; ICM cost = base - sw*agree, a
compare-select argmin with strict < (first minimum wins), the current
label's cost by one-hot sum, and a move only on the half-sweep's parity
when better by more than 1e-6. In both, base = dct + sw*deg^T is built
by the caller.

Tolerances against the plain versions: mean-field q within 1e-5
max-abs (the band product sums in another order); ICM labels exact (the
band values {0, 0.5, 1} make every agreement sum exact, and the kernel
rounds sw*agree and the subtraction separately, as PyTorch does).

The wrappers take CUDA tensors only and raise on anything else; the
callers (labeling.mean_field_t, labeling._icm_batch) choose the plain
sweeps for CPU tensors.
"""

from __future__ import annotations

import torch

from multih_tpu_torch.ops.kernels import _build

MAX_LABELS = 64  # the kernels keep L per-lane sums in registers


def _band_window(state: torch.Tensor, nb: int, block: int, fill):
    """(R, N) -> (R, nb, 3B): each block's window of the state, with
    `fill` in the halos (no wrap)."""
    r = state.shape[0]
    pad = torch.full((r, block), fill, dtype=state.dtype,
                     device=state.device)
    padded = torch.cat([pad, state, pad], dim=1)  # (R, N + 2B)
    return padded.unfold(1, 3 * block, block)  # (R, nb, 3B)


def _agree(win: torch.Tensor, band: torch.Tensor) -> torch.Tensor:
    """(R, nb, 3B) windows x band (nb, B, 3B) -> (R, N) agreements."""
    r = win.shape[0]
    out = torch.bmm(win.transpose(0, 1), band.transpose(1, 2))  # (nb, R, B)
    return out.transpose(0, 1).reshape(r, -1)


def mean_field_fused_reference(q0_t, base_t, band, inv_temps,
                               spatial_weight: float) -> torch.Tensor:
    """Plain version of `mean_field_fused`, the kernel's arithmetic."""
    nb, block, _ = band.shape
    q = q0_t
    for s in range(inv_temps.shape[0]):
        agree = _agree(_band_window(q, nb, block, 0.0), band)
        z = -(base_t - spatial_weight * agree) * inv_temps[s]
        z = z - z.amax(0, keepdim=True)
        e = torch.exp(z)
        q = e / e.sum(0, keepdim=True)
    return q


def icm_fused_reference(labels0, base_t, band, iterations: int,
                        spatial_weight: float) -> torch.Tensor:
    """Plain version of `icm_fused`, the kernel's arithmetic."""
    nb, block, _ = band.shape
    ns, n = labels0.shape
    l = base_t.shape[0]
    ids = torch.arange(l, dtype=labels0.dtype, device=labels0.device)
    parity = torch.arange(n, device=labels0.device) % 2
    labels = labels0
    for h in range(2 * iterations):
        win = _band_window(labels, nb, block, -1)  # (S, nb, 3B)
        oh = (win[:, None] == ids[None, :, None, None]).to(base_t.dtype)
        agree = _agree(oh.reshape(ns * l, nb, 3 * block), band)
        cost = base_t[None] - spatial_weight * agree.reshape(ns, l, n)
        new_c = cost[:, 0]
        new = torch.zeros_like(labels)
        for lab in range(1, l):
            take = cost[:, lab] < new_c
            new_c = torch.where(take, cost[:, lab], new_c)
            new = torch.where(take, lab, new)
        cur_oh = (labels[:, None, :] == ids[None, :, None]).to(cost.dtype)
        cur_c = (cur_oh * cost).sum(1)
        move = (new_c < cur_c - 1e-6) & (parity[None, :] == h % 2)
        labels = torch.where(move, new, labels)
    return labels


def _check_band(band: torch.Tensor, n: int, rows: int):
    nb, block, bb = band.shape
    if bb != 3 * block or nb * block != n:
        raise ValueError(f"band {tuple(band.shape)} does not fit N={n}")
    if rows > MAX_LABELS:
        raise ValueError(f"{rows} labels > {MAX_LABELS}")


def mean_field_fused(q0_t: torch.Tensor, base_t: torch.Tensor,
                     band: torch.Tensor, inv_temps: torch.Tensor,
                     spatial_weight: float) -> torch.Tensor:
    """All annealed mean-field sweeps, one launch each.

    q0_t, base_t: (L, N) float32 label-major (base = dct + sw*deg^T);
    band: (nb, B, 3B) float32, far-free; inv_temps: (S,) float32.
    Returns the (L, N) marginals after S sweeps. CUDA tensors only."""
    _build.require_cuda(q0_t, base_t, band, inv_temps)
    l, n = q0_t.shape
    if base_t.shape != q0_t.shape or inv_temps.dim() != 1:
        raise ValueError(f"q0 {tuple(q0_t.shape)}, base "
                         f"{tuple(base_t.shape)}, inv_temps "
                         f"{tuple(inv_temps.shape)}")
    _check_band(band, n, l)
    nb, block, _ = band.shape
    n_sweeps = inv_temps.shape[0]
    if n_sweeps == 0:
        return q0_t.clone()
    out = torch.empty_like(q0_t)
    tmp = torch.empty_like(q0_t) if n_sweeps > 1 else out
    rc = _build.load().multih_mean_field(
        q0_t.data_ptr(), base_t.data_ptr(), band.data_ptr(),
        inv_temps.data_ptr(), n_sweeps, l, nb, block,
        float(spatial_weight), out.data_ptr(), tmp.data_ptr(),
        _build.stream_handle(q0_t),
    )
    _build.check(rc, "mean_field_fused")
    mean_field_fused.launches += 1
    return out


mean_field_fused.launches = 0


def icm_fused(labels0: torch.Tensor, base_t: torch.Tensor,
              band: torch.Tensor, iterations: int,
              spatial_weight: float) -> torch.Tensor:
    """All 2*iterations red-black ICM half-sweeps of S starts, one launch
    each, parity 0 first.

    labels0: (S, N) int32; base_t: (L, N) float32 (dct + sw*deg^T);
    band: (nb, B, 3B) float32, far-free. Returns (S, N) int32. The
    constant-labeling escape stays with the caller. CUDA tensors only."""
    _build.require_cuda(labels0, dtype=torch.int32)
    _build.require_cuda(base_t, band)
    ns, n = labels0.shape
    l = base_t.shape[0]
    if base_t.shape[1] != n:
        raise ValueError(f"labels {tuple(labels0.shape)}, base "
                         f"{tuple(base_t.shape)}")
    _check_band(band, n, l)
    nb, block, _ = band.shape
    if iterations <= 0:
        return labels0.clone()
    out = torch.empty_like(labels0)
    tmp = torch.empty_like(labels0)
    rc = _build.load().multih_icm(
        labels0.data_ptr(), base_t.data_ptr(), band.data_ptr(), iterations,
        ns, l, nb, block, float(spatial_weight), out.data_ptr(),
        tmp.data_ptr(), _build.stream_handle(labels0),
    )
    _build.check(rc, "icm_fused")
    icm_fused.launches += 1
    return out


icm_fused.launches = 0
