"""The Multi-H fit in PyTorch: correspondences in, per-point plane labels
and homographies out.

Counterpart of ``multih_tpu/models/pipeline.py::fit``, homography branch,
stage for stage: Morton sort -> k-NN graph (windowed or exact) + banded
adjacency -> progressive hypothesis generation (sampling + minimal 4-pt
DLT) ->
verification counts + top-M -> LO refine (moment refit + 9x9 eigensolve)
-> NMS select -> PEARL iterations -> finalize. Each stage is wrapped in a
``torch.profiler.record_function`` of the JAX ``named_scope``'s name.

The fit runs eagerly and forward-only, on the card unless the caller
asks for the CPU (`fit`'s `device`). With ``cfg.use_pallas`` and CUDA
tensors the hand-written kernels carry the count sweeps, the minimal
solves, the refit eigensolves, the mean-field and ICM sweeps (on the
windowed graph's far-free band) and the window-sampling gathers
(`_kernels_enabled`); otherwise their plain PyTorch versions run, as the
JAX package runs its jnp paths off the TPU.

Where the port is likely to diverge from the reference, the code says
so: `jax.lax.top_k`'s tie order (lower index first) is reproduced with a
stable descending sort (ops.topk.top_k_stable), every argsort is
stable, `.at[].add` scatters are index_add_, and lax.scan / fori_loop
bodies are Python loops that never wait on the device.

Out of the port so far, `fit` raises NotImplementedError: the
fundamental model, the fused front, affine and seed hypotheses, a mesh,
the gather-path labeling and the direct (non-moment) refit.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from multih_tpu_torch.config import MultiHConfig
from multih_tpu_torch.models import labeling, selection
from multih_tpu_torch.ops import geometry, sampling
from multih_tpu_torch.ops.kernels import dlt_kernel, residual_kernel
from multih_tpu_torch.ops.topk import top_k_stable

# Precision.HIGHEST in the reference: geometry contractions in full fp32
# (reduced-precision products lost whole planes; docs/ARCHITECTURE.md).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


class FitResult(NamedTuple):
    """The fit's outputs (multih_tpu.models.pipeline.FitResult)."""

    labels: torch.Tensor           # (N,) int32 in [0, K]; K = outlier
    homographies: torch.Tensor     # (K, 3, 3) float32, ||H||_F = 1
    active: torch.Tensor           # (K,) float {0,1}
    support: torch.Tensor          # (K,) float — inliers per plane
    energy: torch.Tensor           # () final PEARL energy
    energy_trace: torch.Tensor     # (pearl_iterations,)
    n_hypotheses_ok: torch.Tensor  # () non-degenerate hypotheses
    n_far_dropped: torch.Tensor    # () int32 far k-NN edges beyond the
                                   # banded operator's capacity


def pad_points(x1, x2, gt_labels=None, max_points: int = 512):
    """Pad (n, 2) correspondence arrays to max_points with a validity
    mask (numpy in, numpy out)."""
    n = x1.shape[0]
    if n > max_points:
        raise ValueError(f"{n} points > max_points={max_points}")
    pad = max_points - n
    x1p = np.pad(np.asarray(x1, np.float32), ((0, pad), (0, 0)))
    x2p = np.pad(np.asarray(x2, np.float32), ((0, pad), (0, 0)))
    valid = np.zeros((max_points,), np.float32)
    valid[:n] = 1.0
    out = (x1p, x2p, valid)
    if gt_labels is not None:
        out = out + (np.pad(np.asarray(gt_labels, np.int32), (0, pad),
                            constant_values=-1),)
    return out


def _interleave10(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of v to even bit positions (Morton)."""
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton_order(pts: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Z-order sort permutation of the points, invalid last (stable, as
    jnp.argsort at pipeline.py:100). Codes are int64: torch has no
    general uint32 arithmetic, and every code fits below 2^32."""
    vmask = valid[:, None] > 0
    lo = torch.where(vmask, pts, float("inf")).amin(0)
    hi = torch.where(vmask, pts, float("-inf")).amax(0)
    extent = torch.clamp_min(hi - lo, 1e-3)
    q = torch.clamp((pts - lo) / extent * 1023.0, 0.0, 1023.0).to(torch.int64)
    code = _interleave10(q[:, 0]) | (_interleave10(q[:, 1]) << 1)
    code = torch.where(valid > 0, code, 0xFFFFFFFF)
    return torch.argsort(code, stable=True)


def _thr(cfg: MultiHConfig, tau, ref: torch.Tensor) -> torch.Tensor:
    """Squared inlier threshold as a 0-dim tensor on ref's device."""
    if tau is None:
        return torch.full((), cfg.inlier_threshold ** 2, dtype=ref.dtype,
                          device=ref.device)
    t = torch.as_tensor(tau, dtype=ref.dtype, device=ref.device)
    return t * t


def _kernels_enabled(cfg: MultiHConfig, device: torch.device) -> bool:
    """The hand-written kernels run on CUDA tensors when cfg.use_pallas;
    everything else takes the plain PyTorch paths (the counterpart of
    pipeline._pallas_enabled)."""
    return cfg.use_pallas and device.type == "cuda"


def banded_gate(cfg: MultiHConfig, n_pts: int) -> bool:
    """Whether the banded agreement operator is eligible: Morton-sorted
    points and a block-aligned N (multih_tpu pipeline.banded_gate)."""
    return (cfg.agree_block > 0 and cfg.spatial_sort
            and n_pts % cfg.agree_block == 0
            and n_pts >= 2 * cfg.agree_block)


def graph_path(cfg: MultiHConfig, n_pts: int) -> str:
    """'windowed', 'row_blocked' or 'row_blocked_approx', as fit()
    selects them in the reference."""
    if banded_gate(cfg, n_pts) and cfg.knn_window:
        return "windowed"
    return "row_blocked_approx" if cfg.knn_approx else "row_blocked"


def model_residual_matrix(Ms, x1, x2, kind, cfg: MultiHConfig):
    """(S, 3, 3) models x (N, 2) points -> (S, N) squared residuals."""
    return geometry.residual_matrix(Ms, x1, x2, kind)


def _prepare_refit_basis(x1, x2, cfg: MultiHConfig):
    return geometry.prepare_refit(x1, x2)


def _refit_batch(w, basis, cfg: MultiHConfig):
    """(C, N) weights -> (C, 3, 3) moment-formulated batched refit; the
    eigensolve takes the kernel on CUDA (geometry.py:502-509's rule)."""
    return geometry.homography_refit_batch(
        w, basis, cfg.eig_method, cfg.eig_iterations,
        eig_kernel=_kernels_enabled(cfg, w.device),
    )


# ---------------------------------------------------------------------------
# stages
# ---------------------------------------------------------------------------

def _round_sample_indices(draws, stream, avail, nbr_idx, nbr_ok,
                          n_samples: int, m: int = 4):
    """(S, 4) index tuples for one progressive round: the first half
    uniform over `avail`, the second locality-biased."""
    if m != 4:
        raise NotImplementedError("only the homography quad sampler")
    s_local = n_samples // 2
    idx_u = sampling.sample_indices(draws, stream, n_samples - s_local,
                                    avail > 0, m=m)
    idx_l = sampling.localized_sample_indices(
        draws, stream, s_local, avail > 0, nbr_idx, nbr_ok
    )
    return torch.cat([idx_u, idx_l], dim=0)


def _solve_minimal(x1, x2, avail, idx, cfg: MultiHConfig):
    """Minimal 4-pt solves for (S, 4) sample indices: one row gather of a
    packed (N, 8) array, transposed to (32, S) coordinate-major rows."""
    s = idx.shape[0]
    packed_src = torch.cat(
        [x1, x2, avail[:, None],
         torch.zeros((x1.shape[0], 3), dtype=x1.dtype, device=x1.device)],
        dim=1,
    )  # (N, 8)
    gt = packed_src[idx].reshape(s, 32).T  # (32, S)
    return _solve_from_gt(gt, cfg)


def _solve_from_gt(gt, cfg: MultiHConfig):
    """(32, S) rows (row 8q+c = channel c of quad point q; channel 4 =
    avail) -> (Hs (S, 3, 3), ok (S,))."""
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
    if _kernels_enabled(cfg, gt.device):
        Hs = dlt_kernel.homography_4pt_packed(packed)
    else:
        Hs = dlt_kernel.homography_4pt_packed_reference(packed)
    return Hs, ok


def count_inliers(Hs, x1, x2, valid, cfg: MultiHConfig, tau=None,
                  kind: str | None = None):
    """Inlier counts of the whole pool without materializing (S, N): the
    count kernel on CUDA, residual_chunk-sized chunks of the plain
    residual otherwise. `kind` overrides cfg.residual."""
    kind = kind or cfg.residual
    thr = _thr(cfg, tau, x1)
    if _kernels_enabled(cfg, x1.device):
        return residual_kernel.inlier_counts_padded(Hs, x1, x2, valid, thr,
                                                    kind=kind)
    return residual_kernel.inlier_counts_reference(
        Hs, x1, x2, valid, thr, kind, chunk=cfg.residual_chunk
    )


def generate_hypotheses(draws, x1, x2, valid, nbr_idx, cfg: MultiHConfig,
                        tau=None, window_block: int = 0):
    """Minimal-sample hypotheses in cfg.progressive_rounds guided rounds:
    after each round its top-R candidates are LO-grown together, greedily
    accepted when mostly novel, and their inliers claimed, so the next
    round samples among unclaimed points. With `window_block` > 0 a
    round whose sample count divides into the N // window_block Morton
    windows draws window-stratified samples
    (sampling.windowed_quadruples). Returns (Hs, ok)."""
    rounds = max(1, cfg.progressive_rounds)
    n_claim = max(1, cfg.claims_per_round)
    s_round = cfg.n_hypotheses // rounds
    s_rem = cfg.n_hypotheses - s_round * (rounds - 1)
    thr = _thr(cfg, tau, x1)

    claimed = torch.zeros_like(valid)
    pools, oks = [], []
    for r in range(rounds):
        avail = valid * (1.0 - claimed)
        # too few unclaimed points: fall back to all valid, branch-free
        enough = (avail.sum() >= 16.0).to(x1.dtype)
        avail = avail * enough + valid * (1.0 - enough)
        n_s = s_rem if r == rounds - 1 else s_round
        if window_block > 0 and n_s % (x1.shape[0] // window_block) == 0:
            gt = sampling.windowed_quadruples(
                draws, r, x1, x2, avail, nbr_idx, n_s, window_block,
                use_kernel=_kernels_enabled(cfg, x1.device),
            )
            Hs_r, ok_r = _solve_from_gt(gt, cfg)
        else:
            nbr_ok = avail[nbr_idx]
            idx = _round_sample_indices(draws, r, avail, nbr_idx, nbr_ok,
                                        n_s)
            Hs_r, ok_r = _solve_minimal(x1, x2, avail, idx, cfg)
        pools.append(Hs_r)
        oks.append(ok_r)
        if r == rounds - 1:
            break
        ss = max(1, cfg.claim_subsample)
        counts_av = count_inliers(
            Hs_r, x1[::ss], x2[::ss], avail[::ss], cfg, tau,
            kind=cfg.rank_residual or None,
        ) * ok_r
        # pipeline.py:393: top_k tie order
        _, i_top = top_k_stable(counts_av, min(n_claim, n_s))
        H_grown = lo_refine_candidates(
            Hs_r[i_top], x1, x2, valid, cfg, cfg.lo_rounds, tau
        )
        r_grown = model_residual_matrix(H_grown, x1, x2, cfg.residual, cfg)
        inl = (r_grown < thr).to(x1.dtype) * valid[None, :]  # (R, N)
        # greedy disjoint accept, strongest first — tensor ops only
        accepted = []
        for j in range(H_grown.shape[0]):
            n_novel = (inl[j] * (1.0 - claimed)).sum()
            acc = ((n_novel >= cfg.min_inliers)
                   & (n_novel >= 0.5 * inl[j].sum())).to(x1.dtype)
            claimed = torch.clamp(claimed + inl[j] * acc, 0.0, 1.0)
            accepted.append(acc)
        pools.append(H_grown)
        oks.append(torch.stack(accepted))
    return torch.cat(pools), torch.cat(oks)


def refit_planes(Hs, labels, residuals, x1, x2, valid, cfg: MultiHConfig,
                 tau=None, basis=None):
    """Re-estimate every plane from its assigned points with Tukey-biweight
    weights gated by the current residual, all planes in one batched
    refit; planes with fewer than 4 weighted members keep their H."""
    k = cfg.max_labels
    thr = _thr(cfg, tau, x1)
    member = F.one_hot(labels.long(), k + 1)[:, :k].to(x1.dtype) \
        * valid[:, None]  # (N, K)
    support = member.sum(0)
    rr = torch.clamp(residuals.T / thr, 0.0, 1.0)
    tukey = (1.0 - rr) ** 2 * (residuals.T < thr)
    w = member * tukey
    eff_support = (w > 0).to(x1.dtype).sum(0)
    if basis is None:
        basis = _prepare_refit_basis(x1, x2, cfg)
    Hs_mom = _refit_batch(w.T, basis, cfg)
    Hs_new = torch.where((eff_support >= float(cfg.minimal_points))
                         [:, None, None], Hs_mom, Hs)
    return Hs_new, support


def merge_duplicate_planes(r, support, active, thr, merge_iou: float,
                           containment: bool = True):
    """Deactivate planes whose inlier sets duplicate a stronger plane's
    (containment: intersection over the smaller set), greedy in order of
    support. The fori_loop (pipeline.py:783) is a loop of tensor ops."""
    k = r.shape[0]
    masks = (r < thr).to(r.dtype) * active[:, None]
    counts = masks.sum(1)
    inter = masks @ masks.T
    if containment:
        denom = torch.minimum(counts[:, None], counts[None, :])
    else:
        denom = counts[:, None] + counts[None, :] - inter
    iou = inter / torch.clamp_min(denom, 1.0)
    # pipeline.py:772/:774: jnp.argsort is stable
    order = torch.argsort(-(support + 1e-3 * counts), stable=True)
    pos = torch.argsort(order, stable=True)
    keep = active.clone()
    for i in range(k):
        l = order[i:i + 1]
        earlier = pos < pos[l]
        dup = torch.any(earlier & (keep > 0) & (iou[l][0] >= merge_iou))
        keep[l] = torch.where(dup, 0.0, keep[l])
    return keep


def lo_refine_candidates(Hs, x1, x2, valid, cfg: MultiHConfig, rounds: int,
                         tau=None):
    """LO-RANSAC growth of candidates: `rounds` batched Tukey refits at
    geometrically shrinking thresholds (4tau, 2tau, tau), each kept only
    if the inlier count at tau does not drop. The lax.scan over rounds
    (pipeline.py:840) is a Python loop."""
    thr = _thr(cfg, tau, x1)

    def count(r):
        return ((r < thr) * valid[None, :]).sum(1)

    basis = _prepare_refit_basis(x1, x2, cfg)
    m_min = float(cfg.minimal_points)
    for i in range(rounds):
        thr_r = thr * cfg.lo_shrink_eff ** (rounds - 1 - i)
        r = model_residual_matrix(Hs, x1, x2, cfg.residual, cfg)
        rr = torch.clamp(r / thr_r, 0.0, 1.0)
        w = ((1.0 - rr) ** 2 * (r < thr_r)) * valid[None, :]
        enough = (w > 0).to(x1.dtype).sum(1) >= m_min
        Hs_new = torch.where(enough[:, None, None],
                             _refit_batch(w, basis, cfg), Hs)
        r_new = model_residual_matrix(Hs_new, x1, x2, cfg.residual, cfg)
        better = (count(r_new) >= count(r))[:, None, None]
        Hs = torch.where(better, Hs_new, Hs)
    return Hs


def _pearl_iteration(carry, it: int, x1, x2, valid, nbr_idx, nbr_w,
                     cfg: MultiHConfig, tau=None, adj=None):
    """One PEARL alternation: residuals -> data costs -> mean-field + ICM
    -> refit -> accept -> merge duplicates -> label-cost prune (only in
    the second half of the iterations)."""
    Hs, active, q = carry
    thr = _thr(cfg, tau, x1)
    k = cfg.max_labels
    use_k = _kernels_enabled(cfg, x1.device)

    r = model_residual_matrix(Hs, x1, x2, cfg.residual, cfg)  # (K, N)
    dct = labeling.data_costs_t(r, valid, thr, cfg.outlier_cost, active)
    q = labeling.mean_field_t(
        dct, nbr_idx, nbr_w, cfg.spatial_weight, cfg.meanfield_iterations,
        cfg.temperature_start, cfg.temperature, q_init=q, adj=adj,
        use_kernel=use_k,
    )
    # two ICM starts: the mean-field argmax and the data argmin
    labels = labeling.best_labeling_t(
        [torch.argmax(q, dim=0), torch.argmin(dct, dim=0)],
        dct, nbr_idx, nbr_w, cfg.spatial_weight, cfg.icm_iterations,
        adj=adj, use_kernel=use_k,
    )

    # refit on assignments; accept per plane if global inliers don't drop
    Hs_new, support = refit_planes(Hs, labels, r, x1, x2, valid, cfg, tau)
    r_new = model_residual_matrix(Hs_new, x1, x2, cfg.residual, cfg)
    in_old = ((r < thr) * valid[None, :]).sum(1)
    in_new = ((r_new < thr) * valid[None, :]).sum(1)
    better = (in_new >= in_old)[:, None, None]
    Hs = torch.where(better, Hs_new, Hs)
    r_acc = torch.where(better[..., 0], r_new, r)

    active = merge_duplicate_planes(r_acc, support, active, thr,
                                    cfg.merge_iou, containment=True)

    # PEARL label cost: drop the plane whose removal lowers the energy
    # the most, if any (one greedy removal for homographies), as tensor
    # ops — the fori_loop at pipeline.py:973 with its single trip
    prune_on = it >= cfg.pearl_iterations // 2
    if prune_on:
        oh_lab = (labels[None, :] == torch.arange(
            k + 1, device=labels.device)[:, None]).to(x1.dtype)
        dct_now = labeling.data_costs_t(r_acc, valid, thr, cfg.outlier_cost,
                                        active)
        member = oh_lab[:k] * valid[None, :] * active[:, None]
        own = (oh_lab * dct_now).sum(0)
        runner = torch.where(oh_lab > 0, float("inf"), dct_now).amin(0)
        switch_cost = ((runner - own)[None, :] * member).sum(1)
        gain = cfg.label_cost - switch_cost
        worst = torch.argmax(torch.where(active > 0, gain,
                                         float("-inf"))).view(1)
        active = active.clone()
        active[worst] = torch.where(gain[worst] > 0, 0.0, active[worst])
        # drop tiny planes once the growth phase is over
        active = active * (support >= cfg.min_inliers).to(active.dtype)

    energy = labeling.total_energy_t(
        labels, dct, nbr_idx, nbr_w, cfg.spatial_weight, cfg.label_cost,
        active, adj=adj,
    )
    return (Hs, active, q), energy


def _check_slice(cfg: MultiHConfig, n_pts: int, affines, seed_Hs, mesh):
    """NotImplementedError for everything outside the ported slice."""
    unsupported = []
    if cfg.model != "homography":
        unsupported.append(f"model={cfg.model!r}")
    if not banded_gate(cfg, n_pts):
        unsupported.append("the gather-path labeling (needs spatial_sort "
                           "and N a multiple >= 2 of agree_block)")
    if cfg.mrf_fused_front:
        unsupported.append("mrf_fused_front")
    if not cfg.refit_moments:
        unsupported.append("refit_moments=False")
    if affines is not None:
        unsupported.append("affine one-point hypotheses")
    if seed_Hs is not None:
        unsupported.append("seed homographies")
    if mesh is not None:
        unsupported.append("a device mesh")
    if unsupported:
        raise NotImplementedError(
            "not ported yet: " + ", ".join(unsupported)
        )


def _inputs(x1, x2, valid, device):
    """float32 tensors of the inputs. Tensors keep their device; arrays
    and lists go to `device`, by default the card. Asking for the card
    without one raises: the fit never falls back to the CPU quietly."""
    dev = torch.device("cuda" if device is None else device)

    def one(a):
        if isinstance(a, torch.Tensor):
            return a.to(torch.float32)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' (or CPU "
                               "tensors) to fit on the CPU")
        return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                               device=dev)

    return one(x1), one(x2), one(valid)


@torch.inference_mode()
def fit(x1, x2, valid, key, cfg: MultiHConfig, affines=None, tau=None,
        seed_Hs=None, seed_ok=None, mesh=None, device=None) -> FitResult:
    """Full Multi-H fit on one padded correspondence set.

    x1, x2: (N, 2) float32; valid: (N,) float {0,1}. Tensors keep their
    device; numpy arrays or lists go to `device`, by default the card
    (see `_inputs`). key: a ``torch.Generator`` on the points' device, or
    a draw source (ops/sampling.py). tau: optional inlier threshold in px
    overriding cfg.inlier_threshold. affines / seed_Hs / seed_ok / mesh
    exist for signature parity with the reference and are not ported."""
    x1, x2, valid = _inputs(x1, x2, valid, device)
    n_pts = x1.shape[0]
    _check_slice(cfg, n_pts, affines, seed_Hs, mesh)
    if isinstance(key, torch.Generator):
        if key.device.type != x1.device.type:
            raise ValueError(f"generator on {key.device}, points on "
                             f"{x1.device}")
        draws = sampling.TorchDraws(key)
    else:
        draws = key
    dev = x1.device
    k = cfg.max_labels
    thr = _thr(cfg, tau, x1)

    # Morton order; labels are scattered back at the end
    perm = morton_order(x1, valid)
    x1, x2, valid = x1[perm], x2[perm], valid[perm]

    # pipeline.py:1121-1169: the windowed graph when the banded gate
    # holds and cfg.knn_window, for both graphs; its band is far-free
    windowed = graph_path(cfg, n_pts) == "windowed"

    def graph_of(feats):
        if windowed:
            return labeling.knn_graph_windowed(feats, valid, cfg.knn_k,
                                               cfg.agree_block)
        return labeling.knn_graph(feats, valid, cfg.knn_k,
                                  cfg.knn_row_block, cfg.knn_approx)

    with record_function("knn_graph"):
        nbr_idx, nbr_w = graph_of(x1)
    with record_function("banded_adjacency"):
        adj = labeling.build_banded_adjacency(
            nbr_idx, nbr_w, cfg.agree_block,
            far_capacity=0 if windowed else None,
        )
    if cfg.sampling_motion_weight > 0.0:
        feat = torch.cat([x1, cfg.sampling_motion_weight * (x2 - x1)], dim=1)
        with record_function("sampling_knn"):
            nbr_sample, _ = graph_of(feat)
    else:
        nbr_sample = nbr_idx

    with record_function("hypothesize"):
        Hs_all, ok = generate_hypotheses(
            draws, x1, x2, valid, nbr_sample, cfg, tau,
            window_block=(cfg.agree_block
                          if windowed and cfg.window_sampling else 0),
        )
    vs = max(1, cfg.verify_subsample)
    with record_function("verify"):
        # rank_residual only when a full-resolution rescore follows
        counts = count_inliers(
            Hs_all, x1[::vs], x2[::vs], valid[::vs], cfg, tau,
            kind=(cfg.rank_residual or None) if vs > 1 else None,
        ) * ok
        if vs > 1:
            m_pre = min(cfg.verify_rescore * cfg.n_candidates,
                        counts.shape[0])
            # pipeline.py:1244/:1248: top_k tie order
            _, pre_idx = top_k_stable(counts, m_pre)
            counts_full = count_inliers(
                Hs_all[pre_idx], x1, x2, valid, cfg, tau
            ) * ok[pre_idx]
            _, sel = top_k_stable(counts_full, cfg.n_candidates)
            top_idx = pre_idx[sel]
        else:
            # pipeline.py:1253
            _, top_idx = top_k_stable(counts, cfg.n_candidates)
    Hs_cand = Hs_all[top_idx]
    n_hyp_ok = ok.sum()

    with record_function("lo_refine"):
        Hs_top = lo_refine_candidates(Hs_cand, x1, x2, valid, cfg,
                                      cfg.lo_rounds, tau)
    with record_function("select"):
        r_top = model_residual_matrix(Hs_top, x1, x2, cfg.residual, cfg)
        grown_counts = ((r_top < thr) * valid[None, :]).sum(1)
        cand_idx, cand_active = selection.select_candidates(
            r_top, valid, thr, torch.ones_like(grown_counts),
            cfg.n_candidates, k, cfg.nms_iou,
        )
    Hs = Hs_top[cand_idx]
    active = cand_active * (grown_counts[cand_idx]
                            >= cfg.min_inliers).to(x1.dtype)

    # PEARL: q starts from the data costs of the selected candidates
    r0 = model_residual_matrix(Hs, x1, x2, cfg.residual, cfg)
    d0 = labeling.data_costs_t(r0, valid, thr, cfg.outlier_cost, active)
    q = torch.softmax(-d0 / cfg.temperature_start, dim=0)  # (L, N)
    energies = []
    with record_function("pearl"):
        # the lax.scan over iterations (pipeline.py:1302)
        for it in range(cfg.pearl_iterations):
            (Hs, active, q), e = _pearl_iteration(
                (Hs, active, q), it, x1, x2, valid, nbr_idx, nbr_w, cfg,
                tau, adj,
            )
            energies.append(e)

    with record_function("finalize"):
        r = model_residual_matrix(Hs, x1, x2, cfg.residual, cfg)
        dct = labeling.data_costs_t(r, valid, thr, cfg.outlier_cost, active)
        labels = labeling.best_labeling_t(
            [torch.argmax(q, dim=0), torch.argmin(dct, dim=0)],
            dct, nbr_idx, nbr_w, cfg.spatial_weight, cfg.icm_iterations,
            adj=adj, use_kernel=_kernels_enabled(cfg, dev),
        )
        label_active = torch.cat([active, torch.ones(1, dtype=active.dtype,
                                                     device=dev)])
        labels = torch.where(label_active[labels] > 0, labels, k)
        labels = torch.where(valid > 0, labels, k).to(torch.int32)
        member = (labels[None, :] == torch.arange(k, device=dev)[:, None])
        support = (member.to(x1.dtype) * valid[None, :]).sum(1)
        # scatter labels back to the caller's point order
        labels = torch.empty_like(labels).index_copy_(0, perm, labels)

    trace = torch.stack(energies)
    return FitResult(
        labels=labels,
        homographies=Hs,
        active=active,
        support=support,
        energy=trace[-1],
        energy_trace=trace,
        n_hypotheses_ok=n_hyp_ok,
        n_far_dropped=adj.n_dropped,
    )


def make_fit(cfg: MultiHConfig, device=None):
    """fit with cfg (and the device for array inputs) bound:
    f(x1, x2, valid, key)."""
    def f(x1, x2, valid, key):
        return fit(x1, x2, valid, key, cfg, device=device)
    return f


def make_fit_tau(cfg: MultiHConfig, device=None):
    """fit with cfg bound and the threshold (px) as an argument:
    f(x1, x2, valid, key, tau)."""
    def f(x1, x2, valid, key, tau):
        return fit(x1, x2, valid, key, cfg, tau=tau, device=device)
    return f
