"""The Multi-H fit in PyTorch: correspondences in, per-point plane labels
and homographies (or, for model="fundamental", motion labels and
fundamental matrices) out.

Counterpart of ``multih_tpu/models/pipeline.py::fit``, both model
classes, stage for stage: Morton sort (with spatial_sort) -> k-NN graph
(windowed or exact) + banded adjacency where `banded_gate` holds (else
the labeling takes the gather path) -> progressive hypothesis generation
(sampling + minimal 4-pt DLT, or 8/12-point F solves) -> verification
counts + top-M -> LO refine (moment refit + 9x9 eigensolve) -> NMS select (coverage
select for F) -> PEARL iterations -> for F the split move and the
refinement phases -> finalize. Each stage is wrapped in
``utils.tracing.stage`` of the JAX ``named_scope``'s name: a
``torch.profiler.record_function`` range, and a span of the capture's
stage table while the fit is captured as a CUDA graph (utils/aot.py).

The fit runs eagerly and forward-only, on the card unless the caller
asks for the CPU (`fit`'s `device`). With ``cfg.use_pallas`` and CUDA
tensors the hand-written kernels carry the count sweeps, the minimal
solves, the refit eigensolves, the mean-field and ICM sweeps (on the
windowed graph's far-free band; with ``cfg.mrf_fused_front`` the
residuals, data costs and mean-field sweeps of each PEARL iteration in
one fused call, `fused_front_gate`) and the window-sampling gathers
(`_kernels_enabled`); otherwise their plain PyTorch versions run, as the
JAX package runs its jnp paths off the TPU. The MRF sweeps' route is
decided once, when the band is built: `fit` gives it its neighbour list
where `_kernels_enabled` holds, and the labeling runs the MRF kernels
exactly where the adjacency carries the list. Around the fit: seed
homographies (`make_fit_seeded`, the streaming warm start of
utils/streaming.py), the paper's affine one-point hypotheses
(`fit(affines=...)`, ops/epipolar.py), the direct (non-moment) refit
(``cfg.refit_moments=False``) and the two-pass adaptive threshold
(`estimate_tau`, `fit_adaptive`).

Where the port is likely to diverge from the reference, the code says
so: `jax.lax.top_k`'s tie order (lower index first) is reproduced with a
stable descending sort (ops.topk.top_k_stable), every argsort is
stable, `.at[].add` scatters are index_add_, and lax.scan / fori_loop
bodies are Python loops that never wait on the device.

With a mesh (parallel/mesh.py) whose 'hyp' axis is > 1, hypothesis
generation and the verification sweep split over the axis's ranks
(`_hypothesize_verify_sharded`) and the rest of the fit runs replicated;
the result equals the single-device fit's. With a 'pt' (point) mesh the
points split over the ranks in Morton blocks (`check_pt_gate`,
labeling.PointShard): every sweep exchanges a one-block halo (and on
the exact graph gathers the columns of the rank's far edges), the
refits gather their weights and refit as the single-device fit does,
the other sums over the points are psums (integer counts, float64
energies and F-model data costs and flow moments), what sorts or draws
over every point (the F model's quartile cuts, resample subsets and
trimmed costs) runs on gathered arrays, and the result equals the
single-device fit's, for both models and both graphs.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from multih_tpu_torch.config import MultiHConfig
from multih_tpu_torch.models import labeling, selection
from multih_tpu_torch.ops import epipolar, fmodel, geometry, sampling
from multih_tpu_torch.ops.kernels import (accept_kernel, dlt_kernel,
                                          residual_kernel)
from multih_tpu_torch.ops.topk import top_k_stable
from multih_tpu_torch.utils.tracing import stage

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
    """Squared inlier threshold as a 0-dim tensor on ref's device. A
    number is filled in on the device (no host-to-device copy, so a CUDA
    graph can capture it); a tensor is taken as it is."""
    if tau is None:
        return torch.full((), cfg.inlier_threshold ** 2, dtype=ref.dtype,
                          device=ref.device)
    if isinstance(tau, (int, float, np.number)):
        t = torch.full((), float(tau), dtype=ref.dtype, device=ref.device)
    else:
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


def fused_front_gate(cfg: MultiHConfig, adj, has_pt_mesh: bool) -> bool:
    """Whether _pearl_iteration runs the fused residual + data-cost +
    mean-field kernel (cfg.mrf_fused_front; pipeline.py:461): the MRF
    kernels run (the adjacency carries its neighbour list, which the fit
    builds on a far-free band where `_kernels_enabled` holds), no point
    mesh, and a homography residual kind the kernel implements."""
    return (cfg.mrf_fused_front and labeling._mrf_kernels_run(adj)
            and not has_pt_mesh and cfg.model == "homography"
            and cfg.residual in ("symmetric", "transfer"))


def graph_path(cfg: MultiHConfig, n_pts: int) -> str:
    """'windowed', 'row_blocked' or 'row_blocked_approx', as fit()
    selects them in the reference."""
    if banded_gate(cfg, n_pts) and cfg.knn_window:
        return "windowed"
    return "row_blocked_approx" if cfg.knn_approx else "row_blocked"


def model_residual_matrix(Ms, x1, x2, kind, cfg: MultiHConfig):
    """(S, 3, 3) models x (N, 2) points -> (S, N) squared residuals of the
    configured model class."""
    if cfg.model == "fundamental":
        return fmodel.residual_matrix_f(Ms, x1, x2, kind)
    return geometry.residual_matrix(Ms, x1, x2, kind)


def _prepare_refit_basis(x1, x2, cfg: MultiHConfig):
    if cfg.model == "fundamental":
        return fmodel.prepare_refit_f(x1, x2)
    return geometry.prepare_refit(x1, x2)


def _psum(shard, t):
    """t summed over a 'pt' shard's axis; t itself without a shard."""
    return t if shard is None else shard.psum(t)


def _refit_batch(w, basis, cfg: MultiHConfig):
    """(C, N) weights -> (C, 3, 3) moment-formulated batched refit of the
    configured model class; the eigensolve takes the kernel on CUDA
    (geometry.py:502-509's rule)."""
    refit = (fmodel.fundamental_refit_batch if cfg.model == "fundamental"
             else geometry.homography_refit_batch)
    return refit(w, basis, cfg.eig_method, cfg.eig_iterations,
                 eig_kernel=_kernels_enabled(cfg, w.device))


def _refit(w, x1, x2, cfg: MultiHConfig, basis=None, shard=None):
    """(C, N) Tukey weights -> (C, 3, 3): the batched moment refit on
    `basis` (prepared from x1, x2 when None), or with
    cfg.refit_moments=False the direct one. With a `shard` (a 'pt'
    rank), w, x1 and x2 are its own points' and `basis` every point's:
    the ranks gather w and refit on every point (shard.x1, shard.x2) as
    the single-device fit does, bit for bit. A psum of per-rank float32
    moment sums rounds apart from one sum, and an ulp of H moves the
    labels of points at a tie. The gathered w keeps w's memory layout
    (refit_planes passes a transposed view): on CUDA the layout picks
    the GEMM's kernel and with it the order of the float32 sums."""
    if not cfg.refit_moments:
        if shard is not None:
            x1, x2, w = shard.x1, shard.x2, _gather_weights(w, shard)
        return _refit_direct(x1, x2, w, cfg)
    return _moment_refit(w, x1, x2, cfg, basis, shard)


def _gather_weights(w, shard):
    """A 'pt' rank's (C, n_own) weights -> every point's (C, N), in w's
    memory layout (`_refit`)."""
    return (shard.gather(w.T, dim=0).T if w.T.is_contiguous()
            else shard.gather(w))


def _moment_refit(w, x1, x2, cfg: MultiHConfig, basis=None, shard=None):
    """(C, N) weights -> (C, 3, 3) by the batched moment refit whatever
    cfg.refit_moments (the fundamental model's union, split and refine
    refits take it, as in the reference). With a `shard`, w is a 'pt'
    rank's own points' and is gathered as `_refit` gathers it; `basis`
    is every point's (prepared from them when None)."""
    if shard is not None:
        x1, x2, w = shard.x1, shard.x2, _gather_weights(w, shard)
    if basis is None:
        basis = _prepare_refit_basis(x1, x2, cfg)
    return _refit_batch(w, basis, cfg)


def _refit_direct(x1, x2, w, cfg: MultiHConfig):
    """(C, N) weights -> (C, 3, 3): the direct weighted refit of the
    cfg.refit_moments=False path (pipeline.py:148), the normalized
    8-point F or DLT H of every row in one batched solve where the
    reference vmaps one candidate's. Its eigensolve is `eigh` (or
    cfg.eig_method) on every device, as in the reference."""
    if cfg.model == "fundamental":
        return epipolar.fundamental_8pt(x1, x2, w, cfg.eig_method)
    return geometry.homography_from_points(x1, x2, w, cfg.eig_method,
                                           cfg.eig_iterations)


# ---------------------------------------------------------------------------
# stages
# ---------------------------------------------------------------------------

def _round_sample_indices(draws, stream, avail, nbr_idx, nbr_ok,
                          n_samples: int, m: int = 4):
    """(S, m) index tuples for one progressive round: the first half
    uniform over `avail`, the second locality-biased. For m = 8/12 (the
    fundamental model) each localized sample is TWO seed + neighbour
    clusters of m/2 points, drawn under the streams ("loc_a", stream)
    and ("loc_b", stream): the reference splits the localized key in two
    (pipeline.py:185)."""
    s_local = n_samples // 2
    idx_u = sampling.sample_indices(draws, stream, n_samples - s_local,
                                    avail > 0, m=m)
    if m == 4:
        idx_l = sampling.localized_sample_indices(
            draws, stream, s_local, avail > 0, nbr_idx, nbr_ok
        )
    else:
        if m not in (8, 12):
            raise ValueError(f"sample size {m}")
        idx_l = torch.cat([
            sampling.localized_sample_indices(
                draws, (half, stream), s_local, avail > 0, nbr_idx, nbr_ok,
                cluster=m // 2,
            ) for half in ("loc_a", "loc_b")
        ], dim=1)
    return torch.cat([idx_u, idx_l], dim=0)


def _solve_minimal_f(x1, x2, avail, idx, cfg: MultiHConfig):
    """Fundamental solves for (S, m) sample indices, m = 8 by the
    Givens-QR nullspace, m = 12 by normal equations + 9x9 eigensolve.
    The reference solves both outside any Pallas kernel; the port's
    12-point eigensolves run in K3 where the kernels run, since
    torch.linalg.eigh reads its error flags back to the host, which a
    CUDA graph cannot capture (plain eigh elsewhere). Returns (Fs (S, 3,
    3), ok (S,)): ok is 0 where a sample uses an unavailable point or the
    solve is not finite."""
    p1, p2 = x1[idx], x2[idx]  # (S, m, 2)
    if idx.shape[1] == 8:
        Fs = fmodel.fundamental_8pt_batch_qr(p1, p2)
    else:
        Fs = fmodel.fundamental_npt_batch(
            p1, p2, cfg.eig_iterations, cfg.eig_method,
            eig_kernel=_kernels_enabled(cfg, x1.device))
    uses_pad = (avail[idx] == 0).any(1)
    finite = torch.isfinite(Fs.reshape(-1, 9)).all(1)
    return Fs, (~uses_pad & finite).to(x1.dtype)


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
    avail) -> (Hs (S, 3, 3), ok (S,)): ok is 0 where a quad is
    degenerate or uses an unavailable point. One K2 launch on CUDA, the
    plain version's eager ops otherwise."""
    if _kernels_enabled(cfg, gt.device):
        return dlt_kernel.homography_4pt_gt(gt)
    return dlt_kernel.homography_4pt_gt_reference(gt)


def count_inliers(Hs, x1, x2, valid, cfg: MultiHConfig, tau=None,
                  kind: str | None = None):
    """Inlier counts of the whole pool without materializing (S, N): the
    count kernel on CUDA, residual_chunk-sized chunks of the plain
    residual otherwise (the kernel takes the fast reciprocal when
    cfg.pallas_approx_rcp, as the reference passes it at
    pipeline.py:510). `kind` overrides cfg.residual; the fundamental
    model's kinds carry an ``f_`` prefix (pipeline.py:506)."""
    kind = kind or cfg.residual
    if cfg.model == "fundamental":
        kind = f"f_{kind}"
    thr = _thr(cfg, tau, x1)
    if _kernels_enabled(cfg, x1.device):
        return residual_kernel.inlier_counts_padded(
            Hs, x1, x2, valid, thr, kind=kind,
            approx_rcp=cfg.pallas_approx_rcp)
    return residual_kernel.inlier_counts_reference(
        Hs, x1, x2, valid, thr, kind, chunk=cfg.residual_chunk
    )


def _claim_order(c_all, s_all, n: int):
    """The first n positions of the gathered (count, slot) candidates in
    (count descending, slot ascending) order: the reference's
    ``lexsort((slots, -counts))`` (pipeline.py:403, :664), which is
    top_k's tie order on the unsharded pool. Two stable sorts, slot
    first, give it without a combined key."""
    by_slot = torch.argsort(s_all, stable=True)
    by_count = torch.argsort(-c_all[by_slot], stable=True)
    return by_slot[by_count][:n]


def generate_hypotheses(draws, x1, x2, valid, nbr_idx, cfg: MultiHConfig,
                        tau=None, window_block: int = 0, shard=None):
    """Minimal-sample hypotheses in cfg.progressive_rounds guided rounds:
    after each round its top-R candidates are LO-grown together, greedily
    accepted when mostly novel, and their inliers claimed, so the next
    round samples among unclaimed points. With `window_block` > 0 a
    round whose sample count divides into the N // window_block Morton
    windows draws window-stratified samples
    (sampling.windowed_quadruples). Returns (Hs, ok).

    shard: a parallel.mesh.Mesh whose 'hyp' axis splits the pool
    (pipeline.py:281). Every rank makes every draw, full-size, in the
    same order; only its slice [d * s_loc, (d + 1) * s_loc) of each
    round's slots is solved and counted (the window path only where the
    round's windows divide among the ranks). The ranks exchange their
    local top-R (count, slot, H) triples, take the global top-R in
    (count desc, slot asc) order, the unsharded pool's top_k order, and
    LO-grow it replicated; only rank 0 surfaces the claimed planes.
    Returns (Hs_local, ok_local, global_slots): the same slot holds the
    same hypothesis as in the unsharded pool."""
    rounds = max(1, cfg.progressive_rounds)
    n_claim = max(1, cfg.claims_per_round)
    s_round = cfg.n_hypotheses // rounds
    s_rem = cfg.n_hypotheses - s_round * (rounds - 1)
    thr = _thr(cfg, tau, x1)
    n_shards, d = ((shard.shape["hyp"], shard.axis_index("hyp"))
                   if shard is not None else (1, 0))

    claimed = torch.zeros_like(valid)
    pools, oks, slots = [], [], []
    base = 0  # global slot of the round's first hypothesis
    for r in range(rounds):
        avail = valid * (1.0 - claimed)
        # too few unclaimed points: fall back to all valid, branch-free
        enough = (avail.sum() >= 16.0).to(x1.dtype)
        avail = avail * enough + valid * (1.0 - enough)
        n_s = s_rem if r == rounds - 1 else s_round
        s_loc = n_s // n_shards
        if n_s % n_shards:
            raise ValueError(f"{n_s} hypotheses a round over {n_shards} "
                             f"shards")
        nb_win = x1.shape[0] // window_block if window_block > 0 else 0
        if (window_block > 0 and n_s % nb_win == 0
                and nb_win % n_shards == 0):
            # window-major columns: a shard's windows are its slots
            gt = sampling.windowed_quadruples(
                draws, r, x1, x2, avail, nbr_idx, n_s, window_block,
                use_kernel=_kernels_enabled(cfg, x1.device),
                window_range=(None if shard is None else
                              (d * (nb_win // n_shards), nb_win // n_shards)),
            )
            Hs_r, ok_r = _solve_from_gt(gt, cfg)
        else:
            nbr_ok = avail[nbr_idx]
            m_pts = (cfg.f_sample_points if cfg.model == "fundamental"
                     else cfg.minimal_points)
            idx = _round_sample_indices(draws, r, avail, nbr_idx, nbr_ok,
                                        n_s, m=m_pts)
            idx = idx[d * s_loc:(d + 1) * s_loc]
            solve = (_solve_minimal_f if cfg.model == "fundamental"
                     else _solve_minimal)
            Hs_r, ok_r = solve(x1, x2, avail, idx, cfg)
        pools.append(Hs_r)
        oks.append(ok_r)
        if shard is not None:
            slots.append(base + d * s_loc
                         + torch.arange(s_loc, device=x1.device))
        if r == rounds - 1:
            break
        ss = max(1, cfg.claim_subsample)
        counts_av = count_inliers(
            Hs_r, x1[::ss], x2[::ss], avail[::ss], cfg, tau,
            kind=cfg.rank_residual or None,
        ) * ok_r
        # pipeline.py:393: top_k tie order
        c_top, i_top = top_k_stable(counts_av, min(n_claim, s_loc))
        H_top = Hs_r[i_top]
        if shard is not None:
            c_all = shard.all_gather(c_top, "hyp").reshape(-1)
            s_all = shard.all_gather(i_top + d * s_loc, "hyp").reshape(-1)
            H_all = shard.all_gather(H_top, "hyp").reshape(-1, 3, 3)
            H_top = H_all[_claim_order(c_all, s_all, n_claim)]
        H_grown = lo_refine_candidates(
            H_top, x1, x2, valid, cfg, cfg.lo_rounds, tau
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
        acc_v = torch.stack(accepted)
        pools.append(H_grown)
        if shard is not None:
            # every rank knows the claimed planes; only rank 0 surfaces
            # them to the verification sweep
            oks.append(acc_v if d == 0 else torch.zeros_like(acc_v))
            slots.append(base + n_s + torch.arange(H_grown.shape[0],
                                                   device=x1.device))
        else:
            oks.append(acc_v)
        base += n_s + H_grown.shape[0]
    if shard is not None:
        return torch.cat(pools), torch.cat(oks), torch.cat(slots)
    return torch.cat(pools), torch.cat(oks)


def _hypothesize_verify_sharded(draws, x1, x2, valid, nbr_sample,
                                cfg: MultiHConfig, tau, mesh,
                                extra_Hs=None, extra_ok=None,
                                window_block: int = 0,
                                replication_check: bool = False):
    """Hypothesis generation and the verification sweep + top-M, split
    over the mesh's 'hyp' axis (pipeline.py:576): each rank solves and
    counts its slice of every round (`generate_hypotheses(shard=mesh)`)
    and its slice of the extras, padded to a multiple of the axis with
    identity H's whose ok is 0, on slots after the pool's. Its local
    top-m (count, slot, H) triples are gathered and merged in the
    unsharded top_k's order; with cfg.verify_subsample > 1 the merged
    pre-selection is rescored at full resolution, replicated. Returns
    (top_counts (M,), Hs_cand (M, 3, 3), n_hyp_ok), the same on every
    rank of the axis (plus the replication guard's {0, 1} with
    `replication_check`)."""
    n_shards, d = mesh.shape["hyp"], mesh.axis_index("hyp")
    m = cfg.n_candidates
    rounds = max(1, cfg.progressive_rounds)
    s_total = cfg.n_hypotheses + (rounds - 1) * max(1, cfg.claims_per_round)
    dev = x1.device
    n_extra = 0 if extra_Hs is None else extra_Hs.shape[0]
    with stage("hypothesize"):
        Hs_loc, ok_loc, slot_loc = generate_hypotheses(
            draws, x1, x2, valid, nbr_sample, cfg, tau,
            window_block=window_block, shard=mesh,
        )
        if extra_Hs is not None:
            pad = (-extra_Hs.shape[0]) % n_shards
            extra_Hs = torch.cat([extra_Hs, torch.eye(
                3, dtype=x1.dtype, device=dev).expand(pad, 3, 3)])
            extra_ok = torch.cat([extra_ok, torch.zeros(
                pad, dtype=x1.dtype, device=dev)])
            e_loc = extra_Hs.shape[0] // n_shards
            Hs_loc = torch.cat([Hs_loc, extra_Hs[d * e_loc:(d + 1) * e_loc]])
            ok_loc = torch.cat([ok_loc, extra_ok[d * e_loc:(d + 1) * e_loc]])
            slot_loc = torch.cat([slot_loc, s_total + d * e_loc
                                  + torch.arange(e_loc, device=dev)])
    vs = max(1, cfg.verify_subsample)
    # the rescore's pre-selection is capped by the whole pool, extras
    # included, as the unsharded pick caps it. A deliberate divergence:
    # the reference caps it by the pool without the extras
    # (pipeline.py:646), so with seeds or affine H's and verify_rescore *
    # M past the sampled pool it rescores fewer candidates than its own
    # single-device fit
    m_sel = min(cfg.verify_rescore * m, s_total + n_extra) if vs > 1 else m
    with stage("verify"):
        # rank_residual only when a full-resolution rescore follows
        counts = count_inliers(
            Hs_loc, x1[::vs], x2[::vs], valid[::vs], cfg, tau,
            kind=(cfg.rank_residual or None) if vs > 1 else None,
        ) * ok_loc
        c_loc, i_loc = top_k_stable(counts, min(m_sel, counts.shape[0]))
        c_all = mesh.all_gather(c_loc, "hyp").reshape(-1)
        s_all = mesh.all_gather(slot_loc[i_loc], "hyp").reshape(-1)
        h_all = mesh.all_gather(Hs_loc[i_loc], "hyp").reshape(-1, 3, 3)
        n_ok = mesh.psum(ok_loc.sum(), "hyp")
        if vs > 1:
            o_all = mesh.all_gather(ok_loc[i_loc], "hyp").reshape(-1)
            order = _claim_order(c_all, s_all, m_sel)
            h_pre = h_all[order]
            with stage("verify_rescore"):
                counts_full = count_inliers(h_pre, x1, x2, valid, cfg,
                                            tau) * o_all[order]
            c_fin, sel = top_k_stable(counts_full, m)
            out = (c_fin, h_pre[sel], n_ok)
        else:
            order = _claim_order(c_all, s_all, m)
            out = (c_all[order], h_all[order], n_ok)
    if replication_check:
        return out + (mesh.replicated_ok(out, "hyp"),)
    return out


def refit_planes(Hs, labels, residuals, x1, x2, valid, cfg: MultiHConfig,
                 tau=None, basis=None, shard=None):
    """Re-estimate every plane from its assigned points with Tukey-biweight
    weights gated by the current residual, all planes in one batched
    refit (the moment refit, or with cfg.refit_moments=False the direct
    one); planes with fewer than 4 weighted members keep their H. With a
    `shard`, the points are a 'pt' rank's own (basis every point's), the
    supports are summed over the axis and the refit gathers the weights
    (`_refit`)."""
    k = cfg.max_labels
    thr = _thr(cfg, tau, x1)
    member = F.one_hot(labels.long(), k + 1)[:, :k].to(x1.dtype) \
        * valid[:, None]  # (N, K)
    support = member.sum(0)
    rr = torch.clamp(residuals.T / thr, 0.0, 1.0)
    tukey = (1.0 - rr) ** 2 * (residuals.T < thr)
    w = member * tukey
    eff_support = (w > 0).to(x1.dtype).sum(0)
    support, eff_support = _psum(shard, torch.stack([support, eff_support]))
    Hs_fit = _refit(w.T, x1, x2, cfg, basis, shard)
    Hs_new = torch.where((eff_support >= float(cfg.minimal_points))
                         [:, None, None], Hs_fit, Hs)
    return Hs_new, support


def merge_duplicate_planes(r, support, active, thr, merge_iou: float,
                           containment: bool = True, shard=None):
    """Deactivate planes whose inlier sets duplicate a stronger plane's
    (containment: intersection over the smaller set), greedy in order of
    support. The fori_loop (pipeline.py:783) is a loop of tensor ops.
    With a `shard`, r holds a 'pt' rank's points and the counts and
    intersections (integers) are summed over the axis."""
    k = r.shape[0]
    masks = (r < thr).to(r.dtype) * active[:, None]
    counts = masks.sum(1)
    inter = masks @ masks.T
    if shard is not None:
        both = shard.psum(torch.cat([inter, counts[:, None]], dim=1))
        inter, counts = both[:, :k], both[:, k]
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
                         tau=None, shard=None, basis=None):
    """LO-RANSAC growth of candidates: `rounds` batched Tukey refits at
    geometrically shrinking thresholds (4tau, 2tau, tau), each kept only
    if the inlier count at tau does not drop. The lax.scan over rounds
    (pipeline.py:840) is a Python loop; with cfg.refit_moments=False each
    round is one batched direct refit of all M rows. With a `shard`, the
    points are a 'pt' rank's own, `basis` every point's refit features,
    the counts are summed over the axis and the refits gather the weights
    (`_refit`)."""
    thr = _thr(cfg, tau, x1)

    def count(r):
        return ((r < thr) * valid[None, :]).sum(1)

    if basis is None and cfg.refit_moments:
        basis = _prepare_refit_basis(x1, x2, cfg)
    m_min = float(cfg.minimal_points)
    for i in range(rounds):
        thr_r = thr * cfg.lo_shrink_eff ** (rounds - 1 - i)
        r = model_residual_matrix(Hs, x1, x2, cfg.residual, cfg)
        rr = torch.clamp(r / thr_r, 0.0, 1.0)
        w = ((1.0 - rr) ** 2 * (r < thr_r)) * valid[None, :]
        enough = _psum(shard, (w > 0).to(x1.dtype).sum(1)) >= m_min
        Hs_fit = _refit(w, x1, x2, cfg, basis, shard)
        Hs_new = torch.where(enough[:, None, None], Hs_fit, Hs)
        r_new = model_residual_matrix(Hs_new, x1, x2, cfg.residual, cfg)
        c_new, c_old = _psum(shard, torch.stack([count(r_new), count(r)]))
        better = (c_new >= c_old)[:, None, None]
        Hs = torch.where(better, Hs_new, Hs)
    return Hs


def _pearl_iteration(carry, it: int, x1, x2, valid, nbr_idx, nbr_w,
                     cfg: MultiHConfig, tau=None, adj=None, shard=None,
                     basis=None):
    """One PEARL alternation: residuals -> data costs -> mean-field + ICM
    -> refit -> accept -> merge duplicates -> label-cost prune (only in
    the second half of the iterations) -> for F, the union-refit merge.
    Where `fused_front_gate` holds, the residuals, data costs and sweeps
    are one fused kernel call, whose dct and r the rest reuses. With a
    `shard` (labeling.PointShard), the points, q and every (., N) array
    are a 'pt' rank's own, the sweeps exchange halos, and every sum over
    the points runs over the axis but the refits' (`_refit`); `basis`
    is every point's refit basis."""
    Hs, active, q = carry
    thr = _thr(cfg, tau, x1)
    k = cfg.max_labels
    f_model = cfg.model == "fundamental"

    if fused_front_gate(cfg, adj, shard is not None):
        q, dct, r = labeling.pearl_relax_fused(
            x1, x2, valid, Hs, active, thr, cfg.outlier_cost,
            cfg.spatial_weight, cfg.meanfield_iterations,
            cfg.temperature_start, cfg.temperature, q, adj,
            kind=cfg.residual,
        )
    else:
        r = model_residual_matrix(Hs, x1, x2, cfg.residual, cfg)  # (K, N)
        dct = labeling.data_costs_t(r, valid, thr, cfg.outlier_cost, active)
        q = labeling.mean_field_t(
            dct, nbr_idx, nbr_w, cfg.spatial_weight,
            cfg.meanfield_iterations, cfg.temperature_start,
            cfg.temperature, q_init=q, adj=adj, shard=shard,
        )
    # two ICM starts: the mean-field argmax and the data argmin
    labels = labeling.best_labeling_t(
        [torch.argmax(q, dim=0), torch.argmin(dct, dim=0)],
        dct, nbr_idx, nbr_w, cfg.spatial_weight, cfg.icm_iterations,
        adj=adj, shard=shard,
    )

    # refit on assignments; accept per plane if inliers don't drop:
    # global inliers for homographies, the model's own members for F
    # (a bridge must be free to purify toward its members)
    Hs_new, support = refit_planes(Hs, labels, r, x1, x2, valid, cfg, tau,
                                   basis, shard)
    r_new = model_residual_matrix(Hs_new, x1, x2, cfg.residual, cfg)
    member_k = (labels[None, :] == torch.arange(
        k, device=labels.device)[:, None]).to(x1.dtype) * valid[None, :]
    acc_w = (member_k if f_model and cfg.f_member_acceptance
             else valid[None, :])
    in_old, in_new = _psum(shard, torch.stack(
        [((r < thr) * acc_w).sum(1), ((r_new < thr) * acc_w).sum(1)]))
    better = (in_new >= in_old)[:, None, None]
    Hs = torch.where(better, Hs_new, Hs)
    r_acc = torch.where(better[..., 0], r_new, r)

    # containment for homographies, symmetric Jaccard for F
    active = merge_duplicate_planes(r_acc, support, active, thr,
                                    cfg.merge_iou, containment=not f_model,
                                    shard=shard)

    # PEARL label cost: drop the plane whose removal lowers the energy
    # the most, if any — one greedy removal for homographies, eight
    # rounds for F (a 7-dof F holds chance inliers on pure noise), gains
    # recomputed after each; tensor ops, the fori_loop of
    # pipeline.py:973 unrolled
    prune_on = it >= cfg.pearl_iterations // 2
    if prune_on:
        oh_lab = (labels[None, :] == torch.arange(
            k + 1, device=labels.device)[:, None]).to(x1.dtype)
        for _ in range(8 if f_model else 1):
            dct_now = labeling.data_costs_t(r_acc, valid, thr,
                                            cfg.outlier_cost, active)
            member = oh_lab[:k] * valid[None, :] * active[:, None]
            own = (oh_lab * dct_now).sum(0)
            runner = torch.where(oh_lab > 0, float("inf"), dct_now).amin(0)
            switch_cost = _psum(shard, ((runner - own)[None, :] * member
                                        ).double().sum(1))
            gain = cfg.label_cost - switch_cost
            worst = torch.argmax(torch.where(active > 0, gain,
                                             float("-inf"))).view(1)
            active = active.clone()
            active[worst] = torch.where(gain[worst] > 0, 0.0, active[worst])
        # drop tiny planes once the growth phase is over
        active = active * (support >= cfg.min_inliers).to(active.dtype)

    energy = labeling.total_energy_t(
        labels, dct, nbr_idx, nbr_w, cfg.spatial_weight, cfg.label_cost,
        active, adj=adj, shard=shard,
    )
    if f_model and cfg.f_union_merge:
        with stage("union_refit_merge"):
            Hs, active = _union_refit_merge(Hs, active, member_k, r_acc, x1,
                                            x2, thr, cfg, shard, basis)
    return (Hs, active, q), energy


def _union_refit_merge(Hs, active, member_k, r_acc, x1, x2, thr,
                       cfg: MultiHConfig, shard=None, basis=None):
    """The energy-tested union-refit merge of the fundamental model
    (pipeline.py:990-1059): all K^2 pair refits on the joint members in
    one batched moment refit; the pair whose union F covers >= 80% of
    both member sets and raises their data cost by less than the label
    cost it saves, lowest increase first, merges (one per iteration;
    `_union_scores`)."""
    k = cfg.max_labels
    Hs_u, score = _union_scores(active, member_k, r_acc, x1, x2, thr, cfg,
                                shard, basis)
    best = torch.argmax(score).view(1)
    a_i, b_i = best // k, best % k
    do = torch.isfinite(score[best])
    active = active.clone()
    active[b_i] = torch.where(do, 0.0, active[b_i])
    Hs = Hs.clone()
    Hs[a_i] = torch.where(do[:, None, None], Hs_u[best], Hs[a_i])
    return Hs, active


def _union_scores(active, member_k, r_acc, x1, x2, thr, cfg: MultiHConfig,
                  shard=None, basis=None):
    """(Hs_u (K^2, 3, 3), score (K^2,) float64) of `_union_refit_merge`:
    pair (a, b)'s union refit, and minus the data-cost increase of
    merging b into a where the pair may merge, else -inf. The data-cost
    sums over the points run in float64, so that with a `shard` (a 'pt'
    rank's own points; the refit gathers its weights, `_moment_refit`)
    the ranks' partial sums add up as one sum does; the coverage counts
    are integers."""
    k = cfg.max_labels
    member_act = member_k * active[:, None]  # (K, N)
    sup_act = _psum(shard, member_act.sum(1))
    w_u = (member_act[:, None, :] + member_act[None, :, :]).reshape(k * k,
                                                                    -1)
    Hs_u = _moment_refit(w_u, x1, x2, cfg, basis, shard)
    fin_u = torch.isfinite(Hs_u.reshape(k * k, -1)).all(1).reshape(k, k)
    r_u = model_residual_matrix(Hs_u, x1, x2, cfg.residual,
                                cfg).reshape(k, k, -1)
    inl_u = (r_u < thr).to(x1.dtype)
    cov_a, cov_b = _psum(shard, torch.stack([
        torch.einsum("abn,an->ab", inl_u, member_act),
        torch.einsum("abn,bn->ab", inl_u, member_act)]))
    cov_a = cov_a / torch.clamp_min(sup_act[:, None], 1.0)
    cov_b = cov_b / torch.clamp_min(sup_act[None, :], 1.0)
    # data-cost increase of both member sets under the union F against
    # their own F (the truncated quadratic of labeling.data_costs_t)
    d_u = (torch.clamp_max(r_u / thr, 8.0) * cfg.outlier_cost).double()
    m64 = member_act.double()
    d_own = _psum(shard, ((torch.clamp_max(r_acc / thr, 8.0)
                           * cfg.outlier_cost).double() * m64).sum(1))
    d_a, d_b = _psum(shard, torch.stack([
        torch.einsum("abn,an->ab", d_u, m64),
        torch.einsum("abn,bn->ab", d_u, m64)]))
    delta = d_a - d_own[:, None] + d_b - d_own[None, :]
    m_min = float(cfg.minimal_points)
    ids = torch.arange(k, device=x1.device)
    ok_pair = (
        (cov_a >= 0.8) & (cov_b >= 0.8) & fin_u
        & (delta < cfg.label_cost)
        & (active[:, None] > 0) & (active[None, :] > 0)
        & (sup_act[:, None] >= sup_act[None, :])
        & (sup_act[:, None] >= m_min) & (sup_act[None, :] >= m_min)
        & (ids[:, None] != ids[None, :])
    )
    return Hs_u, torch.where(ok_pair, -delta, float("-inf")).reshape(-1)


def _pearl_phase(Hs, active, q, its, x1, x2, valid, nbr_idx, nbr_w,
                 cfg: MultiHConfig, tau, adj, shard=None, basis=None):
    """PEARL iterations `its` (the lax.scan at pipeline.py:1302 and
    :1430) as a Python loop; returns (Hs, active, q, energies)."""
    energies = []
    for it in its:
        (Hs, active, q), e = _pearl_iteration(
            (Hs, active, q), it, x1, x2, valid, nbr_idx, nbr_w, cfg, tau,
            adj, shard, basis,
        )
        energies.append(e)
    return Hs, active, q, energies


def _split_refine(Hs, active, q, x1, x2, valid, nbr_idx, nbr_w,
                  cfg: MultiHConfig, tau, adj, shard=None, basis=None):
    """The fundamental model's split move (pipeline.py:1306-1435): every
    active model's members split twelve ways (`_split_weights`), an F
    refit on each part in one batched moment refit, the roster
    re-selected by marginal coverage from {survivors + splits}, then
    f_split_iterations more PEARL iterations with the label-cost prune
    on. With a `shard`, the (., N) arrays are a 'pt' rank's own points,
    the refit gathers its weights and the counts are psums. Returns (Hs,
    active, q, energies)."""
    thr = _thr(cfg, tau, x1)
    k = cfg.max_labels
    dev = x1.device
    r = model_residual_matrix(Hs, x1, x2, cfg.residual, cfg)
    dct = labeling.data_costs_t(r, valid, thr, cfg.outlier_cost, active)
    lab_s = labeling.best_labeling_t(
        [torch.argmax(q, dim=0), torch.argmin(dct, dim=0)],
        dct, nbr_idx, nbr_w, cfg.spatial_weight, cfg.icm_iterations,
        adj=adj, shard=shard,
    )
    member = (lab_s[None, :] == torch.arange(k, device=dev)[:, None]).to(
        x1.dtype) * valid[None, :]  # (K, N)
    rr = torch.clamp(r / thr, 0.0, 1.0)
    tk = (1.0 - rr) ** 2 * (r < thr)
    w_split = _split_weights(member, x2 - x1, shard) * tk.repeat(12, 1)
    Hs_split = _moment_refit(w_split, x1, x2, cfg, basis, shard)
    n_eff = _psum(shard, (w_split > 0).to(x1.dtype).sum(1))
    ok_split = ((n_eff >= float(cfg.minimal_points))
                & torch.isfinite(Hs_split.reshape(-1, 9)).all(1)).to(x1.dtype)
    cand = torch.cat([Hs, Hs_split], dim=0)  # (13K, 3, 3)
    cand_ok = torch.cat([active, ok_split], dim=0)
    r_cand = model_residual_matrix(cand, x1, x2, cfg.residual, cfg)
    cand_idx, active = selection.select_candidates_coverage(
        r_cand, valid, thr, cand_ok, cand.shape[0], k,
        min_gain=float(cfg.min_inliers),
        reduce=None if shard is None else shard.psum,
    )
    Hs = cand[cand_idx]
    d0s = labeling.data_costs_t(r_cand[cand_idx], valid, thr,
                                cfg.outlier_cost, active)
    q = torch.softmax(-d0s / cfg.temperature_start, dim=0)
    # iteration indices in the prune-enabled second half
    return _pearl_phase(
        Hs, active, q,
        range(cfg.pearl_iterations,
              cfg.pearl_iterations + cfg.f_split_iterations),
        x1, x2, valid, nbr_idx, nbr_w, cfg, tau, adj, shard, basis,
    )


def _split_weights(member, flow, shard=None):
    """(K, N) member masks and the (N, 2) flow x2 - x1 -> the (12K, N)
    member masks of the split move's twelve parts: the Morton-index
    median, mean cuts of both flow components, quartile cuts of the
    member flow's principal axis, each as a (lower, upper) pair.

    With a `shard`, both are a 'pt' rank's own points: the ranks gather
    their member counts (exact integers), the Morton index of a member
    is the local cumulative count plus the members of the ranks before
    this one, and the quartile cuts sort the gathered projections. The
    means and the flow covariance sum over the points in float64,
    rounded to float32, so that the ranks' partial sums give the single
    fit's values; the single fit sums them the same way."""
    n_mem = member.sum(1)
    if shard is None:
        before, n_all, n_pts = torch.zeros_like(n_mem), n_mem, member.shape[1]
    else:
        counts = shard.mesh.all_gather(n_mem, "pt")  # (pt, K)
        before = counts[:shard.mesh.axis_index("pt")].sum(0)
        n_all, n_pts = counts.sum(0), shard.x1.shape[0]
    cum = torch.cumsum(member, dim=1) + before[:, None]
    half = n_all[:, None] * 0.5
    sup_m = torch.clamp_min(n_all, 1.0)[:, None]

    def nsum(t):  # (R, K, N) -> (R, K): a sum over the points
        return _psum(shard, t.double().sum(-1)).to(t.dtype)

    fx, fy = flow[None, :, 0], flow[None, :, 1]
    mf = nsum(member[None] * flow.T[:, None, :]).T / sup_m  # (K, 2)
    mean_cuts = [member * (fx <= mf[:, 0:1]), member * (fx > mf[:, 0:1]),
                 member * (fy <= mf[:, 1:2]), member * (fy > mf[:, 1:2])]
    # leading eigenvector of each member set's 2x2 flow covariance,
    # closed form; a degenerate one falls back to the x axis
    d0 = fx - mf[:, 0:1]
    d1 = fy - mf[:, 1:2]
    ca, cb, cc = nsum(torch.stack([member * d0 * d0, member * d0 * d1,
                                   member * d1 * d1]))
    lam = 0.5 * (ca + cc) + torch.sqrt(0.25 * (ca - cc) ** 2 + cb * cb)
    vx, vy = cb, lam - ca
    degv = (vx.abs() + vy.abs()) < 1e-12
    vx = torch.where(degv, 1.0, vx)
    vy = torch.where(degv, 0.0, vy)
    proj = vx[:, None] * fx + vy[:, None] * fy
    # quartile cuts on the principal axis: members first (non-members
    # sort last as +inf), the cut at floor(support * qf)
    keyed = torch.where(member > 0, proj, float("inf"))
    if shard is not None:
        keyed = shard.gather(keyed)
    proj_sorted = torch.sort(keyed, dim=1).values
    pca_cuts = []
    for qf in (0.25, 0.5, 0.75):
        pos = torch.clamp((n_all * qf).to(torch.int64), 0, n_pts - 1)
        cut = torch.gather(proj_sorted, 1, pos[:, None])
        pca_cuts += [member * (proj <= cut), member * (proj > cut)]
    return torch.cat([member * (cum <= half), member * (cum > half)]
                     + mean_cuts + pca_cuts, dim=0)


def _trimmed_cost(r_like, member_f, t_idx):
    """(..., N) residuals -> the sum of the smallest 80% of each model's
    member residuals (pipeline.py:1602): sorted, cumulated, read at
    t_idx. Non-members count 1e9 and sort last."""
    r_m = torch.where(member_f > 0, r_like,
                      torch.full((), 1e9, dtype=r_like.dtype,
                                 device=r_like.device))
    csum = torch.cumsum(torch.sort(r_m, dim=-1).values, dim=-1)
    idx = t_idx.expand(csum.shape[:-1])[..., None]
    return torch.gather(csum, -1, idx)[..., 0]


def _f_accept_kernel_ok(adj, shard) -> bool:
    """Whether `_f_accept`'s fallback runs as K5 between its two
    hand-written ends (accept_kernel.f_accept_fallback): exactly where
    the fallback's relabel runs K5, without a 'pt' shard where the
    adjacency carries its neighbour list (the MRF kernels' one rule)."""
    return shard is None and labeling._mrf_kernels_run(adj)


def _f_accept(Hs_c, q_c, r_c, lab_c, e_c, Hs_prop, r_prop, ok_prop,
              label_energy, relabel_energy, residuals, on_device=None,
              fallback=None):
    """The accept of `_f_refine_phases` (the lax.cond at pipeline.py:1556):
    the joint move (every ok proposal at once, scored under a full
    relabel) if it lowers the energy e_c of the carried (Hs_c, q_c, r_c,
    lab_c), else one model at a time under an ICM relabel from the
    carried labeling, each kept iff the energy drops. label_energy(r,
    q0) -> (labels, q, e), relabel_energy(r, labels0) -> (labels, e) and
    residuals(Ms) -> r are the phase's; `fallback`, where given, runs
    the one-model-at-a-time loop in kernels ((Hs_c, r_c, lab_c, e_c,
    Hs_prop, r_prop, ok_prop) -> (Hs, e_steps, took) as
    `_f_fallback_plain`, accept_kernel.f_accept_fallback). Returns (Hs,
    q).

    On the CPU the branch is a host read, and the fallback runs only
    where the joint move is refused. On the card (on_device, by default
    where e_c lies) both run and each output is picked with torch.where,
    so that nothing is read back and a CUDA graph can capture the
    accept. Every route gives the same result bit for bit."""
    if on_device is None:
        on_device = e_c.device.type != "cpu"
    with stage("f_accept"):
        r_j = torch.where(ok_prop[:, None], r_prop, r_c)
        _, q_j, e_j = label_energy(r_j, q_c)
        Hs_j = torch.where(ok_prop[:, None, None], Hs_prop, Hs_c)
        if not on_device and bool(e_j < e_c):
            return Hs_j, q_j
        if fallback is not None:
            Hs_s = fallback(Hs_c, r_c, lab_c, e_c, Hs_prop, r_prop,
                            ok_prop)[0]
        else:
            Hs_s = _f_fallback_plain(Hs_c, r_c, lab_c, e_c, Hs_prop,
                                     ok_prop, relabel_energy, residuals)[0]
        if not on_device:
            return Hs_s, q_c
        joint = e_j < e_c
        return torch.where(joint, Hs_j, Hs_s), torch.where(joint, q_j, q_c)


def _f_fallback_plain(Hs_c, r_c, lab_c, e_c, Hs_prop, ok_prop,
                      relabel_energy, residuals):
    """`_f_accept`'s fallback in plain ops: model i's proposal (its
    carried model where ok_prop[i] is false) under an ICM relabel from
    the carried labeling, kept iff the energy drops, for every i in
    turn. Returns (Hs, e_steps (K,): each step's candidate energy, took
    (K,) bool: the steps taken)."""
    Hs_s, r_s, lab_s, e_s = Hs_c, r_c, lab_c, e_c
    e_steps, took = [], []
    for i in range(Hs_c.shape[0]):  # the lax.scan over models
        Hn = torch.where(ok_prop[i], Hs_prop[i], Hs_s[i])
        r_n = r_s.clone()
        r_n[i] = residuals(Hn[None])[0]
        lab_n, e_n = relabel_energy(r_n, lab_s)
        better = e_n < e_s
        Hs_s = Hs_s.clone()
        Hs_s[i] = torch.where(better, Hn, Hs_s[i])
        r_s = torch.where(better, r_n, r_s)
        lab_s = torch.where(better, lab_n, lab_s)
        e_s = torch.where(better, e_n, e_s)
        e_steps.append(e_n)
        took.append(better)
    return Hs_s, torch.stack(e_steps), torch.stack(took)


def _f_refine_phases(Hs, active, q, draws, x1, x2, valid, nbr_idx, nbr_w,
                     cfg: MultiHConfig, tau, adj, shard=None, basis=None):
    """The fundamental model's refinement phases (pipeline.py:1437-1696):
    f_exclusive_iterations exclusive-core refits, then
    f_resample_iterations member-resample LO moves (f_resample_subsets
    uniform 12-point subsets of every model's members, a trimmed member
    cost, one Tukey refit of the winner). Each move is energy-tested by
    `_f_accept`. `active` stays fixed. Returns (Hs, q).

    With a `shard`, the (., N) arrays are a 'pt' rank's own points: the
    labelings and energies run on the axis, the refits gather their
    weights, the counts are psums, and what needs every point runs
    replicated on gathered arrays: the resample's Gumbel top-k on the
    gathered member masks (every rank draws the whole (k, s, N) Gumbel
    from its generator, in the same state on every rank), the minimal
    solves on every point, and the trimmed costs on the gathered
    residuals. `basis` is every point's refit basis."""
    thr = _thr(cfg, tau, x1)
    k = cfg.max_labels
    dev = x1.device
    x1_all, x2_all, valid_all = ((x1, x2, valid) if shard is None
                                 else (shard.x1, shard.x2, shard.valid))
    if basis is None:
        basis = _prepare_refit_basis(x1_all, x2_all, cfg)
    m_min = 1.5 * float(cfg.minimal_points)
    ids = torch.arange(k, device=dev)

    def gathered(t):
        return t if shard is None else shard.gather(t)

    def residuals(Ms):
        return model_residual_matrix(Ms, x1, x2, cfg.residual, cfg)

    def members(lab):
        return (lab[None, :] == ids[:, None]).to(x1.dtype) * valid[None, :]

    def all_finite(Ms):
        return torch.isfinite(Ms.reshape(k, -1)).all(1)

    def label_energy(r_e, q0):
        dct_e = labeling.data_costs_t(r_e, valid, thr, cfg.outlier_cost,
                                      active)
        q_e = labeling.mean_field_t(
            dct_e, nbr_idx, nbr_w, cfg.spatial_weight,
            cfg.meanfield_iterations, cfg.temperature_start,
            cfg.temperature, q_init=q0, adj=adj, shard=shard,
        )
        lab_e = labeling.best_labeling_t(
            [torch.argmax(q_e, dim=0), torch.argmin(dct_e, dim=0)],
            dct_e, nbr_idx, nbr_w, cfg.spatial_weight, cfg.icm_iterations,
            adj=adj, shard=shard,
        )
        e = labeling.total_energy_t(lab_e, dct_e, nbr_idx, nbr_w,
                                    cfg.spatial_weight, cfg.label_cost,
                                    active, adj=adj, shard=shard)
        return lab_e, q_e, e

    fallback = None
    if _f_accept_kernel_ok(adj, shard):
        def fallback(Hs_c, r_c, lab_c, e_c, Hs_prop, r_prop, ok_prop):
            return accept_kernel.f_accept_fallback(
                Hs_c, r_c, lab_c, e_c, Hs_prop, r_prop, ok_prop, valid, thr,
                active, adj, cfg.spatial_weight, cfg.outlier_cost,
                cfg.label_cost, cfg.icm_iterations)

    def relabel_energy(r_n, lab0):
        dct_n = labeling.data_costs_t(r_n, valid, thr, cfg.outlier_cost,
                                      active)
        lab_n = labeling.best_labeling_t(
            [lab0, torch.argmin(dct_n, dim=0)],
            dct_n, nbr_idx, nbr_w, cfg.spatial_weight,
            cfg.icm_iterations, adj=adj, shard=shard,
        )
        e_n = labeling.total_energy_t(
            lab_n, dct_n, nbr_idx, nbr_w, cfg.spatial_weight,
            cfg.label_cost, active, adj=adj, shard=shard,
        )
        return lab_n, e_n

    if cfg.f_exclusive_refine:
        for _ in range(cfg.f_exclusive_iterations):
            r_c = residuals(Hs)
            lab_c, q, e_c = label_energy(r_c, q)
            inl = (r_c < thr).to(x1.dtype) * valid[None, :]
            n_in = (inl * active[:, None]).sum(0)  # (N,)
            rr_c = torch.clamp(r_c / thr, 0.0, 1.0)
            w_x = members(lab_c) * inl * (n_in == 1.0) * (1.0 - rr_c) ** 2
            core = (w_x > 0).to(x1.dtype)
            Hs_prop = _moment_refit(w_x, x1, x2, cfg, basis, shard)
            r_prop = residuals(Hs_prop)
            # degeneracy guard: the proposal keeps >= 80% of its own core
            # inside tau before it is energy-tested
            n_core, n_kept = _psum(shard, torch.stack(
                [core.sum(1), ((r_prop < thr).to(x1.dtype) * core).sum(1)]))
            cov_core = n_kept / torch.clamp_min(n_core, 1.0)
            ok_prop = ((n_core >= m_min) & (cov_core >= 0.8)
                       & all_finite(Hs_prop) & (active > 0))
            Hs, q = _f_accept(Hs, q, r_c, lab_c, e_c, Hs_prop, r_prop,
                              ok_prop, label_energy, relabel_energy,
                              residuals, fallback=fallback)

    if cfg.f_resample_lo:
        m_pts, s_sub, n_pts = 12, cfg.f_resample_subsets, x1_all.shape[0]
        for it in range(cfg.f_resample_iterations):
            r_c = residuals(Hs)
            lab_c, q, e_c = label_energy(r_c, q)
            member_c = members(lab_c)
            member_all = gathered(member_c)
            n_mem = member_all.sum(1)
            # S uniform 12-subsets of each model's members: Gumbel top-k
            # over the members (pipeline.py:1631-1638); jax.lax.top_k's
            # tie order among the -inf non-members
            g = draws.gumbel(("resample", it), (k, s_sub, n_pts), dev)
            logits = torch.where(member_all[:, None, :] > 0, g.to(x1.dtype),
                                 float("-inf"))
            _, idx = top_k_stable(logits, m_pts)  # (K, S, 12)
            Fs_cand, ok_solve = _solve_minimal_f(
                x1_all, x2_all, valid_all, idx.reshape(k * s_sub, m_pts), cfg)
            r_both = gathered(torch.cat([residuals(Fs_cand), r_c]))
            r_cand = r_both[:k * s_sub].reshape(k, s_sub, n_pts)
            t_idx = torch.clamp_min((0.8 * n_mem).to(torch.int64) - 1, 0)
            cost_cand = _trimmed_cost(r_cand, member_all[:, None, :],
                                      t_idx[:, None])  # (K, S)
            cost_cand = torch.where(ok_solve.reshape(k, s_sub) > 0,
                                    cost_cand, float("inf"))
            best_s = torch.argmin(cost_cand, dim=1)  # (K,)
            F_best = Fs_cand.reshape(k, s_sub, 3, 3)[ids, best_s]
            cost_best = cost_cand[ids, best_s]
            # one Tukey refit of the winner on the members it holds
            r_best = residuals(F_best)
            w_t = member_c * torch.clamp_min(
                1.0 - torch.clamp(r_best / thr, 0.0, 1.0), 0.0) ** 2
            F_ref = _moment_refit(w_t, x1, x2, cfg, basis, shard)
            r_ref = residuals(F_ref)
            cost_ref = torch.where(
                all_finite(F_ref),
                _trimmed_cost(gathered(r_ref), member_all, t_idx),
                float("inf"))
            cost_inc = _trimmed_cost(r_both[k * s_sub:], member_all, t_idx)
            take_ref = cost_ref < cost_best
            Hs_prop = torch.where(take_ref[:, None, None], F_ref, F_best)
            r_prop = torch.where(take_ref[:, None], r_ref, r_best)
            cost_prop = torch.minimum(cost_ref, cost_best)
            ok_prop = ((n_mem >= max(float(m_pts), m_min))
                       & (cost_prop < cost_inc) & (active > 0)
                       & all_finite(Hs_prop))
            Hs, q = _f_accept(Hs, q, r_c, lab_c, e_c, Hs_prop, r_prop,
                              ok_prop, label_energy, relabel_energy,
                              residuals, fallback=fallback)
    return Hs, q


def _hypothesize_verify(draws, x1, x2, valid, nbr_sample,
                        cfg: MultiHConfig, tau, extra_Hs, extra_ok,
                        window_block: int, shard=None):
    """Single-device hypothesis generation, the extras appended, and the
    verification sweep + top-M (pipeline.py:1214-1257): with
    cfg.verify_subsample > 1 the ranking sweep runs on a Morton-strided
    subsample and only the top M_pre are rescored at full resolution.
    With a `shard` (a 'pt' rank), generation runs replicated on the
    whole point set and each rank counts its own points' share of each
    sweep (the same stride positions), the integer counts summed over
    the axis. Returns (Hs_cand (M, 3, 3), n_hyp_ok)."""
    with stage("hypothesize"):
        Hs_all, ok = generate_hypotheses(
            draws, x1, x2, valid, nbr_sample, cfg, tau,
            window_block=window_block,
        )
    if extra_Hs:
        Hs_all = torch.cat([Hs_all] + extra_Hs)
        ok = torch.cat([ok] + extra_ok)
    vs = max(1, cfg.verify_subsample)
    lo, hi = (0, x1.shape[0]) if shard is None else (shard.lo, shard.hi)

    def counted(Hs, stride, kind=None):
        sub = slice(lo + (-lo) % stride, hi, stride)
        return _psum(shard, count_inliers(Hs, x1[sub], x2[sub], valid[sub],
                                          cfg, tau, kind=kind))

    with stage("verify"):
        # rank_residual only when a full-resolution rescore follows
        counts = counted(
            Hs_all, vs, (cfg.rank_residual or None) if vs > 1 else None,
        ) * ok
        if vs > 1:
            m_pre = min(cfg.verify_rescore * cfg.n_candidates,
                        counts.shape[0])
            # pipeline.py:1244/:1248: top_k tie order
            _, pre_idx = top_k_stable(counts, m_pre)
            counts_full = counted(Hs_all[pre_idx], 1) * ok[pre_idx]
            _, sel = top_k_stable(counts_full, cfg.n_candidates)
            top_idx = pre_idx[sel]
        else:
            # pipeline.py:1253
            _, top_idx = top_k_stable(counts, cfg.n_candidates)
    return Hs_all[top_idx], ok.sum()


def check_pt_gate(cfg: MultiHConfig, n_pts: int, mesh) -> None:
    """ValueError unless a fit of N = n_pts points can shard its point
    axis over `mesh` (a one-axis 'pt' mesh): the reference's gate
    (sharding.py:93-99, an assert there) -- spatial_sort, agree_block >
    0, N a multiple of agree_block * pt and N >= 2 agree_block -- plus
    what the port's split needs: an even agree_block (a window keeps its
    points' index parity for the red-black ICM). Both models and both
    graphs (windowed; exact, whose far edges a sweep gathers) shard."""
    npt = mesh.shape["pt"]
    b = cfg.agree_block
    if tuple(mesh.shape) != ("pt",):
        raise ValueError(f"a 'pt' mesh has one axis, not {mesh.shape}")
    if not (cfg.spatial_sort and b > 0):
        raise ValueError("pt sharding needs the banded gate: spatial_sort "
                         "+ agree_block")
    if n_pts % (b * npt) or n_pts < 2 * b:
        raise ValueError(f"max_points={n_pts} must be a multiple of "
                         f"agree_block*npt={b}*{npt} and >= 2*agree_block")
    if b % 2:
        raise ValueError("pt sharding needs an even agree_block")


def _check_slice(cfg: MultiHConfig, affines, mesh):
    """The reference's ValueError for affine hypotheses on another
    model than homography (pipeline.py:1176-1180)."""
    if affines is not None and cfg.model != "homography":
        raise ValueError(
            "affine one-point hypotheses are a homography-model path "
            "(Multi-H paper §3.1); drop `affines` for model='fundamental'"
        )


def _inputs(x1, x2, valid, device, mesh=None):
    """float32 tensors of the inputs. Tensors keep their device; arrays
    and lists go to `device`, by default the mesh's device, else the
    card. Asking for the card without one raises: the fit never falls
    back to the CPU quietly."""
    if device is None:
        device = "cuda" if mesh is None else mesh.device
    dev = torch.device(device)

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
    overriding cfg.inlier_threshold (a number or a tensor, e.g. from
    `estimate_tau`; never read back to the host). seed_Hs: optional
    (M, 3, 3) candidate homographies appended to the sampled pool before
    verification (the streaming warm start), competing with it on equal
    terms; seed_ok: optional (M,) {0,1} validity of each seed, non-finite
    seeds masked off regardless (pipeline.py:1193-1200). Both go to the
    points' device. affines: optional (N, 2, 2) local affine frames
    (dp2/dp1 at each correspondence; homography model only): F is
    estimated from the points and one homography a point derived from (F,
    p1, p2, A), the paper's one-point pool (§3.1), joining the pool ahead
    of the seeds. mesh: a parallel.mesh.Mesh; where its 'hyp' axis is
    > 1, hypothesis generation and verification split over that axis
    (pipeline.py:1202-1212) and every rank of the axis returns the
    single-device fit's result. A 'pt' mesh (sharding.make_pt_mesh)
    splits the point axis (`check_pt_gate`; either model, either graph):
    each rank takes a contiguous run of Morton blocks, hypothesis
    generation runs replicated, the sweeps exchange a one-block halo, the
    refits gather their weights,
    the other sums over the points run over the axis, and every rank
    returns the whole labeling (the reference's
    `_pt_constrain` points, pipeline.py:531). Every rank passes the same
    inputs and a key in the same state (a generator of the same seed),
    and array inputs go to the mesh's device."""
    _check_slice(cfg, affines, mesh)
    x1, x2, valid = _inputs(x1, x2, valid, device, mesh)
    n_pts = x1.shape[0]
    shard = None
    if mesh is not None and "pt" in mesh.shape:
        check_pt_gate(cfg, n_pts, mesh)
        shard = labeling.PointShard(mesh, n_pts, cfg.agree_block)
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

    if affines is not None:
        affines = torch.as_tensor(affines, dtype=x1.dtype, device=dev)
    # Morton order; labels are scattered back at the end
    if cfg.spatial_sort:
        perm = morton_order(x1, valid)
        x1, x2, valid = x1[perm], x2[perm], valid[perm]
        if affines is not None:
            affines = affines[perm]

    # pipeline.py:1121-1169: the windowed graph when the banded gate
    # holds and cfg.knn_window, for both graphs; its band is far-free.
    # Without the gate the labeling takes the gather path (adj None).
    windowed = graph_path(cfg, n_pts) == "windowed"
    # a 'pt' rank builds its own points' rows (of the windowed or the
    # exact graph) and gathers the sampling graph, which generation reads
    # whole
    rows = None if shard is None else (shard.lo, shard.hi)

    def graph_of(feats):
        if windowed:
            return labeling.knn_graph_windowed(feats, valid, cfg.knn_k,
                                               cfg.agree_block, rows)
        return labeling.knn_graph(feats, valid, cfg.knn_k,
                                  cfg.knn_row_block, cfg.knn_approx, rows)

    def gathered(nbr):
        return nbr if shard is None else shard.gather(nbr.T).T.contiguous()

    with stage("knn_graph"):
        nbr_idx, nbr_w = graph_of(x1)
    adj = None
    if shard is not None:
        with stage("banded_adjacency"):
            adj = labeling.shard_adjacency(
                nbr_idx, nbr_w, shard, windowed,
                neighbour_list=_kernels_enabled(cfg, dev))
    elif banded_gate(cfg, n_pts):
        with stage("banded_adjacency"):
            adj = labeling.build_banded_adjacency(
                nbr_idx, nbr_w, cfg.agree_block,
                far_capacity=0 if windowed else None,
                neighbour_list=_kernels_enabled(cfg, dev),
            )
    if cfg.sampling_motion_weight > 0.0:
        feat = torch.cat([x1, cfg.sampling_motion_weight * (x2 - x1)], dim=1)
        with stage("sampling_knn"):
            nbr_sample = gathered(graph_of(feat)[0])
    else:
        nbr_sample = gathered(nbr_idx)

    # extras join the sampled pool in the reference's order (pipeline.py:
    # 1171-1224): the affine one-point pool, then the seeds, so top_k's
    # tie order sees the same indices
    extra_Hs, extra_ok = [], []
    if affines is not None:
        with stage("affine_pool"):
            F_est = epipolar.estimate_fundamental(
                draws, x1, x2, valid, n_samples=min(512, cfg.n_hypotheses),
                threshold=max(1.0, cfg.inlier_threshold / 3.0),
            )
            H_aff = epipolar.homography_one_point_batch(F_est, x1, x2,
                                                        affines)
            finite = torch.isfinite(H_aff.reshape(-1, 9)).all(1)
        extra_Hs.append(H_aff)
        extra_ok.append(valid * finite.to(x1.dtype))
    if seed_Hs is not None:
        seed_Hs = torch.as_tensor(seed_Hs, dtype=x1.dtype,
                                  device=dev).reshape(-1, 3, 3)
        s_finite = torch.isfinite(seed_Hs.reshape(seed_Hs.shape[0], -1)
                                  ).all(1).to(x1.dtype)
        extra_Hs.append(seed_Hs)
        extra_ok.append(s_finite if seed_ok is None else torch.as_tensor(
            seed_ok, dtype=x1.dtype, device=dev) * s_finite)
    window_block = (cfg.agree_block if windowed and cfg.window_sampling
                    else 0)
    if mesh is not None and mesh.shape.get("hyp", 1) > 1:
        _, Hs_cand, n_hyp_ok = _hypothesize_verify_sharded(
            draws, x1, x2, valid, nbr_sample, cfg, tau, mesh,
            torch.cat(extra_Hs) if extra_Hs else None,
            torch.cat(extra_ok) if extra_Hs else None,
            window_block=window_block,
        )
    else:
        Hs_cand, n_hyp_ok = _hypothesize_verify(
            draws, x1, x2, valid, nbr_sample, cfg, tau, extra_Hs, extra_ok,
            window_block, shard)

    basis = None
    if shard is not None:
        # from here on a 'pt' rank holds its own points only
        own = slice(shard.lo, shard.hi)
        shard.x1, shard.x2, shard.valid = x1, x2, valid
        if cfg.refit_moments or cfg.model == "fundamental":
            basis = _prepare_refit_basis(x1, x2, cfg)
        x1, x2, valid = x1[own], x2[own], valid[own]

    with stage("lo_refine"):
        Hs_top = lo_refine_candidates(Hs_cand, x1, x2, valid, cfg,
                                      cfg.lo_rounds, tau, shard, basis)
    with stage("select"):
        r_top = model_residual_matrix(Hs_top, x1, x2, cfg.residual, cfg)
        grown_counts = _psum(shard, ((r_top < thr) * valid[None, :]).sum(1))
        if cfg.model == "fundamental":
            # marginal coverage: bridging Fs outcount pure single-motion
            # models, so count + NMS would fill the roster with bridges
            cand_idx, cand_active = selection.select_candidates_coverage(
                r_top, valid, thr, torch.ones_like(grown_counts),
                cfg.n_candidates, k, min_gain=float(cfg.min_inliers),
                reduce=None if shard is None else shard.psum,
            )
        else:
            cand_idx, cand_active = selection.select_candidates(
                r_top, valid, thr, torch.ones_like(grown_counts),
                cfg.n_candidates, k, cfg.nms_iou,
                reduce=None if shard is None else shard.psum,
            )
    Hs = Hs_top[cand_idx]
    active = cand_active * (grown_counts[cand_idx]
                            >= cfg.min_inliers).to(x1.dtype)

    # PEARL: q starts from the data costs of the selected candidates
    r0 = model_residual_matrix(Hs, x1, x2, cfg.residual, cfg)
    d0 = labeling.data_costs_t(r0, valid, thr, cfg.outlier_cost, active)
    q = torch.softmax(-d0 / cfg.temperature_start, dim=0)  # (L, N)
    with stage("pearl"):
        Hs, active, q, energies = _pearl_phase(
            Hs, active, q, range(cfg.pearl_iterations), x1, x2, valid,
            nbr_idx, nbr_w, cfg, tau, adj, shard, basis,
        )
    f_model = cfg.model == "fundamental"
    if f_model and cfg.f_split_refine:
        with stage("split_refine"):
            Hs, active, q, en2 = _split_refine(
                Hs, active, q, x1, x2, valid, nbr_idx, nbr_w, cfg, tau, adj,
                shard, basis)
        energies += en2
    if f_model and (
            (cfg.f_exclusive_refine and cfg.f_exclusive_iterations > 0)
            or (cfg.f_resample_lo and cfg.f_resample_iterations > 0)):
        with stage("f_refine_phases"):
            Hs, q = _f_refine_phases(Hs, active, q, draws, x1, x2, valid,
                                     nbr_idx, nbr_w, cfg, tau, adj, shard,
                                     basis)

    with stage("finalize"):
        r = model_residual_matrix(Hs, x1, x2, cfg.residual, cfg)
        dct = labeling.data_costs_t(r, valid, thr, cfg.outlier_cost, active)
        labels = labeling.best_labeling_t(
            [torch.argmax(q, dim=0), torch.argmin(dct, dim=0)],
            dct, nbr_idx, nbr_w, cfg.spatial_weight, cfg.icm_iterations,
            adj=adj, shard=shard,
        )
        label_active = torch.cat([active, torch.ones(1, dtype=active.dtype,
                                                     device=dev)])
        labels = torch.where(label_active[labels] > 0, labels, k)
        labels = torch.where(valid > 0, labels, k).to(torch.int32)
        member = (labels[None, :] == torch.arange(k, device=dev)[:, None])
        support = _psum(shard, (member.to(x1.dtype) * valid[None, :]).sum(1))
        if shard is not None:
            labels = shard.gather(labels)
        if cfg.spatial_sort:
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
        n_far_dropped=(shard.n_dropped if shard is not None
                       else adj.n_dropped if adj is not None
                       else torch.zeros((), dtype=torch.int32, device=dev)),
    )


def _noise_median_factor(cfg: MultiHConfig) -> float:
    """median(r^2 of true members) / sigma^2 of the configured model
    class and residual kind (pipeline.py:1736): 5.85 for every
    homography kind, as the reference keeps it (its calibration is the
    symmetric transfer's), 0.466 for fundamental Sampson, 1.874 for
    fundamental symmetric epipolar."""
    if cfg.model == "fundamental":
        return 1.874 if cfg.residual == "symmetric" else 0.466
    return 5.85


def tau_from_members(r_own, is_member, cfg: MultiHConfig, floor=None,
                     cap=None) -> torch.Tensor:
    """tau = 6 sigma from the median squared own-model residual of the
    members (pipeline.py:1750): the element at n_members // 2 of the
    members' sorted residuals, scaled by 36 / _noise_median_factor,
    square-rooted and clipped to [floor, cap] (per model class: (3, 12)
    px for homographies, (1.5, 9) for F); cfg.inlier_threshold when
    fewer than min_inliers members exist. A 0-dim tensor on r_own's
    device, computed without reading anything back to the host."""
    if floor is None:
        floor = 1.5 if cfg.model == "fundamental" else 3.0
    if cap is None:
        cap = 9.0 if cfg.model == "fundamental" else 12.0
    vals = torch.where(is_member, r_own, float("inf"))
    n_m = is_member.to(torch.int64).sum()
    med = torch.sort(vals).values.index_select(
        0, torch.clamp_min(n_m // 2, 0).view(1))[0]
    tau = torch.sqrt(36.0 / _noise_median_factor(cfg)
                     * torch.clamp_min(med, 1e-6))
    tau = torch.clamp(tau, floor, cap)
    return torch.where(n_m >= cfg.min_inliers, tau,
                       torch.full_like(tau, cfg.inlier_threshold))


def estimate_tau(res: FitResult, x1, x2, valid, cfg: MultiHConfig,
                 floor=None, cap=None) -> torch.Tensor:
    """Noise-adaptive inlier threshold (px) from a previous fit
    (pipeline.py:1772): its members' squared residuals to their own
    model, padded points and the outlier label excluded, through
    `tau_from_members`. The points (the fit's inputs, in the caller's
    order) go to the device of res.labels."""
    x1, x2, valid = _inputs(x1, x2, valid, res.labels.device)
    k = cfg.max_labels
    r = model_residual_matrix(res.homographies, x1, x2, cfg.residual, cfg)
    lab = res.labels.to(torch.int64)
    is_member = (lab < k) & (valid > 0)
    r_own = torch.gather(r.T, 1, torch.clamp(lab, 0, k - 1)[:, None])[:, 0]
    return tau_from_members(r_own, is_member, cfg, floor, cap)


def fit_adaptive(x1, x2, valid, key, cfg: MultiHConfig,
                 probe_tau: float = 8.0, mesh=None, device=None):
    """Two-pass fit with a self-calibrated inlier threshold
    (pipeline.py:1796): a probe fit at `probe_tau` px, `estimate_tau` on
    its members, then the fit at that tau. key: a ``torch.Generator`` or
    draw source drawn by both passes in turn, or a (probe, fit) pair of
    them (the reference splits its key in two). tau stays on the device
    between the passes. mesh: as `fit`'s, for both passes. Returns
    (FitResult, tau)."""
    x1, x2, valid = _inputs(x1, x2, valid, device, mesh)
    k_probe, k_fit = key if isinstance(key, tuple) else (key, key)
    res0 = fit(x1, x2, valid, k_probe, cfg, tau=probe_tau, mesh=mesh)
    tau = estimate_tau(res0, x1, x2, valid, cfg)
    return fit(x1, x2, valid, k_fit, cfg, tau=tau, mesh=mesh), tau


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


def make_fit_seeded(cfg: MultiHConfig, device=None):
    """fit with cfg bound and seed homographies as arguments, the
    streaming warm start: f(x1, x2, valid, key, seed_Hs, seed_ok)."""
    def f(x1, x2, valid, key, seed_Hs, seed_ok):
        return fit(x1, x2, valid, key, cfg, seed_Hs=seed_Hs, seed_ok=seed_ok,
                   device=device)
    return f


def make_fit_adaptive(cfg: MultiHConfig, probe_tau: float = 8.0,
                      device=None):
    """The two-pass adaptive-threshold fit with cfg bound:
    f(x1, x2, valid, key) -> (FitResult, tau)."""
    def f(x1, x2, valid, key):
        return fit_adaptive(x1, x2, valid, key, cfg, probe_tau,
                            device=device)
    return f
