"""Mixed plane + motion fitting in PyTorch: homographies and fundamental
matrices in one label space.

Counterpart of ``multih_tpu/models/mixed.py``, whose docstrings give the
design (the containment asymmetry, `f_bias`, `f_scope`, why the adaptive
probes are single-class). A homography fit on every point, a fundamental
fit on every point (or, with ``f_scope="remainder"``, on the points the
planes left), then one joint PEARL polish over the union label space on
the exact k-NN graph of the caller's points, unsorted and unbanded (the
gather-path labeling): mean-field from the sequential composition, ICM
from two starts, four label-cost prune rounds, `polish_refits` rounds of
Tukey-weighted F refits, the min-support prune and the energy. Each
stage is a ``utils.tracing.stage`` of the JAX ``named_scope``'s name (a
``torch.profiler.record_function`` range, and a span while captured).
Nothing in the polish reads a device value back
to the host.

Draws: the reference splits its key in two for `fit_mixed` (plane stage,
motion stage) and in three for `fit_mixed_adaptive` (probe_h, probe_f,
fit). Here `key` is one ``torch.Generator`` or draw source, drawn by the
stages in that order, or a tuple with one draw source a stage.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from multih_tpu_torch.config import MultiHConfig
from multih_tpu_torch.models import labeling, pipeline
from multih_tpu_torch.ops import fmodel, geometry
from multih_tpu_torch.utils.tracing import stage


class MixedFitResult(NamedTuple):
    """Union-label-space analog of FitResult
    (multih_tpu.models.mixed.MixedFitResult). Labels 0..Kh-1 are planes,
    Kh..Kh+Kf-1 motions, Kh+Kf the outlier, for Kh = cfg_h.max_labels and
    Kf = cfg_f.max_labels."""

    labels: torch.Tensor     # (N,) int32 in [0, Kh+Kf]
    models: torch.Tensor     # (Kh+Kf, 3, 3) — H's then F's, ||.||_F = 1
    is_f: torch.Tensor       # (Kh+Kf,) float {0,1}: 1 = fundamental matrix
    active: torch.Tensor     # (Kh+Kf,) float {0,1}
    support: torch.Tensor    # (Kh+Kf,) float — member count per model
    energy: torch.Tensor     # () joint MRF energy of the final labels
    result_h: pipeline.FitResult   # the plane stage
    result_f: pipeline.FitResult   # the motion stage


def _joint_residual_units(res_h, res_f, x1, x2, cfg_h: MultiHConfig,
                          cfg_f: MultiHConfig, tau_h=None, tau_f=None):
    """(Kh+Kf, N) squared residuals in per-class threshold units (r/tau)^2
    (mixed.py:78)."""
    r_h = geometry.residual_matrix(res_h.homographies, x1, x2,
                                   cfg_h.residual) \
        / pipeline._thr(cfg_h, tau_h, x1)
    r_f = fmodel.residual_matrix_f(res_f.homographies, x1, x2,
                                   cfg_f.residual) \
        / pipeline._thr(cfg_f, tau_f, x1)
    return torch.cat([r_h, r_f], dim=0)


def _stage_draws(key, n: int):
    """A tuple of n draw sources as given, or one source for all n."""
    if isinstance(key, tuple):
        if len(key) != n:
            raise ValueError(f"{len(key)} draw sources for {n} stages")
        return key
    return (key,) * n


@torch.inference_mode()
def fit_mixed(x1, x2, valid, key, cfg_h: MultiHConfig, cfg_f: MultiHConfig,
              f_bias: float = 0.5, polish_meanfield: int = 4,
              polish_icm: int = 2, tau_h=None, tau_f=None,
              f_scope: str = "all", polish_refits: int = 2,
              device=None) -> MixedFitResult:
    """Mixed plane + motion segmentation of one padded correspondence set
    (mixed.py:94). x1, x2, valid: as `pipeline.fit` (numpy input goes to
    `device`, by default the card). key: a ``torch.Generator`` or draw
    source for both stages in turn, or a (plane, motion) pair. cfg_h:
    model="homography"; cfg_f: model="fundamental". f_bias: the class
    penalty on fundamental labels in the polish, in units of
    cfg_h.outlier_cost. polish_meanfield / polish_icm: the polish's sweep
    counts (0 and 0: the sequential composition). tau_h / tau_f:
    per-class thresholds in px (numbers or device tensors) overriding
    the configs. f_scope: "all" fits motions on every point, anything
    else on the planes' remainder. polish_refits: F refit rounds after
    the prune."""
    if cfg_h.model != "homography":
        raise ValueError("cfg_h must have model='homography'")
    if cfg_f.model != "fundamental":
        raise ValueError("cfg_f must have model='fundamental'")
    x1, x2, valid = pipeline._inputs(x1, x2, valid, device)
    key_h, key_f = _stage_draws(key, 2)
    dt, dev = x1.dtype, x1.device
    kh, kf = cfg_h.max_labels, cfg_f.max_labels
    k_union = kh + kf

    # stage 1: planes on everything (the stricter, codim-2 model first)
    with stage("mixed_fit_h"):
        res_h = pipeline.fit(x1, x2, valid, key_h, cfg_h, tau=tau_h)
    explained_h = (res_h.labels < kh).to(dt)

    # stage 2: motions, on everything or on the planes' remainder
    with stage("mixed_fit_f"):
        valid_f = valid if f_scope == "all" else valid * (1.0 - explained_h)
        res_f = pipeline.fit(x1, x2, valid_f, key_f, cfg_f, tau=tau_f)

    models = torch.cat([res_h.homographies, res_f.homographies], dim=0)
    is_f = torch.cat([torch.zeros((kh,), dtype=dt, device=dev),
                      torch.ones((kf,), dtype=dt, device=dev)])
    active = torch.cat([res_h.active, res_f.active], dim=0)

    # sequential composition of the two label fields (the polish start)
    lab_seq = torch.where(
        res_h.labels < kh, res_h.labels,
        torch.where(res_f.labels < kf, kh + res_f.labels, k_union),
    ).to(torch.int32)

    with stage("mixed_polish"):
        r = _joint_residual_units(res_h, res_f, x1, x2, cfg_h, cfg_f,
                                  tau_h, tau_f)
        one = torch.ones((), dtype=dt, device=dev)
        bias_row = torch.cat([is_f * (f_bias * cfg_h.outlier_cost),
                              torch.zeros((1,), dtype=dt, device=dev)]
                             )[:, None] * valid[None, :]

        def costs(active):
            return labeling.data_costs_t(r, valid, one, cfg_h.outlier_cost,
                                         active) + bias_row  # (K_union+1, N)

        dct = costs(active)
        nbr_idx, nbr_w = labeling.knn_graph(x1, valid, cfg_h.knn_k,
                                            cfg_h.knn_row_block)
        sw = cfg_h.spatial_weight

        def relabel(labels, dct):
            return labeling.best_labeling_t([labels], dct, nbr_idx, nbr_w,
                                            sw, 1)

        if polish_meanfield > 0 or polish_icm > 0:
            q0 = labeling._onehot_t(lab_seq, k_union + 1, dt)
            q = labeling.mean_field_t(
                dct, nbr_idx, nbr_w, sw, polish_meanfield,
                cfg_h.temperature, cfg_h.temperature, q_init=q0,
            ) if polish_meanfield > 0 else q0
            labels = labeling.best_labeling_t(
                [lab_seq, torch.argmax(q, dim=0)], dct, nbr_idx, nbr_w, sw,
                polish_icm,
            )
            # the joint label-cost prune (mixed.py:207-239): greedy
            # one-removal rounds, ICM reassignment between rounds
            ids = torch.arange(k_union + 1, device=dev)
            for _ in range(4):
                oh = (labels[None, :] == ids[:, None]).to(dt)
                member = oh[:k_union] * valid[None, :] * active[:, None]
                own = (oh * dct).sum(0)
                runner = torch.where(oh > 0, float("inf"), dct).amin(0)
                switch = ((runner - own)[None, :] * member).sum(1)
                gain = cfg_h.label_cost - switch
                worst = torch.argmax(torch.where(active > 0, gain,
                                                 float("-inf"))).view(1)
                active = active.clone()
                active[worst] = torch.where(gain[worst] > 0, 0.0,
                                            active[worst])
                dct = costs(active)
                labels = relabel(labels, dct)
            # refit alternation on the motion half (mixed.py:240-302):
            # Tukey-weighted F refits on the current members, each taken
            # if its member-restricted inlier count does not shrink, then
            # one ICM reassignment; the H's stay frozen
            thr_f = pipeline._thr(cfg_f, tau_f, x1)
            basis_f = fmodel.prepare_refit_f(x1, x2)
            for _ in range(polish_refits):
                oh = (labels[None, :] == ids[:, None]).to(dt)
                member_f = (oh[kh:k_union] * valid[None, :]
                            * active[kh:, None])  # (Kf, N)
                rf = r[kh:]  # threshold units (squared)
                tk = torch.clamp_min(1.0 - rf, 0.0) ** 2 * (rf < 1.0)
                w_f = member_f * tk
                Fs_new = fmodel.fundamental_refit_batch(
                    w_f, basis_f, cfg_f.eig_method, cfg_f.eig_iterations,
                    eig_kernel=pipeline._kernels_enabled(cfg_f, dev),
                )
                enough = (((w_f > 0).to(dt).sum(1)
                           >= float(cfg_f.minimal_points))
                          & torch.isfinite(Fs_new.reshape(kf, -1)).all(1))
                rf_new = fmodel.residual_matrix_f(Fs_new, x1, x2,
                                                  cfg_f.residual) / thr_f
                in_old = ((rf < 1.0) * member_f).sum(1)
                in_new = ((rf_new < 1.0) * member_f).sum(1)
                take = (enough & (in_new >= in_old))[:, None]
                models = torch.cat([
                    models[:kh],
                    torch.where(take[..., None], Fs_new, models[kh:]),
                ], dim=0)
                r = torch.cat([r[:kh], torch.where(take, rf_new, rf)], dim=0)
                dct = costs(active)
                labels = relabel(labels, dct)
        else:
            labels = lab_seq

    # per-model support, the per-class min-support prune, outliers folded
    # in, and the full PEARL energy (mixed.py:304-320)
    member = (labels[None, :] == torch.arange(k_union, device=dev)[:, None]
              ).to(dt) * valid[None, :]
    support = member.sum(1)
    min_sup = torch.where(is_f > 0, float(cfg_f.min_inliers),
                          float(cfg_h.min_inliers))
    active = active * (support >= min_sup).to(dt)
    labels = torch.where(
        active[torch.clamp(labels, 0, k_union - 1).long()] > 0, labels,
        k_union).to(torch.int32)
    support = support * active
    energy = labeling.total_energy_t(labels, dct, nbr_idx, nbr_w,
                                     cfg_h.spatial_weight, cfg_h.label_cost,
                                     active)
    return MixedFitResult(labels=labels, models=models, is_f=is_f,
                          active=active, support=support, energy=energy,
                          result_h=res_h, result_f=res_f)


def _per_model_sigma(r, labels, valid, k: int, factor: float,
                     min_inliers: int):
    """Per-model noise estimates from one probe fit (mixed.py:327): for
    each of the k models, sqrt of the median squared own-member residual
    (the element at n_members // 2 of the sorted members) over `factor`.
    Returns (sigma (k,), qualified (k,) bool: >= min_inliers members)."""
    mem = ((labels[None, :] == torch.arange(k, device=labels.device)[:, None])
           & (valid[None, :] > 0))
    cnt = mem.to(torch.int64).sum(1)
    vals = torch.sort(torch.where(mem, r, float("inf")), dim=1).values
    med = torch.gather(vals, 1, (cnt // 2)[:, None])[:, 0]
    sigma = torch.sqrt(torch.clamp_min(med, 1e-12) / factor)
    return sigma, cnt >= min_inliers


def estimate_tau_mixed(res_h, res_f, x1, x2, valid, cfg_h: MultiHConfig,
                       cfg_f: MultiHConfig):
    """Per-class noise-adaptive thresholds (tau_h, tau_f) in px from two
    single-class probe fits (mixed.py:343): the minimum sigma over the
    qualifying models of both classes, tau_h = clip(6 sigma, 3, 12) and
    tau_f = clip(6 sigma, 1.5, 9); both configs' static thresholds when
    no model qualifies. 0-dim tensors on the device of res_h.labels,
    computed without reading anything back to the host."""
    x1, x2, valid = pipeline._inputs(x1, x2, valid, res_h.labels.device)
    r_h = geometry.residual_matrix(res_h.homographies, x1, x2,
                                   cfg_h.residual)
    s_h, ok_h = _per_model_sigma(
        r_h, res_h.labels, valid, cfg_h.max_labels,
        pipeline._noise_median_factor(cfg_h), cfg_h.min_inliers)
    r_f = fmodel.residual_matrix_f(res_f.homographies, x1, x2,
                                   cfg_f.residual)
    s_f, ok_f = _per_model_sigma(
        r_f, res_f.labels, valid, cfg_f.max_labels,
        pipeline._noise_median_factor(cfg_f), cfg_f.min_inliers)
    ok = torch.cat([ok_h, ok_f])
    sigma = torch.where(ok, torch.cat([s_h, s_f]), float("inf")).amin()
    any_ok = ok.any()
    tau_h = torch.where(any_ok, torch.clamp(6.0 * sigma, 3.0, 12.0),
                        torch.full_like(sigma, cfg_h.inlier_threshold))
    tau_f = torch.where(any_ok, torch.clamp(6.0 * sigma, 1.5, 9.0),
                        torch.full_like(sigma, cfg_f.inlier_threshold))
    return tau_h.to(x1.dtype), tau_f.to(x1.dtype)


def fit_mixed_adaptive(x1, x2, valid, key, cfg_h: MultiHConfig,
                       cfg_f: MultiHConfig, probe_tau_h: float = 8.0,
                       probe_tau_f: float = 6.0, device=None,
                       **mixed_kwargs):
    """Two-pass mixed fit with self-calibrated per-class thresholds
    (mixed.py:399): a homography probe at `probe_tau_h` and a fundamental
    probe at `probe_tau_f`, each on every point, `estimate_tau_mixed`,
    then `fit_mixed` at those taus (kept on the device). key: one
    generator or draw source for all three, or a (probe_h, probe_f, fit)
    tuple, whose fit entry may itself be a (plane, motion) pair. Returns
    (MixedFitResult, tau_h, tau_f)."""
    x1, x2, valid = pipeline._inputs(x1, x2, valid, device)
    key_h, key_f, key_fit = _stage_draws(key, 3)
    with stage("mixed_probe_h"):
        res_h0 = pipeline.fit(x1, x2, valid, key_h, cfg_h, tau=probe_tau_h)
    with stage("mixed_probe_f"):
        res_f0 = pipeline.fit(x1, x2, valid, key_f, cfg_f, tau=probe_tau_f)
    tau_h, tau_f = estimate_tau_mixed(res_h0, res_f0, x1, x2, valid, cfg_h,
                                      cfg_f)
    res = fit_mixed(x1, x2, valid, key_fit, cfg_h, cfg_f, tau_h=tau_h,
                    tau_f=tau_f, **mixed_kwargs)
    return res, tau_h, tau_f


def make_fit_mixed(cfg_h: MultiHConfig, cfg_f: MultiHConfig,
                   f_bias: float = 0.5, polish_meanfield: int = 4,
                   polish_icm: int = 2, f_scope: str = "all",
                   polish_refits: int = 2, device=None):
    """fit_mixed with the configs (and the device for array inputs)
    bound: f(x1, x2, valid, key) -> MixedFitResult."""
    def f(x1, x2, valid, key):
        return fit_mixed(x1, x2, valid, key, cfg_h, cfg_f, f_bias,
                         polish_meanfield, polish_icm, f_scope=f_scope,
                         polish_refits=polish_refits, device=device)
    return f


def make_fit_mixed_tau(cfg_h: MultiHConfig, cfg_f: MultiHConfig,
                       f_bias: float = 0.5, polish_meanfield: int = 4,
                       polish_icm: int = 2, f_scope: str = "all",
                       polish_refits: int = 2, device=None):
    """fit_mixed with the configs bound and the per-class thresholds (px,
    numbers or device tensors) as arguments:
    f(x1, x2, valid, key, tau_h, tau_f) -> MixedFitResult."""
    def f(x1, x2, valid, key, tau_h, tau_f):
        return fit_mixed(x1, x2, valid, key, cfg_h, cfg_f, f_bias,
                         polish_meanfield, polish_icm, tau_h=tau_h,
                         tau_f=tau_f, f_scope=f_scope,
                         polish_refits=polish_refits, device=device)
    return f


def make_fit_mixed_adaptive(cfg_h: MultiHConfig, cfg_f: MultiHConfig,
                            f_bias: float = 0.5, polish_meanfield: int = 4,
                            polish_icm: int = 2, f_scope: str = "all",
                            polish_refits: int = 2,
                            probe_tau_h: float = 8.0,
                            probe_tau_f: float = 6.0, device=None):
    """The two-pass per-class adaptive mixed fit with the configs bound:
    f(x1, x2, valid, key) -> (MixedFitResult, tau_h, tau_f)."""
    def f(x1, x2, valid, key):
        return fit_mixed_adaptive(
            x1, x2, valid, key, cfg_h, cfg_f, probe_tau_h=probe_tau_h,
            probe_tau_f=probe_tau_f, device=device, f_bias=f_bias,
            polish_meanfield=polish_meanfield, polish_icm=polish_icm,
            f_scope=f_scope, polish_refits=polish_refits)
    return f
