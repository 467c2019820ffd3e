"""Whether what the timed path produced is correct: the reference judges
a sample of the window's pairs, drawn from the seed, by their outputs
(each point's label, each returned model, the active set) against the
benchmark's own inputs and the scenes' truth.

Per pair, in float64 (portbench/reference/):
- the misclassification % of the labels under the best matching of
  returned models to true ones;
- each active model's refit gap: the model's own members, weighted as
  the fit weights its refits (Tukey on the model's residuals at the
  configured threshold), refitted once by the reference; the gap is the
  RMS difference, in px, between the members' distances to the returned
  model and to that refit. A model the fit refitted to its members sits
  at that refit's fixed point up to the rounding of the fit's
  arithmetic; lower precision (TF32 products) moves it off.
- the share of labelled points whose residual under their own model is
  past the threshold.

The numbers are statistics of these over the sample (`numbers`); each
configuration's file gives the ones compared and their limits, and a
run reports all of them.
"""

from __future__ import annotations

import importlib

import numpy as np

from portbench.reference import common


def judge_pair(labels, models, active, x1, x2, valid, gt, ref, k: int,
               thr: float) -> dict:
    """The reference's readings of one pair's outputs."""
    labels = np.asarray(labels).astype(np.int64)
    models = np.asarray(models, np.float64)
    n = int(valid.sum())
    x1, x2, lab, gt = (np.asarray(x1[:n], np.float64),
                       np.asarray(x2[:n], np.float64), labels[:n], gt[:n])
    out = {"well_formed": bool(labels.shape == valid.shape
                               and np.all((labels >= 0) & (labels <= k))
                               and np.all(labels[n:] == k))}
    if not out["well_formed"]:
        return out
    out["miscls_pct"] = common.misclassification_pct(lab, gt, k)
    gaps, over, labelled = [], 0, 0
    for m in np.unique(lab[lab < k]):
        mem = lab == m
        if not (np.asarray(active)[m] > 0 and np.all(np.isfinite(models[m]))):
            return dict(out, well_formed=False)
        r = ref.residual(models[m], x1[mem], x2[mem])
        over += int(np.sum(~(r < thr)))
        labelled += int(mem.sum())
        w = common.tukey(r, thr)
        if np.count_nonzero(w) < ref.MINIMAL_POINTS:
            continue
        fit = ref.refit(x1[mem], x2[mem], w)
        r_fit = ref.residual(fit, x1[mem], x2[mem])
        use = w > 0
        d = np.sqrt(r_fit[use]) - np.sqrt(r[use])
        gaps.append(float(np.sqrt(np.mean(d * d))))
    out["model_gaps_px"] = gaps
    out["over_thr_pct"] = 100.0 * over / labelled if labelled else 0.0
    return out


GAP_QUANTILES = (10, 20)
FIXED_POINT_PX = 1e-2


def numbers(readings: list[dict]) -> dict:
    """The numbers a sample's readings give, which limits are set on: the
    mean misclassification %, the mean share past threshold, the 10th and
    20th percentiles of the models' refit gaps (NaN with no model), and
    the share of models off their refit's fixed point (gap over 1e-2
    px). A model at its refit's fixed point reads what float32 rounding
    alone sets (1e-4-3e-3 px); one whose members moved after its last
    refit reads 0.01-0.6 px by the algorithm. A low percentile reads the
    former as long as that share of the models is at the fixed point."""
    models = np.asarray([g for r in readings for g in r["model_gaps_px"]])
    out = {
        "miscls_mean_pct": float(np.mean([r["miscls_pct"]
                                          for r in readings])),
        "over_thr_mean_pct": float(np.mean([r["over_thr_pct"]
                                            for r in readings])),
        "models_off_pct": (100.0 * float(np.mean(models > FIXED_POINT_PX))
                           if models.size else float("nan")),
    }
    for q in GAP_QUANTILES:
        out[f"model_gap_p{q}_px"] = (float(np.percentile(models, q))
                                     if models.size else float("nan"))
    return out


def sample(completed: int, size: int, seed: int) -> list[int]:
    """Indices of the pairs to judge: `size` of the `completed` ones (all
    when fewer), drawn from the seed."""
    rng = np.random.default_rng([seed & (2**64 - 1), 0xC4EC])
    if completed <= size:
        return list(range(completed))
    return sorted(rng.choice(completed, size, replace=False).tolist())


def judge(done: list, pool: list, config: dict, seed: int) -> tuple:
    """(correct, {number: {"value", "limit"}}, all numbers) of a run's
    completed pairs `done`: (pool index, (labels, models, active)).
    Every number the configuration's `check` lists is compared with its
    limit; a pair whose outputs are malformed fails the run."""
    spec = config["check"]
    ref = importlib.import_module(f"portbench.reference.{config['reference']}")
    k = config["multih"]["max_labels"]
    thr = float(config["multih"]["inlier_threshold"]) ** 2
    readings = []
    for i in sample(len(done), spec["sample"], seed):
        scene_i, (labels, models, active) = done[i]
        x1, x2, valid, gt = pool[scene_i]
        readings.append(judge_pair(labels, models, active, x1, x2, valid,
                                   gt, ref, k, thr))
    bad = sum(not r["well_formed"] for r in readings)
    got = numbers([r for r in readings if r["well_formed"]]) \
        if len(readings) > bad else {}
    compared = {"malformed_pairs": {"value": bad, "limit": 0}}
    for name, limit in spec["limits"].items():
        compared[name] = {"value": got.get(name, float("nan")),
                          "limit": limit}
    ok = bool(readings) and all(
        v["value"] <= v["limit"] for v in compared.values())
    return ok, compared, got
