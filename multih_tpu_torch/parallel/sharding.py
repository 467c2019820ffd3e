"""Batched fitting of many pairs in one call, on one device.

Counterpart of the single-device part of ``multih_tpu/parallel/
sharding.py``: `batched_fit`, `batched_fit_mixed`,
`prepare_benchmark_batch` and `run_benchmark_batch` (the P4 surface: a
whole benchmark in one call, the CLI's ``bench-adelaide``). The
reference vmaps its fit over the pair axis and shards that axis over a
device mesh. The port's fit is eager Python around hand-written kernels,
so the batch is a loop over pairs: pair i's result is the single fit of
pair i, bit for bit. The homography fit holds no host sync, so the fits
of a batch queue on the card back to back. The mesh axes ('pair', 'hyp',
'pt') are not ported yet: every function here raises
NotImplementedError for a mesh.
"""

from __future__ import annotations

import numpy as np
import torch

from multih_tpu_torch.config import MultiHConfig
from multih_tpu_torch.models import mixed, pipeline


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError("not ported yet: a device mesh")


def _stack(results):
    """A list of (nested) NamedTuples of tensors -> one NamedTuple of the
    stacked tensors, a leading batch axis on every leaf."""
    first = results[0]
    if isinstance(first, tuple):
        return type(first)(*(_stack(list(leaves))
                             for leaves in zip(*results)))
    return torch.stack(results)


def _loop(fit_one, device):
    """f(x1 (B, N, 2), x2, valid (B, N), keys, *per_pair) -> the stacked
    results of fit_one(x1[i], x2[i], valid[i], keys[i], *(a[i] for a in
    per_pair)) over the pairs, in order. Arrays go to `device` (the card
    by default) in one copy each; tensors keep their device."""

    def f(x1, x2, valid, keys, *per_pair):
        x1, x2, valid = pipeline._inputs(x1, x2, valid, device)
        if len(keys) != x1.shape[0]:
            raise ValueError(f"{len(keys)} keys for {x1.shape[0]} pairs")
        return _stack([fit_one(x1[i], x2[i], valid[i], keys[i],
                               *(a[i] for a in per_pair))
                       for i in range(x1.shape[0])])

    return f


def batched_fit(cfg: MultiHConfig, adaptive: bool = False,
                probe_tau: float = 8.0, mesh=None, device=None):
    """The fit over a batch of padded pairs (sharding.py:113).

    Returns f(x1 (B, N, 2), x2, valid (B, N), keys (B generators or draw
    sources), taus (B,)) -> FitResult with a leading batch axis. `taus`
    are per-pair inlier thresholds in px (numbers or a tensor). Tensors
    keep their device; arrays go to `device`, the card by default, in
    one copy each. With `adaptive`, each pair calibrates its own
    threshold (`pipeline.fit_adaptive`, one key for both passes) and
    `taus` is ignored, as in the reference."""
    _no_mesh(mesh)

    def fit_one(x1, x2, valid, key, tau):
        if adaptive:
            return pipeline.fit_adaptive(x1, x2, valid, key, cfg,
                                         probe_tau)[0]
        return pipeline.fit(x1, x2, valid, key, cfg, tau=tau)

    loop = _loop(fit_one, device)

    def f(x1, x2, valid, keys, taus):
        return loop(x1, x2, valid, keys,
                    [None] * len(keys) if adaptive else taus)

    return f


def batched_fit_mixed(cfg_h: MultiHConfig, cfg_f: MultiHConfig,
                      adaptive: bool = False, mesh=None, device=None,
                      **kw):
    """The mixed (plane + motion) fit over a batch of padded pairs
    (sharding.py:182). Returns f(x1 (B, N, 2), x2, valid (B, N), keys
    (B generators or draw sources)) -> MixedFitResult with a leading
    batch axis. With `adaptive`, each pair calibrates its per-class
    thresholds (`mixed.fit_mixed_adaptive`). Extra keyword arguments go
    to the mixed fit (f_bias, the polish's counts, probe taus, ...).

    Explicit `tau_h` / `tau_f` with `adaptive` raise a ValueError here,
    before any fit: the reference would fail only inside the batched
    call, with a TypeError of a duplicated keyword."""
    _no_mesh(mesh)
    if adaptive and ("tau_h" in kw or "tau_f" in kw):
        raise ValueError("explicit tau_h / tau_f conflict with adaptive=True,"
                         " which calibrates each pair's thresholds itself")

    def fit_one(x1, x2, valid, key):
        if adaptive:
            return mixed.fit_mixed_adaptive(x1, x2, valid, key, cfg_h,
                                            cfg_f, **kw)[0]
        return mixed.fit_mixed(x1, x2, valid, key, cfg_h, cfg_f, **kw)

    return _loop(fit_one, device)


def prepare_benchmark_batch(pairs, cfg: MultiHConfig, taus=None,
                            device=None, mesh=None):
    """Pad a list of CorrespondenceSets to cfg.max_points and upload the
    stacked batch once (sharding.py:321): ((x1 (B, N, 2), x2, valid
    (B, N), taus (B,)), B), on `device` (the card by default). `taus`
    defaults to cfg.inlier_threshold for every pair."""
    _no_mesh(mesh)
    b = len(pairs)
    x1 = np.zeros((b, cfg.max_points, 2), np.float32)
    x2 = np.zeros((b, cfg.max_points, 2), np.float32)
    valid = np.zeros((b, cfg.max_points), np.float32)
    for i, cs in enumerate(pairs):
        x1[i], x2[i], valid[i] = pipeline.pad_points(cs.x1, cs.x2, None,
                                                     cfg.max_points)
    t = np.full((b,), cfg.inlier_threshold, np.float32)
    if taus is not None:
        t[:len(taus)] = np.asarray(taus, np.float32)
    x1, x2, valid = pipeline._inputs(x1, x2, valid, device)
    return (x1, x2, valid, torch.from_numpy(t).to(x1.device)), b


def run_benchmark_batch(pairs, cfg: MultiHConfig, seed: int = 0, taus=None,
                        adaptive: bool = False, prepared=None, device=None,
                        mesh=None):
    """Fit a list of CorrespondenceSets as one batch (sharding.py:356):
    a FitResult of numpy arrays with a leading batch axis, cut to
    [:len(pairs)], in input order.

    Pair i draws from a generator seeded seed + i on the batch's device
    (on the CPU torch.Generator().manual_seed(seed + i)), the counterpart
    of the reference's jax.random.key(seed + i); the fit takes a
    generator on its points' device. `taus`: per-pair thresholds in px
    (cfg.inlier_threshold by default), ignored with `adaptive`. Pass
    `prepared` (from prepare_benchmark_batch) to reuse the uploaded
    batch across calls."""
    _no_mesh(mesh)
    if prepared is None:
        prepared = prepare_benchmark_batch(pairs, cfg, taus, device)
    (x1, x2, valid, t), b = prepared
    keys = [torch.Generator(device=x1.device).manual_seed(seed + i)
            for i in range(x1.shape[0])]
    res = batched_fit(cfg, adaptive=adaptive)(x1, x2, valid, keys, t)
    return type(res)(*(a[:b].cpu().numpy() for a in res))
