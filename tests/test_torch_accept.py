"""The F fit's accept fallback in kernels (ops/kernels/accept_kernel.py):
which route a fit takes, and on the card the kernel route against the
plain loop, call by call.

This file imports no JAX, so it runs on the GPU host too:

    python -m pytest tests/test_torch_accept.py --noconftest -q

The `cuda`-marked tests skip without a GPU.
"""

import dataclasses

import numpy as np
import pytest
import torch

import multih_tpu_torch as mt
from multih_tpu_torch.models import labeling, pipeline
from multih_tpu_torch.ops.kernels import accept_kernel, mrf_kernel
from multih_tpu_torch.ops.sampling import TorchDraws
from multih_tpu_torch.utils import data as tdata

import card_checks as cc

torch.set_num_threads(1)


def _adj(n_far: int, listed: bool = False) -> labeling.BandedAdjacency:
    """A 2-block band of 4 points a block, with n_far far edges and, where
    `listed`, the neighbour list the fit builds where its kernels are on
    (plain version: no card is touched)."""
    band = torch.zeros((2, 4, 12))
    return labeling.BandedAdjacency(
        band=band,
        far_out=torch.zeros((n_far,), dtype=torch.int64),
        far_in=torch.zeros((n_far,), dtype=torch.int64),
        far_w=torch.zeros((n_far,)), deg=torch.zeros((8, 1)),
        n_dropped=torch.zeros((), dtype=torch.int32),
        nbr=mrf_kernel.band_list_reference(band) if listed else None)


def test_f_accept_route_choice():
    """The kernel route runs exactly where the fallback's relabel runs
    K5, where the adjacency carries its neighbour list: a CPU fit and
    use_pallas=False (no list built), a 'pt' shard, the exact graph's
    far edges (no list) and the gather path (no band) keep the plain
    loop."""
    cfg = mt.MultiHConfig(model="fundamental", residual="sampson")
    dev = torch.device("cpu")
    ok = pipeline._f_accept_kernel_ok

    def adj_of(cfg, dev, n_far=0):
        """The band as `fit` builds it: its list where the kernels are
        on (far-free bands only)."""
        return _adj(n_far, listed=n_far == 0
                    and pipeline._kernels_enabled(cfg, dev))

    card = torch.device("cuda")  # a device name only
    assert ok(adj_of(cfg, card), None)
    assert not ok(adj_of(cfg, dev), None)
    assert not ok(adj_of(cfg, card), object())
    assert not ok(adj_of(cfg, card, 3), None)
    assert not ok(None, None)
    assert not ok(adj_of(dataclasses.replace(cfg, use_pallas=False), card),
                  None)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _fit_holding_routes(cfg, cs, key, dev, monkeypatch):
    """One F fit on the card whose every accept runs the kernel route,
    the plain device loop and the host route on the same inputs, held
    equal: the same steps taken, each step's energy equal after the
    float32 rounding, Hs and q bit for bit; on the first accept, 3 K device
    ops a kernel-route call (a front, K5 and a back a step). Returns
    the per-call counts (steps, steps taken, steps taken whose model was
    unchanged)."""
    accept = pipeline._f_accept
    counts = []

    def routes(Hs_c, q_c, r_c, lab_c, e_c, Hs_prop, r_prop, ok_prop,
               label_energy, relabel_energy, residuals, fallback=None):
        assert fallback is not None, "the kernel route did not engage"
        args = (Hs_c, q_c, r_c, lab_c, e_c, Hs_prop, r_prop, ok_prop,
                label_energy, relabel_energy, residuals)
        ran, fb_args = [], []

        def recorded(*a):
            fb_args.append(tuple(x.clone() if torch.is_tensor(x) else x
                                 for x in a))
            ran.append(fallback(*a))
            return ran[-1]

        n_ends = accept_kernel.f_accept_fallback.launches
        n_k5 = mrf_kernel.icm_fused.launches
        got = accept(*args, fallback=recorded)
        k = Hs_c.shape[0]
        assert accept_kernel.f_accept_fallback.launches - n_ends == 2 * k
        assert mrf_kernel.icm_fused.launches - n_k5 > k  # + the joint move's
        plain = accept(*args)
        host = accept(*args, on_device=False)
        a = cc.accept_parity(fb_args[0], relabel_energy, residuals,
                             got=ran[0])
        for out in (plain, host):
            assert torch.equal(got[0], out[0]) and torch.equal(got[1], out[1])
        if not counts:
            assert cc.graph_ops(lambda: fallback(*fb_args[0])) == 3 * k
        counts.append((k, a["taken"], a["unchanged"]))
        return got

    monkeypatch.setattr(pipeline, "_f_accept", routes)
    x1, x2, valid, _ = mt.pad_points(cs.x1, cs.x2, cs.gt_labels,
                                     cfg.max_points)
    pts = [torch.from_numpy(a).to(dev) for a in (x1, x2, valid)]
    mt.make_fit(cfg, device=dev)(*pts, TorchDraws(
        torch.Generator().manual_seed(key)))
    assert counts
    return counts


def _motion_cfg(npad: int, residual: str = "sampson") -> mt.MultiHConfig:
    """The motion goldens' config (tests/test_torch_motion.py), which
    the f512 cell runs at N=512."""
    return mt.MultiHConfig(max_points=npad, n_hypotheses=2048,
                           model="fundamental", residual=residual)


@pytest.mark.cuda
@pytest.mark.parametrize("name", [row[0] for row in tdata.MOTION_SUITE])
def test_kernel_route_on_the_motion_goldens(cuda_device, monkeypatch, name):
    cs = tdata.motion_suite_scene(name)
    npad = 1 << max(9, (cs.n_points - 1).bit_length())
    _fit_holding_routes(_motion_cfg(npad), cs, 0, cuda_device, monkeypatch)


@pytest.mark.cuda
@pytest.mark.parametrize("seed,residual", [
    (11, "sampson"), (12, "sampson"), (13, "sampson"), (14, "sampson"),
    (15, "symmetric"), (16, "transfer")])
def test_kernel_route_on_f512_shaped_fits(cuda_device, monkeypatch, seed,
                                          residual):
    """400-512 points, 2-4 motions, 10-40% outliers, 0-0.5 px (the f512
    cell's scenes), every F residual kind; some step is taken, and some
    step of an unchanged model (ICM from the carried labels)."""
    rng = np.random.default_rng(seed)
    cs, _ = tdata.synthetic_motion_scene(
        int(rng.integers(400, 513)), int(rng.integers(2, 5)),
        float(rng.uniform(0.1, 0.4)), float(rng.uniform(0.0, 0.5)),
        seed=seed)
    counts = _fit_holding_routes(_motion_cfg(512, residual), cs, seed,
                                 cuda_device, monkeypatch)
    assert sum(c[1] for c in counts) > 0, counts
