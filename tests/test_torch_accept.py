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

torch.set_num_threads(1)


def _adj(n_far: int) -> labeling.BandedAdjacency:
    """A 2-block band of 4 points a block, with n_far far edges."""
    return labeling.BandedAdjacency(
        band=torch.zeros((2, 4, 12)),
        far_out=torch.zeros((n_far,), dtype=torch.int64),
        far_in=torch.zeros((n_far,), dtype=torch.int64),
        far_w=torch.zeros((n_far,)), deg=torch.zeros((8, 1)),
        n_dropped=torch.zeros((), dtype=torch.int32))


def test_f_accept_route_choice():
    """The kernel route runs exactly where the fallback's relabel runs
    K5: CPU tensors, a 'pt' shard, the exact graph's far edges, the
    gather path (no band) and use_pallas=False keep the plain loop."""
    cfg = mt.MultiHConfig(model="fundamental", residual="sampson")
    card, cpu = torch.device("cuda"), torch.device("cpu")
    ok = pipeline._f_accept_kernel_ok
    assert ok(cfg, card, _adj(0), None)
    assert not ok(cfg, cpu, _adj(0), None)
    assert not ok(cfg, card, _adj(0), object())
    assert not ok(cfg, card, _adj(3), None)
    assert not ok(cfg, card, None, None)
    assert not ok(dataclasses.replace(cfg, use_pallas=False), card, _adj(0),
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
    float32 rounding, Hs and q bit for bit. Returns the per-call counts
    (steps, steps taken, steps taken whose model was unchanged)."""
    accept = pipeline._f_accept
    counts = []

    def routes(Hs_c, q_c, r_c, lab_c, e_c, Hs_prop, r_prop, ok_prop,
               label_energy, relabel_energy, residuals, fallback=None):
        assert fallback is not None, "the kernel route did not engage"
        args = (Hs_c, q_c, r_c, lab_c, e_c, Hs_prop, r_prop, ok_prop,
                label_energy, relabel_energy, residuals)
        ran = []

        def recorded(*a):
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
        Hs_p, e_p, took_p = pipeline._f_fallback_plain(
            Hs_c, r_c, lab_c, e_c, Hs_prop, ok_prop, relabel_energy,
            residuals)
        Hs_k, e_k, took_k = ran[0]
        assert torch.equal(Hs_k, Hs_p)
        assert torch.equal(took_k, took_p), (took_k, took_p)
        off = (e_k != e_p).nonzero().flatten().tolist()
        assert not off, [(i, float(e_k[i]), float(e_p[i])) for i in off]
        for out in (plain, host):
            assert torch.equal(got[0], out[0]) and torch.equal(got[1], out[1])
        counts.append((k, int(took_k.sum()), int((took_k & ~ok_prop).sum())))
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
