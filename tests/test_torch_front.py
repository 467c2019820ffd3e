"""The fused-front PEARL route (K6) against the JAX package: the plain
version of the port's fused residual + data-cost + mean-field call
against `labeling.pearl_relax_fused(..., interpret=True)`, the fit's
fused branch on that plain version, and the route's gate against
`pipeline.fused_front_gate` (the CPU fit with `mrf_fused_front`, which
the gate keeps unfused, is in tests/test_torch_pipeline.py).

Same seeded numpy inputs (tests/test_mrf_kernel.py::_front_problem)
go through both packages. The port's CUDA kernel is held to this plain
version on the card (tests/test_torch_kernels.py, chip_smoke.py).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multih_tpu
from multih_tpu.models import labeling as jlab
from multih_tpu.models import pipeline as jpipe

import multih_tpu_torch as mt
from multih_tpu_torch.models import labeling as tlab
from multih_tpu_torch.models import pipeline as tpipe
from multih_tpu_torch.ops import geometry as tgeo
from multih_tpu_torch.ops.kernels import mrf_kernel as tmrf
from multih_tpu_torch.utils import data as tdata
from multih_tpu_torch.utils import evaluation
from test_mrf_kernel import _front_problem
from test_torch_kernels import t

torch.set_num_threads(1)

KW = dict(outlier_cost=1.0, spatial_weight=0.1, iterations=4,
          temp_start=2.0, temp_end=0.25)


def both_fronts(rng, kind):
    """(JAX (q, dct, r), port (q, dct, r), port inputs) on one
    _front_problem draw, thr = 3 px squared."""
    x1, x2, valid, Hs, active, nbr_idx, nbr_w, adj = _front_problem(rng)
    l, n = Hs.shape[0] + 1, x1.shape[0]
    thr = 9.0
    q0 = np.full((l, n), 1.0 / l, np.float32)
    jout = jlab.pearl_relax_fused(
        x1, x2, valid, Hs, active, jnp.asarray(thr, jnp.float32),
        q_init=jnp.asarray(q0), adj=adj, kind=kind, interpret=True, **KW)
    tadj = tlab.build_banded_adjacency(t(np.array(nbr_idx)),
                                       t(np.array(nbr_w)), 128,
                                       far_capacity=0)
    ins = dict(x1=t(np.array(x1)), x2=t(np.array(x2)),
               valid=t(np.array(valid)), Hs=t(np.array(Hs)),
               active=t(np.array(active)), thr=torch.tensor(thr))
    tout = tlab.pearl_relax_fused(
        ins["x1"], ins["x2"], ins["valid"], ins["Hs"], ins["active"],
        ins["thr"], q_init=t(q0), adj=tadj, kind=kind, **KW)
    return [np.array(a) for a in jout], [a.numpy() for a in tout], ins


@pytest.mark.parametrize("kind", ["symmetric", "transfer"])
def test_front_reference_matches_pallas(rng, kind):
    """r to rtol 1e-3 / atol 1e-4 and min(r/thr, 8) to atol 1e-4 (the
    elementwise Pallas residual against the port's matmul one); dct
    equal to data_costs_t of its own r, and to the Pallas dct within
    that cost tolerance (outlier_cost 1; rtol 2e-6 on the 1e6 rows of
    the inactive plane); q within 1e-5.

    Against float64: the residuals evaluated in float64 from the same
    float32 inputs. The port's r (relative error, where r64 <= 1e6 px^2:
    past it w nears zero and float32 cancellation sets the digits) is
    held to 8x, and its min(r/thr, 8) (everywhere) to 4x, the Pallas
    run's own distance from float64. Both are float32 floors: over 15
    _front_problem draws (seeds 0-13 and 42) the ratio reached 5.2 on r
    and 2.6 on the cost (1.5 and 1.7 on this draw), the matmul's rounding
    against the elementwise one's."""
    (jq, jd, jr), (tq, td, tr), ins = both_fronts(rng, kind)
    assert tr.shape == jr.shape and tq.shape == td.shape == jq.shape
    np.testing.assert_allclose(tr, jr, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(np.minimum(tr / 9.0, 8.0),
                               np.minimum(jr / 9.0, 8.0), atol=1e-4)
    r64 = tgeo.residual_matrix(ins["Hs"].double(), ins["x1"].double(),
                               ins["x2"].double(), kind).numpy()
    near = r64 <= 1e6

    def r_dist(r):
        return float((np.abs(r - r64)
                      / np.maximum(np.abs(r64), 1e-4))[near].max())

    def cost_dist(r):
        return float(np.abs(np.minimum(r.astype(np.float64) / 9.0, 8.0)
                            - np.minimum(r64 / 9.0, 8.0)).max())

    assert 0 < r_dist(tr) <= 8.0 * r_dist(jr), (r_dist(tr), r_dist(jr))
    assert 0 < cost_dist(tr) <= 4.0 * cost_dist(jr), (cost_dist(tr),
                                                      cost_dist(jr))
    own = tlab.data_costs_t(t(tr), ins["valid"], ins["thr"], 1.0,
                            ins["active"]).numpy()
    np.testing.assert_array_equal(td, own)
    np.testing.assert_allclose(td, jd, rtol=2e-6, atol=1e-4)
    assert np.abs(tq - jq).max() <= 1e-5
    # the inactive plane costs +1e6 on valid points, the padding nothing
    assert (td[1][ins["valid"].numpy() > 0] >= 1e6).all()
    assert (td[:, ins["valid"].numpy() == 0] == 0).all()


def test_front_without_sweeps_keeps_q0(rng):
    """iterations=0 still computes r and dct; q is q_init (the TPU
    kernel's load pass alone)."""
    x1, x2, valid, Hs, active, nbr_idx, nbr_w, _ = _front_problem(rng)
    tadj = tlab.build_banded_adjacency(t(np.array(nbr_idx)),
                                       t(np.array(nbr_w)), 128,
                                       far_capacity=0)
    l, n = Hs.shape[0] + 1, x1.shape[0]
    q0 = torch.softmax(t(rng.normal(size=(l, n)).astype(np.float32)), 0)
    q, dct, r = tmrf.mean_field_fused_front_reference(
        q0, t(np.array(x1)), t(np.array(x2)), t(np.array(valid)), tadj.deg,
        t(np.array(Hs)), t(np.array(active)), tadj.band,
        torch.zeros((0,)), 9.0, 0.1, 1.0)
    assert torch.equal(q, q0)
    assert dct.shape == (l, n) and r.shape == (l - 1, n)
    assert bool(torch.isfinite(dct).all()) and float(dct.max()) >= 1e6


def test_fused_route_fit_matches_unfused(monkeypatch):
    """The fit's fused-front branch (pipeline._pearl_iteration), run on
    the CPU with the kernel's plain version (the band carries no list)
    and the gate shown the band with its list, as on a card, ends where
    the unfused route does: the same planes and >= 99% of the labels
    (the two routes' sweeps round differently)."""
    gate = tpipe.fused_front_gate
    plain_front = tmrf.mean_field_fused_front_reference
    calls = []

    def front(*args, **kw):
        calls.append(1)
        return plain_front(*args, **kw)

    def listed(adj):
        return adj._replace(nbr=tmrf.band_list_reference(adj.band))

    cfg = mt.MultiHConfig(max_points=512, n_hypotheses=512,
                          mrf_fused_front=True)
    cs, _ = tdata.synthetic_scene(480, 3, 0.1, 0.5, seed=7)
    x1, x2, valid, gt = mt.pad_points(cs.x1, cs.x2, cs.gt_labels, 512)
    plain = mt.fit(x1, x2, valid, torch.Generator().manual_seed(0), cfg,
                   device="cpu")
    monkeypatch.setattr(tpipe, "fused_front_gate",
                        lambda c, adj, mesh: gate(c, listed(adj), mesh))
    monkeypatch.setattr(tmrf, "mean_field_fused_front_reference", front)
    fused = mt.fit(x1, x2, valid, torch.Generator().manual_seed(0), cfg,
                   device="cpu")
    assert len(calls) == cfg.pearl_iterations
    assert int(fused.active.sum()) == int(plain.active.sum()) == 3
    k = cfg.max_labels
    agree = 100.0 - evaluation.misclassification_error(
        fused.labels.numpy(), plain.labels.numpy(), k, gt_outlier=k)
    assert agree >= 99.0, agree
    assert evaluation.misclassification_error(fused.labels.numpy(), gt,
                                              k) < 5.0


def test_front_wrapper_rejects_cpu_tensors():
    z = torch.zeros((3, 256))
    pts = torch.zeros((256, 2))
    with pytest.raises(ValueError, match="CUDA"):
        tmrf.mean_field_fused_front(z, pts, pts, torch.ones(256),
                                    torch.zeros((256, 1)),
                                    torch.eye(3).expand(2, 3, 3),
                                    torch.ones(2),
                                    torch.zeros((2, 128, 384)),
                                    torch.ones(2), 9.0, 0.1, 1.0)
    assert tmrf.mean_field_fused_front.launches == 0


# ---------------------------------------------------------------------------
# the gate (tests/test_path_gates.py's truth table)
# ---------------------------------------------------------------------------

def _cfg(**kw):
    kw.setdefault("max_points", 512)
    kw.setdefault("n_hypotheses", 256)
    return mt.MultiHConfig(**kw)


@pytest.fixture(scope="module")
def windowed_adj():
    cs, _ = tdata.synthetic_scene(240, 2, 0.1, 0.5, seed=5)
    x1, _, valid = mt.pad_points(cs.x1, cs.x2, None, 256)
    x1, valid = t(x1), t(valid)
    order = tpipe.morton_order(x1, valid)
    idx, w = tlab.knn_graph_windowed(x1[order], valid[order], 6, 128)
    return tlab.build_banded_adjacency(idx, w, 128, far_capacity=0)


@pytest.fixture(scope="module")
def listed_adj(windowed_adj):
    """The band as `fit` builds it where its kernels are on: with its
    neighbour list (the list's plain version; no card is touched)."""
    return windowed_adj._replace(
        nbr=tmrf.band_list_reference(windowed_adj.band))


@pytest.fixture(scope="module")
def jax_windowed_adj(windowed_adj):
    """The same band as the JAX package's BandedAdjacency (its six
    fields; the port's seventh, the neighbour list, is the card's)."""
    return jlab.BandedAdjacency(*[jnp.asarray(a.numpy())
                                  for a in windowed_adj[:6]])


@pytest.mark.parametrize("kw,mesh,expect", [
    (dict(mrf_fused_front=True), False, True),
    (dict(), False, False),                              # off by default
    (dict(mrf_fused_front=True), True, False),           # a point mesh
    (dict(mrf_fused_front=True, model="fundamental", residual="sampson"),
     False, False),
    (dict(mrf_fused_front=True, residual="sampson"), False, False),
    (dict(mrf_fused_front=True, use_pallas=False), False, False),
], ids=["eligible", "off_by_default", "pt_mesh", "fundamental", "sampson",
        "kernels_off"])
def test_fused_front_gate(windowed_adj, listed_adj, jax_windowed_adj,
                          monkeypatch, kw, mesh, expect):
    cfg = _cfg(**kw)
    # the fit builds the list on a card where the kernels are on
    adj = listed_adj if cfg.use_pallas else windowed_adj
    assert tpipe.fused_front_gate(cfg, adj, mesh) is expect
    # the reference's gate on the same config and band, its TPU backend
    # emulated as tests/test_path_gates.py does
    monkeypatch.setattr(jpipe, "_pallas_enabled", lambda c: c.use_pallas)
    jcfg = multih_tpu.MultiHConfig(**dataclasses.asdict(cfg))
    assert bool(jpipe.fused_front_gate(jcfg, jax_windowed_adj, mesh)) \
        is expect


def test_fused_front_gate_needs_far_free_band_and_card(windowed_adj,
                                                       listed_adj):
    """The gate holds only where the band carries its neighbour list,
    which the fit builds on a card and on a far-free band only: the
    exact graph's band with far edges, the gather path (no band) and a
    CPU fit's band (no list) keep the unfused route."""
    cfg = _cfg(mrf_fused_front=True)
    assert tpipe.fused_front_gate(cfg, listed_adj, False)
    far = windowed_adj._replace(far_w=torch.ones(3),
                                far_out=torch.zeros(3, dtype=torch.int64),
                                far_in=torch.zeros(3, dtype=torch.int64))
    assert not tpipe.fused_front_gate(cfg, far, False)
    assert not tpipe.fused_front_gate(cfg, None, False)
    assert not tpipe.fused_front_gate(cfg, windowed_adj, False)
