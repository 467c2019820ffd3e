"""The port's CUDA kernels against their plain versions, and the port's
fit against the golden labelings of the whole homography suite.

This file imports no JAX, so it runs on the GPU host too, which has
none. tests/conftest.py imports JAX, so there it runs without it:

    python -m pytest tests/test_torch_kernels.py --noconftest -q

The `cuda`-marked tests skip without a GPU. The golden-suite tests fit
on the GPU when there is one (the kernel path) and on the CPU otherwise
(the plain path).
"""

import os

import numpy as np
import pytest
import torch

import multih_tpu_torch as mt
from multih_tpu_torch.ops import geometry as tgeo
from multih_tpu_torch.ops.kernels import dlt_kernel as tdlt
from multih_tpu_torch.models import labeling as tlab
from multih_tpu_torch.models import pipeline as tpipe
from multih_tpu_torch.ops.kernels import eig_kernel as teig
from multih_tpu_torch.ops.kernels import gather_kernel as tgather
from multih_tpu_torch.ops.kernels import mrf_kernel as tmrf
from multih_tpu_torch.ops.kernels import residual_kernel as tres
from multih_tpu_torch.ops import sampling as tsamp
from multih_tpu_torch.ops.sampling import TorchDraws
from multih_tpu_torch.utils import data as tdata
from multih_tpu_torch.utils import evaluation

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")


@pytest.fixture
def rng():
    return np.random.default_rng(42)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def random_hs(rng, s):
    """Near-identity pixel-frame homographies (test_pallas_kernels.py)."""
    H = np.eye(3)[None] + rng.normal(0, 0.1, (s, 3, 3))
    H[:, 2, :2] = rng.normal(0, 3e-4, (s, 2))
    H /= np.linalg.norm(H, axis=(1, 2), keepdims=True)
    return H.astype(np.float32)


def count_problem(rng, s, n):
    Hs = random_hs(rng, s)
    x1 = rng.uniform(0, 640, (n, 2)).astype(np.float32)
    x2 = rng.uniform(0, 640, (n, 2)).astype(np.float32)
    valid = (rng.uniform(size=n) > 0.2).astype(np.float32)
    return Hs, x1, x2, valid


def quads(rng, s):
    p1 = rng.uniform(0, 640, (s, 4, 2)).astype(np.float32)
    p2 = (p1 * 1.1 + rng.normal(0, 2.0, (s, 4, 2))).astype(np.float32)
    # a repeated-point degenerate quad (2-D nullspace): excluded from
    # parity exactly as the pipeline excludes it via quad_degenerate
    p1[5, 1] = p1[5, 0]
    p2[5, 1] = p2[5, 0]
    return p1, p2


def pack_quads(p1, p2):
    return np.concatenate([p1.reshape(-1, 8).T, p2.reshape(-1, 8).T])


def normal_matrices(rng, c):
    """(C, 9, 9) DLT normal matrices of noisy 12-point samples."""
    x1 = rng.uniform(-1, 1, (c, 12, 2))
    H = np.eye(3) + rng.normal(0, 0.1, (c, 3, 3))
    pr = np.concatenate([x1, np.ones((c, 12, 1))], 2) @ H.transpose(0, 2, 1)
    x2 = pr[..., :2] / pr[..., 2:3] + rng.normal(0, 0.01, (c, 12, 2))
    return tgeo.dlt_normal_matrix(t(x1.astype(np.float32)),
                                  t(x2.astype(np.float32))).numpy()


def windowed_band(rng, n, block, device, invalid=30):
    """Morton-sorted random points on `device` with their windowed k-NN
    graph and its far-free band, as the fit builds them."""
    x1 = t(rng.uniform(0, 100, (n, 2)).astype(np.float32)).to(device)
    x2 = x1 + t(rng.normal(0, 2.0, (n, 2)).astype(np.float32)).to(device)
    valid = torch.ones(n, device=device)
    valid[n - invalid:] = 0.0
    perm = tpipe.morton_order(x1, valid)
    x1, x2, valid = x1[perm], x2[perm], valid[perm]
    nbr_idx, nbr_w = tlab.knn_graph_windowed(x1, valid, 6, block)
    adj = tlab.build_banded_adjacency(nbr_idx, nbr_w, block, far_capacity=0)
    return x1, x2, valid, nbr_idx, adj


def mrf_inputs(rng, n, block, l, device):
    """(dct, q0, base, band) of a mean-field / ICM call, sw = 0.1."""
    _, _, valid, _, adj = windowed_band(rng, n, block, device)
    dct = t(rng.uniform(0, 2.0, (l, n)).astype(np.float32)).to(device) \
        * valid[None, :]
    q0 = torch.softmax(-dct / 2.0, dim=0).contiguous()
    base = (dct + 0.1 * adj.deg.T).contiguous()
    return dct, q0, base, adj.band


def sign_aligned_err(ref, got):
    sign = np.sign(np.sum(ref * got, axis=1, keepdims=True))
    return np.abs(ref - got * sign).max()


# ---------------------------------------------------------------------------
# the CUDA kernels against their plain versions
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
class TestCudaKernels:
    @pytest.mark.parametrize("kind", ["symmetric", "transfer", "sampson"])
    def test_count_kernel(self, rng, cuda_device, kind):
        Hs, x1, x2, valid = count_problem(rng, 2051, 1536)
        args = [t(a).to(cuda_device) for a in (Hs, x1, x2, valid)]
        thr = torch.tensor(900.0, device=cuda_device)
        before = tres.inlier_counts.launches
        got = tres.inlier_counts_padded(*args, thr, kind=kind)
        assert tres.inlier_counts.launches == before + 1
        ref = tres.inlier_counts_reference(*args, thr, kind)
        d = (got - ref).abs()
        assert float(ref.max()) > 0
        assert float(d.max()) <= 2.0 and float(d.mean()) < 0.5

    def test_dlt_kernel(self, rng, cuda_device):
        """5e-4 on the non-degenerate quads whose float32 solve is well
        conditioned (plain float32 within 1e-4 of float64); on the rest
        no float32 solver holds 5e-4 (see chip_smoke.dlt_parity)."""
        p1, p2 = quads(rng, 1301)
        packed = t(pack_quads(p1, p2)).to(cuda_device)
        got = tdlt.homography_4pt_packed(packed)
        ref = tdlt.homography_4pt_packed_reference(packed)
        ref64 = tdlt.homography_4pt_packed_reference(packed.double())
        degen = (tgeo.quad_degenerate_t(t(p1[:, :, 0].T), t(p1[:, :, 1].T),
                                        1e-4)
                 | tgeo.quad_degenerate_t(t(p2[:, :, 0].T), t(p2[:, :, 1].T),
                                          1e-4)).to(cuda_device)
        well = ~degen & ((ref.double() - ref64).abs().amax((1, 2)) < 1e-4)
        err = (got - ref).abs().amax((1, 2))[well]
        assert bool(torch.isfinite(got).all()) and float(err.max()) < 5e-4

    def test_eig_kernel(self, rng, cuda_device):
        atas = t(normal_matrices(rng, 256)).to(cuda_device)
        got = teig.smallest_eigvec_9x9_batch(atas).cpu().numpy()
        ref = teig.smallest_eigvec_9x9_batch_reference(atas).cpu().numpy()
        assert sign_aligned_err(ref, got) < 1e-4

    @pytest.mark.parametrize("n,block,l,sweeps", [
        (512, 256, 17, 6), (2048, 128, 17, 4), (1024, 64, 9, 1),
    ])
    def test_mean_field_kernel(self, rng, cuda_device, n, block, l, sweeps):
        """q within 1e-5 max-abs of the plain version (the band product
        sums in another order)."""
        _, q0, base, band = mrf_inputs(rng, n, block, l, cuda_device)
        inv_t = t((1.0 / np.geomspace(2.0, 0.25, sweeps)).astype(
            np.float32)).to(cuda_device)
        before = tmrf.mean_field_fused.launches
        got = tmrf.mean_field_fused(q0, base, band, inv_t, 0.1)
        assert tmrf.mean_field_fused.launches == before + 1
        ref = tmrf.mean_field_fused_reference(q0, base, band, inv_t, 0.1)
        assert float((got - ref).abs().max()) <= 1e-5

    @pytest.mark.parametrize("n,block,l,iterations", [
        (512, 256, 17, 2), (2048, 128, 17, 1), (1024, 64, 9, 3),
    ])
    def test_icm_kernel(self, rng, cuda_device, n, block, l, iterations):
        """Labels equal the plain version's exactly."""
        dct, q0, base, band = mrf_inputs(rng, n, block, l, cuda_device)
        starts = torch.stack([torch.argmin(dct, 0), torch.argmax(q0, 0),
                              t(rng.integers(0, l, n)).to(cuda_device)]
                             ).to(torch.int32).contiguous()
        got = tmrf.icm_fused(starts, base, band, iterations, 0.1)
        ref = tmrf.icm_fused_reference(starts, base, band, iterations, 0.1)
        assert torch.equal(got, ref)
        assert bool((got != starts).any())

    @pytest.mark.parametrize("mode", ["index", "rank"])
    def test_window_gather_kernel(self, rng, cuda_device, mode):
        """Bit-exact, out-of-range picks and exhausted windows included."""
        x1, x2, valid, nbr_idx, _ = windowed_band(rng, 2048, 128,
                                                  cuda_device)
        avail = valid.clone()
        avail[:600] = 0.0
        win = tsamp.window_source(x1, x2, avail, nbr_idx, 128)
        # windowed_quadruples gathers by index from the first 8 channels
        win = (win[:, :, :8] if mode == "index" else win).contiguous()
        nb, rows, _ = win.shape
        sel = t(rng.integers(-2, rows + 3, (nb, 777)).astype(np.int32)).to(
            cuda_device)
        got = tgather.window_gather(win, sel, mode)
        ref = tgather.window_gather_reference(win, sel, mode)
        assert torch.equal(got, ref)
        zero = (ref == 0).all(1)
        assert bool(zero.any()) and not bool(zero.all())

    def test_wrappers_reject_bad_input(self, cuda_device):
        with pytest.raises(ValueError):
            tdlt.homography_4pt_packed(
                torch.zeros((16, 8), dtype=torch.float64, device=cuda_device))
        with pytest.raises(ValueError):
            teig.smallest_eigvec_9x9_batch(
                torch.zeros((4, 9, 9), dtype=torch.float64,
                            device=cuda_device))
        with pytest.raises(ValueError):
            tres.inlier_counts(
                torch.zeros((8, 9), device=cuda_device),
                torch.zeros((5, 64), device=cuda_device),
                torch.tensor(9.0, device=cuda_device))
        band = torch.zeros((2, 64, 192), device=cuda_device)
        base = torch.zeros((3, 128), device=cuda_device)
        with pytest.raises(ValueError):  # band does not fit N
            tmrf.mean_field_fused(base, base, band[:1], torch.ones(
                2, device=cuda_device), 0.1)
        with pytest.raises(ValueError):  # labels must be int32
            tmrf.icm_fused(torch.zeros((2, 128), dtype=torch.int64,
                                       device=cuda_device), base, band, 1,
                           0.1)
        with pytest.raises(ValueError):
            tgather.window_gather(torch.zeros((2, 192, 8),
                                              device=cuda_device),
                                  torch.zeros((2, 5), dtype=torch.int32,
                                              device=cuda_device), "row")


# ---------------------------------------------------------------------------
# the golden contract of tests/test_golden_parity.py, for the port
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def golden_suite():
    """Every suite scene fitted by the port at the default config, the
    config the goldens were made at, with the golden tau, 3 keys (6
    below 200 points): {name: (mean
    misclassification, golden's, agreement with the golden labels on key
    0, n_points)}. On the GPU when there is one.

    Key k is a CPU torch.Generator seeded k on every device, as the JAX
    test's jax.random.key(k) draws the same samples on every platform: a
    3-key mean is a noisy estimate (the JAX reference's own 12-key mean
    on outlier50_b is 0.74 pp above the golden, against a 0.83 pp bound),
    so the GPU run holds the kernels to the contract on the CPU run's
    samples, not on another draw of the noise."""
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    out = {}
    for row in tdata.SUITE:
        cs = tdata.suite_scene(row[0])
        npad = 1 << max(9, (cs.n_points - 1).bit_length())
        cfg = mt.MultiHConfig(max_points=npad)
        f = mt.make_fit_tau(cfg)
        g = np.load(os.path.join(GOLDENS, f"{cs.name}.npz"))
        args = [t(a).to(dev) for a in mt.pad_points(cs.x1, cs.x2, None,
                                                    npad)]
        errs, agree = [], None
        for k in range(3 if cs.n_points >= 200 else 6):
            res = f(*args, TorchDraws(torch.Generator().manual_seed(k)),
                    float(g["inlier_threshold"]))
            lab = res.labels.cpu().numpy()[: cs.n_points]
            errs.append(evaluation.misclassification_error(
                lab, cs.gt_labels, cfg.max_labels))
            if agree is None:
                agree = 100.0 - evaluation.misclassification_error(
                    lab, g["labels"], cfg.max_labels,
                    gt_outlier=int(g["outlier_label"]))
        out[cs.name] = (float(np.mean(errs)), float(g["misclassification"]),
                        agree, cs.n_points)
    return out


@pytest.mark.parametrize("name", [row[0] for row in tdata.SUITE])
def test_golden_scene(golden_suite, name):
    """Per scene: |mean misclassification - golden| <= 0.5 pp plus two
    points of granularity slack (capped at 1 pp), and >= 97% per-point
    agreement with the golden labeling (test_golden_parity.py:85-98)."""
    err, golden, agree, n = golden_suite[name]
    slack = min(2.0 * 100.0 / n, 1.0)
    assert abs(err - golden) <= 0.5 + slack, (err, golden)
    assert agree >= 97.0, agree


def test_golden_suite_means(golden_suite):
    """Suite level: |mean delta| <= 0.25 pp, mean agreement >= 99%."""
    deltas = [e - g for e, g, _, _ in golden_suite.values()]
    agrees = [a for _, _, a, _ in golden_suite.values()]
    assert abs(float(np.mean(deltas))) <= 0.25, deltas
    assert float(np.mean(agrees)) >= 99.0, agrees
