"""The PyTorch port's ops and kernel plain versions vs the JAX package.

Same numpy inputs (seeded) through the JAX function and its port; the
tolerances are the JAX kernels' own against their jnp paths unless a
comparison is exact by construction. The CUDA kernels themselves are
held against these plain versions in test_torch_kernels.py.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multih_tpu
from benchmarks import suite
from multih_tpu.models import labeling as jlab
from multih_tpu.models import selection as jsel
from multih_tpu.ops import geometry as jgeo
from multih_tpu.ops import sampling as jsamp
from multih_tpu.ops.kernels import dlt_kernel as jdlt
from multih_tpu.ops.kernels import eig_kernel as jeig
from multih_tpu.ops.kernels import residual_kernel as jres
from multih_tpu.utils import data as jdata

import multih_tpu_torch as mt
from multih_tpu_torch.models import labeling as tlab
from multih_tpu_torch.models import selection as tsel
from multih_tpu_torch.ops import geometry as tgeo
from multih_tpu_torch.ops import sampling as tsamp
from multih_tpu_torch.ops.kernels import dlt_kernel as tdlt
from multih_tpu_torch.ops.kernels import eig_kernel as teig
from multih_tpu_torch.ops.kernels import residual_kernel as tres
from multih_tpu_torch.utils import data as tdata
from test_torch_kernels import (count_problem, normal_matrices, pack_quads,
                                quads, random_hs, sign_aligned_err, t)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _raw_ranks(keys, n_valid, m):
    """sampling._draw_without_replacement's randint draws, before the
    collision fix: (S, m) for S sample keys."""
    def one(k):
        ks = jax.random.split(k, m)
        return jnp.stack([
            jax.random.randint(ks[j], (), 0, jnp.maximum(n_valid - j, 1))
            for j in range(m)
        ])
    return jax.vmap(one)(keys)


_raw_ranks = jax.jit(_raw_ranks, static_argnums=2)


class KeyDraws:
    """Draw source that replays JAX's threefry draws (sampling.py:35,
    :79, :117). `keys(stream)` gives the JAX keys of the uniform and the
    localized sampling call; here `stream` is that key itself."""

    def keys(self, stream):
        return stream, stream

    def ranks(self, stream, n_samples, n_valid, m):
        k_u, _ = self.keys(stream)
        raw = _raw_ranks(jax.random.split(k_u, n_samples),
                         jnp.int32(int(n_valid)), m)
        return t(np.array(raw)).long()

    def seed_ranks(self, stream, n_samples, n_valid):
        k_seed, _ = jax.random.split(self.keys(stream)[1])
        return t(np.array(jax.random.randint(
            k_seed, (n_samples,), 0, max(int(n_valid), 1)))).long()

    def gumbel(self, stream, shape, device):
        _, k_nbr = jax.random.split(self.keys(stream)[1])
        return t(np.array(jax.random.gumbel(k_nbr, shape)))


# ---------------------------------------------------------------------------
# plumbing
# ---------------------------------------------------------------------------

class TestPlumbing:
    def test_config_fields_and_defaults_match(self):
        jf = [(f.name, f.default) for f in
              dataclasses.fields(multih_tpu.MultiHConfig)]
        tf = [(f.name, f.default) for f in dataclasses.fields(mt.MultiHConfig)]
        assert jf == tf

    def test_config_carries_across(self):
        jcfg = multih_tpu.MultiHConfig(max_points=1024, knn_window=False,
                                       n_candidates=64, max_labels=8)
        tcfg = mt.MultiHConfig.from_dict(dataclasses.asdict(jcfg))
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
        assert tcfg.minimal_points == jcfg.minimal_points
        assert tcfg.lo_shrink_eff == jcfg.lo_shrink_eff

    @pytest.mark.parametrize("row", suite.SUITE, ids=lambda r: r[0])
    def test_synthetic_scene_byte_equal(self, row):
        name, n, planes, outl, noise, seed, kw = row
        a, ha = jdata.synthetic_scene(n, planes, outl, noise, seed=seed, **kw)
        b, hb = tdata.synthetic_scene(n, planes, outl, noise, seed=seed, **kw)
        for x, y in ((a.x1, b.x1), (a.x2, b.x2), (a.gt_labels, b.gt_labels),
                     (ha, hb)):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes()

    def test_port_suite_rows_are_the_suite_rows(self):
        rows = {r[0]: r for r in suite.SUITE}
        for row in tdata.SUITE:
            assert rows[row[0]] == row

    def test_import_leaves_no_jax(self):
        code = ("import sys, multih_tpu_torch, multih_tpu_torch.ops.kernels."
                "residual_kernel, multih_tpu_torch.ops.kernels.dlt_kernel, "
                "multih_tpu_torch.ops.kernels.eig_kernel, "
                "multih_tpu_torch.ops.kernels.mrf_kernel, "
                "multih_tpu_torch.ops.kernels.gather_kernel, "
                "multih_tpu_torch.ops.sampling, "
                "multih_tpu_torch.ops.epipolar, "
                "multih_tpu_torch.models.mixed, "
                "multih_tpu_torch.utils.features, "
                "multih_tpu_torch.utils.streaming, "
                "multih_tpu_torch.parallel.sharding, "
                "multih_tpu_torch.cli; "
                "print(sorted(m for m in sys.modules "
                "if m == 'jax' or m.startswith(('jax.', 'multih_tpu.'))))")
        out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                             capture_output=True, text=True, check=True)
        assert out.stdout.strip() == "[]", out.stdout

    def test_pad_points_matches(self, rng):
        x1 = rng.uniform(0, 640, (37, 2))
        x2 = rng.uniform(0, 640, (37, 2))
        gt = rng.integers(0, 3, 37)
        for a, b in zip(multih_tpu.pad_points(x1, x2, gt, 64),
                        mt.pad_points(x1, x2, gt, 64)):
            np.testing.assert_array_equal(np.asarray(a), b)


# ---------------------------------------------------------------------------
# kernel plain versions vs the JAX kernels
# ---------------------------------------------------------------------------

class TestKernelPlainVersions:
    @pytest.mark.parametrize("kind", ["symmetric", "transfer", "sampson"])
    def test_counts_match_pallas_kernel(self, rng, kind):
        """K1 plain version vs the Pallas count kernel in interpret mode,
        exact division on both sides: counts within +-2 boundary ties,
        mean < 0.5 (test_pallas_kernels.py:43-45)."""
        Hs, x1, x2, valid = count_problem(rng, 128, 1024)
        thr = 400.0 if kind == "sampson" else 900.0
        ref = np.asarray(jres.inlier_counts_padded(
            jnp.asarray(Hs), jnp.asarray(x1), jnp.asarray(x2),
            jnp.asarray(valid), jnp.float32(thr), hyp_tile=128,
            pt_tile=1024, interpret=True, approx_rcp=False, kind=kind,
        ))
        got = tres.inlier_counts_reference(
            t(Hs), t(x1), t(x2), t(valid), torch.tensor(thr), kind
        ).numpy()
        assert ref.max() > 0
        d = np.abs(got - ref)
        assert d.max() <= 2.0, d.max()
        assert d.mean() < 0.5, d.mean()

    def test_count_wrapper_on_cpu_is_plain(self, rng):
        Hs, x1, x2, valid = count_problem(rng, 70, 300)
        thr = torch.tensor(900.0)
        for kind in tres.KINDS:
            a = tres.inlier_counts_padded(t(Hs), t(x1), t(x2), t(valid), thr,
                                          kind=kind)
            b = tres.inlier_counts_reference(t(Hs), t(x1), t(x2), t(valid),
                                             thr, kind, chunk=16)
            assert torch.equal(a, b)

    def test_dlt_matches_pallas_kernel(self, rng):
        """K2 plain version vs the Pallas DLT kernel in interpret mode:
        max-abs < 5e-4 on non-degenerate quads
        (test_pallas_kernels.py:202-203)."""
        p1, p2 = quads(rng, 300)
        ref = np.asarray(jdlt.homography_4pt_pallas(
            jnp.asarray(p1), jnp.asarray(p2), interpret=True))
        got = tdlt.homography_4pt_packed_reference(
            t(pack_quads(p1, p2))).numpy()
        assert got.shape == (300, 3, 3) and np.isfinite(got).all()
        degen = np.asarray(jgeo.quad_degenerate_batch(jnp.asarray(p1), 1e-4)
                           | jgeo.quad_degenerate_batch(jnp.asarray(p2), 1e-4))
        assert degen[5]
        err = np.abs(ref - got).max(axis=(1, 2))
        assert err[~degen].max() < 5e-4, err[~degen].max()

    def test_eig_plain_matches_jnp_twin(self, rng):
        """K3 plain Jacobi vs smallest_eigvec_9x9_batch_jnp: the same
        rotations in the same order, sign-aligned within 1e-5."""
        atas = normal_matrices(rng, 64)
        ref = np.asarray(jeig.smallest_eigvec_9x9_batch_jnp(
            jnp.asarray(atas), 6))
        got = teig.smallest_eigvec_9x9_batch(t(atas)).numpy()
        assert sign_aligned_err(ref, got) < 1e-5

    def test_eig_plain_jacobi_vs_eigh(self, rng):
        """Plain Jacobi vs torch.linalg.eigh within 5e-3
        (test_pallas_kernels.py:245-246)."""
        atas = t(normal_matrices(rng, 64))
        ref = tgeo.smallest_eigvec_9x9(atas, 6, "eigh").numpy()
        got = teig.smallest_eigvec_9x9_batch_reference(atas).numpy()
        assert sign_aligned_err(ref, got) < 5e-3


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

class TestGeometry:
    @pytest.mark.parametrize("kind", ["symmetric", "transfer", "sampson"])
    def test_residual_matrix(self, rng, kind):
        Hs, x1, x2, _ = count_problem(rng, 32, 200)
        ref = np.asarray(jgeo.residual_matrix(
            jnp.asarray(Hs), jnp.asarray(x1), jnp.asarray(x2), kind))
        got = tgeo.residual_matrix(t(Hs), t(x1), t(x2), kind).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)

    @pytest.mark.parametrize("method", ["eigh", "jacobi"])
    def test_refit_batch(self, rng, method):
        """Moment refit of 3 weighted planes: within 1e-3 max-abs, not
        the 5e-4 first planned. The normal equations square the condition
        number, so each float32 package is itself 5e-4 to 8e-4 from the
        float64 refit of the same weights (asserted below: the floor),
        and the two float32 solves measured 5.02e-4 apart here."""
        cs, _ = tdata.synthetic_scene(200, 3, 0.1, 0.3, seed=5)
        w = np.stack([(cs.gt_labels == p) * rng.uniform(0.2, 1, 200)
                      for p in (1, 2, 3)]).astype(np.float32)
        jb = jgeo.prepare_refit(jnp.asarray(cs.x1), jnp.asarray(cs.x2))
        tb = tgeo.prepare_refit(t(cs.x1), t(cs.x2))
        np.testing.assert_allclose(tb.feats.numpy(), np.asarray(jb.feats),
                                   rtol=1e-5, atol=1e-5)
        ref = np.asarray(jgeo.homography_refit_batch(jnp.asarray(w), jb,
                                                     method, 6))
        got = tgeo.homography_refit_batch(t(w), tb, method, 6).numpy()
        b64 = tgeo.prepare_refit(t(cs.x1).double(), t(cs.x2).double())
        h64 = tgeo.homography_refit_batch(t(w).double(), b64, "eigh",
                                          6).numpy()
        floor = max(np.abs(ref - h64).max(), np.abs(got - h64).max())
        assert floor < 1e-3, floor
        assert np.abs(ref - got).max() < 1e-3

    def test_minimal_solve_and_degeneracy(self, rng):
        p1, p2 = quads(rng, 64)
        ref = np.asarray(jgeo.homography_4pt_batch_qr(jnp.asarray(p1),
                                                      jnp.asarray(p2)))
        got = tgeo.homography_4pt_batch_qr(t(p1), t(p2)).numpy()
        jd = np.asarray(jgeo.quad_degenerate_t(
            jnp.asarray(p1[:, :, 0].T), jnp.asarray(p1[:, :, 1].T), 1e-4))
        td = tgeo.quad_degenerate_t(t(p1[:, :, 0].T), t(p1[:, :, 1].T),
                                    1e-4).numpy()
        np.testing.assert_array_equal(jd, td)
        assert np.abs(ref - got).max(axis=(1, 2))[~jd].max() < 5e-4

    def test_inverse_iteration(self, rng):
        atas = normal_matrices(rng, 16)
        ref = np.stack([np.asarray(jgeo.smallest_eigvec_9x9(
            jnp.asarray(a), 8, "inverse_iteration")) for a in atas])
        got = tgeo.smallest_eigvec_9x9(t(atas), 8,
                                       "inverse_iteration").numpy()
        assert sign_aligned_err(ref, got) < 5e-3


# ---------------------------------------------------------------------------
# sampling: the reference's threefry draws injected
# ---------------------------------------------------------------------------

class TestSampling:
    def test_sample_indices_exact(self, rng):
        valid = rng.uniform(size=300) > 0.3
        key = jax.random.key(3)
        ref = np.asarray(jsamp.sample_indices(key, 257, jnp.asarray(valid)))
        got = tsamp.sample_indices(KeyDraws(), key, 257, t(valid)).numpy()
        np.testing.assert_array_equal(got, ref)
        assert (np.sort(got, 1)[:, 1:] != np.sort(got, 1)[:, :-1]).all()

    def test_localized_sample_indices_exact(self, rng):
        n, k = 300, 6
        valid = rng.uniform(size=n) > 0.2
        nbr = rng.integers(0, n, (n, k)).astype(np.int32)
        ok = (rng.uniform(size=(n, k)) > 0.4).astype(np.float32)
        key = jax.random.key(9)
        ref = np.asarray(jsamp.localized_sample_indices(
            key, 200, jnp.asarray(valid), jnp.asarray(nbr), jnp.asarray(ok)))
        got = tsamp.localized_sample_indices(
            KeyDraws(), key, 200, t(valid), t(nbr), t(ok)).numpy()
        np.testing.assert_array_equal(got, ref)

    def test_fix_collisions(self, rng):
        raw = np.stack([rng.integers(0, 50 - j, 400) for j in range(4)], 1)
        ref = np.asarray(jax.vmap(jsamp._fix_collisions)(jnp.asarray(raw)))
        got = tsamp._fix_collisions(t(raw)).numpy()
        np.testing.assert_array_equal(got, ref)

    def test_torch_draws_are_distinct_and_valid(self):
        valid = torch.zeros(128, dtype=torch.bool)
        valid[::3] = True
        g = torch.Generator().manual_seed(0)
        idx = tsamp.sample_indices(tsamp.TorchDraws(g), 0, 4096, valid)
        assert bool(valid[idx].all())
        s = torch.sort(idx, dim=1).values
        assert bool((s[:, 1:] != s[:, :-1]).all())
        # every valid point is drawn, roughly uniformly
        hist = torch.bincount(idx.reshape(-1), minlength=128)[valid]
        assert int(hist.min()) > 0.5 * float(hist.float().mean())


# ---------------------------------------------------------------------------
# labeling and selection
# ---------------------------------------------------------------------------

def graph_problem(rng, n=256, n_valid=230, block=64):
    pts = rng.uniform(0, 640, (n, 2)).astype(np.float32)
    valid = (np.arange(n) < n_valid).astype(np.float32)
    # Morton order, as the fit feeds the graph builders
    perm = np.asarray(multih_tpu.models.pipeline.morton_order(
        jnp.asarray(pts), jnp.asarray(valid)))
    pts, valid = pts[perm], valid[perm]
    ji, jw = jlab.knn_graph(jnp.asarray(pts), jnp.asarray(valid), 6)
    jadj = jlab.build_banded_adjacency(ji, jw, block)
    ti, tw = tlab.knn_graph(t(pts), t(valid), 6)
    tadj = tlab.build_banded_adjacency(ti, tw, block)
    return pts, valid, (ji, jw, jadj), (ti, tw, tadj)


def costs(rng, n, l=9, valid=None):
    dct = rng.uniform(0, 2.0, (l, n)).astype(np.float32)
    if valid is not None:
        dct = dct * valid[None, :]
    return dct


class TestLabeling:
    def test_knn_graph_equal(self, rng):
        for row_block in (0, 96):
            pts = rng.uniform(0, 640, (300, 4)).astype(np.float32)
            valid = (rng.uniform(size=300) > 0.1).astype(np.float32)
            ji, jw = jlab.knn_graph(jnp.asarray(pts), jnp.asarray(valid), 6,
                                    row_block)
            ti, tw = tlab.knn_graph(t(pts), t(valid), 6, row_block)
            np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
            np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))

    def test_banded_adjacency_exact(self, rng):
        _, _, (ji, jw, jadj), (ti, tw, tadj) = graph_problem(rng)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(
            tadj.band.numpy(), np.asarray(jadj.band.astype(jnp.float32)))
        for name in ("far_out", "far_in", "far_w", "deg", "n_dropped"):
            np.testing.assert_array_equal(
                getattr(tadj, name).numpy(),
                np.asarray(getattr(jadj, name)), err_msg=name)
        assert float(tadj.far_w.sum()) > 0  # far edges exist here

    def test_agree_and_mean_field(self, rng):
        _, valid, (ji, jw, jadj), (ti, tw, tadj) = graph_problem(rng)
        p = rng.uniform(size=(9, 256)).astype(np.float32)
        np.testing.assert_allclose(tadj.agree_t(t(p)).numpy(),
                                   np.asarray(jadj.agree_t(jnp.asarray(p))),
                                   rtol=1e-5, atol=1e-5)
        dct = costs(rng, 256, valid=valid)
        q0 = np.asarray(jax.nn.softmax(-jnp.asarray(dct) / 2.0, axis=0))
        ref = jlab.mean_field_t(jnp.asarray(dct), ji, jw, 0.1, 6, 2.0, 0.25,
                                q_init=jnp.asarray(q0), adj=jadj)
        got = tlab.mean_field_t(t(dct), ti, tw, 0.1, 6, 2.0, 0.25,
                                q_init=t(q0), adj=tadj)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)

    def test_icm_batch_and_energy(self, rng):
        _, valid, (ji, jw, jadj), (ti, tw, tadj) = graph_problem(rng)
        dct = costs(rng, 256, valid=valid)
        starts = np.stack([np.argmin(dct, 0),
                           rng.integers(0, 9, 256)]).astype(np.int32)
        ref = np.asarray(jlab._icm_batch(jnp.asarray(starts),
                                         jnp.asarray(dct), 0.1, 2, jadj))
        got = tlab._icm_batch(t(starts).long(), t(dct), 0.1, 2, tadj)
        np.testing.assert_array_equal(got.numpy(), ref)
        active = np.array([1, 1, 0, 1, 1, 1, 0, 1], np.float32)
        for lab in ref:
            je = float(jlab.total_energy_t(
                jnp.asarray(lab), jnp.asarray(dct), ji, jw, 0.1, 20.0,
                jnp.asarray(active), adj=jadj))
            te = float(tlab.total_energy_t(
                t(lab).long(), t(dct), ti, tw, 0.1, 20.0, t(active),
                adj=tadj))
            np.testing.assert_allclose(te, je, rtol=1e-5)
        bl_ref = np.asarray(jlab.best_labeling_t(
            [jnp.asarray(s) for s in starts], jnp.asarray(dct), ji, jw, 0.1,
            2, adj=jadj))
        bl = tlab.best_labeling_t([t(s).long() for s in starts], t(dct), ti,
                                  tw, 0.1, 2, adj=tadj)
        np.testing.assert_array_equal(bl.numpy(), bl_ref)

    def test_constant_labeling_escape(self, rng):
        """Strong coupling: ICM adopts the constant labeling, identically."""
        _, valid, (ji, jw, jadj), (ti, tw, tadj) = graph_problem(rng)
        dct = costs(rng, 256, l=4, valid=valid)
        dct[2] *= 0.3
        starts = rng.integers(0, 4, (2, 256)).astype(np.int32)
        ref = np.asarray(jlab._icm_batch(jnp.asarray(starts),
                                         jnp.asarray(dct), 50.0, 1, jadj))
        got = tlab._icm_batch(t(starts).long(), t(dct), 50.0, 1, tadj)
        np.testing.assert_array_equal(got.numpy(), ref)

    def test_data_costs(self, rng):
        r = rng.uniform(0, 40, (8, 100)).astype(np.float32)
        valid = (rng.uniform(size=100) > 0.2).astype(np.float32)
        active = (rng.uniform(size=8) > 0.3).astype(np.float32)
        ref = jlab.data_costs_t(jnp.asarray(r), jnp.asarray(valid),
                                jnp.float32(9.0), 1.0, jnp.asarray(active))
        got = tlab.data_costs_t(t(r), t(valid), torch.tensor(9.0), 1.0,
                                t(active))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


class TestSelection:
    def test_select_candidates_equal(self, rng):
        cs, _ = tdata.synthetic_scene(200, 3, 0.2, 0.3, seed=11)
        Hs = random_hs(rng, 96)
        x1, x2 = cs.x1, cs.x2
        r = np.asarray(jgeo.residual_matrix(jnp.asarray(Hs),
                                            jnp.asarray(x1),
                                            jnp.asarray(x2)))
        valid = np.ones(200, np.float32)
        ok = (rng.uniform(size=96) > 0.1).astype(np.float32)
        thr = 2500.0  # wide: overlapping inlier sets, many count ties
        ji, ja = jsel.select_candidates(jnp.asarray(r), jnp.asarray(valid),
                                        jnp.float32(thr), jnp.asarray(ok),
                                        48, 8, 0.8)
        ti, ta = tsel.select_candidates(t(r), t(valid), torch.tensor(thr),
                                        t(ok), 48, 8, 0.8)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))

    def test_top_k_stable_tie_order(self):
        x = torch.tensor([3.0, 5.0, 3.0, 5.0, 1.0, 3.0])
        vals, idx = tsel.top_k_stable(x, 4)
        jv, ji = jax.lax.top_k(jnp.asarray(x.numpy()), 4)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
