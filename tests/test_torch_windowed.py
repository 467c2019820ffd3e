"""The port's default and window-sampling paths against the JAX package:
the windowed k-NN graph, the far-free band, the fused MRF kernels' and
the window gather's plain versions, window-stratified sampling, and the
fit at the default config and at a small stress-shaped config with
window_sampling.

Same seeded numpy inputs go through both packages. The JAX kernels run
as tests/test_mrf_kernel.py runs them on the CPU (interpret=True); the
port's CUDA kernels are held to these plain versions on the card in
test_torch_kernels.py. The fits replay the JAX fit's threefry draws
(JaxReplayDraws, grown by the windowed sampler's three draws), one JAX
compile per config.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multih_tpu
from multih_tpu.models import labeling as jlab
from multih_tpu.models import pipeline as jpipe
from multih_tpu.ops import sampling as jsamp
from multih_tpu.ops.kernels import gather_kernel as jgather
from multih_tpu.ops.kernels import mrf_kernel as jmrf

import multih_tpu_torch as mt
from multih_tpu_torch.models import labeling as tlab
from multih_tpu_torch.ops import sampling as tsamp
from multih_tpu_torch.ops.kernels import gather_kernel as tgather
from multih_tpu_torch.ops.kernels import mrf_kernel as tmrf
from multih_tpu_torch.utils import data as tdata
from multih_tpu_torch.utils import evaluation
from test_torch_kernels import t
from test_torch_pipeline import JaxReplayDraws


def _raw_ranks_per(keys, n_valid, m):
    """vmap(sampling._draw_without_replacement)(keys, n_valid)'s randint
    draws before the collision fix, n_valid per sample: (S, m)."""
    def one(k, nv):
        ks = jax.random.split(k, m)
        return jnp.stack([
            jax.random.randint(ks[j], (), 0, jnp.maximum(nv - j, 1))
            for j in range(m)
        ])
    return jax.vmap(one)(keys, n_valid)


_raw_ranks_per = jax.jit(_raw_ranks_per, static_argnums=2)
# one compile per shape instead of one per eager op
_knn_windowed = jax.jit(jlab.knn_graph_windowed, static_argnums=(2, 3))
_windowed_quadruples = jax.jit(jsamp.windowed_quadruples,
                               static_argnums=(5, 6))


class WindowDraws:
    """The windowed sampler's draws replayed from JAX keys
    (sampling.py:230-247): `win_keys(r)` gives (k_u, k_s, k_n) of the
    call whose stream round is r."""

    def win_keys(self, r):
        raise NotImplementedError

    def _key(self, stream):
        tag, r = stream
        return dict(zip(("win_u", "win_s", "win_n"), self.win_keys(r)))[tag]

    def window_ranks(self, stream, n_valid, m):
        keys = jax.random.split(self._key(stream), n_valid.shape[0])
        nv = jnp.asarray(n_valid.cpu().numpy().astype(np.int32))
        return t(np.array(_raw_ranks_per(keys, nv, m))).long()

    def window_randint(self, stream, lo, hi, n):
        r = jax.random.randint(
            self._key(stream), (lo.shape[0], n),
            jnp.asarray(lo.cpu().numpy().astype(np.int32)),
            jnp.asarray(hi.cpu().numpy().astype(np.int32)))
        return t(np.array(r)).long()

    def gumbel(self, stream, shape, device):
        if not (isinstance(stream, tuple) and stream[0] == "win_n"):
            return super().gumbel(stream, shape, device)  # row-gather path
        return t(np.array(jax.random.gumbel(self._key(stream), shape)))


class KeyWindowDraws(WindowDraws):
    """One `windowed_quadruples(key, ...)` call's draws."""

    def __init__(self, key):
        self.key = key

    def win_keys(self, r):
        return jax.random.split(self.key, 3)


class FitReplayDraws(WindowDraws, JaxReplayDraws):
    """`multih_tpu.fit`'s draws for `key`, both samplers: the windowed
    sampler gets the round key itself (pipeline.py:353), split three
    ways inside."""

    def win_keys(self, r):
        return jax.random.split(self.round_keys[r], 3)


def morton_scene(rng, n, invalid=0):
    pts = rng.uniform(0, 100, (n, 2)).astype(np.float32)
    x2 = (pts + rng.normal(0, 2.0, (n, 2))).astype(np.float32)
    valid = np.ones(n, np.float32)
    if invalid:
        valid[-invalid:] = 0.0
    perm = np.asarray(jpipe.morton_order(jnp.asarray(pts),
                                         jnp.asarray(valid)))
    return pts[perm], x2[perm], valid[perm]


def j2n(a):
    return np.asarray(a)


# ---------------------------------------------------------------------------
# windowed k-NN graph and the far-free band
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("feats", ["positions", "sampling_features"])
@pytest.mark.parametrize("nb", [2, 3, 4])
def test_knn_graph_windowed_bit_equal(rng, nb, feats):
    block = 64
    x1, x2, valid = morton_scene(rng, nb * block, invalid=20)
    f = x1 if feats == "positions" else \
        np.concatenate([x1, 2.0 * (x2 - x1)], axis=1)
    ji, jw = _knn_windowed(jnp.asarray(f), jnp.asarray(valid), 6, block)
    ti, tw = tlab.knn_graph_windowed(t(f), t(valid), 6, block)
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), j2n(ji))
    np.testing.assert_array_equal(tw.numpy(), j2n(jw))
    if nb == 2:  # the window is the whole array: exact k-NN's edge sets
        ei, ew = tlab.knn_graph(t(f), t(valid), 6)
        for r in range(f.shape[0]):
            assert set(ti[r][tw[r] > 0].tolist()) == \
                set(ei[r][ew[r] > 0].tolist()), r


@pytest.mark.parametrize("graph", ["windowed", "exact"])
def test_far_free_band_equal(rng, graph):
    """The scatter-free build: band and deg equal to JAX's, far arrays
    empty, n_dropped equal (0 on a windowed graph, 2x the out-of-band
    edges on the exact graph)."""
    block = 64
    x1, _, valid = morton_scene(rng, 4 * block, invalid=20)
    build = jlab.knn_graph_windowed if graph == "windowed" else \
        (lambda p, v, k, b: jlab.knn_graph(p, v, k))
    ji, jw = build(jnp.asarray(x1), jnp.asarray(valid), 6, block)
    jadj = jlab.build_banded_adjacency(ji, jw, block, far_capacity=0)
    tadj = tlab.build_banded_adjacency(t(j2n(ji)), t(j2n(jw)), block,
                                       far_capacity=0)
    np.testing.assert_array_equal(tadj.band.numpy(),
                                  j2n(jadj.band.astype(jnp.float32)))
    np.testing.assert_array_equal(tadj.deg.numpy(), j2n(jadj.deg))
    assert tadj.far_w.shape == tadj.far_in.shape == (0,)
    assert int(tadj.n_dropped) == int(jadj.n_dropped)
    assert (int(tadj.n_dropped) == 0) == (graph == "windowed")
    # the band is the same operator as the general build's when no edge
    # is out of band
    if graph == "windowed":
        gen = tlab.build_banded_adjacency(t(j2n(ji)), t(j2n(jw)), block)
        assert float(gen.far_w.sum()) == 0.0
        np.testing.assert_array_equal(tadj.band.numpy(), gen.band.numpy())


# ---------------------------------------------------------------------------
# the fused MRF kernels' plain versions vs the Pallas kernels (interpret)
# ---------------------------------------------------------------------------

def mrf_problem(rng, l=9, n=512, block=128):
    x1, _, valid = morton_scene(rng, n, invalid=30)
    ji, jw = jlab.knn_graph_windowed(jnp.asarray(x1), jnp.asarray(valid), 6,
                                     block)
    jadj = jlab.build_banded_adjacency(ji, jw, block, far_capacity=0)
    tadj = tlab.build_banded_adjacency(t(j2n(ji)), t(j2n(jw)), block,
                                       far_capacity=0)
    dct = (rng.uniform(0, 2.0, (l, n)) * valid[None, :]).astype(np.float32)
    base = (jnp.asarray(dct) + 0.1 * jadj.deg.T).astype(jnp.float32)
    band = j2n(jadj.band.astype(jnp.float32))
    return dct, j2n(base), band, jadj, tadj


def test_mean_field_fused_reference_matches_pallas(rng):
    dct, base, band, jadj, _ = mrf_problem(rng)
    q0 = j2n(jax.nn.softmax(-jnp.asarray(dct) / 2.0, axis=0))
    inv_t = (1.0 / np.geomspace(2.0, 0.25, 6)).astype(np.float32)
    ref = j2n(jmrf.mean_field_fused(
        jnp.asarray(q0), jnp.asarray(base), jadj.band, jnp.asarray(inv_t),
        0.1, interpret=True))
    got = tmrf.mean_field_fused_reference(t(q0), t(base), t(band), t(inv_t),
                                          0.1).numpy()
    assert np.abs(got - ref).max() <= 1e-5
    assert (got.argmax(0) == ref.argmax(0)).mean() > 0.999


def test_icm_fused_reference_matches_pallas(rng):
    dct, base, band, jadj, _ = mrf_problem(rng)
    starts = np.stack([dct.argmin(0),
                       rng.integers(0, dct.shape[0], dct.shape[1])]
                      ).astype(np.int32)
    ref = j2n(jmrf.icm_fused(jnp.asarray(starts), jnp.asarray(base),
                             jadj.band, 2, 0.1, interpret=True))
    got = tmrf.icm_fused_reference(t(starts), t(base), t(band), 2, 0.1)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (ref != starts).any()  # the sweeps moved labels


def test_labeling_on_windowed_band_matches_reference(rng):
    """mean_field_t and _icm_batch (the plain sweeps the CPU runs) on the
    far-free band equal the JAX jnp paths."""
    dct, _, _, jadj, tadj = mrf_problem(rng)
    q0 = j2n(jax.nn.softmax(-jnp.asarray(dct) / 2.0, axis=0))
    ref = jlab.mean_field_t(jnp.asarray(dct), None, None, 0.1, 6, 2.0, 0.25,
                            q_init=jnp.asarray(q0), adj=jadj)
    got = tlab.mean_field_t(t(dct), None, None, 0.1, 6, 2.0, 0.25,
                            q_init=t(q0), adj=tadj)
    np.testing.assert_allclose(got.numpy(), j2n(ref), rtol=1e-5, atol=1e-5)
    starts = np.stack([dct.argmin(0), q0.argmax(0)]).astype(np.int32)
    ref = jlab._icm_batch(jnp.asarray(starts), jnp.asarray(dct), 0.1, 2, jadj)
    got = tlab._icm_batch(t(starts).long(), t(dct), 0.1, 2, tadj)
    np.testing.assert_array_equal(got.numpy(), j2n(ref))


# ---------------------------------------------------------------------------
# window gather and window-stratified sampling
# ---------------------------------------------------------------------------

def gather_problem(rng, nb=5, block=32, c=16):
    win = rng.normal(size=(nb, 3 * block, c)).astype(np.float32)
    avail = (rng.uniform(size=(nb, 3 * block)) > 0.4).astype(np.float32)
    avail[2] = 0.0  # an exhausted window
    win[:, :, 4] = avail
    win[:, :, 5] = np.cumsum(avail, axis=1)
    return win


@pytest.mark.parametrize("mode", ["index", "rank"])
def test_window_gather_reference_equal(rng, mode):
    win = gather_problem(rng)
    nb, rows, _ = win.shape
    # in-range picks, ranks past each window's count, negatives, and
    # indices past the window
    sel = rng.integers(-3, rows + 5, (nb, 300)).astype(np.int32)
    ref = j2n(jgather.window_gather_reference(jnp.asarray(win),
                                              jnp.asarray(sel), mode))
    got = tgather.window_gather_reference(t(win), t(sel), mode).numpy()
    assert got.shape == (nb, win.shape[2], 300)
    np.testing.assert_array_equal(got, ref)
    zero = (got == 0).all(axis=1)
    assert zero.any() and not zero.all()
    if mode == "rank":
        assert zero[2].all()  # nothing is available in window 2


@pytest.mark.parametrize("claimed", [False, True])
def test_windowed_quadruples_exact(rng, claimed):
    """The (32, S) rows equal JAX's with its draws replayed; with a
    claimed region (an exhausted middle block and window) too."""
    block, nb, s = 64, 4, 4 * 96
    x1, x2, valid = morton_scene(rng, nb * block, invalid=25)
    avail = valid.copy()
    if claimed:
        avail[: 2 * block] = 0.0
    ji, _ = _knn_windowed(jnp.asarray(x1), jnp.asarray(valid), 6, block)
    key = jax.random.key(3)
    ref = j2n(_windowed_quadruples(
        key, jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(avail), ji, s,
        block))
    got = tsamp.windowed_quadruples(
        KeyWindowDraws(key), 0, t(x1), t(x2), t(avail), t(j2n(ji)), s,
        block).numpy()
    assert got.shape == (32, s)
    np.testing.assert_array_equal(got, ref)


def test_windowed_quadruples_rejects_window_range(rng):
    """`window_range` is ported: at 2 and 4 shards, the shards' window
    ranges, each drawn from a generator of the same seed, concatenate to
    the unsharded call's columns bit for bit (every draw is full-size on
    every shard; only the gathers are sliced). A range past the windows
    is refused."""
    block, nb, s = 64, 4, 4 * 96
    x1, x2, valid = morton_scene(rng, nb * block, invalid=25)
    avail = valid.copy()
    avail[:block] = 0.0  # an exhausted window
    ti, _ = tlab.knn_graph_windowed(t(x1), t(valid), 6, block)

    def call(window_range=None):
        return tsamp.windowed_quadruples(
            tsamp.TorchDraws(torch.Generator().manual_seed(4)), 0, t(x1),
            t(x2), t(avail), ti, s, block, window_range=window_range)

    whole = call()
    for n_shards in (2, 4):
        nw = nb // n_shards
        shards = [call((d * nw, nw)) for d in range(n_shards)]
        assert all(a.shape == (32, s // n_shards) for a in shards)
        assert torch.equal(torch.cat(shards, dim=1), whole)
    with pytest.raises(ValueError, match="window_range"):
        call((3, 2))


def test_torch_draws_window_methods():
    g = tsamp.TorchDraws(torch.Generator().manual_seed(0))
    nv = torch.tensor([1, 5, 40, 0])
    r = g.window_ranks(("win_u", 0), nv.repeat_interleave(500), 4)
    hi = torch.clamp_min(nv.repeat_interleave(500)[:, None]
                         - torch.arange(4), 1)
    assert bool(((r >= 0) & (r < hi)).all())
    lo = torch.tensor([[0], [3], [10]])
    hi = torch.tensor([[1], [7], [11]])
    x = g.window_randint(("win_s", 0), lo, hi, 1000)
    assert bool(((x >= lo) & (x < hi)).all()) and int(x[1].unique().numel()) == 4
    assert g.gumbel(("win_n", 0), (3, 5, 6), "cpu").shape == (3, 5, 6)


# ---------------------------------------------------------------------------
# the kernel wrappers take CUDA tensors only
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["mean_field", "icm", "window_gather"])
def test_kernel_wrappers_reject_cpu_tensors(which):
    band = torch.zeros((2, 64, 192))
    base = torch.zeros((3, 128))
    with pytest.raises(ValueError, match="CUDA"):
        if which == "mean_field":
            tmrf.mean_field_fused(base, base, band, torch.ones(2), 0.1)
        elif which == "icm":
            tmrf.icm_fused(torch.zeros((2, 128), dtype=torch.int32), base,
                           band, 1, 0.1)
        else:
            tgather.window_gather(torch.zeros((2, 192, 8)),
                                  torch.zeros((2, 10), dtype=torch.int32))
    assert tmrf.mean_field_fused.launches == tmrf.icm_fused.launches == \
        tgather.window_gather.launches == 0


def test_numpy_input_needs_a_card_or_device_cpu():
    cfg = mt.MultiHConfig(max_points=512)
    z = np.zeros((512, 2), np.float32)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mt.fit(z, z, np.ones(512, np.float32), torch.Generator(), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mt.make_fit(cfg)(z, z, np.ones(512, np.float32), torch.Generator())


# ---------------------------------------------------------------------------
# the fit: default config, and window sampling
# ---------------------------------------------------------------------------

def _fits(kw, scene, n_pad, seeds):
    jcfg = multih_tpu.MultiHConfig(**kw)
    tcfg = mt.MultiHConfig.from_dict(dataclasses.asdict(jcfg))
    jf = multih_tpu.make_fit(jcfg)
    out = {}
    for seed in seeds:
        cs, _ = tdata.synthetic_scene(*scene, seed=seed)
        x1, x2, valid, gt = mt.pad_points(cs.x1, cs.x2, cs.gt_labels, n_pad)
        key = jax.random.key(seed)
        jr = jax.device_get(jf(x1, x2, valid, key))
        tr = mt.fit(x1, x2, valid,
                    FitReplayDraws(key, jcfg.progressive_rounds), tcfg,
                    device="cpu")
        out[seed] = (jr, tr, gt, tcfg)
    return out


DEFAULT_SEEDS = (5, 7)
WINDOW_SEEDS = (11, 12)


@pytest.fixture(scope="module")
def default_fits():
    """MultiHConfig() with agree_block=128 (so nb=4 at N=512), 512
    hypotheses and 8 labels: the windowed graph, the far-free band, and
    the plain mean-field / ICM sweeps."""
    kw = dict(agree_block=128, n_hypotheses=512, n_candidates=64,
              max_labels=8)
    return _fits(kw, (480, 3, 0.1, 0.3), 512, DEFAULT_SEEDS)


@pytest.fixture(scope="module")
def window_fits():
    """bench.py _stress_cfg's code paths at N=1024, B=128 (8 windows):
    window sampling (64 samples per window per round, 2 rounds), the
    windowed graph, the subsampled verify with a transfer ranking
    residual and its full-resolution rescore."""
    kw = dict(max_points=1024, n_hypotheses=1024, residual_chunk=256,
              progressive_rounds=2, claims_per_round=4, verify_subsample=4,
              claim_subsample=4, pearl_iterations=5, window_sampling=True,
              rank_residual="transfer", agree_block=128,
              meanfield_iterations=4, icm_iterations=1, n_candidates=64,
              max_labels=8)
    return _fits(kw, (1000, 5, 0.4, 0.5), 1024, WINDOW_SEEDS)


def _check_fit(jr, tr, gt, cfg, max_err):
    k = cfg.max_labels
    assert int(tr.active.sum()) == int(np.asarray(jr.active).sum()) > 0
    assert float(tr.n_hypotheses_ok) == float(jr.n_hypotheses_ok)
    assert int(tr.n_far_dropped) == int(jr.n_far_dropped) == 0
    agree = 100.0 - evaluation.misclassification_error(
        tr.labels.numpy(), np.asarray(jr.labels), k, gt_outlier=k)
    assert agree >= 99.0, agree
    np.testing.assert_allclose(float(tr.energy), float(jr.energy),
                               rtol=1e-3)
    assert evaluation.misclassification_error(tr.labels.numpy(), gt,
                                              k) < max_err


@pytest.mark.parametrize("seed", DEFAULT_SEEDS)
def test_default_config_fit_matches_reference(default_fits, seed):
    jr, tr, gt, cfg = default_fits[seed]
    assert jpipe.graph_path(multih_tpu.MultiHConfig(agree_block=128),
                            512) == "windowed"
    _check_fit(jr, tr, gt, cfg, 5.0)


@pytest.mark.parametrize("seed", WINDOW_SEEDS)
def test_window_sampling_fit_matches_reference(window_fits, seed):
    jr, tr, gt, cfg = window_fits[seed]
    _check_fit(jr, tr, gt, cfg, 5.0)
