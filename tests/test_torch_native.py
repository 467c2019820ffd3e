"""The port's native.py (its own copy of the C++ alpha-expansion solver,
built with g++ under build/) against brute force on tiny MRFs (the cases
of tests/test_native_expansion.py, label costs included), against the
JAX package's multih_tpu/native.py on the same inputs, and as the oracle
of the port's relaxation (labeling.mean_field_t + best_labeling_t on the
port's k-NN graph). Skips where g++ cannot build it. No JAX compile.
"""

import itertools

import numpy as np
import pytest
import torch

from multih_tpu import native as jnative
from multih_tpu_torch import native
from multih_tpu_torch.models import labeling

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="g++/native build unavailable")


def directed_edges(nbr_idx, nbr_w):
    """(E, 2) int32 directed edges and (E,) float64 weights of the k-NN
    graph's nonzero entries, as tests/test_native_expansion.py builds
    them."""
    n, k = nbr_idx.shape
    pq = [(i, nbr_idx[i, j]) for i in range(n) for j in range(k)
          if nbr_w[i, j] > 0]
    w = [nbr_w[i, j] for i in range(n) for j in range(k) if nbr_w[i, j] > 0]
    return np.array(pq, np.int32).reshape(-1, 2), np.array(w, np.float64)


def knn(pts, k):
    idx, w = labeling.knn_graph(torch.from_numpy(pts),
                                torch.ones(len(pts)), k)
    return idx.numpy(), w.numpy()


def brute_force(d, pq, w, lam, h):
    n, n_labels = d.shape
    best_lab, best_e = None, np.inf
    for lab in itertools.product(range(n_labels), repeat=n):
        lab = np.array(lab)
        e = d[np.arange(n), lab].sum()
        e += 0.5 * lam * sum(wi for (p, q), wi in zip(pq, w)
                             if lab[p] != lab[q])
        e += sum(h[l] for l in range(n_labels) if (lab == l).any())
        if e < best_e:
            best_e, best_lab = e, lab
    return best_lab, best_e


def tiny_problem(rng, n=7, n_labels=3, k=2):
    pts = rng.uniform(0, 10, (n, 2)).astype(np.float32)
    pq, w = directed_edges(*knn(pts, k))
    return rng.uniform(0, 1, (n, n_labels)), pq, w


CASES = ("no_label_cost", "label_costs", "true_energy", "strong_smoothness",
         "zero_smoothness", "label_cost_drops_marginal_label")


@pytest.mark.parametrize("case", CASES)
def test_expansion_against_brute_force(case):
    rng = np.random.default_rng(42)
    if case == "no_label_cost":
        for _ in range(8):
            d, pq, w = tiny_problem(rng)
            _, e = native.expansion_solve(d, pq, w, 0.5, np.zeros(3))
            _, e_opt = brute_force(d, pq, w, 0.5, np.zeros(3))
            assert e <= e_opt + 1e-6, (e, e_opt)
    elif case == "label_costs":
        hits, h = 0, np.array([0.8, 0.5, 1.2])
        for _ in range(8):
            d, pq, w = tiny_problem(rng)
            _, e = native.expansion_solve(d, pq, w, 0.4, h)
            _, e_opt = brute_force(d, pq, w, 0.4, h)
            # expansion is approximate in general but near-exact here
            assert e <= e_opt * 1.02 + 1e-6, (e, e_opt)
            hits += int(e <= e_opt + 1e-6)
        assert hits >= 6
    elif case == "true_energy":
        d, pq, w = tiny_problem(rng)
        h = np.array([0.3, 0.0, 0.7])
        lab, e = native.expansion_solve(d, pq, w, 0.6, h)
        e_check = d[np.arange(len(d)), lab].sum()
        e_check += 0.5 * 0.6 * sum(wi for (p, q), wi in zip(pq, w)
                                   if lab[p] != lab[q])
        e_check += sum(h[l] for l in range(3) if (lab == l).any())
        assert abs(e - e_check) < 1e-6
    elif case == "strong_smoothness":
        d, pq, w = tiny_problem(rng)
        lab, _ = native.expansion_solve(d, pq, w, 100.0, np.zeros(3))
        assert len(np.unique(lab)) == 1
    elif case == "zero_smoothness":
        d, pq, w = tiny_problem(rng)
        lab, _ = native.expansion_solve(d, pq, w, 0.0, np.zeros(3))
        np.testing.assert_array_equal(lab, d.argmin(1))
    else:
        # two points prefer label 1 by a hair; a big h_1 pushes them off
        d = np.array([[0.1, 0.05, 1.0], [0.1, 0.05, 1.0]])
        pq = np.array([[0, 1], [1, 0]], np.int32)
        lab, _ = native.expansion_solve(d, pq, np.ones(2), 0.0,
                                        np.array([0.0, 5.0, 0.0]))
        np.testing.assert_array_equal(lab, [0, 0])


def blob_problem(rng, n=300, n_labels=5):
    """tests/test_native_expansion.py's pipeline-like problem: points in a
    640 px square, truncated-quadratic costs around n_labels - 1 blob
    centres, the last label a constant 1; the port's 6-NN graph."""
    pts = rng.uniform(0, 640, (n, 2)).astype(np.float32)
    nbr_idx, nbr_w = knn(pts, 6)
    centers = rng.uniform(100, 540, (n_labels - 1, 2))
    d = np.full((n, n_labels), 1.0)
    for l in range(n_labels - 1):
        r = (np.linalg.norm(pts - centers[l], axis=1) / 120.0) ** 2 \
            + rng.uniform(0, 0.3, n)
        d[:, l] = np.minimum(r, 8.0)
    return d, nbr_idx, nbr_w


def test_equals_reference_binding():
    """The same labels and energy as the JAX package's binding (its own
    build of the same source) on the same inputs, with and without label
    costs and a start labeling."""
    rng = np.random.default_rng(3)
    d, nbr_idx, nbr_w = blob_problem(rng, n=120)
    pq, w = directed_edges(nbr_idx, nbr_w)
    init = rng.integers(0, 5, 120).astype(np.int32)
    for h, start in ((np.zeros(5), None), (np.full(5, 2.0), init)):
        got = native.expansion_solve(d, pq, w, 0.3, h, start, 6)
        want = jnative.expansion_solve(d, pq, w, 0.3, h, start, 6)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]


def test_relaxation_agrees_with_expansion():
    """The port's mean-field + ICM lands within a few % of the expansion
    oracle's labeling and within 0.5% of its energy (the bounds of
    tests/test_native_expansion.py); the port's energy of the oracle's
    labels is the oracle's own."""
    lam = 0.2
    d, nbr_idx, nbr_w = blob_problem(np.random.default_rng(42))
    pq, w = directed_edges(nbr_idx, nbr_w)
    lab_cpp, e_cpp = native.expansion_solve(d, pq, w, lam,
                                            np.zeros(d.shape[1]))
    dct = torch.from_numpy(d.T.astype(np.float32))  # label-major (L, N)
    idx, nw = torch.from_numpy(nbr_idx), torch.from_numpy(nbr_w)
    q = labeling.mean_field_t(dct, idx, nw, lam, 20, 2.0, 0.1)
    lab = labeling.best_labeling_t(
        [torch.argmax(q, dim=0), torch.argmin(dct, dim=0)], dct, idx, nw,
        lam, 6)
    active = torch.ones(d.shape[1] - 1)  # the last label: no model

    def energy(labels):
        return float(labeling.total_energy_t(labels, dct, idx, nw, lam, 0.0,
                                             active))

    assert abs(energy(torch.from_numpy(lab_cpp).long()) - e_cpp) \
        <= 1e-5 * e_cpp
    disagree = float(np.mean(lab_cpp != lab.numpy()))
    assert disagree < 0.05, f"{disagree:.3f} disagreement"
    assert energy(lab) <= e_cpp * 1.005 + 1e-3, (energy(lab), e_cpp)
