"""K3's round-robin plain version (the order and rounding of
csrc/eig_kernel.cu) against the JAX package's cyclic Jacobi and float64
eigh, and its schedule.

The kernel itself runs only on the card; tests/test_torch_kernels.py
holds it to this plain version there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multih_tpu.ops.kernels import eig_kernel as jeig
from multih_tpu_torch.ops.kernels import eig_kernel as teig
from test_torch_kernels import (eigvec_err64, eigvec_floor, f_normal_matrices,
                                normal_matrices, sign_aligned_err, t)

torch.set_num_threads(1)  # one thread per xdist worker (test_torch_kernels)


@pytest.fixture
def rng():
    return np.random.default_rng(42)


def test_round_robin_schedule():
    """Each sweep's 9 rounds hold 4 disjoint pairs p < q and cover each
    of the 36 pairs of 9 indices exactly once; the index left out of
    round r is r."""
    pairs = [pq for rnd in teig.ROUNDS for pq in rnd]
    assert len(teig.ROUNDS) == 9
    assert sorted(pairs) == [(p, q) for p in range(9) for q in range(p + 1, 9)]
    for r, rnd in enumerate(teig.ROUNDS):
        used = [i for pq in rnd for i in pq]
        assert len(rnd) == 4 and len(set(used)) == 8 and r not in used
        assert all(p < q for p, q in rnd)


def test_round_robin_matches_jnp_twin(rng):
    """The round-robin plain version against the JAX package's cyclic
    smallest_eigvec_9x9_batch_jnp (through numpy): another rotation
    order, so the same eigenvector only to rounding; sign-aligned within
    1e-4 on the homography normal matrices whose float32 floor is below
    1e-5."""
    atas = normal_matrices(rng, 64)
    floor = eigvec_floor(t(atas))
    well = floor < 1e-5
    assert well.sum() >= 48
    ref = np.asarray(jeig.smallest_eigvec_9x9_batch_jnp(jnp.asarray(atas), 6))
    got = teig.smallest_eigvec_9x9_round_robin_reference(t(atas)).numpy()
    assert sign_aligned_err(ref[well], got[well]) < 1e-4


@pytest.mark.parametrize("kind", ["homography", "fundamental"])
def test_round_robin_vs_eigh64(rng, kind):
    """Six round-robin sweeps in float32 come within twice the float32
    eigenvector floor eps32 * lam_max / (lam_2 - lam_1) of float64 eigh
    on every matrix: the homography normal matrices and the F refits'
    (gaps down to ~6e-5 of lam_max, floors up to ~2e-3)."""
    atas = (t(normal_matrices(rng, 256)) if kind == "homography"
            else f_normal_matrices(rng, 256))
    floor = eigvec_floor(atas)
    got = teig.smallest_eigvec_9x9_round_robin_reference(atas)
    assert got.shape == (256, 9) and bool(torch.isfinite(got).all())
    assert (eigvec_err64(atas, got) <= 2.0 * floor).all()
    np.testing.assert_allclose(torch.linalg.vector_norm(got, dim=1).numpy(),
                               1.0, atol=1e-6)


def test_round_robin_reads_lower_triangle(rng):
    """The kernel's plain version reads the lower triangle, as
    torch.linalg.eigh does: the upper one does not change its result."""
    atas = t(normal_matrices(rng, 32))
    upper = torch.triu(torch.ones(9, 9, dtype=torch.bool), 1)
    noisy = torch.where(upper, atas * 1.5 + 3.0, atas)
    a = teig.smallest_eigvec_9x9_round_robin_reference(atas)
    b = teig.smallest_eigvec_9x9_round_robin_reference(noisy)
    assert torch.equal(a, b)
