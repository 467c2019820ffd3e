"""The far-free band's neighbour list (mrf_kernel.band_list_reference,
the plain version of the list the fused MRF kernels read), on the
CPU.

The list must be the band, entry for entry: a windowed band from
knn_graph_windowed, a hand-made band with a hub row of more than 32
non-zeros, and the empty rows of invalid points. An agreement summed over
the list equals the band's bmm agreement: exactly for the {0, 0.5, 1}
weights on one-hot labels (what ICM sums), and within 1e-6 (absolute and
relative) for float states and weights. The CUDA list kernel is held bit-exact to this plain
version on the card (test_torch_kernels.py).
"""

import numpy as np
import pytest
import torch

from multih_tpu_torch.models import labeling as tlab
from multih_tpu_torch.ops.kernels import mrf_kernel as tmrf
from test_torch_kernels import add_hub, t, windowed_band

torch.set_num_threads(1)


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def dense_from_list(nbr, nb, block):
    """The (nb, B, 3B) band the list describes."""
    n, bb = nbr.cols.shape
    band = torch.zeros((n, bb), dtype=nbr.ws.dtype)
    for i in range(n):
        c = int(nbr.cnt[i])
        g0 = (i // block - 1) * block
        band[i, nbr.cols[i, :c].long() - g0] = nbr.ws[i, :c]
    return band.reshape(nb, block, bb)


def list_agree(q, nbr):
    """agree[:, i] = sum_e ws[i, e] * q[:, cols[i, e]] over the list."""
    return (q[:, nbr.cols.long()] * nbr.ws[None]).sum(-1)


def band_agree(q, band):
    nb, block, _ = band.shape
    return tmrf._agree(tmrf._band_window(q, nb, block, 0.0), band)


def in_range_band(band):
    """band with its out-of-range columns (block 0's left third, block
    nb-1's right third) zeroed: what every reader of the band sees."""
    nb, block, bb = band.shape
    i = torch.arange(nb * block)[:, None]
    g = (i // block - 1) * block + torch.arange(bb)[None, :]
    ok = ((g >= 0) & (g < nb * block)).reshape(nb, block, bb)
    return torch.where(ok, band, 0.0)


@pytest.mark.parametrize("n,block", [(512, 128), (384, 64)])
@pytest.mark.parametrize("hub", [False, True])
def test_list_is_the_band(rng, n, block, hub):
    """Counts, columns in order and weights reproduce the band exactly;
    the 30 invalid points' rows are empty; a hub row keeps its 80
    non-zeros and drops its 3 out-of-range ones."""
    _, _, valid, _, adj = windowed_band(rng, n, block, "cpu")
    assert adj.nbr is None  # the CPU runs the plain sweeps on the band
    band = add_hub(rng, adj.band) if hub else adj.band
    nbr = tmrf.band_list_reference(band)
    nb, bb = n // block, 3 * block
    assert nbr.cols.shape == nbr.ws.shape == (n, bb)
    assert nbr.cols.dtype == nbr.cnt.dtype == torch.int32
    assert nbr.ws.dtype == torch.float32
    torch.testing.assert_close(dense_from_list(nbr, nb, block),
                               in_range_band(band), rtol=0, atol=0)
    assert torch.equal(nbr.cnt.long(),
                       (in_range_band(band) != 0).sum(2).reshape(n))
    assert bool((nbr.cnt[valid == 0] == 0).all())
    for i in range(n):
        c = int(nbr.cnt[i])
        assert bool((nbr.cols[i, 1:c] > nbr.cols[i, :max(c - 1, 0)]).all())
        assert bool((nbr.cols[i, c:] == 0).all())
        assert bool((nbr.ws[i, c:] == 0).all())
    if hub:
        assert int(nbr.cnt[3]) >= 80


def test_agreement_over_the_list(rng):
    """One-hot labels on {0, 0.5, 1} weights: exact. Float marginals on
    float weights: within 1e-6 (the two sum in different orders)."""
    n, block, l = 512, 128, 9
    _, _, _, _, adj = windowed_band(rng, n, block, "cpu")
    band = add_hub(rng, adj.band)
    nbr = tmrf.band_list_reference(band)
    labels = t(rng.integers(0, l, n))
    onehot = tlab._onehot_t(labels, l, torch.float32)
    assert torch.equal(list_agree(onehot, nbr), band_agree(onehot, band))
    fband = band * t(rng.uniform(0.1, 2.0, band.shape).astype(np.float32))
    fnbr = tmrf.band_list_reference(fband)
    q = torch.softmax(t(rng.normal(size=(l, n)).astype(np.float32)), 0)
    # the hub row sums 80 terms to ~8, where 1e-6 is two float32 ulps
    torch.testing.assert_close(list_agree(q, fnbr), band_agree(q, fband),
                               rtol=1e-6, atol=1e-6)
