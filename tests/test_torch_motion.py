"""The port's fundamental-model (multi-motion) fit against the golden
labelings of the motion suite: the contract of
tests/test_golden_parity.py::test_motion_misclassification_parity_with_reference.

This file imports no JAX, so it runs on the GPU host too (the kernel
path), with the whole suite:

    python -m pytest tests/test_torch_motion.py --noconftest -q

Run as a script from the repository root, it prints the suite's
numbers instead, one line per scene and the suite mean:

    PYTHONPATH=. python tests/test_torch_motion.py

Tier-1 (`-m 'not slow'`) runs one scene on the CPU (the plain path):
fm4_a, the anti-bridge case. The other scenes and the suite mean are
marked `slow`, as their JAX twin is.
"""

import functools
import os

import numpy as np
import pytest
import torch

import multih_tpu_torch as mt
from multih_tpu_torch.ops.sampling import TorchDraws
from multih_tpu_torch.utils import data as tdata
from multih_tpu_torch.utils import evaluation

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
N_KEYS = 3
TIER1_SCENE = "fm4_a"


def motion_cfg(npad: int) -> mt.MultiHConfig:
    """The config the motion goldens were made at (test_golden_parity.py
    :145-148)."""
    return mt.MultiHConfig(max_points=npad, n_hypotheses=2048,
                           model="fundamental", residual="sampson")


@functools.lru_cache(maxsize=None)
def motion_fit(name: str):
    """One suite scene fitted by the port at the golden tau, N_KEYS keys:
    (motion counts per key, mean misclassification, the golden's
    misclassification and motion count). On the GPU when there is one.
    Key k is a CPU torch.Generator seeded k on every device, so the card
    is held to the CPU run's samples (test_torch_kernels.golden_suite)."""
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    cs = tdata.motion_suite_scene(name)
    npad = 1 << max(9, (cs.n_points - 1).bit_length())
    cfg = motion_cfg(npad)
    g = np.load(os.path.join(GOLDENS, f"{name}.npz"))
    f = mt.make_fit_tau(cfg)
    args = [torch.from_numpy(a).to(dev)
            for a in mt.pad_points(cs.x1, cs.x2, None, npad)]
    counts, errs = [], []
    for k in range(N_KEYS):
        res = f(*args, TorchDraws(torch.Generator().manual_seed(k)),
                float(g["inlier_threshold"]))
        counts.append(int(res.active.sum()))
        errs.append(evaluation.misclassification_error(
            res.labels.cpu().numpy()[: cs.n_points], cs.gt_labels,
            cfg.max_labels))
    return (counts, float(np.mean(errs)), float(g["misclassification"]),
            int(g["n_planes"]))


@pytest.mark.parametrize("name", [
    pytest.param(row[0], marks=() if row[0] == TIER1_SCENE
                 else pytest.mark.slow)
    for row in tdata.MOTION_SUITE
])
def test_motion_golden_scene(name):
    """Per scene: the motion count equals the golden's on every key, and
    |mean misclassification - golden| <= 2.0 pp."""
    counts, err, golden_err, golden_n = motion_fit(name)
    assert counts == [golden_n] * N_KEYS, (counts, golden_n)
    assert abs(err - golden_err) <= 2.0, (err, golden_err)


@pytest.mark.slow
def test_motion_golden_suite_mean():
    """Suite level: |mean delta| <= 0.75 pp."""
    deltas = {row[0]: motion_fit(row[0])[1] - motion_fit(row[0])[2]
              for row in tdata.MOTION_SUITE}
    assert abs(float(np.mean(list(deltas.values())))) <= 0.75, deltas


if __name__ == "__main__":
    deltas = []
    for row in tdata.MOTION_SUITE:
        counts, err, golden_err, golden_n = motion_fit(row[0])
        deltas.append(err - golden_err)
        print(f"{row[0]:10s} motions {counts} (golden {golden_n}) "
              f"misclassification {err:.3f}% (golden {golden_err:.3f}%) "
              f"delta {deltas[-1]:+.3f} pp")
    print(f"suite mean delta {np.mean(deltas):+.3f} pp, worst "
          f"{max(deltas, key=abs):+.3f} pp, on "
          f"{'cuda' if torch.cuda.is_available() else 'cpu'}")
