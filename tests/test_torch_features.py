"""The port's OpenCV front end (utils/features.detect_and_match) against
the JAX package's, and the port CLI's ``fit-images`` on the CPU.

The synthetic planar pair of tests/test_streaming_features.py: a blurred
random texture and its warp by a known homography. Both need OpenCV on
the host and skip without it.
"""

import json

import numpy as np
import pytest
import torch

from multih_tpu.utils import features as jfeat

from multih_tpu_torch import cli
from multih_tpu_torch.utils import features as tfeat

torch.set_num_threads(1)

H_PAIR = np.array([[1.0, 0.02, 5.0], [-0.02, 1.0, 3.0], [0, 0, 1.0]])


@pytest.fixture(scope="module")
def planar_pair():
    """(img1, img2) uint8 (240, 320): the texture and its warp."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(0)
    img1 = (rng.uniform(0, 255, (240, 320)) > 200).astype(np.uint8) * 255
    img1 = cv2.GaussianBlur(img1, (5, 5), 1.0)
    return img1, cv2.warpPerspective(img1, H_PAIR, (320, 240))


def test_detect_and_match_equals_reference(planar_pair):
    """The same matches, points and affine frames, byte for byte, and the
    matches explain the warp."""
    img1, img2 = planar_pair
    want, a_want = jfeat.detect_and_match(img1, img2, ratio=0.9)
    got, a_got = tfeat.detect_and_match(img1, img2, ratio=0.9)
    assert got.n_points == want.n_points >= 8
    for a, b in ((got.x1, want.x1), (got.x2, want.x2), (a_got, a_want)):
        assert a.dtype == b.dtype == np.float32
        assert a.tobytes() == b.tobytes()
    y = np.concatenate([got.x1, np.ones((got.n_points, 1))], 1) @ H_PAIR.T
    err = np.linalg.norm(y[:, :2] / y[:, 2:] - got.x2, axis=1)
    assert np.median(err) < 3.0


def test_cli_fit_images(planar_pair, tmp_path, capsys):
    """`multih-torch fit-images a.png b.png --use-affines --json` on the
    CPU: the matched points, one H a match joining the pool, and the
    pair's one plane found."""
    cv2 = pytest.importorskip("cv2")
    paths = [str(tmp_path / f"{n}.png") for n in ("a", "b")]
    for p, img in zip(paths, planar_pair):
        assert cv2.imwrite(p, img)
    cli.main(["fit-images", *paths, "--ratio", "0.9", "--use-affines",
              "--json", "--device", "cpu", "--hypotheses", "512",
              "--save-labels", str(tmp_path / "labels.txt")])
    cap = capsys.readouterr()
    out = json.loads(cap.out.strip().splitlines()[-1])
    want, _ = jfeat.detect_and_match(*planar_pair, ratio=0.9)
    assert out["n_points"] == want.n_points
    assert f"matched {want.n_points} correspondences" in cap.err
    assert out["n_planes_found"] >= 1
    labels = np.loadtxt(tmp_path / "labels.txt")
    assert labels.shape == (want.n_points,)
