"""The port's utils/viz.py against the JAX package's multih_tpu/utils/viz.py
on the same inputs, byte for byte: blank canvases sized from the points,
and the labels drawn on grey and colour images. Needs OpenCV on the
host and skips without it. No JAX compile (the reference's module is
numpy and cv2).
"""

import numpy as np
import pytest

from multih_tpu.utils import viz as jviz
from multih_tpu_torch.utils import data as tdata
from multih_tpu_torch.utils import viz as tviz

cv2 = pytest.importorskip("cv2")


@pytest.fixture(scope="module")
def labelled():
    """A 3-plane scene's points with labels 0..2, outliers at 16 and two
    labels past the palette's 16 colours (wrapped)."""
    cs, _ = tdata.synthetic_scene(180, 3, 0.2, 0.5, seed=6)
    labels = np.where(cs.gt_labels > 0, cs.gt_labels - 1, 16).astype(np.int32)
    labels[:2] = (17, 33)
    return cs.x1, cs.x2, labels


def images(kind):
    rng = np.random.default_rng(1)
    if kind == "none":
        return None, None
    shape = (480, 640) if kind == "grey" else (500, 600, 3)
    return tuple(rng.integers(0, 255, shape, dtype=np.uint8)
                 for _ in range(2))


@pytest.mark.parametrize("kind", ["none", "grey", "colour"])
def test_draw_labels_equals_reference(labelled, kind):
    x1, x2, labels = labelled
    img1, img2 = images(kind)
    got = tviz.draw_labels(x1, x2, labels, 16, img1, img2)
    want = jviz.draw_labels(x1, x2, labels, 16, img1, img2)
    assert got.dtype == want.dtype == np.uint8
    assert got.shape == want.shape and got.tobytes() == want.tobytes()
    if img1 is not None:
        assert got.shape[:2] == (img1.shape[0], 2 * img1.shape[1])


def test_draw_labels_no_points():
    got = tviz.draw_labels(np.zeros((0, 2)), np.zeros((0, 2)),
                           np.zeros((0,), np.int32), 4)
    assert got.shape == (480, 1280, 3)
    assert got.tobytes() == jviz.draw_labels(
        np.zeros((0, 2)), np.zeros((0, 2)), np.zeros((0,), np.int32),
        4).tobytes()


def test_save_labels_figure_equals_reference(labelled, tmp_path):
    x1, x2, labels = labelled
    a, b = str(tmp_path / "port.png"), str(tmp_path / "ref.png")
    assert tviz.save_labels_figure(a, x1, x2, labels, 16) == a
    jviz.save_labels_figure(b, x1, x2, labels, 16)
    assert open(a, "rb").read() == open(b, "rb").read()
