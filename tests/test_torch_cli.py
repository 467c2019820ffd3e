"""The port's CLI (multih_tpu_torch/cli.py) through `main([...])` on the
CPU (`--device cpu`): fit, synth, bench-adelaide and stream at small
sizes, --aot for the three models, --save-viz, the refusal of stream
--model mixed (as the JAX CLI refuses it), and no quiet CPU fallback.
"""

import json
import sys

import numpy as np
import pytest
import torch
from scipy.io import savemat

import torch_mesh_ranks
from multih_tpu_torch import cli
from test_torch_features import planar_pair  # noqa: F401  (a fixture)
from multih_tpu_torch.parallel import mesh as tmesh
from multih_tpu_torch.utils import data as tdata

torch.set_num_threads(1)

SMALL = ["--device", "cpu", "--hypotheses", "256", "--max-labels", "8"]


def last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_synth_json(capsys):
    cli.main(["synth", "--points", "200", "--json", *SMALL])
    out = last_json(capsys)
    assert out["n_points"] == 200 and out["n_planes_found"] == 2
    assert out["misclassification_pct"] < 5.0
    assert np.asarray(out["homographies"]).shape == (2, 3, 3)
    assert out["time_warm_s"] > 0


def test_synth_text_restarts_and_labels(capsys, tmp_path):
    path = tmp_path / "labels.txt"
    cli.main(["synth", "--points", "150", "--restarts", "2",
              "--save-labels", str(path), *SMALL])
    text = capsys.readouterr().out
    assert "planes found: 2" in text and "H[1] =" in text
    labels = np.loadtxt(path, dtype=int)
    assert labels.shape == (150,) and labels.max() <= 8


def test_synth_adaptive_tau(capsys):
    cli.main(["synth", "--points", "200", "--noise", "1.0", "--json",
              "--adaptive-tau", "--restarts", "2", *SMALL])
    out = last_json(capsys)
    assert 3.0 <= out["tau"] <= 12.0 and out["n_planes_found"] >= 1


@pytest.mark.parametrize("model", ["fundamental", "mixed"])
def test_synth_other_models(capsys, model):
    cli.main(["synth", "--points", "200", "--model", model, "--json",
              "--residual", "sampson" if model == "fundamental"
              else "symmetric", *SMALL])
    out = last_json(capsys)
    assert out["n_points"] == 200
    if model == "mixed":
        assert out["n_planes_found"] + out["n_motions_found"] >= 2
        assert len(out["model_kinds"]) == len(out["models"])
    else:
        assert out["n_planes_found"] >= 1


def test_fit_text_file(capsys, tmp_path):
    cs, _ = tdata.synthetic_scene(180, 2, 0.1, 0.5, seed=4)
    path = tmp_path / "pair.txt"
    tdata.save_correspondences_txt(str(path), cs)
    cli.main(["fit", str(path), "--json", *SMALL])
    out = last_json(capsys)
    assert out["n_points"] == 180 and out["n_planes_found"] == 2


def write_adelaide(path, cs):
    """An AdelaideRMF-style .mat: data 6xN [x; y; 1; x'; y'; 1], label N
    (0 = outlier)."""
    one = np.ones((1, cs.n_points))
    data = np.concatenate([cs.x1.T, one, cs.x2.T, one]).astype(np.float64)
    savemat(str(path), {"data": data, "label": cs.gt_labels[None, :]})


def test_bench_adelaide(capsys, tmp_path):
    for name, seed, n in (("johnsona", 1, 150), ("neem", 2, 110)):
        cs, _ = tdata.synthetic_scene(n, 2, 0.1, 0.5, seed=seed)
        write_adelaide(tmp_path / f"{name}.mat", cs)
    (tmp_path / "other.mat").write_bytes(b"")  # not one of the 19 pairs
    cli.main(["bench-adelaide", str(tmp_path), *SMALL])
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    rows, summary = lines[:-1], lines[-1]["summary"]
    assert [r["name"] for r in rows] == ["johnsona", "neem"]
    assert [r["n_points"] for r in rows] == [150, 110]
    for r in rows:
        assert r["n_planes_found"] == 2 and r["misclassification_pct"] < 5
    assert summary["pairs"] == 2 and summary["devices"] == 1
    assert summary["mean_misclassification_pct"] < 5
    assert summary["batch_wall_s_warm"] > 0


def test_bench_adelaide_on_two_ranks(capsys, tmp_path):
    """bench-adelaide in a process group of 2 gloo CPU ranks (as under
    torchrun): the pairs split over the ranks, only rank 0 prints, its
    rows are the single-process run's and "devices" is the world size."""
    for name, seed, n in (("johnsona", 1, 150), ("neem", 2, 110),
                          ("oldclassicswing", 3, 90)):
        cs, _ = tdata.synthetic_scene(n, 2, 0.1, 0.5, seed=seed)
        write_adelaide(tmp_path / f"{name}.mat", cs)
    argv = ["bench-adelaide", str(tmp_path), *SMALL]
    printed = tmesh.spawn(torch_mesh_ranks.cli_rank, 2, "gloo",
                          lambda r: "cpu", 90.0, args=(argv,))
    assert printed[1] == ""
    lines = [json.loads(s) for s in printed[0].splitlines()]
    cli.main(argv)
    alone = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert lines[:-1] == alone[:-1] and len(lines) == 4
    summary = lines[-1]["summary"]
    assert summary["devices"] == 2 and alone[-1]["summary"]["devices"] == 1
    assert summary["mean_misclassification_pct"] == \
        alone[-1]["summary"]["mean_misclassification_pct"]


def test_bench_adelaide_empty_dir(tmp_path):
    with pytest.raises(SystemExit) as e:
        cli.main(["bench-adelaide", str(tmp_path), *SMALL])
    assert e.value.code != 0


def test_stream_synth(capsys):
    cli.main(["stream", "synth", "--frames", "2", "--pipeline-depth", "1",
              "--json", *SMALL])
    out = last_json(capsys)
    assert out["frames"] == 2 and out["mean_planes"] > 1.0
    assert out["budget_ms"] == 33.3


@pytest.mark.parametrize("how,model", [
    ("flag", "homography"), ("env", "homography"), ("flag", "fundamental"),
    ("flag", "mixed")], ids=["flag", "env", "fundamental", "mixed"])
def test_synth_aot_cpu_equals_plain(capsys, tmp_path, monkeypatch, how,
                                    model):
    """--aot (or MULTIH_AOT=1) on --device cpu is the plain fit
    (aot.cached_fit and cached_fit_mixed return the makers there): the
    same JSON but for the timings, and the same labels, as the run
    without it, for each model."""
    def run(aot, path):
        argv = ["synth", "--points", "200", "--json", "--save-labels",
                str(path), "--model", model, *SMALL]
        if aot and how == "flag":
            argv.append("--aot")
        if aot and how == "env":
            monkeypatch.setenv("MULTIH_AOT", "1")
        else:
            monkeypatch.delenv("MULTIH_AOT", raising=False)
        cli.main(argv)
        return last_json(capsys), np.loadtxt(path, dtype=int)

    (plain, lab_plain), (aot, lab_aot) = (
        run(False, tmp_path / "plain.txt"), run(True, tmp_path / "aot.txt"))
    assert aot.keys() == plain.keys()
    for key in plain:
        if not key.startswith("time_"):
            assert aot[key] == plain[key], key
    np.testing.assert_array_equal(lab_aot, lab_plain)
    assert plain["n_planes_found"] == 2


@pytest.mark.parametrize("model", ["homography", "mixed"])
def test_synth_save_viz(tmp_path, capsys, model):
    """--save-viz writes the labelled points side by side as a PNG (two
    blank canvases, one colour a label, grey outliers)."""
    cv2 = pytest.importorskip("cv2")
    path = tmp_path / "viz.png"
    cli.main(["synth", "--points", "200", "--model", model, "--json",
              "--save-viz", str(path), *SMALL])
    assert last_json(capsys)["n_points"] == 200
    img = cv2.imread(str(path))
    assert img is not None and img.ndim == 3 and img.shape[2] == 3
    colours = {tuple(c) for c in img.reshape(-1, 3)[::7].tolist()}
    assert len(colours - {(255, 255, 255)}) >= 3


def test_fit_images_save_viz(planar_pair, tmp_path, capsys):
    """fit-images --use-affines --save-viz draws the labels on the two
    images side by side."""
    cv2 = pytest.importorskip("cv2")
    paths = [str(tmp_path / f"{n}.png") for n in ("a", "b")]
    for p, img in zip(paths, planar_pair):
        assert cv2.imwrite(p, img)
    viz = tmp_path / "viz.png"
    cli.main(["fit-images", *paths, "--ratio", "0.9", "--use-affines",
              "--json", "--device", "cpu", "--hypotheses", "512",
              "--save-viz", str(viz)])
    assert last_json(capsys)["n_planes_found"] >= 1
    img = cv2.imread(str(viz))
    h, w = planar_pair[0].shape
    assert img.shape == (h, 2 * w, 3)


def test_save_viz_without_cv2_exits_2(tmp_path, capsys, monkeypatch):
    """Where OpenCV does not import, --save-viz exits 2 before fitting."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(SystemExit) as e:
        cli.main(["synth", "--points", "100", "--save-viz",
                  str(tmp_path / "viz.png"), *SMALL])
    assert e.value.code == 2
    assert "OpenCV" in capsys.readouterr().err
    assert not (tmp_path / "viz.png").exists()


@pytest.mark.parametrize("argv", [
    ["stream", "synth", "--model", "mixed"],
], ids=["stream_mixed"])
def test_not_ported_exits_nonzero(argv, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(argv + ["--device", "cpu"])
    assert e.value.code not in (0, None)
    assert capsys.readouterr().err.strip()


@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA card exists")
def test_no_card_raises_without_device_cpu():
    """The card is the default and the CPU is never taken quietly."""
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["synth", "--points", "100", "--hypotheses", "256"])
