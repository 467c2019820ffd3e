"""The port's CLI (multih_tpu_torch/cli.py) through `main([...])` on the
CPU (`--device cpu`): fit, synth, bench-adelaide and stream at small
sizes, the refusal of what is not ported, and no quiet CPU fallback.
"""

import json

import numpy as np
import pytest
import torch
from scipy.io import savemat

import torch_mesh_ranks
from multih_tpu_torch import cli
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


@pytest.mark.parametrize("argv", [
    ["synth", "--aot"],
    ["synth", "--save-viz", "out.png"],
    ["fit-images", "a.png", "b.png", "--save-viz", "out.png"],
    ["stream", "synth", "--model", "mixed"],
], ids=["aot", "save_viz", "fit_images", "stream_mixed"])
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
