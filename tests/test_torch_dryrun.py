"""tools/torch_dryrun_multichip.py, the port's counterpart of
``__graft_entry__.py::dryrun_multichip``, on 2 gloo CPU ranks: every
mesh path ('pair' and pair x hyp batches, sharded verification, the
hyp-sharded F fit, the 'pt' homography and F fits, the pair-sharded mixed
fit) at the reference's tiny shapes, each asserted in the ranks on known
synthetic labels (~6 s)."""

import os
import sys

import torch

torch.set_num_threads(1)

# the spawned ranks import the tool's rank function by its module name,
# through this process's sys.path
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import torch_dryrun_multichip  # noqa: E402


def test_dryrun_multichip_on_two_cpu_ranks():
    out = torch_dryrun_multichip.run(2, "cpu", timeout_s=300.0)
    assert out["backend"] == "gloo" and out["ranks"] == 2
    assert len(out["pair"]) == 2 and max(out["pair"]) < 5.0
    assert len(out["pair_hyp"]) == 1 and out["pair_hyp"][0] < 5.0
    assert out["verify_top"] == 64
    for key in ("hyp_f", "pt_f"):
        assert out[key]["motions"] == 2 and out[key]["error"] < 5.0
    assert out["pt"] < 5.0
    assert len(out["mixed"]) == 2 and max(out["mixed"]) < 10.0
