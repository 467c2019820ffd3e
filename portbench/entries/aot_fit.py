"""`utils/aot.cached_fit(cfg, "fit")`: the fit captured once as a CUDA
graph and replayed, the `--aot` user's path. One pair a call; the pair
draws from a generator seeded with the call's seed."""

from __future__ import annotations

import torch

from multih_tpu_torch.utils import aot


class AotFit:
    captured = True

    def __init__(self, cfg, device):
        self.fn = aot.cached_fit(cfg, "fit", device=device)
        self.gen = torch.Generator(device=device)

    def __call__(self, pairs, seed: int):
        (_, x1, x2, valid), = pairs
        res = self.fn(x1, x2, valid, self.gen.manual_seed(seed))
        return [(res.labels.cpu().numpy(), res.homographies.cpu().numpy(),
                 res.active.cpu().numpy())]


def make(cfg, device, traffic):
    return AotFit(cfg, device)
