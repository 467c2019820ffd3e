"""Faults planted in the timed path's outputs, where they are produced,
to read the numbers of `correct` against (portbench/calibrate.py) and
to see `correct` come out false (the tests): the fit's state returned as
it starts, answers altered (labels, models). The cells fit one pair a
call, so no batch can lose half its pairs.
"""

from __future__ import annotations

import numpy as np

FAULTS = ("state_unchanged", "labels_altered", "models_altered")


class Broken:
    """An entry whose outputs are broken by `fault`."""

    def __init__(self, entry, fault: str):
        if fault not in FAULTS:
            raise KeyError(fault)
        self.entry, self.fault = entry, fault
        self.captured = entry.captured

    def __call__(self, pairs, seed):
        return [self._break(*o) for o in self.entry(pairs, seed)]

    def _break(self, labels, models, active):
        labels, models, active = labels.copy(), models.copy(), active.copy()
        k = active.shape[0]
        if self.fault == "state_unchanged":
            # the fit's state as it starts: no model, every point an outlier
            return (np.full_like(labels, k), np.zeros_like(models),
                    np.zeros_like(active))
        if self.fault == "labels_altered":
            # every other member of each model handed to the next model
            used = np.unique(labels[labels < k])
            if used.size > 1:
                nxt = dict(zip(used, np.roll(used, -1)))
                idx = np.flatnonzero(labels < k)[::2]
                labels[idx] = [nxt[x] for x in labels[idx]]
            return labels, models, active
        # models_altered: each model nudged by 1e-3 of its norm
        rng = np.random.default_rng(0)
        for m in range(k):
            n = np.linalg.norm(models[m])
            models[m] = models[m] + 1e-3 * n * rng.normal(size=(3, 3))
        return labels, models, active
