"""Streaming stereo fitting: per-frame multi-plane recovery under a
real-time budget (30 fps -> 33.3 ms a frame).

Counterpart of ``multih_tpu/utils/streaming.py``. The stream sources
(`SyntheticStream`, a temporally coherent multi-plane sequence, and
`DirectoryStream`, a directory of correspondence files) and
`StreamStats` are numpy copies of the reference's. `run_stream` fits
every frame with the port's `fit`, warm-started from the previous
frame's planes (`make_fit_seeded`).

PyTorch runs eagerly, so the reference's asynchronous jit dispatch has
no counterpart. On the card the port's form of pipelining is: frames
padded on the host into pinned buffers, each uploaded with
``non_blocking=True`` on a side CUDA stream that the compute stream
waits on through an event ("stream" upload), and up to
`pipeline_depth` frames enqueued before the oldest one is waited on
(through a CUDA event recorded after its fit). The fit's own host
syncs bound how far the host runs ahead.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import os
import time
from typing import Iterator

import numpy as np
import torch

from multih_tpu_torch.config import MultiHConfig
from multih_tpu_torch.models import pipeline
from multih_tpu_torch.utils import data

_LOG = logging.getLogger(__name__)


class SyntheticStream:
    """Temporally coherent synthetic stereo stream: the planes'
    homographies drift smoothly frame to frame."""

    def __init__(self, n_frames=100, n_points=500, n_planes=3,
                 outlier_rate=0.15, noise_px=0.5, seed=0,
                 drift: float = 0.01):
        self.n_frames = n_frames
        self.rng = np.random.default_rng(seed)
        self.noise_px = noise_px
        self.drift = drift
        base, self._Hs = data.synthetic_scene(
            n_points, n_planes, outlier_rate, noise_px, seed=seed
        )
        self._x1 = base.x1
        self._gt = base.gt_labels

    def __iter__(self) -> Iterator[data.CorrespondenceSet]:
        Hs = self._Hs.copy().astype(np.float64)
        n = self._x1.shape[0]
        x1h = np.concatenate([self._x1, np.ones((n, 1), np.float32)], 1)
        for f in range(self.n_frames):
            # drift the plane homographies smoothly (camera/scene motion)
            for p in range(len(Hs)):
                Hs[p] = Hs[p] + self.rng.normal(
                    0, self.drift, (3, 3)
                ) * np.abs(Hs[p])
            x2 = np.zeros_like(self._x1)
            for p in range(len(Hs)):
                sel = self._gt == p + 1
                y = x1h[sel] @ Hs[p].T
                x2[sel] = (y[:, :2] / y[:, 2:]).astype(np.float32)
            out = self._gt == 0
            x2[out] = self.rng.uniform(
                0, 640, (int(out.sum()), 2)
            ).astype(np.float32)
            x2 = x2 + self.rng.normal(
                0, self.noise_px, x2.shape
            ).astype(np.float32)
            yield data.CorrespondenceSet(
                self._x1, x2, self._gt, f"frame{f:05d}"
            )


class DirectoryStream:
    """Stream of correspondence files (text 'x y x2 y2 [label]' or .mat),
    sorted by name, e.g. precomputed per-frame stereo matches.

    Malformed or unreadable frames are skipped with a warning, and their
    paths kept in `skipped`, rather than ending the stream."""

    def __init__(self, root: str):
        self.paths = sorted(
            os.path.join(root, f) for f in os.listdir(root)
            if f.endswith((".txt", ".mat"))
        )
        self.skipped: list[str] = []

    def __iter__(self):
        for p in self.paths:
            try:
                if p.endswith(".mat"):
                    cs = data.load_adelaide_mat(p)
                else:
                    cs = data.load_correspondences_txt(p)
                if cs.n_points < 8 or not np.isfinite(cs.x1).all() \
                        or not np.isfinite(cs.x2).all():
                    raise ValueError("too few points or non-finite values")
            except Exception as e:  # noqa: BLE001 — the stream survives
                self.skipped.append(p)
                _LOG.warning("skipping malformed frame %s: %s", p, e)
                continue
            yield cs


@dataclasses.dataclass
class StreamStats:
    frames: int
    mean_ms: float       # blocked per-frame latency (pass 1)
    p50_ms: float
    p95_ms: float
    max_ms: float
    fps: float            # sustained throughput at the given pipeline depth
    mean_planes: float
    budget_ms: float
    frames_over_budget: int

    def meets_budget(self) -> bool:
        # real-time means sustaining the frame rate; per-frame latency is
        # reported separately (p95)
        return self.fps >= 1e3 / self.budget_ms


def _uploader(host_frames, dev: torch.device, upload: str):
    """frame index -> (x1, x2, valid) on `dev`. On the CPU the padded
    arrays are wrapped as they are. On the card: "preload" uploads every
    frame now; "stream" pins the host buffers now and copies each frame
    when asked, on a side stream the current stream waits on."""
    host = [tuple(torch.from_numpy(a) for a in hf) for hf in host_frames]
    if dev.type != "cuda":
        return lambda i: host[i]
    if upload == "preload":
        on_dev = [tuple(t.to(dev) for t in hf) for hf in host]
        torch.cuda.synchronize(dev)
        return lambda i: on_dev[i]
    pinned = [tuple(t.pin_memory() for t in hf) for hf in host]
    side = torch.cuda.Stream(dev)

    def get(i):
        compute = torch.cuda.current_stream(dev)
        with torch.cuda.stream(side):
            frame = tuple(t.to(dev, non_blocking=True) for t in pinned[i])
        compute.wait_event(side.record_event())
        for t in frame:
            t.record_stream(compute)
        return frame

    return get


def _done(dev: torch.device):
    """A handle whose wait() returns once the work enqueued so far on
    the current stream has finished (nothing to wait for on the CPU)."""
    if dev.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record()
    return ev


def _wait(handle) -> None:
    if handle is not None:
        handle.synchronize()


def run_stream(
    stream,
    cfg: MultiHConfig | None = None,
    budget_ms: float = 33.3,
    seed: int = 0,
    pipeline_depth: int = 3,
    warm_start: bool = True,
    upload: str = "stream",
    device=None,
) -> StreamStats:
    """Fit every frame of `stream` (utils/streaming.py:126).

    With ``warm_start`` (default) each frame's hypothesis pool is seeded
    with the previous frame's homographies, valid where that fit kept
    them active (`make_fit_seeded`); the first frame's seeds are
    identities masked off. Frames with more than cfg.max_points points
    are skipped with a warning. The frames run on `device`, by default
    the card; ``upload`` is "stream" (each frame copied as it is
    consumed, see the module docstring) or "preload" (every frame on the
    card before timing). Draws come from a ``torch.Generator`` on that
    device seeded with `seed` (pass 2: seed + 104729).

    A first untimed frame warms the kernels (library load, allocator).
    Pass 1 times each frame blocked (upload, fit, wait) for the latency
    statistics; pass 2 keeps up to `pipeline_depth` frames in flight
    for the sustained fps."""
    if upload not in ("stream", "preload"):
        raise ValueError(f"upload {upload!r}")
    cfg = cfg or MultiHConfig(max_points=512, n_hypotheses=1024)
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "stream on the CPU")

    host_frames = []
    for cs in stream:
        if cs.n_points > cfg.max_points:
            _LOG.warning("skipping frame %s: %d points > max_points=%d",
                         cs.name, cs.n_points, cfg.max_points)
            continue
        host_frames.append(pipeline.pad_points(cs.x1, cs.x2, None,
                                               cfg.max_points))
    if not host_frames:
        return StreamStats(0, 0, 0, 0, 0, 0, 0, budget_ms, 0)
    frame = _uploader(host_frames, dev, upload)

    if warm_start:
        f_seeded = pipeline.make_fit_seeded(cfg, dev)
        seeds0 = torch.eye(3, device=dev).expand(cfg.max_labels, 3, 3)
        ok0 = torch.zeros((cfg.max_labels,), device=dev)

        def f(x1, x2, valid, gen, prev):
            if prev is None:
                return f_seeded(x1, x2, valid, gen, seeds0, ok0)
            return f_seeded(x1, x2, valid, gen, prev.homographies,
                            prev.active)
    else:
        f_cold = pipeline.make_fit(cfg, dev)

        def f(x1, x2, valid, gen, prev):
            return f_cold(x1, x2, valid, gen)

    def generator(s):
        return torch.Generator(device=dev).manual_seed(s)

    f(*frame(0), generator(seed), None)  # the untimed warm-up frame
    _wait(_done(dev))

    # pass 1: blocked per-frame latency, upload included in stream mode
    gen = generator(seed)
    times, prev = [], None
    for i in range(len(host_frames)):
        t0 = time.perf_counter()
        prev = f(*frame(i), gen, prev)
        _wait(_done(dev))
        times.append(time.perf_counter() - t0)

    # pass 2: sustained throughput, pipeline_depth frames in flight
    gen = generator(seed + 104729)
    inflight = collections.deque()
    results, prev = [], None
    t0 = time.perf_counter()
    for i in range(len(host_frames)):
        prev = f(*frame(i), gen, prev)
        inflight.append((prev, _done(dev)))
        while len(inflight) >= max(1, pipeline_depth):
            res, done = inflight.popleft()
            _wait(done)
            results.append(res)
    while inflight:
        res, done = inflight.popleft()
        _wait(done)
        results.append(res)
    wall = time.perf_counter() - t0
    planes = [float(r.active.sum()) for r in results]

    times_ms = np.asarray(times) * 1e3
    return StreamStats(
        frames=len(planes),
        mean_ms=float(times_ms.mean()),
        p50_ms=float(np.percentile(times_ms, 50)),
        p95_ms=float(np.percentile(times_ms, 95)),
        max_ms=float(times_ms.max()),
        fps=float(len(host_frames) / wall) if wall > 0 else 0.0,
        mean_planes=float(np.mean(planes)),
        budget_ms=budget_ms,
        frames_over_budget=int((times_ms > budget_ms).sum()),
    )
