"""The homography fit captured once as a CUDA graph, and the kernel library
that outlives a process.

Counterpart of ``multih_tpu/utils/aot.py``. The reference exports the
jitted fit (``jax.export``) so that a later process skips Python tracing;
``cached_fit(cfg, kind)`` returns one program per (config, kind) at the
config's static shapes, with the jitted maker's signature and results.
The port runs eagerly and has no program to export, so its counterparts
are these:

- within a process, a ``torch.cuda.CUDAGraph`` that holds the whole fit
  of one kind (`CapturedFit`): warmed up eagerly once on a side stream,
  captured once, and replayed on every call, so that a fit costs one
  graph launch instead of thousands of eager launches (every fit is
  bound by the host: the device is idle most of its wall time);
- across processes, the nvcc-built kernel library (`export_fit`, which
  builds it into the cache root's host-keyed directory,
  ``ops/kernels/_build.py`` and ``utils/cache.py``). Nothing else
  outlives a process.

Usage (the CLI wires this behind ``--aot`` / MULTIH_AOT=1):

    fn = aot.cached_fit(cfg, kind="fit")   # captured on the first call
    res = fn(x1, x2, valid, torch.Generator("cuda").manual_seed(0))

The homography model's four kinds are captured: ``fit``, ``fit_tau``,
``fit_seeded`` and ``fit_adaptive``. The fundamental model is not: its
fit branches on the host (``models/pipeline.py:999``, the accept of
``_f_refine_phases``). A capture that
fails raises, naming the operation; it never falls back to the eager fit.
"""

from __future__ import annotations

import hashlib
import os
import time
import traceback

import numpy as np
import torch

from multih_tpu_torch.ops.kernels import _build

# bump when the captured program's meaning changes without a config or
# torch change
_STAMP = "aot-torch-v1"

KINDS = ("fit", "fit_tau", "fit_seeded", "fit_adaptive")
# the arguments after (x1, x2, valid, key) of each kind
_EXTRA = {"fit": (), "fit_tau": ("tau",), "fit_seeded": ("seed_Hs",
                                                         "seed_ok"),
          "fit_adaptive": ()}

# one capture per (key, card) in a process
_CAPTURED: dict = {}


def _check(cfg, kind: str) -> None:
    if kind not in KINDS:
        raise ValueError(f"kind {kind!r} not in {KINDS}")
    if cfg.model != "homography":
        raise NotImplementedError(
            f"cached_fit captures the homography model only: the "
            f"{cfg.model} fit branches on the host (models/pipeline.py:999, "
            f"`if bool(e_j < e_c)` in _f_refine_phases' accept), which a "
            f"CUDA graph cannot capture")


def _maker(cfg, kind: str, device=None):
    from multih_tpu_torch.models import pipeline

    return {
        "fit": pipeline.make_fit,
        "fit_tau": pipeline.make_fit_tau,
        "fit_seeded": pipeline.make_fit_seeded,
        "fit_adaptive": pipeline.make_fit_adaptive,
    }[kind](cfg, device=device)


def _device(device) -> torch.device:
    """The card unless the caller asks for another device; never a quiet
    fallback to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to fit on "
                               "the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _device_kind(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" \
        else dev.type


def cache_key(cfg, kind: str, device=None) -> str:
    """24-hex-char key of one captured program: the stamp, torch's
    version and CUDA version, the device kind, the fit kind and the
    config (whose fields fix every shape)."""
    sig = "|".join([_STAMP, torch.__version__, str(torch.version.cuda),
                    _device_kind(_device(device)), kind, repr(cfg)])
    return hashlib.sha256(sig.encode()).hexdigest()[:24]


def default_cache_dir() -> str:
    """The cache root of the kernel library: MULTIH_AOT_CACHE, else the
    one the kernels build into by default (build/multih_tpu_torch at the
    repository root)."""
    return os.environ.get("MULTIH_AOT_CACHE", str(_build.BUILD_ROOT))


def export_fit(cfg, kind: str = "fit", cache_dir: str | None = None) -> str:
    """Build the kernel library into the cache root's host-keyed
    directory (unless it is there) and load it. Returns the library's
    path. The process's first load picks its library: after another
    root's load, that one's path is returned."""
    _check(cfg, kind)
    _build.load(cache_dir or default_cache_dir())
    return str(_build.build_report()[2])


def cached_fit(cfg, kind: str = "fit", cache_dir: str | None = None,
               save_on_miss: bool = True, device=None):
    """The fit of `kind` with cfg bound, on the card captured as one CUDA
    graph (`CapturedFit`, one per config, kind and card in a process):
    the same signature as the maker's, f(x1, x2, valid, key[, tau |
    seed_Hs, seed_ok]), and, given a generator in the same state, the
    same results, which are the graph's outputs cloned. The kernel
    library comes from `cache_dir` (`default_cache_dir()`), built there
    first with `save_on_miss`, else taken from there only if it is
    built and otherwise from the default root. device="cpu" returns the
    plain maker (the CPU has no graphs). cfg.model="fundamental" raises
    NotImplementedError."""
    _check(cfg, kind)
    dev = _device(device)
    if dev.type != "cuda":
        return _maker(cfg, kind, device=dev)
    root = cache_dir or default_cache_dir()
    if save_on_miss:
        export_fit(cfg, kind, root)
    else:
        _build.load(root if _build.library_path(root).exists() else None)
    key = (cache_key(cfg, kind, dev), dev.index)
    if key not in _CAPTURED:
        _CAPTURED[key] = CapturedFit(cfg, kind, dev)
    return _CAPTURED[key]


def _launches() -> dict:
    """Every kernel wrapper's launch count, by kernel name."""
    from multih_tpu_torch.ops.kernels import (dlt_kernel, eig_kernel,
                                              gather_kernel, mrf_kernel,
                                              residual_kernel)

    return {
        "inlier_counts": residual_kernel.inlier_counts_padded.launches,
        "dlt_4pt": dlt_kernel.homography_4pt_gt.launches,
        "eig9_smallest": eig_kernel.smallest_eigvec_9x9_batch.launches,
        "mean_field_fused": mrf_kernel.mean_field_fused.launches,
        "icm_fused": mrf_kernel.icm_fused.launches,
        "mean_field_fused_front": mrf_kernel.mean_field_fused_front.launches,
        "band_list": mrf_kernel.band_list.launches,
        "window_gather": gather_kernel.window_gather.launches,
    }


def _clone(out):
    if isinstance(out, torch.Tensor):
        return out.clone()
    if hasattr(out, "_fields"):
        return type(out)(*(_clone(x) for x in out))
    return tuple(_clone(x) for x in out)


def _where(e: BaseException) -> str:
    """The operation a failed capture stopped at: the innermost frame of
    the port (outside this module) in the first error of e's chain (the
    capture's end may raise again over it), with that error."""
    chain = []
    while e is not None and all(e is not c for c in chain):
        chain.append(e)
        e = e.__cause__ or e.__context__
    for err in reversed(chain):
        frames = [f for f in traceback.extract_tb(err.__traceback__)
                  if f"{os.sep}multih_tpu_torch{os.sep}" in f.filename
                  and not f.filename.endswith(f"utils{os.sep}aot.py")]
        if frames:
            f = frames[-1]
            return (f"{f.filename}:{f.lineno} ({f.name}: {f.line}): "
                    f"{type(err).__name__}: {err}")
    return f"{type(chain[-1]).__name__}: {chain[-1]}"


class CapturedFit:
    """One fit kind at one config, captured as a CUDA graph on a card.

    Static inputs, allocated once: x1, x2 (max_points, 2) float32, valid
    (max_points,), a 0-dim tau, seed_Hs (max_labels, 3, 3) and seed_ok
    (max_labels,). A call copies its arguments in (`copy_`, outside the
    capture: numpy, CPU or CUDA input; a number for tau) and raises
    ValueError on any other shape. The first call warms the fit up
    eagerly on a side stream (the kernel library, the kernels' occupancy
    queries, the cuBLAS workspace) and captures it with
    ``torch.cuda.graph`` on that stream; every call then replays it.

    Random draws come from a CUDA generator the object owns, registered
    with the graph: before a replay it takes the caller's generator's
    state, after it the caller's generator takes the advanced state
    back, so a replay draws what the eager fit draws from that state and
    leaves the caller's generator where the eager fit leaves it. The
    result is a clone of the graph's outputs (the next replay overwrites
    them).

    After the capture: `warmup_s` and `capture_s` (host seconds),
    `pool_bytes` (the graph's private memory pool, None where the
    allocator's snapshot does not say), `launches` (each kernel's
    launches captured, which every replay makes)."""

    def __init__(self, cfg, kind: str, device: torch.device):
        self.cfg, self.kind, self.device = cfg, kind, device
        n, k = cfg.max_points, cfg.max_labels
        f32 = dict(dtype=torch.float32, device=device)
        self.x1 = torch.zeros((n, 2), **f32)
        self.x2 = torch.zeros((n, 2), **f32)
        self.valid = torch.zeros((n,), **f32)
        self.tau = torch.full((), cfg.inlier_threshold, **f32)
        self.seed_Hs = torch.zeros((k, 3, 3), **f32)
        self.seed_ok = torch.zeros((k,), **f32)
        self.generator = torch.Generator(device=device)
        self.graph = None
        self.out = None
        self.warmup_s = self.capture_s = None
        self.pool_bytes = None
        self.launches = None
        self._fn = _maker(cfg, kind, device=device)

    def _static(self):
        return [self.x1, self.x2, self.valid] + [
            getattr(self, name) for name in _EXTRA[self.kind]]

    def _args(self):
        s = self._static()
        return (*s[:3], self.generator, *s[3:])

    def _load(self, args) -> None:
        names = ("x1", "x2", "valid") + _EXTRA[self.kind]
        for name, dst, src in zip(names, self._static(), args):
            if dst.dim() == 0 and isinstance(src, (int, float, np.number)):
                dst.fill_(float(src))
                continue
            src = torch.as_tensor(src)
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(
                    f"{name} of shape {tuple(src.shape)}: the {self.kind} "
                    f"captured at max_points={self.cfg.max_points}, "
                    f"max_labels={self.cfg.max_labels} takes "
                    f"{tuple(dst.shape)}")
            dst.copy_(src)

    def _capture(self) -> None:
        dev = self.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        t0 = time.perf_counter()
        with torch.cuda.stream(side):
            self._fn(*self._args())
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        before = _launches()
        try:
            with torch.cuda.graph(graph, stream=side):
                out = self._fn(*self._args())
        except Exception as e:
            raise RuntimeError(
                f"capturing {self.kind} (max_points={self.cfg.max_points}) "
                f"as a CUDA graph failed at {_where(e)}") from e
        torch.cuda.synchronize(dev)
        self.capture_s = time.perf_counter() - t1
        self.warmup_s = t1 - t0
        self.launches = {k: v - before[k] for k, v in _launches().items()}
        self.pool_bytes = _pool_bytes(graph, dev)
        self.graph, self.out = graph, out

    def __call__(self, x1, x2, valid, key, *extra):
        if len(extra) != len(_EXTRA[self.kind]):
            raise TypeError(f"{self.kind} takes (x1, x2, valid, key"
                            + "".join(f", {n}" for n in _EXTRA[self.kind])
                            + ")")
        if not (isinstance(key, torch.Generator)
                and key.device.type == "cuda"):
            raise ValueError("a captured fit draws from one CUDA "
                             "torch.Generator")
        self._load((x1, x2, valid, *extra))
        if self.graph is None:
            self._capture()
        self.generator.set_state(key.get_state())
        self.graph.replay()
        key.set_state(self.generator.get_state())
        with torch.inference_mode():
            return _clone(self.out)


def _pool_bytes(graph, dev: torch.device):
    """Bytes of the segments of `graph`'s private memory pool, from the
    allocator's snapshot; None where the snapshot has no pool ids."""
    pool = tuple(graph.pool())
    total, seen = 0, False
    for seg in torch.cuda.memory_snapshot():
        if "segment_pool_id" not in seg:
            return None
        seen = True
        if seg.get("device") == dev.index and \
                tuple(seg["segment_pool_id"]) == pool:
            total += seg["total_size"]
    return total if seen else None
