"""The fits captured once as CUDA graphs, and the kernel library that
outlives a process.

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

Both single models' four kinds are captured: ``fit``, ``fit_tau``,
``fit_seeded`` and ``fit_adaptive``; so are the mixed plane + motion
fit's three (`cached_fit_mixed`: ``fit``, ``fit_tau``, ``fit_adaptive``):

    fn = aot.cached_fit_mixed(cfg_h, cfg_f, kind="fit_tau")
    res = fn(x1, x2, valid, torch.Generator("cuda").manual_seed(0),
             tau_h, tau_f)

A capture that fails raises, naming the operation; it never falls back
to the eager fit.

A replay runs no Python, so the fit's stages (utils/tracing.stage) are
recorded while it is captured: each `CapturedFit.stages` maps the graph's
device ops, by their index in capture order, onto the stage spans
(`stage_tables()` gives every capture's). While a profiler records, a
call names its host steps with record_function ranges: ``aot.copy_in``,
``aot.replay`` and ``aot.clone``.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import time
import traceback

import numpy as np
import torch
from torch.profiler import record_function

from multih_tpu_torch.ops.kernels import _build
from multih_tpu_torch.utils import tracing

# bump when the captured program's meaning changes without a config or
# torch change
_STAMP = "aot-torch-v1"

KINDS = ("fit", "fit_tau", "fit_seeded", "fit_adaptive")
MIXED_KINDS = ("fit", "fit_tau", "fit_adaptive")
# the arguments after (x1, x2, valid, key) of each kind
_EXTRA = {"fit": (), "fit_tau": ("tau",), "fit_seeded": ("seed_Hs",
                                                         "seed_ok"),
          "fit_adaptive": ()}
_EXTRA_MIXED = {"fit": (), "fit_tau": ("tau_h", "tau_f"),
                "fit_adaptive": ()}

# one capture per (key, card) in a process
_CAPTURED: dict = {}


def _check(cfg, kind: str) -> None:
    if kind not in KINDS:
        raise ValueError(f"kind {kind!r} not in {KINDS}")


def _check_mixed(cfg_h, cfg_f, kind: str) -> None:
    if kind not in MIXED_KINDS:
        raise ValueError(f"kind {kind!r} not in {MIXED_KINDS}")
    if cfg_h.model != "homography" or cfg_f.model != "fundamental":
        raise ValueError("the mixed fit takes cfg_h with model="
                         "'homography' and cfg_f with model='fundamental'")


def _maker(cfg, kind: str, device=None, mixed=None):
    """The eager fit of `kind`; with `mixed` (the mixed fit's arguments
    after cfg_h: cfg_f, f_bias, ...) the mixed fit's, cfg being cfg_h."""
    if mixed is not None:
        from multih_tpu_torch.models import mixed as mixed_fit

        return {
            "fit": mixed_fit.make_fit_mixed,
            "fit_tau": mixed_fit.make_fit_mixed_tau,
            "fit_adaptive": mixed_fit.make_fit_mixed_adaptive,
        }[kind](cfg, **mixed, device=device)
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


def _mixed_kind_name(kind: str) -> str:
    """The reference's name of a mixed kind: fit_mixed, fit_mixed_tau,
    fit_mixed_adaptive."""
    return "fit_mixed" if kind == "fit" else f"fit_mixed_{kind[4:]}"


def cache_key_mixed(cfg_h, cfg_f, f_bias, polish_meanfield, polish_icm,
                    f_scope="all", kind="fit", device=None,
                    polish_refits=2) -> str:
    """24-hex-char key of one captured mixed program: as `cache_key`, with
    both configs and the mixed fit's options (the port's polish_refits
    among them) in place of the one config."""
    sig = "|".join([
        _STAMP, torch.__version__, str(torch.version.cuda),
        _device_kind(_device(device)), _mixed_kind_name(kind),
        repr(cfg_h), repr(cfg_f),
        repr((f_bias, polish_meanfield, polish_icm, f_scope,
              polish_refits))])
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


def _load_library(cache_dir, save_on_miss: bool) -> None:
    root = cache_dir or default_cache_dir()
    if save_on_miss:
        _build.load(root)
    else:
        _build.load(root if _build.library_path(root).exists() else None)


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
    plain maker (the CPU has no graphs). Either model, homography or
    fundamental."""
    _check(cfg, kind)
    dev = _device(device)
    if dev.type != "cuda":
        return _maker(cfg, kind, device=dev)
    _load_library(cache_dir, save_on_miss)
    key = (cache_key(cfg, kind, dev), dev.index)
    if key not in _CAPTURED:
        _CAPTURED[key] = CapturedFit(cfg, kind, dev)
    return _CAPTURED[key]


def cached_fit_mixed(cfg_h, cfg_f, f_bias: float = 0.5,
                     polish_meanfield: int = 4, polish_icm: int = 2,
                     cache_dir: str | None = None,
                     save_on_miss: bool = True, f_scope: str = "all",
                     kind: str = "fit", device=None,
                     polish_refits: int = 2):
    """The mixed plane + motion fit of `kind` (models/mixed.py: "fit",
    "fit_tau", "fit_adaptive") with its configs and options bound, on the
    card captured as one CUDA graph as `cached_fit` captures a single
    model's fit: f(x1, x2, valid, key[, tau_h, tau_f]) -> MixedFitResult,
    or (MixedFitResult, tau_h, tau_f) for fit_adaptive, the graph's
    outputs cloned. `key` is one CUDA generator, which both stages (and
    the adaptive fit's probes) draw from in turn, as in the eager fit.
    device="cpu" returns the plain maker."""
    _check_mixed(cfg_h, cfg_f, kind)
    mixed = dict(cfg_f=cfg_f, f_bias=f_bias,
                 polish_meanfield=polish_meanfield, polish_icm=polish_icm,
                 f_scope=f_scope, polish_refits=polish_refits)
    dev = _device(device)
    if dev.type != "cuda":
        return _maker(cfg_h, kind, device=dev, mixed=mixed)
    _load_library(cache_dir, save_on_miss)
    key = (cache_key_mixed(cfg_h, cfg_f, f_bias, polish_meanfield,
                           polish_icm, f_scope, kind, dev, polish_refits),
           dev.index)
    if key not in _CAPTURED:
        _CAPTURED[key] = CapturedFit(cfg_h, kind, dev, mixed=mixed)
    return _CAPTURED[key]


def _launches() -> dict:
    """Every kernel wrapper's launch count, by kernel name; K1's
    homography kinds (`inlier_counts`) apart from its epipolar ones
    (`inlier_counts_f`)."""
    from multih_tpu_torch.ops.kernels import (dlt_kernel, eig_kernel,
                                              gather_kernel, mrf_kernel,
                                              residual_kernel)

    k1 = residual_kernel.inlier_counts_padded
    k1_f = sum(v for k, v in k1.kind_launches.items() if k.startswith("f_"))
    return {
        "inlier_counts": k1.launches - k1_f,
        "inlier_counts_f": k1_f,
        "dlt_4pt": dlt_kernel.homography_4pt_gt.launches,
        "eig9_smallest": eig_kernel.smallest_eigvec_9x9_batch.launches,
        "mean_field_fused": mrf_kernel.mean_field_fused.launches,
        "icm_fused": mrf_kernel.icm_fused.launches,
        "mean_field_fused_front": mrf_kernel.mean_field_fused_front.launches,
        "band_list": mrf_kernel.band_list.launches,
        "window_gather": gather_kernel.window_gather.launches,
    }


def _graph_ops(stream: torch.cuda.Stream) -> int:
    """The device ops (kernel, copy and set nodes) captured so far into
    the graph that `stream` is capturing (csrc/graph_ops.cu)."""
    n = ctypes.c_longlong()
    _build.check(_build.load().multih_graph_ops(stream.cuda_stream,
                                                ctypes.byref(n)),
                 "multih_graph_ops")
    return n.value


def _step(name: str):
    """A call's host step: a record_function range while a profiler
    records, else nothing (a range entered with no profiler costs ~10 us
    of host time on the card's host, where a replay takes 17-87 ms)."""
    if torch.autograd._profiler_enabled():
        return record_function(name)
    return contextlib.nullcontext()


def stage_tables() -> list:
    """The stage table (`CapturedFit.stages`, utils/tracing.StageTable) of
    each fit this process captured, in the order of capture."""
    return [fit.stages for fit in _CAPTURED.values()
            if fit.stages is not None]


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
    """One fit kind at one config, captured as a CUDA graph on a card;
    with `mixed` (the mixed fit's arguments after cfg_h, as
    `cached_fit_mixed` passes them) the mixed fit's kind, cfg being
    cfg_h.

    Static inputs, allocated once: x1, x2 (max_points, 2) float32, valid
    (max_points,), and the kind's others: a 0-dim tau (fit_tau),
    seed_Hs (max_labels, 3, 3) and seed_ok (max_labels,) (fit_seeded),
    0-dim tau_h and tau_f (the mixed fit_tau). A call copies its
    arguments in (`copy_`, outside the capture: numpy, CPU or CUDA
    input; a number for a 0-dim one) and raises ValueError on any other
    shape. The first call warms the fit up
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
    launches captured, which every replay makes), `stages` (the
    utils/tracing.StageTable of the capture: each stage's span of the
    graph's device ops and its launches, and the graph's ops in all)."""

    def __init__(self, cfg, kind: str, device: torch.device, mixed=None):
        self.cfg, self.kind, self.device = cfg, kind, device
        self.extra = (_EXTRA if mixed is None else _EXTRA_MIXED)[kind]
        self.what = kind if mixed is None else f"mixed {kind}"
        n, k = cfg.max_points, cfg.max_labels
        f32 = dict(dtype=torch.float32, device=device)
        shapes = {"x1": (n, 2), "x2": (n, 2), "valid": (n,),
                  "seed_Hs": (k, 3, 3), "seed_ok": (k,)}
        fills = {"tau": cfg.inlier_threshold, "tau_h": cfg.inlier_threshold}
        if mixed is not None:
            fills["tau_f"] = mixed["cfg_f"].inlier_threshold
        for name in ("x1", "x2", "valid") + self.extra:
            setattr(self, name, torch.zeros(shapes[name], **f32)
                    if name in shapes else torch.full((), fills[name], **f32))
        self.generator = torch.Generator(device=device)
        self.graph = None
        self.out = None
        self.warmup_s = self.capture_s = None
        self.pool_bytes = None
        self.launches = None
        self.stages = None
        self._fn = _maker(cfg, kind, device=device, mixed=mixed)

    def _static(self):
        return [getattr(self, name)
                for name in ("x1", "x2", "valid") + self.extra]

    def _args(self):
        s = self._static()
        return (*s[:3], self.generator, *s[3:])

    def _load(self, args) -> None:
        names = ("x1", "x2", "valid") + self.extra
        for name, dst, src in zip(names, self._static(), args):
            if dst.dim() == 0 and isinstance(src, (int, float, np.number)):
                dst.fill_(float(src))
                continue
            src = torch.as_tensor(src)
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(
                    f"{name} of shape {tuple(src.shape)}: the {self.what} "
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
            with torch.cuda.graph(graph, stream=side), \
                    tracing.capture_table(lambda: _graph_ops(side),
                                          _launches) as stages:
                out = self._fn(*self._args())
        except Exception as e:
            raise RuntimeError(
                f"capturing {self.what} (max_points={self.cfg.max_points}) "
                f"as a CUDA graph failed at {_where(e)}") from e
        torch.cuda.synchronize(dev)
        self.capture_s = time.perf_counter() - t1
        self.warmup_s = t1 - t0
        self.launches = {k: v - before[k] for k, v in _launches().items()}
        self.pool_bytes = _pool_bytes(graph, dev)
        self.graph, self.out, self.stages = graph, out, stages

    def __call__(self, x1, x2, valid, key, *extra):
        if len(extra) != len(self.extra):
            raise TypeError(f"{self.what} takes (x1, x2, valid, key"
                            + "".join(f", {n}" for n in self.extra) + ")")
        if not (isinstance(key, torch.Generator)
                and key.device.type == "cuda"):
            raise ValueError("a captured fit draws from one CUDA "
                             "torch.Generator")
        with _step("aot.copy_in"):
            self._load((x1, x2, valid, *extra))
        if self.graph is None:
            self._capture()
        self.generator.set_state(key.get_state())
        with _step("aot.replay"):
            self.graph.replay()
        key.set_state(self.generator.get_state())
        with torch.inference_mode(), _step("aot.clone"):
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
