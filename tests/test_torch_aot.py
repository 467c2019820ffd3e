"""The port's utils/aot.py and utils/cache.py, and the kernel library's
key and rebuild (ops/kernels/_build.py), on the CPU.

The CUDA graph itself runs only on a card (chip_smoke.py phase 14). Here:
the host fingerprint equals the JAX package's, the program keys tell
configs, options and kinds apart (tests/test_aot.py's contract),
`cached_fit` (both models) and `cached_fit_mixed` on the CPU are the
port's plain makers bit for bit (tests/test_torch_pipeline.py,
test_torch_fmodel.py and test_torch_mixed.py hold those against the JAX
fits), the captured fits' static inputs refuse other shapes, the F fit's
accept gives the same result on its device route as on its host route,
and `_build` keys its library by the toolchain, refuses a card of
another architecture and rebuilds a library that does not load. No JAX
compile.
"""

import dataclasses
import logging

import numpy as np
import pytest
import torch

import multih_tpu_torch as mt
import torch_mesh_ranks
from multih_tpu.utils import cache as jcache
from multih_tpu_torch.models import mixed, pipeline
from multih_tpu_torch.ops.kernels import _build
from multih_tpu_torch.utils import aot, cache
from multih_tpu_torch.utils import data as tdata

torch.set_num_threads(1)

KINDS = ("fit", "fit_tau", "fit_seeded", "fit_adaptive")
MIXED_MAKERS = {"fit": mixed.make_fit_mixed,
                "fit_tau": mixed.make_fit_mixed_tau,
                "fit_adaptive": mixed.make_fit_mixed_adaptive}


@pytest.fixture(scope="module")
def small_cfg():
    return mt.MultiHConfig(max_points=128, n_hypotheses=256)


@pytest.fixture(scope="module")
def scene(small_cfg):
    """tests/test_aot.py's scene, padded."""
    cs, _ = tdata.synthetic_scene(100, 2, 0.1, 0.5, seed=5)
    return mt.pad_points(cs.x1, cs.x2, None, small_cfg.max_points)


@pytest.fixture(scope="module")
def f_cfg(small_cfg):
    return dataclasses.replace(small_cfg, model="fundamental",
                               residual="sampson")


@pytest.fixture(scope="module")
def motion_scene(small_cfg):
    """A 2-motion scene, padded: a fit whose accept takes the joint move
    once and refuses it four times (test_f_accept_routes_agree)."""
    cs, _ = tdata.synthetic_motion_scene(100, 2, 0.1, 0.5, seed=5)
    return mt.pad_points(cs.x1, cs.x2, None, small_cfg.max_points)


@pytest.fixture(scope="module")
def mixed_scene():
    """A 2-plane, 1-motion scene padded to tests/torch_mesh_ranks.py's
    MIXED_H (N=320, the gather path)."""
    cs, _, _ = tdata.synthetic_mixed_scene(300, 2, 1, 0.1, 0.5, seed=3)
    return mt.pad_points(cs.x1, cs.x2, None,
                         torch_mesh_ranks.MIXED_H["max_points"])


def assert_same(got, want):
    """Two results (NamedTuples of tensors, nested, or tuples of them and
    taus) equal bit for bit."""
    if isinstance(want, torch.Tensor):
        assert torch.equal(got, want)
        return
    if hasattr(want, "_fields"):
        assert got._fields == want._fields
        for name in want._fields:
            assert_same(getattr(got, name), getattr(want, name))
        return
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert_same(a, b)


def test_host_fingerprint_matches_reference():
    assert cache.host_fingerprint() == jcache.host_fingerprint()
    assert cache.compile_cache_dir("x") == jcache.compile_cache_dir("x")
    assert len(cache.host_fingerprint()) == 8


def test_key_stable_and_differs_by_config_and_kind(small_cfg):
    key = aot.cache_key(small_cfg, "fit", device="cpu")
    assert key == aot.cache_key(small_cfg, "fit", device="cpu")
    assert len(key) == 24
    other = dataclasses.replace(small_cfg, inlier_threshold=4.0)
    assert key != aot.cache_key(other, "fit", device="cpu")
    assert key != aot.cache_key(small_cfg, "fit_tau", device="cpu")


def _extra(kind, cfg):
    if kind == "fit_tau":
        return (4.0,)
    if kind == "fit_seeded":
        k = cfg.max_labels
        hs = np.tile(np.eye(3, dtype=np.float32), (k, 1, 1))
        return hs, (np.arange(k) < 2).astype(np.float32)
    return ()


@pytest.mark.parametrize("kind", KINDS)
def test_cpu_cached_fit_is_the_maker(small_cfg, scene, kind):
    """On the CPU cached_fit is the plain maker: the same results bit for
    bit, and the generator left in the same state."""
    f = aot.cached_fit(small_cfg, kind, device="cpu")
    maker = {"fit": mt.make_fit, "fit_tau": mt.make_fit_tau,
             "fit_seeded": mt.make_fit_seeded,
             "fit_adaptive": mt.make_fit_adaptive}[kind]
    g_a, g_b = (torch.Generator().manual_seed(3) for _ in range(2))
    got = f(*scene, g_a, *_extra(kind, small_cfg))
    want = maker(small_cfg, device="cpu")(*scene, g_b,
                                           *_extra(kind, small_cfg))
    if kind == "fit_adaptive":
        assert torch.equal(got[1], want[1])  # tau
        got, want = got[0], want[0]
    assert got._fields == want._fields
    for name in got._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert torch.equal(g_a.get_state(), g_b.get_state())
    assert int(got.active.sum()) >= 1


@pytest.mark.parametrize("kind", ("fit", "fit_tau", "fit_adaptive"))
def test_cpu_cached_fit_fundamental_is_the_maker(f_cfg, motion_scene, kind):
    """cached_fit takes the F model: on the CPU its plain maker, the same
    results bit for bit and the generator left in the same state."""
    f = aot.cached_fit(f_cfg, kind, device="cpu")
    maker = {"fit": mt.make_fit, "fit_tau": mt.make_fit_tau,
             "fit_adaptive": mt.make_fit_adaptive}[kind]
    g_a, g_b = (torch.Generator().manual_seed(3) for _ in range(2))
    extra = (2.5,) if kind == "fit_tau" else ()
    got = f(*motion_scene, g_a, *extra)
    assert_same(got, maker(f_cfg, device="cpu")(*motion_scene, g_b, *extra))
    assert torch.equal(g_a.get_state(), g_b.get_state())
    res = got[0] if kind == "fit_adaptive" else got
    assert int(res.active.sum()) >= 1


@pytest.mark.parametrize("kind", aot.MIXED_KINDS)
def test_cpu_cached_fit_mixed_is_the_maker(mixed_scene, kind):
    """cached_fit_mixed on the CPU is the plain mixed maker: the same
    MixedFitResult (and taus) bit for bit, the generator in the same
    state."""
    cfg_h, cfg_f = torch_mesh_ranks.mixed_configs()
    f = aot.cached_fit_mixed(cfg_h, cfg_f, kind=kind, device="cpu")
    g_a, g_b = (torch.Generator().manual_seed(2) for _ in range(2))
    extra = (3.5, 2.5) if kind == "fit_tau" else ()
    got = f(*mixed_scene, g_a, *extra)
    want = MIXED_MAKERS[kind](cfg_h, cfg_f, device="cpu")(
        *mixed_scene, g_b, *extra)
    assert_same(got, want)
    assert torch.equal(g_a.get_state(), g_b.get_state())
    res = got[0] if kind == "fit_adaptive" else got
    assert int(res.active.sum()) >= 2


def test_mixed_key_stable_and_differs_by_each_argument_and_kind():
    cfg_h, cfg_f = torch_mesh_ranks.mixed_configs()
    base = dict(cfg_h=cfg_h, cfg_f=cfg_f, f_bias=0.5, polish_meanfield=4,
                polish_icm=2, f_scope="all", kind="fit", device="cpu",
                polish_refits=2)
    key = aot.cache_key_mixed(**base)
    assert key == aot.cache_key_mixed(**base) and len(key) == 24
    others = dict(
        cfg_h=dataclasses.replace(cfg_h, inlier_threshold=4.0),
        cfg_f=dataclasses.replace(cfg_f, inlier_threshold=2.0),
        f_bias=0.25, polish_meanfield=2, polish_icm=1, f_scope="remainder",
        kind="fit_tau", polish_refits=1)
    keys = [aot.cache_key_mixed(**dict(base, **{name: v}))
            for name, v in others.items()]
    keys.append(aot.cache_key_mixed(**dict(base, kind="fit_adaptive")))
    assert len(set(keys)) == len(keys) and key not in keys
    assert key != aot.cache_key(cfg_h, "fit", device="cpu")


def test_mixed_refuses_other_kinds_and_models():
    cfg_h, cfg_f = torch_mesh_ranks.mixed_configs()
    with pytest.raises(ValueError, match="fit_seeded"):
        aot.cached_fit_mixed(cfg_h, cfg_f, kind="fit_seeded", device="cpu")
    with pytest.raises(ValueError, match="model='fundamental'"):
        aot.cached_fit_mixed(cfg_h, cfg_h, device="cpu")


def test_mixed_static_inputs_refuse_other_shapes(mixed_scene):
    """The captured mixed fit_tau's static buffers (made on the CPU) take
    the points and two thresholds, numbers or tensors, and refuse other
    shapes; without the thresholds the call names them."""
    cfg_h, cfg_f = torch_mesh_ranks.mixed_configs()
    f = aot.CapturedFit(cfg_h, "fit_tau", torch.device("cpu"),
                        mixed=dict(cfg_f=cfg_f))
    x1, x2, valid = mixed_scene
    assert float(f.tau_h) == cfg_h.inlier_threshold
    assert float(f.tau_f) == cfg_f.inlier_threshold
    f._load((x1, x2, torch.from_numpy(valid), 3.5, torch.tensor(2.5)))
    assert torch.equal(f.valid, torch.from_numpy(valid))
    assert (float(f.tau_h), float(f.tau_f)) == (3.5, 2.5)
    with pytest.raises(ValueError, match="x2 of shape.*mixed fit_tau"):
        f._load((x1, x2[:128], valid, 3.5, 2.5))
    with pytest.raises(ValueError, match="tau_f of shape"):
        f._load((x1, x2, valid, 3.5, np.ones(2, np.float32)))
    with pytest.raises(TypeError, match="tau_h, tau_f"):
        f(x1, x2, valid, torch.Generator())
    adaptive = aot.CapturedFit(cfg_h, "fit_adaptive", torch.device("cpu"),
                               mixed=dict(cfg_f=cfg_f))
    assert adaptive.extra == () and not hasattr(adaptive, "tau_h")


def test_f_accept_routes_agree(f_cfg, motion_scene, monkeypatch):
    """pipeline._f_accept on its device route (both moves computed, each
    output picked with torch.where) equals its host route bit for bit,
    call by call through an F fit, on calls where the joint move is taken
    and on calls where it is refused. On the card the fallback's kernel
    route is held to both as a third route
    (tests/test_torch_accept.py, which imports no JAX)."""
    accept = pipeline._f_accept
    joint = []

    def both(Hs_c, q_c, *args, **kw):
        host = accept(Hs_c, q_c, *args, on_device=False, **kw)
        device = accept(Hs_c, q_c, *args, on_device=True, **kw)
        assert_same(device, host)
        joint.append(host[1] is not q_c)  # the fallback keeps q_c
        return host

    monkeypatch.setattr(pipeline, "_f_accept", both)
    mt.fit(*motion_scene, torch.Generator().manual_seed(0), f_cfg,
           device="cpu")
    assert True in joint and False in joint, joint


def test_unknown_kind(small_cfg):
    with pytest.raises(ValueError, match="fit_mixed"):
        aot.cached_fit(small_cfg, "fit_mixed", device="cpu")


def test_static_inputs_copy_in_and_refuse_other_shapes(small_cfg, scene):
    """The captured fit's static buffers (made here on the CPU: the graph
    needs a card) take numpy or tensors of their own shape, a number for
    tau, and raise ValueError on another shape; the key must be a CUDA
    generator."""
    f = aot.CapturedFit(small_cfg, "fit_tau", torch.device("cpu"))
    x1, x2, valid = scene
    f._load((x1, torch.from_numpy(x2), valid, 2.5))
    assert torch.equal(f.x1, torch.from_numpy(x1))
    assert torch.equal(f.x2, torch.from_numpy(x2))
    assert f.tau.shape == () and float(f.tau) == 2.5
    f._load((x1, x2, valid, torch.tensor(3.5)))
    assert float(f.tau) == 3.5
    with pytest.raises(ValueError, match="x1 of shape"):
        f._load((x1[:64], x2, valid, 2.5))
    with pytest.raises(ValueError, match="tau of shape"):
        f._load((x1, x2, valid, np.ones(2, np.float32)))
    with pytest.raises(ValueError, match="CUDA torch.Generator"):
        f(x1, x2, valid, torch.Generator(), 2.5)
    with pytest.raises(TypeError, match="tau"):
        f(x1, x2, valid, torch.Generator())
    seeded = aot.CapturedFit(small_cfg, "fit_seeded", torch.device("cpu"))
    hs, ok = _extra("fit_seeded", small_cfg)
    seeded._load((x1, x2, valid, hs, ok))
    assert torch.equal(seeded.seed_ok, torch.from_numpy(ok))
    with pytest.raises(ValueError, match="seed_Hs of shape"):
        seeded._load((x1, x2, valid, hs[:3], ok))


def test_cache_dir_default_and_env(monkeypatch):
    monkeypatch.delenv("MULTIH_AOT_CACHE", raising=False)
    assert aot.default_cache_dir() == str(_build.BUILD_ROOT)
    monkeypatch.setenv("MULTIH_AOT_CACHE", "/var/cache/multih")
    assert aot.default_cache_dir() == "/var/cache/multih"


def test_library_key_has_host_and_toolchain(monkeypatch, tmp_path):
    """The library's directory is keyed by the host (utils/cache.py), its
    name by the sources, flags and toolchain (nvcc's release and
    torch.version.cuda): another toolkit, another file."""
    assert str(_build.library_dir(tmp_path)) == cache.compile_cache_dir(
        str(tmp_path))
    assert _build.library_dir() == _build.library_dir(_build.BUILD_ROOT)
    monkeypatch.setattr(_build, "_toolchain",
                        lambda: "Cuda compilation tools, release 12.9|12.8")
    a = _build.library_path(tmp_path)
    monkeypatch.setattr(_build, "_toolchain",
                        lambda: "Cuda compilation tools, release 12.4|12.8")
    b = _build.library_path(tmp_path)
    assert a != b and a.parent == b.parent
    assert a.name.startswith("libmultih_kernels_") and a.suffix == ".so"


def test_load_refuses_other_cards(monkeypatch):
    monkeypatch.setattr(_build._Library, "lib", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda *a: (8, 0))
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA A100-SXM4-80GB")
    with pytest.raises(RuntimeError, match=r"sm_90a.*8\.0"):
        _build.load()


def test_load_refuses_no_card(monkeypatch):
    monkeypatch.setattr(_build._Library, "lib", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _build.load()


def test_library_that_does_not_load_is_rebuilt_once(monkeypatch, tmp_path,
                                                    caplog):
    """A keyed library that does not load (truncated) is rebuilt once from
    the sources, with a warning; one that still does not load raises."""
    monkeypatch.setattr(_build, "_toolchain", lambda: "test toolchain")
    so = _build.library_path(tmp_path)
    so.parent.mkdir(parents=True)
    so.write_bytes(b"\x7fELF")  # truncated
    builds, opens = [], []

    def compile_(srcs, path):
        builds.append(path)
        path.write_bytes(b"a library")
        return 1.5

    def open_(path):
        opens.append(path.read_bytes())
        if path.read_bytes() != b"a library":
            raise OSError(f"{path}: file too short")
        return "lib"

    monkeypatch.setattr(_build, "_compile", compile_)
    monkeypatch.setattr(_build, "_open", open_)
    with caplog.at_level(logging.WARNING, logger=_build.__name__):
        lib, path, seconds, rebuilt = _build.open_library(tmp_path)
    assert (lib, path, seconds, rebuilt) == ("lib", so, 1.5, True)
    assert builds == [so] and len(opens) == 2
    assert "rebuilding" in caplog.text and str(so) in caplog.text
    # a loadable library is opened as it is
    builds.clear()
    assert _build.open_library(tmp_path)[3] is False and builds == []
    # a rebuild that still does not load raises
    monkeypatch.setattr(_build, "_compile",
                        lambda srcs, path: path.write_bytes(b"") or 0.0)
    so.write_bytes(b"")
    with pytest.raises(OSError):
        _build.open_library(tmp_path)


def test_truncated_library_does_not_reach_dlopen(tmp_path):
    """A library cut short raises OSError before dlopen, which would map
    it and die of SIGBUS past its end; the whole file passes."""
    import struct

    hdr = bytearray(64)
    hdr[:5] = b"\x7fELF\x02"
    struct.pack_into("<QQ", hdr, 0x20, 64, 4096)  # program, section headers
    struct.pack_into("<HHHH", hdr, 0x36, 56, 2, 64, 3)
    so = tmp_path / "lib.so"
    so.write_bytes(bytes(hdr) + bytes(4096 + 3 * 64 - 64))
    _build._check_whole(so)
    so.write_bytes(bytes(hdr) + bytes(1000))
    with pytest.raises(OSError, match="truncated"):
        _build._check_whole(so)
    so.write_bytes(b"\x7fELF")
    with pytest.raises(OSError, match="not a whole"):
        _build._check_whole(so)
