"""Batched fitting of many pairs, and the device mesh's 'pair' and
'hyp' axes.

Counterpart of ``multih_tpu/parallel/sharding.py``. The reference vmaps
its fit over the pair axis and shards that axis over a device mesh; the
port's fit is eager Python around hand-written kernels, so a batch is a
loop over pairs, and pair i's result is the single fit of pair i, bit
for bit. The homography fit holds no host sync, so the fits of a batch
queue on the card back to back.

A mesh (parallel/mesh.py, `make_mesh`) lays torch.distributed ranks out
on two axes. 'pair': rank row p fits its share of the batch's pairs and
the rows all-gather the results (`sharded_fit`, `sharded_fit_mixed`,
`run_benchmark_batch(mesh=)`). 'hyp': the ranks of a row split one
pair's hypothesis pool (`hyp_sharded_fit`, `sharded_verification`,
`batched_fit(mesh=)`), each generating and counting its slice; the rest
of the fit runs replicated. Every rank of the world calls the same
function with the same arguments, as one JAX program runs on every
device. A 'pt' mesh (`make_pt_mesh`, one axis) splits one pair's points
into contiguous runs of Morton blocks (`pt_sharded_fit`): the labeling's
sweeps exchange a one-block halo between neighbouring ranks, the
refits gather their weights, and the other sums over the points are
psums.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from multih_tpu_torch.config import MultiHConfig
from multih_tpu_torch.models import mixed, pipeline
from multih_tpu_torch.parallel.mesh import Mesh


def make_mesh(devices=None, pair_axis: int | None = None,
              device=None) -> Mesh:
    """('pair', 'hyp') mesh over ranks of the initialized default group
    (sharding.py:33): `devices` are ranks, all of the world's by default
    (a world of one without a process group); `pair_axis` defaults to
    their count, so every rank is on the pair axis. Ranks lie row-major,
    devices[:pair * hyp].reshape(pair, hyp). Every rank of the world
    calls it with the same arguments. device: this rank's device, by
    default cuda:<local rank % cards>."""
    if devices is None:
        world = dist.get_world_size() if dist.is_initialized() else 1
        devices = range(world)
    devices = list(devices)
    pair = len(devices) if pair_axis is None else pair_axis
    hyp = len(devices) // pair
    return Mesh(np.array(devices[:pair * hyp]).reshape(pair, hyp),
                ("pair", "hyp"), device)


def make_pt_mesh(ranks=None, device=None) -> Mesh:
    """1-D mesh over the point axis, ('pt',) (sharding.py:48): `ranks`
    are ranks of the initialized default group, all of the world's by
    default. Every rank of the world calls it with the same arguments.
    device: this rank's device, by default cuda:<local rank % cards>."""
    if ranks is None:
        world = dist.get_world_size() if dist.is_initialized() else 1
        ranks = range(world)
    return Mesh(np.array(list(ranks)), ("pt",), device)


def pt_sharded_fit(cfg: MultiHConfig, mesh: Mesh):
    """The single-pair fit with the point axis split over the mesh's
    'pt' axis (sharding.py:57): f(x1, x2, valid, key) -> FitResult, the
    whole labeling on every rank. Each rank holds the whole coordinate
    arrays and computes the same Morton order; it owns a contiguous run
    of N / (agree_block * pt) blocks, on which it builds its k-NN rows,
    its band, residuals, data costs, q and labels; hypothesis generation
    runs replicated. Raises ValueError where the reference asserts its
    gate (`pipeline.check_pt_gate`, checked here on cfg.max_points and in
    the fit on N). The counts sum exactly over the ranks; the energies
    sum in float64, and the refits gather their (C, N) weights and run
    the single-device refit, so the result equals the single-device
    fit's. The reference psums float32 moments and energies
    (sharding.py:76-82), which round apart from one sum; a deliberate
    divergence. Every rank passes the same inputs and a key in the same
    state."""
    pipeline.check_pt_gate(cfg, cfg.max_points, mesh)

    def f(x1, x2, valid, key):
        return pipeline.fit(x1, x2, valid, key, cfg, mesh=mesh)
    return f


def _stack(results):
    """A list of (nested) NamedTuples of tensors -> one NamedTuple of the
    stacked tensors, a leading batch axis on every leaf."""
    first = results[0]
    if isinstance(first, tuple):
        return type(first)(*(_stack(list(leaves))
                             for leaves in zip(*results)))
    return torch.stack(results)


def _loop(fit_one, device, mesh=None):
    """f(x1 (B, N, 2), x2, valid (B, N), keys, *per_pair) -> the stacked
    results of fit_one(x1[i], x2[i], valid[i], keys[i], *(a[i] for a in
    per_pair)) over the pairs, in order. Arrays go to `device` (the
    mesh's device, else the card, by default) in one copy each; tensors
    keep their device."""

    def f(x1, x2, valid, keys, *per_pair):
        x1, x2, valid = pipeline._inputs(x1, x2, valid, device, mesh)
        if len(keys) != x1.shape[0]:
            raise ValueError(f"{len(keys)} keys for {x1.shape[0]} pairs")
        return _stack([fit_one(x1[i], x2[i], valid[i], keys[i],
                               *(a[i] for a in per_pair))
                       for i in range(x1.shape[0])])

    return f


def batched_fit(cfg: MultiHConfig, adaptive: bool = False,
                probe_tau: float = 8.0, mesh: Mesh | None = None,
                device=None):
    """The fit over a batch of padded pairs (sharding.py:113).

    Returns f(x1 (B, N, 2), x2, valid (B, N), keys (B generators or draw
    sources), taus (B,)) -> FitResult with a leading batch axis. `taus`
    are per-pair inlier thresholds in px (numbers or a tensor). Tensors
    keep their device; arrays go to `device`, the card by default, in
    one copy each. With `adaptive`, each pair calibrates its own
    threshold (`pipeline.fit_adaptive`, one key for both passes) and
    `taus` is ignored, as in the reference. With a mesh whose 'hyp' axis
    is > 1, each pair's fit splits its hypothesis pool over that axis
    (sharding.py:130-145); the pairs are not split (`sharded_fit`
    does that)."""
    def fit_one(x1, x2, valid, key, tau):
        if adaptive:
            return pipeline.fit_adaptive(x1, x2, valid, key, cfg,
                                         probe_tau, mesh=mesh)[0]
        return pipeline.fit(x1, x2, valid, key, cfg, tau=tau, mesh=mesh)

    loop = _loop(fit_one, device, mesh)

    def f(x1, x2, valid, keys, taus):
        return loop(x1, x2, valid, keys,
                    [None] * len(keys) if adaptive else taus)

    return f


def batched_fit_mixed(cfg_h: MultiHConfig, cfg_f: MultiHConfig,
                      adaptive: bool = False, mesh: Mesh | None = None,
                      device=None, **kw):
    """The mixed (plane + motion) fit over a batch of padded pairs
    (sharding.py:182). Returns f(x1 (B, N, 2), x2, valid (B, N), keys
    (B generators or draw sources)) -> MixedFitResult with a leading
    batch axis. With `adaptive`, each pair calibrates its per-class
    thresholds (`mixed.fit_mixed_adaptive`). Extra keyword arguments go
    to the mixed fit (f_bias, the polish's counts, probe taus, ...). A
    mesh gives the arrays' default device only: the mixed fit has no
    'hyp' split, as in the reference.

    Explicit `tau_h` / `tau_f` with `adaptive` raise a ValueError here,
    before any fit: the reference would fail only inside the batched
    call, with a TypeError of a duplicated keyword."""
    if adaptive and ("tau_h" in kw or "tau_f" in kw):
        raise ValueError("explicit tau_h / tau_f conflict with adaptive=True,"
                         " which calibrates each pair's thresholds itself")

    def fit_one(x1, x2, valid, key):
        if adaptive:
            return mixed.fit_mixed_adaptive(x1, x2, valid, key, cfg_h,
                                            cfg_f, **kw)[0]
        return mixed.fit_mixed(x1, x2, valid, key, cfg_h, cfg_f, **kw)

    return _loop(fit_one, device, mesh)


def _gather_pairs(res, mesh: Mesh):
    """This rank row's results (a nested NamedTuple of (b_loc, ...)
    tensors) -> every row's, concatenated in row order on every rank."""
    if isinstance(res, tuple):
        return type(res)(*(_gather_pairs(leaf, mesh) for leaf in res))
    return mesh.all_gather(res, "pair").reshape(-1, *res.shape[1:])


def _split_pairs(fit_rows, mesh: Mesh):
    """f(x1, x2, valid, keys, *per_pair) that runs fit_rows on this rank
    row's share [p * B/P, (p + 1) * B/P) of the B pairs and returns the
    whole batch's results; B must be a multiple of the 'pair' size P."""

    def f(x1, x2, valid, keys, *per_pair):
        x1, x2, valid = pipeline._inputs(x1, x2, valid, None, mesh)
        b, npair = x1.shape[0], mesh.shape["pair"]
        if b % npair:
            raise ValueError(f"{b} pairs over a pair axis of {npair}: pad "
                             f"the batch (prepare_benchmark_batch does)")
        row = mesh.axis_index("pair")
        sl = slice(row * (b // npair), (row + 1) * (b // npair))
        res = fit_rows(x1[sl], x2[sl], valid[sl], keys[sl],
                       *(a[sl] for a in per_pair))
        return _gather_pairs(res, mesh)

    return f


def sharded_fit(cfg: MultiHConfig, mesh: Mesh, adaptive: bool = False,
                probe_tau: float = 8.0):
    """The batched fit with the pairs split over the mesh's 'pair' axis
    (sharding.py:151), each pair's pool over its 'hyp' axis where that is
    > 1: f(x1 (B, N, 2), x2, valid (B, N), keys (B,), taus (B,)) ->
    FitResult of all B pairs on every rank. B must be a multiple of the
    'pair' size (prepare_benchmark_batch pads it). Pair i takes keys[i],
    whichever row fits it."""
    return _split_pairs(batched_fit(cfg, adaptive, probe_tau, mesh), mesh)


def sharded_fit_mixed(cfg_h: MultiHConfig, cfg_f: MultiHConfig, mesh: Mesh,
                      adaptive: bool = False, **kw):
    """The batched mixed fit with the pairs split over the mesh's 'pair'
    axis (sharding.py:212): f(x1 (B, N, 2), x2, valid (B, N), keys (B,))
    -> MixedFitResult of all B pairs on every rank; B a multiple of the
    'pair' size. Extra keyword arguments as `batched_fit_mixed`'s."""
    return _split_pairs(batched_fit_mixed(cfg_h, cfg_f, adaptive, mesh,
                                          **kw), mesh)


def hyp_sharded_fit(cfg: MultiHConfig, mesh: Mesh):
    """The single-pair fit with hypothesis generation and the
    verification sweep + top-M split over the mesh's 'hyp' axis
    (sharding.py:247; pipeline._hypothesize_verify_sharded): f(x1, x2,
    valid, key) -> FitResult, the single-device fit's on every rank of
    the axis. Every rank passes the same inputs and a key in the same
    state."""
    def f(x1, x2, valid, key):
        return pipeline.fit(x1, x2, valid, key, cfg, mesh=mesh)
    return f


def sharded_verification(cfg: MultiHConfig, mesh: Mesh,
                         replication_check: bool = False):
    """The verification sweep with the pool split over the mesh's 'hyp'
    axis (sharding.py:272): each rank counts its contiguous slice of the
    pool against every point, takes its local top-M, and the ranks merge
    the gathered (count, index) candidates into the global top-M.
    Returns f(Hs (S, 3, 3), x1, x2, valid) -> (top_counts (M,), top_idx
    (M,)), the same on every rank of the axis and equal to the stable
    top-M of the unsharded counts (ties: the lower index first); with
    `replication_check`, also the {0, 1} replication guard. S must be a
    multiple of the 'hyp' size."""
    from multih_tpu_torch.ops.topk import top_k_stable

    m = cfg.n_candidates

    def f(Hs, x1, x2, valid):
        x1, x2, valid = pipeline._inputs(x1, x2, valid, None, mesh)
        Hs = torch.as_tensor(Hs, dtype=x1.dtype, device=x1.device)
        n, d = mesh.shape["hyp"], mesh.axis_index("hyp")
        if Hs.shape[0] % n:
            raise ValueError(f"{Hs.shape[0]} hypotheses over a hyp axis of "
                             f"{n}")
        s_loc = Hs.shape[0] // n
        counts = pipeline.count_inliers(Hs[d * s_loc:(d + 1) * s_loc], x1,
                                        x2, valid, cfg)
        c_loc, i_loc = top_k_stable(counts, m)
        c_all = mesh.all_gather(c_loc, "hyp").reshape(-1)
        i_all = mesh.all_gather(i_loc + d * s_loc, "hyp").reshape(-1)
        # shard order, then local order: equal counts stay in index order
        c_top, pos = top_k_stable(c_all, m)
        out = (c_top, i_all[pos])
        if replication_check:
            return out + (mesh.replicated_ok(out, "hyp"),)
        return out

    return f


def prepare_benchmark_batch(pairs, cfg: MultiHConfig, taus=None,
                            device=None, mesh: Mesh | None = None):
    """Pad a list of CorrespondenceSets to cfg.max_points and upload the
    stacked batch once (sharding.py:321): ((x1 (B', N, 2), x2, valid
    (B', N), taus (B',)), B), on `device` (the mesh's device, else the
    card, by default). With a mesh, B' is B padded up to a multiple of
    its 'pair' size with pairs of no valid point (sharding.py:331-333);
    every rank holds the whole batch. `taus` defaults to
    cfg.inlier_threshold for every pair."""
    b = len(pairs)
    npair = 1 if mesh is None else mesh.shape["pair"]
    b_pad = -(-b // npair) * npair
    x1 = np.zeros((b_pad, cfg.max_points, 2), np.float32)
    x2 = np.zeros((b_pad, cfg.max_points, 2), np.float32)
    valid = np.zeros((b_pad, cfg.max_points), np.float32)
    for i, cs in enumerate(pairs):
        x1[i], x2[i], valid[i] = pipeline.pad_points(cs.x1, cs.x2, None,
                                                     cfg.max_points)
    t = np.full((b_pad,), cfg.inlier_threshold, np.float32)
    if taus is not None:
        t[:len(taus)] = np.asarray(taus, np.float32)
    x1, x2, valid = pipeline._inputs(x1, x2, valid, device, mesh)
    return (x1, x2, valid, torch.from_numpy(t).to(x1.device)), b


def run_benchmark_batch(pairs, cfg: MultiHConfig, seed: int = 0, taus=None,
                        adaptive: bool = False, prepared=None, device=None,
                        mesh: Mesh | None = None):
    """Fit a list of CorrespondenceSets as one batch (sharding.py:356):
    a FitResult of numpy arrays with a leading batch axis, cut to
    [:len(pairs)], in input order; with a mesh, the pairs split over its
    'pair' axis (`sharded_fit`) and every rank returns the whole batch.

    Pair i draws from a generator seeded seed + i, i its index in the
    whole batch, on the batch's device (on the CPU
    torch.Generator().manual_seed(seed + i)), the counterpart of the
    reference's jax.random.key(seed + i); the fit takes a generator on
    its points' device. `taus`: per-pair thresholds in px
    (cfg.inlier_threshold by default), ignored with `adaptive`. Pass
    `prepared` (from prepare_benchmark_batch, with the same mesh) to
    reuse the uploaded batch across calls."""
    if prepared is None:
        prepared = prepare_benchmark_batch(pairs, cfg, taus, device, mesh)
    (x1, x2, valid, t), b = prepared
    keys = [torch.Generator(device=x1.device).manual_seed(seed + i)
            for i in range(x1.shape[0])]
    f = (batched_fit(cfg, adaptive=adaptive) if mesh is None
         else sharded_fit(cfg, mesh, adaptive=adaptive))
    res = f(x1, x2, valid, keys, t)
    return type(res)(*(a[:b].cpu().numpy() for a in res))
