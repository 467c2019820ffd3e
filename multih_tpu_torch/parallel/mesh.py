"""A device mesh over torch.distributed ranks, and a helper that starts
ranks.

The counterpart of the ``jax.sharding.Mesh`` that ``multih_tpu/parallel/
sharding.py`` builds over devices. Here one process drives one device
(a rank), so a mesh lays the world's ranks out on named axes, row-major
as ``np.array(devices).reshape(pair, hyp)`` does, and carries one process
group per axis through this rank: the ``hyp`` group is its row, the
``pair`` group its column; a 'pt' mesh (`sharding.make_pt_mesh`) has one
axis. The collectives that the JAX code takes from ``jax.lax``
(`axis_index`, `all_gather`, `psum`) are methods of the mesh, and so is
the halo exchange of a 'pt' sweep (`halo_exchange`), which GSPMD derives
from the reference's sharding annotations.

Backends. NCCL keeps tensors on the card but needs one card a rank (it
refuses two ranks on one device). Gloo runs any number of ranks on one
card or on the CPU, but gathers no CUDA tensor: under gloo a collective
on a CUDA tensor copies it to the host and back, explicitly, and counts
the bytes in `Mesh.host_staged`. The kernels still run on the card.

A mesh of one rank needs no process group: `Mesh([[0]])` in a plain
process runs every collective locally.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import queue as queue_mod
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

# a collective that waits longer fails its rank (init_process_group's
# timeout), so a lost peer never hangs the others
COLLECTIVE_TIMEOUT_S = 60.0


def default_device(rank: int) -> torch.device:
    """cuda:<local rank % card count>; raises without a card (a mesh
    never carries on on the CPU unless asked)."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' for a CPU mesh")
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


class Mesh:
    """Named axes over ranks.

    ranks: an array of global ranks, one axis per name in `axis_names`.
    Every rank of the world builds the same mesh, because creating a
    process group is collective; a rank that the array leaves out gets a
    mesh with `coords` None and takes no part in its collectives.
    device: this rank's device (default_device by default)."""

    def __init__(self, ranks, axis_names=("pair", "hyp"), device=None):
        ranks = np.asarray(ranks, dtype=np.int64)
        if ranks.ndim != len(axis_names):
            raise ValueError(f"ranks of shape {ranks.shape} for axes "
                             f"{axis_names}")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, ranks.shape))
        self.ranks = ranks
        distributed = dist.is_available() and dist.is_initialized()
        self.rank = dist.get_rank() if distributed else 0
        self.backend = dist.get_backend() if distributed else None
        if not distributed and ranks.size != 1:
            raise RuntimeError(f"a mesh of {ranks.size} ranks needs an "
                               f"initialized process group")
        hit = np.argwhere(ranks == self.rank)
        self.coords = tuple(int(c) for c in hit[0]) if len(hit) else None
        self.device = (default_device(self.rank) if device is None
                       else torch.device(device))
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"no CUDA device for a mesh on {self.device}")
        self.host_staged = 0  # bytes of CUDA tensors staged through the host
        self.groups, self.members = {}, {}
        for ax, name in enumerate(self.axis_names):
            # every line along this axis, in one fixed order on every rank
            lines = np.moveaxis(ranks, ax, -1).reshape(-1, ranks.shape[ax])
            for line in lines:
                line = [int(r) for r in line]
                group = dist.new_group(line) if distributed else None
                if self.rank in line:
                    self.groups[name], self.members[name] = group, line

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate on `axis` (jax.lax.axis_index); a rank
        outside the mesh has none and raises ValueError."""
        if self.coords is None:
            raise ValueError(f"rank {self.rank} is not in the mesh")
        return self.coords[self.axis_names.index(axis)]

    def _staged(self, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.is_cuda

    def all_gather(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """(n, *t.shape): every rank's t along `axis`, in axis order
        (jax.lax.all_gather). Every rank passes the same shape."""
        group = self.groups[axis]
        if group is None:
            return t[None].clone()
        staged = self._staged(t)
        src = t.detach().cpu() if staged else t.detach().contiguous()
        out = [torch.empty_like(src) for _ in self.members[axis]]
        dist.all_gather(out, src, group=group)
        # the list comes in group-rank order; the mesh's order is the
        # axis order
        res = torch.stack([out[dist.get_group_rank(group, r)]
                           for r in self.members[axis]])
        if staged:
            self.host_staged += src.nbytes + res.nbytes
            res = res.to(t.device)
        return res

    def psum(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum of t over `axis`, on every rank of it
        (jax.lax.psum)."""
        group = self.groups[axis]
        if group is None:
            return t.clone()
        staged = self._staged(t)
        buf = t.detach().cpu() if staged else t.detach().clone()
        dist.all_reduce(buf, group=group)
        if staged:
            self.host_staged += 2 * buf.nbytes
            buf = buf.to(t.device)
        return buf

    def halo_exchange(self, t: torch.Tensor, axis: str, width: int):
        """(prev, next): the last `width` entries of the previous rank's
        t along `axis` and the first `width` of the next rank's, on t's
        last dimension, zeros past the axis's ends (the one-block halo of
        a 'pt' sweep). Point-to-point sends and receives with the two
        neighbours; every rank of the axis passes the same shape."""
        group = self.groups[axis]
        dev = t.device
        lo = t[..., :width].detach().contiguous()
        hi = t[..., t.shape[-1] - width:].detach().contiguous()
        if group is None:
            return torch.zeros_like(lo), torch.zeros_like(hi)
        staged = self._staged(t)
        if staged:
            lo, hi = lo.cpu(), hi.cpu()
        prev, nxt = torch.zeros_like(hi), torch.zeros_like(lo)
        line = self.members[axis]
        i = line.index(self.rank)
        ops = []
        if i > 0:
            ops += [dist.P2POp(dist.isend, lo, line[i - 1], group),
                    dist.P2POp(dist.irecv, prev, line[i - 1], group)]
        if i + 1 < len(line):
            ops += [dist.P2POp(dist.isend, hi, line[i + 1], group),
                    dist.P2POp(dist.irecv, nxt, line[i + 1], group)]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        if staged:
            self.host_staged += 2 * (lo.nbytes + hi.nbytes)
            prev, nxt = prev.to(dev), nxt.to(dev)
        return prev, nxt

    def replicated_ok(self, vals, axis: str) -> torch.Tensor:
        """1.0 where every value of `vals` is bit-equal on every rank of
        `axis`, else 0.0 (pipeline.py:562's runtime replication guard),
        itself replicated: every rank reduces the same gathers."""
        ok = torch.ones((), dtype=torch.bool, device=self.device)
        for v in vals:
            g = self.all_gather(v, axis)
            ok = ok & (g == g[:1]).all().to(ok.device)
        return ok.to(torch.float32)


def _rank_main(fn, rank, world, backend, device, init_method, args,
               results):
    """One rank: join the group, run fn(rank, device, *args), leave the
    group, and report fn's result or its traceback."""
    try:
        device = torch.device(device)
        if device.type == "cpu":
            torch.set_num_threads(1)
        else:
            torch.cuda.set_device(device)
        os.environ["LOCAL_RANK"] = str(rank)
        dist.init_process_group(
            backend, init_method=init_method, world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S),
            # NCCL binds the rank's communicators to its card up front
            device_id=device if backend == "nccl" else None)
        try:
            out = fn(rank, device, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except Exception:  # the rank's boundary: report, then fail the rank
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)


def spawn(fn, world: int, backend: str = "gloo", device_of_rank=None,
          timeout_s: float = 120.0, args=()):
    """Run fn(rank, device, *args) in `world` new processes joined in one
    process group; returns the ranks' results, by rank.

    The processes start with the `spawn` method (a parent that has
    initialised CUDA cannot fork) and meet through a file under a new
    temporary directory, so concurrent calls never share a port. fn must
    be importable by name (a module-level function) and return something
    picklable. device_of_rank(rank) gives each rank's device (evaluated
    here, before any process starts); by default cuda:<rank % cards>.
    Every collective times out after COLLECTIVE_TIMEOUT_S. A rank
    that fails raises RuntimeError with its traceback here; if the ranks
    are not all done within timeout_s, they are killed and TimeoutError
    is raised. No process outlives the call."""
    if device_of_rank is None:
        device_of_rank = default_device
    devices = [str(device_of_rank(r)) for r in range(world)]
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(
            target=_rank_main, daemon=True,
            args=(fn, r, world, backend, devices[r], init, tuple(args),
                  results))
            for r in range(world)]
        deadline = time.monotonic() + timeout_s
        try:
            for p in procs:
                p.start()
            while len(out) < world:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"ranks {sorted(set(range(world)) - set(out))} not "
                        f"done within {timeout_s} s")
                try:
                    rank, ok, val = results.get(timeout=min(left, 0.5))
                except queue_mod.Empty:
                    gone = [r for r, p in enumerate(procs)
                            if r not in out and p.exitcode is not None]
                    if gone:
                        raise RuntimeError(
                            f"rank {gone[0]} exited with code "
                            f"{procs[gone[0]].exitcode} and no result")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{val}")
                out[rank] = val
            for p in procs:
                p.join(timeout=max(deadline - time.monotonic(), 1.0))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join(timeout=10.0)
            results.close()
    return [out[r] for r in range(world)]
