"""Batched smallest eigenvector of 9x9 symmetric matrices: the CUDA
Jacobi kernel and its plain PyTorch versions; and the batched moment
refit around it (`moment_refit_batch`): the refit's assembly and
denormalization kernels (csrc/refit_kernel.cu) with the Jacobi kernel
between them, three launches from moments to models.

Replaces ``multih_tpu/ops/kernels/eig_kernel.py`` (``_eig_kernel`` ->
``jacobi_smallest_column`` via ``smallest_eigvec_9x9_batch``). The kernel
(``csrc/eig_kernel.cu``) is bound by the serial chain of its rotations,
not by memory or flops. It runs the same six Jacobi sweeps with the JAX
kernel's trig-free rotation, but in a parallel (round-robin) order: each
sweep is 9 rounds of 4 disjoint rotations (`ROUNDS`), so the chain is
54 rounds, not 216 rotations. Nine lanes of a warp hold one matrix, a
row of A and of V each. It reads the lower triangle, as
``torch.linalg.eigh`` (the CPU fits' solver) does and as the cyclic
order's updates come to follow: a float32 normal matrix is symmetric
only to rounding, and at the F refits' smallest eigenvalue gaps the two
triangles' eigenvectors differ by about the float32 floor below.

Two plain versions:
  - ``smallest_eigvec_9x9_batch_reference``: the cyclic order, the JAX
    package's ``smallest_eigvec_9x9_batch_jnp`` op for op. The wrapper
    returns it for a CPU tensor.
  - ``smallest_eigvec_9x9_round_robin_reference``: the kernel's order and
    rounding (no fused multiply-adds, 1 / sqrt), the one the kernel is
    held to on the card.

Tolerances: the kernel vs the round-robin plain version, sign-aligned,
<= 1e-5 where the float32 eigenvector floor eps32 * lam_max / (lam_2 -
lam_1) is below 1e-5; either order within 1e-4 of the other there, and
within twice that floor of float64 ``eigh`` on every matrix.
"""

from __future__ import annotations

import torch

from multih_tpu_torch.ops.kernels import _build

_N = 9
_TINY = 1e-30
# The round-robin (circle method) schedule over 9 indices padded to 10:
# in round r the pad meets r, which does not rotate, and (r + k) % 9
# meets (r - k) % 9 for k = 1..4. Every pair (p < q) comes once a sweep;
# p + q = 2r (mod 9) names its round. csrc/eig_kernel.cu computes the
# same pairs at compile time.
ROUNDS = tuple(
    tuple(tuple(sorted(((r + k) % _N, (r - k) % _N))) for k in range(1, 5))
    for r in range(_N))


def jacobi_smallest_column(A, sweeps: int):
    """The cyclic order on tensors: A is a 9x9 nested list of (C,)
    tensors (one matrix entry across the batch); returns the 9 components
    of the eigenvector of the smallest eigenvalue (first on ties)."""
    one = torch.ones_like(A[0][0])
    zero = torch.zeros_like(A[0][0])
    V = [[one if i == j else zero for j in range(_N)] for i in range(_N)]
    for _ in range(sweeps):
        for p in range(_N - 1):
            for q in range(p + 1, _N):
                app, aqq, apq = A[p][p], A[q][q], A[p][q]
                c, s = _rotation(app, aqq, apq, torch.rsqrt)
                for k in range(_N):
                    if k in (p, q):
                        continue
                    akp, akq = A[k][p], A[k][q]
                    nkp = c * akp - s * akq
                    nkq = s * akp + c * akq
                    A[k][p] = A[p][k] = nkp
                    A[k][q] = A[q][k] = nkq
                A[p][p] = c * c * app - 2.0 * s * c * apq + s * s * aqq
                A[q][q] = s * s * app + 2.0 * s * c * apq + c * c * aqq
                A[p][q] = A[q][p] = zero
                for k in range(_N):
                    vkp, vkq = V[k][p], V[k][q]
                    V[k][p] = c * vkp - s * vkq
                    V[k][q] = s * vkp + c * vkq
    best_val = A[0][0]
    best_col = [V[k][0] for k in range(_N)]
    for j in range(1, _N):
        take = A[j][j] < best_val
        best_val = torch.where(take, A[j][j], best_val)
        for k in range(_N):
            best_col[k] = torch.where(take, V[k][j], best_col[k])
    return best_col


def _rotation(app, aqq, apq, rsqrt):
    """(c, s) of the trig-free Jacobi rotation zeroing apq: t =
    sign(theta) / (|theta| + sqrt(theta^2 + 1)), t = 0 where |apq| <
    1e-30, c = rsqrt(t^2 + 1), s = t c."""
    tiny = apq.abs() < _TINY
    theta = (aqq - app) / (2.0 * torch.where(tiny, _TINY, apq))
    # not sign(): sign(0) = 0 would leave the pivot unzeroed at
    # aqq == app, where the right rotation is 45 degrees
    sgn = torch.where(theta >= 0.0, 1.0, -1.0)
    t = sgn / (theta.abs() + torch.sqrt(theta * theta + 1.0))
    t = torch.where(tiny, 0.0, t)
    c = rsqrt(t * t + 1.0)
    return c, t * c


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp_min(
        torch.linalg.vector_norm(v, dim=1, keepdim=True), 1e-12)


def smallest_eigvec_9x9_batch_reference(ata: torch.Tensor,
                                        sweeps: int = 6) -> torch.Tensor:
    """Plain version in the cyclic order (the JAX package's
    smallest_eigvec_9x9_batch_jnp): (C, 9, 9) -> (C, 9) unit vectors."""
    A = [[ata[:, i, j] for j in range(_N)] for i in range(_N)]
    return _unit(torch.stack(jacobi_smallest_column(A, sweeps), dim=1))


def smallest_eigvec_9x9_round_robin_reference(ata: torch.Tensor,
                                              sweeps: int = 6
                                              ) -> torch.Tensor:
    """Plain version in the kernel's order: the lower triangle of each
    (C, 9, 9) matrix, `sweeps` sweeps of the 9 `ROUNDS`, each round's 4
    rotations from the round's starting A, applied as the kernel's lanes
    apply them (A <- A J and V <- V J by columns, then A <- J^T A by
    rows, then the 2x2 pivot blocks set as in the cyclic order) ->
    (C, 9) unit vectors."""
    a = torch.tril(ata)
    a = a + torch.tril(ata, -1).transpose(1, 2)
    v = torch.eye(_N, dtype=ata.dtype, device=ata.device).repeat(
        ata.shape[0], 1, 1)
    rsqrt = lambda x: 1.0 / torch.sqrt(x)  # noqa: E731  (the kernel's)
    for _ in range(sweeps):
        for pairs in ROUNDS:
            p = [pq[0] for pq in pairs]
            q = [pq[1] for pq in pairs]
            app, aqq, apq = a[:, p, p], a[:, q, q], a[:, p, q]  # (C, 4)
            c, s = _rotation(app, aqq, apq, rsqrt)
            cc, ss = c[:, None, :], s[:, None, :]
            for m in (a, v):  # columns
                mp, mq = m[:, :, p], m[:, :, q]
                m[:, :, p] = cc * mp - ss * mq
                m[:, :, q] = ss * mp + cc * mq
            cr, sr = c[:, :, None], s[:, :, None]  # rows
            ap, aq = a[:, p, :], a[:, q, :]
            a[:, p, :] = cr * ap - sr * aq
            a[:, q, :] = sr * ap + cr * aq
            a[:, p, p] = c * c * app - 2.0 * s * c * apq + s * s * aqq
            a[:, q, q] = s * s * app + 2.0 * s * c * apq + c * c * aqq
            a[:, p, q] = 0.0
            a[:, q, p] = 0.0
    d = torch.diagonal(a, dim1=1, dim2=2)
    # first minimum, as the cyclic selection's strict < keeps it
    j = torch.argmin(d, dim=1)
    col = torch.gather(v, 2, j[:, None, None].expand(-1, _N, 1))[..., 0]
    return _unit(col)


def smallest_eigvec_9x9_batch(ata: torch.Tensor) -> torch.Tensor:
    """(C, 9, 9) symmetric -> (C, 9) unit eigenvectors of the smallest
    eigenvalue, 6 Jacobi sweeps. A CPU tensor takes the cyclic plain
    version; a CUDA float32 tensor launches the kernel (round-robin
    order; it reads the lower triangle)."""
    if ata.dim() != 3 or ata.shape[1:] != (_N, _N):
        raise ValueError(f"expected (C, 9, 9), got {tuple(ata.shape)}")
    if ata.device.type == "cpu":
        return smallest_eigvec_9x9_batch_reference(ata)
    ata = ata.contiguous()
    _build.require_cuda(ata)
    c = ata.shape[0]
    out = torch.empty((c, _N), dtype=torch.float32, device=ata.device)
    _build.check(_build.load().multih_eig9_smallest(
        ata.data_ptr(), c, out.data_ptr(), _build.stream_handle(ata)),
        "smallest_eigvec_9x9_batch")
    smallest_eigvec_9x9_batch.launches += 1
    return out


smallest_eigvec_9x9_batch.launches = 0


# the moment table's width of each model class
_MOMENT_WIDTH = {"homography": 30, "fundamental": 36}


def moment_refit_reference(mom: torch.Tensor, model: str,
                           T1g: torch.Tensor, T2g: torch.Tensor
                           ) -> torch.Tensor:
    """Plain version of `moment_refit_batch`: the model's plain refit
    from moments (geometry.homography_from_moments /
    fmodel.fundamental_from_moments) with `smallest_eigvec_9x9_batch` as
    its eigensolve."""
    from multih_tpu_torch.ops import fmodel, geometry

    plain = (geometry.homography_from_moments if model == "homography"
             else fmodel.fundamental_from_moments)
    return plain(mom, T1g, T2g, smallest_eigvec_9x9_batch)


def moment_refit_batch(mom: torch.Tensor, model: str, T1g: torch.Tensor,
                       T2g: torch.Tensor) -> torch.Tensor:
    """(C, 30) homography or (C, 36) fundamental moment tables (the
    refit's `weights @ basis.feats`) and the basis's (3, 3) global
    similarities -> (C, 3, 3) models: H Frobenius-normalized with h33 >=
    0, F rank 2, Frobenius-normalized with its largest entry positive. A
    CPU tensor takes the plain version; a CUDA float32 tensor launches
    the refit's assembly kernel (the normalized normal matrices and the
    Hartley parameters), `smallest_eigvec_9x9_batch` on the matrices,
    and the denormalization kernel (csrc/refit_kernel.cu)."""
    width = _MOMENT_WIDTH.get(model)
    if width is None:
        raise ValueError(f"model {model!r}: homography or fundamental")
    if mom.dim() != 2 or mom.shape[1] != width:
        raise ValueError(f"expected (C, {width}) {model} moments, got "
                         f"{tuple(mom.shape)}")
    if mom.dtype != torch.float32:
        raise ValueError(f"expected float32 moments, got {mom.dtype}")
    for name, T in (("T1g", T1g), ("T2g", T2g)):
        if T.shape != (3, 3):
            raise ValueError(f"expected a (3, 3) {name}, got "
                             f"{tuple(T.shape)}")
    if mom.device.type == "cpu":
        return moment_refit_reference(mom, model, T1g, T2g)
    mom, T1g, T2g = mom.contiguous(), T1g.contiguous(), T2g.contiguous()
    _build.require_cuda(mom, T1g, T2g)
    c, fundamental = mom.shape[0], int(model == "fundamental")
    lib, stream = _build.load(), _build.stream_handle(mom)
    ata = torch.empty((c, _N, _N), dtype=torch.float32, device=mom.device)
    params = torch.empty((c, 6), dtype=torch.float32, device=mom.device)
    _build.check(lib.multih_moment_refit_assemble(
        mom.data_ptr(), c, fundamental, ata.data_ptr(), params.data_ptr(),
        stream), "moment_refit_batch")
    vec = smallest_eigvec_9x9_batch(ata)
    out = torch.empty((c, 3, 3), dtype=torch.float32, device=mom.device)
    _build.check(lib.multih_moment_refit_denormalize(
        vec.data_ptr(), params.data_ptr(), c, fundamental, T1g.data_ptr(),
        T2g.data_ptr(), out.data_ptr(), stream), "moment_refit_batch")
    moment_refit_batch.launches += 1
    moment_refit_batch.model_launches[model] += 1
    return out


moment_refit_batch.launches = 0
# the same calls, by model class
moment_refit_batch.model_launches = dict.fromkeys(_MOMENT_WIDTH, 0)
