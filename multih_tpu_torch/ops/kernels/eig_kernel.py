"""Batched smallest eigenvector of 9x9 symmetric matrices: the CUDA
Jacobi kernel and its plain PyTorch version.

Replaces ``multih_tpu/ops/kernels/eig_kernel.py`` (``_eig_kernel`` ->
``jacobi_smallest_column`` via ``smallest_eigvec_9x9_batch``). The kernel
(``csrc/eig_kernel.cu``) is bound by registers and the serial rotation
chain (~13k flops per matrix on 126 live entries), not by memory. One
thread per matrix keeps A's 45 unique entries and V's 81 in registers
through six fully unrolled cyclic Jacobi sweeps with the trig-free
rotation of the JAX kernel.

Tolerance: kernel vs the plain Jacobi below, sign-aligned, <= 1e-4; the
plain Jacobi vs ``torch.linalg.eigh`` <= 5e-3 (the JAX kernel test's
bound against its arctan2 reference).
"""

from __future__ import annotations

import torch

from multih_tpu_torch.ops.kernels import _build

_N = 9


def jacobi_smallest_column(A, sweeps: int):
    """The kernel's math on tensors: A is a 9x9 nested list of (C,)
    tensors (one matrix entry across the batch); returns the 9 components
    of the eigenvector of the smallest eigenvalue (first on ties)."""
    one = torch.ones_like(A[0][0])
    zero = torch.zeros_like(A[0][0])
    V = [[one if i == j else zero for j in range(_N)] for i in range(_N)]
    eps = 1e-30
    for _ in range(sweeps):
        for p in range(_N - 1):
            for q in range(p + 1, _N):
                app, aqq, apq = A[p][p], A[q][q], A[p][q]
                tiny = apq.abs() < eps
                theta = (aqq - app) / (2.0 * torch.where(tiny, eps, apq))
                # not sign(): sign(0) = 0 would leave the pivot unzeroed at
                # aqq == app, where the right rotation is 45 degrees
                sgn = torch.where(theta >= 0.0, 1.0, -1.0)
                t = sgn / (theta.abs() + torch.sqrt(theta * theta + 1.0))
                t = torch.where(tiny, 0.0, t)
                c = torch.rsqrt(t * t + 1.0)
                s = t * c
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


def smallest_eigvec_9x9_batch_reference(ata: torch.Tensor,
                                        sweeps: int = 6) -> torch.Tensor:
    """Plain version (the JAX package's smallest_eigvec_9x9_batch_jnp):
    (C, 9, 9) -> (C, 9) unit vectors."""
    A = [[ata[:, i, j] for j in range(_N)] for i in range(_N)]
    v = torch.stack(jacobi_smallest_column(A, sweeps), dim=1)
    return v / torch.clamp_min(
        torch.linalg.vector_norm(v, dim=1, keepdim=True), 1e-12)


def smallest_eigvec_9x9_batch(ata: torch.Tensor) -> torch.Tensor:
    """(C, 9, 9) symmetric -> (C, 9) unit eigenvectors of the smallest
    eigenvalue, 6 Jacobi sweeps. A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel (which reads the upper triangle)."""
    if ata.dim() != 3 or ata.shape[1:] != (_N, _N):
        raise ValueError(f"expected (C, 9, 9), got {tuple(ata.shape)}")
    if ata.device.type == "cpu":
        return smallest_eigvec_9x9_batch_reference(ata)
    ata = ata.contiguous()
    _build.require_cuda(ata)
    c = ata.shape[0]
    out = torch.empty((c, _N), dtype=torch.float32, device=ata.device)
    rc = _build.load().multih_eig9_smallest(
        ata.data_ptr(), c, out.data_ptr(), _build.stream_handle(ata)
    )
    _build.check(rc, "smallest_eigvec_9x9_batch")
    smallest_eigvec_9x9_batch.launches += 1
    return out


smallest_eigvec_9x9_batch.launches = 0
