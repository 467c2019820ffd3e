"""The least time the card could take for each launch of the port's CUDA
kernels, from the launch's shapes.

Each launch's bound is the larger of its bytes at the HBM rate and its
operations at the float32 rate (the reciprocals of K1's fast path at the
MUFU rate too; K2's float64 solve given as the float32 operations of the
same time). Bytes count each input read once and each output written
once; operations are counted from the kernels' formulas. Where the work
depends on the data (the neighbour list's pairs), it is counted from the
launch's own inputs. The arithmetic and the constants are the ones
PERF.md's kernel table was computed with.

The peaks are NVIDIA's data sheet figures for one H100 SXM at its 700 W
limit; `power_limit` reads the card's limit so that it is published
beside every share.
"""

from __future__ import annotations

import subprocess

# H100 SXM: HBM bytes/s, float32 and float64 FLOP/s outside the tensor
# cores, and the MUFU rate (16 a cycle on each of 132 SMs at 1.98 GHz)
PEAK_BYTES_S = 3.35e12
PEAK_FLOP_S = 67e12
PEAK_FP64_S = 34e12
PEAK_MUFU_S = 16 * 132 * 1.98e9

# operations per (hypothesis, point) pair of the count kernel (K1), by
# residual kind, and its reciprocals per pair
COUNT_OPS = {"symmetric": 40, "transfer": 20, "sampson": 52,
             "f_symmetric": 39, "f_transfer": 25, "f_sampson": 37}
COUNT_RCPS = {"symmetric": 2, "transfer": 1, "sampson": 1,
              "f_symmetric": 2, "f_transfer": 1, "f_sampson": 1}
# K2: float64 operations per 4-point solve (as float32 operations of the
# same time) and the float32 degeneracy tests; K3: per 9x9 eigensolve
DLT_OPS = 520 * PEAK_FLOP_S / PEAK_FP64_S
DLT_TEST_OPS = 70
EIG_OPS = 13000
# K6's front per (plane, point), by residual kind
FRONT_OPS = {"symmetric": 51, "transfer": 29}


def bound_s(n_bytes: float, n_ops: float, n_mufu: float = 0.0) -> float:
    """Seconds: the larger of the bytes at the HBM rate, the operations
    at the float32 rate and the reciprocals at the MUFU rate."""
    return max(n_bytes / PEAK_BYTES_S, n_ops / PEAK_FLOP_S,
               n_mufu / PEAK_MUFU_S)


def bound_by(n_bytes: float, n_ops: float, n_mufu: float = 0.0) -> str:
    """Which of the two rates bounds: "bytes" or "operations"."""
    t_ops = max(n_ops / PEAK_FLOP_S, n_mufu / PEAK_MUFU_S)
    return "bytes" if n_bytes / PEAK_BYTES_S >= t_ops else "operations"


def inlier_counts(s: int, n: int, kind: str, approx_rcp: bool = True):
    """K1: S hypotheses (3x3) over N points (x1, x2, valid) -> S counts."""
    return (4 * (s * 9 + 5 * n + s), s * n * COUNT_OPS[kind],
            s * n * COUNT_RCPS[kind] if approx_rcp else 0.0)


def dlt_4pt(s: int):
    """K2: S quads' (32, S) sampler rows -> S homographies and flags."""
    return 4 * 30 * s, (DLT_OPS + DLT_TEST_OPS) * s, 0.0


def eig9_smallest(c: int):
    """K3: C 9x9 symmetric matrices (lower triangle) -> C vectors."""
    return 4 * 90 * c, EIG_OPS * c, 0.0


def band_list(nb: int, block: int):
    """The neighbour list: an (nb, B, 3B) band -> (N, 3B) pairs and
    (N,) counts."""
    n = nb * block
    return 4 * nb * block * 3 * block + 8 * n * 3 * block + 4 * n, 0, 0.0


def mean_field_fused(l: int, n: int, sweeps: int, nnz: int):
    """K4: L labels x N points, `sweeps` annealed sweeps over the list's
    `nnz` pairs."""
    return (8 * nnz + 4 * n + 4 * (3 * l * n + sweeps),
            sweeps * (2 * nnz * l + 8 * l * n), 0.0)


def icm_fused(starts: int, l: int, n: int, half_sweeps: int, nnz: int):
    """K5: `starts` labelings of N points over L labels, `half_sweeps`
    red-black half-sweeps over the list's `nnz` pairs."""
    return (8 * nnz + 4 * n + 4 * (2 * starts * n + l * n),
            half_sweeps / 2 * starts * (nnz * l + 3 * l * n), 0.0)


def mean_field_fused_front(l: int, n: int, sweeps: int, nnz: int,
                           kind: str):
    """K6: K4 with the residual and data-cost front of L-1 planes."""
    k = l - 1
    n_bytes = (8 * nnz + 4 * n + 4 * (l * n + 6 * n + 10 * k + sweeps + 1)
               + 4 * (2 * l * n + k * n))
    n_ops = (sweeps * (2 * nnz * l + 8 * l * n) + FRONT_OPS[kind] * k * n
             + 3 * n + (27 * k if kind == "symmetric" else 0))
    return n_bytes, n_ops, 0.0


def window_gather(nb: int, rows: int, c: int, t: int):
    """K7: nb windows of (rows, C) -> (nb, C, T) selections."""
    return 4 * (nb * rows * c + nb * t + nb * c * t), 0, 0.0


WORK = {
    "inlier_counts": inlier_counts,
    "dlt_4pt": dlt_4pt,
    "eig9_smallest": eig9_smallest,
    "band_list": band_list,
    "mean_field_fused": mean_field_fused,
    "icm_fused": icm_fused,
    "mean_field_fused_front": mean_field_fused_front,
    "window_gather": window_gather,
}


def launch_bound_s(kernel: str, **shape) -> float:
    """The bound of one launch of `kernel` at `shape`, in seconds."""
    return bound_s(*WORK[kernel](**shape))


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi prints them, or
    "not read" where nvidia-smi does not answer."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "not read"
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else "not read"
