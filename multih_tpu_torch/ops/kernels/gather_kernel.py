"""Window-local gather of minimal-sample rows: the CUDA kernel and its
plain PyTorch version.

Replaces ``multih_tpu/ops/kernels/gather_kernel.py`` (``_gather_kernel``
via ``window_gather``). The TPU kernel contracts a one-hot selection
matrix with each window on the MXU because the TPU has no per-lane
gather; the card loads by index. The kernel (``csrc/gather_kernel.cu``)
is bound by the bytes of the output it writes: one block per (window,
run of `T_BLOCK` selections) stages the window in shared memory with one
TMA bulk copy, searches and reads rows there, and stores coalesced along
T. It takes any T (the TPU's 512-lane padding is not needed).

Contract (the plain version, ``window_gather_reference``, is the JAX
package's ``window_gather_reference``): win_src (nb, R, C) float32, sel
(nb, T) int32 -> (nb, C, T) float32.
  - "index": sel is a window-local row in [0, R); anything else gives an
    all-zero column.
  - "rank": sel is a rank among the window's available rows; channel
    CUM_CH holds the inclusive cumulative availability, and the row is
    the first with cum >= sel + 1 (searchsorted of sel + 0.5). A
    negative rank or one at or past the window's count cum[-1] gives an
    all-zero column.
Both are copies, so the kernel equals the plain version bit for bit.
The wrapper takes CUDA tensors only, whose windows (R * C * 4 bytes)
are multiples of 16 bytes, at most `MAX_WINDOW_BYTES`; the caller
(sampling.windowed_quadruples) takes the plain version for CPU tensors.
"""

from __future__ import annotations

import torch

from multih_tpu_torch.ops.kernels import _build

MODES = {"index": 0, "rank": 1}
CUM_CH = 5  # the windowed source's cumulative-availability channel
# selections per block: at the stress shapes (nb = 80 windows on 132 SMs)
# runs of 256 (5-7 blocks a window) took as little device time as 320 or
# 640 and less than 128 or whole windows (tools/torch_kernel_ab.py)
T_BLOCK = 256
# the shared memory a block may take (227 KB) less the copy's mbarrier
MAX_WINDOW_BYTES = 227 * 1024 - 16


def window_gather_reference(win_src: torch.Tensor, sel: torch.Tensor,
                            mode: str = "index") -> torch.Tensor:
    """Plain version: searchsorted + gather, zero where nothing is
    selected."""
    nb, rows, c = win_src.shape
    if mode == "index":
        idx = sel.long()
        ok = (sel >= 0) & (sel < rows)
    else:
        cum = win_src[:, :, CUM_CH].contiguous()
        key = sel.to(cum.dtype) + 0.5
        idx = torch.searchsorted(cum, key)
        ok = (sel >= 0) & (idx < rows) & (sel.to(cum.dtype) < cum[:, -1:])
    idx = torch.clamp(idx, 0, rows - 1)
    g = torch.gather(win_src, 1, idx[:, :, None].expand(-1, -1, c))
    g = torch.where(ok[:, :, None], g, 0.0)  # (nb, T, C)
    return g.transpose(1, 2)


def window_gather(win_src: torch.Tensor, sel: torch.Tensor,
                  mode: str = "index") -> torch.Tensor:
    """Window-local gather on the card: (nb, R, C) x (nb, T) int32 ->
    (nb, C, T). CUDA tensors only."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    _build.require_cuda(win_src)
    _build.require_cuda(sel, dtype=torch.int32)
    if win_src.dim() != 3 or sel.dim() != 2 or sel.shape[0] != \
            win_src.shape[0]:
        raise ValueError(f"win {tuple(win_src.shape)}, sel "
                         f"{tuple(sel.shape)}")
    nb, rows, c = win_src.shape
    if mode == "rank" and c <= CUM_CH:
        raise ValueError(f"rank mode needs channel {CUM_CH}, C={c}")
    window = 4 * rows * c
    if window % 16 or win_src.data_ptr() % 16 or not 0 < window <= \
            MAX_WINDOW_BYTES:
        raise ValueError(f"a window of {rows} x {c} floats at address "
                         f"{win_src.data_ptr():#x}: the kernel copies whole "
                         f"windows of a multiple of 16 bytes, 16-byte "
                         f"aligned, up to {MAX_WINDOW_BYTES}")
    t = sel.shape[1]
    out = torch.empty((nb, c, t), dtype=torch.float32, device=win_src.device)
    _build.check(_build.load().multih_window_gather(
        win_src.data_ptr(), sel.data_ptr(), nb, rows, c, t, T_BLOCK,
        MODES[mode], CUM_CH, out.data_ptr(), _build.stream_handle(win_src)),
        "window_gather")
    window_gather.launches += 1
    return out


window_gather.launches = 0
