// Window-local gather of minimal-sample rows, by local index or by rank
// among a window's available rows.
//
// Replaces the TPU kernel multih_tpu/ops/kernels/gather_kernel.py
// (_gather_kernel, launched by window_gather). The TPU has no per-lane
// gather, so that kernel builds a (3B, T) one-hot and contracts it on the
// MXU; the card loads by index, so here one thread serves one
// (window, selection) pair: "index" mode copies the C channels of row
// sel, "rank" mode binary-searches the window's monotone cumulative
// availability channel for the first row with cum >= r + 1 (the
// reference's searchsorted), which is the r-th available row. A pick out
// of range, or a rank at or past the window's available count, gives an
// all-zero column. Any T; no padding.
//
// Bound on the H100: bytes. The (nb, C, T) output is written once, in
// coalesced stores (neighbouring threads, neighbouring selections); the
// window rows are read from L2 (nb * 3B * C floats, 2 MB at the stress
// shape) and the rank search reads log2(3B) cum entries per selection.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
window_gather_kernel(const float* __restrict__ win,
                     const int* __restrict__ sel, int rows, int c, int t,
                     int rank_mode, int cum_ch, float* __restrict__ out) {
  const int tt = blockIdx.x * kThreads + threadIdx.x;
  if (tt >= t) return;
  const int v = blockIdx.y;
  const int s = sel[static_cast<size_t>(v) * t + tt];
  const float* w = win + static_cast<size_t>(v) * rows * c;
  int idx = s;
  bool ok = s >= 0 && s < rows;
  if (rank_mode) {
    const float key = static_cast<float>(s) + 0.5f;
    int lo = 0, hi = rows;  // first row with cum >= key, or rows
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (w[mid * c + cum_ch] < key)
        lo = mid + 1;
      else
        hi = mid;
    }
    idx = lo;
    ok = s >= 0 && idx < rows &&
         static_cast<float>(s) < w[(rows - 1) * c + cum_ch];
  }
  float* o = out + static_cast<size_t>(v) * c * t + tt;
  const float* src = w + static_cast<size_t>(ok ? idx : 0) * c;
  for (int ch = 0; ch < c; ++ch)
    o[static_cast<size_t>(ch) * t] = ok ? src[ch] : 0.f;
}

}  // namespace

extern "C" int multih_window_gather(const float* win, const int* sel, int nb,
                                    int rows, int c, int t, int rank_mode,
                                    int cum_ch, float* out, void* stream) {
  if (nb <= 0 || t <= 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid((t + kThreads - 1) / kThreads, nb);
  window_gather_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      win, sel, rows, c, t, rank_mode, cum_ch, out);
  return static_cast<int>(cudaGetLastError());
}
