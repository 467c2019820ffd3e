// Window-local gather of minimal-sample rows, by local index or by rank
// among a window's available rows.
//
// Replaces the TPU kernel multih_tpu/ops/kernels/gather_kernel.py
// (_gather_kernel, launched by window_gather). The TPU has no per-lane
// gather, so that kernel builds a (3B, T) one-hot and contracts it on the
// MXU; the card loads by index. "index" mode copies the C channels of
// row sel, "rank" mode binary-searches the window's monotone cumulative
// availability channel for the first row with cum >= r + 0.5 (the
// reference's searchsorted), which is the r-th available row. A pick out
// of range, or a rank at or past the window's available count, gives an
// all-zero column. Any T; no padding.
//
// Bound on the H100: bytes (the (nb, C, T) output, written once). Design:
// one block per (window, run of t_block selections). Its first thread
// stages the window's R x C rows in shared memory with one TMA bulk copy
// (cp.async.bulk, completing on an mbarrier) while every thread loads its
// first selection; the rank search and the row reads (float4 where C
// allows) then run in shared memory, and the stores stay coalesced along
// T (neighbouring threads, neighbouring selections). The window's bytes
// and base address are multiples of 16 (the wrapper checks), and above
// 48 KB of shared memory the launch raises the kernel's dynamic limit.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__global__ void __launch_bounds__(kThreads)
window_gather_kernel(const float* __restrict__ win,
                     const int* __restrict__ sel, int rows, int c, int t,
                     int t_block, int rank_mode, int cum_ch,
                     float* __restrict__ out) {
  extern __shared__ __align__(16) float w[];  // the window, rows x c
  __shared__ __align__(8) uint64_t bar;
  const int v = blockIdx.y;
  const int t0 = blockIdx.x * t_block;
  const int t1 = min(t0 + t_block, t);
  const uint32_t bytes = static_cast<uint32_t>(rows) * c * 4;
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                     smem_addr(&bar))
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
            smem_addr(&bar)),
        "r"(bytes)
        : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(w)),
        "l"(win + static_cast<size_t>(v) * rows * c), "r"(bytes),
        "r"(smem_addr(&bar))
        : "memory");
  }
  const int* s_v = sel + static_cast<size_t>(v) * t;
  int tt = t0 + threadIdx.x;
  int s = tt < t1 ? s_v[tt] : 0;  // in flight while the window arrives
  uint32_t ready = 0;
  while (!ready) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ready)
        : "r"(smem_addr(&bar)), "r"(0u)  // the first phase
        : "memory");
  }

  // rank mode: the window's available count
  const float count = rank_mode ? w[(rows - 1) * c + cum_ch] : 0.f;
  float* o_v = out + static_cast<size_t>(v) * c * t;
  const bool vec = (c & 3) == 0;
  for (; tt < t1; tt += kThreads) {
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
      ok = s >= 0 && idx < rows && static_cast<float>(s) < count;
    }
    const float* src = w + (ok ? idx : 0) * c;
    float* o = o_v + tt;
    if (vec) {
      for (int ch = 0; ch < c; ch += 4) {
        const float4 x = ok ? *reinterpret_cast<const float4*>(src + ch)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
        o[static_cast<size_t>(ch) * t] = x.x;
        o[static_cast<size_t>(ch + 1) * t] = x.y;
        o[static_cast<size_t>(ch + 2) * t] = x.z;
        o[static_cast<size_t>(ch + 3) * t] = x.w;
      }
    } else {
      for (int ch = 0; ch < c; ++ch)
        o[static_cast<size_t>(ch) * t] = ok ? src[ch] : 0.f;
    }
    if (tt + kThreads < t1) s = s_v[tt + kThreads];
  }
}

}  // namespace

// win: (nb, rows, c) float32, each window's rows * c * 4 bytes a multiple
// of 16 at a 16-byte aligned base, at most the dynamic shared memory a
// block may take; sel: (nb, t) int32; out: (nb, c, t). One block per
// window and run of t_block selections.
extern "C" int multih_window_gather(const float* win, const int* sel, int nb,
                                    int rows, int c, int t, int t_block,
                                    int rank_mode, int cum_ch, float* out,
                                    void* stream) {
  if (nb <= 0 || t <= 0) return static_cast<int>(cudaGetLastError());
  const int smem = rows * c * 4;
  // the default dynamic limit is 48 KB less the static mbarrier
  static int smem_allowed = 47 * 1024;
  if (smem > smem_allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        window_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_allowed = smem;
  }
  t_block = t_block < t ? t_block : t;
  const dim3 grid((t + t_block - 1) / t_block, nb);
  window_gather_kernel<<<grid, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      win, sel, rows, c, t, t_block, rank_mode, cum_ch, out);
  return static_cast<int>(cudaGetLastError());
}
