// Fused PEARL relaxation sweeps over a far-free banded adjacency: annealed
// mean-field (all sweeps) and batched red-black ICM (all half-sweeps of S
// starts).
//
// Replaces the TPU kernels multih_tpu/ops/kernels/mrf_kernel.py
// (_mf_kernel, launched by mean_field_fused; _icm_kernel, launched by
// icm_fused). The TPU grid runs (sweep, block) in order with the state in
// VMEM. Here sweep s+1 of Morton block b needs sweep s of blocks b-1, b
// and b+1, so the barrier between sweeps is the launch boundary: one
// launch per sweep (per half-sweep for ICM), the state double-buffered in
// device memory, all launches issued by one C entry point.
//
// Bound on the H100: the band read. Each sweep streams the (nb, B, 3B)
// float32 band once (15.7 MB at N=10240, B=128) against ~12 non-zeros per
// row, and the per-launch cost (a few microseconds) is of the same order
// as that read at these sizes. Design: one warp per point, i.e. per band
// row. The 32 lanes read the row's 3B entries in coalesced 128-byte
// steps, and for each non-zero w at window column c (global index
// (b-1)*B + c; out of range reads zero, label -1, never wrapping) add
// w * q[:, g] (ICM: w to the accumulator of label lab[g]) into L
// per-lane sums, kept in registers (L <= LMAX, unrolled, so no local
// memory). A butterfly of shuffles gives every lane the same L totals
// (addition commutes exactly), and every lane finishes the point: the
// label softmax (ICM: the first-minimum argmin and the move test). The
// neighbours' state is read from L2; the ICM warp also copies its
// neighbour of the other parity, so half-sweeps launch N/2 warps.
//
// Arithmetic is that of the plain versions in ops/kernels/mrf_kernel.py:
// sw*agree and the subtraction from base are rounded separately
// (__fmul_rn / __fsub_rn, no FMA contraction), and ICM's agreements are
// sums of band values {0.5, 1}, exact in any order, so its costs, and
// its labels, equal the plain version's exactly.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;  // points (warps) per block
constexpr unsigned kFull = 0xffffffffu;

// acc[j] (each lane's partial sums) -> the warp's totals, in every lane.
template <int LMAX>
__device__ __forceinline__ void warp_sum(float* acc, int l) {
#pragma unroll
  for (int j = 0; j < LMAX; ++j) {
    if (j < l) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[j] = __fadd_rn(acc[j], __shfl_xor_sync(kFull, acc[j], off));
    }
  }
}

// One mean-field sweep: dst = softmax_l(-(base - sw*agree(src)) * it).
template <int LMAX>
__global__ void __launch_bounds__(kWarps * 32)
mf_sweep(const float* __restrict__ src, const float* __restrict__ base,
         const float* __restrict__ band, const float* __restrict__ inv_temps,
         int sweep, int l, int n, int block, float sw,
         float* __restrict__ dst) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i >= n) return;  // uniform across the warp
  const int bb = 3 * block;
  const int g0 = (i / block - 1) * block;
  const float* brow = band + static_cast<size_t>(i) * bb;
  float acc[LMAX];
#pragma unroll
  for (int j = 0; j < LMAX; ++j) acc[j] = 0.f;
  for (int c = lane; c < bb; c += 32) {
    const float w = brow[c];
    const int g = g0 + c;
    if (w != 0.f && g >= 0 && g < n) {
#pragma unroll
      for (int j = 0; j < LMAX; ++j)
        if (j < l)
          acc[j] = __fmaf_rn(w, src[static_cast<size_t>(j) * n + g], acc[j]);
    }
  }
  warp_sum<LMAX>(acc, l);

  const float it = inv_temps[sweep];
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < LMAX; ++j) {
    if (j < l) {
      const float cost = __fsub_rn(base[static_cast<size_t>(j) * n + i],
                                   __fmul_rn(sw, acc[j]));
      acc[j] = __fmul_rn(-cost, it);
      m = fmaxf(m, acc[j]);
    }
  }
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < LMAX; ++j) {
    if (j < l) {
      acc[j] = expf(__fsub_rn(acc[j], m));
      sum = __fadd_rn(sum, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < LMAX; ++j)
    if (j < l && (j & 31) == lane)
      dst[static_cast<size_t>(j) * n + i] = __fdiv_rn(acc[j], sum);
}

// One ICM half-sweep of start blockIdx.y: the point of index parity `par`
// in each pair (2p, 2p+1) moves to its first cheapest label when that
// beats its current one by more than 1e-6; the other keeps its label.
template <int LMAX>
__global__ void __launch_bounds__(kWarps * 32)
icm_half(const int* __restrict__ src, const float* __restrict__ base,
         const float* __restrict__ band, int par, int l, int n, int block,
         float sw, int* __restrict__ dst) {
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int* lab = src + static_cast<size_t>(blockIdx.y) * n;
  int* out = dst + static_cast<size_t>(blockIdx.y) * n;
  const int i = 2 * p + par;
  const int keep = 2 * p + (1 - par);
  if (lane == 0 && keep < n) out[keep] = lab[keep];
  if (i >= n) return;  // uniform across the warp
  const int bb = 3 * block;
  const int g0 = (i / block - 1) * block;
  const float* brow = band + static_cast<size_t>(i) * bb;
  float acc[LMAX];
#pragma unroll
  for (int j = 0; j < LMAX; ++j) acc[j] = 0.f;
  for (int c = lane; c < bb; c += 32) {
    const float w = brow[c];
    const int g = g0 + c;
    if (w != 0.f && g >= 0 && g < n) {
      const int lc = lab[g];
#pragma unroll
      for (int j = 0; j < LMAX; ++j)
        if (j == lc) acc[j] = __fadd_rn(acc[j], w);
    }
  }
  warp_sum<LMAX>(acc, l);

  const int cur = lab[i];
  float new_c = 0.f, cur_c = 0.f;
  int best = 0;
#pragma unroll
  for (int j = 0; j < LMAX; ++j) {
    if (j < l) {
      const float cost = __fsub_rn(base[static_cast<size_t>(j) * n + i],
                                   __fmul_rn(sw, acc[j]));
      if (j == 0 || cost < new_c) {
        new_c = cost;
        best = j;
      }
      if (j == cur) cur_c = cost;
    }
  }
  if (lane == 0) out[i] = new_c < __fsub_rn(cur_c, 1e-6f) ? best : cur;
}

template <int LMAX>
int mean_field(const float* q0, const float* base, const float* band,
               const float* inv_temps, int n_sweeps, int l, int nb,
               int block, float sw, float* out, float* tmp,
               cudaStream_t st) {
  const int n = nb * block;
  const int grid = (n + kWarps - 1) / kWarps;
  const float* src = q0;
  for (int s = 0; s < n_sweeps; ++s) {
    // the last sweep writes `out`, the ones before alternate
    float* dst = ((n_sweeps - 1 - s) % 2 == 0) ? out : tmp;
    mf_sweep<LMAX><<<grid, kWarps * 32, 0, st>>>(src, base, band, inv_temps,
                                                 s, l, n, block, sw, dst);
    const int rc = static_cast<int>(cudaGetLastError());
    if (rc) return rc;
    src = dst;
  }
  return 0;
}

template <int LMAX>
int icm(const int* labels0, const float* base, const float* band,
        int iterations, int ns, int l, int nb, int block, float sw, int* out,
        int* tmp, cudaStream_t st) {
  const int n = nb * block;
  const dim3 grid(((n + 1) / 2 + kWarps - 1) / kWarps, ns);
  const int halves = 2 * iterations;
  const int* src = labels0;
  for (int h = 0; h < halves; ++h) {
    int* dst = ((halves - 1 - h) % 2 == 0) ? out : tmp;
    icm_half<LMAX><<<grid, kWarps * 32, 0, st>>>(src, base, band, h % 2, l,
                                                 n, block, sw, dst);
    const int rc = static_cast<int>(cudaGetLastError());
    if (rc) return rc;
    src = dst;
  }
  return 0;
}

}  // namespace

extern "C" int multih_mean_field(const float* q0, const float* base,
                                 const float* band, const float* inv_temps,
                                 int n_sweeps, int l, int nb, int block,
                                 float sw, float* out, float* tmp,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (l <= 16)
    return mean_field<16>(q0, base, band, inv_temps, n_sweeps, l, nb, block,
                          sw, out, tmp, st);
  if (l <= 32)
    return mean_field<32>(q0, base, band, inv_temps, n_sweeps, l, nb, block,
                          sw, out, tmp, st);
  if (l <= 64)
    return mean_field<64>(q0, base, band, inv_temps, n_sweeps, l, nb, block,
                          sw, out, tmp, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int multih_icm(const int* labels0, const float* base,
                          const float* band, int iterations, int ns, int l,
                          int nb, int block, float sw, int* out, int* tmp,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (l <= 16)
    return icm<16>(labels0, base, band, iterations, ns, l, nb, block, sw, out,
                   tmp, st);
  if (l <= 32)
    return icm<32>(labels0, base, band, iterations, ns, l, nb, block, sw, out,
                   tmp, st);
  if (l <= 64)
    return icm<64>(labels0, base, band, iterations, ns, l, nb, block, sw, out,
                   tmp, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
