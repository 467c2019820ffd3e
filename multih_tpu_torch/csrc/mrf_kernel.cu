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
//
// K6, the fused front (replaces _mf_front_kernel, launched by
// mean_field_fused_front): the homography residuals, the data costs and
// base = dct + sw*deg are computed per point in a pass over the points,
// as the TPU kernel does in its load pass, and every sweep follows. The
// first sweep of point i needs q0 (an input) and point i's own base
// only, so the front and sweep 0 share one launch (mf_front: the warp
// of point i computes its L costs, one label per lane, into shared
// memory, then runs the sweep on them) and the call keeps K4's
// n_sweeps launches; sweeps 1.. are K4's mf_sweep reading base from
// device memory. Bound: the band read, as K4; the front adds ~40
// operations per (label, point) and 8 + 3L floats per point. Residuals
// use IEEE division and the plain elementwise order (no FMA), so near
// a vanishing w (r up to 1e9 px^2) they stay the plain version's to
// float32 rounding; thr is read from device memory.

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

// Point i's mean-field update, by its warp: dst[:, i] = softmax_l(-(base_l
// - sw*agree_l(src)) * it), base_l read at base_i[l * bstride].
template <int LMAX>
__device__ __forceinline__ void mf_point(const float* __restrict__ src,
                                         const float* base_i, int bstride,
                                         const float* __restrict__ band,
                                         float it, int i, int lane, int l,
                                         int n, int block, float sw,
                                         float* __restrict__ dst) {
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

  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < LMAX; ++j) {
    if (j < l) {
      const float cost = __fsub_rn(base_i[static_cast<size_t>(j) * bstride],
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
  mf_point<LMAX>(src, base + i, n, band, inv_temps[sweep], i, lane, l, n,
                 block, sw, dst);
}

// geometry's w guard: |w| < 1e-12 -> +-1e-12 with w's sign.
__device__ __forceinline__ float safe_w(float w) {
  return fabsf(w) < 1e-12f ? (w < 0.f ? -1e-12f : 1e-12f) : w;
}

// a*x + b*y + c, each product and sum rounded on its own (no FMA), the
// order of the plain version's elementwise terms.
__device__ __forceinline__ float affine(float a, float x, float b, float y,
                                        float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y)), c);
}

__device__ __forceinline__ float sq(float a) { return __fmul_rn(a, a); }

// The fused front (K6) and the first sweep. Per point i (one warp), lane
// j mod 32 computes label j's squared residual r (forward transfer through
// hm row j's H, plus, when `symmetric`, the backward transfer through its
// adjugate), its truncated-quadratic data cost dct (labeling.data_costs_t:
// min(r/thr, 8)*oc, +1e6 on an inactive plane, oc on the outlier row L-1,
// times valid) and base = dct + sw*deg; writes r (labels < L-1), dct and
// base, and keeps base in shared memory for the warp. With `sweep` the
// warp then runs mean-field sweep 0 from q0, which needs only its own
// point's base; otherwise it copies q0 to dst (no sweeps).
template <int LMAX, bool SYMMETRIC>
__global__ void __launch_bounds__(kWarps * 32)
mf_front(const float* __restrict__ q0, const float* __restrict__ pts,
         const float* __restrict__ hm, const float* __restrict__ band,
         const float* __restrict__ inv_temps, const float* __restrict__ thr_p,
         int sweep, int l, int n, int block, float sw, float oc,
         float* __restrict__ dst, float* __restrict__ dct,
         float* __restrict__ r_out, float* __restrict__ base) {
  __shared__ float s_hm[LMAX * 19];
  __shared__ float s_base[kWarps][LMAX];
  for (int t = threadIdx.x; t < l * 19; t += blockDim.x) s_hm[t] = hm[t];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int i = blockIdx.x * kWarps + w;
  if (i >= n) return;  // uniform across the warp; no barrier follows
  const float x = pts[i], y = pts[n + i];
  const float u = pts[2 * n + i], v = pts[3 * n + i];
  const float valid = pts[4 * n + i], sw_deg = pts[5 * n + i];
  const float thr = *thr_p;
  const int k = l - 1;
  for (int j = lane; j < l; j += 32) {
    float d = oc;
    if (j < k) {
      const float* h = s_hm + j * 19;
      const float w1 = safe_w(affine(h[6], x, h[7], y, h[8]));
      const float px = __fdiv_rn(affine(h[0], x, h[1], y, h[2]), w1);
      const float py = __fdiv_rn(affine(h[3], x, h[4], y, h[5]), w1);
      float r = __fadd_rn(sq(__fsub_rn(px, u)), sq(__fsub_rn(py, v)));
      if (SYMMETRIC) {
        const float w2 = safe_w(affine(h[15], u, h[16], v, h[17]));
        const float bx = __fdiv_rn(affine(h[9], u, h[10], v, h[11]), w2);
        const float by = __fdiv_rn(affine(h[12], u, h[13], v, h[14]), w2);
        r = __fadd_rn(__fadd_rn(r, sq(__fsub_rn(bx, x))),
                      sq(__fsub_rn(by, y)));
      }
      r_out[static_cast<size_t>(j) * n + i] = r;
      float c = __fdiv_rn(r, thr);
      c = c > 8.f ? 8.f : c;  // clamp_max: NaN stays NaN
      d = __fadd_rn(__fmul_rn(c, oc),
                    __fmul_rn(__fsub_rn(1.f, h[18]), 1e6f));
    }
    d = __fmul_rn(d, valid);
    const float b = __fadd_rn(d, sw_deg);
    dct[static_cast<size_t>(j) * n + i] = d;
    base[static_cast<size_t>(j) * n + i] = b;
    s_base[w][j] = b;
  }
  __syncwarp();
  if (!sweep) {
    for (int j = lane; j < l; j += 32)
      dst[static_cast<size_t>(j) * n + i] = q0[static_cast<size_t>(j) * n + i];
    return;
  }
  mf_point<LMAX>(q0, s_base[w], 1, band, inv_temps[0], i, lane, l, n, block,
                 sw, dst);
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

// K6: the front fused with sweep 0, then sweeps 1.. as in `mean_field`
// (base from the front's output): max(n_sweeps, 1) launches.
template <int LMAX>
int mean_field_front(const float* q0, const float* pts, const float* hm,
                     const float* band, const float* inv_temps,
                     const float* thr, int n_sweeps, int l, int nb,
                     int block, float sw, float oc, int symmetric,
                     float* out, float* dct, float* r, float* base,
                     float* tmp, cudaStream_t st) {
  const int n = nb * block;
  const int grid = (n + kWarps - 1) / kWarps;
  float* dst = ((n_sweeps - 1) % 2 == 0 || n_sweeps == 0) ? out : tmp;
  if (symmetric)
    mf_front<LMAX, true><<<grid, kWarps * 32, 0, st>>>(
        q0, pts, hm, band, inv_temps, thr, n_sweeps > 0, l, n, block, sw, oc,
        dst, dct, r, base);
  else
    mf_front<LMAX, false><<<grid, kWarps * 32, 0, st>>>(
        q0, pts, hm, band, inv_temps, thr, n_sweeps > 0, l, n, block, sw, oc,
        dst, dct, r, base);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc) return rc;
  const float* src = dst;
  for (int s = 1; s < n_sweeps; ++s) {
    dst = ((n_sweeps - 1 - s) % 2 == 0) ? out : tmp;
    mf_sweep<LMAX><<<grid, kWarps * 32, 0, st>>>(src, base, band, inv_temps,
                                                 s, l, n, block, sw, dst);
    rc = static_cast<int>(cudaGetLastError());
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

extern "C" int multih_mean_field_front(
    const float* q0, const float* pts, const float* hm, const float* band,
    const float* inv_temps, const float* thr, int n_sweeps, int l, int nb,
    int block, float sw, float oc, int symmetric, float* out, float* dct,
    float* r, float* base, float* tmp, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (l <= 16)
    return mean_field_front<16>(q0, pts, hm, band, inv_temps, thr, n_sweeps,
                                l, nb, block, sw, oc, symmetric, out, dct, r,
                                base, tmp, st);
  if (l <= 32)
    return mean_field_front<32>(q0, pts, hm, band, inv_temps, thr, n_sweeps,
                                l, nb, block, sw, oc, symmetric, out, dct, r,
                                base, tmp, st);
  if (l <= 64)
    return mean_field_front<64>(q0, pts, hm, band, inv_temps, thr, n_sweeps,
                                l, nb, block, sw, oc, symmetric, out, dct, r,
                                base, tmp, st);
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
