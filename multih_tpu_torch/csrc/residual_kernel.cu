// Per-hypothesis inlier counts over hypotheses x correspondences, with
// the (S, N) residual matrix never materialised.
//
// Replaces the TPU kernel multih_tpu/ops/kernels/residual_kernel.py
// (_count_kernel, launched by inlier_counts), every kind. Homographies:
// 0 = symmetric transfer (forward + adjugate back-transfer), 1 = forward
// transfer, 2 = Sampson. Fundamental matrices (F row-major in the same
// (S, 9) layout): 3 = symmetric epipolar distance, 4 = one-sided
// epipolar distance, 5 = Sampson.
//
// Bound on the H100: fp32 arithmetic and division. Each pair costs
// ~20-40 flops plus one or two IEEE divisions and reads nothing from
// device memory once the point tile is in shared memory; the inputs are
// S*9 + 5*N floats. Design: one thread per hypothesis keeps its 9 entries
// and 9 adjugate entries in registers; a block of 128 hypotheses stages
// a tile of points in shared memory and every thread loops over it.
// The point axis is split over gridDim.y so that a pool of ~2k
// hypotheses (16 blocks) still fills the 132 SMs; the partial counts
// meet in an int32 atomicAdd, exact and order-free.
//
// Division is IEEE (the JAX kernel's fast reciprocal,
// cfg.pallas_approx_rcp, is not used yet).

#include <cuda_runtime.h>

namespace {

constexpr float kEps = 1e-12f;
constexpr int kThreads = 128;
constexpr int kTile = 256;     // points per shared-memory tile
constexpr int kTargetBlocks = 4 * 132;

// geometry.from_homogeneous: |w| < EPS -> +-EPS keeping the sign
__device__ __forceinline__ float safe_den(float w) {
  return fabsf(w) < kEps ? (w < 0.f ? -kEps : kEps) : w;
}

template <int KIND>
__device__ __forceinline__ float residual(const float* h, const float* a,
                                          float x, float y, float u,
                                          float v) {
  if (KIND >= 3) {  // fmodel.residual_matrix_f
    // epiline in image 2, l = F x1h; constraint value e = x2h . l
    const float l0 = h[0] * x + h[1] * y + h[2];
    const float l1 = h[3] * x + h[4] * y + h[5];
    const float l2 = h[6] * x + h[7] * y + h[8];
    const float e = u * l0 + v * l1 + l2;
    const float e2 = e * e;
    const float dl = l0 * l0 + l1 * l1;
    if (KIND == 4) return e2 / fmaxf(dl, kEps);
    // epiline in image 1, m = F^T x2h
    const float m0 = h[0] * u + h[3] * v + h[6];
    const float m1 = h[1] * u + h[4] * v + h[7];
    const float dm = m0 * m0 + m1 * m1;
    if (KIND == 3) return e2 / fmaxf(dl, kEps) + e2 / fmaxf(dm, kEps);
    // Sampson clamps the SUM of both normals, as the jnp residual does
    // (fmodel.py:109-110); the TPU kernel clamps each before adding.
    // The two differ only where both epilines vanish.
    return e2 / fmaxf(dl + dm, kEps);
  }
  if (KIND == 2) {  // Sampson, geometry.sampson_error_sq_h
    const float hx0 = h[0] * x + h[1] * y + h[2];
    const float hx1 = h[3] * x + h[4] * y + h[5];
    const float hx2 = h[6] * x + h[7] * y + h[8];
    const float e1 = v * hx2 - hx1;
    const float e2 = hx0 - u * hx2;
    const float d1x = v * h[6] - h[3];
    const float d1y = v * h[7] - h[4];
    const float d2x = h[0] - u * h[6];
    const float d2y = h[1] - u * h[7];
    const float aa = d1x * d1x + d1y * d1y + hx2 * hx2;
    const float bb = d1x * d2x + d1y * d2y;
    const float cc = d2x * d2x + d2y * d2y + hx2 * hx2;
    const float det = fmaxf(aa * cc - bb * bb, kEps);
    return (cc * e1 * e1 - 2.f * bb * e1 * e2 + aa * e2 * e2) / det;
  }
  const float w = safe_den(h[6] * x + h[7] * y + h[8]);
  const float uf = (h[0] * x + h[1] * y + h[2]) / w - u;
  const float vf = (h[3] * x + h[4] * y + h[5]) / w - v;
  float err = uf * uf + vf * vf;
  if (KIND == 0) {
    const float wb = safe_den(a[6] * u + a[7] * v + a[8]);
    const float ub = (a[0] * u + a[1] * v + a[2]) / wb - x;
    const float vb = (a[3] * u + a[4] * v + a[5]) / wb - y;
    err += ub * ub + vb * vb;
  }
  return err;
}

// hs: (S, 9) row-major; pts: (8, N) rows [x1, y1, x2, y2, valid, ...];
// thr: device scalar (squared threshold); out: (S,) int32, zeroed.
template <int KIND>
__global__ void __launch_bounds__(kThreads)
count_kernel(const float* __restrict__ hs, int s,
             const float* __restrict__ pts, int n, int chunk,
             const float* __restrict__ thr_ptr, int* __restrict__ out) {
  __shared__ float sx[kTile], sy[kTile], su[kTile], sv[kTile], sw[kTile];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < s;
  float h[9], a[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) h[k] = live ? hs[i * 9 + k] : 0.f;
  // adjugate (scale-free inverse) for the back-transfer
  a[0] = h[4] * h[8] - h[5] * h[7];
  a[1] = h[2] * h[7] - h[1] * h[8];
  a[2] = h[1] * h[5] - h[2] * h[4];
  a[3] = h[5] * h[6] - h[3] * h[8];
  a[4] = h[0] * h[8] - h[2] * h[6];
  a[5] = h[2] * h[3] - h[0] * h[5];
  a[6] = h[3] * h[7] - h[4] * h[6];
  a[7] = h[1] * h[6] - h[0] * h[7];
  a[8] = h[0] * h[4] - h[1] * h[3];
  const float thr = *thr_ptr;

  const int p_begin = blockIdx.y * chunk;
  const int p_end = min(n, p_begin + chunk);
  int cnt = 0;
  for (int t0 = p_begin; t0 < p_end; t0 += kTile) {
    const int tn = min(kTile, p_end - t0);
    __syncthreads();  // previous tile fully consumed
    for (int j = threadIdx.x; j < tn; j += kThreads) {
      sx[j] = pts[t0 + j];
      sy[j] = pts[n + t0 + j];
      su[j] = pts[2 * n + t0 + j];
      sv[j] = pts[3 * n + t0 + j];
      sw[j] = pts[4 * n + t0 + j];
    }
    __syncthreads();
    if (live) {
      for (int j = 0; j < tn; ++j) {
        const float err = residual<KIND>(h, a, sx[j], sy[j], su[j], sv[j]);
        cnt += (err < thr && sw[j] > 0.f) ? 1 : 0;
      }
    }
  }
  if (live && cnt) atomicAdd(out + i, cnt);
}

}  // namespace

extern "C" int multih_inlier_counts(const float* hs, int s, const float* pts,
                                    int n, const float* thr, int kind,
                                    int* out, void* stream) {
  if (s <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  const int bx = (s + kThreads - 1) / kThreads;
  const int max_split = (n + kTile - 1) / kTile;
  int split = (kTargetBlocks + bx - 1) / bx;
  split = split < 1 ? 1 : (split > max_split ? max_split : split);
  int chunk = (n + split - 1) / split;
  chunk = (chunk + kTile - 1) / kTile * kTile;
  split = (n + chunk - 1) / chunk;
  const dim3 grid(bx, split);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0:
      count_kernel<0><<<grid, kThreads, 0, st>>>(hs, s, pts, n, chunk, thr,
                                                 out);
      break;
    case 1:
      count_kernel<1><<<grid, kThreads, 0, st>>>(hs, s, pts, n, chunk, thr,
                                                 out);
      break;
    case 2:
      count_kernel<2><<<grid, kThreads, 0, st>>>(hs, s, pts, n, chunk, thr,
                                                 out);
      break;
    case 3:
      count_kernel<3><<<grid, kThreads, 0, st>>>(hs, s, pts, n, chunk, thr,
                                                 out);
      break;
    case 4:
      count_kernel<4><<<grid, kThreads, 0, st>>>(hs, s, pts, n, chunk, thr,
                                                 out);
      break;
    case 5:
      count_kernel<5><<<grid, kThreads, 0, st>>>(hs, s, pts, n, chunk, thr,
                                                 out);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
