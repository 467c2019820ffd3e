// Per-hypothesis inlier counts over hypotheses x correspondences, with
// the (S, N) residual matrix never materialised.
//
// Replaces the TPU kernel multih_tpu/ops/kernels/residual_kernel.py
// (_count_kernel, launched by inlier_counts), every kind. Homographies:
// 0 = symmetric transfer (forward + adjugate back-transfer), 1 = forward
// transfer, 2 = Sampson. Fundamental matrices (F row-major in the same
// (S, 3, 3) layout): 3 = symmetric epipolar distance, 4 = one-sided
// epipolar distance, 5 = Sampson.
//
// Reciprocals (cfg.pallas_approx_rcp, as the TPU kernel's approx_rcp):
// APPROX multiplies by the hardware reciprocal rcp.approx.ftz.f32 (one
// MUFU op) wherever the TPU kernel takes pl.reciprocal(..., approx=True),
// with its algebra kind by kind: the transfers multiply each numerator
// by the reciprocal of the clamped w, Sampson by that of the clamped
// det, f_symmetric adds the two reciprocals and multiplies by e^2.
// Without APPROX every quotient is an IEEE division.
//
// Bound on the H100: instruction issue. Each pair costs ~20-40 fp32
// operations plus one or two reciprocals and reads nothing from device
// memory once the points are in shared memory; the inputs are S*9 + 5*N
// floats. Design: one warp per hypothesis (or r = 2-8 warps when the
// pool is small), every lane holding H (or F) and H's adjugate in
// registers and striding the points, so ~2k hypotheses make ~4k warps
// on 132 SMs. A block stages its points once as float4 {x, y, u, v}
// plus a per-point threshold (the squared threshold where valid, -inf
// where not: one vector and one scalar shared load a pair, and the
// validity test is the threshold compare) and walks its hypotheses
// grid-stride. Past kTile points, or for a pool too small to fill the
// card, the point axis is split over a thread-block cluster of up to 8
// CTAs, each staging its share (past 8 tiles a CTA loops over tiles). A
// lane counts in an int, the warp sums with __reduce_add_sync, and a
// hypothesis's r warps in each of the cluster's CTAs meet in CTA 0
// through distributed shared memory in a fixed order: an exact integer
// sum, written once as float32 (no memset, no atomics, no cast).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kEps = 1e-12f;
constexpr int kThreads = 256;  // 8 warps a block
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 2048;    // points staged at once: 40 KB
constexpr int kMaxSplit = 8;   // CTAs a cluster (the portable limit)
constexpr unsigned kAll = 0xffffffffu;
#define kNegInf __int_as_float(0xff800000)

__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// num / den: the IEEE quotient, or num times den's fast reciprocal
template <bool APPROX>
__device__ __forceinline__ float quot(float num, float den) {
  return APPROX ? num * rcp_approx(den) : num / den;
}

// geometry.from_homogeneous: |w| < EPS -> +-EPS keeping the sign
__device__ __forceinline__ float safe_den(float w) {
  return fabsf(w) < kEps ? (w < 0.f ? -kEps : kEps) : w;
}

template <int KIND, bool APPROX>
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
    if (KIND == 4) return quot<APPROX>(e2, fmaxf(dl, kEps));
    // epiline in image 1, m = F^T x2h
    const float m0 = h[0] * u + h[3] * v + h[6];
    const float m1 = h[1] * u + h[4] * v + h[7];
    const float dm = m0 * m0 + m1 * m1;
    if (KIND == 3) {
      return APPROX ? e2 * (rcp_approx(fmaxf(dl, kEps))
                            + rcp_approx(fmaxf(dm, kEps)))
                    : e2 / fmaxf(dl, kEps) + e2 / fmaxf(dm, kEps);
    }
    // Sampson clamps the SUM of both normals, as the jnp residual does
    // (fmodel.py:109-110); the TPU kernel clamps each before adding.
    // The two differ only where both epilines vanish.
    return quot<APPROX>(e2, fmaxf(dl + dm, kEps));
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
    return quot<APPROX>(cc * e1 * e1 - 2.f * bb * e1 * e2 + aa * e2 * e2,
                        det);
  }
  const float w = safe_den(h[6] * x + h[7] * y + h[8]);
  float uf, vf;
  if (APPROX) {
    const float rw = rcp_approx(w);
    uf = (h[0] * x + h[1] * y + h[2]) * rw - u;
    vf = (h[3] * x + h[4] * y + h[5]) * rw - v;
  } else {
    uf = (h[0] * x + h[1] * y + h[2]) / w - u;
    vf = (h[3] * x + h[4] * y + h[5]) / w - v;
  }
  float err = uf * uf + vf * vf;
  if (KIND == 0) {
    const float wb = safe_den(a[6] * u + a[7] * v + a[8]);
    float ub, vb;
    if (APPROX) {
      const float rb = rcp_approx(wb);
      ub = (a[0] * u + a[1] * v + a[2]) * rb - x;
      vb = (a[3] * u + a[4] * v + a[5]) * rb - y;
    } else {
      ub = (a[0] * u + a[1] * v + a[2]) / wb - x;
      vb = (a[3] * u + a[4] * v + a[5]) / wb - y;
    }
    err += ub * ub + vb * vb;
  }
  return err;
}

// Strided views, in floats: hypothesis i's entry (r, c) is
// hs[i * h_si + r * h_sr + c * h_sc]; point j is (x1[j * p1_sn],
// x1[j * p1_sn + p1_sc]), likewise x2, and valid[j * v_sn].
struct Args {
  const float* hs;
  int s, h_si, h_sr, h_sc;
  const float* x1;
  int p1_sn, p1_sc;
  const float* x2;
  int p2_sn, p2_sc;
  const float* valid;
  int v_sn, n;
  const float* thr;
  float* out;
  int r;  // warps per hypothesis: 1, 2, 4 or 8
};

template <int KIND, bool APPROX>
__global__ void __launch_bounds__(kThreads)
count_kernel(const Args p) {
  extern __shared__ float4 smem[];
  __shared__ int part[kWarps];
  cg::cluster_group cluster = cg::this_cluster();
  // this CTA's share of the points: cluster rank c of gridDim.y
  const int split = gridDim.y, c = blockIdx.y;
  const int chunk = (p.n + split - 1) / split;
  const int p0 = min(p.n, c * chunk);
  const int m = min(p.n, p0 + chunk) - p0;
  const int tile = chunk < kTile ? chunk : kTile;
  float4* sp = smem;                                  // {x, y, u, v}
  float* st = reinterpret_cast<float*>(sp + tile);    // thr or -inf

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int per_block = kWarps / p.r;                 // hypotheses a block
  const int slot = warp / p.r, sub = warp % p.r;
  const int groups = (p.s + per_block - 1) / per_block;
  const float thr = *p.thr;
  const bool one_tile = m <= kTile;

  auto stage = [&](int t0, int tn) {
    for (int j = threadIdx.x; j < tn; j += kThreads) {
      const int q = p0 + t0 + j;
      sp[j] = make_float4(p.x1[q * p.p1_sn], p.x1[q * p.p1_sn + p.p1_sc],
                          p.x2[q * p.p2_sn], p.x2[q * p.p2_sn + p.p2_sc]);
      st[j] = p.valid[q * p.v_sn] > 0.f ? thr : kNegInf;
    }
  };
  if (one_tile) {
    stage(0, m);
    __syncthreads();
  }

  // every CTA of a cluster walks the same groups (same blockIdx.x)
  for (int g = blockIdx.x; g < groups; g += gridDim.x) {
    const int i = g * per_block + slot;
    const bool live = i < p.s;
    float h[9], a[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      h[k] = live ? p.hs[i * p.h_si + (k / 3) * p.h_sr + (k % 3) * p.h_sc]
                  : 0.f;
    }
    // adjugate (scale-free inverse) for the back-transfer, each product
    // and difference rounded on its own as geometry.adjugate_3x3 rounds
    // them (no FMA contraction): on a near-rank-1 H the minors cancel to
    // ~1e-6 of the products, and a contracted minor moved the
    // back-projected point by pixels (a sampled H of the affine fit's
    // pool counted 0 against the plain version's and float64's 3)
    const auto minor = [&](int i, int j, int k, int l) {
      return __fsub_rn(__fmul_rn(h[i], h[j]), __fmul_rn(h[k], h[l]));
    };
    a[0] = minor(4, 8, 5, 7);
    a[1] = minor(2, 7, 1, 8);
    a[2] = minor(1, 5, 2, 4);
    a[3] = minor(5, 6, 3, 8);
    a[4] = minor(0, 8, 2, 6);
    a[5] = minor(2, 3, 0, 5);
    a[6] = minor(3, 7, 4, 6);
    a[7] = minor(1, 6, 0, 7);
    a[8] = minor(0, 4, 1, 3);

    int cnt = 0;
    for (int t0 = 0; t0 < m; t0 += kTile) {
      const int tn = min(kTile, m - t0);
      if (!one_tile) {
        __syncthreads();  // the previous tile fully consumed
        stage(t0, tn);
        __syncthreads();
      }
      if (live) {
#pragma unroll 4
        for (int j = sub * 32 + lane; j < tn; j += p.r * 32) {
          const float4 q = sp[j];
          const float err = residual<KIND, APPROX>(h, a, q.x, q.y, q.z,
                                                   q.w);
          cnt += err < st[j] ? 1 : 0;
        }
      }
    }
    cnt = __reduce_add_sync(kAll, cnt);
    if (lane == 0) part[warp] = cnt;
    // every CTA's partial counts written (a plain launch: this CTA's)
    if (split > 1) cluster.sync(); else __syncthreads();
    if (c == 0 && threadIdx.x < per_block) {
      const int ii = g * per_block + threadIdx.x;
      int total = 0;
      for (int cc = 0; cc < split; ++cc) {
        const int* rp = split > 1 ? cluster.map_shared_rank(part, cc) : part;
        for (int w = 0; w < p.r; ++w) total += rp[threadIdx.x * p.r + w];
      }
      if (ii < p.s) p.out[ii] = static_cast<float>(total);
    }
    // part[] read before the next group writes it
    if (split > 1) cluster.sync(); else __syncthreads();
  }
}

template <int KIND, bool APPROX>
int launch(const Args& p, int split, cudaStream_t st) {
  static int blocks_per_sm = -1, sms = 0;
  const int chunk = (p.n + split - 1) / split;
  const size_t smem = static_cast<size_t>(chunk < kTile ? chunk : kTile) *
                      (sizeof(float4) + sizeof(float));
  if (blocks_per_sm < 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    // occupancy at the largest tile: a smaller one fits at least as many
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks_per_sm, count_kernel<KIND, APPROX>, kThreads,
        static_cast<size_t>(kTile) * (sizeof(float4) + sizeof(float)));
    if (blocks_per_sm < 1) blocks_per_sm = 1;
  }
  const int per_block = kWarps / p.r;
  const int groups = (p.s + per_block - 1) / per_block;
  int cap = blocks_per_sm * sms / split;
  cap = cap < 1 ? 1 : cap;
  const dim3 grid(groups < cap ? groups : cap, split, 1);
  if (split == 1) {  // a plain launch: a cluster launch costs ~2 us more
    count_kernel<KIND, APPROX><<<grid, kThreads, smem, st>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = split;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t rc =
      cudaLaunchKernelEx(&cfg, count_kernel<KIND, APPROX>, p);
  return static_cast<int>(rc != cudaSuccess ? rc : cudaGetLastError());
}

template <bool APPROX>
int dispatch(int kind, const Args& p, int split, cudaStream_t st) {
  switch (kind) {
    case 0: return launch<0, APPROX>(p, split, st);
    case 1: return launch<1, APPROX>(p, split, st);
    case 2: return launch<2, APPROX>(p, split, st);
    case 3: return launch<3, APPROX>(p, split, st);
    case 4: return launch<4, APPROX>(p, split, st);
    case 5: return launch<5, APPROX>(p, split, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The launch-shape policy (multih_tpu_torch/ops/kernels/residual_kernel.py
// launch_shape) reads these: out = {warps a block, points staged at once,
// CTAs a cluster at most}.
extern "C" int multih_inlier_counts_limits(int* out) {
  out[0] = kWarps;
  out[1] = kTile;
  out[2] = kMaxSplit;
  return 0;
}

// hs (S, 3, 3), x1 / x2 (N, 2), valid (N,), each float32 with the
// strides given; thr: device scalar (the squared threshold); out: (S,)
// float32 counts; r: warps a hypothesis (1, 2, 4 or 8); split: CTAs a
// cluster on the point axis (1-8). One launch.
extern "C" int multih_inlier_counts(
    const float* hs, int s, int h_si, int h_sr, int h_sc, const float* x1,
    int p1_sn, int p1_sc, const float* x2, int p2_sn, int p2_sc,
    const float* valid, int v_sn, int n, const float* thr, int kind,
    int approx, int r, int split, float* out, void* stream) {
  if (s <= 0) return static_cast<int>(cudaGetLastError());
  if ((r != 1 && r != 2 && r != 4 && r != 8) || split < 1 ||
      split > kMaxSplit)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args p{hs, s, h_si, h_sr, h_sc, x1, p1_sn, p1_sc, x2, p2_sn, p2_sc,
               valid, v_sn, n, thr, out, r};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return approx ? dispatch<true>(kind, p, split, st)
                : dispatch<false>(kind, p, split, st);
}
