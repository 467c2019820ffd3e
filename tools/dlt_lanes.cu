// Two K2 variants timed against multih_tpu_torch/csrc/dlt_kernel.cu's
// dlt_gt by tools/torch_kernel_ab.py (part "dltlanes"), on the same
// (32, S) sampler rows:
//   - dlt_gt_lanes: 4 lanes a solve (8 solves a warp, one warp a
//     block, so S = 512 runs 64 warps on 64 SMs, the shipped kernel 16
//     on 16). Lane j < 3 holds
//     column j of the 4x3 point matrix P and of the tails T1 and T2, and
//     rotates only those; the pivot pair of each of the 7 rotations
//     comes from the lane that owns the pivot column by two shuffles,
//     and every lane computes (c, s) from it. Lane 3 runs the degeneracy
//     and padded-point tests. After the QR every lane gathers the
//     triangular system by shuffles and runs the shipped back
//     substitution and denormalisation (`finish`); lane j < 3 writes row
//     j of H and lane 3 writes ok.
//   - dlt_gt_floor: the shipped kernel's grid and staging and its
//     writes, with no solve: what a launch that moves the same bytes
//     costs on the card.
// Build (the tool does it): nvcc -gencode arch=compute_90a,code=sm_90a
// -std=c++17 -O3 -Xcompiler -fPIC -shared tools/dlt_lanes.cu -o lib.so

#include "../multih_tpu_torch/csrc/dlt_kernel.cu"

namespace {

constexpr unsigned kAllLanes = 0xffffffffu;
constexpr int kLanes = 4;
constexpr int kLaneThreads = 32;
constexpr int kSolves = kLaneThreads / kLanes;  // solves a block: 8

// the block's C columns of gt, staged [column][row] by its one warp with
// the index that is adjacent in memory across the lanes: all C loads
// issued before the first store, as the shipped kernel stages
template <int C>
__device__ __forceinline__ void stage(const float* __restrict__ gt, int rs,
                                      int cs, int i0, int cols,
                                      float (&tile)[C][33]) {
  const bool rows_adjacent = rs <= cs;
  float v[C];
#pragma unroll
  for (int it = 0; it < C; ++it) {
    const int e = it * 32 + threadIdx.x;
    const int row = rows_adjacent ? e % 32 : e / C;
    const int col = rows_adjacent ? e / 32 : e % C;
    v[it] = col < cols ? gt[static_cast<long long>(row) * rs +
                            static_cast<long long>(i0 + col) * cs]
                       : 0.f;
  }
#pragma unroll
  for (int it = 0; it < C; ++it) {
    const int e = it * 32 + threadIdx.x;
    const int row = rows_adjacent ? e % 32 : e / C;
    const int col = rows_adjacent ? e / 32 : e % C;
    tile[col][row] = v[it];
  }
  __syncwarp();
}

__global__ void __launch_bounds__(kLaneThreads)
dlt_gt_lanes(const float* __restrict__ gt, int s, int rs, int cs,
             float* __restrict__ out, float* __restrict__ ok) {
  __shared__ float tile[kSolves][33];
  const int i0 = blockIdx.x * kSolves;
  const int cols = min(kSolves, s - i0);
  stage(gt, rs, cs, i0, cols, tile);
  const int local = threadIdx.x / kLanes, j = threadIdx.x % kLanes;
  const int base = (threadIdx.x & 31) & ~(kLanes - 1);
  // columns past the last solve hold zeros: they solve the guarded
  // zero system and write nothing, but take part in every shuffle
  const float* q = tile[local];
  float p[16];
  bool pad = false;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    p[2 * k] = q[8 * k + 0];
    p[2 * k + 1] = q[8 * k + 1];
    p[8 + 2 * k] = q[8 * k + 2];
    p[8 + 2 * k + 1] = q[8 * k + 3];
    pad |= q[8 * k + 4] == 0.f;
  }
  double n1[8], n2[8], s1, c1x, c1y, s2, c2x, c2y;
  hartley(p, n1, s1, c1x, c1y);
  hartley(p + 8, n2, s2, c2x, c2y);
  // column j of P (x, y, 1) and of the tails T1 = -U P, T2 = V P
  double mc[4], a1[4], a2[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    mc[r] = j == 0 ? n1[2 * r] : j == 1 ? n1[2 * r + 1] : 1.0;
    a1[r] = -n2[2 * r] * mc[r];
    a2[r] = n2[2 * r + 1] * mc[r];
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
#pragma unroll
    for (int k = c + 1; k < 4; ++k) {
      const double pa = __shfl_sync(kAllLanes, mc[c], base + c);
      const double pb = __shfl_sync(kAllLanes, mc[k], base + c);
      double cs_, sn, d;
      givens(pa, pb, cs_, sn, d);
      if (j == c) {
        mc[c] = d;
      } else if (j > c) {
        rotate(cs_, sn, mc[c], mc[k]);
      }
      rotate(cs_, sn, a1[c], a1[k]);
      rotate(cs_, sn, a2[c], a2[k]);
    }
  }
  double b00;  // B = [t1[3]; t2[3]]: one rotation on lane 0's column
  {
    const double pa = __shfl_sync(kAllLanes, a1[3], base);
    const double pb = __shfl_sync(kAllLanes, a2[3], base);
    double cs_, sn;
    givens(pa, pb, cs_, sn, b00);
    if (j > 0) rotate(cs_, sn, a1[3], a2[3]);
  }
  // gather the triangular system from the column lanes
  double m[4][3], t1[4][3], t2[4][3];
#pragma unroll
  for (int col = 0; col < 3; ++col) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      m[r][col] = __shfl_sync(kAllLanes, mc[r], base + col);
      t1[r][col] = __shfl_sync(kAllLanes, a1[r], base + col);
      t2[r][col] = __shfl_sync(kAllLanes, a2[r], base + col);
    }
  }
  float h[9];
  finish(m, t1, t2, b00, s1, c1x, c1y, s2, c2x, c2y, h);
  if (local >= cols) return;
  const int i = i0 + local;
  if (j < 3) {
#pragma unroll
    for (int k = 0; k < 3; ++k) out[i * 9 + 3 * j + k] = h[3 * j + k];
  } else {
    ok[i] = pad || degenerate(p) || degenerate(p + 8) ? 0.f : 1.f;
  }
}

__global__ void __launch_bounds__(kThreads)
dlt_gt_floor(const float* __restrict__ gt, int s, int rs, int cs,
             float* __restrict__ out, float* __restrict__ ok) {
  __shared__ float tile[kThreads][33];
  const int i0 = blockIdx.x * kThreads;
  const int cols = min(kThreads, s - i0);
  stage(gt, rs, cs, i0, cols, tile);
  const int t = threadIdx.x;
  if (t >= cols) return;
  const int i = i0 + t;
#pragma unroll
  for (int k = 0; k < 9; ++k) out[i * 9 + k] = tile[t][k];
  ok[i] = tile[t][4];
}

}  // namespace

extern "C" int multih_dlt_4pt_gt_lanes(const float* gt, int s, int rs,
                                       int cs, float* out, float* ok,
                                       void* stream) {
  if (s > 0) {
    dlt_gt_lanes<<<(s + kSolves - 1) / kSolves, kLaneThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(gt, s, rs, cs, out,
                                                        ok);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int multih_dlt_4pt_gt_floor(const float* gt, int s, int rs,
                                       int cs, float* out, float* ok,
                                       void* stream) {
  if (s > 0) {
    dlt_gt_floor<<<blocks(s), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(gt, s, rs, cs, out,
                                                        ok);
  }
  return static_cast<int>(cudaGetLastError());
}
