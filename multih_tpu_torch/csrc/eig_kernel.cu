// Batched unit eigenvector of the smallest eigenvalue of 9x9 symmetric
// positive semi-definite matrices.
//
// Replaces the TPU kernel multih_tpu/ops/kernels/eig_kernel.py
// (_eig_kernel -> jacobi_smallest_column, launched by _eig_packed): six
// Jacobi sweeps with the trig-free tangent formula t = sign(theta) /
// (|theta| + sqrt(theta^2 + 1)) and its guards (|apq| < 1e-30 -> t = 0,
// sign(0) = +1), then the column of V at the smallest diagonal entry
// (first on ties), normalised here rather than by the caller.
//
// Bound on the H100: the serial chain of the rotations (each one's
// divide -> sqrt -> divide -> sqrt on entries the one before wrote), not
// bytes (81 floats in, 9 out) or flops (~13k a matrix). Design: a
// parallel order cuts the chain. Padded to 10 indices, a round-robin
// schedule makes each sweep 9 rounds of 4 disjoint rotations, every one
// of the 36 pairs once (ops/kernels/eig_kernel.py::ROUNDS, the same
// pairs), so a sweep is 9 steps of the chain instead of 36. Lane i of a
// 16-lane half warp holds row i of A and of V (two matrices a warp, one
// warp a block: C = 256 runs on 128 SMs). In each round both lanes of a
// pair compute its rotation from the pivots (two shuffles), so the
// chain runs once a round on every lane; eight shuffles bring each
// pair's (c, s) to every lane for the column updates (A <- A J, V <- V J,
// in registers), nine bring the partner's row for A <- J^T A, and the
// pair's lanes set their 2x2 pivot block as the cyclic order does. ~30
// live floats a lane instead of ~130 a thread. The arithmetic rounds as
// the plain version smallest_eigvec_9x9_round_robin_reference does (no
// fused multiply-adds, 1 / sqrt), so the two agree to the last bits.
// The lower triangle is read, as torch.linalg.eigh reads it.

#include <cuda_runtime.h>

namespace {

constexpr int kN = 9;
constexpr int kSweeps = 6;
constexpr int kThreads = 32;  // one warp, two matrices
constexpr int kHalf = 16;     // lanes per matrix
constexpr float kTiny = 1e-30f;
constexpr unsigned kAll = 0xffffffffu;

// pair k (0..3) of round r: (r + k + 1) % 9 meets (r - k - 1) % 9; the
// pad meets r, which does not rotate
__host__ __device__ constexpr int pair_a(int r, int k) {
  return (r + k + 1) % kN;
}
__host__ __device__ constexpr int pair_b(int r, int k) {
  return (r - k - 1 + kN) % kN;
}
__host__ __device__ constexpr int pair_p(int r, int k) {
  return pair_a(r, k) < pair_b(r, k) ? pair_a(r, k) : pair_b(r, k);
}
__host__ __device__ constexpr int pair_q(int r, int k) {
  return pair_a(r, k) < pair_b(r, k) ? pair_b(r, k) : pair_a(r, k);
}

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}

// c * x - s * y and s * x + c * y, each product rounded
__device__ __forceinline__ float rot_lo(float c, float s, float x, float y) {
  return __fsub_rn(mul(c, x), mul(s, y));
}
__device__ __forceinline__ float rot_hi(float c, float s, float x, float y) {
  return __fadd_rn(mul(s, x), mul(c, y));
}

__device__ __forceinline__ void rotation(float app, float aqq, float apq,
                                         float& c, float& s) {
  const bool tiny = fabsf(apq) < kTiny;
  const float theta =
      __fdiv_rn(__fsub_rn(aqq, app), mul(2.f, tiny ? kTiny : apq));
  // sign(theta) / x is +-(1 / x) exactly, and 1 / sqrt(y) divides by a
  // rounded sqrt: correctly rounded reciprocals give the same bits as
  // the plain version's divisions. sign(0) must be +1: at aqq == app
  // the rotation is 45 degrees.
  const float r = __frcp_rn(
      __fadd_rn(fabsf(theta), __fsqrt_rn(__fadd_rn(mul(theta, theta), 1.f))));
  const float t = tiny ? 0.f : theta >= 0.f ? r : -r;
  c = __frcp_rn(__fsqrt_rn(__fadd_rn(mul(t, t), 1.f)));
  s = mul(t, c);
}

// One round R of a sweep on the lane holding row i (0..15; rows 9..15
// are padding) of the matrix whose row 0 is on lane `base`; d is the
// lane's diagonal entry a[i], kept beside the row.
template <int R>
__device__ __forceinline__ void jacobi_round(float (&a)[kN], float (&v)[kN],
                                             float& d, int i, int base) {
  // Row i's partner is (2R - i) mod 9; row R and the padding rows have
  // none (their partner is themselves).
  const int j = i < kN ? (2 * R + 2 * kN - i) % kN : i;
  const bool is_p = i < j;
  // the pair's pivots: both lanes of a pair take A[p][p], A[q][q] and
  // A[p][q] (row p's entry) and so compute the same rotation
  float off = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    off = i == pair_p(R, k) ? a[pair_q(R, k)] : off;
  const float dj = __shfl_sync(kAll, d, base + j);
  const float off_j = __shfl_sync(kAll, off, base + j);
  const float app = is_p ? d : dj, aqq = is_p ? dj : d;
  const float apq = is_p ? off : off_j;
  float co, so;
  rotation(app, aqq, apq, co, so);

  // columns p, q of this lane's rows: A <- A J, V <- V J, with each
  // pair's rotation from its lane p
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int p = pair_p(R, k), q = pair_q(R, k);
    const float c = __shfl_sync(kAll, co, base + p);
    const float s = __shfl_sync(kAll, so, base + p);
    const float ap = a[p], aq = a[q], vp = v[p], vq = v[q];
    a[p] = rot_lo(c, s, ap, aq);
    a[q] = rot_hi(c, s, ap, aq);
    v[p] = rot_lo(c, s, vp, vq);
    v[q] = rot_hi(c, s, vp, vq);
  }

  // rows: A <- J^T A from the partner's row, then the 2x2 pivot block
  // from the round's starting entries, as the cyclic order sets it
  float pa[kN];
#pragma unroll
  for (int m = 0; m < kN; ++m) pa[m] = __shfl_sync(kAll, a[m], base + j);
  const float cc = mul(co, co), ss = mul(so, so);
  const float cs2 = mul(mul(mul(2.f, so), co), apq);
  const float piv =
      is_p ? __fadd_rn(__fsub_rn(mul(cc, app), cs2), mul(ss, aqq))
           : __fadd_rn(__fadd_rn(mul(ss, app), cs2), mul(cc, aqq));
  if (j != i) {
#pragma unroll
    for (int m = 0; m < kN; ++m) {
      const float r = is_p ? rot_lo(co, so, a[m], pa[m])
                           : rot_hi(co, so, pa[m], a[m]);
      a[m] = m == i ? piv : m == j ? 0.f : r;
    }
    d = piv;
  }
}

__global__ void __launch_bounds__(kThreads)
eig_kernel(const float* __restrict__ ata, int count, float* __restrict__ out) {
  const int base = threadIdx.x & kHalf;  // 0 or 16
  const int i = threadIdx.x & (kHalf - 1);
  const int m = blockIdx.x * (kThreads / kHalf) + (threadIdx.x >> 4);
  const bool row = i < kN && m < count;
  // every lane stays to the end: the shuffles need the whole warp
  float a[kN], v[kN];
  const float* src = ata + static_cast<long long>(row ? m : 0) * kN * kN;
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    a[k] = row ? src[i >= k ? i * kN + k : k * kN + i] : 0.f;
    v[k] = k == i ? 1.f : 0.f;
  }
  float d = row ? src[i * kN + i] : 0.f;

#pragma unroll 1
  for (int sweep = 0; sweep < kSweeps; ++sweep) {
    jacobi_round<0>(a, v, d, i, base);
    jacobi_round<1>(a, v, d, i, base);
    jacobi_round<2>(a, v, d, i, base);
    jacobi_round<3>(a, v, d, i, base);
    jacobi_round<4>(a, v, d, i, base);
    jacobi_round<5>(a, v, d, i, base);
    jacobi_round<6>(a, v, d, i, base);
    jacobi_round<7>(a, v, d, i, base);
    jacobi_round<8>(a, v, d, i, base);
  }

  // the smallest diagonal entry, first on ties (strict <, as the cyclic
  // selection), and row i's entry of that column of V
  float best = __shfl_sync(kAll, d, base);
  int jb = 0;
#pragma unroll
  for (int k = 1; k < kN; ++k) {
    const float dk = __shfl_sync(kAll, d, base + k);
    jb = dk < best ? k : jb;
    best = dk < best ? dk : best;
  }
  float col = 0.f;
#pragma unroll
  for (int k = 0; k < kN; ++k) col = jb == k ? v[k] : col;
  col = i < kN ? col : 0.f;
  float nrm = mul(col, col);
#pragma unroll
  for (int off = kHalf / 2; off > 0; off >>= 1)
    nrm = __fadd_rn(nrm, __shfl_xor_sync(kAll, nrm, off));
  if (row)
    out[static_cast<long long>(m) * kN + i] =
        __fdiv_rn(col, fmaxf(__fsqrt_rn(nrm), 1e-12f));
}

}  // namespace

// ata: (C, 9, 9) row-major symmetric (lower triangle read); out: (C, 9).
extern "C" int multih_eig9_smallest(const float* ata, int c, float* out,
                                    void* stream) {
  if (c > 0) {
    const int per_block = kThreads / kHalf;
    const int blocks = (c + per_block - 1) / per_block;
    eig_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        ata, c, out);
  }
  return static_cast<int>(cudaGetLastError());
}
