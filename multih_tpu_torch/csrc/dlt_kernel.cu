// Batched minimal 4-point homography solves.
//
// Replaces the TPU kernel multih_tpu/ops/kernels/dlt_kernel.py
// (_dlt_kernel, launched by _solve_packed). Same math as there and as
// geometry.homography_4pt: Hartley normalisation of both quads, the 8x9
// DLT rows, 28 Givens rotations with the same EPS guards and order, back
// substitution with h9 = 1, denormalisation, Frobenius norm, h33 >= 0.
//
// Bound on the H100: registers and latency. Each solve is ~1.5k flops on
// 72 matrix entries and touches 16 floats in and 9 out. Design: one
// thread per hypothesis with the whole 8x9 system in registers (the
// loops unroll fully, so every index is a compile-time constant); thread
// s reads column s of the (16, S) input and writes column s of the
// (9, S) output, so every load and store is coalesced.

#include <cuda_runtime.h>

namespace {

constexpr float kEps = 1e-12f;
constexpr int kThreads = 128;

// geometry.hartley_normalize for 4 points with unit weights
__device__ __forceinline__ void hartley(const float* q, float* nq, float& s,
                                        float& cx, float& cy) {
  cx = (q[0] + q[2] + q[4] + q[6]) * 0.25f;
  cy = (q[1] + q[3] + q[5] + q[7]) * 0.25f;
  float ms = 0.f;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    nq[2 * p] = q[2 * p] - cx;
    nq[2 * p + 1] = q[2 * p + 1] - cy;
    ms += nq[2 * p] * nq[2 * p] + nq[2 * p + 1] * nq[2 * p + 1];
  }
  ms *= 0.25f;
  const float rms = sqrtf(fmaxf(ms, kEps));
  s = sqrtf(2.f) / rms;
#pragma unroll
  for (int k = 0; k < 8; ++k) nq[k] *= s;
}

__global__ void __launch_bounds__(kThreads)
dlt_kernel(const float* __restrict__ packed, int s, float* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= s) return;
  float p[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) p[k] = packed[k * s + i];

  float n1[8], n2[8], s1, c1x, c1y, s2, c2x, c2y;
  hartley(p, n1, s1, c1x, c1y);
  hartley(p + 8, n2, s2, c2x, c2y);

  // 8x9 DLT rows (geometry.dlt_rows)
  float r[8][9];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float x = n1[2 * q], y = n1[2 * q + 1];
    const float u = n2[2 * q], v = n2[2 * q + 1];
    float* rx = r[2 * q];
    float* ry = r[2 * q + 1];
    rx[0] = 0.f; rx[1] = 0.f; rx[2] = 0.f;
    rx[3] = -x;  rx[4] = -y;  rx[5] = -1.f;
    rx[6] = v * x; rx[7] = v * y; rx[8] = v;
    ry[0] = x;   ry[1] = y;   ry[2] = 1.f;
    ry[3] = 0.f; ry[4] = 0.f; ry[5] = 0.f;
    ry[6] = -u * x; ry[7] = -u * y; ry[8] = -u;
  }

  // 28 Givens rotations; columns j < c are structurally zero by then
#pragma unroll
  for (int c = 0; c < 8; ++c) {
#pragma unroll
    for (int k = c + 1; k < 8; ++k) {
      const float a = r[c][c], b = r[k][c];
      const float d = sqrtf(a * a + b * b);
      const float d_safe = fmaxf(d, kEps);
      const bool live = d > kEps;
      const float cs = live ? a / d_safe : 1.f;
      const float sn = live ? b / d_safe : 0.f;
#pragma unroll
      for (int j = c; j < 9; ++j) {
        const float rc = cs * r[c][j] + sn * r[k][j];
        const float rk = -sn * r[c][j] + cs * r[k][j];
        r[c][j] = rc;
        r[k][j] = rk;
      }
    }
  }

  // back substitution of R x = 0 with x[8] = 1
  float x[9];
  x[8] = 1.f;
#pragma unroll
  for (int ii = 7; ii >= 0; --ii) {
    float acc = 0.f;
#pragma unroll
    for (int j = ii + 1; j < 9; ++j) acc += r[ii][j] * x[j];
    float den = r[ii][ii];
    if (fabsf(den) < kEps) den = den < 0.f ? -kEps : kEps;
    x[ii] = -acc / den;
  }
  float vn = 0.f;
#pragma unroll
  for (int k = 0; k < 9; ++k) vn += x[k] * x[k];
  const float inv = 1.f / fmaxf(sqrtf(vn), kEps);
  float h[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) h[k] = x[k] * inv;

  // H = T2^-1 (Hn T1)
  const float A[3][3] = {
      {s1 * h[0], s1 * h[1], -s1 * c1x * h[0] - s1 * c1y * h[1] + h[2]},
      {s1 * h[3], s1 * h[4], -s1 * c1x * h[3] - s1 * c1y * h[4] + h[5]},
      {s1 * h[6], s1 * h[7], -s1 * c1x * h[6] - s1 * c1y * h[7] + h[8]},
  };
  const float inv_s2 = 1.f / s2;
  float B[3][3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    B[0][j] = A[0][j] * inv_s2 + c2x * A[2][j];
    B[1][j] = A[1][j] * inv_s2 + c2y * A[2][j];
    B[2][j] = A[2][j];
  }
  float fro = 0.f;
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b) fro += B[a][b] * B[a][b];
  const float scale = 1.f / fmaxf(sqrtf(fro), kEps);
  const float sign = B[2][2] < 0.f ? -scale : scale;
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b) out[(3 * a + b) * s + i] = B[a][b] * sign;
}

}  // namespace

// packed: (16, S) rows [x1: xa ya xb yb xc yc xd yd; x2 likewise];
// out: (9, S) row-major homographies.
extern "C" int multih_dlt_4pt(const float* packed, int s, float* out,
                              void* stream) {
  if (s > 0) {
    const int blocks = (s + kThreads - 1) / kThreads;
    dlt_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        packed, s, out);
  }
  return static_cast<int>(cudaGetLastError());
}
