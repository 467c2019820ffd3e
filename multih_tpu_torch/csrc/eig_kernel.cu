// Batched unit eigenvector of the smallest eigenvalue of 9x9 symmetric
// positive semi-definite matrices.
//
// Replaces the TPU kernel multih_tpu/ops/kernels/eig_kernel.py
// (_eig_kernel -> jacobi_smallest_column, launched by _eig_packed): six
// cyclic Jacobi sweeps (216 rotations) with the trig-free tangent
// formula t = sign(theta) / (|theta| + sqrt(theta^2 + 1)), the same
// guards and update order, then the column of V at the smallest diagonal
// entry (first on ties), normalised here rather than by the caller.
//
// Bound on the H100: registers and the serial dependency chain of the
// rotations (~13k flops per matrix, 81 floats in, 9 out). Design: one
// thread per matrix with the 45 unique entries of A and all 81 of V in
// registers; every loop unrolls fully, so indices are compile-time
// constants. That is ~130 live floats per thread, close to the 255
// register limit: ptxas reports any spill at build time. Batches are
// small (C = 256 LO refits, 16 PEARL refits), so the card is far from
// full and the kernel's time is its per-thread latency.

#include <cuda_runtime.h>

namespace {

constexpr int kN = 9;
constexpr int kThreads = 64;
constexpr int kSweeps = 6;
constexpr float kTiny = 1e-30f;

// index of (i, j), i <= j, in the packed upper triangle
__host__ __device__ constexpr int tri(int i, int j) {
  return i <= j ? i * kN - i * (i - 1) / 2 + (j - i)
                : j * kN - j * (j - 1) / 2 + (i - j);
}

__global__ void __launch_bounds__(kThreads)
eig_kernel(const float* __restrict__ ata, int c, float* __restrict__ out) {
  const int m = blockIdx.x * kThreads + threadIdx.x;
  if (m >= c) return;
  const float* src = ata + static_cast<long long>(m) * kN * kN;
  float A[45];
#pragma unroll
  for (int i = 0; i < kN; ++i)
#pragma unroll
    for (int j = i; j < kN; ++j) A[tri(i, j)] = src[i * kN + j];
  float V[kN][kN];
#pragma unroll
  for (int i = 0; i < kN; ++i)
#pragma unroll
    for (int j = 0; j < kN; ++j) V[i][j] = i == j ? 1.f : 0.f;

#pragma unroll 1
  for (int sweep = 0; sweep < kSweeps; ++sweep) {
#pragma unroll
    for (int p = 0; p < kN - 1; ++p) {
#pragma unroll
      for (int q = p + 1; q < kN; ++q) {
        const float app = A[tri(p, p)], aqq = A[tri(q, q)];
        const float apq = A[tri(p, q)];
        const bool tiny = fabsf(apq) < kTiny;
        const float theta = (aqq - app) / (2.f * (tiny ? kTiny : apq));
        // sign(0) must be +1: at aqq == app the rotation is 45 degrees
        const float sgn = theta >= 0.f ? 1.f : -1.f;
        float t = sgn / (fabsf(theta) + sqrtf(theta * theta + 1.f));
        t = tiny ? 0.f : t;
        const float cs = 1.f / sqrtf(t * t + 1.f);
        const float sn = t * cs;
#pragma unroll
        for (int k = 0; k < kN; ++k) {
          if (k == p || k == q) continue;
          const float akp = A[tri(k, p)], akq = A[tri(k, q)];
          A[tri(k, p)] = cs * akp - sn * akq;
          A[tri(k, q)] = sn * akp + cs * akq;
        }
        A[tri(p, p)] = cs * cs * app - 2.f * sn * cs * apq + sn * sn * aqq;
        A[tri(q, q)] = sn * sn * app + 2.f * sn * cs * apq + cs * cs * aqq;
        A[tri(p, q)] = 0.f;
#pragma unroll
        for (int k = 0; k < kN; ++k) {
          const float vkp = V[k][p], vkq = V[k][q];
          V[k][p] = cs * vkp - sn * vkq;
          V[k][q] = sn * vkp + cs * vkq;
        }
      }
    }
  }

  float best_val = A[tri(0, 0)];
  float col[kN];
#pragma unroll
  for (int k = 0; k < kN; ++k) col[k] = V[k][0];
#pragma unroll
  for (int j = 1; j < kN; ++j) {
    const bool take = A[tri(j, j)] < best_val;
    best_val = take ? A[tri(j, j)] : best_val;
#pragma unroll
    for (int k = 0; k < kN; ++k) col[k] = take ? V[k][j] : col[k];
  }
  float nrm = 0.f;
#pragma unroll
  for (int k = 0; k < kN; ++k) nrm += col[k] * col[k];
  const float inv = 1.f / fmaxf(sqrtf(nrm), 1e-12f);
#pragma unroll
  for (int k = 0; k < kN; ++k) out[static_cast<long long>(m) * kN + k] =
      col[k] * inv;
}

}  // namespace

// ata: (C, 9, 9) row-major symmetric (upper triangle read); out: (C, 9).
extern "C" int multih_eig9_smallest(const float* ata, int c, float* out,
                                    void* stream) {
  if (c > 0) {
    const int blocks = (c + kThreads - 1) / kThreads;
    eig_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        ata, c, out);
  }
  return static_cast<int>(cudaGetLastError());
}
