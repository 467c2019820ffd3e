// The two ends of the batched moment refit, on either side of K3: from a
// candidate's moment table to its normalized normal matrix, and from the
// matrix's smallest eigenvector to the candidate's model.
//
// Replaces no TPU kernel: these are the plain ops around K3 in
// ops/geometry.py::homography_refit_batch and
// ops/fmodel.py::fundamental_refit_batch. There, each batched refit was
// one GEMM (weights @ features), ~90 / ~50 plain ops assembling the
// normalized normal matrices (_moments_to_ata, _moments_to_ata_f), K3,
// and ~60 / ~490 plain ops taking the nullvectors back to models
// (_h_from_nullvec; _f_from_nullvec with its 5-sweep 3x3 Jacobi for
// rank 2): 149 / 545 graph nodes a refit, each ~1-1.6 us of device time
// for a few hundred flops. Here a refit is three nodes: assemble, K3
// (csrc/eig_kernel.cu, unchanged, launched as every other K3 launch is),
// denormalize.
//
// Bound on the H100: the serial chain of one candidate's arithmetic
// (~400 / ~550 flops assembling, ~300 / ~1,800 denormalizing, most of
// F's in the 3x3 Jacobi's 15 rotations); the bytes (30-36 floats in, 81
// out and 6 parameters; 9 + 6 in, 9 out) are negligible. Design: one
// thread a candidate, everything in registers, so a node costs its
// launch and one thread's chain; the Hartley parameters pass from the
// first end to the second through device memory (6 floats a candidate)
// rather than being computed twice. The normal matrix is stored whole
// (the lower triangle mirrored), as the plain ops hand it to K3.
//
// Arithmetic: float32 throughout. The Hartley parameters round as the
// plain ops do (each product, sum, quotient and root on its own); the
// congruences with kron(Ga, T1c) / kron(Gb, T1c) (H) and kron(T2c, T1c)
// (F) are taken in their block structure, exactly zero where the plain
// product's factors are, and otherwise round in another order than the
// plain GEMMs: the models agree with the plain route to the float32
// floor of the eigenvector, carried through the denormalization.

#include <cuda_runtime.h>

namespace {

constexpr int kN = 9;
constexpr int kThreads = 64;  // one candidate a thread

constexpr int kHomography = 0;
constexpr int kFundamental = 1;
constexpr float kEps = 1e-12f;           // the plain ops' _EPS
constexpr float kSqrt2 = 1.41421356237309515f;

// fmodel._SYM_IDX: the sym6 index (x^2, xy, y^2, x, y, 1) of entry
// (i, j) of ph ph^T
__host__ __device__ constexpr int sym(int i, int j) {
  return i + j + (i == 2 || j == 2 ? 1 : 0);
}

// torch.clamp_min(x, lo): NaN stays NaN
__device__ __forceinline__ float clamp_lo(float x, float lo) {
  return x < lo ? lo : x;
}

// Weighted Hartley parameters from the moments (the plain ops' order):
// centroid (sx, sy) / w and scale sqrt(2) / rms, rms^2 = sq / w - |c|^2,
// clamped as geometry._moments_to_ata clamps it.
struct Hartley {
  float s, cx, cy;
};

__device__ __forceinline__ Hartley hartley(float sx, float sy, float sq,
                                           float wsum) {
  Hartley h;
  h.cx = __fdiv_rn(sx, wsum);
  h.cy = __fdiv_rn(sy, wsum);
  const float r2 =
      __fsub_rn(__fdiv_rn(sq, wsum),
                __fadd_rn(__fmul_rn(h.cx, h.cx), __fmul_rn(h.cy, h.cy)));
  h.s = __fdiv_rn(kSqrt2, __fsqrt_rn(clamp_lo(r2, kEps)));
  return h;
}

// T P T^T for the similarity T = [[s, 0, tx], [0, s, ty], [0, 0, 1]]
// (geometry._similarity: t = -s c) and a 3x3 P
__device__ __forceinline__ void congruence(float s, float tx, float ty,
                                           const float (&p)[3][3],
                                           float (&out)[3][3]) {
  const float t[2] = {tx, ty};
  float x[3][3];
#pragma unroll
  for (int l = 0; l < 3; ++l) {
    x[0][l] = s * p[0][l] + t[0] * p[2][l];
    x[1][l] = s * p[1][l] + t[1] * p[2][l];
    x[2][l] = p[2][l];
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    out[k][0] = s * x[k][0] + t[0] * x[k][2];
    out[k][1] = s * x[k][1] + t[1] * x[k][2];
    out[k][2] = x[k][2];
  }
}

__device__ __forceinline__ void matmul3(const float (&a)[3][3],
                                        const float (&b)[3][3],
                                        float (&out)[3][3]) {
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      out[r][c] = fmaf(a[r][2], b[2][c], fmaf(a[r][1], b[1][c],
                                              a[r][0] * b[0][c]));
}

__device__ __forceinline__ void similarity(const Hartley& h,
                                           float (&out)[3][3]) {
  out[0][0] = h.s; out[0][1] = 0.f; out[0][2] = -h.s * h.cx;
  out[1][0] = 0.f; out[1][1] = h.s; out[1][2] = -h.s * h.cy;
  out[2][0] = 0.f; out[2][1] = 0.f; out[2][2] = 1.f;
}

// geometry._similarity_inverse of a similarity T
__device__ __forceinline__ void similarity_inverse(const float (&t)[3][3],
                                                   float (&out)[3][3]) {
  const float s = t[0][0];
  const float inv = 1.f / s;
  out[0][0] = inv; out[0][1] = 0.f; out[0][2] = -t[0][2] / s;
  out[1][0] = 0.f; out[1][1] = inv; out[1][2] = -t[1][2] / s;
  out[2][0] = 0.f; out[2][1] = 0.f; out[2][2] = 1.f;
}

__device__ __forceinline__ float frobenius(const float (&a)[3][3]) {
  float n = 0.f;
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) n = fmaf(a[r][c], a[r][c], n);
  return sqrtf(n);
}

__device__ __forceinline__ void scale(float (&a)[3][3], float f) {
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) a[r][c] = a[r][c] * f;
}

// geometry._normalize_sign: Frobenius-normalized, h33 >= 0
__device__ __forceinline__ void normalize_sign(float (&h)[3][3]) {
  const float n = clamp_lo(frobenius(h), kEps);
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) h[r][c] = h[r][c] / n;
  scale(h, h[2][2] < 0.f ? -1.f : 1.f);
}

// fmodel._canonical_f: Frobenius-normalized, the largest |entry| (first
// on ties) positive
__device__ __forceinline__ void canonical_f(float (&f)[3][3]) {
  const float n = clamp_lo(frobenius(f), kEps);
  float lead = 0.f, mag = -1.f;
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      f[r][c] = f[r][c] / n;
      const bool take = fabsf(f[r][c]) > mag;
      lead = take ? f[r][c] : lead;
      mag = take ? fabsf(f[r][c]) : mag;
    }
  scale(f, lead < 0.f ? -1.f : 1.f);
}

// fmodel._rank2_project: F - (F v) v^T, v the eigenvector of the
// smallest eigenvalue (first on ties) of F^T F by
// geometry.jacobi_eigh_small's 5 cyclic sweeps (atan2 rotations, rows
// then columns)
__device__ __forceinline__ void rank2_project(float (&f)[3][3]) {
  float a[3][3], v[3][3];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      a[r][c] = fmaf(f[2][r], f[2][c], fmaf(f[1][r], f[1][c],
                                            f[0][r] * f[0][c]));
      v[r][c] = r == c ? 1.f : 0.f;
    }
#pragma unroll 1
  for (int sweep = 0; sweep < 5; ++sweep) {
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int q = p + 1; q < 3; ++q) {
        const float theta =
            0.5f * atan2f(2.f * a[p][q], a[q][q] - a[p][p]);
        float s, c;
        sincosf(theta, &s, &c);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float ap = a[p][k], aq = a[q][k];
          a[p][k] = c * ap - s * aq;
          a[q][k] = s * ap + c * aq;
        }
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float ap = a[k][p], aq = a[k][q];
          a[k][p] = c * ap - s * aq;
          a[k][q] = s * ap + c * aq;
          const float vp = v[k][p], vq = v[k][q];
          v[k][p] = c * vp - s * vq;
          v[k][q] = s * vp + c * vq;
        }
      }
  }
  float best = a[0][0], u[3] = {v[0][0], v[1][0], v[2][0]};
#pragma unroll
  for (int j = 1; j < 3; ++j) {
    const bool take = a[j][j] < best;
    best = take ? a[j][j] : best;
#pragma unroll
    for (int k = 0; k < 3; ++k) u[k] = take ? v[k][j] : u[k];
  }
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float fv = fmaf(f[r][2], u[2], fmaf(f[r][1], u[1], f[r][0] * u[0]));
#pragma unroll
    for (int c = 0; c < 3; ++c) f[r][c] = f[r][c] - fv * u[c];
  }
}

// The lower triangle of the normalized homography normal matrix
// (geometry._moments_to_ata): mo[6 mi + pj] is the moment of basis row
// mi (1, u, v, u^2, v^2 of image 2) and column pj (1, x, y, x^2, xy,
// y^2 of image 1), in the global frame. Blocks (a, b) of
// Ka Sa Ka^T + Kb Sb Kb^T with Ka = kron(Ga, T1c), Kb = kron(Gb, T1c),
// in terms of C(P) = T1c P T1c^T of the five moment matrices P.
__device__ __forceinline__ void assemble_h(const float (&mo)[30],
                                           Hartley& h1, Hartley& h2,
                                           float (&ata)[kN * kN]) {
  const float wsum = clamp_lo(mo[0], kEps);
  h1 = hartley(mo[1], mo[2], __fadd_rn(mo[3], mo[5]), wsum);
  h2 = hartley(mo[6], mo[12], __fadd_rn(mo[18], mo[24]), wsum);
  const float tx = -h1.s * h1.cx, ty = -h1.s * h1.cy;
  float c[5][3][3];  // C(P0), C(Pu), C(Pv), C(Pu2), C(Pv2)
#pragma unroll
  for (int mi = 0; mi < 5; ++mi) {
    const float* r = mo + 6 * mi;
    const float p[3][3] = {{r[3], r[4], r[1]}, {r[4], r[5], r[2]},
                           {r[1], r[2], r[0]}};
    congruence(h1.s, tx, ty, p, c[mi]);
  }
  const float g1 = h2.s * h2.cy, e1 = h2.s * h2.cx, g2 = h2.s;
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int l = 0; l < 3; ++l) {
      const float c0 = c[0][k][l], cu = c[1][k][l], cv = c[2][k][l];
      const float cu2 = c[3][k][l], cv2 = c[4][k][l];
      // Sa's blocks (1, 1), (2, 1), (2, 2); Sb's (0, 0), (2, 0), (2, 2)
      const float a21 = g1 * c0 - g2 * cv;
      const float a22 = g1 * a21 + g2 * (g2 * cv2 - g1 * cv);
      const float b20 = e1 * c0 - g2 * cu;
      const float b22 = e1 * b20 + g2 * (g2 * cu2 - e1 * cu);
      const float blk[3][3] = {{c0, 0.f, 0.f}, {0.f, c0, 0.f},
                               {b20, a21, a22 + b22}};
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int b = 0; b <= a; ++b)
          if (a > b || k >= l) ata[(3 * a + k) * kN + 3 * b + l] = blk[a][b];
    }
}

// The lower triangle of the normalized epipolar normal matrix
// (fmodel._moments_to_ata_f): mo[6 p2 + p1] is the joint moment of the
// sym6 entries (x^2, xy, y^2, x, y, 1) of image 2 (p2) and image 1 (p1);
// ata[3i+k][3j+l] = mo[sym(i,j)][sym(k,l)], then the congruence with
// kron(T2c, T1c): T1c inside each block, T2c across the blocks.
__device__ __forceinline__ void assemble_f(const float (&mo)[36],
                                           Hartley& h1, Hartley& h2,
                                           float (&ata)[kN * kN]) {
  const float wsum = clamp_lo(mo[35], kEps);
  h1 = hartley(mo[33], mo[34], __fadd_rn(mo[30], mo[32]), wsum);
  h2 = hartley(mo[23], mo[29], __fadd_rn(mo[5], mo[17]), wsum);
  float c[6][3][3];  // T1c P T1c^T of each image-2 row p
#pragma unroll
  for (int p = 0; p < 6; ++p) {
    float q[3][3];
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int l = 0; l < 3; ++l) q[k][l] = mo[6 * p + sym(k, l)];
    congruence(h1.s, -h1.s * h1.cx, -h1.s * h1.cy, q, c[p]);
  }
  const float s2 = h2.s, t2[2] = {-h2.s * h2.cx, -h2.s * h2.cy};
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int l = 0; l < 3; ++l) {
      // the congruence across blocks, entry (k, l) of each
      float n[3][3];  // n[a][j] = sum_i T2c[a][i] block(i, j)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float m2 = c[sym(2, j)][k][l];
        n[0][j] = s2 * c[sym(0, j)][k][l] + t2[0] * m2;
        n[1][j] = s2 * c[sym(1, j)][k][l] + t2[1] * m2;
        n[2][j] = m2;
      }
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int b = 0; b <= a; ++b)
          if (a > b || k >= l)
            ata[(3 * a + k) * kN + 3 * b + l] =
                b < 2 ? s2 * n[a][b] + t2[b] * n[a][2] : n[a][2];
    }
}

// geometry._h_from_nullvec: through the per-candidate similarities
// (T2c^-1 Hn T1c, normalized), then out of the global frame
// (T2g^-1 Hg T1g, normalized)
__device__ __forceinline__ void h_from_nullvec(float (&h)[3][3],
                                               const Hartley& h1,
                                               const Hartley& h2,
                                               const float (&t1g)[3][3],
                                               const float (&t2g)[3][3]) {
  float s1[3][3], s2[3][3], inv[3][3], x[3][3];
  similarity(h1, s1);
  similarity(h2, s2);
  similarity_inverse(s2, inv);
  matmul3(inv, h, x);
  matmul3(x, s1, h);
  normalize_sign(h);
  similarity_inverse(t2g, inv);
  matmul3(inv, h, x);
  matmul3(x, t1g, h);
  normalize_sign(h);
}

// fmodel._f_from_nullvec: rank 2 in the normalized frame, then
// F = T2^T Fr T1 with T = Tc Tg, canonical
__device__ __forceinline__ void f_from_nullvec(float (&f)[3][3],
                                               const Hartley& h1,
                                               const Hartley& h2,
                                               const float (&t1g)[3][3],
                                               const float (&t2g)[3][3]) {
  float sc[3][3], t1[3][3], t2[3][3], t2t[3][3], x[3][3];
  similarity(h1, sc);
  matmul3(sc, t1g, t1);
  similarity(h2, sc);
  matmul3(sc, t2g, t2);
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) t2t[r][c] = t2[c][r];
  rank2_project(f);
  matmul3(t2t, f, x);
  matmul3(x, t1, f);
  canonical_f(f);
}

template <int kModel>
__global__ void __launch_bounds__(kThreads)
moment_refit_assemble(const float* __restrict__ mom, int count,
                      float* __restrict__ ata, float* __restrict__ params) {
  constexpr int kWidth = kModel == kHomography ? 30 : 36;
  const int m = blockIdx.x * kThreads + threadIdx.x;
  if (m >= count) return;
  float mo[kWidth];
  const float* src = mom + static_cast<long long>(m) * kWidth;
#pragma unroll
  for (int k = 0; k < kWidth; ++k) mo[k] = src[k];
  Hartley h1, h2;
  float tri[kN * kN];  // the lower triangle
  if constexpr (kModel == kHomography)
    assemble_h(mo, h1, h2, tri);
  else
    assemble_f(mo, h1, h2, tri);
  float* dst = ata + static_cast<long long>(m) * kN * kN;
#pragma unroll
  for (int r = 0; r < kN; ++r)
#pragma unroll
    for (int c = 0; c <= r; ++c) {
      dst[r * kN + c] = tri[r * kN + c];
      dst[c * kN + r] = tri[r * kN + c];
    }
  float* p = params + static_cast<long long>(m) * 6;
  p[0] = h1.s; p[1] = h1.cx; p[2] = h1.cy;
  p[3] = h2.s; p[4] = h2.cx; p[5] = h2.cy;
}

template <int kModel>
__global__ void __launch_bounds__(kThreads)
moment_refit_denormalize(const float* __restrict__ vec,
                         const float* __restrict__ params, int count,
                         const float* __restrict__ t1g_in,
                         const float* __restrict__ t2g_in,
                         float* __restrict__ out) {
  const int m = blockIdx.x * kThreads + threadIdx.x;
  if (m >= count) return;
  float model[3][3], t1g[3][3], t2g[3][3];
  const float* v = vec + static_cast<long long>(m) * kN;
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    model[k / 3][k % 3] = v[k];
    t1g[k / 3][k % 3] = t1g_in[k];
    t2g[k / 3][k % 3] = t2g_in[k];
  }
  const float* p = params + static_cast<long long>(m) * 6;
  const Hartley h1{p[0], p[1], p[2]}, h2{p[3], p[4], p[5]};
  if constexpr (kModel == kHomography)
    h_from_nullvec(model, h1, h2, t1g, t2g);
  else
    f_from_nullvec(model, h1, h2, t1g, t2g);
  float* dst = out + static_cast<long long>(m) * kN;
#pragma unroll
  for (int k = 0; k < kN; ++k) dst[k] = model[k / 3][k % 3];
}

int blocks_of(int c) { return (c + kThreads - 1) / kThreads; }

}  // namespace

// mom: (C, 30) homography or (C, 36) fundamental moment tables in the
// global frame (fundamental = 0 / 1); ata: (C, 9, 9) normalized normal
// matrices; params: (C, 6) Hartley parameters (s, cx, cy of image 1,
// then of image 2).
extern "C" int multih_moment_refit_assemble(const float* mom, int c,
                                            int fundamental, float* ata,
                                            float* params, void* stream) {
  if (c > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (fundamental)
      moment_refit_assemble<kFundamental><<<blocks_of(c), kThreads, 0, st>>>(
          mom, c, ata, params);
    else
      moment_refit_assemble<kHomography><<<blocks_of(c), kThreads, 0, st>>>(
          mom, c, ata, params);
  }
  return static_cast<int>(cudaGetLastError());
}

// vec: (C, 9) unit nullvectors of the normal matrices; params: as the
// assembly wrote them; t1g, t2g: the (3, 3) global similarities; out:
// (C, 3, 3) models.
extern "C" int multih_moment_refit_denormalize(const float* vec,
                                               const float* params, int c,
                                               int fundamental,
                                               const float* t1g,
                                               const float* t2g, float* out,
                                               void* stream) {
  if (c > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (fundamental)
      moment_refit_denormalize<kFundamental>
          <<<blocks_of(c), kThreads, 0, st>>>(vec, params, c, t1g, t2g, out);
    else
      moment_refit_denormalize<kHomography>
          <<<blocks_of(c), kThreads, 0, st>>>(vec, params, c, t1g, t2g, out);
  }
  return static_cast<int>(cudaGetLastError());
}
