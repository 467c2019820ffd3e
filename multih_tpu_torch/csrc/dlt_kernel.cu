// Batched minimal 4-point homography solves.
//
// Replaces the TPU kernel multih_tpu/ops/kernels/dlt_kernel.py
// (_dlt_kernel, launched by _solve_packed). Same math as there and as
// geometry.homography_4pt: Hartley normalisation of both quads, the 8x9
// DLT rows, a Givens QR with the same EPS guards, back substitution with
// h9 = 1, denormalisation, Frobenius norm, h33 >= 0.
//
// Bound on the H100: the serial chain of the rotations, not bytes (16
// floats in, 9 out) or flops. Rotation (c, k) needs the pivot that
// rotation (c, k - 1) wrote, so the plain version's 28 rotations are a
// chain of 28 steps whatever the layout; spreading a solve's columns
// over lanes adds two shuffles to every step (4 lanes a solve,
// tools/dlt_lanes.cu, measured no faster at S = 512 and over twice as
// slow at S = 51200 on the H100). Design: the chain is
// shortened by the DLT system's structure. The rows of point i are
// [p_i, 0, -u_i p_i] and [0, -p_i, v_i p_i], so the 6 rotations that
// triangularise the 4x3 P triangularise both blocks, and one more
// finishes the 2x3 rest: 7 steps and ~520 operations in place of 28 and
// ~1.5k, with the same R up to row signs (so the same nullspace). One
// thread per solve in registers (every index a compile-time constant),
// blocks of 32 threads (S = 512 solves over 16 SMs); a step is a*a +
// b*b, the hardware's reciprocal square root refined by a Newton step,
// and two multiplies. The solve runs in double (the inputs are exact
// float32 values): ~1 in 50k random quads is sensitive enough that
// float32 solves of it, however rounded, land up to ~1e-3 apart (the
// plain version, the TPU kernel's float32 algebra, a fast-math float32
// kernel), past the 5e-4 the JAX kernel holds; in double the H's are
// within ~3e-8 of a float64 solve of the same quads, so within the
// plain version's own distance from it (< 1e-4 where that is well
// conditioned) on every quad.
//
// The pipeline's entry (multih_dlt_4pt_gt) reads the sampler's (32, S)
// rows where they lie (row 8q + c = channel c of quad point q, channel
// 4 = avail; any strides) and writes ok beside H: a quad is rejected if
// any 3 of its points in either image are collinear to 1e-4 (twice the
// triangle area, geometry.quad_degenerate_t) or it uses a padded point.
// That test rounds each product and difference as the eager ops do
// (__fsub_rn / __fmul_rn: no FMA contraction), so ok equals the plain
// version's bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr float kEps = 1e-12f;
constexpr float kEps2 = 1e-24f;  // kEps squared: |d| > EPS as d^2 > EPS^2
constexpr float kDegenerate = 1e-4f;
constexpr int kThreads = 32;

__device__ __forceinline__ float rcp(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// 1 / sqrt(x) and 1 / x in double from the float32 hardware estimate
// (~23 bits) and one Newton step (~46 bits, far past the float32
// output): three or four operations on the chain in place of the
// library's double square root and division. x lies in float32's normal
// range here (clamped to >= EPS^2, or |x| >= EPS for rcp_d).
__device__ __forceinline__ double rsqrt_d(double x) {
  const double y = rsqrtf(static_cast<float>(x));
  return y * fma(-0.5 * x, y * y, 1.5);
}
__device__ __forceinline__ double rcp_d(double x) {
  const double y = rcp(static_cast<float>(x));
  return fma(y, fma(-x, y, 1.0), y);
}

// geometry.hartley_normalize for 4 points with unit weights
__device__ __forceinline__ void hartley(const float* q, double* nq,
                                        double& s, double& cx, double& cy) {
  cx = (double(q[0]) + q[2] + q[4] + q[6]) * 0.25;
  cy = (double(q[1]) + q[3] + q[5] + q[7]) * 0.25;
  double ms = 0;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    nq[2 * p] = q[2 * p] - cx;
    nq[2 * p + 1] = q[2 * p + 1] - cy;
    ms += nq[2 * p] * nq[2 * p] + nq[2 * p + 1] * nq[2 * p + 1];
  }
  // s = sqrt(2) / sqrt(max(ms / 4, EPS))
  ms *= 0.25;
  s = 1.4142135623730951 * rsqrt_d(ms > kEps ? ms : kEps);
#pragma unroll
  for (int k = 0; k < 8; ++k) nq[k] *= s;
}

// twice the area of triangle (a, b, c), rounded as the eager ops round
__device__ __forceinline__ float tri_area2(const float* px, const float* py,
                                           int a, int b, int c) {
  const float t1 = __fmul_rn(__fsub_rn(px[b], px[a]),
                             __fsub_rn(py[c], py[a]));
  const float t2 = __fmul_rn(__fsub_rn(py[b], py[a]),
                             __fsub_rn(px[c], px[a]));
  return fabsf(__fsub_rn(t1, t2));
}

__device__ __forceinline__ bool degenerate(const float* q) {
  float px[4], py[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    px[p] = q[2 * p];
    py[p] = q[2 * p + 1];
  }
  return tri_area2(px, py, 0, 1, 2) < kDegenerate ||
         tri_area2(px, py, 0, 1, 3) < kDegenerate ||
         tri_area2(px, py, 0, 2, 3) < kDegenerate ||
         tri_area2(px, py, 1, 2, 3) < kDegenerate;
}

// (c, s) of the Givens rotation taking (a, b) to (d, 0), d = sqrt(a^2 +
// b^2), and d itself; (1, 0) and a where d <= EPS (the plain version's
// guard)
__device__ __forceinline__ void givens(double a, double b, double& cs,
                                       double& sn, double& d) {
  const double d2 = a * a + b * b;
  const bool live = d2 > static_cast<double>(kEps2);
  const double inv = rsqrt_d(live ? d2 : static_cast<double>(kEps2));
  cs = live ? a * inv : 1.0;
  sn = live ? b * inv : 0.0;
  d = live ? d2 * inv : a;
}

__device__ __forceinline__ void rotate(double cs, double sn, double& u,
                                       double& v) {
  const double ru = cs * u + sn * v;
  v = -sn * u + cs * v;
  u = ru;
}

// the plain version's back-substitution pivot: |d| < EPS -> +-EPS
__device__ __forceinline__ double pivot(double d) {
  const double eps = kEps;
  return (d < 0 ? -d : d) < eps ? (d < 0 ? -eps : eps) : d;
}

// The triangular system [R 0 T1'; 0 -R T2'; 0 0 B] of `solve` (R and
// the tails' rows 0-2 in m, t1, t2; B's rows in t1[3], t2[3], its pivot
// b00) -> back substitution of R x = 0 with x[8] = 1, unit norm,
// denormalisation, Frobenius norm and h33 >= 0: the 9 row-major entries
// of H.
__device__ __forceinline__ void finish(
    const double (&m)[4][3], const double (&t1)[4][3],
    const double (&t2)[4][3], double b00, double s1, double c1x,
    double c1y, double s2, double c2x, double c2y, float* hout) {
  const double eps2 = kEps2;
  double x[9];
  x[8] = 1.0;
  x[7] = -t2[3][2] * rcp_d(pivot(t2[3][1]));
  x[6] = -(t1[3][1] * x[7] + t1[3][2]) * rcp_d(pivot(b00));
#pragma unroll
  for (int c = 2; c >= 0; --c) {  // rows [0, -R, T2'] -> x[3..5]
    double acc = t2[c][0] * x[6] + t2[c][1] * x[7] + t2[c][2];
#pragma unroll
    for (int j = c + 1; j < 3; ++j) acc -= m[c][j] * x[3 + j];
    x[3 + c] = -acc * rcp_d(pivot(-m[c][c]));
  }
#pragma unroll
  for (int c = 2; c >= 0; --c) {  // rows [R, 0, T1'] -> x[0..2]
    double acc = t1[c][0] * x[6] + t1[c][1] * x[7] + t1[c][2];
#pragma unroll
    for (int j = c + 1; j < 3; ++j) acc += m[c][j] * x[j];
    x[c] = -acc * rcp_d(pivot(m[c][c]));
  }
  double vn = 0;
#pragma unroll
  for (int k = 0; k < 9; ++k) vn += x[k] * x[k];
  const double inv = rsqrt_d(vn > eps2 ? vn : eps2);
  double h[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) h[k] = x[k] * inv;

  // H = T2^-1 (Hn T1)
  const double A[3][3] = {
      {s1 * h[0], s1 * h[1], -s1 * c1x * h[0] - s1 * c1y * h[1] + h[2]},
      {s1 * h[3], s1 * h[4], -s1 * c1x * h[3] - s1 * c1y * h[4] + h[5]},
      {s1 * h[6], s1 * h[7], -s1 * c1x * h[6] - s1 * c1y * h[7] + h[8]},
  };
  const double inv_s2 = rcp_d(s2);
  double B[3][3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    B[0][j] = A[0][j] * inv_s2 + c2x * A[2][j];
    B[1][j] = A[1][j] * inv_s2 + c2y * A[2][j];
    B[2][j] = A[2][j];
  }
  double fro = 0;
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b) fro += B[a][b] * B[a][b];
  const double scale = rsqrt_d(fro > eps2 ? fro : eps2);
  const double sign = B[2][2] < 0 ? -scale : scale;
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b) hout[3 * a + b] = float(B[a][b] * sign);
}

// p[0:8]: x1 quad (xa ya xb yb xc yc xd yd), p[8:16]: x2 quad ->
// h: the 9 row-major entries of H
__device__ __forceinline__ void solve(const float* p, float* hout) {
  double n1[8], n2[8], s1, c1x, c1y, s2, c2x, c2y;
  hartley(p, n1, s1, c1x, c1y);
  hartley(p + 8, n2, s2, c2x, c2y);

  // The DLT rows of point i (geometry.dlt_rows), p_i = (x_i, y_i, 1):
  // [p_i, 0, -u_i p_i] and [0, -p_i, v_i p_i]. The rotations that
  // triangularise P (rows p_i, 4x3) triangularise both blocks at once,
  // so the 8x9 QR is one 4x3 QR carried along the blocks' tails
  // T1 = -U P and T2 = V P, then one rotation of the 2x3 rest:
  //   [R 0 T1'; 0 -R T2'; 0 0 B]  (the same R up to row signs as the
  // plain version's 28 rotations, so the same nullspace), 7 steps of the
  // chain in place of 28.
  double m[4][3], t1[4][3], t2[4][3];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i][0] = n1[2 * i];
    m[i][1] = n1[2 * i + 1];
    m[i][2] = 1.0;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      t1[i][j] = -n2[2 * i] * m[i][j];
      t2[i][j] = n2[2 * i + 1] * m[i][j];
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
#pragma unroll
    for (int k = c + 1; k < 4; ++k) {
      double cs, sn;
      givens(m[c][c], m[k][c], cs, sn, m[c][c]);
#pragma unroll
      for (int j = c + 1; j < 3; ++j) rotate(cs, sn, m[c][j], m[k][j]);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        rotate(cs, sn, t1[c][j], t1[k][j]);
        rotate(cs, sn, t2[c][j], t2[k][j]);
      }
    }
  }
  // B = [t1[3]; t2[3]] (columns 6-8): one rotation on its first column
  double cs, sn, b00;
  givens(t1[3][0], t2[3][0], cs, sn, b00);
  rotate(cs, sn, t1[3][1], t2[3][1]);
  rotate(cs, sn, t1[3][2], t2[3][2]);
  finish(m, t1, t2, b00, s1, c1x, c1y, s2, c2x, c2y, hout);
}

// gt: (32, S), element (row, i) at gt[row * rs + i * cs]. The block's 32
// columns are staged in shared memory with whichever index is adjacent
// in memory across the lanes, so each of the 32 loads is one coalesced
// 128-byte line (the sampler hands over a transposed view, strides (1,
// 32): read directly, a lane's 20 loads would touch 32 lines each).
__global__ void __launch_bounds__(kThreads)
dlt_gt(const float* __restrict__ gt, int s, int rs, int cs,
       float* __restrict__ out, float* __restrict__ ok) {
  __shared__ float tile[kThreads][kThreads + 1];  // [column][row], padded
  const int i0 = blockIdx.x * kThreads, t = threadIdx.x;
  const int cols = min(kThreads, s - i0);
  const bool rows_adjacent = rs <= cs;
  float v[kThreads];
#pragma unroll
  for (int k = 0; k < kThreads; ++k) {
    const int row = rows_adjacent ? t : k, col = rows_adjacent ? k : t;
    v[k] = col < cols ? gt[static_cast<long long>(row) * rs +
                           static_cast<long long>(i0 + col) * cs]
                      : 0.f;
  }
#pragma unroll
  for (int k = 0; k < kThreads; ++k) {
    if (rows_adjacent) {
      tile[k][t] = v[k];
    } else {
      tile[t][k] = v[k];
    }
  }
  __syncwarp();
  if (t >= cols) return;
  const float* q = tile[t];
  float p[16], h[9];
  bool pad = false;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    p[2 * j] = q[8 * j + 0];
    p[2 * j + 1] = q[8 * j + 1];
    p[8 + 2 * j] = q[8 * j + 2];
    p[8 + 2 * j + 1] = q[8 * j + 3];
    pad |= q[8 * j + 4] == 0.f;
  }
  const bool bad = pad || degenerate(p) || degenerate(p + 8);
  solve(p, h);
  const int i = i0 + t;
#pragma unroll
  for (int k = 0; k < 9; ++k) out[i * 9 + k] = h[k];
  ok[i] = bad ? 0.f : 1.f;
}

int blocks(int s) { return (s + kThreads - 1) / kThreads; }

}  // namespace

// gt: (32, S) sampler rows with strides (rs, cs); out: (S, 9); ok: (S,)
// float32, 1 where the quad is usable.
extern "C" int multih_dlt_4pt_gt(const float* gt, int s, int rs, int cs,
                                 float* out, float* ok, void* stream) {
  if (s > 0) {
    dlt_gt<<<blocks(s), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        gt, s, rs, cs, out, ok);
  }
  return static_cast<int>(cudaGetLastError());
}
