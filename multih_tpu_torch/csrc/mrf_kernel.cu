// Fused PEARL relaxation sweeps over a far-free banded adjacency, read
// through its per-row neighbour list: annealed mean-field (K4, all sweeps
// in one launch), batched red-black ICM (K5, every half-sweep of every
// start in one launch), the fused front (K6) and the list build.
//
// Replaces the TPU kernels multih_tpu/ops/kernels/mrf_kernel.py
// (_mf_kernel, launched by mean_field_fused; _icm_kernel, launched by
// icm_fused; _mf_front_kernel, launched by mean_field_fused_front). The
// TPU grid runs (sweep, block) in order with the state in VMEM. Here
// sweep s+1 of a point needs sweep s of its neighbours, which lie within
// one Morton block of it (the band is far-free), so the barrier between
// sweeps sits inside the launch.
//
// The neighbour list (band_list, one warp a row, ballot / popc
// compaction in column order) holds, for row i, cnt[i] (global column,
// weight) pairs of the band row's non-zeros in a fixed capacity of 3B
// slots (no host sync sizes it; the slots past cnt[i] are zero). The
// band holds ~1-2% non-zeros, so a row is ~7 pairs in place of 3B band
// entries, and any count up to 3B is read in steps of 32.
//
// Bound on the H100: at N=512 a sweep moves ~0.1 MB, a fraction of a
// microsecond at 3.35 TB/s, so what is left is latency: the chain of
// dependent loads of a point's neighbours and the barrier a sweep.
// Layout: one warp a point, one label a lane (two for L <= 64): lane j
// sums w * q[j, g] over the row's pairs (the 32 pairs of a step are
// loaded by the 32 lanes and broadcast by shuffles, 8 loads in flight),
// so the label softmax is one warp max and one warp sum, and the ICM
// argmin one first-minimum butterfly.
//
// Each call is one cooperative launch of as many 8-warp blocks as are
// resident at once, warps striding over the points (ICM: over the
// (start, moving point) pairs of every start), this_grid().sync() the
// barrier between sweeps. Mean-field first copies q0 and base into
// point-major scratch ((N, L|1) floats, so a neighbour's L values are
// contiguous), double-buffers the state there (L2-resident) and writes
// the last sweep label-major; ICM double-buffers the labels. A design
// with the state in the shared memory of a thread-block cluster
// (cluster.sync() between sweeps, neighbours through distributed shared
// memory) was measured beside this one on the H100 and was slower at
// every shape the fit runs (PERF.md, section 6).
//
// Arithmetic is that of the plain versions in ops/kernels/mrf_kernel.py:
// sw*agree and the subtraction from base are rounded separately
// (__fmul_rn / __fsub_rn, no FMA contraction), IEEE exp and divide; the
// mean-field agreement sums in list order, the plain version's bmm in
// its own (within 1e-5). ICM's agreements are sums of band values
// {0.5, 1}, exact in any order, so its costs, and its labels, equal the
// plain version's exactly.
//
// K6, the fused front: the homography residuals, the data costs and base
// = dct + sw*deg, as the TPU kernel does in its load pass, then every
// sweep, in one cooperative launch (mf_front_grid). The pass before the
// first grid barrier is the front, laid out for itself: a block stages
// the K planes' H, adjugate and active flag in shared memory once, then
// takes tiles of 32 consecutive points, a lane a point and a warp every
// 8th label, so the point inputs are read and r and dct (label-major)
// written coalesced; base and q0 go point-major into the sweeps' scratch
// through a shared tile (contiguous stores). After the barrier run K4's
// sweeps (mf_sweeps, the code mf_grid runs), so K6's q equals K4's on
// K6's own base bit for bit. It reads the fit's own tensors (x1, x2,
// valid, deg, Hs, active, by their strides) and thr from device memory;
// the adjugate is rounded term by term as geometry.adjugate_3x3 rounds
// it. Residuals use IEEE division and the plain elementwise order (no
// FMA), so near a vanishing w (r up to 1e9 px^2) they stay the plain
// version's to float32 rounding. Bound: at N=512 the call moves ~0.18
// MB and its front does ~0.4 M operations, together ~0.05 us at the
// card's rates; what is left is latency: the front's loads and its
// division chains before the first barrier, then K4's sweeps. A variant
// that loaded a tile's points and q0 before the planes' staging and
// unrolled a lane's labels was measured beside this one on the H100 and
// was no faster (PERF.md, section 6).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;  // warps a block
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// every lane ends with the same sum: each butterfly step adds the same
// two values, and addition commutes exactly
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// q[lbl, g] = p[g * gs + lbl * ls]: label-major (gs 1, ls N) or
// point-major (gs L|1, ls 1) state in device memory
struct GlobalQ {
  const float* p;
  int gs, ls;
  __device__ __forceinline__ const float* row(int g) const {
    return p + static_cast<size_t>(g) * gs;
  }
};

// acc[k] = sum over row i's pairs (g, w) of w * q[lane + 32k, g], in list
// order. Lane e loads pair e of each step of 32; shuffles broadcast them,
// kIlp pairs at a time, whose loads are all issued before their sums (a
// pair past the row's end loads nothing, weighs 0 and adds exactly
// nothing).
constexpr int kIlp = 8;

template <int LPL>
__device__ __forceinline__ void agree_row(const GlobalQ& q,
                                          const int* __restrict__ cols,
                                          const float* __restrict__ ws,
                                          int cnt, int lane, int l,
                                          float (&acc)[LPL]) {
#pragma unroll
  for (int k = 0; k < LPL; ++k) acc[k] = 0.f;
  for (int e0 = 0; e0 < cnt; e0 += 32) {
    int gv = 0;
    float wv = 0.f;
    if (e0 + lane < cnt) {
      gv = cols[e0 + lane];
      wv = ws[e0 + lane];
    }
    const int m = min(32, cnt - e0);
    for (int j = 0; j < m; j += kIlp) {
      float w[kIlp], v[kIlp][LPL];
#pragma unroll
      for (int u = 0; u < kIlp; ++u) {
        const int g = __shfl_sync(kFull, gv, (j + u) & 31);
        const float wu = __shfl_sync(kFull, wv, (j + u) & 31);
        w[u] = j + u < m ? wu : 0.f;
        const float* row = q.row(g);
#pragma unroll
        for (int k = 0; k < LPL; ++k) {
          const int lbl = lane + 32 * k;
          v[u][k] = lbl < l && j + u < m ? row[lbl * q.ls] : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kIlp; ++u)
#pragma unroll
        for (int k = 0; k < LPL; ++k)
          acc[k] = __fmaf_rn(w[u], v[u][k], acc[k]);
    }
  }
}

// base_l of the warp's point, b[lbl * bs], one label a lane (loaded
// before the agreement, so its latency overlaps the neighbours')
template <int LPL>
__device__ __forceinline__ void load_base(const float* b, int bs, int lane,
                                          int l, float (&bv)[LPL]) {
#pragma unroll
  for (int k = 0; k < LPL; ++k) {
    const int lbl = lane + 32 * k;
    bv[k] = lbl < l ? b[static_cast<size_t>(lbl) * bs] : 0.f;
  }
}

// acc (agreements) -> the point's marginals softmax_l(-(base_l -
// sw*agree_l) * it)
template <int LPL>
__device__ __forceinline__ void mf_finish(float (&acc)[LPL],
                                          const float (&bv)[LPL], float it,
                                          float sw, int lane, int l) {
  float m = -INFINITY;
#pragma unroll
  for (int k = 0; k < LPL; ++k) {
    if (lane + 32 * k < l) {
      const float cost = __fsub_rn(bv[k], __fmul_rn(sw, acc[k]));
      acc[k] = __fmul_rn(-cost, it);
      m = fmaxf(m, acc[k]);
    }
  }
  m = warp_max(m);
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < LPL; ++k) {
    if (lane + 32 * k < l) {
      acc[k] = expf(__fsub_rn(acc[k], m));
      s = __fadd_rn(s, acc[k]);
    }
  }
  s = warp_sum(s);
#pragma unroll
  for (int k = 0; k < LPL; ++k) acc[k] = __fdiv_rn(acc[k], s);
}

// The neighbour list of a far-free band, one warp a row: the row's
// non-zeros with an in-range global column (b-1)*B + c, in column order.
__global__ void __launch_bounds__(kWarps * 32)
band_list(const float* __restrict__ band, int n, int block,
          int* __restrict__ cols, float* __restrict__ ws,
          int* __restrict__ cnt) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i >= n) return;  // uniform across the warp
  const int bb = 3 * block;
  const int g0 = (i / block - 1) * block;
  const float* brow = band + static_cast<size_t>(i) * bb;
  int* ci = cols + static_cast<size_t>(i) * bb;
  float* wi = ws + static_cast<size_t>(i) * bb;
  int pos = 0;
  for (int c0 = 0; c0 < bb; c0 += 32) {
    const int c = c0 + lane;
    const float w = c < bb ? brow[c] : 0.f;
    const int g = g0 + c;
    const bool keep = c < bb && w != 0.f && g >= 0 && g < n;
    const unsigned mask = __ballot_sync(kFull, keep);
    if (keep) {
      const int k = pos + __popc(mask & ((1u << lane) - 1u));
      ci[k] = g;
      wi[k] = w;
    }
    pos += __popc(mask);
  }
  for (int k = pos + lane; k < bb; k += 32) {
    ci[k] = 0;
    wi[k] = 0.f;
  }
  if (lane == 0) cnt[i] = pos;
}

// K4's sweeps, run by mf_grid and mf_front_grid after their first pass
// and its grid barrier: sweep s reads the state point-major from buf0 or
// buf1 and base from sbase (both (N, L|1)), writes the other buffer, or
// `out` label-major on the last sweep, and waits at the grid barrier.
template <int LPL>
__device__ __forceinline__ void mf_sweeps(
    cg::grid_group& grid, const float* sbase, float* buf0, float* buf1,
    const int* __restrict__ cols, const float* __restrict__ ws,
    const int* __restrict__ cnt, int cap,
    const float* __restrict__ inv_temps, int n_sweeps, int l, int n,
    float sw, float* __restrict__ out) {
  const int ls = l | 1;
  const int lane = threadIdx.x & 31;
  const int gw = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int nw = (gridDim.x * blockDim.x) >> 5;
  for (int s = 0; s < n_sweeps; ++s) {
    const bool last = s == n_sweeps - 1;
    const GlobalQ q{(s & 1) ? buf1 : buf0, ls, 1};
    float* dst = (s & 1) ? buf0 : buf1;
    const float it = inv_temps[s];
    for (int i = gw; i < n; i += nw) {
      float acc[LPL], bv[LPL];
      load_base<LPL>(sbase + static_cast<size_t>(i) * ls, 1, lane, l, bv);
      agree_row<LPL>(q, cols + static_cast<size_t>(i) * cap,
                     ws + static_cast<size_t>(i) * cap, cnt[i], lane, l,
                     acc);
      mf_finish<LPL>(acc, bv, it, sw, lane, l);
#pragma unroll
      for (int k = 0; k < LPL; ++k) {
        const int lbl = lane + 32 * k;
        if (lbl < l) {
          if (last)
            out[static_cast<size_t>(lbl) * n + i] = acc[k];
          else
            dst[static_cast<size_t>(i) * ls + lbl] = acc[k];
        }
      }
    }
    if (!last) grid.sync();
  }
}

// K4: every sweep in one cooperative launch, state in device
// memory: a first pass copies q0 and base point-major into tmp (coalesced
// reads), then every sweep reads its neighbours' L values contiguously.
template <int LPL>
__global__ void __launch_bounds__(kWarps * 32)
mf_grid(const float* __restrict__ q0, const float* __restrict__ base,
        const int* __restrict__ cols, const float* __restrict__ ws,
        const int* __restrict__ cnt, int cap,
        const float* __restrict__ inv_temps, int n_sweeps, int l, int n,
        float sw, float* __restrict__ out, float* __restrict__ tmp) {
  cg::grid_group grid = cg::this_grid();
  const int ls = l | 1;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int nt = gridDim.x * blockDim.x;
  float* sbase = tmp;
  float* buf0 = tmp + static_cast<size_t>(n) * ls;
  float* buf1 = buf0 + static_cast<size_t>(n) * ls;
  for (int t = tid; t < l * n; t += nt) {
    const int lbl = t / n, i = t - lbl * n;
    sbase[static_cast<size_t>(i) * ls + lbl] = base[t];
    buf0[static_cast<size_t>(i) * ls + lbl] = q0[t];
  }
  grid.sync();
  mf_sweeps<LPL>(grid, sbase, buf0, buf1, cols, ws, cnt, cap, inv_temps,
                 n_sweeps, l, n, sw, out);
}

// One ICM move of point i (current label cur), by its warp: its first
// cheapest label (strict <, lowest label on ties) when that beats cur by
// more than 1e-6, else cur. Lane e of each step of 32 reads pair e's
// neighbour label; the warp then walks them, lane j adding the weights
// of label j.
template <int LPL>
__device__ __forceinline__ int icm_point(const int* __restrict__ lab,
                                         int cur,
                                         const float* base_i, int n,
                                         const int* __restrict__ ci,
                                         const float* __restrict__ wi,
                                         int c, int lane, int l, float sw) {
  float acc[LPL], bv[LPL];
  load_base<LPL>(base_i, n, lane, l, bv);
#pragma unroll
  for (int k = 0; k < LPL; ++k) acc[k] = 0.f;
  for (int e0 = 0; e0 < c; e0 += 32) {
    int lv = -1;
    float wv = 0.f;
    if (e0 + lane < c) {
      lv = lab[ci[e0 + lane]];
      wv = wi[e0 + lane];
    }
    const int m = min(32, c - e0);
    for (int e = 0; e < m; ++e) {
      const int lc = __shfl_sync(kFull, lv, e);
      const float w = __shfl_sync(kFull, wv, e);
#pragma unroll
      for (int k = 0; k < LPL; ++k)
        if (lc == lane + 32 * k) acc[k] = __fadd_rn(acc[k], w);
    }
  }
  float cost[LPL];
  float bc = INFINITY;
  int bl = 1 << 30;
#pragma unroll
  for (int k = 0; k < LPL; ++k) {
    const int lbl = lane + 32 * k;
    cost[k] = 0.f;
    if (lbl < l) {
      cost[k] = __fsub_rn(bv[k], __fmul_rn(sw, acc[k]));
      if (cost[k] < bc) {
        bc = cost[k];
        bl = lbl;
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float oc = __shfl_xor_sync(kFull, bc, o);
    const int ol = __shfl_xor_sync(kFull, bl, o);
    if (oc < bc || (oc == bc && ol < bl)) {
      bc = oc;
      bl = ol;
    }
  }
  float mine = cost[0];
#pragma unroll
  for (int k = 1; k < LPL; ++k)
    if (cur >= 32 * k) mine = cost[k];
  float cur_c = __shfl_sync(kFull, mine, cur & 31);
  if (cur < 0 || cur >= l) cur_c = 0.f;  // the plain one-hot sum
  return bc < __fsub_rn(cur_c, 1e-6f) ? bl : cur;
}

// K5: every half-sweep of every start in one cooperative launch,
// warps striding over the (start, moving point) pairs, the labels
// double-buffered in device memory, this_grid().sync() between halves.
// Half-sweep h moves the points of parity (parity0 + h) & 1: a 'pt'
// rank runs one half-sweep a launch on its halo window, parity0
// alternating, and exchanges the halo between launches.
template <int LPL>
__global__ void __launch_bounds__(kWarps * 32)
icm_grid(const int* __restrict__ labels0, const float* __restrict__ base,
         const int* __restrict__ cols, const float* __restrict__ ws,
         const int* __restrict__ cnt, int cap, int halves, int parity0,
         int ns, int l, int n, float sw, int* __restrict__ out,
         int* __restrict__ tmp) {
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int nt = gridDim.x * blockDim.x;
  const int gw = tid >> 5, nw = nt >> 5;
  const size_t total = static_cast<size_t>(ns) * n;
  for (int h = 0; h < halves; ++h) {
    const int par = (parity0 + h) & 1;
    const bool last = h == halves - 1;
    const int* src = h == 0 ? labels0 : tmp + ((h - 1) & 1) * total;
    int* dst = last ? out : tmp + (h & 1) * total;
    for (size_t t = tid; t < total; t += nt)
      if (((t % n) & 1) != static_cast<size_t>(par)) dst[t] = src[t];
    const int moving = (n - par + 1) / 2;
    for (int it = gw; it < ns * moving; it += nw) {
      const int s = it / moving;
      const int i = 2 * (it - s * moving) + par;
      const int* lab_s = src + static_cast<size_t>(s) * n;
      const int moved = icm_point<LPL>(
          lab_s, lab_s[i], base + i, n,
          cols + static_cast<size_t>(i) * cap,
          ws + static_cast<size_t>(i) * cap, cnt[i], lane, l, sw);
      if (lane == 0) dst[static_cast<size_t>(s) * n + i] = moved;
    }
    if (!last) grid.sync();
  }
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

// K6's inputs as the fit holds them: x1, x2 (N, 2), valid (N,), deg (N,
// or N x 1), Hs (K, 3, 3), active (K,), each by its element strides, and
// the squared threshold in device memory.
struct FrontIn {
  const float *x1, *x2, *valid, *deg, *hs, *active, *thr;
  int x1_r, x1_c, x2_r, x2_c, valid_s, deg_s, hs_k, hs_r, hs_c, active_s;
};

constexpr int kTileP = 32;  // points a front tile, a lane each

// K6: the front, then (n_sweeps > 0) the grid barrier and K4's sweeps.
// Front, per point i (a lane) and label j (warp j mod 8): the squared
// residual r (forward transfer through H_j, plus, when SYMMETRIC, the
// backward transfer through its adjugate), the truncated-quadratic data
// cost dct (labeling.data_costs_t: min(r/thr, 8)*oc, +1e6 on an
// inactive plane, oc on the outlier row L-1, times valid) and base = dct
// + sw*deg; r (labels < L-1) and dct are written label-major, base and
// q0 point-major into tmp (with no sweeps, q0 is copied to out).
template <int LPL, bool SYMMETRIC>
__global__ void __launch_bounds__(kWarps * 32)
mf_front_grid(const float* __restrict__ q0, FrontIn in,
              const int* __restrict__ cols, const float* __restrict__ ws,
              const int* __restrict__ cnt, int cap,
              const float* __restrict__ inv_temps, int n_sweeps, int l,
              int n, float sw, float oc, float* __restrict__ out,
              float* __restrict__ dct, float* __restrict__ r_out,
              float* __restrict__ tmp) {
  constexpr int kTs = 32 * LPL + 1;  // a tile row's stride, L|1 at most
  __shared__ float s_h[(32 * LPL - 1) * 19];  // H (9), adj(H) (9), active
  __shared__ float s_base[kTileP * kTs];
  __shared__ float s_q[kTileP * kTs];
  const int k = l - 1;
  // one thread a plane: H, its adjugate, each product and difference
  // rounded on its own (geometry.adjugate_3x3; no FMA contraction), and
  // the active flag
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    float* h = s_h + j * 19;
#pragma unroll
    for (int e = 0; e < 9; ++e)
      h[e] = in.hs[j * in.hs_k + (e / 3) * in.hs_r + (e % 3) * in.hs_c];
    const auto minor = [&](int a, int b, int c, int d) {
      return __fsub_rn(__fmul_rn(h[a], h[b]), __fmul_rn(h[c], h[d]));
    };
    h[9] = minor(4, 8, 5, 7);
    h[10] = minor(2, 7, 1, 8);
    h[11] = minor(1, 5, 2, 4);
    h[12] = minor(5, 6, 3, 8);
    h[13] = minor(0, 8, 2, 6);
    h[14] = minor(2, 3, 0, 5);
    h[15] = minor(3, 7, 4, 6);
    h[16] = minor(1, 6, 0, 7);
    h[17] = minor(0, 4, 1, 3);
    h[18] = in.active[j * in.active_s];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int ls = l | 1;
  const float thr = *in.thr;
  float* sbase = tmp;
  float* buf0 = tmp + static_cast<size_t>(n) * ls;
  float* buf1 = buf0 + static_cast<size_t>(n) * ls;
  for (int i0 = blockIdx.x * kTileP; i0 < n; i0 += gridDim.x * kTileP) {
    const int i = i0 + lane;
    if (i < n) {
      const float x = in.x1[i * in.x1_r], y = in.x1[i * in.x1_r + in.x1_c];
      const float u = in.x2[i * in.x2_r], v = in.x2[i * in.x2_r + in.x2_c];
      const float valid = in.valid[i * in.valid_s];
      const float sw_deg = __fmul_rn(sw, in.deg[i * in.deg_s]);
      for (int j = wid; j < l; j += kWarps) {
        const size_t o = static_cast<size_t>(j) * n + i;
        float d = oc;
        if (j < k) {
          const float* h = s_h + j * 19;  // a broadcast across the warp
          const float w1 = safe_w(affine(h[6], x, h[7], y, h[8]));
          const float px = __fdiv_rn(affine(h[0], x, h[1], y, h[2]), w1);
          const float py = __fdiv_rn(affine(h[3], x, h[4], y, h[5]), w1);
          float r = __fadd_rn(sq(__fsub_rn(px, u)), sq(__fsub_rn(py, v)));
          if (SYMMETRIC) {
            const float w2 = safe_w(affine(h[15], u, h[16], v, h[17]));
            const float bx = __fdiv_rn(affine(h[9], u, h[10], v, h[11]), w2);
            const float by = __fdiv_rn(affine(h[12], u, h[13], v, h[14]),
                                       w2);
            r = __fadd_rn(__fadd_rn(r, sq(__fsub_rn(bx, x))),
                          sq(__fsub_rn(by, y)));
          }
          r_out[o] = r;
          float c = __fdiv_rn(r, thr);
          c = c > 8.f ? 8.f : c;  // clamp_max: NaN stays NaN
          d = __fadd_rn(__fmul_rn(c, oc),
                        __fmul_rn(__fsub_rn(1.f, h[18]), 1e6f));
        }
        d = __fmul_rn(d, valid);
        dct[o] = d;
        if (n_sweeps > 0) {  // ls is odd: lanes hit distinct banks
          s_base[lane * ls + j] = __fadd_rn(d, sw_deg);
          s_q[lane * ls + j] = q0[o];
        } else {
          out[o] = q0[o];
        }
      }
    }
    if (n_sweeps > 0) {
      // the tile's points are contiguous point-major rows
      __syncthreads();
      const size_t o = static_cast<size_t>(i0) * ls;
      const int m = min(kTileP, n - i0) * ls;
      for (int t = threadIdx.x; t < m; t += blockDim.x) {
        sbase[o + t] = s_base[t];
        buf0[o + t] = s_q[t];
      }
      __syncthreads();
    }
  }
  if (n_sweeps == 0) return;  // uniform across the grid
  cg::grid_group grid = cg::this_grid();
  grid.sync();
  mf_sweeps<LPL>(grid, sbase, buf0, buf1, cols, ws, cnt, cap, inv_temps,
                 n_sweeps, l, n, sw, out);
}

// Launches `kern` cooperatively: as many 8-warp blocks as `want`, but
// no more than are resident at once, so that every warp reaches each
// grid sync.
template <auto kern>
int launch_grid(int want, void** args, cudaStream_t st) {
  static int per_sm = -1, sms = 0;  // one static a kernel
  if (per_sm < 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                  kWarps * 32, 0);
  }
  const int blocks = min(want, per_sm * sms);
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int rc = static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(kern), dim3(blocks), dim3(kWarps * 32), args,
      0, st));
  return rc ? rc : static_cast<int>(cudaGetLastError());
}

template <int LPL>
int mean_field(const float* q0, const float* base, const int* cols,
               const float* ws, const int* cnt, int cap,
               const float* inv_temps, int n_sweeps, int l, int n, float sw,
               float* out, float* tmp, cudaStream_t st) {
  void* args[] = {&q0, &base, &cols, &ws, &cnt, &cap, &inv_temps,
                  &n_sweeps, &l, &n, &sw, &out, &tmp};
  return launch_grid<mf_grid<LPL>>((n + kWarps - 1) / kWarps, args, st);
}

// K6: one cooperative launch, the front's tiles and the sweeps' warps
// striding over the points (a warp a point at most)
template <int LPL>
int mean_field_front(const float* q0, const FrontIn& in, const int* cols,
                     const float* ws, const int* cnt, int cap,
                     const float* inv_temps, int n_sweeps, int l, int n,
                     float sw, float oc, int symmetric, float* out,
                     float* dct, float* r, float* tmp, cudaStream_t st) {
  void* args[] = {&q0, const_cast<FrontIn*>(&in), &cols, &ws, &cnt,
                  &cap, &inv_temps, &n_sweeps, &l, &n, &sw, &oc, &out,
                  &dct, &r, &tmp};
  const int want = (n + kWarps - 1) / kWarps;
  return symmetric
             ? launch_grid<mf_front_grid<LPL, true>>(want, args, st)
             : launch_grid<mf_front_grid<LPL, false>>(want, args, st);
}

template <int LPL>
int icm(const int* labels0, const float* base, const int* cols,
        const float* ws, const int* cnt, int cap, int halves, int parity0,
        int ns, int l, int n, float sw, int* out, int* tmp,
        cudaStream_t st) {
  void* args[] = {&labels0, &base, &cols, &ws, &cnt, &cap, &halves,
                  &parity0, &ns, &l, &n, &sw, &out, &tmp};
  return launch_grid<icm_grid<LPL>>(
      (ns * ((n + 1) / 2) + kWarps - 1) / kWarps, args, st);
}

}  // namespace

extern "C" int multih_band_list(const float* band, int nb, int block,
                                int* cols, float* ws, int* cnt,
                                void* stream) {
  const int n = nb * block;
  band_list<<<(n + kWarps - 1) / kWarps, kWarps * 32, 0,
              static_cast<cudaStream_t>(stream)>>>(band, n, block, cols, ws,
                                                   cnt);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int multih_mean_field(const float* q0, const float* base,
                                 const int* cols, const float* ws,
                                 const int* cnt, int cap,
                                 const float* inv_temps, int n_sweeps, int l,
                                 int n, float sw, float* out, float* tmp,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (l <= 32)
    return mean_field<1>(q0, base, cols, ws, cnt, cap, inv_temps, n_sweeps,
                         l, n, sw, out, tmp, st);
  if (l <= 64)
    return mean_field<2>(q0, base, cols, ws, cnt, cap, inv_temps, n_sweeps,
                         l, n, sw, out, tmp, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int multih_mean_field_front(
    const float* q0, const float* x1, int x1_r, int x1_c, const float* x2,
    int x2_r, int x2_c, const float* valid, int valid_s, const float* deg,
    int deg_s, const float* hs, int hs_k, int hs_r, int hs_c,
    const float* active, int active_s, const float* thr, const int* cols,
    const float* ws, const int* cnt, int cap, const float* inv_temps,
    int n_sweeps, int l, int n, float sw, float oc, int symmetric,
    float* out, float* dct, float* r, float* tmp, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const FrontIn in{x1,   x2,   valid,   deg,   hs,   active, thr,
                   x1_r, x1_c, x2_r,    x2_c,  valid_s, deg_s, hs_k,
                   hs_r, hs_c, active_s};
  if (l <= 32)
    return mean_field_front<1>(q0, in, cols, ws, cnt, cap, inv_temps,
                               n_sweeps, l, n, sw, oc, symmetric, out, dct,
                               r, tmp, st);
  if (l <= 64)
    return mean_field_front<2>(q0, in, cols, ws, cnt, cap, inv_temps,
                               n_sweeps, l, n, sw, oc, symmetric, out, dct,
                               r, tmp, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int multih_icm(const int* labels0, const float* base,
                          const int* cols, const float* ws, const int* cnt,
                          int cap, int halves, int parity0, int ns, int l,
                          int n, float sw, int* out, int* tmp,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (l <= 32)
    return icm<1>(labels0, base, cols, ws, cnt, cap, halves, parity0, ns, l,
                  n, sw, out, tmp, st);
  if (l <= 64)
    return icm<2>(labels0, base, cols, ws, cnt, cap, halves, parity0, ns, l,
                  n, sw, out, tmp, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
