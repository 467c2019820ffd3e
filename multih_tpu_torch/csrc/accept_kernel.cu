// The two ends of one step of the F fit's accept fallback, on either side
// of K5: the fallback of models/pipeline.py::_f_accept tries the K models
// one at a time, each under an ICM relabel from the carried labeling, and
// keeps a model where the energy drops.
//
// Replaces no TPU kernel: these are the plain ops of one fallback step
// (the lax.scan body of the JAX package's pipeline.py:1556 accept). There
// a step was a residual row (ops/fmodel.py), a full relabel_energy
// (labeling.data_costs_t; best_labeling_t: K5, _energies_batch twice and
// the constant-labeling escape; total_energy_t) and the torch.where
// commits: ~128 graph nodes of a few microseconds each on (K+1) x N
// floats, one of them K5. Here a step is three nodes: the front, K5
// (csrc/mrf_kernel.cu, unchanged, launched through mrf_kernel.icm_fused
// as every other K5 launch is), the back. The carried state lives in
// device memory between them and from step to step:
//   dct, base  (L, N) the carried data costs and K5's base = dct +
//              sw*deg; during a step row i holds the candidate's, the
//              carried row is kept in save and put back by the back if
//              the step is refused;
//   starts     (2, N) int32: K5's two starts, the carried labeling (row
//              0, rewritten by the back on a commit) and the per-point
//              first argmin of the candidate's data costs (row 1);
//   hs_s, e_s  the carried models and energy.
//
// f_accept_front (step i; with `init`, step 0, which first takes the
// carried state from the accept's inputs): model i's candidate residual
// row, its data costs and base, K5's two starts. Row i of the carried
// residuals changes only at step i, so the candidate's row is the one the
// accept was handed: r_prop[i] (the proposal's) where ok_prop[i], else
// r_c[i] (the carried model's). Nothing is recomputed, so an unchanged
// model's row is the carried row bit for bit and no step is taken by an
// ulp.
//
// f_accept_back (step i): on K5's two polished starts, the
// constant-labeling escape of labeling._icm_batch, the start of lowest
// data + Potts energy (best_labeling_t, the first on ties) and
// total_energy_t's label-cost term; the step is taken where that energy
// is below the carried one, and its energy and verdict are written to
// e_steps[i] / took[i].
//
// Arithmetic is the plain route's, operation by operation, so that the
// two routes keep the same steps:
// - data costs and base as labeling.data_costs_t and _icm_batch round
//   them (min(r / thr, 8) * oc + (1 - active) * 1e6, times valid; dct +
//   sw*deg), each product and sum rounded on its own (no contraction:
//   __fmul_rn / __fadd_rn), NaN kept where PyTorch keeps it (clamp,
//   argmin, min);
// - energies as _energies_batch and total_energy_t: the per-point data
//   and Potts terms in float32 (the Potts sums of band weights {0.5, 1}
//   are exact in any order), summed over the points in float64 and
//   rounded to float32 only at the end, with the label-cost product in
//   float32. The float64 sums run in a fixed order (each thread its
//   points in turn, then a fixed butterfly and the warps in turn), so a
//   captured fit replays its eager fit bit for bit; they may differ from
//   PyTorch's order in the last float64 bits, which the float32 rounding
//   takes away but at a rounding boundary.
//
// Bound on the H100: at N=512, L=17 the front reads ~0.1 MB, the back
// ~0.2 MB (the costs twice, the neighbour lists, the labels); ~0.1 us at
// the card's rates. What is left is latency: one block of 512 threads (a
// thread a point; for larger N each thread takes every 512th point), the
// dependent loads of a point's neighbours' labels, and the back's block
// reductions; the loops over labels and neighbours are unrolled so that
// several loads are in flight. Measured on an H100 at that shape: ~3.9 us
// a front and ~10.4 us a back, against ~128 plain nodes (~0.27 ms) a step
// (PERF.md, section 6).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLabels = 64;  // mrf_kernel.MAX_LABELS
constexpr unsigned kFull = 0xffffffffu;

struct Step {
  // the fit's points and the graph
  const float* valid;   // (N,)
  const float* deg;     // (N,)
  const int* cols;      // the band's neighbour list (N, cap)
  const float* ws;      // (N, cap)
  const int* cnt;       // (N,)
  int cap;
  // the accept's inputs
  const float* active;  // (K,)
  const float* thr;     // ()
  const float* hs_prop;            // (K, 3, 3)
  const unsigned char* ok_prop;    // (K,) bool
  const float* r_prop;             // (K, N): the proposals' residuals
  const float* r_c;                // (K, N): the carried ones
  const long long* lab_c;          // (N,) int64, read by step 0
  const float* hs_c;               // (K, 3, 3), read by step 0
  const float* e_c;                // (), read by step 0
  const int* polished;             // (2, N): K5's output
  // the carried state and the steps' record
  float* hs_s;          // (K, 3, 3)
  float* e_s;           // ()
  float* dct;           // (L, N)
  float* base;          // (L, N)
  float* save;          // (2, N)
  int* starts;          // (2, N)
  float* e_steps;       // (K,)
  unsigned char* took;  // (K,) bool
  int k, n;
  double sw;            // spatial_weight (float64 in the energy)
  float oc, label_cost;
};

// labeling.data_costs_t of one model's residual at one point
__device__ __forceinline__ float data_cost(float r, float thr, float act,
                                           float vld, float oc) {
  float t = __fdiv_rn(r, thr);
  t = isnan(t) ? t : fminf(t, 8.f);
  const float p = __fadd_rn(__fmul_rn(t, oc),
                            __fmul_rn(__fsub_rn(1.f, act), 1e6f));
  return __fmul_rn(p, vld);
}

__global__ void __launch_bounds__(kThreads)
f_accept_front(const Step s, int i, int init) {
  const int n = s.n, l = s.k + 1;
  if (init) {
    for (int t = threadIdx.x; t < s.k * 9; t += kThreads)
      s.hs_s[t] = s.hs_c[t];
    if (threadIdx.x == 0) s.e_s[0] = s.e_c[0];
  }
  const float* r_i = (s.ok_prop[i] ? s.r_prop : s.r_c) + i * n;
  const float thr = s.thr[0];
  const float act = s.active[i];
  const float swf = static_cast<float>(s.sw);
  for (int p = threadIdx.x; p < n; p += kThreads) {
    const float vld = s.valid[p];
    const float swdeg = __fmul_rn(swf, s.deg[p]);
    const float d = data_cost(r_i[p], thr, act, vld, s.oc);
    if (init) {
      for (int j = 0; j < l; ++j) {
        const float dj = j < s.k ? data_cost(s.r_c[j * n + p], thr,
                                             s.active[j], vld, s.oc)
                                 : __fmul_rn(s.oc, vld);
        s.dct[j * n + p] = dj;
        s.base[j * n + p] = __fadd_rn(dj, swdeg);
      }
      s.starts[p] = static_cast<int>(s.lab_c[p]);
    }
    s.save[p] = s.dct[i * n + p];
    s.save[n + p] = s.base[i * n + p];
    s.dct[i * n + p] = d;
    s.base[i * n + p] = __fadd_rn(d, swdeg);
    // torch.argmin over the labels: the first minimum, a NaN first
    float best = s.dct[p];
    int arg = 0;
#pragma unroll 8
    for (int j = 1; j < l; ++j) {
      const float v = s.dct[j * n + p];
      if (!isnan(best) && (isnan(v) || v < best)) {
        best = v;
        arg = j;
      }
    }
    s.starts[n + p] = arg;
  }
}

__device__ __forceinline__ double warp_dsum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __dadd_rn(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__global__ void __launch_bounds__(kThreads)
f_accept_back(const Step s, int i) {
  __shared__ double part[4][kWarps];
  __shared__ double econst[kMaxLabels];
  __shared__ int used[2][kMaxLabels];
  // verdict[0]: -2 refused, -1 taken with the picked start's labels, l >=
  // 0 taken as the constant labeling l; verdict[1]: the picked start
  __shared__ int verdict[2];
  const int n = s.n, l = s.k + 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int t = threadIdx.x; t < 2 * kMaxLabels; t += kThreads)
    used[t / kMaxLabels][t % kMaxLabels] = 0;
  // each label's constant-labeling data energy, a warp a label (the loops
  // are unrolled so that the loads of several terms are in flight at
  // once; the sums keep their order)
  for (int j = warp; j < l; j += kWarps) {
    double acc = 0.0;
#pragma unroll 8
    for (int p = lane; p < n; p += 32)
      acc = __dadd_rn(acc, static_cast<double>(s.dct[j * n + p]));
    acc = warp_dsum(acc);
    if (lane == 0) econst[j] = acc;
  }
  __syncthreads();
  // the two polished starts' data and Potts sums over the points
  double acc[4] = {0.0, 0.0, 0.0, 0.0};
  for (int p = threadIdx.x; p < n; p += kThreads) {
    const int* ci = s.cols + static_cast<size_t>(p) * s.cap;
    const float* wi = s.ws + static_cast<size_t>(p) * s.cap;
    const int c = s.cnt[p];
    const float dg = s.deg[p];
    const int* lab1 = s.polished + n;
    const int lp0 = s.polished[p], lp1 = lab1[p];
    used[0][lp0] = 1;
    used[1][lp1] = 1;
    // the one-hot sums over the labels, both starts in one pass
    float ed0 = 0.f, ed1 = 0.f;
#pragma unroll 8
    for (int j = 0; j < l; ++j) {
      const float d = s.dct[j * n + p];
      ed0 = __fadd_rn(ed0, __fmul_rn(j == lp0 ? 1.f : 0.f, d));
      ed1 = __fadd_rn(ed1, __fmul_rn(j == lp1 ? 1.f : 0.f, d));
    }
    // agree[l_p, p]: the weights of the neighbours that share p's label,
    // in list order, eight neighbours' loads at a time
    float own0 = 0.f, own1 = 0.f;
    for (int e0 = 0; e0 < c; e0 += 8) {
      int g[8], a0[8], a1[8];
      float w[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        g[u] = e0 + u < c ? ci[e0 + u] : -1;
        w[u] = e0 + u < c ? wi[e0 + u] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        a0[u] = g[u] < 0 ? -1 : s.polished[g[u]];
        a1[u] = g[u] < 0 ? -1 : lab1[g[u]];
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (a0[u] == lp0) own0 = __fadd_rn(own0, w[u]);
        if (a1[u] == lp1) own1 = __fadd_rn(own1, w[u]);
      }
    }
    acc[0] = __dadd_rn(acc[0], static_cast<double>(ed0));
    acc[1] = __dadd_rn(acc[1], static_cast<double>(ed1));
    acc[2] = __dadd_rn(acc[2], static_cast<double>(__fsub_rn(dg, own0)));
    acc[3] = __dadd_rn(acc[3], static_cast<double>(__fsub_rn(dg, own1)));
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const double v = warp_dsum(acc[q]);
    if (lane == 0) part[q][warp] = v;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double sum[4];
    for (int q = 0; q < 4; ++q) {
      sum[q] = part[q][0];
      for (int w = 1; w < kWarps; ++w) sum[q] = __dadd_rn(sum[q], part[q][w]);
    }
    // e_const.min() and torch.argmin(e_const): NaN first
    double m = econst[0];
    int ls = 0;
    for (int j = 1; j < l; ++j) {
      const double v = econst[j];
      if (!isnan(m) && (isnan(v) || v < m)) {
        m = v;
        ls = j;
      }
    }
    double e_after[2];
    bool esc[2];
    for (int st = 0; st < 2; ++st) {
      const double e_cur = __dadd_rn(
          sum[st], __dmul_rn(s.sw, __dmul_rn(0.5, sum[2 + st])));
      // an escaped start is constant: its Potts term is exactly 0
      esc[st] = m < e_cur;
      e_after[st] = esc[st] ? m : e_cur;
    }
    const int pick = (isnan(e_after[1]) && !isnan(e_after[0]))
                     || e_after[1] < e_after[0];
    int n_models = 0;
    for (int j = 0; j < l - 1; ++j)
      if ((esc[pick] ? j == ls && n > 0 : used[pick][j] != 0)
          && s.active[j] > 0.f)
        ++n_models;
    const float e_n = __double2float_rn(__dadd_rn(
        e_after[pick], static_cast<double>(__fmul_rn(
                           s.label_cost, static_cast<float>(n_models)))));
    const bool taken = e_n < s.e_s[0];
    s.e_steps[i] = e_n;
    s.took[i] = taken;
    if (taken) {
      s.e_s[0] = e_n;
      if (s.ok_prop[i])
        for (int q = 0; q < 9; ++q) s.hs_s[i * 9 + q] = s.hs_prop[i * 9 + q];
    }
    verdict[0] = taken ? (esc[pick] ? ls : -1) : -2;
    verdict[1] = pick;
  }
  __syncthreads();
  const int v = verdict[0];
  const int* lab = s.polished + verdict[1] * n;
  for (int p = threadIdx.x; p < n; p += kThreads) {
    if (v == -2) {  // refused: the carried row back
      s.dct[i * n + p] = s.save[p];
      s.base[i * n + p] = s.save[n + p];
    } else {
      s.starts[p] = v >= 0 ? v : lab[p];
    }
  }
}

}  // namespace

// end 0: the front of step i (init: step 0, taking the carried state
// from the accept's inputs); end 1: the back of step i. One block each.
extern "C" int multih_f_accept_step(
    int end, int i, int init, const float* valid, const float* deg,
    const int* cols, const float* ws, const int* cnt, int cap,
    const float* active, const float* thr, const float* hs_prop,
    const unsigned char* ok_prop, const float* r_prop, const float* r_c,
    const long long* lab_c, const float* hs_c, const float* e_c,
    const int* polished, float* hs_s, float* e_s, float* dct, float* base,
    float* save, int* starts, float* e_steps, unsigned char* took, int k,
    int n, double sw, float oc, float label_cost, void* stream) {
  if (k + 1 > kMaxLabels) return static_cast<int>(cudaErrorInvalidValue);
  const Step s{valid,   deg,      cols,    ws,
               cnt,     cap,      active,  thr,
               hs_prop, ok_prop,  r_prop,  r_c,
               lab_c,   hs_c,     e_c,     polished,
               hs_s,    e_s,      dct,     base,
               save,    starts,   e_steps, took,
               k,       n,        sw,      oc,
               label_cost};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (end == 0)
    f_accept_front<<<1, kThreads, 0, st>>>(s, i, init);
  else
    f_accept_back<<<1, kThreads, 0, st>>>(s, i);
  return static_cast<int>(cudaGetLastError());
}
