// Alpha-expansion multi-label MRF solver with label costs — the parity
// oracle standing in for the reference's vendored gco-v3.0 (SURVEY.md §2
// C10/C11). Written from scratch from the published algorithms:
//   - max-flow: Dinic's algorithm (level graph + blocking flow)
//   - expansion moves: Boykov, Veksler, Zabih, "Fast Approximate Energy
//     Minimization via Graph Cuts", PAMI 2001, with the standard
//     submodular binary-term decomposition (Kolmogorov & Zabih 2004)
//   - label costs: auxiliary-node construction of Delong, Osokin, Isack,
//     Boykov, "Fast Approximate Energy Minimization with Label Costs",
//     CVPR 2010
//
// Energy (matches multih_tpu_torch.models.labeling.total_energy_t):
//   E(L) = sum_p D[p, L(p)]
//        + lambda * sum_{directed edges (p,q)} w_pq * [L(p) != L(q)] / 2
//        + sum_{l used} h_l
//
// Exposed via a C ABI for ctypes. A host oracle: no device code.
//
// Build: multih_tpu_torch/native.py runs g++ -O3 -std=c++17 -shared -fPIC
// on it at first use, into a host-keyed directory under build/.

#include <cstdint>
#include <cstring>
#include <limits>
#include <queue>
#include <vector>

namespace {

using Cap = double;
constexpr Cap kInf = std::numeric_limits<Cap>::max() / 4;

// ---------------------------------------------------------------------
// Dinic max-flow on an adjacency-list residual graph.
// ---------------------------------------------------------------------
class Dinic {
 public:
  explicit Dinic(int n) : n_(n), head_(n, -1), level_(n), iter_(n) {}

  // returns the edge id; the reverse edge is id^1
  int AddEdge(int u, int v, Cap cap, Cap rcap = 0) {
    int id = static_cast<int>(to_.size());
    to_.push_back(v); cap_.push_back(cap);
    next_.push_back(head_[u]); head_[u] = id;
    to_.push_back(u); cap_.push_back(rcap);
    next_.push_back(head_[v]); head_[v] = id + 1;
    return id;
  }

  Cap MaxFlow(int s, int t) {
    Cap flow = 0;
    while (Bfs(s, t)) {
      std::copy(head_.begin(), head_.end(), iter_.begin());
      Cap f;
      while ((f = Dfs(s, t, kInf)) > 0) flow += f;
    }
    return flow;
  }

  // after MaxFlow: true if node reachable from s in the residual graph
  // (source side of the min cut)
  bool SourceSide(int v) const { return level_[v] >= 0; }

 private:
  bool Bfs(int s, int t) {
    std::fill(level_.begin(), level_.end(), -1);
    std::queue<int> q;
    level_[s] = 0; q.push(s);
    while (!q.empty()) {
      int u = q.front(); q.pop();
      for (int e = head_[u]; e != -1; e = next_[e]) {
        if (cap_[e] > 1e-12 && level_[to_[e]] < 0) {
          level_[to_[e]] = level_[u] + 1;
          q.push(to_[e]);
        }
      }
    }
    return level_[t] >= 0;
  }

  Cap Dfs(int u, int t, Cap f) {
    if (u == t) return f;
    for (int& e = iter_[u]; e != -1; e = next_[e]) {
      int v = to_[e];
      if (cap_[e] > 1e-12 && level_[v] == level_[u] + 1) {
        Cap d = Dfs(v, t, std::min(f, cap_[e]));
        if (d > 0) {
          cap_[e] -= d;
          cap_[e ^ 1] += d;
          return d;
        }
      }
    }
    return 0;
  }

  int n_;
  std::vector<int> head_, next_, to_, level_, iter_;
  std::vector<Cap> cap_;
};

// ---------------------------------------------------------------------
// Binary submodular energy accumulated into a flow network.
// Convention: x_p = 0 -> p keeps its label (source side),
//             x_p = 1 -> p switches to alpha (sink side).
// cap_s[p] is paid when x_p = 1, cap_t[p] when x_p = 0.
// ---------------------------------------------------------------------
struct BinaryEnergy {
  explicit BinaryEnergy(int n_vars)
      : n(n_vars), cap_s(n_vars, 0), cap_t(n_vars, 0), constant(0) {}

  void AddUnary(int p, Cap cost0, Cap cost1) {
    cap_t[p] += cost0;
    cap_s[p] += cost1;
  }

  // coefficient c on x_p (cost c iff x_p = 1); negative c reparameterized
  // as cost -c iff x_p = 0 plus a constant
  void AddLinear(int p, Cap c) {
    if (c >= 0) {
      cap_s[p] += c;
    } else {
      cap_t[p] += -c;
      constant += c;
    }
  }

  // E(x_p, x_q) with E(0,0)=A, E(0,1)=B, E(1,0)=C, E(1,1)=D, B+C>=A+D
  void AddPairwise(int p, int q, Cap A, Cap B, Cap C, Cap D) {
    constant += A;
    AddLinear(p, C - A);   // * x_p
    AddLinear(q, D - C);   // * x_q
    pair_p.push_back(p);
    pair_q.push_back(q);
    pair_c.push_back(B + C - A - D);  // on [x_p=0][x_q=1]
  }

  // pay h iff ANY member variable keeps (x=0). Delong et al. aux node:
  // edge p->aux (inf) for members, aux->t (h).
  void AddKeepCost(const std::vector<int>& members, Cap h) {
    keep_sets.push_back(members);
    keep_costs.push_back(h);
  }

  // pay h iff ANY member variable switches (x=1): s->aux (h), aux->p (inf).
  void AddSwitchCost(const std::vector<int>& members, Cap h) {
    switch_sets.push_back(members);
    switch_costs.push_back(h);
  }

  // solve; fills x (0/1), returns the minimized energy value
  Cap Solve(std::vector<uint8_t>* x) {
    int n_aux = static_cast<int>(keep_sets.size() + switch_sets.size());
    int s = n + n_aux, t = s + 1;
    Dinic g(t + 1);
    for (int p = 0; p < n; ++p) {
      // normalize: only the positive part matters, shift to constant
      Cap m = std::min(cap_s[p], cap_t[p]);
      constant += m;
      Cap cs = cap_s[p] - m, ct = cap_t[p] - m;
      if (cs > 0) g.AddEdge(s, p, cs);   // pay when x_p=1 (sink side)
      if (ct > 0) g.AddEdge(p, t, ct);   // pay when x_p=0 (source side)
    }
    for (size_t i = 0; i < pair_p.size(); ++i) {
      if (pair_c[i] > 0) g.AddEdge(pair_p[i], pair_q[i], pair_c[i]);
    }
    int aux = n;
    for (size_t i = 0; i < keep_sets.size(); ++i, ++aux) {
      g.AddEdge(aux, t, keep_costs[i]);
      for (int p : keep_sets[i]) g.AddEdge(p, aux, kInf);
    }
    for (size_t i = 0; i < switch_sets.size(); ++i, ++aux) {
      g.AddEdge(s, aux, switch_costs[i]);
      for (int p : switch_sets[i]) g.AddEdge(aux, p, kInf);
    }
    Cap flow = g.MaxFlow(s, t);
    x->resize(n);
    for (int p = 0; p < n; ++p) {
      // source side -> x=0 (keep); sink side -> x=1 (switch)
      (*x)[p] = g.SourceSide(p) ? 0 : 1;
    }
    return constant + flow;
  }

  int n;
  std::vector<Cap> cap_s, cap_t;
  Cap constant;
  std::vector<int> pair_p, pair_q;
  std::vector<Cap> pair_c;
  std::vector<std::vector<int>> keep_sets, switch_sets;
  std::vector<Cap> keep_costs, switch_costs;
};

struct Edge {
  int p, q;
  double w;
};

double LabelingEnergy(int n, int L, const double* D,
                      const std::vector<Edge>& edges, double lambda,
                      const double* label_costs,
                      const std::vector<int>& labels) {
  double e = 0;
  for (int p = 0; p < n; ++p) e += D[p * L + labels[p]];
  for (const Edge& ed : edges) {
    if (labels[ed.p] != labels[ed.q]) e += 0.5 * lambda * ed.w;
  }
  std::vector<uint8_t> used(L, 0);
  for (int p = 0; p < n; ++p) used[labels[p]] = 1;
  for (int l = 0; l < L; ++l) {
    if (used[l]) e += label_costs[l];
  }
  return e;
}

}  // namespace

extern "C" {

// data_costs: N x L row-major. edges: E x 2 int32 (p, q) + E double weights
// (each *directed* edge counts lambda*w/2 when labels differ, matching the
// JAX energy). label_costs: L. init/out labels: N int32.
// Returns the final energy.
double expansion_solve(int32_t n, int32_t L, const double* data_costs,
                       int32_t n_edges, const int32_t* edge_pq,
                       const double* edge_w, double lambda,
                       const double* label_costs, const int32_t* init_labels,
                       int32_t max_cycles, int32_t* out_labels) {
  // collapse directed duplicates into undirected edges with summed w/2
  std::vector<Edge> edges;
  edges.reserve(n_edges);
  for (int i = 0; i < n_edges; ++i) {
    edges.push_back({edge_pq[2 * i], edge_pq[2 * i + 1], edge_w[i]});
  }

  std::vector<int> labels(init_labels, init_labels + n);
  double best = LabelingEnergy(n, L, data_costs, edges, lambda,
                               label_costs, labels);

  for (int cycle = 0; cycle < max_cycles; ++cycle) {
    bool improved = false;
    for (int alpha = 0; alpha < L; ++alpha) {
      // variables: every p with labels[p] != alpha
      std::vector<int> var_id(n, -1);
      std::vector<int> vars;
      for (int p = 0; p < n; ++p) {
        if (labels[p] != alpha) {
          var_id[p] = static_cast<int>(vars.size());
          vars.push_back(p);
        }
      }
      if (vars.empty()) continue;
      BinaryEnergy be(static_cast<int>(vars.size()));

      // unaries
      for (int v = 0; v < static_cast<int>(vars.size()); ++v) {
        int p = vars[v];
        be.AddUnary(v, data_costs[p * L + labels[p]],
                    data_costs[p * L + alpha]);
      }
      // pairwise Potts: each directed edge at weight lambda*w/2
      for (const Edge& ed : edges) {
        double c = 0.5 * lambda * ed.w;
        int vp = var_id[ed.p], vq = var_id[ed.q];
        if (vp >= 0 && vq >= 0) {
          double A = labels[ed.p] != labels[ed.q] ? c : 0;
          // B = V(l_p, alpha) = c (l_p != alpha by construction)
          // C = V(alpha, l_q) = c, D = 0
          be.AddPairwise(vp, vq, A, c, c, 0);
        } else if (vp >= 0) {  // q fixed at alpha
          be.AddUnary(vp, c, 0);  // pay c iff p keeps (l_p != alpha)
        } else if (vq >= 0) {  // p fixed at alpha
          be.AddUnary(vq, c, 0);
        }
      }
      // label costs (Delong et al.): pay h_l iff any current member keeps
      for (int l = 0; l < L; ++l) {
        if (l == alpha || label_costs[l] <= 0) continue;
        std::vector<int> members;
        for (int v = 0; v < static_cast<int>(vars.size()); ++v) {
          if (labels[vars[v]] == l) members.push_back(v);
        }
        if (!members.empty()) be.AddKeepCost(members, label_costs[l]);
      }
      // cost of alpha itself: if alpha currently unused, pay h_alpha iff
      // anyone switches to it
      bool alpha_used = vars.size() < static_cast<size_t>(n);
      if (!alpha_used && label_costs[alpha] > 0) {
        std::vector<int> all(vars.size());
        for (size_t v = 0; v < vars.size(); ++v) all[v] = static_cast<int>(v);
        be.AddSwitchCost(all, label_costs[alpha]);
      } else if (alpha_used && label_costs[alpha] > 0) {
        be.constant += label_costs[alpha];
      }

      std::vector<uint8_t> x;
      be.Solve(&x);
      std::vector<int> trial = labels;
      for (size_t v = 0; v < vars.size(); ++v) {
        if (x[v]) trial[vars[v]] = alpha;
      }
      double e = LabelingEnergy(n, L, data_costs, edges, lambda,
                                label_costs, trial);
      if (e < best - 1e-9) {
        best = e;
        labels = trial;
        improved = true;
      }
    }
    if (!improved) break;
  }
  std::memcpy(out_labels, labels.data(), n * sizeof(int32_t));
  return best;
}

}  // extern "C"
