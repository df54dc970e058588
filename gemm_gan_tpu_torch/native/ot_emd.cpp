// Exact optimal transport (transportation problem) via primal network simplex.
//
// The port's copy of `gemm_gan_tpu/native/ot_emd.cpp`, unchanged below this
// comment: the exact 1- and 2-Wasserstein of the distribution distances, in
// place of POT's network simplex (`ot.emd2`) in the original GeMM-GAN code.
// Dense bipartite transportation: n sources with supply a[i], m sinks with
// demand b[j], cost matrix M[n*m]; returns the optimal cost <P*, M>.
//
// Implementation: textbook uncapacitated network simplex on the bipartite
// graph plus an artificial root. Spanning tree kept as parent/pred-arc with
// explicit children lists; entering arc chosen by block pricing (most
// negative reduced cost within a rotating block); potentials recomputed on
// the re-hung subtree only.
//
// Cycle orientation convention: the entering arc e = (u -> v) is traversed
// u -> v; the rest of the cycle runs v up to the common ancestor w, then w
// down to u. For a node z with pred arc linking z to parent(z):
//   * on the v-side (traversal z -> parent): arc z->parent (dir -1) gains
//     flow, arc parent->z (dir +1) loses;
//   * on the u-side (traversal parent -> z): arc parent->z (dir +1) gains,
//     arc z->parent (dir -1) loses.
//
// Exposed through a plain C API and loaded with ctypes
// (gemm_gan_tpu_torch/native/ot.py), which builds it with
// g++ -O3 -std=c++17 -shared -fPIC -pthread at first use.

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct Simplex {
    int n, m, N;           // sources, sinks, total nodes incl. root
    int root;
    const double* cost;    // n*m
    double big;
    int n_arcs_real;

    std::vector<double> flow;      // per arc (real then artificial)
    std::vector<double> pi;        // node potentials
    std::vector<int> parent;       // node -> parent node (-1 for root)
    std::vector<int> pred;         // node -> arc id to parent
    std::vector<int> pred_dir;     // +1: arc parent->node; -1: arc node->parent
    std::vector<std::vector<int>> children;
    std::vector<int> depth_;

    double arc_cost(int arc) const {
        return arc < n_arcs_real ? cost[arc] : big;
    }

    void init(const double* a, const double* b) {
        flow.assign(n_arcs_real + N - 1, 0.0);
        pi.assign(N, 0.0);
        parent.assign(N, -1);
        pred.assign(N, -1);
        pred_dir.assign(N, 0);
        children.assign(N, {});
        depth_.assign(N, 0);
        for (int k = 0; k < N - 1; ++k) {
            parent[k] = root;
            pred[k] = n_arcs_real + k;
            children[root].push_back(k);
            depth_[k] = 1;
            if (k < n) {                      // source: artificial arc k -> root
                flow[n_arcs_real + k] = a[k];
                pred_dir[k] = -1;
                pi[k] = big;                   // basic: big - pi[k] + pi[root] = 0
            } else {                           // sink: artificial arc root -> k
                flow[n_arcs_real + k] = b[k - n];
                pred_dir[k] = +1;
                pi[k] = -big;                  // basic: big - pi[root] + pi[k] = 0
            }
        }
        pi[root] = 0.0;
    }

    int find_entering(double eps, int& block_start, int block_size) const {
        int best = -1;
        double best_rc = -eps;
        const int total = n_arcs_real;
        int scanned = 0;
        int idx = block_start;
        while (scanned < total) {
            int end = idx + block_size;
            if (end > total) end = total;
            for (int arc = idx; arc < end; ++arc) {
                if (flow[arc] > 0.0) continue;     // basic (or degenerate zero)
                double rc = cost[arc] - pi[arc / m] + pi[n + (arc % m)];
                if (rc < best_rc) { best_rc = rc; best = arc; }
            }
            scanned += end - idx;
            idx = (end < total) ? end : 0;
            if (best >= 0) break;
        }
        return best;
    }

    // Re-hang the detached subtree so `x`'s new parent is `new_parent` via
    // `arc` (dir: orientation of arc w.r.t. x: +1 parent->x, -1 x->parent).
    // Walks x's old parent chain (which ends at the detachment point whose
    // parent was already cleared to -1), reversing each link.
    void rehang(int x, int new_parent, int arc, int dir) {
        int prev = new_parent, prev_arc = arc, prev_dir = dir, node = x;
        while (node >= 0) {
            int next = parent[node];
            int next_arc = pred[node];
            int next_dir = pred_dir[node];
            if (next >= 0) remove_child(next, node);
            parent[node] = prev;
            pred[node] = prev_arc;
            pred_dir[node] = prev_dir;
            children[prev].push_back(node);
            prev = node;
            prev_arc = next_arc;
            prev_dir = -next_dir;   // arc's role flips when viewed from old parent
            node = next;
        }
    }

    void remove_child(int p, int c) {
        auto& ch = children[p];
        for (size_t i = 0; i < ch.size(); ++i)
            if (ch[i] == c) { ch[i] = ch.back(); ch.pop_back(); return; }
    }

    // Recompute potentials + depths for the subtree rooted at v (parents valid).
    void refresh_subtree(int v) {
        std::vector<int> stack{v};
        while (!stack.empty()) {
            int x = stack.back(); stack.pop_back();
            int p = parent[x];
            double c = arc_cost(pred[x]);
            // basic arc rc = c - pi[tail] + pi[head] = 0
            pi[x] = (pred_dir[x] > 0) ? pi[p] - c   // arc p->x: pi[x] = pi[p] - c
                                      : pi[p] + c;  // arc x->p: pi[x] = pi[p] + c
            depth_[x] = depth_[p] + 1;
            for (int ch : children[x]) stack.push_back(ch);
        }
    }

    double solve(const double* a, const double* b, long max_iter) {
        init(a, b);
        double max_c = 1.0;
        for (int i = 0; i < n_arcs_real; ++i)
            if (std::fabs(cost[i]) > max_c) max_c = std::fabs(cost[i]);
        const double eps = 1e-11 * max_c;
        const int block_size = (int)std::sqrt((double)n_arcs_real) + 1;
        int block_start = 0;

        for (long it = 0; it < max_iter; ++it) {
            int e = find_entering(eps, block_start, block_size);
            if (e < 0) {
                double total = 0.0;
                for (int arc = 0; arc < n_arcs_real; ++arc)
                    if (flow[arc] != 0.0) total += flow[arc] * cost[arc];
                return total;
            }
            block_start = (e + 1) % n_arcs_real;
            const int u = e / m, v = n + (e % m);

            // find leaving arc along the cycle (see orientation note above)
            double t = 1e300;
            int leave_node = -1;
            bool leave_on_u_side = false;
            int xu = u, yv = v;
            int du = depth_[u], dv = depth_[v];
            while (du > dv) {
                if (pred_dir[xu] == -1 && flow[pred[xu]] < t) {
                    t = flow[pred[xu]]; leave_node = xu; leave_on_u_side = true;
                }
                xu = parent[xu]; --du;
            }
            while (dv > du) {
                if (pred_dir[yv] == +1 && flow[pred[yv]] < t) {
                    t = flow[pred[yv]]; leave_node = yv; leave_on_u_side = false;
                }
                yv = parent[yv]; --dv;
            }
            while (xu != yv) {
                if (pred_dir[xu] == -1 && flow[pred[xu]] < t) {
                    t = flow[pred[xu]]; leave_node = xu; leave_on_u_side = true;
                }
                if (pred_dir[yv] == +1 && flow[pred[yv]] < t) {
                    t = flow[pred[yv]]; leave_node = yv; leave_on_u_side = false;
                }
                xu = parent[xu]; yv = parent[yv];
            }
            const int w = xu;  // common ancestor

            if (leave_node < 0) return -2.0;  // unbounded: cannot happen if balanced

            // apply flow change along the cycle
            flow[e] += t;
            for (int z = u; z != w; z = parent[z])
                flow[pred[z]] += (pred_dir[z] == +1) ? t : -t;   // u-side gains on +1
            for (int z = v; z != w; z = parent[z])
                flow[pred[z]] += (pred_dir[z] == -1) ? t : -t;   // v-side gains on -1

            // pivot: detach at leave_node, reconnect via entering arc
            remove_child(parent[leave_node], leave_node);
            parent[leave_node] = -1;
            if (leave_on_u_side) {
                // u is in the detached subtree; hang it under v.
                // arc e = u->v is node->parent from u's view: dir -1.
                rehang(u, v, e, -1);
                refresh_subtree(u);
            } else {
                // v is in the detached subtree; hang it under u (arc u->v: +1).
                rehang(v, u, e, +1);
                refresh_subtree(v);
            }
        }
        return -1.0;  // iteration cap hit
    }
};

}  // namespace

extern "C" double emd2(const double* a, const double* b, const double* M,
                       int n, int m, long max_iter) {
    double sa = 0, sb = 0;
    for (int i = 0; i < n; ++i) sa += a[i];
    for (int j = 0; j < m; ++j) sb += b[j];
    if (sa <= 0 || sb <= 0) return -3.0;
    std::vector<double> aa(a, a + n), bb(b, b + m);
    for (int j = 0; j < m; ++j) bb[j] *= sa / sb;   // rebalance to sum(a)

    Simplex s;
    s.n = n; s.m = m; s.N = n + m + 1; s.root = n + m;
    s.cost = M;
    s.n_arcs_real = n * m;
    double max_c = 1.0;
    for (int i = 0; i < n * m; ++i)
        if (std::fabs(M[i]) > max_c) max_c = std::fabs(M[i]);
    s.big = max_c * (n + m + 1) * 2.0;
    return s.solve(aa.data(), bb.data(), max_iter);
}
