// Whole-block partial-order alignment on the GPU, called from JAX through
// the XLA foreign function interface.
//
// One thread block (CTA) runs the complete multi-sequence POA loop of one
// smoothing block: seed the graph from sequence 0, then for every later
// sequence fill the dual-affine DP against the growing graph, trace back,
// and thread the sequence into the graph.  The semantics are those of
// native/cpoa.cpp (and its numpy oracle, ops/poa_fused.py) bit for bit:
// same scores, same tie-breaks, same node numbering, in local, global and
// adaptive-banded mode.
//
// Layout of the work inside a CTA:
//   * DP fill: one graph node (row) at a time in topological order; the
//     row's columns are spread over the CTA's threads (KC consecutive
//     columns per thread, tiles of NT*KC columns).  The F channels use the
//     closed form of native/cpoa.cpp:fill_row,
//         f(j) = R(j-1) - (j-1)*ext,  R(j) = max(R(j-1), hq(j) - open + j*ext)
//     so the loop-carried recurrence becomes a prefix max: a per-thread
//     scan over its KC columns, a warp-shuffle scan, and a scan of the warp
//     totals through shared memory.  Integer max is exact in any order.
//   * Column j belongs to the same thread in every row, so the row's
//     predecessor maxima (H, E1, E2 over the node's predecessors) stay in
//     that thread's registers; only one boundary value per thread goes
//     through shared memory, and a tile costs two barriers.  A thread's 4
//     columns are one aligned 16-byte vector (rows padded to 4 cells).
//     Per-row records (predecessor rows, base, band window) are built in
//     parallel before the fill, and the next row's is loaded while the
//     current row runs.  The sequence sits in shared memory; DP planes
//     live in device memory scratch that the caller passes in as an extra
//     result, rows laid out with the current sequence's (padded) stride,
//     so depth and length are loop bounds and only the cell count is a
//     cap.
//   * Topological walk, band ranks, traceback and threading are scalar,
//     data-dependent work and run on thread 0 while the CTA waits.
//
// Scores are int32 throughout (NEG = -2^30 floor as in cpoa.cpp).
// Capacity overflow (node count, cell count, edge count) sets meta[1] and
// abandons the block; the host engine redoes such blocks on the native
// engine, so a block is never truncated.
//
// Build: make -C native cuda  (nvcc -gencode arch=compute_90a,code=sm_90a)
#include <cstdint>
#include <string>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int32_t NEG = -(1 << 30);
constexpr int32_t IDN = INT32_MIN;   // identity of the max-scan
constexpr int NT = 512;              // threads per CTA
constexpr int KC = 4;                // consecutive columns per thread (one int4)
constexpr int TILE = NT * KC;
constexpr int NWARP = NT / 32;
constexpr unsigned FULL = 0xffffffffu;
// DP rows are laid out with the stride L+1 rounded up to 4 cells, so a
// thread's KC = 4 columns are one aligned 16-byte vector
__host__ __device__ __forceinline__ int64_t row_stride(int32_t L) {
    return ((int64_t)L + 4) & ~(int64_t)3;
}

// per-row record, filled in parallel before each fill: first and second
// predecessor rows (-1: none), base, the edge of the third predecessor
// (-1: none), band window [blo, bhi]
enum { RI_P0, RI_P1, RI_BASE, RI_ED2, RI_LO, RI_HI, RI_STRIDE = 6 };

// per-block parameter row (int32[NPAR]) and result meta row (int32[NMETA]);
// mirrored by ops/poa_cuda.py
enum { P_M, P_N, P_G, P_E, P_Q, P_C, P_LOCAL, P_WB, P_WF, P_R, P_RING,
       NPAR = 16 };
enum { M_V, M_OVF, M_MAXPRED, M_GUARD, NMETA = 4 };

struct Ctl {                 // CTA-uniform control state (shared memory)
    int32_t V, head, nE, ovf, max_pred, guard;
    int32_t w, adj_l, adj_r;
    int32_t best, ei, ej;
    int32_t red_v[NWARP], red_i[NWARP];
    // double-buffered by tile parity, so one barrier per exchange suffices
    int32_t tot[2][2 * NWARP];      // warp totals of the two scan channels
    int32_t edge[2][NT];            // each thread's last predecessor max
};

__device__ __forceinline__ int32_t warp_incl_max(int32_t x) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        int32_t y = __shfl_up_sync(FULL, x, o);
        if (lane >= o) x = max(x, y);
    }
    return x;
}

// CTA-wide exclusive max-scan of two channels; also returns the totals.
// One barrier: warp totals go to a buffer that alternates between calls
// (`tot` = ctl.tot[parity]); a buffer is rewritten only two calls later,
// after every thread has passed the barrier of the call in between.
__device__ __forceinline__ void block_excl_max2(int32_t a, int32_t b,
                                                int32_t& ea, int32_t& eb,
                                                int32_t& ta, int32_t& tb,
                                                int32_t* tot) {
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    int32_t ia = warp_incl_max(a), ib = warp_incl_max(b);
    int32_t xa = __shfl_up_sync(FULL, ia, 1);
    int32_t xb = __shfl_up_sync(FULL, ib, 1);
    if (lane == 0) { xa = IDN; xb = IDN; }
    if (lane == 31) { tot[wid] = ia; tot[NWARP + wid] = ib; }
    __syncthreads();
    int32_t pa = IDN, pb = IDN;
    ta = IDN; tb = IDN;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) {
        const int32_t va = tot[w], vb = tot[NWARP + w];
        if (w < wid) { pa = max(pa, va); pb = max(pb, vb); }
        ta = max(ta, va);
        tb = max(tb, vb);
    }
    ea = max(xa, pa);
    eb = max(xb, pb);
}

// (value, index) arg-reduction over the CTA: larger value wins, ties go
// to the smaller index (row-major first occurrence).  Result in ctl.
__device__ __forceinline__ void block_argmax(int32_t v, int32_t i, Ctl& ctl,
                                             int32_t& ov, int32_t& oi) {
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        int32_t v2 = __shfl_down_sync(FULL, v, o);
        int32_t i2 = __shfl_down_sync(FULL, i, o);
        if (v2 > v || (v2 == v && i2 < i)) { v = v2; i = i2; }
    }
    if (lane == 0) { ctl.red_v[wid] = v; ctl.red_i[wid] = i; }
    __syncthreads();
    if (threadIdx.x == 0) {
        int32_t bv = ctl.red_v[0], bi = ctl.red_i[0];
        for (int k = 1; k < NWARP; ++k) {
            int32_t v2 = ctl.red_v[k], i2 = ctl.red_i[k];
            if (v2 > bv || (v2 == bv && i2 < bi)) { bv = v2; bi = i2; }
        }
        ctl.red_v[0] = bv;
        ctl.red_i[0] = bi;
    }
    __syncthreads();
    ov = ctl.red_v[0];
    oi = ctl.red_i[0];
    __syncthreads();
}

struct Graph {               // per-block device-memory state
    int32_t *H, *Hq, *E1, *E2;                     // C cells each
    int32_t *base, *ring, *nxt, *pos, *nsucc, *row_of, *order;
    int32_t *mr, *MR, *phead, *ptail, *npred;      // Vcap each
    int32_t *rinfo;                                // RI_STRIDE * Vcap
    int32_t *efrom, *enext;                        // Ecap each
    int32_t *target, *spl;                         // Lcap, 2*Lcap
    int32_t vcap, ecap;
};

// thread-0 helpers (ctl is the CTA's shared control block)
__device__ int32_t new_node(Graph& G, Ctl& ctl, int32_t b) {
    if (ctl.V >= G.vcap) { ctl.ovf = 1; return -1; }
    int32_t v = ctl.V++;
    G.base[v] = b;
    G.ring[v] = v;
    G.nxt[v] = -1;
    G.pos[v] = -1;
    G.nsucc[v] = 0;
    G.npred[v] = 0;
    G.phead[v] = -1;
    G.ptail[v] = -1;
    return v;
}

__device__ void add_edge(Graph& G, Ctl& ctl, int32_t u, int32_t v) {
    for (int32_t ed = G.phead[v]; ed >= 0; ed = G.enext[ed])
        if (G.efrom[ed] == u) return;
    if (ctl.nE >= G.ecap) { ctl.ovf = 1; return; }
    int32_t ed = ctl.nE++;
    G.efrom[ed] = u;
    G.enext[ed] = -1;
    if (G.ptail[v] >= 0) G.enext[G.ptail[v]] = ed;
    else G.phead[v] = ed;
    G.ptail[v] = ed;
    G.npred[v] += 1;
    G.nsucc[u] += 1;
    ctl.max_pred = max(ctl.max_pred, G.npred[v]);
}

__device__ int32_t walk(Graph& G, Ctl& ctl) {
    int32_t n = 0;
    for (int32_t v = ctl.head; v >= 0; v = G.nxt[v]) {
        G.pos[v] = n;
        G.order[n] = v;
        ++n;
        G.row_of[v] = n;          // 1-based DP row
    }
    return n;
}

__device__ void seed(Graph& G, Ctl& ctl, const int8_t* s, int32_t L,
                     int32_t* path) {
    int32_t prev = -1;
    for (int32_t j = 0; j < L; ++j) {
        int32_t v = new_node(G, ctl, s[j]);
        if (v < 0) return;
        if (prev >= 0) {
            add_edge(G, ctl, prev, v);
            G.nxt[prev] = v;
        } else {
            ctl.head = v;
        }
        path[j] = v;
        prev = v;
    }
}

// traceback by value re-derivation (native/cpoa.cpp align_impl)
__device__ void traceback(Graph& G, const Ctl& ctl, const int8_t* seq,
                          int32_t L, const int32_t* par) {
    const int32_t m = par[P_M], n = par[P_N], g = par[P_G], e = par[P_E];
    const int32_t q = par[P_Q], c = par[P_C];
    const bool local = par[P_LOCAL] != 0;
    const int64_t W = row_stride(L);
    const int32_t* H = G.H;
    const int32_t* Hq = G.Hq;
    int64_t i = ctl.ei, j = ctl.ej;
    int chan = 0;
    int32_t val = H[i * W + j];
    while (true) {
        if (chan <= 1) {
            if (local && val == 0) break;
            if (i == 0) {
                if (j == 0) break;
                G.target[j - 1] = -1;
                j -= 1;
                val = H[j];
                chan = 0;
                continue;
            }
            int32_t v = G.order[i - 1];
            bool moved = false;
            if (j > 0) {
                int32_t subv = (seq[j - 1] == G.base[v]) ? m : -n;
                int32_t ed = G.phead[v];
                bool none = ed < 0;
                do {
                    int64_t pr = none ? 0 : G.row_of[G.efrom[ed]];
                    if (H[pr * W + j - 1] + subv == val) {
                        G.target[j - 1] = v;
                        i = pr; j -= 1; chan = 0;
                        val = H[pr * W + j];
                        moved = true;
                        break;
                    }
                    if (!none) ed = G.enext[ed];
                } while (!none && ed >= 0);
            }
            if (moved) continue;
            if (G.E1[i * W + j] == val) { chan = 2; continue; }
            if (G.E2[i * W + j] == val) { chan = 3; continue; }
            if (chan == 0) {
                bool found = false;
                for (int64_t k = j - 1; k >= 0 && !found; --k) {
                    int32_t hk = Hq[i * W + k];
                    int32_t d = (int32_t)(j - 1 - k);
                    if (hk - g - d * e == val || hk - q - d * c == val) {
                        for (int64_t t = j; t > k; --t) G.target[t - 1] = -1;
                        j = k; chan = 1;
                        val = Hq[i * W + j];
                        found = true;
                    }
                }
                if (found) continue;
            }
            break;                  // stuck: cannot happen with a correct fill
        } else {
            const int32_t op = (chan == 2) ? g : q;
            const int32_t ex = (chan == 2) ? e : c;
            const int32_t* Em = (chan == 2) ? G.E1 : G.E2;
            int32_t v = G.order[i - 1];
            int32_t ed0 = G.phead[v];
            bool none = ed0 < 0;
            bool moved = false;
            int32_t ed = ed0;
            do {
                int64_t pr = none ? 0 : G.row_of[G.efrom[ed]];
                if (H[pr * W + j] - op == val) {
                    i = pr; chan = 0; val = H[pr * W + j];
                    moved = true;
                    break;
                }
                if (!none) ed = G.enext[ed];
            } while (!none && ed >= 0);
            if (!moved) {
                ed = ed0;
                do {
                    int64_t pr = none ? 0 : G.row_of[G.efrom[ed]];
                    if (Em[pr * W + j] - ex == val) {
                        i = pr; val = Em[pr * W + j];
                        moved = true;
                        break;
                    }
                    if (!none) ed = G.enext[ed];
                } while (!none && ed >= 0);
            }
            if (!moved) break;      // broken E chain: cannot happen
        }
    }
}

// guarded threading of one aligned sequence (native/cpoa.cpp thread)
__device__ void thread_seq(Graph& G, Ctl& ctl, const int8_t* seq, int32_t L,
                           int32_t ring_cap, int32_t* path) {
    int32_t prev = -1, guard = -1, nspl = 0;
    for (int32_t j = 0; j < L; ++j) {
        int32_t b = seq[j];
        int32_t t = G.target[j];
        int32_t v = -1;
        bool saw = false;
        if (t >= 0) {
            int32_t cand = t;
            for (int32_t r = 0; r < ring_cap; ++r) {
                if (G.base[cand] == b) {
                    saw = true;
                    if (G.pos[cand] > guard) { v = cand; break; }
                }
                cand = G.ring[cand];
                if (cand == t) break;
            }
        }
        if (v < 0) {
            if (saw) ctl.guard += 1;
            v = new_node(G, ctl, b);
            if (v < 0) return;
            if (t >= 0) { G.spl[2 * nspl] = t; G.spl[2 * nspl + 1] = v; ++nspl; }
            if (prev < 0) {
                G.nxt[v] = ctl.head; ctl.head = v; G.pos[v] = -1;
            } else {
                G.nxt[v] = G.nxt[prev]; G.nxt[prev] = v;
                G.pos[v] = G.pos[prev];
            }
        } else {
            guard = G.pos[v];
        }
        if (prev >= 0) {
            add_edge(G, ctl, prev, v);
            if (ctl.ovf) return;
        }
        path[j] = v;
        prev = v;
    }
    for (int32_t k = 0; k < nspl; ++k) {
        int32_t t = G.spl[2 * k], v = G.spl[2 * k + 1];
        G.ring[v] = G.ring[t];
        G.ring[t] = v;
    }
}

__global__ void __launch_bounds__(NT)
poa_kernel(const int8_t* __restrict__ seqs, const int32_t* __restrict__ offs,
           const int32_t* __restrict__ params, int32_t* __restrict__ meta,
           int32_t* __restrict__ exp, int32_t* __restrict__ paths,
           int32_t* __restrict__ scratch, int32_t scap, int32_t rcap,
           int32_t vcap, int32_t lcap, int64_t cells, int64_t words) {
    extern __shared__ int8_t sseq[];        // the current sequence
    __shared__ Ctl ctl;
    const int tid = threadIdx.x;
    const int64_t b = blockIdx.x;
    const int8_t* sq = seqs + b * scap;
    const int32_t* off = offs + b * (rcap + 1);
    const int32_t* par = params + b * NPAR;
    int32_t* path = paths + b * scap;

    Graph G;
    int32_t* sc = scratch + b * words;
    G.H = sc; G.Hq = sc + cells; G.E1 = sc + 2 * cells; G.E2 = sc + 3 * cells;
    int32_t* nodes = sc + 4 * cells;
    G.base = nodes;              G.ring = nodes + vcap;
    G.nxt = nodes + 2 * vcap;    G.pos = nodes + 3 * vcap;
    G.nsucc = nodes + 4 * vcap;  G.row_of = nodes + 5 * vcap;
    G.order = nodes + 6 * vcap;  G.mr = nodes + 7 * vcap;
    G.MR = nodes + 8 * vcap;     G.phead = nodes + 9 * vcap;
    G.ptail = nodes + 10 * vcap; G.npred = nodes + 11 * vcap;
    G.rinfo = nodes + 12 * vcap;
    G.efrom = nodes + (12 + RI_STRIDE) * vcap; G.enext = G.efrom + scap;
    G.target = G.enext + scap;   G.spl = G.target + lcap;
    G.vcap = vcap; G.ecap = scap;

    const int32_t m = par[P_M], n = par[P_N], g = par[P_G], e = par[P_E];
    const int32_t q = par[P_Q], c = par[P_C];
    const bool local = par[P_LOCAL] != 0;
    const int32_t wb = par[P_WB], wf = par[P_WF];
    const int32_t R = par[P_R], ring_cap = par[P_RING];

    if (tid == 0) {
        ctl.V = 0; ctl.head = -1; ctl.nE = 0; ctl.ovf = 0;
        ctl.max_pred = 0; ctl.guard = 0;
    }
    __syncthreads();

    for (int32_t r = 0; r < R; ++r) {
        const int32_t L = off[r + 1] - off[r];
        const int8_t* s = sq + off[r];
        int32_t* pth = path + off[r];
        if (ctl.V == 0) {                       // seed (CTA-uniform test)
            if (tid == 0) {
                if (L > lcap) ctl.ovf = 1;
                else seed(G, ctl, s, L, pth);
            }
            __syncthreads();
            if (ctl.ovf) break;
            continue;
        }
        if (L == 0) continue;
        // ---- topological walk, capacity check, band ranks (thread 0) ----
        if (tid == 0) {
            int32_t V = walk(G, ctl);
            const int64_t W = row_stride(L);
            if (L > lcap || (int64_t)(V + 1) * W > cells) ctl.ovf = 1;
            ctl.w = (wb < 0) ? -1 : wb + (int32_t)(((int64_t)wf * L) / 1000);
            ctl.adj_l = 0; ctl.adj_r = 0;
            if (ctl.w >= 0 && !ctl.ovf) {
                int32_t D = 0;
                for (int32_t k = 0; k < V; ++k) {
                    int32_t v = G.order[k];
                    int32_t lo = 1 << 30, hi = 0;
                    for (int32_t ed = G.phead[v]; ed >= 0; ed = G.enext[ed]) {
                        int32_t u = G.efrom[ed];
                        lo = min(lo, G.mr[u]);
                        hi = max(hi, G.MR[u]);
                    }
                    bool np0 = G.phead[v] < 0;
                    G.mr[v] = np0 ? 1 : lo + 1;
                    G.MR[v] = np0 ? 1 : hi + 1;
                    D = max(D, G.MR[v]);
                }
                ctl.adj_l = max(0, D - L);
                ctl.adj_r = max(0, L - D);
            }
        }
        __syncthreads();
        if (ctl.ovf) break;
        const int32_t V = ctl.V;
        const int64_t W = row_stride(L);
        const int32_t w = ctl.w, adj_l = ctl.adj_l, adj_r = ctl.adj_r;
        const bool banded = w >= 0;

        // ---- row 0, sequence, target init ----
        for (int32_t j = tid; j <= L; j += NT) {
            if (local) {
                G.H[j] = 0; G.Hq[j] = 0;
            } else if (j == 0) {
                G.H[0] = 0; G.Hq[0] = 0;
            } else {
                G.H[j] = max(-(g + (j - 1) * e), -(q + (j - 1) * c));
                G.Hq[j] = NEG;
            }
            G.E1[j] = NEG; G.E2[j] = NEG;
            if (j < L) { sseq[j] = s[j]; G.target[j] = -2; }
        }
        __syncthreads();

        // ---- per-row records, in parallel ----
        for (int32_t i = 1 + tid; i <= V; i += NT) {
            const int32_t v = G.order[i - 1];
            const int32_t ed = G.phead[v];
            int32_t* ri = G.rinfo + (int64_t)(i - 1) * RI_STRIDE;
            const int32_t ed1 = ed < 0 ? -1 : G.enext[ed];
            ri[RI_P0] = ed < 0 ? 0 : G.row_of[G.efrom[ed]];
            ri[RI_P1] = ed1 < 0 ? -1 : G.row_of[G.efrom[ed1]];
            ri[RI_BASE] = G.base[v];
            ri[RI_ED2] = ed1 < 0 ? -1 : G.enext[ed1];
            ri[RI_LO] = banded ? max(0, G.mr[v] - w - adj_l) : 0;
            ri[RI_HI] = banded ? min(L, G.MR[v] + w + adj_r) : L;
        }
        __syncthreads();

        // ---- DP fill, one node per row in topological order ----
        // Column j belongs to thread (j % TILE) / KC in every row, so a
        // thread reads back only cells it wrote itself; the one value it
        // needs from a neighbour (the predecessor max at column j0-1)
        // comes through shared memory.  Two barriers per tile; the next
        // row's record is loaded while the current row runs.
        int32_t tbest = NEG, trow = 0;      // per-thread local-mode best
        int tpar = 0;                       // tile parity (CTA-uniform)
        int32_t nx[RI_HI + 1];
#pragma unroll
        for (int f = 0; f <= RI_HI; ++f) nx[f] = G.rinfo[f];
        for (int32_t i = 1; i <= V; ++i) {
            const int64_t r0 = (int64_t)nx[RI_P0] * W;
            const int32_t p1r = nx[RI_P1], bv = nx[RI_BASE];
            const int32_t ed2 = nx[RI_ED2];
            const int32_t blo = nx[RI_LO], bhi = nx[RI_HI];
            if (i < V) {
                const int32_t* rn = G.rinfo + (int64_t)i * RI_STRIDE;
#pragma unroll
                for (int f = 0; f <= RI_HI; ++f) nx[f] = rn[f];
            }
            const int32_t clo = max(0, blo - 1);
            const int64_t ri = (int64_t)i * W;
            int32_t c1 = NEG + (blo - 1) * e;   // R(blo-1), both channels
            int32_t c2 = NEG + (blo - 1) * c;
            int32_t rmax = NEG;
            for (int32_t tb = 0; tb <= L; tb += TILE) {
                const int32_t te = min(tb + TILE - 1, L);
                const int32_t j0 = tb + tid * KC;
                const bool live = j0 <= L;      // this thread's vector
                int4* Hv = reinterpret_cast<int4*>(G.H + ri + j0);
                int4* Hqv = reinterpret_cast<int4*>(G.Hq + ri + j0);
                int4* E1v = reinterpret_cast<int4*>(G.E1 + ri + j0);
                int4* E2v = reinterpret_cast<int4*>(G.E2 + ri + j0);
                if (te < clo || tb > bhi) {     // tile outside the band
                    if (live) {
                        const int4 nv = make_int4(NEG, NEG, NEG, NEG);
                        *Hv = nv; *Hqv = nv; *E1v = nv; *E2v = nv;
                    }
                    continue;
                }
                // predecessor maxima over this thread's columns
                int32_t hp[KC], x1p[KC], x2p[KC];
                if (live) {
                    int4 a = *reinterpret_cast<const int4*>(G.H + r0 + j0);
                    int4 b1 = *reinterpret_cast<const int4*>(G.E1 + r0 + j0);
                    int4 b2 = *reinterpret_cast<const int4*>(G.E2 + r0 + j0);
                    // the second predecessor's row is in the record; only
                    // rows with three or more walk the edge list
                    for (int32_t ed = ed2, pr = p1r; pr >= 0;
                         pr = ed < 0 ? -1 : G.row_of[G.efrom[ed]],
                         ed = ed < 0 ? -1 : G.enext[ed]) {
                        const int64_t rr = (int64_t)pr * W + j0;
                        const int4 a2 = *reinterpret_cast<const int4*>(G.H + rr);
                        const int4 c2v = *reinterpret_cast<const int4*>(G.E1 + rr);
                        const int4 d2 = *reinterpret_cast<const int4*>(G.E2 + rr);
                        a.x = max(a.x, a2.x); a.y = max(a.y, a2.y);
                        a.z = max(a.z, a2.z); a.w = max(a.w, a2.w);
                        b1.x = max(b1.x, c2v.x); b1.y = max(b1.y, c2v.y);
                        b1.z = max(b1.z, c2v.z); b1.w = max(b1.w, c2v.w);
                        b2.x = max(b2.x, d2.x); b2.y = max(b2.y, d2.y);
                        b2.z = max(b2.z, d2.z); b2.w = max(b2.w, d2.w);
                    }
                    hp[0] = a.x; hp[1] = a.y; hp[2] = a.z; hp[3] = a.w;
                    x1p[0] = b1.x; x1p[1] = b1.y; x1p[2] = b1.z; x1p[3] = b1.w;
                    x2p[0] = b2.x; x2p[1] = b2.y; x2p[2] = b2.z; x2p[3] = b2.w;
                }
#pragma unroll
                for (int k = 0; k < KC; ++k) {
                    const int32_t j = j0 + k;
                    if (!live || j < clo || j > bhi) {
                        hp[k] = NEG; x1p[k] = NEG; x2p[k] = NEG;
                    }
                }
                ctl.edge[tpar][tid] = hp[KC - 1];
                __syncthreads();
                const int32_t left = tid > 0 ? ctl.edge[tpar][tid - 1]
                                             : ctl.edge[tpar ^ 1][NT - 1];
                int32_t hq[KC], o1[KC], o2[KC];
                int32_t p1 = IDN, p2 = IDN;
#pragma unroll
                for (int k = 0; k < KC; ++k) {
                    const int32_t j = j0 + k;
                    hq[k] = IDN; o1[k] = NEG; o2[k] = NEG;
                    if (j > L || j < blo || j > bhi) continue;
                    const int32_t hl = k > 0 ? hp[k - 1] : left;
                    int32_t M = (j == 0) ? NEG
                        : hl + (sseq[j - 1] == bv ? m : -n);
                    int32_t z1 = max(max(hp[k] - g, x1p[k] - e), NEG);
                    int32_t z2 = max(max(hp[k] - q, x2p[k] - c), NEG);
                    int32_t h = max(M, max(z1, z2));
                    if (local && h < 0) h = 0;
                    hq[k] = h; o1[k] = z1; o2[k] = z2;
                    p1 = max(p1, h - g + j * e);
                    p2 = max(p2, h - q + j * c);
                }
                if (live) {
                    // out-of-band columns (and the row's padding) get NEG
                    *Hqv = make_int4(hq[0] == IDN ? NEG : hq[0],
                                     hq[1] == IDN ? NEG : hq[1],
                                     hq[2] == IDN ? NEG : hq[2],
                                     hq[3] == IDN ? NEG : hq[3]);
                    *E1v = make_int4(o1[0], o1[1], o1[2], o1[3]);
                    *E2v = make_int4(o2[0], o2[1], o2[2], o2[3]);
                }
                int32_t ex1, ex2, t1, t2;
                block_excl_max2(p1, p2, ex1, ex2, t1, t2, ctl.tot[tpar]);
                // R(j-1) = max(carry, earlier threads, earlier own columns)
                int32_t run1 = max(c1, ex1), run2 = max(c2, ex2);
                int32_t hv[KC];
#pragma unroll
                for (int k = 0; k < KC; ++k) {
                    const int32_t j = j0 + k;
                    hv[k] = NEG;
                    if (hq[k] == IDN) continue;
                    int32_t h = max(hq[k], max(run1 - (j - 1) * e,
                                               run2 - (j - 1) * c));
                    hv[k] = h;
                    rmax = max(rmax, h);
                    run1 = max(run1, hq[k] - g + j * e);
                    run2 = max(run2, hq[k] - q + j * c);
                }
                if (live) *Hv = make_int4(hv[0], hv[1], hv[2], hv[3]);
                c1 = max(c1, t1);
                c2 = max(c2, t2);
                tpar ^= 1;
            }
            if (local && rmax > tbest) { tbest = rmax; trow = i; }
        }
        __syncthreads();

        // ---- end cell ----
        int32_t best, ei, ej;
        if (local) {
            block_argmax(tbest, trow, ctl, best, ei);
            if (best <= 0) {
                ej = -1;
            } else {
                int32_t first = INT32_MAX;
                for (int32_t j = tid; j <= L; j += NT)
                    if (G.H[(int64_t)ei * W + j] == best) { first = j; break; }
                int32_t dummy;
                block_argmax(-first, 0, ctl, ej, dummy);
                ej = -ej;
            }
        } else {
            int32_t bvv = NEG - 1, bii = 0;
            for (int32_t i = 1 + tid; i <= V; i += NT) {
                if (G.nsucc[G.order[i - 1]] != 0) continue;
                int32_t x = G.H[(int64_t)i * W + L];
                if (x > bvv) { bvv = x; bii = i; }
            }
            block_argmax(bvv, bii, ctl, best, ei);
            ej = L;
        }
        // ---- traceback + threading (thread 0) ----
        if (tid == 0) {
            if (!(local && best <= 0)) {
                ctl.ei = ei; ctl.ej = ej;
                traceback(G, ctl, sseq, L, par);
            }
            thread_seq(G, ctl, sseq, L, ring_cap, pth);
        }
        __syncthreads();
        if (ctl.ovf) break;
    }
    if (tid == 0) {
        int32_t V = ctl.ovf ? 0 : walk(G, ctl);
        int32_t* mt = meta + b * NMETA;
        mt[M_V] = ctl.ovf ? ctl.V : V;
        mt[M_OVF] = ctl.ovf;
        mt[M_MAXPRED] = ctl.max_pred;
        mt[M_GUARD] = ctl.guard;
    }
    __syncthreads();
    if (ctl.ovf) return;
    const int32_t V = ctl.V;
    int32_t* xb = exp + b * 3 * (int64_t)vcap;
    for (int32_t k = tid; k < V; k += NT) {
        xb[k] = G.base[k];
        xb[vcap + k] = G.ring[k];
        xb[2 * vcap + k] = G.order[k];
    }
}

int64_t block_words(int64_t cells, int64_t vcap, int64_t lcap, int64_t scap) {
    // rounded to 4 words so every block's planes stay 16-byte aligned
    return (4 * cells + (12 + RI_STRIDE) * vcap + 2 * scap + 3 * lcap + 3)
        & ~(int64_t)3;
}

}  // namespace

static ffi::Error PoaImpl(cudaStream_t stream, ffi::Buffer<ffi::S8> seqs,
                          ffi::Buffer<ffi::S32> offs,
                          ffi::Buffer<ffi::S32> params,
                          ffi::ResultBuffer<ffi::S32> meta,
                          ffi::ResultBuffer<ffi::S32> exp,
                          ffi::ResultBuffer<ffi::S32> paths,
                          ffi::ResultBuffer<ffi::S32> scratch, int64_t lcap) {
    auto sd = seqs.dimensions();
    auto od = offs.dimensions();
    auto xd = exp->dimensions();
    auto kd = scratch->dimensions();
    if (sd.size() != 2 || od.size() != 2 || xd.size() != 3 || kd.size() != 2)
        return ffi::Error::InvalidArgument("smoothxg_poa: bad ranks");
    const int64_t B = sd[0], scap = sd[1], rcap = od[1] - 1, vcap = xd[2];
    const int64_t cells = (vcap + 1) * row_stride(lcap);
    const int64_t words = block_words(cells, vcap, lcap, scap);
    if (od[0] != B || xd[0] != B || kd[0] != B || kd[1] != words)
        return ffi::Error::InvalidArgument(
            "smoothxg_poa: scratch is " + std::to_string(kd[1]) +
            " words per block, expected " + std::to_string(words));
    if (B == 0) return ffi::Error::Success();
    const size_t smem = ((lcap + 1 + 15) / 16) * 16;
    cudaError_t err = cudaFuncSetAttribute(
        poa_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess)
        return ffi::Error::Internal(std::string("smoothxg_poa: smem ") +
                                    cudaGetErrorString(err));
    poa_kernel<<<(unsigned)B, NT, smem, stream>>>(
        seqs.typed_data(), offs.typed_data(), params.typed_data(),
        meta->typed_data(), exp->typed_data(), paths->typed_data(),
        scratch->typed_data(), (int32_t)scap, (int32_t)rcap, (int32_t)vcap,
        (int32_t)lcap, cells, words);
    err = cudaGetLastError();
    if (err != cudaSuccess)
        return ffi::Error::Internal(std::string("smoothxg_poa: launch ") +
                                    cudaGetErrorString(err));
    return ffi::Error::Success();
}

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    SmoothxgPoa, PoaImpl,
    ffi::Ffi::Bind()
        .Ctx<ffi::PlatformStream<cudaStream_t>>()
        .Arg<ffi::Buffer<ffi::S8>>()
        .Arg<ffi::Buffer<ffi::S32>>()
        .Arg<ffi::Buffer<ffi::S32>>()
        .Ret<ffi::Buffer<ffi::S32>>()
        .Ret<ffi::Buffer<ffi::S32>>()
        .Ret<ffi::Buffer<ffi::S32>>()
        .Ret<ffi::Buffer<ffi::S32>>()
        .Attr<int64_t>("lcap"));
