// cpoa: native single-thread fused POA engine for smoothxg_jax.
//
// Implements EXACTLY the fused POA semantics specified by
// smoothxg_jax/ops/poa_fused.py (the numpy oracle): sequence-vs-DAG DP with
// convex (dual-affine) gaps — score-identical to the spoa engine the
// reference drives per block (reference: src/smooth.cpp:736-753, params
// m,n,g,e,q,c from src/main.cpp:322-327) — followed by value-rederivation
// traceback and guarded linked-list threading of each sequence into the
// graph.  Bit-for-bit parity with the oracle is tested
// (tests/test_poa_native.py), which makes this library three things at
// once:
//   1. the honest single-thread CPU baseline for bench.py's vs_baseline
//      (BASELINE.md demands a real CPU POA engine, not the numpy DP),
//   2. the fast host fallback for blocks the CUDA kernel cannot take,
//   3. the reference the CUDA kernel (native/cuda/poa.cu) is checked
//      against bit for bit.
//
// Build: make -C native  (g++ -O3 -march=native -shared -fPIC)
#include <cstdint>
#include <cstring>
#include <memory>
#include <type_traits>
#include <vector>
#include <algorithm>
#ifdef __AVX512F__
#include <immintrin.h>
#endif

using std::vector;

#ifdef CPOA_PROF
// Profiling builds only; accumulators are not thread-safe — profile with
// a single-threaded engine.
#include <chrono>
static double prof_acc[8];   // assign, pred, fill, end, tb, thread, walk
struct ProfT {
    int k; std::chrono::steady_clock::time_point t0;
    explicit ProfT(int k_) : k(k_), t0(std::chrono::steady_clock::now()) {}
    ~ProfT() { prof_acc[k] += std::chrono::duration<double>(
        std::chrono::steady_clock::now() - t0).count(); }
};
#define PROF_CAT2(a, b) a##b
#define PROF_CAT(a, b) PROF_CAT2(a, b)
#define PROF(k) ProfT PROF_CAT(prof_scope_, __LINE__)(k)
#else
#define PROF(k)
#endif

namespace {

constexpr int32_t NEG = -(1 << 30);

struct Params {
    int32_t m, n, g, e, q, c;
    bool local;
    // adaptive band (abPOA parity; ops/poa_host.POAParams.wb/wf_milli):
    // row v filled only for columns [min_rank(v)-w, max_rank(v)+w] with a
    // diagonal shift for length skew, w = wb + wf_milli*L/1000; wb < 0 off
    int32_t wb = -1;
    int32_t wf_milli = 30;
};

// One DP row over columns [blo, bhi].  The F channels use the exact
// max-plus closed form
//     f(j) = R(j-1) - (j-1)*ext,   R(j) = max(R(j-1), hq(j) - open + j*ext),
//     R(blo-1) = NEG + (blo-1)*ext
// which is integer-identical to the iterated recurrence
// f' = max(f - ext, hq - open) (both are the max over the same candidate
// set; the CUDA kernel uses the same closed form on device,
// native/cuda/poa.cu).  Breaking the loop-carried dependency this way
// lets the whole row run as 16-lane AVX-512 with a log-step prefix max;
// the scalar path computes the identical closed form.
static int32_t fill_row(const int32_t* hpmax, const int32_t* e1p,
                        const int32_t* e2p, const int8_t* seq, int32_t bv,
                        const Params& p, int64_t blo, int64_t bhi,
                        int32_t* Hrow, int32_t* Hqrow, int32_t* E1row,
                        int32_t* E2row) {
    int32_t r1 = NEG + (int32_t)(blo - 1) * p.e;
    int32_t r2 = NEG + (int32_t)(blo - 1) * p.c;
    int32_t rm = NEG;   // row max of H (drives the local end-cell pick)
    int64_t j = blo;
    auto scalar_step = [&](int64_t jj) {
        int32_t M = (jj == 0) ? NEG
            : hpmax[jj - 1] + (seq[jj - 1] == bv ? p.m : -p.n);
        int32_t e1 = std::max(hpmax[jj] - p.g, e1p[jj] - p.e);
        int32_t e2 = std::max(hpmax[jj] - p.q, e2p[jj] - p.c);
        if (e1 < NEG) e1 = NEG;
        if (e2 < NEG) e2 = NEG;
        int32_t hq = std::max(M, std::max(e1, e2));
        if (p.local && hq < 0) hq = 0;
        int32_t f1 = r1 - (int32_t)(jj - 1) * p.e;
        int32_t f2 = r2 - (int32_t)(jj - 1) * p.c;
        Hrow[jj] = std::max(hq, std::max(f1, f2));
        rm = std::max(rm, Hrow[jj]);
        Hqrow[jj] = hq;
        E1row[jj] = e1;
        E2row[jj] = e2;
        r1 = std::max(r1, hq - p.g + (int32_t)jj * p.e);
        r2 = std::max(r2, hq - p.q + (int32_t)jj * p.c);
    };
    if (j == 0) { scalar_step(0); ++j; }   // column 0 has no M term
#ifdef __AVX512F__
    // identity for the shifted-in prefix-max lanes must underbid every
    // real A value (A >= NEG - n - g can dip below NEG); INT32_MIN is
    // only ever max-compared, never added
    const __m512i vID = _mm512_set1_epi32(INT32_MIN);
    const __m512i vNEG = _mm512_set1_epi32(NEG);
    const __m512i vbv = _mm512_set1_epi32(bv);
    const __m512i vsm = _mm512_set1_epi32(p.m);
    const __m512i vsn = _mm512_set1_epi32(-p.n);
    const __m512i vg = _mm512_set1_epi32(p.g);
    const __m512i ve = _mm512_set1_epi32(p.e);
    const __m512i vq = _mm512_set1_epi32(p.q);
    const __m512i vc = _mm512_set1_epi32(p.c);
    const __m512i vone = _mm512_set1_epi32(1);
    const __m512i lane = _mm512_setr_epi32(0, 1, 2, 3, 4, 5, 6, 7, 8, 9,
                                           10, 11, 12, 13, 14, 15);
    const __m512i vzero = _mm512_setzero_si512();
    __m512i vrm = _mm512_set1_epi32(NEG);
    const bool loc = p.local;
    for (; j + 16 <= bhi + 1; j += 16) {
        __m512i hp1 = _mm512_loadu_si512((const void*)(hpmax + j - 1));
        __m512i hp = _mm512_loadu_si512((const void*)(hpmax + j));
        __m512i ep1 = _mm512_loadu_si512((const void*)(e1p + j));
        __m512i ep2 = _mm512_loadu_si512((const void*)(e2p + j));
        __m128i sb = _mm_loadu_si128((const __m128i*)(seq + j - 1));
        __m512i sc = _mm512_cvtepi8_epi32(sb);
        __mmask16 eq = _mm512_cmpeq_epi32_mask(sc, vbv);
        __m512i M = _mm512_add_epi32(hp1, _mm512_mask_blend_epi32(eq, vsn, vsm));
        __m512i e1 = _mm512_max_epi32(_mm512_sub_epi32(hp, vg),
                                      _mm512_sub_epi32(ep1, ve));
        e1 = _mm512_max_epi32(e1, vNEG);
        __m512i e2 = _mm512_max_epi32(_mm512_sub_epi32(hp, vq),
                                      _mm512_sub_epi32(ep2, vc));
        e2 = _mm512_max_epi32(e2, vNEG);
        __m512i hq = _mm512_max_epi32(M, _mm512_max_epi32(e1, e2));
        if (loc) hq = _mm512_max_epi32(hq, vzero);
        _mm512_storeu_si512((void*)(Hqrow + j), hq);
        _mm512_storeu_si512((void*)(E1row + j), e1);
        _mm512_storeu_si512((void*)(E2row + j), e2);
        __m512i jv = _mm512_add_epi32(_mm512_set1_epi32((int32_t)j), lane);
        __m512i a1 = _mm512_add_epi32(_mm512_sub_epi32(hq, vg),
                                      _mm512_mullo_epi32(jv, ve));
        __m512i a2 = _mm512_add_epi32(_mm512_sub_epi32(hq, vq),
                                      _mm512_mullo_epi32(jv, vc));
        // inclusive 16-lane prefix max: shift-up by 1/2/4/8 and max
        __m512i p1 = a1, p2 = a2;
        p1 = _mm512_max_epi32(p1, _mm512_alignr_epi32(p1, vID, 15));
        p2 = _mm512_max_epi32(p2, _mm512_alignr_epi32(p2, vID, 15));
        p1 = _mm512_max_epi32(p1, _mm512_alignr_epi32(p1, vID, 14));
        p2 = _mm512_max_epi32(p2, _mm512_alignr_epi32(p2, vID, 14));
        p1 = _mm512_max_epi32(p1, _mm512_alignr_epi32(p1, vID, 12));
        p2 = _mm512_max_epi32(p2, _mm512_alignr_epi32(p2, vID, 12));
        p1 = _mm512_max_epi32(p1, _mm512_alignr_epi32(p1, vID, 8));
        p2 = _mm512_max_epi32(p2, _mm512_alignr_epi32(p2, vID, 8));
        __m512i cr1 = _mm512_set1_epi32(r1);
        __m512i cr2 = _mm512_set1_epi32(r2);
        p1 = _mm512_max_epi32(p1, cr1);
        p2 = _mm512_max_epi32(p2, cr2);
        // exclusive view x[i] = p[i-1] with the carry entering lane 0
        __m512i x1 = _mm512_alignr_epi32(p1, cr1, 15);
        __m512i x2 = _mm512_alignr_epi32(p2, cr2, 15);
        __m512i jm1 = _mm512_sub_epi32(jv, vone);
        __m512i f1 = _mm512_sub_epi32(x1, _mm512_mullo_epi32(jm1, ve));
        __m512i f2 = _mm512_sub_epi32(x2, _mm512_mullo_epi32(jm1, vc));
        __m512i h = _mm512_max_epi32(hq, _mm512_max_epi32(f1, f2));
        vrm = _mm512_max_epi32(vrm, h);
        _mm512_storeu_si512((void*)(Hrow + j), h);
        __m128i t1 = _mm512_extracti32x4_epi32(p1, 3);
        __m128i t2 = _mm512_extracti32x4_epi32(p2, 3);
        r1 = _mm_extract_epi32(t1, 3);
        r2 = _mm_extract_epi32(t2, 3);
    }
    rm = std::max(rm, _mm512_reduce_max_epi32(vrm));
#endif
    for (; j <= bhi; ++j) scalar_step(j);
    return rm;
}

// DP scratch, reused across blocks (thread_local: NativePOAEngine may run
// several FusedPOA concurrently from a thread pool).  The planes are raw
// uninitialized buffers: in unbanded mode every cell is written before it
// is read, so clearing (or vector<>'s value-init on resize) would be pure
// memset bandwidth — measured at ~35% of the whole engine — and a fresh
// allocation per block would pay the same cost again in first-touch page
// faults inside the fill.
template <typename T>
struct PlaneT {
    std::unique_ptr<T[]> buf;
    size_t cap = 0;
    T* ensure(size_t need) {
        if (cap < need) {
            size_t c = std::max(need, cap * 2);
            buf.reset(new T[c]);   // POD: stays uninitialized
            cap = c;
        } else if (cap > (8u << 20) && cap > 8 * need) {
            // high-water shrink: one outlier block must not pin 4 planes
            // of its size per pool thread for the process lifetime
            buf.reset(new T[need]);
            cap = need;
        }
        return buf.get();
    }
    T* fill_neg(size_t need, T negval) {
        T* p = ensure(need);
        std::fill_n(p, need, negval);
        return p;
    }
};
struct Scratch {
    PlaneT<int32_t> H, Hq, E1, E2;   // (V+1) x (L+1), row-major
    PlaneT<int32_t> hpmax, e1p, e2p; // per-row predecessor reductions
    PlaneT<int16_t> H16, Hq16, E116, E216;   // int16 local-mode planes
    PlaneT<int16_t> hp16, e1p16, e2p16;
};
static thread_local Scratch g_scratch;

// int16 local-mode floor for the E channels: any clamped value is below
// every score that can win a max in local mode (hq >= 0, M >= -n), so
// clamping is alignment-invisible (hq >= 0 bounds every winning score)
constexpr int32_t NEGS16 = -16000;


#if defined(__AVX512F__) && defined(__AVX512BW__)
static inline int32_t hmax_epi16(__m512i v) {
    __m256i a = _mm256_max_epi16(_mm512_castsi512_si256(v),
                                 _mm512_extracti64x4_epi64(v, 1));
    __m128i b = _mm_max_epi16(_mm256_castsi256_si128(a),
                              _mm256_extracti128_si256(a, 1));
    b = _mm_max_epi16(b, _mm_srli_si128(b, 8));
    b = _mm_max_epi16(b, _mm_srli_si128(b, 4));
    b = _mm_max_epi16(b, _mm_srli_si128(b, 2));
    return (int16_t)_mm_extract_epi16(b, 0);
}
#endif

// int16 local-mode row fill: 32 epi16 lanes (AVX-512BW).  The F scan is
// the decayed log-step prefix max S[j] = max(S[j-1] - ext, hq[j] - open)
// with saturation at INT16_MIN standing in for -inf; saturation commutes
// with max (monotone) and saturated values are < 0 <= hq, so they can
// never win h = max(hq, f1, f2) nor appear in a traceback re-derivation —
// alignment-identical to the int32 closed form.  Caller guarantees
// m*(L+1), g, q < ~14k and e, c < ~900 (see use16 in align()).
static int32_t fill_row16(const int16_t* hpmax, const int16_t* e1p,
                          const int16_t* e2p, const int8_t* seq, int32_t bv,
                          const Params& p, int64_t blo, int64_t bhi,
                          int16_t* Hrow, int16_t* Hqrow, int16_t* E1row,
                          int16_t* E2row) {
    int32_t r1 = INT16_MIN, r2 = INT16_MIN;   // S at the previous column
    int32_t rm = INT16_MIN;
    int64_t j = blo;
    auto sat = [](int32_t x) {
        return x < INT16_MIN ? (int32_t)INT16_MIN : x;
    };
    auto scalar_step = [&](int64_t jj) {
        int32_t M = (jj == 0) ? (int32_t)INT16_MIN
            : (int32_t)hpmax[jj - 1] + (seq[jj - 1] == bv ? p.m : -p.n);
        int32_t e1 = std::max((int32_t)hpmax[jj] - p.g,
                              (int32_t)e1p[jj] - p.e);
        int32_t e2 = std::max((int32_t)hpmax[jj] - p.q,
                              (int32_t)e2p[jj] - p.c);
        if (e1 < NEGS16) e1 = NEGS16;
        if (e2 < NEGS16) e2 = NEGS16;
        int32_t hq = std::max(M, std::max(e1, e2));
        if (hq < 0) hq = 0;                    // local mode only
        int32_t h = std::max(hq, std::max(r1, r2));   // f(j) = S(j-1)
        Hrow[jj] = (int16_t)h;
        Hqrow[jj] = (int16_t)hq;
        E1row[jj] = (int16_t)e1;
        E2row[jj] = (int16_t)e2;
        rm = std::max(rm, h);
        r1 = sat(std::max(r1 - p.e, hq - p.g));
        r2 = sat(std::max(r2 - p.c, hq - p.q));
    };
    if (j == 0) { scalar_step(0); ++j; }   // column 0 has no M term
#if defined(__AVX512F__) && defined(__AVX512BW__)
    const __m512i vFLOOR = _mm512_set1_epi16(INT16_MIN);
    const __m512i vNEGS = _mm512_set1_epi16((int16_t)NEGS16);
    const __m512i vbv = _mm512_set1_epi16((int16_t)bv);
    const __m512i vsm = _mm512_set1_epi16((int16_t)p.m);
    const __m512i vsn = _mm512_set1_epi16((int16_t)-p.n);
    const __m512i vg = _mm512_set1_epi16((int16_t)p.g);
    const __m512i ve = _mm512_set1_epi16((int16_t)p.e);
    const __m512i vq = _mm512_set1_epi16((int16_t)p.q);
    const __m512i vc = _mm512_set1_epi16((int16_t)p.c);
    const __m512i vzero = _mm512_setzero_si512();
    __m512i vrm = vFLOOR;
    // carry decay (i+1)*ext per lane, and shift-up tables for s=1,2,4,8,16
    alignas(64) int16_t ibuf[32];
    for (int i = 0; i < 32; ++i) ibuf[i] = (int16_t)(i + 1);
    const __m512i iota1 = _mm512_load_si512((const void*)ibuf);
    const __m512i dec1 = _mm512_mullo_epi16(iota1, ve);
    const __m512i dec2 = _mm512_mullo_epi16(iota1, vc);
    __m512i shidx[5], dst1[5], dst2[5];
    __mmask32 shmask[5];
    for (int t = 0, s = 1; t < 5; ++t, s <<= 1) {
        for (int i = 0; i < 32; ++i) ibuf[i] = (int16_t)((i - s) & 31);
        shidx[t] = _mm512_load_si512((const void*)ibuf);
        shmask[t] = (__mmask32)(~0u << s);
        dst1[t] = _mm512_set1_epi16((int16_t)(s * p.e));
        dst2[t] = _mm512_set1_epi16((int16_t)(s * p.c));
    }
    for (; j + 32 <= bhi + 1; j += 32) {
        __m512i hp1 = _mm512_loadu_si512((const void*)(hpmax + j - 1));
        __m512i hp = _mm512_loadu_si512((const void*)(hpmax + j));
        __m512i ep1 = _mm512_loadu_si512((const void*)(e1p + j));
        __m512i ep2 = _mm512_loadu_si512((const void*)(e2p + j));
        __m256i sb = _mm256_loadu_si256((const __m256i*)(seq + j - 1));
        __m512i sc = _mm512_cvtepi8_epi16(sb);
        __mmask32 eq = _mm512_cmpeq_epi16_mask(sc, vbv);
        __m512i M = _mm512_adds_epi16(hp1,
                                      _mm512_mask_blend_epi16(eq, vsn, vsm));
        __m512i e1v = _mm512_max_epi16(_mm512_subs_epi16(hp, vg),
                                       _mm512_subs_epi16(ep1, ve));
        e1v = _mm512_max_epi16(e1v, vNEGS);
        __m512i e2v = _mm512_max_epi16(_mm512_subs_epi16(hp, vq),
                                       _mm512_subs_epi16(ep2, vc));
        e2v = _mm512_max_epi16(e2v, vNEGS);
        __m512i hq = _mm512_max_epi16(M, _mm512_max_epi16(e1v, e2v));
        hq = _mm512_max_epi16(hq, vzero);
        _mm512_storeu_si512((void*)(Hqrow + j), hq);
        _mm512_storeu_si512((void*)(E1row + j), e1v);
        _mm512_storeu_si512((void*)(E2row + j), e2v);
        __m512i s1 = _mm512_subs_epi16(hq, vg);
        __m512i s2 = _mm512_subs_epi16(hq, vq);
        for (int t = 0; t < 5; ++t) {
            __m512i sh1 = _mm512_mask_blend_epi16(
                shmask[t], vFLOOR, _mm512_permutexvar_epi16(shidx[t], s1));
            s1 = _mm512_max_epi16(s1, _mm512_subs_epi16(sh1, dst1[t]));
            __m512i sh2 = _mm512_mask_blend_epi16(
                shmask[t], vFLOOR, _mm512_permutexvar_epi16(shidx[t], s2));
            s2 = _mm512_max_epi16(s2, _mm512_subs_epi16(sh2, dst2[t]));
        }
        __m512i cr1 = _mm512_set1_epi16((int16_t)r1);
        __m512i cr2 = _mm512_set1_epi16((int16_t)r2);
        s1 = _mm512_max_epi16(s1, _mm512_subs_epi16(cr1, dec1));
        s2 = _mm512_max_epi16(s2, _mm512_subs_epi16(cr2, dec2));
        __m512i f1 = _mm512_mask_blend_epi16(
            shmask[0], cr1, _mm512_permutexvar_epi16(shidx[0], s1));
        __m512i f2 = _mm512_mask_blend_epi16(
            shmask[0], cr2, _mm512_permutexvar_epi16(shidx[0], s2));
        __m512i h = _mm512_max_epi16(hq, _mm512_max_epi16(f1, f2));
        vrm = _mm512_max_epi16(vrm, h);
        _mm512_storeu_si512((void*)(Hrow + j), h);
        __m128i t1 = _mm512_extracti32x4_epi32(s1, 3);
        __m128i t2 = _mm512_extracti32x4_epi32(s2, 3);
        r1 = (int16_t)_mm_extract_epi16(t1, 7);
        r2 = (int16_t)_mm_extract_epi16(t2, 7);
    }
    rm = std::max(rm, hmax_epi16(vrm));
#endif
    for (; j <= bhi; ++j) scalar_step(j);
    return rm;
}

struct FusedPOA {
    int ring_cap;
    vector<int32_t> base;
    vector<vector<int32_t>> preds;   // slot order
    vector<int32_t> nsucc;
    vector<int32_t> ring;            // circular aligned ring
    vector<int32_t> nxt;             // topo linked list
    vector<int32_t> pos;             // topo position as of last walk
    int32_t head = -1;
    vector<vector<int32_t>> paths;
    int32_t max_pred = 0;
    int64_t guard_splits = 0;        // guarded reuse rejections (see thread)

    vector<int32_t> order, row_of;

    explicit FusedPOA(int rc) : ring_cap(rc) {}

    int32_t n_nodes() const { return (int32_t)base.size(); }

    int32_t new_node(int32_t b) {
        int32_t v = (int32_t)base.size();
        base.push_back(b);
        preds.emplace_back();
        nsucc.push_back(0);
        ring.push_back(v);
        nxt.push_back(-1);
        pos.push_back(-1);
        return v;
    }

    void add_edge(int32_t u, int32_t v) {
        for (int32_t p : preds[v])
            if (p == u) return;
        preds[v].push_back(u);
        nsucc[u] += 1;
        max_pred = std::max(max_pred, (int32_t)preds[v].size());
    }

    void walk() {                      // refresh order/pos/row_of
        order.clear();
        row_of.assign(base.size(), 0);
        for (int32_t v = head; v >= 0; v = nxt[v]) {
            pos[v] = (int32_t)order.size();
            order.push_back(v);
            row_of[v] = (int32_t)order.size();   // 1-based DP row
        }
    }

    void seed(const int8_t* seq, int64_t L) {
        vector<int32_t> path;
        path.reserve(L);
        int32_t prev = -1;
        for (int64_t j = 0; j < L; ++j) {
            int32_t v = new_node(seq[j]);
            if (prev >= 0) { add_edge(prev, v); nxt[prev] = v; }
            else head = v;
            path.push_back(v);
            prev = v;
        }
        paths.push_back(std::move(path));
    }

    // DP fill + traceback; fills `target` (seq pos -> node id, -2 = none,
    // -1 = aligned to the virtual source i.e. unaligned insertion).
    // Local-mode rows with scores provably inside int16 run on int16
    // planes (half the plane bandwidth, 32 epi16 lanes); everything else
    // uses the int32 path.  The two are alignment-identical (fill_row16).
    void align(const int8_t* seq, int64_t L, const Params& p,
               vector<int32_t>& target) {
        { PROF(6); walk(); }
        const bool use16 = p.local && p.wb < 0
            && (int64_t)p.m * (L + 1) < 30000
            && p.n < 14000 && p.g < 14000 && p.q < 14000
            && p.e < 900 && p.c < 900;
        if (use16) align_impl<int16_t>(seq, L, p, target);
        else align_impl<int32_t>(seq, L, p, target);
    }

    template <typename T>
    void align_impl(const int8_t* seq, int64_t L, const Params& p,
                    vector<int32_t>& target) {
        constexpr bool IS16 = std::is_same_v<T, int16_t>;
        constexpr int32_t NEGT = IS16 ? NEGS16 : NEG;
        const int64_t V = (int64_t)order.size();
        const int64_t W = L + 1;
        const bool banded = p.wb >= 0;
        const size_t need = (size_t)(V + 1) * W;
        Scratch& S = g_scratch;
        T *Hr, *Hqr, *E1r, *E2r;
        { PROF(0);
        if (banded) {
            // banded rows leave out-of-window cells unwritten but they are
            // still read (successor windows, end-cell scan) — keep the NEG
            // clear.  (banded implies the int32 path; use16 excludes it.)
            if constexpr (IS16) { __builtin_unreachable(); }
            else {
                Hr = S.H.fill_neg(need, NEG);
                Hqr = S.Hq.fill_neg(need, NEG);
                E1r = S.E1.fill_neg(need, NEG);
                E2r = S.E2.fill_neg(need, NEG);
            }
        } else {
            // unbanded: every cell of rows 1..V over [0, W) is written
            // before any read and row 0 is initialized below — the planes
            // stay uninitialized
            if constexpr (IS16) {
                Hr = S.H16.ensure(need);
                Hqr = S.Hq16.ensure(need);
                E1r = S.E116.ensure(need);
                E2r = S.E216.ensure(need);
            } else {
                Hr = S.H.ensure(need);
                Hqr = S.Hq.ensure(need);
                E1r = S.E1.ensure(need);
                E2r = S.E2.ensure(need);
            }
        }
        }

        if (p.local) {
            for (int64_t j = 0; j < W; ++j) { Hr[j] = 0; Hqr[j] = 0; }
        } else {
            Hr[0] = 0; Hqr[0] = 0;
            for (int64_t j = 1; j < W; ++j)
                Hr[j] = (T)std::max(-(p.g + (int32_t)(j - 1) * p.e),
                                    -(p.q + (int32_t)(j - 1) * p.c));
            if (!banded)
                for (int64_t j = 1; j < W; ++j) Hqr[j] = (T)NEGT;
        }
        if (!banded)
            for (int64_t j = 0; j < W; ++j) {
                E1r[j] = (T)NEGT;
                E2r[j] = (T)NEGT;
            }

        // adaptive band: per-node min/max topological rank (1 + min/max
        // over predecessors; identical to ops/poa_host.node_ranks)
        const int32_t w = (p.wb < 0) ? -1
            : p.wb + (int32_t)(((int64_t)p.wf_milli * L) / 1000);
        vector<int32_t> mr, MR;
        int32_t adj_l = 0, adj_r = 0;
        if (w >= 0) {
            mr.assign(base.size(), 1);
            MR.assign(base.size(), 1);
            int32_t D = 0;
            for (int64_t i = 0; i < V; ++i) {
                int32_t v = order[i];
                int32_t lo = 1 << 30, hi = 0;
                for (int32_t u : preds[v]) {
                    lo = std::min(lo, mr[u]);
                    hi = std::max(hi, MR[u]);
                }
                mr[v] = preds[v].empty() ? 1 : lo + 1;
                MR[v] = preds[v].empty() ? 1 : hi + 1;
                D = std::max(D, MR[v]);
            }
            adj_l = std::max<int32_t>(0, D - (int32_t)L);
            adj_r = std::max<int32_t>(0, (int32_t)L - D);
        }

        // local-mode end cell tracked during the fill (row 0 is all zeros
        // in local mode, so it can never hold the strictly-positive best)
        int32_t best_row = NEG;
        int64_t bi = 0;
        T *hpmax, *e1p, *e2p;
        if constexpr (IS16) {
            hpmax = S.hp16.ensure(W);
            e1p = S.e1p16.ensure(W);
            e2p = S.e2p16.ensure(W);
        } else {
            hpmax = S.hpmax.ensure(W);
            e1p = S.e1p.ensure(W);
            e2p = S.e2p.ensure(W);
        }
        for (int64_t i = 1; i <= V; ++i) {
            int32_t v = order[i - 1];
            const auto& ps = preds[v];
            // band window [blo, bhi] of columns to fill (full row when off)
            int64_t blo = 0, bhi = W - 1;
            if (w >= 0) {
                blo = std::max<int64_t>(0, (int64_t)mr[v] - w - adj_l);
                bhi = std::min<int64_t>(L, (int64_t)MR[v] + w + adj_r);
            }
            // predecessor reductions restricted to [blo-1, bhi] (M reads
            // column j-1; cells outside stay whatever — never read)
            const int64_t clo = std::max<int64_t>(0, blo - 1);
            { PROF(1);
            if (ps.empty()) {
                std::copy(Hr + clo, Hr + bhi + 1, hpmax + clo);
                std::copy(E1r + clo, E1r + bhi + 1, e1p + clo);
                std::copy(E2r + clo, E2r + bhi + 1, e2p + clo);
            } else {
                int64_t r0 = (int64_t)row_of[ps[0]] * W;
                std::copy(Hr + r0 + clo, Hr + r0 + bhi + 1, hpmax + clo);
                std::copy(E1r + r0 + clo, E1r + r0 + bhi + 1, e1p + clo);
                std::copy(E2r + r0 + clo, E2r + r0 + bhi + 1, e2p + clo);
                for (size_t k = 1; k < ps.size(); ++k) {
                    int64_t r = (int64_t)row_of[ps[k]] * W;
                    for (int64_t j = clo; j <= bhi; ++j) {
                        hpmax[j] = std::max(hpmax[j], Hr[r + j]);
                        e1p[j] = std::max(e1p[j], E1r[r + j]);
                        e2p[j] = std::max(e2p[j], E2r[r + j]);
                    }
                }
            }
            }
            int32_t bv = base[v];
            int64_t ri = i * W;
            PROF(2);
            int32_t rmax;
            if constexpr (IS16)
                rmax = fill_row16(hpmax, e1p, e2p, seq, bv, p, blo, bhi,
                                  Hr + ri, Hqr + ri, E1r + ri, E2r + ri);
            else
                rmax = fill_row(hpmax, e1p, e2p, seq, bv, p, blo, bhi,
                                Hr + ri, Hqr + ri, E1r + ri, E2r + ri);
            if (p.local && rmax > best_row) { best_row = rmax; bi = i; }
        }

        // ---- end cell ----
        int64_t ei = 0, ej = 0;
        { PROF(3);
        if (p.local) {
            // best_row/bi were tracked during the fill: the first row
            // holding the global max (strict improvements only), matching
            // the row-major first-occurrence rule of the oracle; out-of-
            // band cells are NEG and can never tie a positive best
            if (best_row <= 0) { target.assign(L, -2); return; }
            ei = bi;
            const T* row = Hr + bi * W;
            int64_t t = 0;
            while (row[t] != best_row) ++t;
            ej = t;
        } else {
            int32_t best = NEG - 1;
            for (int64_t i = 1; i <= V; ++i) {
                if (nsucc[order[i - 1]] != 0) continue;
                if (Hr[i * W + L] > best) { best = Hr[i * W + L]; ei = i; }
            }
            ej = L;
        }
        }

        // ---- traceback (value re-derivation; mirrors poa_host.align) ----
        PROF(4);
        target.assign(L, -2);
        int64_t i = ei, j = ej;
        int chan = 0;   // 0=H, 1=Hq, 2=E1, 3=E2
        int32_t val = Hr[i * W + j];
        while (true) {
            if (chan <= 1) {
                if (p.local && val == 0) break;
                if (i == 0) {
                    if (j == 0) break;
                    target[j - 1] = -1;   // leading insertion via row 0
                    j -= 1;
                    val = Hr[j];
                    chan = 0;
                    continue;
                }
                int32_t v = order[i - 1];
                const auto& ps = preds[v];
                bool moved = false;
                if (j > 0) {
                    int32_t subv = (seq[j - 1] == base[v]) ? p.m : -p.n;
                    size_t np = ps.empty() ? 1 : ps.size();
                    for (size_t k = 0; k < np; ++k) {
                        int64_t pr = ps.empty() ? 0 : row_of[ps[k]];
                        if (Hr[pr * W + j - 1] + subv == val) {
                            target[j - 1] = v;
                            i = pr; j -= 1; chan = 0;
                            val = Hr[pr * W + j];
                            moved = true;
                            break;
                        }
                    }
                }
                if (moved) continue;
                if (E1r[i * W + j] == val) { chan = 2; continue; }
                if (E2r[i * W + j] == val) { chan = 3; continue; }
                if (chan == 0) {
                    // nearest F origin k, channel 1 before channel 2 at
                    // each k (single backward scan; matches poa_host and
                    // the CUDA kernel move-for-move)
                    bool found = false;
                    const int32_t ops[2] = {p.g, p.q};
                    const int32_t exs[2] = {p.e, p.c};
                    for (int64_t k = j - 1; k >= 0 && !found; --k) {
                        for (int f = 0; f < 2; ++f) {
                            if (Hqr[i * W + k] - ops[f]
                                - (int32_t)(j - 1 - k) * exs[f] == val) {
                                for (int64_t t = j; t > k; --t)
                                    target[t - 1] = -1;   // insertions
                                j = k; chan = 1;
                                val = Hqr[i * W + j];
                                found = true;
                                break;
                            }
                        }
                    }
                    if (found) continue;
                }
                // stuck — cannot happen with a correct fill
                break;
            } else {
                int32_t op = (chan == 2) ? p.g : p.q;
                int32_t ex = (chan == 2) ? p.e : p.c;
                const T* Em = (chan == 2) ? E1r : E2r;
                int32_t v = order[i - 1];
                (void)v;   // deletion consumes node; nothing recorded in target
                const auto& ps = preds[v];
                size_t np = ps.empty() ? 1 : ps.size();
                bool moved = false;
                for (size_t k = 0; k < np; ++k) {
                    int64_t pr = ps.empty() ? 0 : row_of[ps[k]];
                    if (Hr[pr * W + j] - op == val) {
                        i = pr; chan = 0; val = Hr[pr * W + j];
                        moved = true;
                        break;
                    }
                }
                if (!moved) {
                    for (size_t k = 0; k < np; ++k) {
                        int64_t pr = ps.empty() ? 0 : row_of[ps[k]];
                        if (Em[pr * W + j] - ex == val) {
                            i = pr; val = Em[pr * W + j];
                            moved = true;
                            break;
                        }
                    }
                }
                if (!moved) break;   // broken E chain — cannot happen
            }
        }
    }

    void thread(const vector<int32_t>& target, const int8_t* seq, int64_t L) {
        // Ring lookups see the round-start ring state: splices of this
        // round's new nodes are deferred to the end of the position loop
        // (targets are distinct within one alignment, so they commute).
        // Matches ops/poa_fused.FusedPOA.thread and the CUDA kernel.
        vector<int32_t> path;
        path.reserve(L);
        vector<std::pair<int32_t, int32_t>> ring_splices;
        int32_t prev = -1;
        int32_t guard = -1;
        for (int64_t j = 0; j < L; ++j) {
            int32_t b = seq[j];
            int32_t t = target[j];   // -2 none, -1 insertion, else node
            int32_t v = -1;
            bool saw_base = false;   // base match visible in scan window
            if (t >= 0) {
                int32_t cand = t;
                for (int r = 0; r < ring_cap; ++r) {
                    if (base[cand] == b) {
                        saw_base = true;
                        if (pos[cand] > guard) { v = cand; break; }
                    }
                    cand = ring[cand];
                    if (cand == t) break;
                }
            }
            if (v < 0) {
                // guard-split: spoa's AddAlignment would have reused the
                // matching-base candidate; the guard rule (or ring cap)
                // split the aligned group instead (ops/poa_fused docstring)
                if (saw_base) ++guard_splits;
                v = new_node(b);
                if (t >= 0) ring_splices.emplace_back(t, v);
                if (prev < 0) {
                    nxt[v] = head; head = v; pos[v] = -1;
                } else {
                    nxt[v] = nxt[prev]; nxt[prev] = v; pos[v] = pos[prev];
                }
            } else {
                guard = pos[v];
            }
            if (prev >= 0) add_edge(prev, v);
            path.push_back(v);
            prev = v;
        }
        for (auto& tv : ring_splices) {
            ring[tv.second] = ring[tv.first];
            ring[tv.first] = tv.second;
        }
        paths.push_back(std::move(path));
    }

    void add_sequence(const int8_t* seq, int64_t L, const Params& p) {
        if (n_nodes() == 0) { seed(seq, L); return; }
        if (L == 0) { paths.emplace_back(); return; }
        vector<int32_t> target;
        align(seq, L, p, target);
        thread(target, seq, L);
    }
};

}   // namespace

extern "C" {

void* cpoa_run(const int8_t* seqs, const int64_t* seq_off, int64_t R,
               int32_t m, int32_t n, int32_t g, int32_t e,
               int32_t q, int32_t c, int32_t local, int32_t ring_cap,
               int32_t wb, int32_t wf_milli) {
    auto* f = new FusedPOA(ring_cap);
    Params p{m, n, g, e, q, c, local != 0, wb, wf_milli};
    for (int64_t r = 0; r < R; ++r)
        f->add_sequence(seqs + seq_off[r], seq_off[r + 1] - seq_off[r], p);
    f->walk();   // final order/pos
    return f;
}

int64_t cpoa_n_nodes(void* h) { return ((FusedPOA*)h)->n_nodes(); }
int64_t cpoa_max_pred(void* h) { return ((FusedPOA*)h)->max_pred; }
int64_t cpoa_guard_splits(void* h) { return ((FusedPOA*)h)->guard_splits; }

// base/ring/order sized n_nodes; paths sized seq_off[R] (node id per
// sequence position, concatenated with the input offsets)
void cpoa_export(void* h, int32_t* base, int32_t* ring, int32_t* order,
                 int32_t* paths) {
    auto* f = (FusedPOA*)h;
    std::copy(f->base.begin(), f->base.end(), base);
    std::copy(f->ring.begin(), f->ring.end(), ring);
    std::copy(f->order.begin(), f->order.end(), order);
    int64_t k = 0;
    for (auto& path : f->paths)
        for (int32_t v : path) paths[k++] = v;
}

void cpoa_free(void* h) { delete (FusedPOA*)h; }

#ifdef CPOA_PROF
void cpoa_prof(double* out) {
    for (int i = 0; i < 8; ++i) out[i] = prof_acc[i];
}
#endif

}   // extern "C"
