// Bounded affine wavefront alignment (WFA) with adaptive reduction.
//
// Native tier of smoothxg_jax/ops/wfa.py — exact same algorithm and
// traceback tie-breaks, so the two produce identical (score, cigar) pairs
// (fuzz-verified in tests/test_native.py).  The reference uses the WFA
// library's bounded reduced mode for identity clustering in the block
// split stage (src/breaks.cpp:186-196,474-502); this file is that
// capability rebuilt for the flat-array runtime: one self-contained
// translation unit, C ABI, no allocations shared with the caller.
//
// Alignment model: diagonal k = h - v (position in a minus position in b),
// affine gaps, penalties {match 0, mismatch x, gap_open o, gap_ext e}.
// Wavefronts longer than min_wf_len are trimmed at the boundaries when a
// diagonal's remaining distance to the target cell lags the best by more
// than max_dist_thr (WFA-adaptive heuristic).

#include <cstdint>
#include <cstring>
#include <memory>
#include <vector>

namespace {

constexpr int64_t NEG = INT64_MIN / 2;
constexpr int64_t NEG_HALF = NEG / 2;   // "is a real offset" threshold

struct WF {
    int64_t lo, hi;
    std::vector<int64_t> m, i, d;
    WF(int64_t lo_, int64_t hi_)
        : lo(lo_), hi(hi_),
          m(size_t(hi_ - lo_ + 1), NEG),
          i(size_t(hi_ - lo_ + 1), NEG),
          d(size_t(hi_ - lo_ + 1), NEG) {}
    int64_t get(const std::vector<int64_t>& arr, int64_t k) const {
        if (k < lo || k > hi) return NEG;
        return arr[size_t(k - lo)];
    }
    int64_t gm(int64_t k) const { return get(m, k); }
    int64_t gi(int64_t k) const { return get(i, k); }
    int64_t gd(int64_t k) const { return get(d, k); }
};

inline int64_t extend1(int64_t h, int64_t k, const uint8_t* a, int64_t la,
                       const uint8_t* b, int64_t lb) {
    int64_t v = h - k;
    while (h < la && v < lb && a[h] == b[v]) { ++h; ++v; }
    return h;
}

struct Aligner {
    std::vector<std::unique_ptr<WF>> wfs;   // indexed by score
    const uint8_t *a, *b;
    int64_t la, lb;
    int64_t mismatch, gap_open, gap_ext;

    WF* at(int64_t s) {
        if (s < 0 || size_t(s) >= wfs.size()) return nullptr;
        return wfs[size_t(s)].get();
    }

    int64_t traceback(int64_t s, int64_t k, char* out) {
        // emits ops REVERSED into out; caller reverses.  Matches the
        // Python _traceback state machine including its x>i>d tie order.
        int64_t n = 0;
        int64_t h = la;
        char state = 'm';
        for (;;) {
            WF* w = at(s);
            if (s == 0 && state == 'm') {
                while (h > 0) { out[n++] = 'M'; --h; }
                break;
            }
            if (state == 'm') {
                WF* sx = at(s - mismatch);
                int64_t src = sx ? sx->gm(k) : NEG;
                int64_t i_off = w ? w->gi(k) : NEG;
                int64_t d_off = w ? w->gd(k) : NEG;
                int64_t xm = (src > NEG_HALF) ? src + 1 : NEG;
                int64_t base = xm;
                if (i_off > NEG_HALF && i_off > base) base = i_off;
                if (d_off > NEG_HALF && d_off > base) base = d_off;
                while (h > base) { out[n++] = 'M'; --h; }
                if (xm > NEG_HALF && xm == base) {
                    out[n++] = 'X'; --h; s -= mismatch;
                } else if (i_off > NEG_HALF && i_off == base) {
                    state = 'i';
                } else {
                    state = 'd';
                }
            } else if (state == 'i') {
                out[n++] = 'I';
                WF* so = at(s - gap_open - gap_ext);
                WF* se = at(s - gap_ext);
                int64_t from_m = so ? so->gm(k - 1) : NEG;
                int64_t from_i = se ? se->gi(k - 1) : NEG;
                --h; --k;
                if (from_m >= from_i) { s -= gap_open + gap_ext; state = 'm'; }
                else                  { s -= gap_ext; }
            } else {  // 'd'
                out[n++] = 'D';
                WF* so = at(s - gap_open - gap_ext);
                WF* se = at(s - gap_ext);
                int64_t from_m = so ? so->gm(k + 1) : NEG;
                int64_t from_d = se ? se->gd(k + 1) : NEG;
                ++k;
                if (from_m >= from_d) { s -= gap_open + gap_ext; state = 'm'; }
                else                  { s -= gap_ext; }
            }
        }
        // reverse in place
        for (int64_t x = 0, y = n - 1; x < y; ++x, --y) {
            char t = out[x]; out[x] = out[y]; out[y] = t;
        }
        return n;
    }
};

void reduce_wf(WF& w, int64_t la, int64_t lb, int64_t thr) {
    int64_t n = int64_t(w.m.size());
    int64_t best = INT64_MAX;
    for (int64_t x = 0; x < n; ++x) {
        int64_t h = w.m[size_t(x)];
        if (h <= NEG_HALF) continue;
        int64_t k = w.lo + x;
        int64_t dist = (la - h) + (lb - (h - k));
        if (dist < best) best = dist;
    }
    if (best == INT64_MAX) return;       // nothing live
    const int64_t lim = best + thr;
    auto dropped = [&](int64_t x) {
        int64_t h = w.m[size_t(x)];
        if (h <= NEG_HALF) return true;  // dead diagonals trim freely
        int64_t k = w.lo + x;
        return (la - h) + (lb - (h - k)) > lim;
    };
    int64_t i = 0, j = n - 1;
    while (i < n && dropped(i)) ++i;
    while (j >= 0 && dropped(j)) --j;
    if (i > j) return;                   // all boundary-dropped: keep as is
    if (i > 0 || j < n - 1) {
        w.m.assign(w.m.begin() + i, w.m.begin() + j + 1);
        w.i.assign(w.i.begin() + i, w.i.begin() + j + 1);
        w.d.assign(w.d.begin() + i, w.d.begin() + j + 1);
        w.hi = w.lo + j;
        w.lo = w.lo + i;
    }
}

}  // namespace

extern "C" {

// Returns the alignment score (>= 0) and writes the M/X/I/D op string to
// cigar_out (capacity must be >= la + lb; *cigar_len receives its length),
// or returns -1 when max_score was exceeded (cigar untouched).
int64_t wfa_align_c(const uint8_t* a, int64_t la,
                    const uint8_t* b, int64_t lb,
                    int64_t mismatch, int64_t gap_open, int64_t gap_ext,
                    int64_t max_score, int64_t min_wf_len,
                    int64_t max_dist_thr,
                    char* cigar_out, int64_t* cigar_len) {
    Aligner al;
    al.a = a; al.b = b; al.la = la; al.lb = lb;
    al.mismatch = mismatch; al.gap_open = gap_open; al.gap_ext = gap_ext;
    if (max_score < 0) max_score = mismatch * (la > lb ? la : lb);
    al.wfs.resize(size_t(max_score + 1));

    const int64_t k_final = la - lb;
    const int64_t off_final = la;

    auto w0 = std::make_unique<WF>(0, 0);
    w0->m[0] = extend1(0, 0, a, la, b, lb);
    int64_t w0m = w0->m[0];
    al.wfs[0] = std::move(w0);
    if (w0m >= off_final && k_final == 0) {
        for (int64_t x = 0; x < la; ++x) cigar_out[x] = 'M';
        *cigar_len = la;
        return 0;
    }

    for (int64_t s = 1; s <= max_score; ++s) {
        WF* sx = al.at(s - mismatch);
        WF* so = al.at(s - gap_open - gap_ext);
        WF* se = al.at(s - gap_ext);
        if (!sx && !so && !se) continue;
        int64_t lo = INT64_MAX, hi = INT64_MIN;
        for (WF* w : {sx, so, se}) {
            if (!w) continue;
            if (w->lo < lo) lo = w->lo;
            if (w->hi > hi) hi = w->hi;
        }
        --lo; ++hi;
        auto wp = std::make_unique<WF>(lo, hi);
        WF& w = *wp;
        bool hit = false;
        for (int64_t k = lo; k <= hi; ++k) {
            size_t x = size_t(k - lo);
            // I (insertion in a: h advances) from k-1; D from k+1
            int64_t iv = so ? so->gm(k - 1) : NEG;
            int64_t i2 = se ? se->gi(k - 1) : NEG;
            if (i2 > iv) iv = i2;
            iv = (iv + 1 <= NEG_HALF) ? NEG : iv + 1;
            w.i[x] = iv;
            int64_t dv = so ? so->gm(k + 1) : NEG;
            int64_t d2 = se ? se->gd(k + 1) : NEG;
            if (d2 > dv) dv = d2;
            if (dv <= NEG_HALF) dv = NEG;
            w.d[x] = dv;
            int64_t xm = sx ? sx->gm(k) : NEG;
            xm = (xm <= NEG_HALF) ? NEG : xm + 1;
            int64_t mv = xm;
            if (iv > mv) mv = iv;
            if (dv > mv) mv = dv;
            // clip to valid cells: 0 <= h <= la, 0 <= h-k <= lb
            if (!(mv > NEG_HALF && mv >= 0 && mv <= la &&
                  mv - k >= 0 && mv - k <= lb)) {
                w.m[x] = NEG;
                continue;
            }
            mv = extend1(mv, k, a, la, b, lb);
            w.m[x] = mv;
            if (k == k_final && mv >= off_final) hit = true;
        }
        al.wfs[size_t(s)] = std::move(wp);
        if (hit) {
            *cigar_len = al.traceback(s, k_final, cigar_out);
            return s;
        }
        WF& wr = *al.wfs[size_t(s)];
        if (max_dist_thr > 0 && int64_t(wr.m.size()) > min_wf_len)
            reduce_wf(wr, la, lb, max_dist_thr);
    }
    return -1;
}

}  // extern "C"
