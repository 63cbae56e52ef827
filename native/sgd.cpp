// Path-guided 1D SGD graph sort — native host backend.
//
// Implements the same term-update semantics as the JAX kernel in
// smoothxg_jax/ops/sgd.py (reference: src/prep.cpp:30-125, odgi
// path_linear_sgd): per update, sample a path step uniformly, a second
// step of the same path at a zipf-distributed rank distance (cooled to
// <=1000 after cooling_start), and pull the two nodes' 1D positions
// toward their nucleotide distance along the path.
//
// Updates are applied SEQUENTIALLY (threads=1, deterministic) — the true
// semantics the reference's Hogwild threads approximate — or Hogwild-style
// over racy threads (threads>1), matching the reference's parallel mode.
// The JAX backend keeps the batched formulation for device-scale graphs;
// this backend serves the host/native engine path where a jit compile
// (and the jax import itself) would dominate the whole pipeline run.
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

inline uint64_t splitmix64(uint64_t& s) {
    uint64_t z = (s += 0x9E3779B97F4A7C15ULL);
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
    return z ^ (z >> 31);
}

struct Rng {  // xoshiro256++
    uint64_t s[4];
    explicit Rng(uint64_t seed) {
        for (int i = 0; i < 4; ++i) s[i] = splitmix64(seed);
    }
    static inline uint64_t rotl(uint64_t x, int k) {
        return (x << k) | (x >> (64 - k));
    }
    inline uint64_t next() {
        const uint64_t r = rotl(s[0] + s[3], 23) + s[0];
        const uint64_t t = s[1] << 17;
        s[2] ^= s[0]; s[3] ^= s[1]; s[1] ^= s[2]; s[0] ^= s[3];
        s[2] ^= t; s[3] = rotl(s[3], 45);
        return r;
    }
    inline double uni() { return (next() >> 11) * 0x1.0p-53; }
};

}  // namespace

extern "C" void sgd_solve(
    int64_t T, const int32_t* st_node, const double* st_pos,
    const int32_t* st_start, const int32_t* st_count,
    int64_t zipf_space, const double* cdf,
    int64_t iter_max, double eta_max, double lam, double cooling_start,
    int64_t B, uint64_t seed, int32_t threads, double* x) {
    auto run = [&](uint64_t wseed, int64_t nb) {
        Rng rng(wseed);
        for (int64_t t = 0; t < iter_max; ++t) {
            const double eta = eta_max * std::exp(-lam * (double)t);
            const int64_t cap =
                ((double)t < (double)iter_max * cooling_start)
                    ? zipf_space
                    : std::min<int64_t>(zipf_space, 1000);
            for (int64_t b = 0; b < nb; ++b) {
                int64_t i1 = (int64_t)(rng.uni() * (double)T);
                if (i1 >= T) i1 = T - 1;
                const double u = rng.uni();
                // searchsorted(cdf, u, side='left') + 1
                int64_t z =
                    (std::lower_bound(cdf, cdf + zipf_space, u) - cdf) + 1;
                if (z > cap) z = cap;
                const int64_t sgn = (rng.next() & 1) ? 1 : -1;
                const int64_t r1 = i1 - st_start[i1];
                const int64_t cnt = st_count[i1];
                int64_t r2 = r1 + sgn * z;
                if (r2 < 0 || r2 >= cnt) r2 = r1 - sgn * z;
                r2 = std::max<int64_t>(0, std::min<int64_t>(r2, cnt - 1));
                const int64_t i2 = st_start[i1] + r2;
                const int32_t n1 = st_node[i1], n2 = st_node[i2];
                double d = std::fabs(st_pos[i1] - st_pos[i2]);
                if (n1 == n2 || d <= 0.0) continue;
                d = std::max(d, 1e-3);
                const double mu = std::min(eta / (d * d), 1.0);
                const double dx = x[n1] - x[n2];
                const double mag = std::fabs(dx) + 1e-9;
                const double upd = mu * (mag - d) / 2.0 / mag * dx;
                x[n1] -= upd;
                x[n2] += upd;
            }
        }
    };
    if (threads <= 1) {
        run(seed, B);
        return;
    }
    // Hogwild: racy unsynchronized writes to x, per-thread RNG streams
    // (reference: odgi path_linear_sgd worker threads).
    std::vector<std::thread> pool;
    const int64_t per = (B + threads - 1) / threads;
    for (int32_t w = 0; w < threads; ++w) {
        const int64_t nb = std::min<int64_t>(per, B - (int64_t)w * per);
        if (nb <= 0) break;
        uint64_t ws = seed;
        for (int32_t i = 0; i <= w; ++i) splitmix64(ws);
        pool.emplace_back(run, ws, nb);
    }
    for (auto& th : pool) th.join();
}
