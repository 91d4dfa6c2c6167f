// Worldline sweeps of a parallel-tempering ladder for sm_90a: R replicas of a
// periodic ring or square torus with quenched per-replica couplings and
// per-replica (dtau, Ktau, h, p_bond).
//
// Replaces the Pallas TPU kernel of pyisingmontecarlo_tpu/ops/wl_ladder_pallas.py,
// _kernel (l.157, launched by _call at l.290/302). The semantics, the
// randomness contract and the plain PyTorch version it is held to bit for
// bit are in pyisingmontecarlo_tpu_torch/ops/ladder.py.
//
// Layout: s[R, nvars, L] int8 (a time line is L contiguous bytes, as in
// wl.cu); couplings J[R, ndir, nvars] f32, each site's outgoing bonds (ring:
// J(i -> i+1); torus: J(i -> y+1), then J(i -> x+1)); dt, kt, h, pb [R] f32.
// One sweep is six launches on the caller's stream:
//
// - ladder_site, four times (site color x tau parity): one thread per active
//   (r, i, tau), in place. Glauber acceptance in logit form,
//   log(u) - log(1 - u) < -dE with dE = (-2 s) (dt (F + h) - kt (s_up + s_dn)),
//   F the coupling-weighted neighbour field.
// - ladder_cluster, twice (one per color): one thread per time line of the
//   color, fk_line_update of worldline.cuh (the binary-counter walk that
//   gives the JAX kernel's pointer-doubling sums, a frozen line's total in
//   XLA's CPU order); a bond freezes when aligned and u < pb, a head flips
//   its cluster when log(u) < -dE, with the slice dE (-2 s) dt (F + h).
//
// Every product and sum is __fmul_rn / __fadd_rn / __fsub_rn in the JAX
// kernel's order, so nothing is contracted to an FMA, and the logs are logf
// (no fast math): the plain version's torch ops on the card round the same.
// The uniform is u = f32(u31) 2^-31 + 2^-32, clipped to 1 - 2^-23 so that
// log(1 - u) stays finite.
//
// What bounds it on an H100: per spin and sweep, two hashes (the site draw
// and the time-bond draw; 22 integer operations each) and about 10 more
// integer operations, and about 37 f32 operations plus two logf; the cluster
// heads' draws and logs depend on the data and are not counted. At the
// tempering bench shape (64 replicas x 144 sites x L_tau 60 = 0.55 M spins)
// that is about 0.9 us of integer issue at 33.5 T op/s per sweep, while the
// 0.55 MB state stays in L2. Each launch lasts a few microseconds, so launch
// latency and the gaps between the six launches set the time there, as at
// wl.cu's 256-chain. Left for later: one launch per sweep with a replica
// resident in a block, CUDA graphs, the swap's features fused in.

#include <cstdint>
#include <cuda_runtime.h>

#include "lanerng.cuh"
#include "worldline.cuh"

namespace {

constexpr float kScale = 4.656612873077393e-10f;    // 2^-31
constexpr float kHalfStep = 2.3283064365386963e-10f;  // 2^-32
constexpr float kUMax = 0.99999988079071044921875f;  // f32(1 - 1.2e-7) = 1 - 2^-23

struct Params {
    const float* J;  // [R, ndir, nvars]
    const float* dt;
    const float* kt;
    const float* h;
    const float* pb;
};

__device__ __forceinline__ float uniform(uint32_t u31) {
    return fminf(__fadd_rn(__fmul_rn(__int2float_rn((int)u31), kScale), kHalfStep), kUMax);
}

// The field sum_b J_b s_b of site i at slice t, in the JAX kernel's order:
// ring fwd + bwd; torus ((y+ + y-) + x+) + x-. Jr is the replica's couplings
// and p its [nvars, L] spins; each incoming bond's J is its source's outgoing
// one.
__device__ __forceinline__ float field(const Geo& g, const int8_t* p, const float* Jr, int i, int t) {
    const int L = g.L, n = g.nvars;
    if (!g.torus) {
        const int ip = i + 1 == n ? 0 : i + 1, im = i == 0 ? n - 1 : i - 1;
        return __fadd_rn(__fmul_rn(__ldg(Jr + i), (float)p[ip * L + t]),
                         __fmul_rn(__ldg(Jr + im), (float)p[im * L + t]));
    }
    const int m = g.size, x = i / m, y = i - x * m;
    const int yp = x * m + (y + 1 == m ? 0 : y + 1), ym = x * m + (y == 0 ? m - 1 : y - 1);
    const int xp = (x + 1 == m ? 0 : x + 1) * m + y, xm = (x == 0 ? m - 1 : x - 1) * m + y;
    const float* J2 = Jr + n;
    float f = __fadd_rn(__fmul_rn(__ldg(Jr + i), (float)p[yp * L + t]), __fmul_rn(__ldg(Jr + ym), (float)p[ym * L + t]));
    f = __fadd_rn(f, __fmul_rn(__ldg(J2 + i), (float)p[xp * L + t]));
    return __fadd_rn(f, __fmul_rn(__ldg(J2 + xm), (float)p[xm * L + t]));
}

// grid: one thread per (r, site of the color, tau of the parity), tau
// fastest. Indices fit in int: R * nvars * L < 2^31 (ops/ladder.py, gate).
__global__ void __launch_bounds__(kSiteBlock) ladder_site(
    int8_t* __restrict__ s, const int32_t* __restrict__ seeds, Params q, Geo g, int ndir, int n_active,
    uint32_t ctr, int color, int parity) {
    const int idx = blockIdx.x * kSiteBlock + threadIdx.x;
    if (idx >= n_active) return;
    const int halfL = g.L >> 1, lines = g.nvars >> 1, L = g.L;
    const int k = idx / halfL;
    const int tau = 2 * (idx - k * halfL) + parity;
    const int r = k / lines;
    const int i = site_of(g, k - r * lines, color);
    int8_t* p = s + (size_t)r * g.nvars * L;
    int8_t* lp = p + (size_t)i * L;
    const int sv = lp[tau];
    const float ud = (float)(lp[tau + 1 == L ? 0 : tau + 1] + lp[tau == 0 ? L - 1 : tau - 1]);
    const float F = field(g, p, q.J + (size_t)r * ndir * g.nvars, i, tau);
    const float inner = __fsub_rn(__fmul_rn(__ldg(q.dt + r), __fadd_rn(F, __ldg(q.h + r))),
                                  __fmul_rn(__ldg(q.kt + r), ud));
    const float dE = __fmul_rn(-2.0f * (float)sv, inner);
    const float u = uniform(lane_draw31((uint32_t)__ldg(seeds + r), (uint32_t)(tau * g.nvars + i), ctr));
    if (__fsub_rn(logf(u), logf(__fsub_rn(1.0f, u))) < -dE) lp[tau] = (int8_t)(-sv);
}

// grid: one thread per time line of the color, kLineBlock lines per block.
__global__ void __launch_bounds__(kLineBlock) ladder_cluster(
    int8_t* __restrict__ s, const int32_t* __restrict__ seeds, Params q, Geo g, int ndir, int n_lines,
    uint32_t ctr, int color) {
    extern __shared__ uint32_t bits[];
    const int line = blockIdx.x * kLineBlock + threadIdx.x;
    if (line >= n_lines) return;
    const int L = g.L, nvars = g.nvars, lines = nvars >> 1;
    const int r = line / lines;
    const int i = site_of(g, line - r * lines, color);
    const int8_t* p = s + (size_t)r * nvars * L;
    const float* Jr = q.J + (size_t)r * ndir * nvars;
    const uint32_t seed = (uint32_t)__ldg(seeds + r);
    const float dt = __ldg(q.dt + r), h = __ldg(q.h + r), pb = __ldg(q.pb + r);
    fk_line_update(
        s + ((size_t)r * nvars + i) * L, bits + threadIdx.x, L,
        [&](int t) { return uniform(lane_draw31(seed, (uint32_t)(t * nvars + i), ctr)) < pb; },
        [&](int x, int sv) { return __fmul_rn(__fmul_rn(-2.0f * (float)sv, dt), __fadd_rn(field(g, p, Jr, i, x), h)); },
        [&](int head, float de) {
            return logf(uniform(lane_draw31(seed, (uint32_t)(head * nvars + i), ctr + 1))) < -de;
        });
}

}  // namespace

// Runs T sweeps (6 T launches) on `stream` on s[R, nvars, L]; seeds is
// [T, R] int32 (row t keys sweep t), J [R, ndir, nvars] and dt, kt, h, pb [R]
// f32 as in ops/ladder.py. Draw d of every sweep uses counter d: 0..3 the site
// phases, 4 + 2c and 5 + 2c the bond and head draws of cluster color c.
// Returns the first launch error, or 0.
extern "C" int ladder_sweeps(void* s, const void* seeds, const void* J, const void* dt, const void* kt,
                             const void* h, const void* pb, int R, int nvars, int L, int torus, int size,
                             int T, void* stream) {
    if (L < 4 || L > kMaxL || (L & 1) || (nvars & 1)) return (int)cudaErrorInvalidValue;
    const Geo g{torus, size, nvars, L};
    const int ndir = torus ? 2 : 1;
    const Params q{static_cast<const float*>(J), static_cast<const float*>(dt), static_cast<const float*>(kt),
                   static_cast<const float*>(h), static_cast<const float*>(pb)};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    int8_t* sp = static_cast<int8_t*>(s);
    const int n_active = R * (nvars / 2) * (L / 2);
    const int n_color = R * (nvars / 2);
    const unsigned site_grid = (n_active + kSiteBlock - 1) / kSiteBlock;
    const unsigned color_grid = (n_color + kLineBlock - 1) / kLineBlock;
    const int smem = cluster_smem_bytes(L);
    cudaError_t e = cudaFuncSetAttribute(ladder_cluster, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    for (int t = 0; t < T; ++t) {
        const int32_t* sd = static_cast<const int32_t*>(seeds) + (size_t)t * R;
        uint32_t d = 0;
        for (int color = 0; color < 2; ++color)
            for (int parity = 0; parity < 2; ++parity) {
                ladder_site<<<site_grid, kSiteBlock, 0, st>>>(sp, sd, q, g, ndir, n_active, d++, color, parity);
                if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
            }
        for (int color = 0; color < 2; ++color) {
            ladder_cluster<<<color_grid, kLineBlock, smem, st>>>(sp, sd, q, g, ndir, n_color, d, color);
            d += 2;
            if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
        }
    }
    return 0;
}
