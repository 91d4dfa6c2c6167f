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
// Two routes, chosen by shape alone (ops/ladder.py, through
// ops/wl.resident_plan):
//
// Resident (ladder_resident, one launch per call): one block per replica
// holds its plane, its couplings J[r] and its neighbour tables in shared
// memory for all T sweeps (resident.cuh), sweep t keyed by row t of the seeds;
// four site phases and two cluster phases (res_cluster) a sweep. After the
// last sweep the block writes the swap features of the state it leaves,
// feat[r] = (P per union edge (ea, eb) summed over tau, S the spin sum, A the
// aligned time bonds), int32, which LatticeTempering reads in place of
// computing them with torch operations.
//
// Multi-launch (planes too large for a block, such as a 64^2 torus at
// L_tau = 60, 245 KB a replica), six launches a sweep on the caller's stream:
//
// - ladder_site, four times (site color x tau parity): one thread per active
//   (r, i, tau), in place. Glauber acceptance in logit form,
//   log(u) - log(1 - u) < -dE with dE = (-2 s) (dt (F + h) - kt (s_up + s_dn)),
//   F the coupling-weighted neighbour field.
// - ladder_cluster, twice (one per color): a group of threads per time line
//   of the color (a warp at the tempering shapes' L_tau), fk_line of
//   worldline.cuh (the JAX kernel's pointer-doubling sums in shared memory, a
//   frozen line's total in XLA's CPU order); a bond freezes when aligned and
//   u < pb, a head flips its cluster when log(u) < -dE, with the slice dE
//   (-2 s) dt (F + h), F from the site's neighbour lines and couplings
//   (SiteField, found once a line).
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
// 0.55 MB state stays in L2. The multi-launch route's six launches last a few
// microseconds each at that shape; the resident route takes it with no
// launch between phases, the state read and written once per call, and the
// features computed from shared memory. At R = 64 it fills 64 of the 132
// SMs. The multi-launch route takes the planes too large for a block, such
// as the 64^2 glass: there a warp owns each of its 131072 lines a phase, and
// the ALU work of the cluster phase's slice loops bounds it (chip_smoke.py
// counts their SASS).

#include <cstdint>
#include <cuda_runtime.h>

#include "lanerng.cuh"
#include "resident.cuh"
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

// The field sum_b J_b s_b of a site from its terms (coupling, neighbour
// spin), in the JAX kernel's order: ring fwd + bwd (the last two terms
// unused); torus ((y+ + y-) + x+) + x-. field() and SiteField both add
// through it, so the order is written once.
__device__ __forceinline__ float field_sum(bool torus, float j0, float s0, float j1, float s1, float j2, float s2,
                                           float j3, float s3) {
    const float f = __fadd_rn(__fmul_rn(j0, s0), __fmul_rn(j1, s1));
    if (!torus) return f;
    return __fadd_rn(__fadd_rn(f, __fmul_rn(j2, s2)), __fmul_rn(j3, s3));
}

// The field of site i at slice t. Jr is the replica's couplings and p its
// [nvars, L] spins; each incoming bond's J is its source's outgoing one.
__device__ __forceinline__ float field(const Geo& g, const int8_t* p, const float* Jr, int i, int t) {
    const int L = g.L, n = g.nvars;
    if (!g.torus) {
        const int ip = i + 1 == n ? 0 : i + 1, im = i == 0 ? n - 1 : i - 1;
        return field_sum(false, __ldg(Jr + i), (float)p[ip * L + t], __ldg(Jr + im), (float)p[im * L + t], 0.0f,
                         0.0f, 0.0f, 0.0f);
    }
    const int m = g.size, x = i / m, y = i - x * m;
    const int yp = x * m + (y + 1 == m ? 0 : y + 1), ym = x * m + (y == 0 ? m - 1 : y - 1);
    const int xp = (x + 1 == m ? 0 : x + 1) * m + y, xm = (x == 0 ? m - 1 : x - 1) * m + y;
    const float* J2 = Jr + n;
    return field_sum(true, __ldg(Jr + i), (float)p[yp * L + t], __ldg(Jr + ym), (float)p[ym * L + t], __ldg(J2 + i),
                     (float)p[xp * L + t], __ldg(J2 + xm), (float)p[xm * L + t]);
}

// field() of one site i at any slice, its neighbour lines and couplings
// found once (nb: its neighbours(), ring i+1, i-1; torus x+1, x-1, y+1,
// y-1), for the cluster phase's pass along the line.
struct SiteField {
    const int8_t* q[4];  // ring: i+1, i-1; torus: y+1, y-1, x+1, x-1
    float j[4];
    int torus;

    __device__ SiteField(const Geo& g, const int8_t* p, const float* Jr, const Nbrs& nb, int i) : torus(g.torus) {
        const int L = g.L, n = g.nvars;
        if (!g.torus) {
            q[0] = p + nb.j[0] * L, q[1] = p + nb.j[1] * L, q[2] = q[3] = q[0];
            j[0] = __ldg(Jr + i), j[1] = __ldg(Jr + nb.j[1]), j[2] = j[3] = 0.0f;
            return;
        }
        q[0] = p + nb.j[2] * L, q[1] = p + nb.j[3] * L, q[2] = p + nb.j[0] * L, q[3] = p + nb.j[1] * L;
        j[0] = __ldg(Jr + i), j[1] = __ldg(Jr + nb.j[3]), j[2] = __ldg(Jr + n + i), j[3] = __ldg(Jr + n + nb.j[1]);
    }
    __device__ __forceinline__ float at(int t) const {
        if (!torus) return field_sum(false, j[0], (float)q[0][t], j[1], (float)q[1][t], 0.0f, 0.0f, 0.0f, 0.0f);
        return field_sum(true, j[0], (float)q[0][t], j[1], (float)q[1][t], j[2], (float)q[2][t], j[3],
                         (float)q[3][t]);
    }
};

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

// grid fk_grid: a group of G threads per time line of the color
// (fk_block_lines(G) lines a block): fk_line (worldline.cuh).
template <int G>
__global__ void __launch_bounds__(fk_block_threads(G)) ladder_cluster(
    int8_t* __restrict__ s, const int32_t* __restrict__ seeds, Params q, Geo g, int ndir, uint32_t ctr, int color) {
    extern __shared__ __align__(16) unsigned char fk_smem[];
    int x, y;
    if (!fk_site<G>(g, color, x, y)) return;  // the whole group
    const int L = g.L, nvars = g.nvars, r = blockIdx.z, i = x * g.size + y;
    const int8_t* p = s + (size_t)r * nvars * L;
    const float* Jr = q.J + (size_t)r * ndir * nvars;
    const uint32_t seed = (uint32_t)__ldg(seeds + r);
    const float dt = __ldg(q.dt + r), h = __ldg(q.h + r), pb = __ldg(q.pb + r);
    const SiteField F(g, p, Jr, neighbours_at(g, x, y), i);
    fk_line<G>(
        s + ((size_t)r * nvars + i) * L, fk_smem + (threadIdx.x / G) * fk_line_bytes(L), L,
        [&](int t) { return uniform(lane_draw31(seed, (uint32_t)(t * nvars + i), ctr)) < pb; },
        [&](int t, int sv) { return __fmul_rn(__fmul_rn(-2.0f * (float)sv, dt), __fadd_rn(F.at(t), h)); },
        [&](int head, float de) {
            return logf(uniform(lane_draw31(seed, (uint32_t)(head * nvars + i), ctr + 1))) < -de;
        });
}

// field() on the resident plane: Js is the replica's [ndir, nvars] couplings
// in shared memory, n site i's neighbours (ring i+1, i-1; torus x+1, x-1,
// y+1, y-1); the same operations in the same order.
__device__ __forceinline__ float res_field(const int8_t* pl, const float* Js, ushort4 n, int torus, int nvars,
                                           int L, int i, int t) {
    if (!torus)
        return __fadd_rn(__fmul_rn(Js[i], (float)pl[n.x * L + t]), __fmul_rn(Js[n.y], (float)pl[n.y * L + t]));
    const float* J2 = Js + nvars;
    float f = __fadd_rn(__fmul_rn(Js[i], (float)pl[n.z * L + t]), __fmul_rn(Js[n.w], (float)pl[n.w * L + t]));
    f = __fadd_rn(f, __fmul_rn(J2[i], (float)pl[n.x * L + t]));
    return __fadd_rn(f, __fmul_rn(J2[n.y], (float)pl[n.y * L + t]));
}

// grid: one block per replica (resident.cuh), T sweeps, then the features of
// the final state into feat [R, E + 2] int32 (per-edge bond products, spin
// sum, aligned time bonds).
__global__ void __launch_bounds__(kResThreads, 1) ladder_resident(
    int8_t* __restrict__ s, const int32_t* __restrict__ seeds, Params q, Geo g, int ndir, int R, int T, int tile,
    const int32_t* __restrict__ ea, const int32_t* __restrict__ eb, int E, int32_t* __restrict__ feat) {
    extern __shared__ __align__(16) unsigned char smem[];
    Res b;
    b.base = smem;
    const int r = blockIdx.x, tid = threadIdx.x;
    const int L = g.L, nvars = g.nvars, half = g.nvars >> 1;
    int8_t* gs = s + (size_t)r * nvars * L;
    res_load(b, gs, g, ndir * nvars * 4, tile);
    float* Js = reinterpret_cast<float*>(b.params());
    for (int k = tid; k < ndir * nvars; k += kResThreads) Js[k] = q.J[(size_t)r * ndir * nvars + k];
    const float dt = q.dt[r], kt = q.kt[r], h = q.h[r], pb = q.pb[r];
    __syncthreads();
    int8_t* pl = b.pl();
    const ushort4* nb = b.nb();
    const Walk sw(L >> 1), lw(L);
    for (int t = 0; t < T; ++t) {
        const uint32_t seed = (uint32_t)seeds[(size_t)t * R + r];
        for (int color = 0; color < 2; ++color)
            for (int parity = 0; parity < 2; ++parity) {
                const uint32_t ctr = 2 * color + parity;
                const uint16_t* sites = b.sites() + color * half;
                for (Walk w = sw; w.row < half; w.next()) {
                    const int i = sites[w.row], tau = 2 * w.col + parity;
                    int8_t* lp = pl + i * L;
                    const int sv = lp[tau];
                    const float ud = (float)(lp[tau + 1 == L ? 0 : tau + 1] + lp[tau == 0 ? L - 1 : tau - 1]);
                    const float F = res_field(pl, Js, nb[i], g.torus, nvars, L, i, tau);
                    const float inner = __fsub_rn(__fmul_rn(dt, __fadd_rn(F, h)), __fmul_rn(kt, ud));
                    const float dE = __fmul_rn(-2.0f * (float)sv, inner);
                    const float u = uniform(lane_draw31(seed, (uint32_t)(tau * nvars + i), ctr));
                    if (__fsub_rn(logf(u), logf(__fsub_rn(1.0f, u))) < -dE) lp[tau] = (int8_t)(-sv);
                }
                __syncthreads();
            }
        for (int color = 0; color < 2; ++color) {
            const uint32_t ctr = 4 + 2 * color;
            res_cluster(
                b, sw, color,
                [&](int i, int t) { return uniform(lane_draw31(seed, (uint32_t)(t * nvars + i), ctr)) < pb; },
                [&](int i, int t, int sv) {
                    return __fmul_rn(__fmul_rn(-2.0f * (float)sv, dt),
                                     __fadd_rn(res_field(pl, Js, nb[i], g.torus, nvars, L, i, t), h));
                },
                [&](int i, int head, float de) {
                    return logf(uniform(lane_draw31(seed, (uint32_t)(head * nvars + i), ctr + 1))) < -de;
                });
        }
    }
    // the features of the state the launch leaves
    int32_t* f = feat + (size_t)r * (E + 2);
    for (int e = tid; e < E; e += kResThreads) {
        const int8_t* a = pl + ea[e] * L;
        const int8_t* c = pl + eb[e] * L;
        int p = 0;
        for (int t = 0; t < L; ++t) p += a[t] * c[t];
        f[e] = p;
    }
    int S = 0, A = 0;
    for (Walk w = lw; w.row < nvars; w.next()) {
        const int sv = pl[w.e];
        S += sv;
        A += sv == pl[w.col + 1 == L ? w.e - w.col : w.e + 1];
    }
    res_block_add(b.red(), 0, S);
    res_block_add(b.red(), 1, A);
    __syncthreads();
    if (tid == 0) {
        f[E] = b.red()[0];
        f[E + 1] = b.red()[1];
    }
    res_store(b, gs);
}

}  // namespace

// Runs T sweeps (6 T launches) on `stream` on s[R, nvars, L]; seeds is
// [T, R] int32 (row t keys sweep t), J [R, ndir, nvars] and dt, kt, h, pb [R]
// f32 as in ops/ladder.py. Draw d of every sweep uses counter d: 0..3 the site
// phases, 4 + 2c and 5 + 2c the bond and head draws of cluster color c. The
// cluster phases take fk_group(L) threads a line (worldline.cuh); R <= 65535
// (fk_grid). Returns the first launch error, or 0.
extern "C" int ladder_sweeps(void* s, const void* seeds, const void* J, const void* dt, const void* kt,
                             const void* h, const void* pb, int R, int nvars, int L, int torus, int size,
                             int T, void* stream) {
    if (L < 4 || L > kMaxL || (L & 1) || (nvars & 1) || R > 65535) return (int)cudaErrorInvalidValue;
    const Geo g{torus, size, nvars, L};
    const int ndir = torus ? 2 : 1;
    const Params q{static_cast<const float*>(J), static_cast<const float*>(dt), static_cast<const float*>(kt),
                   static_cast<const float*>(h), static_cast<const float*>(pb)};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    int8_t* sp = static_cast<int8_t*>(s);
    const int n_active = R * (nvars / 2) * (L / 2);
    const unsigned site_grid = (n_active + kSiteBlock - 1) / kSiteBlock;
    return (int)by_group(L, [&](auto gc) {
        constexpr int G = decltype(gc)::value;
        const int smem = fk_block_lines(G) * fk_line_bytes(L);
        cudaError_t e = cudaFuncSetAttribute(ladder_cluster<G>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return e;
        for (int t = 0; t < T; ++t) {
            const int32_t* sd = static_cast<const int32_t*>(seeds) + (size_t)t * R;
            uint32_t d = 0;
            for (int color = 0; color < 2; ++color)
                for (int parity = 0; parity < 2; ++parity) {
                    ladder_site<<<site_grid, kSiteBlock, 0, st>>>(sp, sd, q, g, ndir, n_active, d++, color, parity);
                    if ((e = cudaGetLastError()) != cudaSuccess) return e;
                }
            for (int color = 0; color < 2; ++color) {
                ladder_cluster<G><<<fk_grid(g, R, G), fk_block_threads(G), smem, st>>>(sp, sd, q, g, ndir, d, color);
                d += 2;
                if ((e = cudaGetLastError()) != cudaSuccess) return e;
            }
        }
        return cudaSuccess;
    });
}

// The resident route: T sweeps in one launch of R blocks on `stream`, then the
// features of the final state into feat [R, E + 2] int32 (ea, eb [E] int32
// site indices in [0, nvars)); tile and smem as ops/wl.resident_plan gives
// them (refused unless they match this file's layout). The other arguments
// as ladder_sweeps.
extern "C" int ladder_resident_sweeps(void* s, const void* seeds, const void* J, const void* dt, const void* kt,
                                      const void* h, const void* pb, const void* ea, const void* eb, void* feat,
                                      int R, int nvars, int L, int torus, int size, int T, int E, int tile, int smem,
                                      void* stream) {
    const int ndir = torus ? 2 : 1;
    if (L < 4 || L > kMaxL || (L & 1) || (nvars & 1) || nvars > 65535 || tile < 1 || tile > nvars / 2 ||
        E < 0 || res_layout(nvars, L, ndir * nvars * 4, tile).bytes != smem)
        return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(ladder_resident, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    const Params q{static_cast<const float*>(J), static_cast<const float*>(dt), static_cast<const float*>(kt),
                   static_cast<const float*>(h), static_cast<const float*>(pb)};
    ladder_resident<<<R, kResThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<int8_t*>(s), static_cast<const int32_t*>(seeds), q, Geo{torus, size, nvars, L}, ndir, R, T, tile,
        static_cast<const int32_t*>(ea), static_cast<const int32_t*>(eb), E, static_cast<int32_t*>(feat));
    return (int)cudaGetLastError();
}
