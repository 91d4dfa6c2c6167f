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
// L_tau = 60, 245 KB a replica, and every line past L_tau = kMaxL = 4096, up
// to the JAX kernel's gate of 10^6 spins a replica: L_tau = 250,000 on a
// 4-ring), four launches a sweep on the caller's stream:
//
// - ladder_site, twice (one per site color): a group of threads per time
//   line of the color (site_lanes(L): 4 threads of 8 pairs of slices each up
//   to L_tau = 64, more up to a warp, then a warp taking the line in chunks),
//   both tau parities in one launch, in place: the even slices, then the odd
//   slices from the updated even ones (site_phases of worldline.cuh, the
//   schedule wl_site shares). The line's pairs of slices and its
//   neighbour lines' are read in 2-byte words, and its couplings and
//   neighbour lines found once a line (SiteField). Glauber acceptance in
//   logit form, log(u) - log(1 - u) < -dE with
//   dE = (-2 s) (dt (F + h) - kt (s_up + s_dn)), F the coupling-weighted
//   neighbour field.
// - ladder_cluster, twice (one per color): a group of threads per time line
//   of the color (a warp at the tempering shapes' L_tau), fk_line of
//   worldline.cuh (the JAX kernel's pointer-doubling sums in shared memory, a
//   frozen line's total in XLA's CPU order); a bond freezes when aligned and
//   u < pb, a head flips its cluster when log(u) < -dE, with the slice dE
//   (-2 s) dt (F + h), F from the site's neighbour lines and couplings
//   (SiteField, found once a line). A line past one block's opt-in
//   shared memory (L > 26,944 on an H100) takes the two fk_long_* launches
//   a color of worldline.cuh instead (6 launches a sweep).
// - pt_swap_features, once a call after the last sweep, where the caller
//   asks for the features: the resident route's feat [R, E + 2] int32 of the
//   state the call leaves, a memset of its S and A slots before it. It
//   replaces no Pallas kernel: the JAX package computes these features with
//   XLA ops (pyisingmontecarlo_tpu/tempering.py:152, _swap_features), and
//   the port did so in torch (ops/ladder.swap_features) until a gather of
//   2 R E L_tau bytes and int64 sums, a dozen operations after every sweep,
//   took more device time than the sweep's four launches on the 80^2 glass.
//   A group of feat_lanes(L) threads an item (a union edge (ea, eb) in its
//   given order, then a time line; one thread up to 16 words a line, so a
//   thread an item at the tempering shapes' L_tau = 60), reading its lines
//   in 4-byte words with dp4a (2-byte words where L % 4 = 2): an edge's
//   products summed over tau; a line's spin sum and its aligned time bonds
//   (L + sum_t s_t s_t+1) / 2 from its words against the same words shifted
//   down one byte, summed over the block and added into feat's zeroed slots
//   with an atomic a block (the sums are integers, so their order does not
//   matter). What bounds it is the state's bytes, read once, and the
//   features' written: 27.9 MB at 64 x 6400 x 60, 8.3 us at 3.35 TB/s. It
//   reads each line about five times (its own item and its sites' four
//   edges), from L2 (which still holds the state the last cluster launch
//   wrote) and L1, since nothing is assumed of the edges' order: about
//   27 us there on an H100, the same with 8 to 32 words a lane and 128 to
//   512 threads a block, 43 us with 4 words and 108 with 1.
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
// 0.55 MB state stays in L2. The multi-launch route's four launches last a few
// microseconds each at that shape; the resident route takes it with no
// launch between phases, the state read and written once per call, and the
// features computed from shared memory. At R = 64 it fills 64 of the 132
// SMs. The multi-launch route takes the planes too large for a block, such
// as the 64^2 glass: there a warp owns each of its 131072 lines a cluster
// phase, and the ALU work of the cluster phase's slice loops bounds it; the
// site phases issue a hash, two logf and the update's f32 work a spin, the
// line's set-up shared by 16 spins.

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
// unused); torus ((y+ + y-) + x+) + x-. SiteField's at() and at2() both add
// through it, so the order is written once.
__device__ __forceinline__ float field_sum(bool torus, float j0, float s0, float j1, float s1, float j2, float s2,
                                           float j3, float s3) {
    const float f = __fadd_rn(__fmul_rn(j0, s0), __fmul_rn(j1, s1));
    if (!torus) return f;
    return __fadd_rn(__fadd_rn(f, __fmul_rn(j2, s2)), __fmul_rn(j3, s3));
}

// The field sum_b J_b s_b of one site at any slice, its neighbour lines and
// couplings found once a line (nb: its neighbours(), ring i+1, i-1; torus
// x+1, x-1, y+1, y-1; each incoming bond's J is its source's outgoing one).
// Jr is the replica's couplings and p its [nvars, L] spins.
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
    // The fields at slices t and t + 1, t even: one 2-byte load a neighbour line.
    __device__ __forceinline__ void at2(int t, float& f0, float& f1) const {
        const char2 a = *reinterpret_cast<const char2*>(q[0] + t), b = *reinterpret_cast<const char2*>(q[1] + t);
        if (!torus) {
            f0 = field_sum(false, j[0], (float)a.x, j[1], (float)b.x, 0.0f, 0.0f, 0.0f, 0.0f);
            f1 = field_sum(false, j[0], (float)a.y, j[1], (float)b.y, 0.0f, 0.0f, 0.0f, 0.0f);
            return;
        }
        const char2 c = *reinterpret_cast<const char2*>(q[2] + t), d = *reinterpret_cast<const char2*>(q[3] + t);
        f0 = field_sum(true, j[0], (float)a.x, j[1], (float)b.x, j[2], (float)c.x, j[3], (float)d.x);
        f1 = field_sum(true, j[0], (float)a.y, j[1], (float)b.y, j[2], (float)c.y, j[3], (float)d.y);
    }
};

// One line of a site phase (site_phases, worldline.cuh): its spins lp, its
// neighbours' field F, and its replica's seed and (dt, kt, h); load reads a
// thread's pairs of slices and the neighbour lines' in 2-byte words, and
// flips is the Glauber acceptance in logit form, log(u) - log(1 - u) < -dE
// with dE = (-2 s) (dt (F + h) - kt (s_up + s_dn)), for the draw of (tau, i)
// at counter 2 color + parity.
struct SiteLine {
    int8_t* lp;
    SiteField F;
    uint32_t seed, c0;
    float dt, kt, h;
    int i, nvars;

    struct Data {
        float f0[kSitePairs], f1[kSitePairs];  // the field at each pair's even and odd slice
    };

    __device__ SiteLine(int8_t* s, const int32_t* seeds, const Params& q, const Geo& g, int ndir, int color, int x,
                        int y)
        : lp(s + ((size_t)blockIdx.z * g.nvars + x * g.size + y) * g.L),
          F(g, s + (size_t)blockIdx.z * g.nvars * g.L, q.J + (size_t)blockIdx.z * ndir * g.nvars,
            neighbours_at(g, x, y), x * g.size + y),
          seed((uint32_t)__ldg(seeds + blockIdx.z)),
          c0(2u * (uint32_t)color),
          dt(__ldg(q.dt + blockIdx.z)),
          kt(__ldg(q.kt + blockIdx.z)),
          h(__ldg(q.h + blockIdx.z)),
          i(x * g.size + y),
          nvars(g.nvars) {}

    __device__ __forceinline__ void load(int k0, int P, int (&e)[kSitePairs], int (&o)[kSitePairs], Data& nb) const {
#pragma unroll
        for (int c = 0; c < kSitePairs; ++c) {
            const int k = k0 + c;
            const int w = k < P ? *reinterpret_cast<const int16_t*>(lp + 2 * k) : 0x0101;
            e[c] = (int8_t)w;
            o[c] = w >> 8;
            nb.f0[c] = nb.f1[c] = 0.0f;
            if (k < P) F.at2(2 * k, nb.f0[c], nb.f1[c]);
        }
    }

    // whether spin sv at slice tau of the parity (the thread's pair c), with tau neighbours a and b, flips
    __device__ __forceinline__ bool flips(int sv, int a, int b, const Data& nb, int c, int tau, int parity) const {
        const float f = parity ? nb.f1[c] : nb.f0[c];
        const float inner = __fsub_rn(__fmul_rn(dt, __fadd_rn(f, h)), __fmul_rn(kt, (float)(a + b)));
        const float dE = __fmul_rn(-2.0f * (float)sv, inner);
        const float u = uniform(lane_draw31(seed, (uint32_t)(tau * nvars + i), c0 + parity));
        return __fsub_rn(logf(u), logf(__fsub_rn(1.0f, u))) < -dE;
    }
};

// Both site phases of a color in one launch (site_phases, worldline.cuh):
// W = site_lanes(L) threads a time line of the color, kSitePairs pairs of
// slices a thread, in a grid site_grid.
template <int W>
__global__ void __launch_bounds__(kSiteThreads) ladder_site(
    int8_t* __restrict__ s, const int32_t* __restrict__ seeds, Params q, Geo g, int ndir, int color) {
    int x, y;
    const bool live = site_line_of<W>(g, color, x, y);
    const SiteLine ln(s, seeds, q, g, ndir, color, x, y);
    site_phases<W>(ln, g.L, live);
}

// A line's cluster draws for fk_long_* (its Ops): ladder_cluster's three
// functions below (a bond freezes when aligned and u < pb, a head flips its
// cluster when log(u) < -dE, with the slice dE (-2 s) dt (F + h), F from the
// site's neighbour lines and couplings, SiteField). ladder_cluster keeps its
// own lambdas: built on LadderFk it ran 4% slower on the 64^2 ladder at
// L_tau = 60 on an H100 (a line's set-up counts there).
struct LadderFk {
    struct Args {
        const int32_t* seeds;
        Params q;
        int ndir;
    };
    SiteField F;
    uint32_t seed, ctr;
    float dt, h, pb;
    int i, nvars;

    __device__ LadderFk(const int8_t* s, const Args& a, const Geo& g, int r, int i_, uint32_t ctr_)
        : F(g, s + (size_t)r * g.nvars * g.L, a.q.J + (size_t)r * a.ndir * g.nvars, neighbours(g, i_), i_),
          seed((uint32_t)__ldg(a.seeds + r)),
          ctr(ctr_),
          dt(__ldg(a.q.dt + r)),
          h(__ldg(a.q.h + r)),
          pb(__ldg(a.q.pb + r)),
          i(i_),
          nvars(g.nvars) {}
    __device__ __forceinline__ bool frozen(int t) const {
        return uniform(lane_draw31(seed, (uint32_t)(t * nvars + i), ctr)) < pb;
    }
    __device__ __forceinline__ float de(int t, int sv) const {
        return __fmul_rn(__fmul_rn(-2.0f * (float)sv, dt), __fadd_rn(F.at(t), h));
    }
    __device__ __forceinline__ bool flips(int head, float de) const {
        return logf(uniform(lane_draw31(seed, (uint32_t)(head * nvars + i), ctr + 1))) < -de;
    }
};

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

// SiteField::at on the resident plane: Js is the replica's [ndir, nvars] couplings
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

// The swap features on the multi-launch route (pt_swap_features): kFeatThreads
// threads a block, feat_lanes(L, V) a group, up to kFeatWords words of V
// bytes a lane where the line is short enough for one (more up to a warp).
constexpr int kFeatThreads = 256, kFeatWords = 16;

// The threads an item at L slices in words of V bytes: the fewest of 1, 2,
// 4, 8, 16 and 32 that hold a line at kFeatWords words a lane (a warp and
// more words a lane up to L = kMaxL), the whole block past kMaxL.
__host__ __device__ constexpr int feat_lanes(int L, int V) {
    if (L > kMaxL) return kFeatThreads;
    const int need = (L / V + kFeatWords - 1) / kFeatWords;
    int g = 1;
    while (g < need && g < 32) g *= 2;
    return g;
}

template <int V>
__device__ __forceinline__ int feat_word(const int8_t* p) {
    if constexpr (V == 4)
        return *reinterpret_cast<const int*>(p);
    else
        return (int)*reinterpret_cast<const uint16_t*>(p);  // bytes 2 and 3 zero: they add nothing to a dp4a
}

// v summed over the calling group of G threads, in its first thread (0 in the others past a warp).
template <int G>
__device__ __forceinline__ int group_sum(int v) {
    if constexpr (G == kFeatThreads) {
        __shared__ int part[kFeatThreads / 32];
        v = __reduce_add_sync(0xffffffffu, v);
        __syncthreads();  // a former call's reads of part are done
        if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
        __syncthreads();
        v = 0;
        if (threadIdx.x == 0)
            for (int w = 0; w < kFeatThreads / 32; ++w) v += part[w];
        return v;
    } else {
#pragma unroll
        for (int o = G / 2; o; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o, G);
        return v;
    }
}

// grid (chunks of a replica's E + nvars items, R): a group of G threads an
// item, the union edges first, then the time lines; feat [R, E + 2] with its
// slots E and E + 1 zeroed.
template <int G, int V>
__global__ void __launch_bounds__(kFeatThreads) pt_swap_features(
    const int8_t* __restrict__ s, const int32_t* __restrict__ ea, const int32_t* __restrict__ eb,
    int32_t* __restrict__ feat, int nvars, int L, int E) {
    constexpr int kItems = kFeatThreads / G;
    const int r = blockIdx.y, lane = threadIdx.x % G, k = blockIdx.x * kItems + threadIdx.x / G;
    const int8_t* p = s + (size_t)r * nvars * L;
    const int nw = L / V;
    int v = 0, pr = 0;  // an edge's bond products; a line's spin sum and products s_t s_t+1
    if (k < E) {
        const int8_t* a = p + (size_t)__ldg(ea + k) * L;
        const int8_t* b = p + (size_t)__ldg(eb + k) * L;
#pragma unroll 4
        for (int w = lane; w < nw; w += G) v = __dp4a(feat_word<V>(a + w * V), feat_word<V>(b + w * V), v);
    } else if (k < E + nvars) {
        const int8_t* a = p + (size_t)(k - E) * L;
#pragma unroll 4
        for (int w = lane; w < nw; w += G) {
            const int c = feat_word<V>(a + w * V);
            const uint32_t nx = (uint8_t)a[w + 1 == nw ? 0 : (w + 1) * V];  // the next slice, slice 0 after the last
            v = __dp4a(c, 0x01010101, v);
            pr = __dp4a(c, (int)(((uint32_t)c >> 8) | (nx << (8 * (V - 1)))), pr);
        }
    }
    v = group_sum<G>(v);
    pr = group_sum<G>(pr);
    int32_t* f = feat + (size_t)r * (E + 2);
    if (lane == 0 && k < E) f[k] = v;
    if ((blockIdx.x + 1) * kItems <= E) return;  // the whole block: no line among its items
    __shared__ int red[2];
    if (threadIdx.x < 2) red[threadIdx.x] = 0;
    __syncthreads();
    const bool line = lane == 0 && k >= E && k < E + nvars;
    res_block_add(red, 0, line ? v : 0);
    res_block_add(red, 1, line ? (L + pr) / 2 : 0);
    __syncthreads();
    if (threadIdx.x == 0) {
        atomicAdd(f + E, red[0]);
        atomicAdd(f + E + 1, red[1]);
    }
}

template <int V>
cudaError_t launch_features(const int8_t* s, const int32_t* ea, const int32_t* eb, int32_t* feat, int R, int nvars,
                            int L, int E, cudaStream_t st) {
    const int G = feat_lanes(L, V), items = kFeatThreads / G;
    const dim3 grid((E + nvars + items - 1) / items, R);
    switch (G) {
        case 1: pt_swap_features<1, V><<<grid, kFeatThreads, 0, st>>>(s, ea, eb, feat, nvars, L, E); break;
        case 2: pt_swap_features<2, V><<<grid, kFeatThreads, 0, st>>>(s, ea, eb, feat, nvars, L, E); break;
        case 4: pt_swap_features<4, V><<<grid, kFeatThreads, 0, st>>>(s, ea, eb, feat, nvars, L, E); break;
        case 8: pt_swap_features<8, V><<<grid, kFeatThreads, 0, st>>>(s, ea, eb, feat, nvars, L, E); break;
        case 16: pt_swap_features<16, V><<<grid, kFeatThreads, 0, st>>>(s, ea, eb, feat, nvars, L, E); break;
        case 32: pt_swap_features<32, V><<<grid, kFeatThreads, 0, st>>>(s, ea, eb, feat, nvars, L, E); break;
        default: pt_swap_features<kFeatThreads, V><<<grid, kFeatThreads, 0, st>>>(s, ea, eb, feat, nvars, L, E);
    }
    return cudaGetLastError();
}

// The features of s [R, nvars, L] into feat [R, E + 2] on `st`: the memset
// of the S and A slots, then pt_swap_features in words of 4 bytes (2 where
// L % 4 = 2).
cudaError_t swap_features(const int8_t* s, const int32_t* ea, const int32_t* eb, int32_t* feat, int R, int nvars,
                          int L, int E, cudaStream_t st) {
    const cudaError_t e = cudaMemset2DAsync(feat + E, (size_t)(E + 2) * sizeof(int32_t), 0, 2 * sizeof(int32_t), R, st);
    if (e != cudaSuccess) return e;
    return L % 4 ? launch_features<2>(s, ea, eb, feat, R, nvars, L, E, st)
                 : launch_features<4>(s, ea, eb, feat, R, nvars, L, E, st);
}

}  // namespace

// Runs T sweeps on `stream` on s[R, nvars, L]: 4 T launches, or 6 T where
// the line is too long for fk_line's one block (fk_long: the two fk_long_*
// launches a color in place of ladder_cluster, in scratch,
// pmc_long_scratch_bytes of device memory (wl.cu), whose status words are
// zeroed once a call; null otherwise); seeds is
// [T, R] int32 (row t keys sweep t), J
// [R, ndir, nvars] and dt, kt, h, pb [R] f32 as in ops/ladder.py. Draw d of
// every sweep uses counter d: 2c + parity the site phases of color c, 4 + 2c
// and 5 + 2c the bond and head draws of cluster color c. The site phases take
// site_lanes(L) threads a line, the cluster phases fk_group(L) or fk_long_*
// (worldline.cuh); R <= 65535 (fk_grid). With feat (null: none), the swap
// features of the state the sweeps leave (T may be 0) into feat [R, E + 2]
// int32 as ladder_resident_sweeps writes them (ea, eb [E] int32 site indices
// in [0, nvars)): a memset and one launch of pt_swap_features after the
// last sweep. Returns the first launch error, or 0.
extern "C" int ladder_sweeps(void* s, const void* seeds, const void* J, const void* dt, const void* kt,
                             const void* h, const void* pb, void* scratch, const void* ea, const void* eb, void* feat,
                             int R, int nvars, int L, int torus, int size, int T, int E, void* stream) {
    if (L < 4 || L > kLongMaxL || (L & 1) || (nvars & 1) || R > 65535 || E < 0) return (int)cudaErrorInvalidValue;
    const Geo g{torus, size, nvars, L};
    const int ndir = torus ? 2 : 1;
    const Params q{static_cast<const float*>(J), static_cast<const float*>(dt), static_cast<const float*>(kt),
                   static_cast<const float*>(h), static_cast<const float*>(pb)};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    int8_t* sp = static_cast<int8_t*>(s);
    const bool longline = fk_long(L, fk_optin());
    if (longline && !scratch) return (int)cudaErrorInvalidValue;
    const FkLong f = longline ? fk_long_layout(scratch, R, nvars, L) : FkLong{};
    if (longline) {
        const cudaError_t e = fk_long_reset(f, R, st);
        if (e != cudaSuccess) return (int)e;
    }
    const cudaError_t err = by_lanes(L, [&](auto wc) {
        constexpr int W = decltype(wc)::value;
        return by_group(L, [&](auto gc) {
            constexpr int G = decltype(gc)::value;
            const int smem = fk_block_lines(G) * fk_line_bytes(L);
            cudaError_t e = longline ? cudaSuccess
                                     : cudaFuncSetAttribute(ladder_cluster<G>,
                                                            cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
            if (e != cudaSuccess) return e;
            const dim3 grid = fk_grid(g, R, G), sgrid = site_grid(g, R, W);
            for (int t = 0; t < T; ++t) {
                const int32_t* sd = static_cast<const int32_t*>(seeds) + (size_t)t * R;
                const LadderFk::Args fa{sd, q, ndir};
                for (int color = 0; color < 2; ++color) {
                    ladder_site<W><<<sgrid, kSiteThreads, 0, st>>>(sp, sd, q, g, ndir, color);
                    if ((e = cudaGetLastError()) != cudaSuccess) return e;
                }
                for (int color = 0; color < 2; ++color) {
                    if (longline)
                        e = fk_long_phase<LadderFk>(sp, fa, g, R, 4 + 2 * color, color, 2u * t + color + 1u, f, st);
                    else {
                        ladder_cluster<G><<<grid, fk_block_threads(G), smem, st>>>(sp, sd, q, g, ndir, 4 + 2 * color,
                                                                                   color);
                        e = cudaGetLastError();
                    }
                    if (e != cudaSuccess) return e;
                }
            }
            return cudaSuccess;
        });
    });
    if (err != cudaSuccess || !feat) return (int)err;
    return (int)swap_features(sp, static_cast<const int32_t*>(ea), static_cast<const int32_t*>(eb),
                              static_cast<int32_t*>(feat), R, nvars, L, E, st);
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

// The threads a time line of the multi-launch site phases at L slices
// (site_lanes), for measurement.
extern "C" int pmc_site_lanes(int L) { return site_lanes(L); }
