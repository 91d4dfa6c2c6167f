// Trotterized TFIM worldline sweeps on R replicas of a uniform periodic ring
// or square torus, for sm_90a.
//
// Replaces the two Pallas TPU kernels of pyisingmontecarlo_tpu/ops/wl_pallas.py:
// _kernel (plain sweeps, l.330, launched by _call at l.406) and _kernel_sample
// (slice-0 rows staged every freq sweeps, l.346, launched by _call_sample at
// l.449), both built on _build_ops (l.186), as one set of kernels with an
// optional sampling mode. The semantics, the randomness contract and the
// plain PyTorch version it is held to bit for bit are in
// pyisingmontecarlo_tpu_torch/ops/wl.py.
//
// Layout: the state is s[R, nvars, L] int8, so a replica's time line (r, i)
// is L contiguous bytes. Three routes, chosen by shape alone (ops/wl.py,
// choose_route): resident where resident_plan admits the shape (the plane and
// a cluster tile of at least one line per thread, or every line, in the
// card's opt-in shared memory per block, and at most
// RESIDENT_IDLE_SITES_TILED sites that the idle SMs of the launch's last wave
// could have swept), else
// tiled where tiled_plan admits it (a tile and its halo in that memory), else
// multi-launch.
//
// Resident (wl_resident, one launch per call): one block of kResThreads per
// replica holds its plane in shared memory for all T sweeps (resident.cuh):
// four site phases (the block strides over the active (site, tau)), two
// cluster phases (res_cluster: parallel pointer doubling in the JAX kernel's
// order), then the accumulation, each thread keeping its int64 sums of bond
// products, spins and aligned time bonds in registers, added to acc [R, 3]
// once per launch; in sampling mode slice 0 goes to the sample slot after
// every freq-th sweep. 2 ceil(log2 L) + 9 barriers a sweep (one cluster tile).
// Bound: one replica per SM, so it fills only R of the 132 SMs.
//
// Tiled (wl_tiled, one launch per sweep; planes too large for a block, such
// as the 256^2 torus, 2.6 MB a replica): one block of kTileThreads per
// (replica, B x B tile) copies its tile and a halo of 4 sites below and 5
// above from one state buffer into shared memory, runs the whole sweep there
// (tiled.cuh: each phase on the sites of its color up to its rank, the halo's
// updates recomputed exactly; the cluster phases by tile_cluster, whose only
// serial step is each line's walk of its cluster sums), adds the interior's
// statistics to acc [R, 3] with one atomic per value and block, writes slice
// 0 of the interior to the sample slot in sampling mode, and writes the
// interior to the other buffer. 15 barriers a sweep besides the list
// builder's. Bound: integer issue, as below, inflated by the halo's
// recomputed work ((B + 7)^2 / B^2 of the sites in the first site phases, down
// to (B + 1)^2 / B^2 in the last cluster phase), and the serial walk; the
// state moves once in and once out a sweep, the halo read again from L2.
//
// Multi-launch (what neither takes: L_tau so long that no tile of 8 fits,
// and every line past L_tau = kMaxL = 4096, up to the JAX kernel's gate of a
// 16 MiB int32 plane a replica: L_tau = 2^20 on a 4-ring), five launches a
// sweep on the caller's stream:
//
// - wl_site, twice (one per site color): both tau parities of the color in
//   one launch, in place, on ladder_site's schedule (site_phases,
//   worldline.cuh): a group of site_lanes(L) threads a time line of the
//   color, 8 pairs of slices a thread in registers, the even slices and then
//   the odd slices from the updated even ones, a warp taking lines past 512
//   slices in chunks; a grid of (chunks of a row's lines, rows, replicas),
//   so no division finds a line. The line and its 2 or 4 neighbour lines are
//   read in the widest aligned word that divides L (acc_width: 16 bytes at
//   L_tau = 800), the neighbour bytes summed four slices an instruction
//   (__vadd4). Its spatial neighbours have the other color, which the launch
//   does not write. Acceptance compares a 31-bit draw with one of 30 int31
//   thresholds made on the host, kept in shared memory: integers only.
// - wl_cluster, twice (one per color): a group of threads per time line of
//   the color (fk_line, worldline.cuh; a warp up to L = 896, then a block of
//   128, 256 or, past 4096, 512 threads, fk_group), in parallel over tau: the
//   line's spins, bond draws and slice dE read coalesced along tau, the
//   frozen bonds as bit words; the JAX kernel's forward segmented sum by
//   pointer doubling in shared memory, stopped after the round that leaves no
//   longer run of frozen bonds; the heads' decisions, each slice taking its
//   nearest head's. A fully frozen line's total is summed in XLA's CPU order
//   (ops/wl.py, xla_sum_last), its windows of 32 slices in parallel.
//   Additions and products are __fadd_rn / __fmul_rn, so nothing is
//   contracted, and the log is logf (no fast math). Shared memory: about
//   8.6 bytes a slice (fk_line_bytes), 35 KB a line at L = 4096. A line past
//   one block's opt-in shared memory (L > 26,944 on an H100, fk_long) takes
//   the two fk_long_* launches a color of worldline.cuh instead (7 launches
//   a sweep), on the caller's scratch in device memory: the same flips, each
//   run's leaves summed from shared memory where they start, each head
//   folding its leaves (WlFk gives the draws).
// - wl_accumulate, once: a warp per line (both colors) adds the line's
//   tau-sums of bond products (outgoing bonds), spins and aligned time bonds
//   to int64 accumulators [R, 3, nvars]: exact, no atomics (one writer per
//   line). The lanes read the line and its partners' lines in aligned words
//   of up to 16 bytes, coalesced along tau, and sum four slices an
//   instruction with dp4a. In sampling mode the same launch writes slice 0
//   into the sample slot after every freq-th sweep.
//
// What bounds a sweep on an H100: it must hash two draws per spin (the site
// phase's and its time bond's; 22 integer operations each) and do about 18
// more operations per spin, 62 in all. At the 256^2 torus, R=8, L=40 (21 M
// spins) that is 1.3 G operations, 39 us at the 33.5 T int32 op/s peak, while
// reading and writing the 21 MB state once would take 12.5 us at 3.35 TB/s
// (and it stays in the 50 MB L2): integer issue bounds it. The multi-launch
// route passes over the state five times a sweep, its neighbours' words read
// from L2, and its cluster phase does about log2 of
// the longest frozen run more work a slice than a serial walk would (the
// doubling rounds); the tiled route passes
// once and reads every neighbour from shared memory. At the 256-site chain,
// R=64, L=40 (0.66 M spins) the multi-launch route's launches last a few
// microseconds; the resident route takes that shape instead, with no launch
// and no device-memory pass between phases, and barriers in their place.

#include <cstdint>
#include <cuda_runtime.h>

#include "lanerng.cuh"
#include "resident.cuh"
#include "tiled.cuh"
#include "worldline.cuh"

namespace {

constexpr float kLogScale = 4.656612873077393e-10f;  // 2^-31

// Spatial neighbour sum at slice t; p is the replica's [nvars, L].
__device__ __forceinline__ int nbr_sum(const int8_t* p, const Nbrs& nb, int L, int t) {
    int b = p[nb.j[0] * L + t] + p[nb.j[1] * L + t];
    if (nb.j[2] >= 0) b += p[nb.j[2] * L + t] + p[nb.j[3] * L + t];
    return b;
}

__device__ __forceinline__ float log_uniform(uint32_t u31) {
    return logf(__fmul_rn(__fadd_rn(__int2float_rn((int)u31), 0.5f), kLogScale));
}

// The 16 bytes p[0, 16) as four words, read in words of V bytes (V of 2, 4,
// 8, 16; p a multiple of V): the words at or past n bytes from p (n a
// multiple of V) are not read and hold pad.
template <int V>
__device__ __forceinline__ void load16(const int8_t* p, int n, uint32_t pad, uint32_t (&u)[4]) {
    if constexpr (V == 16) {
        const uint4 v = n > 0 ? *reinterpret_cast<const uint4*>(p) : make_uint4(pad, pad, pad, pad);
        u[0] = v.x, u[1] = v.y, u[2] = v.z, u[3] = v.w;
    } else if constexpr (V == 8) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            const uint2 v = 8 * j < n ? *reinterpret_cast<const uint2*>(p + 8 * j) : make_uint2(pad, pad);
            u[2 * j] = v.x, u[2 * j + 1] = v.y;
        }
    } else if constexpr (V == 4) {
#pragma unroll
        for (int j = 0; j < 4; ++j) u[j] = 4 * j < n ? *reinterpret_cast<const uint32_t*>(p + 4 * j) : pad;
    } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const uint32_t h = 2 * j < n ? *reinterpret_cast<const uint16_t*>(p + 2 * j) : pad & 0xffffu;
            u[j >> 1] = j & 1 ? u[j >> 1] | h << 16 : h;
        }
    }
}

// One line of wl_site (site_phases, worldline.cuh): its spins lp, its spatial
// neighbour lines q (ring i + 1, i - 1, twice; torus all four), its replica's
// seed, the phase's draw counter and the threshold table in shared memory.
// load reads a thread's 16 slices and the neighbour lines' in words of V bytes
// (the line starts at a multiple of V, and a thread's slices at a multiple of
// 16 in it) and adds the neighbour lines' bytes four slices an instruction
// (__vadd4: a sum of at most four +-1 fits a byte); flips compares the draw of
// (tau, i) at counter ctr + parity with
// thr[15 (s > 0) + 3 ((B + 4) >> 1) + ((s_up + s_dn + 2) >> 1)], B the
// neighbour sum, all in integers.
template <int V>
struct WlSiteLine {
    int8_t* lp;
    const int8_t* q[4];
    const int32_t* thr;
    uint32_t seed, ctr;
    int i, nvars, L, torus;

    struct Data {
        uint32_t w[4];  // byte j of word m: the neighbour sum at the thread's slice 4 m + j
    };

    __device__ WlSiteLine(int8_t* s, const int32_t* seeds, const int32_t* thr_s, const Geo& g, uint32_t ctr_, int x,
                          int y)
        : thr(thr_s),
          seed((uint32_t)__ldg(seeds + blockIdx.z)),
          ctr(ctr_),
          i(x * g.size + y),
          nvars(g.nvars),
          L(g.L),
          torus(g.torus) {
        int8_t* p = s + (size_t)blockIdx.z * g.nvars * g.L;
        lp = p + (size_t)i * L;
        const Nbrs n = neighbours_at(g, x, y);
#pragma unroll
        for (int k = 0; k < 4; ++k) q[k] = p + (size_t)n.j[g.torus ? k : k & 1] * L;
    }

    __device__ __forceinline__ void load(int k0, int, int (&e)[kSitePairs], int (&o)[kSitePairs], Data& d) const {
        const int s0 = 2 * k0, n = L - s0;
        uint32_t u[4], v[4];
        load16<V>(lp + s0, n, 0x01010101u, u);
        load16<V>(q[0] + s0, n, 0u, d.w);
        load16<V>(q[1] + s0, n, 0u, v);
#pragma unroll
        for (int m = 0; m < 4; ++m) d.w[m] = __vadd4(d.w[m], v[m]);
        if (torus) {
            load16<V>(q[2] + s0, n, 0u, v);
#pragma unroll
            for (int m = 0; m < 4; ++m) d.w[m] = __vadd4(d.w[m], v[m]);
            load16<V>(q[3] + s0, n, 0u, v);
#pragma unroll
            for (int m = 0; m < 4; ++m) d.w[m] = __vadd4(d.w[m], v[m]);
        }
#pragma unroll
        for (int c = 0; c < kSitePairs; ++c) {
            e[c] = (int8_t)(u[c >> 1] >> (16 * (c & 1)));
            o[c] = (int8_t)(u[c >> 1] >> (16 * (c & 1) + 8));
        }
    }

    // whether spin sv at slice tau of the parity (the thread's pair c), with tau neighbours a and b, flips
    __device__ __forceinline__ bool flips(int sv, int a, int b, const Data& d, int c, int tau, int parity) const {
        const int B = (int8_t)(d.w[c >> 1] >> (8 * (2 * (c & 1) + parity)));
        const int th = thr[15 * (sv > 0) + 3 * ((B + 4) >> 1) + ((a + b + 2) >> 1)];
        return (int)lane_draw31(seed, (uint32_t)(tau * nvars + i), ctr + parity) <= th;
    }
};

// Both site phases of a color in one launch (site_phases, worldline.cuh):
// W = site_lanes(L) threads a time line of the color, kSitePairs pairs of
// slices a thread, words of V = acc_width bytes, in a grid site_grid; parity
// p draws at counter ctr + p.
template <int W, int V>
__global__ void __launch_bounds__(kSiteThreads) wl_site(
    int8_t* __restrict__ s, const int32_t* __restrict__ seeds, const int32_t* __restrict__ thr, Geo g, uint32_t ctr,
    int color) {
    __shared__ int32_t ts[30];
    if (threadIdx.x < 30) ts[threadIdx.x] = __ldg(thr + threadIdx.x);
    __syncthreads();
    int x, y;
    const bool live = site_line_of<W>(g, color, x, y);
    const WlSiteLine<V> ln(s, seeds, ts, g, ctr, x, y);
    site_phases<W>(ln, g.L, live);
}

// Launches wl_site<W, V> on `st`.
template <int W>
cudaError_t launch_site(int8_t* s, const int32_t* seeds, const int32_t* thr, const Geo& g, int R, int V,
                        uint32_t ctr, int color, cudaStream_t st) {
    const dim3 grid = site_grid(g, R, W);
    switch (V) {
        case 16: wl_site<W, 16><<<grid, kSiteThreads, 0, st>>>(s, seeds, thr, g, ctr, color); break;
        case 8: wl_site<W, 8><<<grid, kSiteThreads, 0, st>>>(s, seeds, thr, g, ctr, color); break;
        case 4: wl_site<W, 4><<<grid, kSiteThreads, 0, st>>>(s, seeds, thr, g, ctr, color); break;
        default: wl_site<W, 2><<<grid, kSiteThreads, 0, st>>>(s, seeds, thr, g, ctr, color); break;
    }
    return cudaGetLastError();
}

// A line's cluster draws for fk_long_* (its Ops): wl_cluster's three
// functions below (the bond (t, t + 1) freezes when its int31 draw is below
// pb, the slice's dE is the host table's, the head flips its cluster when
// log((u + 0.5) / 2^31) < -dE). wl_cluster keeps its own lambdas and
// __restrict__ parameters: built on WlFk and its Args, it compiled to other
// shared-memory loops and ran 9% slower at L_tau = 800 on an H100.
struct WlFk {
    struct Args {
        const int32_t* seeds;
        const float* cde;
        int32_t pb;
    };
    const int8_t* p;
    const float* cde;
    Nbrs nb;
    uint32_t seed, ctr;
    int32_t pb;
    int i, nvars, L;

    __device__ WlFk(const int8_t* s, const Args& a, const Geo& g, int r, int i_, uint32_t ctr_)
        : p(s + (size_t)r * g.nvars * g.L),
          cde(a.cde),
          nb(neighbours(g, i_)),
          seed((uint32_t)__ldg(a.seeds + r)),
          ctr(ctr_),
          pb(a.pb),
          i(i_),
          nvars(g.nvars),
          L(g.L) {}
    __device__ __forceinline__ bool frozen(int t) const {
        return (int)lane_draw31(seed, (uint32_t)(t * nvars + i), ctr) < pb;
    }
    __device__ __forceinline__ float de(int t, int sv) const {
        return __ldg(cde + 5 * (sv > 0) + ((nbr_sum(p, nb, L, t) + 4) >> 1));
    }
    __device__ __forceinline__ bool flips(int head, float de) const {
        return log_uniform(lane_draw31(seed, (uint32_t)(head * nvars + i), ctr + 1)) < -de;
    }
};

// grid fk_grid: a group of G threads per time line of the color
// (fk_block_lines(G) lines a block): fk_line (worldline.cuh) with the bond
// frozen when its int31 draw is below pb, the slice's dE from the host table,
// and the head's flip when log((u + 0.5) / 2^31) < -dE.
template <int G>
__global__ void __launch_bounds__(fk_block_threads(G)) wl_cluster(
    int8_t* __restrict__ s, const int32_t* __restrict__ seeds, const float* __restrict__ cde,
    int32_t pb, Geo g, uint32_t ctr, int color) {
    extern __shared__ __align__(16) unsigned char fk_smem[];
    int x, y;
    if (!fk_site<G>(g, color, x, y)) return;  // the whole group
    const int L = g.L, nvars = g.nvars, r = blockIdx.z, i = x * g.size + y;
    const int8_t* p = s + (size_t)r * nvars * L;
    const uint32_t seed = (uint32_t)__ldg(seeds + r);
    const Nbrs nb = neighbours_at(g, x, y);
    fk_line<G>(
        s + ((size_t)r * nvars + i) * L, fk_smem + (threadIdx.x / G) * fk_line_bytes(L), L,
        [&](int t) { return (int)lane_draw31(seed, (uint32_t)(t * nvars + i), ctr) < pb; },
        [&](int t, int sv) { return __ldg(cde + 5 * (sv > 0) + ((nbr_sum(p, nb, L, t) + 4) >> 1)); },
        [&](int head, float de) {
            return log_uniform(lane_draw31(seed, (uint32_t)(head * nvars + i), ctr + 1)) < -de;
        });
}

// The accumulation: a warp per time line (both colors), kAccLines lines a
// block, in a grid of (chunks of a row's lines, rows, replicas): a torus has
// `size` rows of `size` lines, a ring one row of nvars, so a warp finds its
// line with no division. The lanes read words of V bytes (V slices) of the
// line and of its outgoing bonds' partners (ring i+1; torus y+1 and x+1),
// coalesced along tau; a word holds V / 4 (at least one) 32-bit chunks of
// four signed bytes, and dp4a (__dp4a: four byte products and their sum)
// gives a chunk's bond products, spin sum and aligned-bond products
// s_t s_{t+1}, the chunk shifted down one byte with the next byte on top
// (the next lane's first byte by a shuffle; the line's slice 0 after its
// last slice). The aligned bonds are (L + sum s_t s_{t+1}) / 2. The sums
// stay int32 (|x| <= 2 L) and a warp reduction gives lane 0 the line's
// three, which it adds into acc[r, k, i] int64: one writer per line, no
// atomics. V is the widest of 16, 8, 4, 2 that divides L and the state's
// address (acc_width), since a line starts at a multiple of L.
constexpr int kAccLines = 8;

template <int V>
struct Word {
    static constexpr int N = V >= 4 ? V / 4 : 1;  // 32-bit chunks
    static constexpr int top = 8 * (V >= 4 ? 3 : V - 1);  // the last byte's shift in the last chunk
    uint32_t c[N];

    __device__ __forceinline__ void load(const int8_t* p) {
        if constexpr (V == 16) {
            const uint4 v = *reinterpret_cast<const uint4*>(p);
            c[0] = v.x, c[1] = v.y, c[2] = v.z, c[3] = v.w;
        } else if constexpr (V == 8) {
            const uint2 v = *reinterpret_cast<const uint2*>(p);
            c[0] = v.x, c[1] = v.y;
        } else if constexpr (V == 4) {
            c[0] = *reinterpret_cast<const uint32_t*>(p);
        } else {
            c[0] = *reinterpret_cast<const uint16_t*>(p);
        }
    }
};

template <int V>
__global__ void __launch_bounds__(32 * kAccLines) wl_accumulate(
    const int8_t* __restrict__ s, long long* __restrict__ acc, int8_t* __restrict__ stage, int stage_stride, Geo g) {
    const int y = blockIdx.x * kAccLines + (threadIdx.x >> 5);
    if (y >= (g.torus ? g.size : g.nvars)) return;  // the whole warp
    const int lane = threadIdx.x & 31, x = blockIdx.y, r = blockIdx.z, L = g.L, n = g.nvars, m = g.size;
    const int i = g.torus ? x * m + y : y;
    const int8_t* p = s + (size_t)r * n * L;
    const int8_t* lp = p + (size_t)i * L;
    // the partners of the site's outgoing bonds
    const int8_t* q1 = p + (size_t)(g.torus ? x * m + (y + 1 == m ? 0 : y + 1) : (y + 1 == n ? 0 : y + 1)) * L;
    const int8_t* q2 = g.torus ? p + (size_t)((x + 1 == m ? 0 : x + 1) * m + y) * L : lp;  // torus only
    const int nw = L / V;
    long long* a = acc + (size_t)r * 3 * n + i;
    long long a0 = 0, a1 = 0, a2 = 0;  // the accumulators, read while the line's words arrive
    if (lane == 0) a0 = a[0], a1 = a[n], a2 = a[2 * (size_t)n];
    int sb = 0, sh = 0, pr = 0;
    uint32_t s0 = 0;
#pragma unroll 2
    for (int b = 0; b < nw; b += 32) {
        const int w = b + lane;
        const bool in = w < nw;
        Word<V> u;
#pragma unroll
        for (int k = 0; k < Word<V>::N; ++k) u.c[k] = 0;
        if (in) u.load(lp + w * V);
        uint32_t nx = __shfl_down_sync(0xffffffffu, u.c[0] & 0xffu, 1);
        if (b == 0) s0 = __shfl_sync(0xffffffffu, u.c[0] & 0xffu, 0);
        if (in && (lane == 31 || w + 1 == nw)) nx = w + 1 == nw ? s0 : (uint8_t)lp[(w + 1) * V];
        if (in) {
            Word<V> b1, b2;
            b1.load(q1 + w * V);
            if (g.torus) b2.load(q2 + w * V);
#pragma unroll
            for (int k = 0; k < Word<V>::N; ++k) {
                const int c = (int)u.c[k];
                const uint32_t up = k + 1 < Word<V>::N ? __funnelshift_r(u.c[k], u.c[k + 1 < Word<V>::N ? k + 1 : k], 8)
                                                        : (u.c[k] >> 8) | (nx << Word<V>::top);
                sh = __dp4a(c, 0x01010101, sh);
                sb = __dp4a(c, (int)b1.c[k], sb);
                if (g.torus) sb = __dp4a(c, (int)b2.c[k], sb);
                pr = __dp4a(c, (int)up, pr);
            }
        }
    }
    sb = __reduce_add_sync(0xffffffffu, sb);
    sh = __reduce_add_sync(0xffffffffu, sh);
    pr = __reduce_add_sync(0xffffffffu, pr);
    if (lane == 0) {
        a[0] = a0 + sb;
        a[n] = a1 + sh;
        a[2 * (size_t)n] = a2 + (L + pr) / 2;
        if (stage) stage[(size_t)r * stage_stride + i] = (int8_t)s0;
    }
}

// acc_width: the word of wl_accumulate, the widest of 16, 8, 4 and 2 bytes
// that divides L and the state's address (0: the address is odd).
inline int acc_width(int L, const void* s) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(s);
    for (int v = 16; v >= 2; v >>= 1)
        if (L % v == 0 && a % v == 0) return v;
    return 0;
}

// The grid of wl_accumulate: (chunks of a row's lines, rows, replicas).
inline dim3 acc_grid(const Geo& g, int R) {
    const int per_row = g.torus ? g.size : g.nvars;
    return dim3((per_row + kAccLines - 1) / kAccLines, g.torus ? g.size : 1, R);
}

// Launches wl_accumulate<acc_width> on `st`.
inline cudaError_t launch_accumulate(const int8_t* s, long long* acc, int8_t* stage, int stage_stride, const Geo& g,
                                     int R, int V, cudaStream_t st) {
    const dim3 grid = acc_grid(g, R);
    switch (V) {
        case 16: wl_accumulate<16><<<grid, 32 * kAccLines, 0, st>>>(s, acc, stage, stage_stride, g); break;
        case 8: wl_accumulate<8><<<grid, 32 * kAccLines, 0, st>>>(s, acc, stage, stage_stride, g); break;
        case 4: wl_accumulate<4><<<grid, 32 * kAccLines, 0, st>>>(s, acc, stage, stage_stride, g); break;
        default: wl_accumulate<2><<<grid, 32 * kAccLines, 0, st>>>(s, acc, stage, stage_stride, g); break;
    }
    return cudaGetLastError();
}

constexpr int kWlParamBytes = 30 * 4 + 10 * 4;  // thr, cde (ops/wl.py WL_PARAM_BYTES)

// grid: one block per replica (resident.cuh), T sweeps of the plain or the
// sampling mode; acc [R, 3] int64 is added to once, samples [R, nsamples,
// nvars] or null.
__global__ void __launch_bounds__(kResThreads, 1) wl_resident(
    int8_t* __restrict__ s, const int32_t* __restrict__ seeds, const int32_t* __restrict__ thr_g,
    const float* __restrict__ cde_g, int32_t pb, Geo g, long long* __restrict__ acc, int8_t* __restrict__ samples,
    int T, int freq, int nsamples, int tile) {
    extern __shared__ __align__(16) unsigned char smem[];
    Res b;
    b.base = smem;
    const int r = blockIdx.x, tid = threadIdx.x;
    int8_t* gs = s + (size_t)r * g.nvars * g.L;
    res_load(b, gs, g, kWlParamBytes, tile);
    int32_t* thr = reinterpret_cast<int32_t*>(b.params());
    float* cde = reinterpret_cast<float*>(b.params() + 30 * 4);
    if (tid < 30) thr[tid] = thr_g[tid];
    if (tid < 10) cde[tid] = cde_g[tid];
    __syncthreads();
    const int L = g.L, nvars = g.nvars, half = b.half;
    const uint32_t seed = (uint32_t)seeds[r];
    int8_t* pl = b.pl();
    const ushort4* nb = b.nb();
    const Walk sw(L >> 1);
    long long sb = 0, sh = 0, al = 0;
    int since = 0, slot = 0;  // sweeps since the last sample, samples taken
    for (int t = 0; t < T; ++t) {
        const uint32_t base = 8u * (uint32_t)t;
        for (int color = 0; color < 2; ++color)
            for (int parity = 0; parity < 2; ++parity) {
                const uint32_t ctr = base + 2 * color + parity;
                const uint16_t* sites = b.sites() + color * half;
                for (Walk w = sw; w.row < half; w.next()) {
                    const int i = sites[w.row], tau = 2 * w.col + parity;
                    int8_t* lp = pl + i * L;
                    const int sv = lp[tau];
                    const int ud = lp[tau + 1 == L ? 0 : tau + 1] + lp[tau == 0 ? L - 1 : tau - 1];
                    const ushort4 n = nb[i];
                    int bs = pl[n.x * L + tau] + pl[n.y * L + tau];
                    if (g.torus) bs += pl[n.z * L + tau] + pl[n.w * L + tau];
                    const int th = thr[15 * (sv > 0) + 3 * ((bs + 4) >> 1) + ((ud + 2) >> 1)];
                    if ((int)lane_draw31(seed, (uint32_t)(tau * nvars + i), ctr) <= th) lp[tau] = (int8_t)(-sv);
                }
                __syncthreads();
            }
        for (int color = 0; color < 2; ++color) {
            const uint32_t ctr = base + 4 + 2 * color;
            res_cluster(
                b, sw, color,
                [&](int i, int t) { return (int)lane_draw31(seed, (uint32_t)(t * nvars + i), ctr) < pb; },
                [&](int i, int t, int sv) {
                    const ushort4 n = nb[i];
                    int bs = pl[n.x * L + t] + pl[n.y * L + t];
                    if (g.torus) bs += pl[n.z * L + t] + pl[n.w * L + t];
                    return cde[5 * (sv > 0) + ((bs + 4) >> 1)];
                },
                [&](int i, int head, float de) {
                    return log_uniform(lane_draw31(seed, (uint32_t)(head * nvars + i), ctr + 1)) < -de;
                });
        }
        // statistics of the sweep's state: bond products over the outgoing
        // bonds (ring i+1; torus y+1 and x+1), spins, aligned time bonds
        int psb = 0, psh = 0, pal = 0;
        for (Walk w = sw; w.row < nvars; w.next()) {  // pairs of slices (t, t + 1)
            const int t = 2 * w.col;
            const char2 v = reinterpret_cast<const char2*>(pl)[w.e];
            const int nx = pl[t + 2 == L ? 2 * w.e + 2 - L : 2 * w.e + 2];
            const ushort4 n = nb[w.row];
            const char2 p1 = *reinterpret_cast<const char2*>(pl + n.x * L + t);
            const char2 p2 = g.torus ? *reinterpret_cast<const char2*>(pl + n.z * L + t) : make_char2(0, 0);
            psb += v.x * (p1.x + p2.x) + v.y * (p1.y + p2.y);
            psh += v.x + v.y;
            pal += (v.x == v.y) + (v.y == nx);
        }
        sb += psb;
        sh += psh;
        al += pal;
        if (samples && ++since == freq && slot < nsamples) {
            int8_t* out = samples + ((size_t)r * nsamples + slot) * nvars;
            for (int i = tid; i < nvars; i += kResThreads) out[i] = pl[i * L];
            since = 0;
            ++slot;
        }
        __syncthreads();
    }
    long long v[3] = {sb, sh, al};
    for (int k = 0; k < 3; ++k) {
        long long x = v[k];
        for (int o = 16; o; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
        if ((tid & 31) == 0)
            atomicAdd(reinterpret_cast<unsigned long long*>(acc + 3 * r + k), (unsigned long long)x);
    }
    res_store(b, gs);
}

// grid: one block of kTileThreads per (replica, tile) (tiled.cuh), one sweep
// t (draw counter base = 8 t) from s_in to s_out; acc [R, 3] int64 is added
// to once per block; stage is the sample slot of this sweep ([R, stage_stride]
// rows of nvars) or null. Depth: the line walk's counter levels for this L.
template <int Depth>
__global__ void __launch_bounds__(kTileThreads, 2) wl_tiled(
    const int8_t* __restrict__ s_in, int8_t* __restrict__ s_out, const int32_t* __restrict__ seeds,
    const int32_t* __restrict__ thr_g, const float* __restrict__ cde_g, int32_t pb, Geo g, int B,
    long long* __restrict__ acc, int8_t* __restrict__ stage, int stage_stride, uint32_t base) {
    extern __shared__ __align__(16) unsigned char smem[];
    const TileLayout o = tile_layout(g.torus, B, g.L, kWlParamBytes);
    const Tile t = tile_of(g, B);
    const int tid = threadIdx.x, L = g.L, nvars = g.nvars, wy = t.wy, torus = g.torus;
    int8_t* pl = reinterpret_cast<int8_t*>(smem + o.plane);
    int* gi = reinterpret_cast<int*>(smem + o.gi);
    uint16_t* list = reinterpret_cast<uint16_t*>(smem + o.list);
    int* start = reinterpret_cast<int*>(smem + o.start);
    int32_t* thr = reinterpret_cast<int32_t*>(smem + o.params);
    float* cde = reinterpret_cast<float*>(smem + o.params + 30 * 4);
    int* red = reinterpret_cast<int*>(smem + o.red);
    if (tid < 30) thr[tid] = thr_g[tid];
    if (tid < 10) cde[tid] = cde_g[tid];
    if (tid < 3) red[tid] = 0;
    for (int ln = tid; ln < tile_max_lines(g.torus, B); ln += kTileThreads)
        reinterpret_cast<int*>(smem + o.first)[ln] = L;
    tile_lists(g, t, gi, list, start, reinterpret_cast<int*>(smem + o.wcnt));
    const size_t plane_off = (size_t)t.r * nvars * L;
    by_unit(L, [&](auto unit) { tile_load<decltype(unit)>(pl, s_in + plane_off, gi, t.sites, L); });
    __syncthreads();
    const uint32_t seed = (uint32_t)seeds[t.r];
    // four site phases, each on the sites of its color up to its rank
    for (int color = 0; color < 2; ++color)
        for (int parity = 0; parity < 2; ++parity) {
            const uint32_t ctr = base + 2 * color + parity;
            const uint16_t* ls = list + start[color * kRanks];
            const int n = start[color * kRanks + tile_rank(2 * color + parity) + 1] - start[color * kRanks];
            for (TileWalk w(L >> 1); w.row < n; w.next()) {
                const int k = ls[w.row], tau = 2 * w.col + parity;
                int8_t* lp = pl + k * L;
                const int sv = lp[tau];
                const int ud = lp[tau + 1 == L ? 0 : tau + 1] + lp[tau == 0 ? L - 1 : tau - 1];
                const int bs = tile_nsum(pl, k, wy, L, tau, torus);
                const int th = thr[15 * (sv > 0) + 3 * ((bs + 4) >> 1) + ((ud + 2) >> 1)];
                if ((int)lane_draw31(seed, (uint32_t)(tau * nvars + gi[k]), ctr) <= th) lp[tau] = (int8_t)(-sv);
            }
            __syncthreads();
        }
    // two cluster phases, on the lines of the color up to its rank
    const TileCluster cl{reinterpret_cast<int*>(smem + o.first),
                         reinterpret_cast<int*>(smem + o.first) + tile_max_lines(g.torus, B),
                         reinterpret_cast<uint16_t*>(smem + o.order), reinterpret_cast<uint32_t*>(smem + o.masks),
                         reinterpret_cast<float*>(smem + o.qde), reinterpret_cast<uint16_t*>(smem + o.qhead)};
    for (int color = 0; color < 2; ++color) {
        const uint32_t ctr = base + 4 + 2 * color;
        const uint16_t* ls = list + start[color * kRanks];
        const int n = start[color * kRanks + tile_rank(4 + color) + 1] - start[color * kRanks];
        auto bond_frozen = [&](int k, int tau) {
            return (int)lane_draw31(seed, (uint32_t)(tau * nvars + gi[k]), ctr) < pb;
        };
        auto head_flips = [&](int k, int head, float de) {
            return log_uniform(lane_draw31(seed, (uint32_t)(head * nvars + gi[k]), ctr + 1)) < -de;
        };
        tile_cluster<Depth>(pl, L, wy, torus, ls, n, cde, cl, bond_frozen, head_flips);
    }
    // statistics of the interior (rank 0 of both colors): bond products over
    // the outgoing bonds (ring k + 1; torus k + 1 and k + wy), spins, aligned
    // time bonds; slice 0 to the sample slot
    const int n0 = start[1] - start[0], n1 = start[kRanks + 1] - start[kRanks];
    const uint16_t* l0 = list + start[0];
    const uint16_t* l1 = list + start[kRanks];
    int psb = 0, psh = 0, pal = 0;
    for (TileWalk w(L >> 1); w.row < n0 + n1; w.next()) {  // pairs (tau, tau + 1)
        const int k = w.row < n0 ? l0[w.row] : l1[w.row - n0], tau = 2 * w.col;
        const int8_t* lp = pl + k * L;
        const char2 v = *reinterpret_cast<const char2*>(lp + tau);
        const int nx = lp[tau + 2 == L ? 0 : tau + 2];
        const char2 p1 = *reinterpret_cast<const char2*>(lp + L + tau);
        const char2 p2 = torus ? *reinterpret_cast<const char2*>(lp + wy * L + tau) : make_char2(0, 0);
        psb += v.x * (p1.x + p2.x) + v.y * (p1.y + p2.y);
        psh += v.x + v.y;
        pal += (v.x == v.y) + (v.y == nx);
    }
    if (stage)
        for (int j = tid; j < n0 + n1; j += kTileThreads) {
            const int k = j < n0 ? l0[j] : l1[j - n0];
            stage[(size_t)t.r * stage_stride + gi[k]] = pl[k * L];
        }
    res_block_add(red, 0, psb);
    res_block_add(red, 1, psh);
    res_block_add(red, 2, pal);
    by_unit(L, [&](auto unit) { tile_store<decltype(unit)>(pl, s_out + plane_off, g, t, L); });
    __syncthreads();
    if (tid < 3)
        atomicAdd(reinterpret_cast<unsigned long long*>(acc + 3 * t.r + tid), (unsigned long long)(long long)red[tid]);
}

}  // namespace

// Runs T sweeps on `stream` on s[R, nvars, L], s at an even address (the
// words of wl_site and wl_accumulate): 5 T launches, or 7 T where the line is
// too long for fk_line's one block (fk_long: the two fk_long_* launches a
// color in place of wl_cluster, in scratch, pmc_long_scratch_bytes of device
// memory, whose status words are zeroed once a call; null otherwise). thr [30] int32, cde [10] f32 and pb as in ops/wl.py; acc
// [R, 3, nvars] int64 is added to; samples is [R, nsamples, nvars] int8 or
// null, slot k written after sweep (k + 1) * freq. Draw d of sweep t uses
// counter 8 t + d: 2c + parity the site phases of color c, 4 + 2c and 5 + 2c
// the bond and head draws of cluster color c. The site phases take
// site_lanes(L) threads a line, the cluster phases fk_group(L) or fk_long_*
// (worldline.cuh); R <= 65535 (site_grid, fk_grid). Returns the first launch
// error, or 0.
extern "C" int wl_sweeps(void* s, const void* seeds, const void* thr, const void* cde, int pb,
                         void* acc, void* samples, void* scratch, int R, int nvars, int L, int torus, int size,
                         int T, int freq, int nsamples, void* stream) {
    if (L < 4 || L > kLongMaxL || (L & 1) || (nvars & 1) || R > 65535) return (int)cudaErrorInvalidValue;
    const Geo g{torus, size, nvars, L};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    int8_t* sp = static_cast<int8_t*>(s);
    const int32_t* sd = static_cast<const int32_t*>(seeds);
    const int32_t* th = static_cast<const int32_t*>(thr);
    const WlFk::Args fa{sd, static_cast<const float*>(cde), pb};
    const int V = acc_width(L, s);
    if (V == 0) return (int)cudaErrorMisalignedAddress;
    const bool longline = fk_long(L, fk_optin());
    if (longline && !scratch) return (int)cudaErrorInvalidValue;
    const FkLong f = longline ? fk_long_layout(scratch, R, nvars, L) : FkLong{};
    if (longline) {
        const cudaError_t e = fk_long_reset(f, R, st);
        if (e != cudaSuccess) return (int)e;
    }
    return (int)by_lanes(L, [&](auto wc) {
        constexpr int W = decltype(wc)::value;
        return by_group(L, [&](auto gc) {
            constexpr int G = decltype(gc)::value;
            const int smem = fk_block_lines(G) * fk_line_bytes(L);
            cudaError_t e = longline ? cudaSuccess
                                     : cudaFuncSetAttribute(wl_cluster<G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                            smem);
            if (e != cudaSuccess) return e;
            for (int t = 0; t < T; ++t) {
                const uint32_t base = 8u * (uint32_t)t;
                for (int color = 0; color < 2; ++color)
                    if ((e = launch_site<W>(sp, sd, th, g, R, V, base + 2 * color, color, st)) != cudaSuccess)
                        return e;
                for (int color = 0; color < 2; ++color) {
                    if (longline)
                        e = fk_long_phase<WlFk>(sp, fa, g, R, base + 4 + 2 * color, color, 2u * t + color + 1u, f,
                                                st);
                    else {
                        wl_cluster<G><<<fk_grid(g, R, G), fk_block_threads(G), smem, st>>>(
                            sp, sd, static_cast<const float*>(cde), pb, g, base + 4 + 2 * color, color);
                        e = cudaGetLastError();
                    }
                    if (e != cudaSuccess) return e;
                }
                int8_t* stage = nullptr;
                if (samples && freq > 0 && (t + 1) % freq == 0 && (t + 1) / freq <= nsamples)
                    stage = static_cast<int8_t*>(samples) + (size_t)((t + 1) / freq - 1) * nvars;
                e = launch_accumulate(sp, static_cast<long long*>(acc), stage, nsamples * nvars, g, R, V, st);
                if (e != cudaSuccess) return e;
            }
            return cudaSuccess;
        });
    });
}

// The resident route: T sweeps in one launch of R blocks on `stream`, with
// tile lines per cluster tile and smem bytes of shared memory as
// ops/wl.resident_plan gives them (refused unless they match this file's
// layout). acc is [R, 3] int64, added to; the other arguments as wl_sweeps.
extern "C" int wl_resident_sweeps(void* s, const void* seeds, const void* thr, const void* cde, int pb, void* acc,
                                  void* samples, int R, int nvars, int L, int torus, int size, int T, int freq,
                                  int nsamples, int tile, int smem, void* stream) {
    if (L < 4 || L > kMaxL || (L & 1) || (nvars & 1) || nvars > 65535 || tile < 1 || tile > nvars / 2 ||
        res_layout(nvars, L, kWlParamBytes, tile).bytes != smem)
        return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(wl_resident, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    wl_resident<<<R, kResThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<int8_t*>(s), static_cast<const int32_t*>(seeds), static_cast<const int32_t*>(thr),
        static_cast<const float*>(cde), pb, Geo{torus, size, nvars, L}, static_cast<long long*>(acc),
        static_cast<int8_t*>(samples), T, samples ? freq : 0, samples ? nsamples : 0, tile);
    return (int)cudaGetLastError();
}

// The tiled route: T sweeps, one launch each, of R x tiles blocks on
// `stream`, with tiles of side `tile` and smem bytes of shared memory as
// ops/wl.tiled_plan gives them (refused unless they match this file's
// layout). Sweep t reads s (t = 0) or the buffer the sweep before wrote, and
// writes a (t even) or b (t odd): the result is in a when T is odd, in b
// when T is even. s is not modified. acc is [R, 3] int64, added to; the other
// arguments as wl_sweeps.
extern "C" int wl_tiled_sweeps(const void* s, void* a, void* b, const void* seeds, const void* thr, const void* cde,
                               int pb, void* acc, void* samples, int R, int nvars, int L, int torus, int size, int T,
                               int freq, int nsamples, int tile, int smem, void* stream) {
    const int side = torus ? size : nvars;
    if (L < 4 || L > kMaxL || (L & 1) || (nvars & 1) || R < 1 || tile < 1 ||
        tile + kHaloLo + kHaloHi > side || tile_box_sites(torus, tile) > 65535 ||
        tile_layout(torus, tile, L, kWlParamBytes).bytes != smem)
        return (int)cudaErrorInvalidValue;
    const long long tiles = torus ? (long long)((side + tile - 1) / tile) * ((side + tile - 1) / tile)
                                  : (side + tile - 1) / tile;
    if (tiles * R >= (1LL << 31)) return (int)cudaErrorInvalidValue;
    const bool shallow = L < 128;  // counts below 128 need tree_depth(127) = 7 counter levels
    cudaError_t e = cudaFuncSetAttribute(shallow ? wl_tiled<tree_depth(127)> : wl_tiled<tree_depth(kMaxL)>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    const Geo g{torus, size, nvars, L};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int8_t* in = static_cast<const int8_t*>(s);
    for (int t = 0; t < T; ++t) {
        int8_t* out = static_cast<int8_t*>(t & 1 ? b : a);
        int8_t* stage = nullptr;
        if (samples && freq > 0 && (t + 1) % freq == 0 && (t + 1) / freq <= nsamples)
            stage = static_cast<int8_t*>(samples) + (size_t)((t + 1) / freq - 1) * nvars;
        auto kernel = shallow ? wl_tiled<tree_depth(127)> : wl_tiled<tree_depth(kMaxL)>;
        kernel<<<(unsigned)(tiles * R), kTileThreads, smem, st>>>(
            in, out, static_cast<const int32_t*>(seeds), static_cast<const int32_t*>(thr),
            static_cast<const float*>(cde), pb, g, tile, static_cast<long long*>(acc), stage, nsamples * nvars,
            8u * (uint32_t)t);
        if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
        in = out;
    }
    return 0;
}

// The opt-in shared memory per block of a device, in bytes (negative: the
// CUDA error), for the resident routes' gate.
extern "C" int pmc_smem_optin(int device) {
    int v = 0;
    const cudaError_t e = cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    return e == cudaSuccess ? v : -(int)e;
}

// The threads a time line of the multi-launch cluster phases at L slices
// (fk_group), or 0 where the line takes fk_long_* on the current device, for
// measurement.
extern "C" int pmc_cluster_group(int L) { return fk_long(L, fk_optin()) ? 0 : fk_group(L); }

// The bytes of scratch that wl_sweeps and ladder_sweeps take where the line
// is too long for one block (fk_long_bytes; 0 where it is not).
extern "C" long long pmc_long_scratch_bytes(int R, int nvars, int L) {
    return fk_long(L, fk_optin()) ? (long long)fk_long_bytes(R, nvars, L) : 0;
}
