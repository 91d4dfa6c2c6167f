// What the worldline kernels (wl.cu, ladder.cu) share: the layout of
// R replicas of a periodic ring or square torus, s[R, nvars, L] int8 (a time
// line (r, i) is L contiguous bytes), a fully frozen line's total in XLA's
// order (XlaSum fed one slice at a time; xla_total by a block), a
// cluster's sum in the order of the JAX kernels' pointer doubling fed one
// slice at a time (TreeSum), and the multi-launch route's two phases of one
// line by a group of threads: the site phases of a color, both tau parities
// in one launch (site_phases: 8 pairs of slices a thread, wl_site and
// ladder_site giving the loads and the decision), and the Fortuin-Kasteleyn
// time-line cluster update, either by a group of threads holding the line in
// shared memory (fk_line: a warp, or a whole block for long lines), which
// runs the JAX kernels' own pointer doubling, or, for a line too long for one
// block's shared memory, by five launches over the line in global memory
// (fk_long_*: segments of kLongWords words, each run summed leaf by leaf from
// its head). The resident route, one block per replica with its plane in
// shared memory, is in resident.cuh, the tiled route in tiled.cuh;
// ops/wl.choose_route picks the route by shape.
#pragma once

#include <climits>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

// The longest line of the resident and tiled routes (their planes and line
// buffers in shared memory); the multi-launch route takes any line up to
// kLongMaxL, the longest the TPU kernels' gates admit (2^22 spins a replica
// over at least 4 sites on the worldline; 10^6 on the ladder).
constexpr int kMaxL = 4096;
constexpr int kLongMaxL = 1 << 20;

// TreeSum's levels for counts up to n: floor(log2 n) + 1.
__host__ __device__ constexpr int tree_depth(int n) { return n > 1 ? 1 + tree_depth(n >> 1) : 1; }

struct Geo {
    int torus;  // 0: ring of nvars sites; 1: size x size torus, i = x * size + y
    int size;
    int nvars;
    int L;
};

// The k-th site of a color.
__device__ __forceinline__ int site_of(const Geo& g, int k, int color) {
    if (!g.torus) return 2 * k + color;
    const int half = g.size >> 1;
    const int x = k / half;
    return x * g.size + 2 * (k - x * half) + ((x + color) & 1);
}

// The spatial neighbours of site i: ring (i + 1, i - 1, -1, -1); torus
// (x + 1, x - 1, y + 1, y - 1).
struct Nbrs {
    int j[4];
};

// The same of site (x, y) of a torus, i = x * size + y, or of site y of a
// ring.
__device__ __forceinline__ Nbrs neighbours_at(const Geo& g, int x, int y) {
    if (!g.torus) return {{y + 1 == g.nvars ? 0 : y + 1, y == 0 ? g.nvars - 1 : y - 1, -1, -1}};
    const int n = g.size;
    return {{(x + 1 == n ? 0 : x + 1) * n + y, (x == 0 ? n - 1 : x - 1) * n + y,
             x * n + (y + 1 == n ? 0 : y + 1), x * n + (y == 0 ? n - 1 : y - 1)}};
}

__device__ __forceinline__ Nbrs neighbours(const Geo& g, int i) {
    const int x = g.torus ? i / g.size : 0;
    return neighbours_at(g, x, i - x * g.size);
}

// A fully frozen line's total dE in XLA's CPU order (ops/wl.py,
// xla_sum_last), fed one slice at a time in order: windows of 32 slices,
// padded evenly at both ends, each summed from 0, then the window sums by the
// same rule (the resident and tiled routes' L <= kMaxL needs at most two
// levels; fk_line's frozen sum takes two, to 32,768 slices, fk_long_*'s
// xla_total any number). The pads add +0, which changes no comparison.
struct XlaSum {
    bool small, two;
    int lo1, lo2, w_cur = 0, v_cur = 0;
    float p1 = 0.0f, p2 = 0.0f, tot = 0.0f;

    __device__ explicit XlaSum(int L) : small(L <= 32) {
        const int nw1 = (L + 31) / 32;
        two = nw1 > 32;
        lo1 = (32 * nw1 - L) / 2;
        lo2 = two ? (32 * ((nw1 + 31) / 32) - nw1) / 2 : 0;
    }
    __device__ void flush() {  // window w_cur is complete
        if (two) {
            const int v = (w_cur + lo2) >> 5;
            if (v != v_cur) {
                tot = __fadd_rn(tot, p2);
                p2 = 0.0f;
                v_cur = v;
            }
            p2 = __fadd_rn(p2, p1);
        } else {
            tot = __fadd_rn(tot, p1);
        }
        p1 = 0.0f;
    }
    __device__ void add(int t, float v) {
        if (small) {
            tot = __fadd_rn(tot, v);
            return;
        }
        const int w = (t + lo1) >> 5;
        if (w != w_cur) {
            flush();
            w_cur = w;
        }
        p1 = __fadd_rn(p1, v);
    }
    __device__ float total() {
        if (small) return tot;
        flush();
        return two ? __fadd_rn(tot, p2) : tot;
    }
};

// The forward segmented sum of a cluster's slice dE in the JAX kernels'
// order, fed one slice at a time from the cluster's head. Their pointer
// doubling over the whole ring gives, at a head h with n slices,
// R(h, n) = F(h, p) + R(h + p, n - p), p the largest power of two below n, F a
// perfect binary tree of additions. Merging equal blocks like a binary
// counter leaves exactly the blocks F of n's binary expansion (blk[b] holds
// the sum of a block of 2^b slices while bit b of count is set), which summed
// right-nested are R: the same f32 additions in the same order, done once per
// slice instead of log2 L times. Every index of blk is a constant once the
// loops over b are unrolled, so blk stays in registers, and the loops
// branch on nothing: the threads of a warp, each at its own place in its own
// cluster, stay together (the additions whose results are not kept are
// computed all the same). Depth: the levels, floor(log2 n) + 1 at least.
template <int Depth>
struct TreeSum {
    float blk[Depth] = {};
    unsigned count = 0;

    __device__ __forceinline__ void add(float v) {
        const int merges = __ffs(~count) - 1;  // the trailing ones of count
#pragma unroll
        for (int b = 0; b < Depth; ++b) {
            const float m = __fadd_rn(blk[b], v);
            v = b < merges ? m : v;
        }
#pragma unroll
        for (int b = 0; b < Depth; ++b) blk[b] = b == merges ? v : blk[b];
        ++count;
    }
    // R, right-nested; with a tail, R nested onto it (tail + the smallest
    // block first), as a run continued by a shorter one sums
    __device__ __forceinline__ float total(float tail = 0.0f, bool has_tail = false) const {
        float acc = tail;
        bool first = !has_tail;
#pragma unroll
        for (int b = 0; b < Depth; ++b) {
            const bool set = (count >> b) & 1u;
            const float m = first ? blk[b] : __fadd_rn(blk[b], acc);
            acc = set ? m : acc;
            first = first && !set;
        }
        return acc;
    }
};

// The multi-launch route's site phases of a color (wl_site, ladder_site), W
// threads a time line of the color, in place: the even slices, then the odd
// slices from the updated even ones. The other color's lines are not written
// in the launch, so the odd slices read what a launch per parity would read.
// A thread holds kSitePairs consecutive pairs of slices (2k, 2k + 1) of a
// chunk of W kSitePairs pairs in registers: thread t the pairs
// k = b + kSitePairs t + c of chunk b. W is site_lanes(L): the fewest of 4,
// 8, 16 and 32 threads that hold the line in one chunk, else 32 and the line
// in chunks. Parity 0 goes up the chunks, pair k's even slice from its odd
// slice and the odd slice before it (pair k - 1's: the same thread, the lane
// below by a shuffle, the chunk below's last carried in a register; at k = 0
// the line's last slice). Parity 1 goes down from the last chunk, still in
// registers, pair k's odd slice from its even slice and the next pair's
// updated even slice (the same thread, the lane above, the chunk above's
// first carried from the chunk before; at the line's last pair pair 0's,
// kept from parity 0), and reads each chunk below it again, which the same
// threads wrote. A line of one chunk (every W < 32, so known when compiling)
// reads its slices once. kSiteThreads / W lines a block in a grid of (chunks
// of a row's lines of the color, rows, replicas), as fk_grid. A thread pays
// its line's set-up (the neighbour lines, seed and parameters) once for its
// pairs, and takes a chunk's decisions with no branch before it writes a
// flip, so that their draws overlap; 8 pairs a thread beat 2, 4 and 16 on the
// 64^2 ladder at L_tau = 60 (PERF.md). A group past its row's end computes a
// copy of the row's last line and writes nothing, so that every lane of a
// warp takes part in the shuffles.
constexpr int kSitePairs = 8, kSiteThreads = 128;

__host__ __device__ constexpr int site_lanes(int L) {
    const int need = ((L >> 1) + kSitePairs - 1) / kSitePairs;
    return need <= 4 ? 4 : need <= 8 ? 8 : need <= 16 ? 16 : 32;
}

inline dim3 site_grid(const Geo& g, int R, int W) {
    const int per_row = g.torus ? g.size >> 1 : g.nvars >> 1, lines = kSiteThreads / W;
    return dim3((per_row + lines - 1) / lines, g.torus ? g.size : 1, R);
}

// Calls fn(std::integral_constant<int, site_lanes(L)>{}).
template <class Fn>
cudaError_t by_lanes(int L, Fn fn) {
    switch (site_lanes(L)) {
        case 4: return fn(std::integral_constant<int, 4>{});
        case 8: return fn(std::integral_constant<int, 8>{});
        case 16: return fn(std::integral_constant<int, 16>{});
        default: return fn(std::integral_constant<int, 32>{});
    }
}

// The site (x, y) of the line that the calling group of W threads owns in
// site_grid, and whether it is live: past its row's end, the row's last line
// of the color (the group computes it and writes nothing).
template <int W>
__device__ __forceinline__ bool site_line_of(const Geo& g, int color, int& x, int& y) {
    const int per_row = g.torus ? g.size >> 1 : g.nvars >> 1;
    const int jr = blockIdx.x * (kSiteThreads / W) + threadIdx.x / W;
    const bool live = jr < per_row;
    x = blockIdx.y;
    y = 2 * (live ? jr : per_row - 1) + (g.torus ? (x + color) & 1 : color);
    return live;
}

// Both site phases of the line ln by its group of W threads, on the schedule
// above. Line gives lp (its L spins), Data (a thread's neighbour data for its
// kSitePairs pairs), load(k0, P, e, o, nb) (the spins of pairs k0 .. k0 +
// kSitePairs - 1 into e (even slices) and o (odd), +1 past the line's P
// pairs, and their neighbour data) and flips(sv, a, b, nb, c, tau, parity)
// (whether spin sv at slice tau of the thread's pair c flips, its tau
// neighbours a and b).
template <int W, class Line>
__device__ __forceinline__ void site_phases(const Line& ln, int L, bool live) {
    constexpr int C = kSitePairs, N = W * C;
    constexpr unsigned kAll = 0xffffffffu;
    const int P = L >> 1, t = threadIdx.x % W;
    const int last = W < 32 ? 0 : (P - 1) / N * N;  // the last chunk's first pair
    int e[C], o[C];  // the pairs' slices
    typename Line::Data nb;
    int before = ln.lp[L - 1], first = 0;  // the odd slice before the chunk; pair 0's even slice, updated
    for (int b = 0;; b += N) {  // parity 0, up the chunks
        ln.load(b + C * t, P, e, o, nb);
        const int below = __shfl_up_sync(kAll, o[C - 1], 1, W);
#pragma unroll
        for (int c = 0; c < C; ++c) {  // every pair's decision, with no branch, then the flips
            const int k = b + C * t + c;
            const int po = c > 0 ? o[c > 0 ? c - 1 : c] : t == 0 ? before : below;
            const bool flip = ln.flips(e[c], o[c], po, nb, c, 2 * k, 0);
            if (flip & live & (k < P)) {
                e[c] = -e[c];
                ln.lp[2 * k] = (int8_t)e[c];
            }
        }
        if (b == 0) first = __shfl_sync(kAll, e[0], 0, W);
        if (b == last) break;
        before = __shfl_sync(kAll, o[C - 1], W - 1, W);
    }
    int after = first;  // the even slice after the chunk's last pair, updated
    for (int b = last;; b -= N) {  // parity 1, down the chunks
        const int above = __shfl_down_sync(kAll, e[0], 1, W);
#pragma unroll
        for (int c = 0; c < C; ++c) {
            const int k = b + C * t + c;
            const int ne = k + 1 == P ? first : c + 1 < C ? e[c + 1 < C ? c + 1 : c] : t == W - 1 ? after : above;
            const bool flip = ln.flips(o[c], ne, e[c], nb, c, 2 * k + 1, 1);
            if (flip & live & (k < P)) ln.lp[2 * k + 1] = (int8_t)(-o[c]);
        }
        if (b == 0) break;
        after = __shfl_sync(kAll, e[0], 0, W);
        ln.load(b - N + C * t, P, e, o, nb);
    }
}

// The multi-launch route's cluster phase: a group of G threads owns one time
// line, G = 32 (a warp; kFkWarpLines lines a block) or G = 128 or 256 (the
// whole block); fk_group picks G by L. The group keeps its line
// in shared memory (fk_line_bytes): two f32 run-sum buffers of 32 W slices
// and five bit arrays of W words, W = ceil(L / 32) (the frozen bonds, the
// spins' signs, two reach buffers, the first of which then holds the heads'
// decisions, and the heads), and a word for the group's decision. Warp w of
// the group takes the words w, w + G / 32, ...: slice t = 32 word + lane, so
// that a ballot gives a word.
constexpr int kFkWarpLines = 4;

__host__ __device__ constexpr int fk_block_threads(int G) { return G == 32 ? 32 * kFkWarpLines : G; }
__host__ __device__ constexpr int fk_block_lines(int G) { return G == 32 ? kFkWarpLines : 1; }
__host__ __device__ inline int fk_line_bytes(int L) { return (276 * ((L + 31) >> 5) + 4 + 15) & ~15; }

// The grid of a cluster phase: (chunks of a row's lines of the color, rows,
// replicas); a torus has `size` rows of size / 2 lines of a color, a ring
// one row of nvars / 2, so a group finds its line with no division.
inline dim3 fk_grid(const Geo& g, int R, int G) {
    const int per_row = g.torus ? g.size >> 1 : g.nvars >> 1;
    return dim3((per_row + fk_block_lines(G) - 1) / fk_block_lines(G), g.torus ? g.size : 1, R);
}

// The site (x, y) of the line that the calling group owns in fk_grid, or
// false past its row's end (the whole group).
template <int G>
__device__ __forceinline__ bool fk_site(const Geo& g, int color, int& x, int& y) {
    const int j = blockIdx.x * fk_block_lines(G) + threadIdx.x / G;
    x = blockIdx.y;
    y = 2 * j + (g.torus ? (x + color) & 1 : color);
    return j < (g.torus ? g.size >> 1 : g.nvars >> 1);
}

// Threads a time line at L slices: a warp up to 28 words of 32 slices, a
// block of 128 threads up to 64 words, 256 up to 128 words (L = 4096), then
// PMC_FK_GROUP_LONG (256, 512 or 1024; a build for measurement may set it)
// while the line fits one block's shared memory (fk_line_bytes) and 32,768
// slices, past which the line takes fk_long_* (fk_long). Every size from 32 to 1024 was timed in turns on
// an H100 (PERF.md): a warp was fastest at L = 60, 700 and 800, 128 threads
// from 900 to 2048, 256 at 4096, 512 at 10,240 (against 256 and 1024).
#ifndef PMC_FK_GROUP_LONG
#define PMC_FK_GROUP_LONG 512
#endif
static_assert(PMC_FK_GROUP_LONG == 256 || PMC_FK_GROUP_LONG == 512 || PMC_FK_GROUP_LONG == 1024,
              "PMC_FK_GROUP_LONG: 256, 512 or 1024 threads a line");

__host__ __device__ constexpr int fk_group(int L) {
    return L <= 896 ? 32 : L <= 2048 ? 128 : L <= kMaxL ? 256 : PMC_FK_GROUP_LONG;
}

// Calls fn(std::integral_constant<int, fk_group(L)>{}).
template <class Fn>
cudaError_t by_group(int L, Fn fn) {
    switch (fk_group(L)) {
        case 32: return fn(std::integral_constant<int, 32>{});
        case 128: return fn(std::integral_constant<int, 128>{});
        case 256: return fn(std::integral_constant<int, 256>{});
        case 512: return fn(std::integral_constant<int, 512>{});
        default: return fn(std::integral_constant<int, 1024>{});
    }
}

// The group's barrier, and whether p holds on any of its threads (a barrier too).
template <int G>
__device__ __forceinline__ void fk_sync() {
    if constexpr (G == 32)
        __syncwarp();
    else
        __syncthreads();
}
template <int G>
__device__ __forceinline__ bool fk_any(bool p) {
    if constexpr (G == 32) {
        __syncwarp();
        return __any_sync(0xffffffffu, p);
    } else {
        return __syncthreads_or(p);
    }
}

template <class T>
__device__ __forceinline__ void fk_swap(T*& a, T*& b) {
    T* x = a;
    a = b;
    b = x;
}

__device__ __forceinline__ bool fk_bit(const uint32_t* b, int x) { return (b[x >> 5] >> (x & 31)) & 1u; }

// The total of x[0..n) in XLA's CPU order (ops/wl.xla_sum_last) by the
// calling group of G threads (fk_sync<G> its barrier; fk_long_decide's
// block), on its thread 0 (the others get 0): while more than 32 terms remain, windows of 32 padded evenly
// at both ends (the pads add +0, which changes no sum, so they are skipped),
// each summed from 0 by one thread, their sums the next level's terms in
// scratch (n / 31 floats at most); then the last 32 or fewer one by one. At L
// = 2^20 that is three levels of windows.
template <int G>
__device__ float xla_total(const float* x, int n, float* scratch) {
    const int gt = threadIdx.x % G;
    while (n > 32) {
        const int m = (n + 31) >> 5, lo = (32 * m - n) >> 1;
        for (int v = gt; v < m; v += G) {
            const int a = 32 * v - lo;
            float p = 0.0f;  // never -0, so a pad's +0 would leave it as it is
            for (int j = max(0, -a); j < 32 && a + j < n; ++j) p = __fadd_rn(p, x[a + j]);
            scratch[v] = p;
        }
        fk_sync<G>();
        x = scratch;
        scratch += m;
        n = m;
    }
    float tot = 0.0f;
    if (gt == 0)
        for (int j = 0; j < n; ++j) tot = __fadd_rn(tot, x[j]);
    return tot;
}

// One FK cluster update of the time line lp[0..L) by a group of G threads
// with sm, fk_line_bytes(L) of shared memory. bond_frozen(t): the aligned
// bond (t, t+1) freezes (the caller's draw); slice_de(t, s): the diagonal dE
// of flipping slice t, which holds s; head_flips(head, dE): the cluster
// headed at head, of total dE, flips. Every thread of the group calls it
// (a warp's 32 lanes, or the whole block).
//
// The JAX kernels' phase (ops/wl.fk_flips), in parallel over the slices:
// (1) each slice's spin, its bond draw and its dE (the neighbours read
// coalesced along tau); the frozen bonds and the signs as bit words.
// (2) A fully frozen line is one cluster headed at tau = 0, whose total is
// summed in XLA's CPU order (XlaSum's, ops/wl.xla_sum_last): the windows of 32
// slices in parallel, then the window sums by the same rule; the head
// decides and the line flips whole or not. (3) Else the forward segmented
// sum by pointer doubling, acc[t] += reach[t] ? acc[t + k] : 0 and
// reach[t] &= reach[t + k] for k = 1, 2, 4, ... around the ring, double
// buffered: the JAX sums addition for addition. It stops after the round
// that leaves no reach bit set (no longer run of frozen bonds), since every
// later round would leave the sums as they are, and after ceil(log2 L)
// rounds at most. (4) The decision at each head (after a thawed bond): its
// log-uniform is drawn there only; heads and decisions as bit words. (5)
// Each slice takes the decision of its nearest head at or before it,
// cyclically (found with __clz in its word, else in the words before it),
// and flips: the set that the JAX kernels' forward doubling of the
// decisions reaches. Additions are __fadd_rn: nothing is contracted.
template <int G, class BondFrozen, class SliceDE, class HeadFlips>
__device__ __forceinline__ void fk_line(int8_t* lp, unsigned char* sm, int L, BondFrozen bond_frozen,
                                        SliceDE slice_de, HeadFlips head_flips) {
    constexpr int NW = G / 32;  // warps of the group
    const int W = (L + 31) >> 5;
    const int lane = threadIdx.x & 31, gt = threadIdx.x % G, w0 = gt >> 5;
    float* acc0 = reinterpret_cast<float*>(sm);
    float* acc1 = acc0 + 32 * W;
    uint32_t* act = reinterpret_cast<uint32_t*>(acc1 + 32 * W);  // bond (t, t + 1) frozen
    uint32_t* up = act + W;                                       // spin t is +1
    uint32_t* b0 = up + W;
    uint32_t* b1 = b0 + W;
    uint32_t* c0 = b1 + W;
    int* flag = reinterpret_cast<int*>(c0 + W);
    // (1)
    bool thawed = false;
    for (int w = w0; w < W; w += NW) {
        const int t = 32 * w + lane;
        const bool in = t < L;
        const int sv = in ? lp[t] : 1;
        int nx = __shfl_down_sync(0xffffffffu, sv, 1);
        if (in && (lane == 31 || t + 1 == L)) nx = lp[t + 1 == L ? 0 : t + 1];
        const bool a = in & (sv == nx) & bond_frozen(t);  // every lane draws: no branch
        acc0[t] = in ? slice_de(t, sv) : 0.0f;
        const uint32_t am = __ballot_sync(0xffffffffu, a), um = __ballot_sync(0xffffffffu, sv > 0);
        if (lane == 0) {
            act[w] = am;
            up[w] = um;
        }
        thawed |= in && !a;
    }
    if (!fk_any<G>(thawed)) {
        // (2) XLA's order: windows of 32 slices, padded evenly at both ends
        // (the pads add +0, which changes no sum), each summed from 0; then
        // the W window sums by the same rule (L <= 4096: W <= 128, so at most
        // four windows of windows), each level in acc1
        float* part = acc1;
        const int n2 = (W + 31) >> 5;
        if (L > 32)
            for (int v = gt; v < W; v += G) {
                const int t0 = 32 * v - (32 * W - L) / 2;
                float p = 0.0f;  // never -0, so a pad's +0 leaves it as it is
#pragma unroll
                for (int j = 0; j < 32; ++j) p = __fadd_rn(p, t0 + j >= 0 && t0 + j < L ? acc0[t0 + j] : 0.0f);
                part[v] = p;
            }
        fk_sync<G>();
        if (W > 32)
            for (int v = gt; v < n2; v += G) {
                const int x0 = 32 * v - (32 * n2 - W) / 2;
                float p = 0.0f;
                for (int j = max(0, -x0); j < 32 && x0 + j < W; ++j) p = __fadd_rn(p, part[x0 + j]);
                part[W + v] = p;
            }
        fk_sync<G>();
        if (gt == 0) {
            const float* v = L <= 32 ? acc0 : W <= 32 ? part : part + W;
            const int n = L <= 32 ? L : W <= 32 ? W : n2;
            float tot = 0.0f;
            for (int x = 0; x < n; ++x) tot = __fadd_rn(tot, v[x]);
            *flag = head_flips(0, tot);
        }
        fk_sync<G>();
        if (*flag)
            for (int w = w0; w < W; w += NW) {
                const int t = 32 * w + lane;
                if (t < L) lp[t] = (int8_t)(fk_bit(up, t) ? -1 : 1);
            }
        return;
    }
    // (3) the forward segmented sum; reach starts as the frozen bonds
    const int K = 32 - __clz(L - 1);  // ceil(log2 L), L >= 4
    float *as = acc0, *ad = acc1;
    const uint32_t* rs = act;
    uint32_t* rd = b0;
    for (int step = 0, k = 1; step < K; ++step, k <<= 1) {
        bool more = false;
        for (int w = w0; w < W; w += NW) {
            const int t = 32 * w + lane;
            const bool in = t < L;
            const int u = !in ? t : t + k < L ? t + k : t + k - L;
            const float a = as[t], b = as[u];  // t < 32 W: a slice past L holds what no sum reads
            const bool rt = in && ((rs[w] >> lane) & 1u), r = rt && fk_bit(rs, u);
            ad[t] = rt ? __fadd_rn(a, b) : a;
            const uint32_t m = __ballot_sync(0xffffffffu, r);
            if (lane == 0) rd[w] = m;
            more |= r;
        }
        const bool again = fk_any<G>(more);
        fk_swap(as, ad);
        rs = rd;
        rd = rd == b0 ? b1 : b0;
        if (!again) break;
    }
    // (4) the heads (after a thawed bond) into c0 and their decisions into b0
    bool flips = false;
    for (int w = w0; w < W; w += NW) {
        const int t = 32 * w + lane;
        const bool head = t < L && !fk_bit(act, t == 0 ? L - 1 : t - 1);
        const bool f = head && head_flips(t, as[t]);
        const uint32_t hm = __ballot_sync(0xffffffffu, head), fm = __ballot_sync(0xffffffffu, f);
        if (lane == 0) {
            c0[w] = hm;
            b0[w] = fm;
        }
        flips |= f;
    }
    if (!fk_any<G>(flips)) return;
    // (5) each slice takes the decision of its nearest head at or before it,
    // cyclically (the line has one at least): in its word, else the last head
    // of the words before it; then the flips
    for (int w = w0; w < W; w += NW) {
        const int t = 32 * w + lane;
        uint32_t m = c0[w] & (0xffffffffu >> (31 - lane));
        int x = w;
        for (int j = 1; !m; ++j) {
            x = w - j < 0 ? w - j + W : w - j;
            m = c0[x];
        }
        if (t < L && (b0[x] >> (31 - __clz(m))) & 1u) lp[t] = (int8_t)(fk_bit(up, t) ? -1 : 1);
    }
}

// The multi-launch route's cluster phase for a line too long for one block's
// shared memory (fk_line_bytes(L) past the card's opt-in bytes: L > 26,944
// on an H100), in global memory: five launches a color, each over
// (segments of kLongWords words of 32 slices, lines of the color, replicas)
// with blocks of kLongThreads threads, warp w of a block taking the words w,
// w + 8, ... of its segment, slice t = 32 word + lane. They compute what
// fk_line computes (ops/wl.fk_flips), summing each cluster from its head
// instead of by pointer doubling: the doubling's sum at a head h of a run of
// n slices is the right-nested sum of the perfect binary trees of n's binary
// expansion laid from h (TreeSum), which splits at kLongLeaf slices into
// leaves of kLongLeaf slices at relative multiples of kLongLeaf from h, the
// perfect trees of leaves of the blocks of n / kLongLeaf, nested onto the
// run's last n % kLongLeaf slices. So each slice at a relative multiple of
// kLongLeaf sums its leaf (or the run's tail) alone, and each head folds its
// leaves: n + n / kLongLeaf additions a run, where the doubling does up to
// n log2 n.
//
// 1. fk_long_scan: each slice's bond draw and dE (de), the heads (after a
//    thawed bond; a lane 0 draws the bond before its word again) as bit
//    words (hw), each segment's first and last head (sf, sl).
// 2. fk_long_carry, a warp a line: for each segment the last head before it
//    (cl) and the first after it (cf), around the ring (max and min scans);
//    -1 everywhere for a line with no head (fully frozen).
// 3. fk_long_leaves: each slice finds its run (its nearest head at or before
//    it and the next head after it: in its word, in the words of its segment
//    before or after it, else the carries) and, at a relative multiple of
//    kLongLeaf, sums the leaf or the tail from it (TreeSum) into lf.
// 4. fk_long_decide: each head folds its leaves onto its tail (TreeSum) and
//    decides (its draw, as fk_line's head); a fully frozen line is summed in
//    XLA's order (xla_total, by segment 0's block) and decided at tau = 0;
//    the decisions as bit words (dw).
// 5. fk_long_flip: each slice takes its nearest head's decision and flips.
//
// The caller's Ops type gives a line's draws: Ops(s, args, g, r, i, ctr),
// frozen(t) (the aligned bond (t, t + 1) freezes), de(t, sv) (the slice's dE)
// and flips(head, dE), as fk_line's three functions; only site i's own line
// is written, in fk_long_flip, and its neighbours' (the other color) only
// read. Additions are __fadd_rn: nothing is contracted.
constexpr int kLongWords = 32, kLongThreads = 256, kLongLeaf = 256;

// The scratch of one color's phase, per line of the color (line index
// r * nl + j, j the line's rank in its color, site_of): de and lf (32 W f32
// each, W = ceil(L / 32)), hw and dw (W words), sf, sl, cf, cl (nseg ints).
struct FkLong {
    float* de;
    float* lf;
    uint32_t* hw;
    uint32_t* dw;
    int *sf, *sl, *cf, *cl;
    int L, W, nseg, nl;

    __device__ size_t line() const { return (size_t)blockIdx.z * nl + blockIdx.y; }
};

// The bytes of FkLong for R replicas of nvars sites at L slices, and its
// arrays laid out from base.
inline size_t fk_long_bytes(int R, int nvars, int L) {
    const size_t W = (L + 31) >> 5, nseg = (W + kLongWords - 1) / kLongWords, lines = (size_t)R * (nvars >> 1);
    return lines * (2 * 32 * W * 4 + 2 * W * 4 + 4 * nseg * 4);
}

inline FkLong fk_long_layout(void* base, int R, int nvars, int L) {
    FkLong f;
    f.L = L;
    f.W = (L + 31) >> 5;
    f.nseg = (f.W + kLongWords - 1) / kLongWords;
    f.nl = nvars >> 1;
    const size_t lines = (size_t)R * f.nl;
    f.de = static_cast<float*>(base);
    f.lf = f.de + lines * 32 * f.W;
    f.hw = reinterpret_cast<uint32_t*>(f.lf + lines * 32 * f.W);
    f.dw = f.hw + lines * f.W;
    f.sf = reinterpret_cast<int*>(f.dw + lines * f.W);
    f.sl = f.sf + lines * f.nseg;
    f.cf = f.sl + lines * f.nseg;
    f.cl = f.cf + lines * f.nseg;
    return f;
}

inline dim3 fk_long_grid(const FkLong& f, int R) { return dim3(f.nseg, f.nl, R); }

// 1.
template <class Ops>
__global__ void __launch_bounds__(kLongThreads) fk_long_scan(const int8_t* __restrict__ s, typename Ops::Args a,
                                                             Geo g, uint32_t ctr, int color, FkLong f) {
    __shared__ int first, last;
    const int r = blockIdx.z, i = site_of(g, blockIdx.y, color), L = g.L, lane = threadIdx.x & 31;
    const Ops ops(s, a, g, r, i, ctr);
    const int8_t* lp = s + ((size_t)r * g.nvars + i) * L;
    const size_t ln = f.line();
    float* de = f.de + ln * 32 * f.W;
    if (threadIdx.x == 0) first = INT_MAX, last = -1;
    __syncthreads();
    const int w1 = min(f.W, (int)(blockIdx.x + 1) * kLongWords);
    for (int w = blockIdx.x * kLongWords + (threadIdx.x >> 5); w < w1; w += kLongThreads / 32) {
        const int t = 32 * w + lane;
        const bool in = t < L;
        const int sv = in ? lp[t] : 1;
        int nx = __shfl_down_sync(0xffffffffu, sv, 1);
        if (in && (lane == 31 || t + 1 == L)) nx = lp[t + 1 == L ? 0 : t + 1];
        const bool fr = in & (sv == nx) & ops.frozen(t);  // every lane draws: no branch
        if (in) de[t] = ops.de(t, sv);
        bool before = __shfl_up_sync(0xffffffffu, fr, 1);  // the bond (t - 1, t) frozen
        if (lane == 0) {
            const int tp = t == 0 ? L - 1 : t - 1;
            before = lp[tp] == sv && ops.frozen(tp);
        }
        const uint32_t hm = __ballot_sync(0xffffffffu, in && !before);
        if (lane == 0) {
            f.hw[ln * f.W + w] = hm;
            if (hm) {
                atomicMin(&first, 32 * w + __ffs(hm) - 1);
                atomicMax(&last, 32 * w + 31 - __clz(hm));
            }
        }
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        f.sf[ln * f.nseg + blockIdx.x] = first == INT_MAX ? -1 : first;
        f.sl[ln * f.nseg + blockIdx.x] = last;
    }
}

// 2. grid (1, lines of the color, replicas), a warp a line.
__global__ void __launch_bounds__(32) fk_long_carry(FkLong f) {
    const size_t ln = f.line();
    const int* sf = f.sf + ln * f.nseg;
    const int* sl = f.sl + ln * f.nseg;
    int* cf = f.cf + ln * f.nseg;
    int* cl = f.cl + ln * f.nseg;
    const int lane = threadIdx.x, n = f.nseg;
    int lo = INT_MAX, hi = -1;  // the line's first and last head
    for (int x = lane; x < n; x += 32) {
        if (sf[x] >= 0) lo = min(lo, sf[x]);
        hi = max(hi, sl[x]);
    }
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = __reduce_max_sync(0xffffffffu, hi);
    int run = -1;  // the last head of the segments before this round's
    for (int b = 0; b < n; b += 32) {
        int v = b + lane < n ? sl[b + lane] : -1;
        for (int o = 1; o < 32; o <<= 1) {
            const int u = __shfl_up_sync(0xffffffffu, v, o);
            if (lane >= o) v = max(v, u);
        }
        int ex = __shfl_up_sync(0xffffffffu, v, 1);
        ex = max(lane == 0 ? -1 : ex, run);
        if (b + lane < n) cl[b + lane] = ex >= 0 ? ex : hi;
        run = max(run, __shfl_sync(0xffffffffu, v, 31));
    }
    run = INT_MAX;  // the first head of the segments after this round's
    for (int b = (n - 1) / 32 * 32; b >= 0; b -= 32) {
        int v = b + lane < n && sf[b + lane] >= 0 ? sf[b + lane] : INT_MAX;
        for (int o = 1; o < 32; o <<= 1) {
            const int u = __shfl_down_sync(0xffffffffu, v, o);
            if (lane + o < 32) v = min(v, u);
        }
        int ex = __shfl_down_sync(0xffffffffu, v, 1);
        ex = min(lane == 31 ? INT_MAX : ex, run);
        if (b + lane < n) cf[b + lane] = ex != INT_MAX ? ex : lo == INT_MAX ? -1 : lo;
        run = min(run, __shfl_sync(0xffffffffu, v, 0));
    }
}

// A segment's head words and, for each of its words, the last head at or
// before its end within the segment (upto) and the first at or after its
// start (from), with the segment's carries: where each slice's run starts
// and ends. Loaded by fk_long_segment (a barrier).
struct FkSeg {
    uint32_t hw[kLongWords];
    int upto[kLongWords], from[kLongWords];
    int cl, cf;

    // the nearest head at or before slice t (word k of the segment), around the ring
    __device__ __forceinline__ int head_at(int k, int lane, int t) const {
        const uint32_t m = hw[k] & (0xffffffffu >> (31 - lane));
        if (m) return t - lane + 31 - __clz(m);
        return k > 0 && upto[k - 1] >= 0 ? upto[k - 1] : cl;
    }
    // the first head after slice t, around the ring (t itself for a line's only head)
    __device__ __forceinline__ int head_after(int k, int lane, int t) const {
        const uint32_t m = hw[k] & (0xfffffffeu << lane);
        if (m) return t - lane + __ffs(m) - 1;
        return k + 1 < kLongWords && from[k + 1] != INT_MAX ? from[k + 1] : cf;
    }
};

__device__ __forceinline__ void fk_long_segment(FkSeg& sg, const FkLong& f, size_t ln) {
    if (threadIdx.x < 32) {
        const int lane = threadIdx.x, w = blockIdx.x * kLongWords + lane;
        const uint32_t m = w < f.W ? f.hw[ln * f.W + w] : 0u;
        int last = m ? 32 * w + 31 - __clz(m) : -1, first = m ? 32 * w + __ffs(m) - 1 : INT_MAX;
        for (int o = 1; o < 32; o <<= 1) {
            const int u = __shfl_up_sync(0xffffffffu, last, o), d = __shfl_down_sync(0xffffffffu, first, o);
            if (lane >= o) last = max(last, u);
            if (lane + o < 32) first = min(first, d);
        }
        sg.hw[lane] = m;
        sg.upto[lane] = last;
        sg.from[lane] = first;
        if (lane == 0) {
            sg.cl = f.cl[ln * f.nseg + blockIdx.x];
            sg.cf = f.cf[ln * f.nseg + blockIdx.x];
        }
    }
    __syncthreads();
}

// The slices from t to the end of its run, which ends before the head e.
__device__ __forceinline__ int fk_long_left(int t, int e, int L) {
    const int m = e - t - 1;
    return (m < 0 ? m + L : m) + 1;
}

// 3.
__global__ void __launch_bounds__(kLongThreads) fk_long_leaves(FkLong f) {
    __shared__ FkSeg sg;
    const size_t ln = f.line();
    fk_long_segment(sg, f, ln);
    if (sg.cl < 0) return;  // no head: a fully frozen line (the whole block)
    const int L = f.L, lane = threadIdx.x & 31;
    const float* de = f.de + ln * 32 * f.W;
    for (int k = threadIdx.x >> 5; k < kLongWords; k += kLongThreads / 32) {
        const int t = 32 * (blockIdx.x * kLongWords + k) + lane;
        if (t >= L) break;
        const int h = sg.head_at(k, lane, t), u = t - h < 0 ? t - h + L : t - h;
        if (u % kLongLeaf) continue;
        const int n = min(kLongLeaf, fk_long_left(t, sg.head_after(k, lane, t), L));
        TreeSum<tree_depth(kLongLeaf)> sum;
        for (int j = 0, x = t; j < n; ++j, x = x + 1 == L ? 0 : x + 1) sum.add(de[x]);
        f.lf[ln * 32 * f.W + t] = sum.total();
    }
}

// 4.
template <class Ops>
__global__ void __launch_bounds__(kLongThreads) fk_long_decide(const int8_t* __restrict__ s, typename Ops::Args a,
                                                               Geo g, uint32_t ctr, int color, FkLong f) {
    __shared__ FkSeg sg;
    const size_t ln = f.line();
    fk_long_segment(sg, f, ln);
    const int r = blockIdx.z, i = site_of(g, blockIdx.y, color), L = g.L, lane = threadIdx.x & 31;
    const Ops ops(s, a, g, r, i, ctr);
    const float* lf = f.lf + ln * 32 * f.W;
    uint32_t* dw = f.dw + ln * f.W;
    if (sg.cl < 0) {  // one cluster headed at tau = 0, summed in XLA's order (lf the scratch)
        if (blockIdx.x != 0) return;
        const float tot = xla_total<kLongThreads>(f.de + ln * 32 * f.W, L, f.lf + ln * 32 * f.W);
        if (threadIdx.x == 0) dw[0] = ops.flips(0, tot);
        return;
    }
    for (int k = threadIdx.x >> 5; k < kLongWords; k += kLongThreads / 32) {
        const int w = blockIdx.x * kLongWords + k, t = 32 * w + lane;
        if (w >= f.W) break;  // the whole warp
        bool flip = false;
        if (t < L && ((sg.hw[k] >> lane) & 1u)) {
            const int n = fk_long_left(t, sg.head_after(k, lane, t), L), q = n / kLongLeaf, rest = n % kLongLeaf;
            TreeSum<tree_depth(kLongMaxL / kLongLeaf)> sum;
            int x = t;
            for (int j = 0; j < q; ++j, x = x + kLongLeaf < L ? x + kLongLeaf : x + kLongLeaf - L) sum.add(lf[x]);
            flip = ops.flips(t, sum.total(rest ? lf[x] : 0.0f, rest != 0));
        }
        const uint32_t m = __ballot_sync(0xffffffffu, flip);
        if (lane == 0) dw[w] = m;
    }
}

// 5.
__global__ void __launch_bounds__(kLongThreads) fk_long_flip(int8_t* __restrict__ s, Geo g, int color, FkLong f) {
    __shared__ FkSeg sg;
    const size_t ln = f.line();
    fk_long_segment(sg, f, ln);
    const int L = g.L, lane = threadIdx.x & 31;
    int8_t* lp = s + ((size_t)blockIdx.z * g.nvars + site_of(g, blockIdx.y, color)) * L;
    const uint32_t* dw = f.dw + ln * f.W;
    const bool whole = sg.cl < 0 && (dw[0] & 1u);  // a fully frozen line decided at tau = 0
    if (sg.cl < 0 && !whole) return;
    for (int k = threadIdx.x >> 5; k < kLongWords; k += kLongThreads / 32) {
        const int t = 32 * (blockIdx.x * kLongWords + k) + lane;
        if (t >= L) break;
        bool flip = whole;
        if (!whole) {
            const int h = sg.head_at(k, lane, t);
            flip = (dw[h >> 5] >> (h & 31)) & 1u;
        }
        if (flip) lp[t] = (int8_t)(-lp[t]);
    }
}

// Runs one color's five launches on st.
template <class Ops>
cudaError_t fk_long_phase(int8_t* s, const typename Ops::Args& a, const Geo& g, int R, uint32_t ctr, int color,
                          const FkLong& f, cudaStream_t st) {
    const dim3 grid = fk_long_grid(f, R);
    fk_long_scan<Ops><<<grid, kLongThreads, 0, st>>>(s, a, g, ctr, color, f);
    fk_long_carry<<<dim3(1, f.nl, R), 32, 0, st>>>(f);
    fk_long_leaves<<<grid, kLongThreads, 0, st>>>(f);
    fk_long_decide<Ops><<<grid, kLongThreads, 0, st>>>(s, a, g, ctr, color, f);
    fk_long_flip<<<grid, kLongThreads, 0, st>>>(s, g, color, f);
    return cudaGetLastError();
}

// Whether the cluster phase at L takes fk_long_* on a card of `optin` bytes
// of shared memory per block: fk_line's buffers no longer fit one block, or
// its frozen sum would need a third level of XLA's windows (past 32,768
// slices; on an H100 the block's limit comes first, at 26,946).
__host__ __device__ inline bool fk_long(int L, int optin) { return fk_line_bytes(L) > optin || L > 32 * 32 * 32; }

// The card's opt-in shared memory per block (0 on an error).
inline int fk_optin() {
    int dev = 0, v = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
        return 0;
    return v;
}

}  // namespace
