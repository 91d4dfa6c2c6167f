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
// block's shared memory, by two launches over the line in global memory
// (fk_long_sums, fk_long_apply: segments of kLongSlices slices, each run's
// leaves summed from shared memory where they start, each head folding its
// leaves). The resident route, one block per replica with its plane in
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
// 512 while the line fits one block's shared memory (fk_line_bytes) and 32,768
// slices, past which the line takes fk_long_* (fk_long). Every size from 32 to 1024 was timed in turns on
// an H100 (PERF.md): a warp was fastest at L = 60, 700 and 800, 128 threads
// from 900 to 2048, 256 at 4096, 512 at 10,240 (against 256 and 1024).
__host__ __device__ constexpr int fk_group(int L) {
    return L <= 896 ? 32 : L <= 2048 ? 128 : L <= kMaxL ? 256 : 512;
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
// calling group of G threads (fk_sync<G> its barrier; the last block of
// fk_long_sums, which reads the other blocks' values through L2, __ldcg), on
// its thread 0 (the others get 0): while more than 32 terms remain, windows of 32 padded evenly
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
            for (int j = max(0, -a); j < 32 && a + j < n; ++j) p = __fadd_rn(p, __ldcg(x + a + j));
            scratch[v] = p;
        }
        fk_sync<G>();
        x = scratch;
        scratch += m;
        n = m;
    }
    float tot = 0.0f;
    if (gt == 0)
        for (int j = 0; j < n; ++j) tot = __fadd_rn(tot, __ldcg(x + j));
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
// on an H100), over the line in global memory: two launches a color, each
// over (segments of kLongSlices slices, lines of the color, replicas) with
// blocks of kLongThreads threads. They compute what fk_line computes
// (ops/wl.fk_flips), summing each cluster from its head instead of by pointer
// doubling: the doubling's sum at a head h of a run of n slices is the
// right-nested sum of the perfect binary trees of n's binary expansion laid
// from h (TreeSum), which splits at kLongLeaf slices into leaves of kLongLeaf
// slices at relative multiples of kLongLeaf from h, the perfect trees of
// leaves of the blocks of n / kLongLeaf, nested onto the run's last
// n % kLongLeaf slices (its tail). So each leaf is summed alone where it
// starts and each head folds its leaves: n + n / kLongLeaf additions a run,
// where the doubling does up to n log2 n.
//
// 1. fk_long_sums: a block takes its segment from a ticket of its line, so
//    that it waits only on blocks that have started, and computes for the
//    segment and a halo of kLongLeaf slices past its end each slice's bond
//    draw, dE (kept in shared memory) and head bit (after a thawed bond); the
//    draws are a pure hash of (seed, pos, ctr), so the halo's are exact. It
//    publishes its segment's last head in a status word tagged with the
//    launch and finds the last head before its segment by a decoupled
//    look-back (a warp reads 32 status words at a time and stops at the
//    nearest segment with a head, or at one that has published its
//    inclusive result). Then it sums, from shared memory, every leaf that
//    starts in its segment: a full one by a warp (8 slices a lane, then five
//    shuffle levels: the perfect tree, TreeSum's additions exactly); the
//    short ones (a run's tail), the common case, all at once level by level
//    in place (a node of 2^c slices at a multiple of 2^c in its leaf is the
//    sum of its halves, c = 1 .. 7, every thread on its slices; then a thread
//    a leaf nests the nodes of its length's binary expansion: TreeSum's
//    additions again; a thread walking each tail alone ran 1.5x slower). It
//    writes the leaf sums (lf), the heads, the spins' signs and two bits a
//    leaf start (the leaf is short; the leaf ends its run). A slice before
//    the line's first head (the wrap-around run, headed by the line's last
//    head) has no known head in its block: its dE goes to lf, and the block
//    of the line that finishes last (a count of finished blocks) sums those
//    leaves, or, on a line with no head (fully frozen), sums the line in
//    XLA's order (xla_total) and decides it at tau = 0.
// 2. fk_long_apply: each block decides the heads in its segment and the
//    carried head that owns its first slices, a thread a head (each walks
//    its leaves from the head, folds them with TreeSum onto the tail and
//    draws at its own (pos, ctr); the same leaves and draw as the head's own
//    block, so the same bit), waiting on no other block, then flips its
//    slices from their signs: it reads no spin of the line it writes.
//
// The caller's Ops type gives a line's draws: Ops(s, args, g, r, i, ctr),
// frozen(t) (the aligned bond (t, t + 1) freezes), de(t, sv) (the slice's dE)
// and flips(head, dE), as fk_line's three functions; only site i's own line
// is written, in fk_long_apply, and its neighbours' (the other color) only
// read. Additions are __fadd_rn: nothing is contracted.
//
// They replace the TPU kernels' cluster phase (wl_pallas.py cluster_phase,
// wl_ladder_pallas.py's) on lines past one block. What bounds them on an
// H100: one pass needs a bond draw and the dE's few operations a slice and
// n + n / kLongLeaf additions a run, integer issue (about 10 us a sweep on
// the 4-ring at L = 2^20, two lines a color and replica, R = 2); they run
// about 20x that (PERF.md), most of it the draws of the segment and its
// halo, the look-back and the leaf starts (timed in builds of fk_long_sums
// cut after each step).
constexpr int kLongWords = 32, kLongThreads = 256, kLongLeaf = 256;
constexpr int kLongSlices = 32 * kLongWords;             // a segment's own slices
constexpr int kLongCover = kLongWords + kLongLeaf / 32;  // the words of a segment and its halo
constexpr int kLongWarps = kLongThreads / 32;
static_assert(kLongCover % kLongWarps == 0, "fk_long_sums: a segment's words and its halo's split evenly over the warps");
// A status word: the launch's tag in the high half; the inclusive flag (the
// last head of every segment up to this one) and a head + 1 (0: none) in the
// low half.
constexpr unsigned long long kLongIncl = 1ull << 31, kLongVal = kLongIncl - 1;
// The polls of a look-back before it gives up (__trap: a launch error, never
// a hang): a predecessor publishes its status after its own draws.
constexpr int kLongSpins = 1 << 24;

// The scratch of one color's phase, per line of the color (line index
// r * nl + j, j the line's rank in its color, site_of). Zeroed once a call
// (fk_long_reset): st (nseg status words), tk and done (the line's tickets
// and finished blocks). Written in every launch: lf (32 W f32: each leaf's
// sum at its start, a wrap-around slice's dE), hw, up, sw, ew (W words: the
// heads, the spins +1, the leaf starts whose leaf is short and whose leaf
// ends its run), sf and cl (nseg ints: the segment's first head and the last
// head before it, -1 for none), info (the line's last head; -1 or -2 for a
// fully frozen line that stays or flips) and xs (xw f32: xla_total's levels).
struct FkLong {
    unsigned long long* st;
    unsigned *tk, *done;
    float *lf, *xs;
    uint32_t *hw, *up, *sw, *ew;
    int *sf, *cl, *info;
    int L, W, nseg, nl, xw;
};

__host__ __device__ constexpr int fk_long_xw(int W) { return W + (W >> 4) + 4; }  // W + W / 32 + W / 1024 + 3 at least

inline size_t fk_long_sync_bytes(size_t lines, int nseg) { return lines * (8 * (size_t)nseg + 8); }

// The bytes of FkLong for R replicas of nvars sites at L slices (about 4.6
// a slice of a color's lines), and its arrays laid out from base.
inline size_t fk_long_bytes(int R, int nvars, int L) {
    const int W = (L + 31) >> 5, nseg = (L + kLongSlices - 1) / kLongSlices;
    const size_t lines = (size_t)R * (nvars >> 1);
    return fk_long_sync_bytes(lines, nseg) + lines * 4 * (32 * (size_t)W + fk_long_xw(W) + 4 * (size_t)W + 2 * nseg + 1);
}

inline FkLong fk_long_layout(void* base, int R, int nvars, int L) {
    FkLong f;
    f.L = L;
    f.W = (L + 31) >> 5;
    f.nseg = (L + kLongSlices - 1) / kLongSlices;
    f.nl = nvars >> 1;
    f.xw = fk_long_xw(f.W);
    const size_t lines = (size_t)R * f.nl;
    f.st = static_cast<unsigned long long*>(base);
    f.tk = reinterpret_cast<unsigned*>(f.st + lines * f.nseg);
    f.done = f.tk + lines;
    f.lf = reinterpret_cast<float*>(f.done + lines);
    f.xs = f.lf + lines * 32 * f.W;
    f.hw = reinterpret_cast<uint32_t*>(f.xs + lines * f.xw);
    f.up = f.hw + lines * f.W;
    f.sw = f.up + lines * f.W;
    f.ew = f.sw + lines * f.W;
    f.sf = reinterpret_cast<int*>(f.ew + lines * f.W);
    f.cl = f.sf + lines * f.nseg;
    f.info = f.cl + lines * f.nseg;
    return f;
}

// Zeroes the status words, tickets and counts once a call, before its first
// launch (a launch's tag, 2 t + color + 1, tells its words from the last's).
inline cudaError_t fk_long_reset(const FkLong& f, int R, cudaStream_t st) {
    return cudaMemsetAsync(f.st, 0, fk_long_sync_bytes((size_t)R * f.nl, f.nseg), st);
}

inline dim3 fk_long_grid(const FkLong& f, int R) { return dim3(f.nseg, f.nl, R); }

__device__ __forceinline__ unsigned long long fk_long_load(const unsigned long long* p) {
    return *reinterpret_cast<const volatile unsigned long long*>(p);
}
__device__ __forceinline__ void fk_long_store(unsigned long long* p, unsigned long long v) {
    *reinterpret_cast<volatile unsigned long long*>(p) = v;
}

// The bits of word w that hold one of the first n slices.
__device__ __forceinline__ uint32_t fk_below(int w, int n) {
    const int b = n - 32 * w;
    return b <= 0 ? 0u : b >= 32 ? 0xffffffffu : (1u << b) - 1u;
}

// A full leaf x[0 .. kLongLeaf) summed by the calling warp, on lane 0: the
// perfect binary tree, 8 slices a lane, then five shuffle levels (lane l adds
// lane l + o's node to its own), so TreeSum's additions in the same pairs.
__device__ __forceinline__ float fk_leaf_tree(const float* x) {
    const float* p = x + 8 * (threadIdx.x & 31);
    float v = __fadd_rn(__fadd_rn(__fadd_rn(p[0], p[1]), __fadd_rn(p[2], p[3])),
                        __fadd_rn(__fadd_rn(p[4], p[5]), __fadd_rn(p[6], p[7])));
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, o));
    return v;
}

// 1.
template <class Ops>
__global__ void __launch_bounds__(kLongThreads) fk_long_sums(const int8_t* __restrict__ s, typename Ops::Args a,
                                                             Geo g, uint32_t ctr, int color, uint32_t tag, FkLong f) {
    constexpr unsigned kAll = 0xffffffffu;
    __shared__ float de[32 * kLongCover];                 // the slices' dE, local slice u at S0 + u mod L
    __shared__ uint32_t fw[kLongCover], hw[kLongCover];  // frozen bonds (u, u + 1); heads
    __shared__ int upto[kLongCover], from[kLongCover];   // the last head at or before a word's end, the first at or after its start
    __shared__ uint32_t tails[kLongSlices];              // the short leaves: start | length << 16
    __shared__ int fulls[kLongSlices / kLongLeaf];       // the full leaves' starts
    __shared__ int seg, ntail, nfull, mine, carry, firsthead;
    __shared__ bool before, last;
    const int r = blockIdx.z, L = g.L, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const size_t ln = (size_t)r * f.nl + blockIdx.y;
    if (threadIdx.x == 0) {
        seg = (int)(atomicAdd(f.tk + ln, 1u) % (unsigned)f.nseg);
        ntail = nfull = 0;
    }
    __syncthreads();
    const int S0 = seg * kLongSlices, own = min(kLongSlices, L - S0), cover = own + kLongLeaf;
    const int i = site_of(g, blockIdx.y, color);
    const Ops ops(s, a, g, r, i, ctr);
    const int8_t* lp = s + ((size_t)r * g.nvars + i) * L;
    const size_t w0 = ln * f.W + (S0 >> 5);  // the segment's first word in the line's bit arrays
    unsigned long long* st = f.st + ln * f.nseg;
    float* lf = f.lf + ln * 32 * f.W;
    // the draws of the segment and its halo
    for (int w = warp; w < kLongCover; w += kLongWarps) {
        const int u = 32 * w + lane, t = S0 + u < L ? S0 + u : S0 + u - L;
        const int sv = lp[t];
        int nx = __shfl_down_sync(kAll, sv, 1);
        if (lane == 31) nx = lp[t + 1 == L ? 0 : t + 1];
        const bool fr = (u < cover) & (sv == nx) & ops.frozen(t);  // every lane draws: no branch
        de[u] = ops.de(t, sv);
        const uint32_t fm = __ballot_sync(kAll, fr), um = __ballot_sync(kAll, sv > 0);
        if (lane == 0) {
            fw[w] = fm;
            if (32 * w < own) f.up[w0 + w] = um & fk_below(w, own);
        }
    }
    if (threadIdx.x == 0) {  // the bond into the segment's first slice
        const int t = S0 == 0 ? L - 1 : S0 - 1;
        before = lp[t] == lp[S0] && ops.frozen(t);
    }
    __syncthreads();
    if (threadIdx.x < kLongCover) {
        const int w = threadIdx.x;
        hw[w] = ~((fw[w] << 1) | (w ? fw[w - 1] >> 31 : (uint32_t)before)) & fk_below(w, cover);
    }
    __syncthreads();
    if (warp == 0) {
        int run = -1;
        for (int b = 0; b < kLongCover; b += 32) {
            const int w = b + lane;
            const uint32_t m = w < kLongCover ? hw[w] : 0u;
            int v = m ? 32 * w + 31 - __clz(m) : -1;
            for (int o = 1; o < 32; o <<= 1) {
                const int x = __shfl_up_sync(kAll, v, o);
                if (lane >= o) v = max(v, x);
            }
            v = max(v, run);
            if (w < kLongCover) upto[w] = v;
            run = __shfl_sync(kAll, v, 31);
        }
        run = INT_MAX;
        for (int b = (kLongCover - 1) / 32 * 32; b >= 0; b -= 32) {
            const int w = b + lane;
            const uint32_t m = w < kLongCover ? hw[w] : 0u;
            int v = m ? 32 * w + __ffs(m) - 1 : INT_MAX;
            for (int o = 1; o < 32; o <<= 1) {
                const int x = __shfl_down_sync(kAll, v, o);
                if (lane + o < 32) v = min(v, x);
            }
            v = min(v, run);
            if (w < kLongCover) from[w] = v;
            run = __shfl_sync(kAll, v, 0);
        }
        __syncwarp();
        if (lane == 0) {  // the segment's last head (the halo's left out): its status
            const int wl = (own - 1) >> 5;
            const uint32_t m = hw[wl] & fk_below(wl, own);
            mine = m ? 32 * wl + 31 - __clz(m) : wl ? upto[wl - 1] : -1;
            fk_long_store(st + seg, (unsigned long long)tag << 32 | (unsigned long long)(mine >= 0 ? S0 + mine + 1 : 0));
            f.sf[ln * f.nseg + seg] = from[0] < own ? S0 + from[0] : -1;
        }
        // the look-back: the nearest segment before this one with a head, or with its inclusive status
        int c = -1;
        for (int j0 = seg - 1; j0 >= 0; j0 -= 32) {
            const int j = j0 - lane;
            unsigned long long v;
            unsigned dm;
            for (int spin = 0;; ++spin) {
                v = j >= 0 ? fk_long_load(st + j) : 0ull;
                const bool ready = j < 0 || (uint32_t)(v >> 32) == tag;
                dm = __ballot_sync(kAll, j >= 0 && ready && (v & (kLongIncl | kLongVal)) != 0);
                const unsigned rm = __ballot_sync(kAll, ready), need = dm ? dm ^ (dm - 1) : kAll;
                if ((rm & need) == need) break;  // every lane up to the first decisive one is ready
                if (spin == kLongSpins) __trap();
                __nanosleep(64);
            }
            if (dm) {
                c = (int)(__shfl_sync(kAll, v, __ffs(dm) - 1) & kLongVal) - 1;
                break;
            }
        }
        if (lane == 0) {
            carry = c;
            f.cl[ln * f.nseg + seg] = c;
            const int incl = mine >= 0 ? S0 + mine : c;
            fk_long_store(st + seg, (unsigned long long)tag << 32 | kLongIncl | (unsigned long long)(incl + 1));
        }
    }
    __syncthreads();
    // each local slice's offset in its leaf (rel: from its run's head, in the cover or the carry; -1 for the
    // wrap-around run) and the slices from it to its run's end in the cover (dn); the own slices' leaf starts
    constexpr int K = kLongCover / kLongWarps;
    int rel[K], dn[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
        const int w = warp + kLongWarps * k, u = 32 * w + lane;
        const uint32_t m = hw[w], mb = m & (kAll >> (31 - lane)), ma = m & (0xfffffffeu << lane);
        const int hl = mb ? 32 * w + 31 - __clz(mb) : w ? upto[w - 1] : -1;
        const int nh = ma ? 32 * w + __ffs(ma) - 1 : w + 1 < kLongCover ? from[w + 1] : INT_MAX;
        rel[k] = hl >= 0 ? u - hl : carry >= 0 ? S0 + u - carry : -1;
        dn[k] = nh == INT_MAX ? INT_MAX : nh - u;
        if (w < kLongWords && 32 * w < own) {
            const bool in = u < own, start = in && rel[k] >= 0 && (rel[k] & (kLongLeaf - 1)) == 0;
            const uint32_t sm = __ballot_sync(kAll, start && dn[k] < kLongLeaf),
                           em = __ballot_sync(kAll, start && dn[k] <= kLongLeaf);
            if (lane == 0) {
                f.hw[w0 + w] = m & fk_below(w, own);
                f.sw[w0 + w] = sm;
                f.ew[w0 + w] = em;
            }
            if (start) {
                if (dn[k] < kLongLeaf)
                    tails[atomicAdd(&ntail, 1)] = (uint32_t)u | (uint32_t)dn[k] << 16;
                else
                    fulls[atomicAdd(&nfull, 1)] = u;
            }
            if (in && rel[k] < 0) lf[S0 + u] = de[u];
        }
    }
    __syncthreads();
    for (int e = warp; e < nfull; e += kLongWarps) {  // before the levels below sum the leaf's slices in place
        const float v = fk_leaf_tree(de + fulls[e]);
        if (lane == 0) lf[S0 + fulls[e]] = v;
    }
    __syncthreads();
    // the short leaves' perfect trees, level by level in place: a node of 2^c slices at a multiple of 2^c in
    // its leaf, within its run, is the sum of its halves (TreeSum's additions); a leaf's block of 2^b slices
    // at its offset o is then the node at o, the largest that starts there
#pragma unroll
    for (int c = 1; c < 8; ++c) {
        const int half = 1 << (c - 1);
#pragma unroll
        for (int k = 0; k < K; ++k) {
            const int u = 32 * (warp + kLongWarps * k) + lane;
            if (rel[k] >= 0 && (rel[k] & (2 * half - 1)) == 0 && dn[k] >= 2 * half && u + 2 * half <= 32 * kLongCover)
                de[u] = __fadd_rn(de[u], de[u + half]);
        }
        __syncthreads();
    }
    for (int e = threadIdx.x; e < ntail; e += kLongThreads) {  // the blocks of n's binary expansion, right-nested
        const int u = tails[e] & 0xffff, n = tails[e] >> 16;
        float acc = 0.0f;
        bool first = true;
#pragma unroll
        for (int b = 0; b < 8; ++b)
            if ((n >> b) & 1) {
                const float x = de[u + (n & ~((2 << b) - 1))];
                acc = first ? x : __fadd_rn(x, acc);
                first = false;
            }
        lf[S0 + u] = acc;
    }
    // the line's last block to finish: the wrap-around run's leaves, or a fully frozen line
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
        __threadfence();
        last = (atomicAdd(f.done + ln, 1u) + 1u) % (unsigned)f.nseg == 0;
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    const int H = (int)(fk_long_load(st + f.nseg - 1) & kLongVal) - 1;  // the line's last head
    if (H < 0) {  // no head: one cluster headed at tau = 0, summed in XLA's order
        const float tot = xla_total<kLongThreads>(lf, L, f.xs + ln * f.xw);
        if (threadIdx.x == 0) f.info[ln] = ops.flips(0, tot) ? -2 : -1;
        return;
    }
    if (warp == 0) {  // the line's first head
        int F = INT_MAX;
        for (int b = 0; b < f.nseg && F == INT_MAX; b += 32) {
            const int x = b + lane < f.nseg ? __ldcg(f.sf + ln * f.nseg + b + lane) : -1;
            F = (int)__reduce_min_sync(kAll, (unsigned)(x >= 0 ? x : INT_MAX));
        }
        if (lane == 0) firsthead = F;
    }
    __syncthreads();
    const int F = firsthead;
    // the wrap-around run's leaves before F, at relative multiples of kLongLeaf from H, from their dE in lf
    for (int p = ((H - L) % kLongLeaf + kLongLeaf) % kLongLeaf + kLongLeaf * threadIdx.x; p < F;
         p += kLongLeaf * kLongThreads) {
        const int n = min(kLongLeaf, F - p);
        TreeSum<tree_depth(kLongLeaf)> sum;
        for (int j = 0; j < n; ++j) sum.add(__ldcg(lf + p + j));
        lf[p] = sum.total();
        if (n < kLongLeaf) atomicOr(f.sw + ln * f.W + (p >> 5), 1u << (p & 31));
        if (F - p <= kLongLeaf) atomicOr(f.ew + ln * f.W + (p >> 5), 1u << (p & 31));
    }
    if (threadIdx.x == 0) f.info[ln] = H;
}

// The total dE of the run headed at slice x: its leaves walked from x, each
// full one added to a TreeSum and the short one (the tail) nested under them,
// until the leaf that ends the run (at most L / kLongLeaf + 1 leaves: the
// bound only guards a fault from a hang).
__device__ __forceinline__ float fk_long_fold(const FkLong& f, size_t ln, int x) {
    const float* lf = f.lf + ln * 32 * f.W;
    const uint32_t* sw = f.sw + ln * f.W;
    const uint32_t* ew = f.ew + ln * f.W;
    TreeSum<tree_depth(kLongMaxL / kLongLeaf)> sum;
    for (int j = 0; j <= f.L / kLongLeaf; ++j) {
        const float v = lf[x];
        const uint32_t b = 1u << (x & 31);
        if (sw[x >> 5] & b) return sum.total(v, true);
        sum.add(v);
        if (ew[x >> 5] & b) break;
        x = x + kLongLeaf < f.L ? x + kLongLeaf : x + kLongLeaf - f.L;
    }
    return sum.total();
}

// 2.
template <class Ops>
__global__ void __launch_bounds__(kLongThreads) fk_long_apply(int8_t* __restrict__ s, typename Ops::Args a, Geo g,
                                                              uint32_t ctr, int color, FkLong f) {
    constexpr unsigned kAll = 0xffffffffu;
    __shared__ uint32_t hw[kLongWords], dw[kLongWords];  // the segment's heads and their decisions
    __shared__ int prev[kLongWords];                     // the decision of the last head before each word
    __shared__ int cdec;                                 // the carried head's decision
    __shared__ int heads[kLongSlices], nheads;           // the segment's heads
    const int r = blockIdx.z, L = g.L, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const size_t ln = (size_t)r * f.nl + blockIdx.y;
    const int S0 = blockIdx.x * kLongSlices, own = min(kLongSlices, L - S0), nw = (own + 31) >> 5;
    const int i = site_of(g, blockIdx.y, color);
    int8_t* lp = s + ((size_t)r * g.nvars + i) * L + S0;
    const uint32_t* up = f.up + ln * f.W + (S0 >> 5);
    const int info = f.info[ln];
    if (info < 0) {  // a fully frozen line, decided at tau = 0: all or nothing
        if (info == -2)
            for (int w = warp; w < nw; w += kLongWarps) {
                const int u = 32 * w + lane;
                if (u < own) lp[u] = (int8_t)((up[w] >> lane) & 1u ? -1 : 1);
            }
        return;
    }
    const Ops ops(s, a, g, r, i, ctr);
    if (threadIdx.x < nw) hw[threadIdx.x] = f.hw[ln * f.W + (S0 >> 5) + threadIdx.x];
    if (threadIdx.x < kLongWords) dw[threadIdx.x] = 0u;
    if (threadIdx.x == 0) nheads = 0;
    __syncthreads();
    for (int w = warp; w < nw; w += kLongWarps)  // the heads, listed so that each takes a thread of its own
        if ((hw[w] >> lane) & 1u) heads[atomicAdd(&nheads, 1)] = 32 * w + lane;
    __syncthreads();
    for (int e = threadIdx.x; e <= nheads; e += kLongThreads) {
        if (e < nheads) {
            const int u = heads[e];
            if (ops.flips(S0 + u, fk_long_fold(f, ln, S0 + u))) atomicOr(dw + (u >> 5), 1u << (u & 31));
        } else {  // the last head before the segment, else (the wrap-around run) the line's last
            cdec = 0;
            if (!(hw[0] & 1u)) {
                const int c = f.cl[ln * f.nseg + blockIdx.x], h = c >= 0 ? c : info;
                cdec = ops.flips(h, fk_long_fold(f, ln, h));
            }
        }
    }
    __syncthreads();
    if (warp == 0) {  // the last word before each word that holds a head
        int v = lane < nw && hw[lane] ? lane : -1;
        for (int o = 1; o < 32; o <<= 1) {
            const int x = __shfl_up_sync(kAll, v, o);
            if (lane >= o) v = max(v, x);
        }
        const int x = __shfl_up_sync(kAll, v, 1), ex = lane ? x : -1;
        prev[lane] = ex >= 0 ? (int)((dw[ex] >> (31 - __clz(hw[ex]))) & 1u) : cdec;
    }
    __syncthreads();
    for (int w = warp; w < nw; w += kLongWarps) {
        const int u = 32 * w + lane;
        const uint32_t m = hw[w] & (kAll >> (31 - lane));
        const bool d = m ? (dw[w] >> (31 - __clz(m))) & 1u : prev[w] != 0;
        if (u < own && d) lp[u] = (int8_t)((up[w] >> lane) & 1u ? -1 : 1);
    }
}

// Runs one color's two launches on st; tag tells the launch's status words
// from the call's earlier launches' (2 t + color + 1 at sweep t).
template <class Ops>
cudaError_t fk_long_phase(int8_t* s, const typename Ops::Args& a, const Geo& g, int R, uint32_t ctr, int color,
                          uint32_t tag, const FkLong& f, cudaStream_t st) {
    const dim3 grid = fk_long_grid(f, R);
    fk_long_sums<Ops><<<grid, kLongThreads, 0, st>>>(s, a, g, ctr, color, tag, f);
    fk_long_apply<Ops><<<grid, kLongThreads, 0, st>>>(s, a, g, ctr, color, f);
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
