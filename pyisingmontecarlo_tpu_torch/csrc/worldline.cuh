// What the worldline kernels (wl.cu, ladder.cu) share: the layout of
// R replicas of a periodic ring or square torus, s[R, nvars, L] int8 (a time
// line (r, i) is L contiguous bytes), a fully frozen line's total in XLA's
// order (XlaSum), a cluster's sum in the order of the JAX kernels' pointer
// doubling fed one slice at a time (TreeSum), and the multi-launch route's
// two phases of one line by a group of threads: the site phases of a color,
// both tau parities in one launch (site_phases: 8 pairs of slices a thread,
// wl_site and ladder_site giving the loads and the decision), and the
// Fortuin-Kasteleyn time-line cluster update (fk_line: a warp, or a whole
// block for long lines), which runs the JAX kernels' own pointer doubling in
// shared memory. The resident route, one block per replica with its plane in
// shared memory, is in resident.cuh, the tiled route in tiled.cuh;
// ops/wl.choose_route picks the route by shape.
#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxL = 4096;
constexpr int kTreeDepth = 13;  // binary-counter blocks of up to 2^12 = kMaxL slices

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
// same rule (L <= 4096 needs at most two levels). The pads add +0, which
// changes no comparison.
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
    __device__ __forceinline__ float total() const {  // R, right-nested
        float acc = 0.0f;
        bool first = true;
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
// block of 128 threads up to 64 words, then 256. Every size from 32 to 512
// was timed in turns on an H100 (PERF.md): a warp was fastest at L = 60, 700
// and 800, 128 threads from 900 to 2048, 256 at 4096.
__host__ __device__ constexpr int fk_group(int L) { return L <= 896 ? 32 : L <= 2048 ? 128 : 256; }

// Calls fn(std::integral_constant<int, fk_group(L)>{}).
template <class Fn>
cudaError_t by_group(int L, Fn fn) {
    switch (fk_group(L)) {
        case 32: return fn(std::integral_constant<int, 32>{});
        case 128: return fn(std::integral_constant<int, 128>{});
        default: return fn(std::integral_constant<int, 256>{});
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

}  // namespace
