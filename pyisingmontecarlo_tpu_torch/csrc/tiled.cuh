// The tiled worldline sweep of wl_tiled (wl.cu): one sweep per launch, one
// block per (replica, spatial tile), for planes too large for one block's
// shared memory (the resident route's) but whose tile and halo fit.
//
// Geometry. A tile is B x B sites of a torus (a segment of B sites of a
// ring); the last tile of a side is partial when B does not divide it. The
// block copies into shared memory the box of its tile: the tile and a halo
// of kHaloLo sites below and kHaloHi above in each direction (the ring: along
// the ring only). It runs the whole sweep on the box, and writes the tile
// (the interior) to the other of two state buffers.
//
// Why the halo is enough. A phase that updates color c reads its own line
// and the lines of color 1 - c at the four spatial neighbours, so a value is
// right one site further in than what it read. Give each box site its rank
// rho, the larger over the two directions of: 0 inside the interior, 1 in the
// first ring above it (the partners of the interior's outgoing bonds, which
// the statistics read), r + 1 in the r-th ring below it and in the (r + 1)-th
// above it. A site of rank rho >= 1 has its neighbours at rank rho + 1 at
// most. With the phases in their order, P1..P4 the site phases (color,
// parity) = (0,0), (0,1), (1,0), (1,1) and P5, P6 the cluster phases of colors
// 0 and 1, phase p updates the sites of its color with rho <= 4, 4, 3, 3, 2, 1
// (tile_rank) and leaves them exactly as the whole-lattice sweep would: the
// statistics read rank 1 after P5 and P6, P6 reads color 0 at rank 2 after
// P5, P5 color 1 at rank 3 after P4, P3 and P4 color 0 at rank 4 after P2,
// P1 and P2 the untouched color 1 at rank 5, the outermost ring (and each
// phase its own lines, updated by the phases before it at a rank as large).
// Each draw is keyed by the global site (pos = tau nvars + i), so a halo
// site's recomputed update is the one its own tile makes. Each site lies in
// one box at most once (B + kHaloLo + kHaloHi <= the side, ops/wl.tiled_plan).
//
// Shared memory (tile_layout; ops/wl.tiled_bytes computes the same): the box
// plane [sites, L] int8; per box site its global index (int32); the box
// sites listed by (color, rank), so that each phase's update set is a prefix
// of its color's list; the kernel's parameters; the list builder's counts;
// the cluster phase's scratch for the most lines a phase takes
// (ceil((B + 3)^2 / 2)): per line its first thawed bond, its place in the
// walk's order and its head and decision masks, and per thread a queue of
// kTileQueue clusters (dE and head).
//
// The cluster phase (tile_cluster), on the lines of one color up to the
// phase's rank. (a) Every thread takes pairs of slices, as in a site phase:
// each slice's bond draw and neighbour sum are coded into the line's own
// byte, its sign still the spin's (the line's own bytes are read by no other
// line's update: its neighbours have the other color), and each line's first
// thawed bond is kept. The lines are put in an order with the fully frozen
// ones last, so that a warp's threads mostly take the same of the two sums.
// (b) One thread per line walks from its first head: each cluster's dE in
// the JAX order (TreeSum, worldline.cuh; a fully frozen line's total by
// XlaSum); the (head, dE) of the first kTileQueue clusters go to the
// thread's queue and are marked and decided after the walk (in the line's
// head and decision masks), so that a warp draws and takes the log of its
// decisions together and not at every slice where one of its threads closes
// a cluster. (c) Every thread takes pairs of slices again: each slice takes
// the decision of its nearest head at or before it (cyclically), as the
// resident route's step (d) does, and becomes a spin again. The same flips
// as the JAX kernel's (ops/wl.fk_flips); only (b) is serial, 4 barriers a
// phase.
#pragma once

#include <cstdint>

#include "resident.cuh"
#include "worldline.cuh"

namespace {

constexpr int kTileThreads = 512;        // ops/wl.py TILE_THREADS
constexpr int kHaloLo = 4, kHaloHi = 5;  // ops/wl.py TILE_HALO
constexpr int kRanks = 6;                // rho = 0 .. 5
constexpr int kBuckets = 2 * kRanks;     // (color, rho)
constexpr int kTileWarps = kTileThreads / 32;
constexpr int kTileQueue = 6;  // clusters a line walk decides after the walk (ops/wl.py TILE_QUEUE)
using TileWalk = WalkN<kTileThreads>;

// The largest rank that phase p (0..5, in sweep order) updates; the cluster
// phases are p = 4, 5. ops/wl.py TILE_RANKS.
__host__ __device__ constexpr int tile_rank(int p) { return p < 2 ? 4 : p < 4 ? 3 : p == 4 ? 2 : 1; }

// Byte offsets into a tiled block's dynamic shared memory, for tiles of side
// B (the largest box; a partial tile uses a part of it).
struct TileLayout {
    int plane, gi, list, start, params, wcnt, red, first, order, masks, qde, qhead, bytes;
};

__host__ __device__ inline int tile_box_sites(int torus, int B) {
    const int w = B + kHaloLo + kHaloHi;
    return torus ? w * w : w;
}

// The most lines a cluster phase takes: the sites of one color of rank 2 at
// most.
__host__ __device__ inline int tile_max_lines(int torus, int B) {
    const int w = B + 3;
    return ((torus ? w * w : w) + 1) / 2;
}

__host__ __device__ inline TileLayout tile_layout(int torus, int B, int L, int param_bytes) {
    const int sites = tile_box_sites(torus, B), lines = tile_max_lines(torus, B);
    TileLayout o;
    int off = 0;
    o.plane = off, off += align16(sites * L);
    o.gi = off, off += align16(4 * sites);
    o.list = off, off += align16(2 * sites);
    o.start = off, off += align16(4 * (2 * kBuckets + 1));  // bucket starts, then running offsets
    o.params = off, off += align16(param_bytes);
    o.wcnt = off, off += align16(4 * kTileWarps * kBuckets);
    o.red = off, off += 16;
    o.first = off, off += align16(4 * lines) + 16;  // and two counters for the order
    o.order = off, off += align16(2 * lines);
    o.masks = off, off += align16(8 * ((L + 31) >> 5) * lines);
    o.qde = off, off += align16(4 * kTileQueue * kTileThreads);
    o.qhead = off, off += align16(2 * kTileQueue * kTileThreads);
    o.bytes = off;
    return o;
}

// A block's tile: replica r, interior origin (x0, y0) and extents bx x by
// (a ring: x0 = 0, bx = 1, no halo in x), box extents wx x wy with hx halo
// sites below the interior in x.
struct Tile {
    int r, x0, y0, bx, by, hx, wx, wy, sites;
};

__device__ inline Tile tile_of(const Geo& g, int B) {
    const int side = g.torus ? g.size : g.nvars;
    const int nt = (side + B - 1) / B;
    const int tiles = g.torus ? nt * nt : nt;
    Tile t;
    t.r = blockIdx.x / tiles;
    const int q = blockIdx.x - t.r * tiles;
    const int tx = g.torus ? q / nt : 0;
    t.x0 = tx * B;
    t.y0 = (q - tx * nt) * B;
    t.bx = g.torus ? min(B, side - t.x0) : 1;
    t.by = min(B, side - t.y0);
    t.hx = g.torus ? kHaloLo : 0;
    t.wx = g.torus ? t.bx + kHaloLo + kHaloHi : 1;
    t.wy = t.by + kHaloLo + kHaloHi;
    t.sites = t.wx * t.wy;
    return t;
}

// rho along one direction of box coordinate u: interior lo <= u < lo + b.
__device__ __forceinline__ int rank1(int u, int lo, int b) {
    return u < lo ? lo - u + 1 : u >= lo + b ? u - lo - b + 1 : 0;
}

__device__ __forceinline__ int wrap(int x, int n) { return x < 0 ? x + n : x >= n ? x - n : x; }

// Box site k's global index and its bucket color * kRanks + rho.
__device__ __forceinline__ int box_site(const Geo& g, const Tile& t, int k, int& bucket) {
    const int u = g.torus ? k / t.wy : 0, v = k - u * t.wy;
    const int gy = wrap(t.y0 - kHaloLo + v, g.torus ? g.size : g.nvars);
    const int rho = max(rank1(u, t.hx, t.bx), rank1(v, kHaloLo, t.by));
    if (!g.torus) {
        bucket = (gy & 1) * kRanks + rho;
        return gy;
    }
    const int gx = wrap(t.x0 - kHaloLo + u, g.size);
    bucket = ((gx + gy) & 1) * kRanks + rho;
    return gx * g.size + gy;
}

// Build the global index of every box site (gi) and the list of box sites
// by bucket, in box order within a bucket (start[b]: where bucket b begins;
// start[kBuckets]: the box's site count). Ends with a barrier.
__device__ void tile_lists(const Geo& g, const Tile& t, int* gi, uint16_t* list, int* start, int* wcnt) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    int* run = start + kBuckets + 1;
    if (tid < kBuckets) run[tid] = 0;
    __syncthreads();
    for (int k = tid; k < t.sites; k += kTileThreads) {
        int b;
        gi[k] = box_site(g, t, k, b);
        atomicAdd(run + b, 1);
    }
    __syncthreads();
    if (tid == 0) {
        int acc = 0;
        for (int b = 0; b < kBuckets; ++b) {
            start[b] = acc;
            acc += run[b];
            run[b] = start[b];
        }
        start[kBuckets] = acc;
    }
    __syncthreads();
    for (int k0 = 0; k0 < t.sites; k0 += kTileThreads) {  // a chunk of sites, ranked by warp ballots
        const int k = k0 + tid;
        int b = -1, rank = 0;
        if (k < t.sites) box_site(g, t, k, b);
        for (int bb = 0; bb < kBuckets; ++bb) {
            const uint32_t m = __ballot_sync(0xffffffffu, b == bb);
            if (lane == 0) wcnt[warp * kBuckets + bb] = __popc(m);
            if (b == bb) rank = __popc(m & ((1u << lane) - 1u));
        }
        __syncthreads();
        if (b >= 0) {
            int pos = run[b] + rank;
            for (int w = 0; w < warp; ++w) pos += wcnt[w * kBuckets + b];
            list[pos] = (uint16_t)k;
        }
        __syncthreads();
        if (tid < kBuckets)
            for (int w = 0; w < kTileWarps; ++w) run[tid] += wcnt[w * kBuckets + tid];
        __syncthreads();
    }
}

// Copy the box from the replica's plane src ([nvars, L]) in units of T (a
// divisor of L, so that every site's line is aligned to it at both ends).
template <class T>
__device__ void tile_load(int8_t* pl, const int8_t* src, const int* gi, int sites, int L) {
    const int cols = L / (int)sizeof(T);
    for (TileWalk w(cols); w.row < sites; w.next())
        reinterpret_cast<T*>(pl + w.row * L)[w.col] = reinterpret_cast<const T*>(src + (size_t)gi[w.row] * L)[w.col];
}

// Copy the interior to the replica's plane dst, one interior row (by
// contiguous sites, which never wrap) at a time.
template <class T>
__device__ void tile_store(const int8_t* pl, int8_t* dst, const Geo& g, const Tile& t, int L) {
    const int cols = t.by * L / (int)sizeof(T);
    const int m = g.torus ? g.size : 0;
    for (TileWalk w(cols); w.row < t.bx; w.next()) {
        const T v = reinterpret_cast<const T*>(pl + ((t.hx + w.row) * t.wy + kHaloLo) * L)[w.col];
        reinterpret_cast<T*>(dst + (size_t)((t.x0 + w.row) * m + t.y0) * L)[w.col] = v;
    }
}

// Call fn(T{}) with the widest of 16, 8, 4, 2 bytes that divides L.
template <class Fn>
__device__ __forceinline__ void by_unit(int L, Fn fn) {
    if ((L & 15) == 0)
        fn(uint4{});
    else if ((L & 7) == 0)
        fn(uint2{});
    else if ((L & 3) == 0)
        fn(uint32_t{});
    else
        fn(uint16_t{});
}

// Spatial neighbour sum of box site k at slice tau (torus: k +- 1 along y,
// k +- wy along x; ring: k +- 1).
__device__ __forceinline__ int tile_nsum(const int8_t* pl, int k, int wy, int L, int tau, int torus) {
    int b = pl[(k + 1) * L + tau] + pl[(k - 1) * L + tau];
    if (torus) b += pl[(k + wy) * L + tau] + pl[(k - wy) * L + tau];
    return b;
}

// The cluster phase's scratch (tile_layout): first[line] is L on entry and
// is left so, first[lines .. lines + 1] two counters; order[i], the line
// the walk takes i-th; masks[line] the head mask then the decision mask,
// ceil(L / 32) words each; the queue.
struct TileCluster {
    int* first;
    int* count;
    uint16_t* order;
    uint32_t* masks;
    float* qde;
    uint16_t* qhead;
};

// One FK cluster phase on the lines of the n box sites ls[0..n) (box plane
// pl; spatial neighbours by tile_nsum), in the steps (a), (b), (c) above;
// ends with a barrier. bond_frozen(k, t): the aligned
// bond (t, t + 1) of box site k freezes (the caller's draw); cde: the dE
// table, [5 (s > 0) + (neighbour sum + 4) / 2]; head_flips(k, head, dE): the
// cluster of box site k headed at head, of total dE, flips. Depth: the
// counter's levels (TreeSum) for L.
template <int Depth, class BondFrozen, class HeadFlips>
__device__ void tile_cluster(int8_t* pl, int L, int wy, int torus, const uint16_t* ls, int n,
                             const float* cde, const TileCluster& c, BondFrozen bond_frozen, HeadFlips head_flips) {
    constexpr int kFrozen = 16;  // a code's magnitude: 1 | index << 1 | frozen bond (t, t + 1)
    const int W = (L + 31) >> 5;
    // (a) the codes and each line's first thawed bond
    for (TileWalk w(L >> 1); w.row < n; w.next()) {
        const int k = ls[w.row], t = 2 * w.col;
        int8_t* lp = pl + k * L;
        const char2 s = *reinterpret_cast<const char2*>(lp + t);
        const int s2 = lp[t + 2 == L ? 0 : t + 2] > 0 ? 1 : -1;  // coded or not, by its sign
        const bool f0 = s.x == s.y && bond_frozen(k, t), f1 = s.y == s2 && bond_frozen(k, t + 1);
        const char2 a = *reinterpret_cast<const char2*>(pl + (k + 1) * L + t);
        const char2 b = *reinterpret_cast<const char2*>(pl + (k - 1) * L + t);
        int n0 = a.x + b.x, n1 = a.y + b.y;
        if (torus) {
            const char2 e = *reinterpret_cast<const char2*>(pl + (k + wy) * L + t);
            const char2 d = *reinterpret_cast<const char2*>(pl + (k - wy) * L + t);
            n0 += e.x + d.x;
            n1 += e.y + d.y;
        }
        const int m0 = 1 | ((n0 + 4) >> 1) << 1 | (f0 ? kFrozen : 0);
        const int m1 = 1 | ((n1 + 4) >> 1) << 1 | (f1 ? kFrozen : 0);
        *reinterpret_cast<char2*>(lp + t) = make_char2(s.x > 0 ? m0 : -m0, s.y > 0 ? m1 : -m1);
        if (!f0)
            atomicMin(c.first + w.row, t);
        else if (!f1)
            atomicMin(c.first + w.row, t + 1);
    }
    if (threadIdx.x < 2) c.count[threadIdx.x] = 0;
    __syncthreads();
    // the walk's order: the lines with a thawed bond from the front, the
    // fully frozen ones from the back, one atomic a warp for each
    for (int ln0 = 0; ln0 < n; ln0 += kTileThreads) {
        const int ln = ln0 + threadIdx.x, lane = threadIdx.x & 31;
        const bool valid = ln < n, frozen = valid && c.first[ln] == L;
        const uint32_t mf = __ballot_sync(0xffffffffu, frozen);
        const uint32_t mt = __ballot_sync(0xffffffffu, valid && !frozen);
        int base = 0;
        if (lane == 0) base = (atomicAdd(c.count, __popc(mt)) << 16) | atomicAdd(c.count + 1, __popc(mf));
        base = __shfl_sync(0xffffffffu, base, 0);
        const uint32_t below = (1u << lane) - 1u;
        if (frozen) c.order[n - 1 - ((base & 0xFFFF) + __popc(mf & below))] = (uint16_t)ln;
        else if (valid) c.order[(base >> 16) + __popc(mt & below)] = (uint16_t)ln;
    }
    __syncthreads();
    // (b) one thread per line: each cluster's dE from its head; the heads
    // and their decisions queued, then marked and taken
    float* qde = c.qde + threadIdx.x;
    uint16_t* qhead = c.qhead + threadIdx.x;
    for (int i = threadIdx.x; i < n; i += kTileThreads) {
        const int ln = c.order[i], k = ls[ln];
        const int8_t* lp = pl + k * L;
        const int m = c.first[ln];
        c.first[ln] = L;
        uint32_t* heads = c.masks + ln * 2 * W;
        uint32_t* flips = heads + W;
        for (int w = 0; w < W; ++w) heads[w] = flips[w] = 0u;
        const bool frozen = m == L;  // one cluster, headed at tau = 0
        const int h0 = frozen || m + 1 == L ? 0 : m + 1;
        TreeSum<Depth> sum;
        XlaSum whole(L);
        int queued = 0;
        for (int j = 0, x = h0, head = h0; j < L; ++j, x = x + 1 == L ? 0 : x + 1) {
            const int code = lp[x], mag = code > 0 ? code : -code;
            const float v = cde[5 * (code > 0) + ((mag >> 1) & 7)];
            float acc = 0.0f;
            bool ends = false;
            if (frozen) {
                whole.add(x, v);
                if (j == L - 1) {
                    acc = whole.total();
                    ends = true;
                }
            } else {
                sum.add(v);
                if (!(mag & kFrozen)) {  // the cluster ends at x
                    ends = true;
                    acc = sum.total();
                }
            }
            if (ends) {
                if (queued < kTileQueue) {
                    qde[queued * kTileThreads] = acc;
                    qhead[queued * kTileThreads] = (uint16_t)head;
                    ++queued;
                } else {
                    heads[head >> 5] |= 1u << (head & 31);
                    if (head_flips(k, head, acc)) flips[head >> 5] |= 1u << (head & 31);
                }
                sum.count = 0;
                head = x + 1 == L ? 0 : x + 1;
            }
        }
        for (int q = 0; q < queued; ++q) {
            const int h = qhead[q * kTileThreads];
            heads[h >> 5] |= 1u << (h & 31);
            if (head_flips(k, h, qde[q * kTileThreads])) flips[h >> 5] |= 1u << (h & 31);
        }
    }
    __syncthreads();
    // (c) each slice takes the decision of its nearest head at or before it,
    // cyclically (a line has one at least), and becomes a spin again
    for (TileWalk w(L >> 1); w.row < n; w.next()) {
        const int t = 2 * w.col, wi = t >> 5;
        const uint32_t* hl = c.masks + w.row * 2 * W;
        const uint32_t* fl = hl + W;
        uint32_t m = hl[wi] & (0xFFFFFFFFu >> (31 - (t & 31)));  // heads at or before t in its word
        int x = wi;
        for (int j = 1; !m && j <= W; ++j) {  // else the last head in the words before, cyclically
            x = wi - j < 0 ? wi - j + W : wi - j;
            m = hl[x];
        }
        const uint32_t f0 = (fl[x] >> (31 - __clz(m))) & 1u;
        const uint32_t f1 = (hl[wi] >> ((t + 1) & 31)) & 1u ? (fl[wi] >> ((t + 1) & 31)) & 1u : f0;
        char2* sp = reinterpret_cast<char2*>(pl + ls[w.row] * L + t);
        const char2 sv = *sp;
        const int a = sv.x > 0 ? 1 : -1, b = sv.y > 0 ? 1 : -1;
        *sp = make_char2(f0 ? -a : a, f1 ? -b : b);
    }
    __syncthreads();
}

}  // namespace
