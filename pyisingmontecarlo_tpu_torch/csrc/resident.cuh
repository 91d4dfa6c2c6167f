// The block-resident worldline sweep that wl_resident (wl.cu) and
// ladder_resident (ladder.cu) share: one thread block per replica loads the
// replica's plane s[r] ([nvars, L] int8) into dynamic shared memory once, runs
// every phase of every sweep of the launch on that copy with __syncthreads()
// between phases, and writes it back once at the end.
//
// - Site phases: the block's threads stride over the active (site, tau) of a
//   color and parity; spins, neighbours and the sites of each color come from
//   shared memory, and the loop divides by nothing (Walk).
// - Cluster phases (res_cluster): the Fortuin-Kasteleyn time-line update of
//   ops/wl.fk_flips, in parallel over (line, tau), each thread taking pairs of
//   slices (L is even), tile by tile: (a) the frozen-bond bits and the slice
//   dE; (b) the forward segmented run-sum by pointer doubling,
//   acc[t] += reach[t] ? acc[t + k] : 0 and reach[t] &= reach[t + k] for
//   k = 1, 2, 4, ... (ceil(log2 L) steps, double buffers, one barrier a step),
//   so that each head's f32 sum is the JAX kernel's addition for addition, and
//   a fully frozen line's total by XlaSum (worldline.cuh), one thread per such
//   line; (c), in the last doubling step, the decision at each head (its
//   log-uniform is drawn there: nearly every warp holds a head, so drawing it
//   for every pair would issue no less), set as bits of per-line head and
//   decision masks; (d) one pass in which each slice takes the decision of its
//   nearest head at or before it, cyclically (found with __clz), and flips:
//   the cluster's decision, which fk_flips' OR doubling spreads. The lines of
//   a color are taken in tiles whose scratch fits beside the plane
//   (ops/wl.resident_plan), so the plane, not the scratch, bounds the shape.
//   K + 2 barriers per tile, K = ceil(log2 L). (Tried on the H100 and not
//   kept: a binary-counter walk of each cluster for (b), one thread per
//   line, which gives the same sums (TreeSum, worldline.cuh), ran slower at
//   both bench shapes, each line one serial chain of adds, draws and logs.)
//
// The draws are the multi-launch kernels' (same lane_draw31, pos and ctr), so
// a resident launch equals them and the plain versions bit for bit.
#pragma once

#include <cstdint>

#include "worldline.cuh"

namespace {

constexpr int kResThreads = 1024;  // ops/wl.py RESIDENT_THREADS

__host__ __device__ constexpr int align16(int n) { return (n + 15) & ~15; }

// Byte offsets into a resident block's dynamic shared memory: the plane, the
// neighbours (ushort4 per site), the sites of each color (uint16), the
// kernel's parameters, four ints for reductions, then a cluster tile of
// `tile` lines: per line the frozen total (f32), a fully-frozen flag and the
// head and decision masks (ceil(L / 32) words each), per (line, tau) two f32
// run-sum buffers, two reach buffers and the frozen bits.
// ops/wl.resident_bytes computes the same total; the C entries refuse a launch
// whose byte count differs.
struct ResLayout {
    int plane, nbr, sites, params, red, total, all, masks, acc0, acc1, fl0, fl1, act, bytes;
};

__host__ __device__ inline ResLayout res_layout(int nvars, int L, int param_bytes, int tile) {
    const int P = tile * L;
    ResLayout o;
    int off = 0;
    o.plane = off, off += align16(nvars * L);
    o.nbr = off, off += align16(8 * nvars);
    o.sites = off, off += align16(2 * nvars);
    o.params = off, off += align16(param_bytes);
    o.red = off, off += 16;
    o.total = off, off += align16(4 * tile);
    o.all = off, off += align16(tile);
    o.masks = off, off += align16(8 * tile * ((L + 31) >> 5));
    o.acc0 = off, off += align16(4 * P);
    o.acc1 = off, off += align16(4 * P);
    o.fl0 = off, off += align16(P);
    o.fl1 = off, off += align16(P);
    o.act = off, off += align16(P);
    o.bytes = off;
    return o;
}

// A block's view of its shared memory.
struct Res {
    unsigned char* base;
    ResLayout o;
    int nvars, L, half, tile, ksteps, torus;

    __device__ int8_t* pl() const { return reinterpret_cast<int8_t*>(base + o.plane); }
    __device__ const ushort4* nb() const { return reinterpret_cast<const ushort4*>(base + o.nbr); }
    __device__ const uint16_t* sites() const { return reinterpret_cast<const uint16_t*>(base + o.sites); }
    __device__ unsigned char* params() const { return base + o.params; }
    __device__ int* red() const { return reinterpret_cast<int*>(base + o.red); }
    __device__ float* total() const { return reinterpret_cast<float*>(base + o.total); }
    __device__ uint8_t* all() const { return base + o.all; }
    __device__ uint32_t* masks() const { return reinterpret_cast<uint32_t*>(base + o.masks); }
    __device__ float* acc(int k) const { return reinterpret_cast<float*>(base + (k ? o.acc1 : o.acc0)); }
    __device__ uint8_t* fl(int k) const { return base + (k ? o.fl1 : o.fl0); }
    __device__ uint8_t* act() const { return base + o.act; }
};

// The elements e = threadIdx.x + m N of a grid of `cols` columns, as
// (row, col), for a block of N threads: the divisions happen once, when a
// walk is made.
template <int N>
struct WalkN {
    int e, row, col, drow, dcol, cols;

    __device__ explicit WalkN(int cols_) : cols(cols_) {
        e = threadIdx.x;
        row = e / cols;
        col = e - row * cols;
        drow = N / cols;
        dcol = N - drow * cols;
    }
    __device__ void next() {
        e += N;
        row += drow;
        col += dcol;
        if (col >= cols) {
            col -= cols;
            ++row;
        }
    }
};
using Walk = WalkN<kResThreads>;

// Load replica r's plane (gs, nvars L bytes, a multiple of 4) and build the
// neighbour and site tables; every fully-frozen flag starts set.
__device__ void res_load(Res& b, const int8_t* gs, const Geo& g, int param_bytes, int tile) {
    b.o = res_layout(g.nvars, g.L, param_bytes, tile);
    b.nvars = g.nvars;
    b.L = g.L;
    b.half = g.nvars >> 1;
    b.tile = tile;
    b.ksteps = 32 - __clz(g.L - 1);  // ceil(log2 L), L >= 4
    b.torus = g.torus;
    const int tid = threadIdx.x;
    const uint32_t* src = reinterpret_cast<const uint32_t*>(gs);
    uint32_t* dst = reinterpret_cast<uint32_t*>(b.pl());
    for (int w = tid; w < (g.nvars * g.L) >> 2; w += kResThreads) dst[w] = src[w];
    ushort4* nb = reinterpret_cast<ushort4*>(b.base + b.o.nbr);
    uint16_t* sites = reinterpret_cast<uint16_t*>(b.base + b.o.sites);
    for (int i = tid; i < g.nvars; i += kResThreads) {
        const Nbrs n = neighbours(g, i);
        nb[i] = make_ushort4((unsigned short)n.j[0], (unsigned short)n.j[1], (unsigned short)n.j[2],
                             (unsigned short)n.j[3]);
        const int color = i >= b.half;
        sites[i] = (uint16_t)site_of(g, i - color * b.half, color);
    }
    for (int ln = tid; ln < tile; ln += kResThreads) b.all()[ln] = 1;
    if (tid < 4) b.red()[tid] = 0;
}

// Write the plane back to gs.
__device__ void res_store(const Res& b, int8_t* gs) {
    const uint32_t* src = reinterpret_cast<const uint32_t*>(b.pl());
    uint32_t* dst = reinterpret_cast<uint32_t*>(gs);
    for (int w = threadIdx.x; w < (b.nvars * b.L) >> 2; w += kResThreads) dst[w] = src[w];
}

// One FK cluster phase of `color` on the resident plane. Each thread takes
// pairs of slices (2m, 2m + 1) of its lines (pw walks L / 2 columns; L is
// even, so a pair never straddles a line's end, and for an even shift k the
// partner of a pair is the aligned pair k / 2 along, read as one float2 and
// one uchar2). bond_frozen(i, t): the aligned bond (t, t+1) of site i freezes
// (the draw); slice_de(i, t, s): the diagonal dE of flipping slice t of site
// i, which holds s; head_flips(i, head, dE): the cluster of site i headed at
// head, of total dE, flips. Ends with a barrier.
template <class BondFrozen, class SliceDE, class HeadFlips>
__device__ void res_cluster(const Res& b, const Walk& pw, int color, BondFrozen bond_frozen, SliceDE slice_de,
                            HeadFlips head_flips) {
    const int L = b.L, H = b.L >> 1, K = b.ksteps;
    int8_t* pl = b.pl();
    const uint16_t* sites = b.sites() + color * b.half;
    uint8_t* all = b.all();
    float* total = b.total();
    const int W = (L + 31) >> 5;  // mask words per line
    uint32_t* heads = b.masks();  // [tile, W]: the heads, then the decisions
    for (int l0 = 0; l0 < b.half; l0 += b.tile) {
        const int tl = min(b.tile, b.half - l0);
        uint32_t* flips = heads + tl * W;
        // (a) frozen bits (also the run-sum's reach) and slice dE; a thawed
        // bond clears its line's fully-frozen flag; the masks start empty
        for (int x = threadIdx.x; x < 2 * tl * W; x += kResThreads) heads[x] = 0u;
        {
            float2* acc = reinterpret_cast<float2*>(b.acc(0));
            uchar2* fl = reinterpret_cast<uchar2*>(b.fl(0));
            for (Walk w = pw; w.row < tl; w.next()) {
                const int i = sites[l0 + w.row], t = 2 * w.col;
                const int8_t* lp = pl + i * L;
                const char2 s01 = *reinterpret_cast<const char2*>(lp + t);
                const int s2 = lp[t + 2 == L ? 0 : t + 2];
                const uchar2 a = make_uchar2(s01.x == s01.y && bond_frozen(i, t), s01.y == s2 && bond_frozen(i, t + 1));
                reinterpret_cast<uchar2*>(b.act())[w.e] = a;
                fl[w.e] = a;
                acc[w.e] = make_float2(slice_de(i, t, s01.x), slice_de(i, t + 1, s01.y));
                if (!(a.x & a.y)) all[w.row] = 0;
            }
        }
        __syncthreads();
        // (b) the forward segmented run-sum: acc[t] += reach[t] ? acc[t + k]
        // : 0, reach[t] &= reach[t + k]; a fully frozen line's total in XLA's
        // order, from the slice dE before the first step overwrites them.
        // (c) in the last step, where each thread holds its pairs' final sums:
        // the decision at each head (after a thawed bond, or tau = 0 of a
        // fully frozen line), as bits of the line's masks
        int cur = 0;
        for (int step = 0, k = 1; step < K; ++step, k <<= 1) {
            const float* src = b.acc(cur);
            float2* dst = reinterpret_cast<float2*>(b.acc(cur ^ 1));
            const uint8_t* fs = b.fl(cur);
            uchar2* fd = reinterpret_cast<uchar2*>(b.fl(cur ^ 1));
            if (step == 0) {
                for (int ln = threadIdx.x; ln < tl; ln += kResThreads)
                    if (all[ln]) {
                        XlaSum whole(L);
                        const float* v = src + ln * L;
                        for (int x = 0; x < L; ++x) whole.add(x, v[x]);
                        total[ln] = whole.total();
                    }
                for (Walk w = pw; w.row < tl; w.next()) {  // k = 1: t + 1 is the pair's own, t + 2 the next pair's
                    const int q = 2 * (w.col + 1 == H ? w.e + 1 - H : w.e + 1);
                    const float2 a = reinterpret_cast<const float2*>(src)[w.e];
                    const uchar2 r = reinterpret_cast<const uchar2*>(fs)[w.e];
                    const float n = src[q];
                    const uint8_t rn = fs[q];
                    dst[w.e] = make_float2(r.x ? __fadd_rn(a.x, a.y) : a.x, r.y ? __fadd_rn(a.y, n) : a.y);
                    fd[w.e] = make_uchar2(r.x & r.y, r.y & rn);
                }
            } else {
                const int kp = k >> 1;  // k even: the partner pair
                const bool last = step == K - 1;
                const uint8_t* act = b.act();
                for (Walk w = pw; w.row < tl; w.next()) {
                    const int q = w.col + kp >= H ? w.e + kp - H : w.e + kp;
                    const float2 a = reinterpret_cast<const float2*>(src)[w.e];
                    const uchar2 r = reinterpret_cast<const uchar2*>(fs)[w.e];
                    const float2 n = reinterpret_cast<const float2*>(src)[q];
                    const uchar2 rn = reinterpret_cast<const uchar2*>(fs)[q];
                    const float s0 = r.x ? __fadd_rn(a.x, n.x) : a.x, s1 = r.y ? __fadd_rn(a.y, n.y) : a.y;
                    if (!last) {
                        dst[w.e] = make_float2(s0, s1);
                        fd[w.e] = make_uchar2(r.x & rn.x, r.y & rn.y);
                        continue;
                    }
                    const int t = 2 * w.col, e = 2 * w.e;
                    const bool whole = all[w.row];
                    const uint32_t bit = 1u << (t & 31);  // t and t + 1 share a word
                    uint32_t h = 0u, f = 0u;
                    if (whole ? t == 0 : !act[t == 0 ? e + L - 1 : e - 1]) {
                        h = bit;
                        if (head_flips(sites[l0 + w.row], t, whole ? total[w.row] : s0)) f = bit;
                    }
                    if (!whole && !act[e]) {
                        h |= bit << 1;
                        if (head_flips(sites[l0 + w.row], t + 1, s1)) f |= bit << 1;
                    }
                    if (h) {
                        atomicOr(heads + w.row * W + (t >> 5), h);
                        if (f) atomicOr(flips + w.row * W + (t >> 5), f);
                    }
                }
            }
            __syncthreads();
            cur ^= 1;
        }
        // (d) each slice takes the decision of its nearest head at or before
        // it, cyclically (a line has one at least), and flips
        for (int ln = threadIdx.x; ln < b.tile; ln += kResThreads) all[ln] = 1;  // (c) has read them
        for (Walk w = pw; w.row < tl; w.next()) {
            const int t = 2 * w.col, wi = t >> 5;
            const uint32_t* hl = heads + w.row * W;
            const uint32_t* fl = flips + w.row * W;
            uint32_t m = hl[wi] & (0xFFFFFFFFu >> (31 - (t & 31)));  // heads at or before t in its word
            int x = wi;
            for (int j = 1; !m && j <= W; ++j) {  // else the last head in the words before, cyclically
                x = wi - j < 0 ? wi - j + W : wi - j;
                m = hl[x];
            }
            const uint32_t f0 = (fl[x] >> (31 - __clz(m))) & 1u;
            const uint32_t f1 = (hl[wi] >> ((t + 1) & 31)) & 1u ? (fl[wi] >> ((t + 1) & 31)) & 1u : f0;
            if (f0 | f1) {
                char2* sp = reinterpret_cast<char2*>(pl + sites[l0 + w.row] * L + t);
                const char2 sv = *sp;
                *sp = make_char2(f0 ? (signed char)(-sv.x) : sv.x, f1 ? (signed char)(-sv.y) : sv.y);
            }
        }
        __syncthreads();
    }
}

// Sum v over the block into red[slot] (red starts at 0); the caller
// synchronises before reading it.
__device__ __forceinline__ void res_block_add(int* red, int slot, int v) {
    for (int o = 16; o; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if ((threadIdx.x & 31) == 0) atomicAdd(red + slot, v);
}

}  // namespace
