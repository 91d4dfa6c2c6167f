// What the worldline kernels (wl.cu, ladder.cu) share: the layout of
// R replicas of a periodic ring or square torus, s[R, nvars, L] int8 (a time
// line (r, i) is L contiguous bytes), a fully frozen line's total in XLA's
// order (XlaSum), a cluster's sum in the order of the JAX kernels' pointer
// doubling fed one slice at a time (TreeSum), and the multi-launch route's
// Fortuin-Kasteleyn time-line cluster update of one line by one thread
// (fk_line_update), which holds those sums bit for bit. The resident route,
// one block per replica with its plane in shared memory and the cluster
// phase in parallel, is in resident.cuh, the tiled route in tiled.cuh;
// ops/wl.choose_route picks the route by shape.
#pragma once

#include <cstdint>

namespace {

constexpr int kSiteBlock = 256;
constexpr int kLineBlock = 64;  // lines (threads) per block of a cluster phase
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

__device__ __forceinline__ Nbrs neighbours(const Geo& g, int i) {
    if (!g.torus) return {{i + 1 == g.nvars ? 0 : i + 1, i == 0 ? g.nvars - 1 : i - 1, -1, -1}};
    const int n = g.size;
    const int x = i / n, y = i - x * n;
    return {{(x + 1 == n ? 0 : x + 1) * n + y, (x == 0 ? n - 1 : x - 1) * n + y,
             x * n + (y + 1 == n ? 0 : y + 1), x * n + (y == 0 ? n - 1 : y - 1)}};
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

// Per-line bit arrays in shared memory: word w of the block's thread j at
// [w * kLineBlock + j], so a warp's accesses fall in distinct banks.
__device__ __forceinline__ bool get_bit(const uint32_t* b, int x) {
    return (b[(x >> 5) * kLineBlock] >> (x & 31)) & 1u;
}
__device__ __forceinline__ void set_bit(uint32_t* b, int x) { b[(x >> 5) * kLineBlock] |= 1u << (x & 31); }

// Dynamic shared memory of a cluster-phase block: frozen and decision bits.
inline int cluster_smem_bytes(int L) { return 2 * ((L + 31) / 32) * kLineBlock * (int)sizeof(uint32_t); }

// One FK cluster update of the time line lp[0..L) by one thread; bits is
// this thread's column of the block's shared memory (bits + threadIdx.x).
// bond_frozen(t): the aligned bond (t, t+1) freezes (the caller's draw);
// slice_de(x, s): the diagonal dE of flipping slice x, which holds s;
// head_flips(head, dE): the cluster headed at head, of total dE, flips.
//
// The JAX kernels run the forward segmented sum by pointer doubling over the
// whole ring; TreeSum gives the same sums walking each cluster. Three passes
// along the line: (1) frozen bonds, as bits; (2) from the first head (tau = 0 on a
// fully frozen line, whose total is summed in XLA's order), each cluster's dE
// and its head's decision, as bits; (3) the decisions carried to every slice
// of their cluster, and the flips written. Frozen and other lines take the
// same passes, so a warp's threads stay together.
template <class BondFrozen, class SliceDE, class HeadFlips>
__device__ __forceinline__ void fk_line_update(int8_t* lp, uint32_t* bits, int L,
                                               BondFrozen bond_frozen, SliceDE slice_de,
                                               HeadFlips head_flips) {
    const int words = (L + 31) >> 5;
    uint32_t* act = bits;
    uint32_t* dec = act + words * kLineBlock;
    for (int w = 0; w < words; ++w) act[w * kLineBlock] = dec[w * kLineBlock] = 0u;

    // (1) h0 = the first head (the slice after the first thawed bond)
    int h0 = -1;
    const int s0 = lp[0];
#pragma unroll 4
    for (int t = 0; t < L; ++t) {
        const int sv = lp[t], nx = t + 1 == L ? s0 : lp[t + 1];
        if (sv == nx && bond_frozen(t))
            set_bit(act, t);
        else if (h0 < 0)
            h0 = t + 1 == L ? 0 : t + 1;
    }
    const bool frozen = h0 < 0;  // one cluster, headed at tau = 0
    if (frozen) h0 = 0;
    // (2) each cluster's dE by the binary counter, and its head's decision
    TreeSum<kTreeDepth> sum;
    XlaSum whole(L);
    for (int j = 0, x = h0, head = h0; j < L; ++j, x = x + 1 == L ? 0 : x + 1) {
        const float v = slice_de(x, (int)lp[x]);
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
            if (!get_bit(act, x)) {  // the cluster ends at x
                ends = true;
                acc = sum.total();
            }
        }
        if (ends) {
            if (head_flips(head, acc)) set_bit(dec, head);
            sum.count = 0;
            head = x + 1 == L ? 0 : x + 1;
        }
    }
    // (3) a head (after a thawed bond, or tau = 0 of a frozen line) sets the
    // decision its cluster takes
    bool flip = false;
#pragma unroll 4
    for (int j = 0, x = h0; j < L; ++j, x = x + 1 == L ? 0 : x + 1) {
        if (j == 0 || !get_bit(act, x == 0 ? L - 1 : x - 1)) flip = get_bit(dec, x);
        if (flip) lp[x] = (int8_t)(-lp[x]);
    }
}

}  // namespace
