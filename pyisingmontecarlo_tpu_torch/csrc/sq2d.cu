// Checkerboard Glauber sweeps on R replicas of an L x L uniform-J periodic
// square lattice, for sm_90a: the kernel sq2d_tiled.
//
// Replaces the three Pallas TPU kernels of pyisingmontecarlo_tpu/ops/sq2d_pallas.py:
// _kernel (plain sweeps, l.159), _kernel_sample (state staged every freq sweeps,
// l.180) and _kernel_testbits (explicit random planes, l.315), as one kernel
// with two optional modes. The semantics, the randomness contract and the plain
// PyTorch version it is held to are in pyisingmontecarlo_tpu_torch/ops/sq2d.py.
// Acceptance compares a 31-bit draw with one of ten int31 thresholds of the
// sweep's row of a [T, 10] table made once on the host (never expf here: the
// plain version must agree bit for bit).
//
// Temporal blocking: one launch runs K sweeps. A block owns one
// B x B tile of one replica and holds the tile with a halo of 2K sites (the
// box, w = B + 4K a side) in shared memory, as the TPU kernel holds both
// color planes in VMEM for a whole call. Phase j of a launch (j = 0 .. 2K-1)
// updates its color only where a site is at least j + 1 sites from the box's
// edge, so its four neighbours were exact after phase j - 1; after 2K phases
// the tile is exact. Box coordinates are global coordinates mod L, and every
// draw keeps its global key (pos = x*L/2 + y/2, ctr = 2*(ctr0 + t) + p), so a
// site that several boxes hold, or one box holds twice (L < w), takes the
// same value everywhere. A launch reads one [R, L, L] buffer and writes the
// tiles into another (blocks read their neighbours' tiles as halo), so the
// launcher alternates two buffers and never updates in place.
//
// In shared memory the box is packed as the JAX kernel packs the lattice:
// plane E holds the sites with x + y even at column c = y/2, O the others
// (the box's origin is even, so local and global colors agree). A phase's
// sites are then contiguous, and a thread updates four of them from one
// 32-bit word of its plane: the neighbours are the same word of the other
// plane in rows i - 1 and i + 1, and in row i that word and the same shifted
// by one byte to the left or the right, by the row's parity. A neighbour count
// is four byte-wise adds of the spins' sign bits (bit 1 of a byte), so the
// table index of four sites costs a handful of word operations; the lane
// hash, one per site, is what remains. The box is loaded with 2- to 16-byte vector loads (the widest
// that L, B, 2K and the buffers' alignment allow: a chunk never crosses the
// periodic edge), four rows a thread in flight, and packed in registers with
// byte permutes; the tile is unpacked the same way on the way out. (cp.async
// would land the bytes unpacked, and a launch has no work to overlap with
// its box: every phase needs all of it.) In sampling mode the tile is exact
// after every sweep of a launch, so a sample is written from shared memory
// inside the launch. In explicit-randoms mode each box site reads
// rb[2t + p] at its global packed position, halo sites included.
//
// What bounds it: the integer (ALU) pipe. The lane hash is 11 ALU
// instructions a site and 6 multiply-adds, which issue to the FMA pipe; the
// neighbour sums, the table lookups, the flips and the row loop's own
// addresses and test add about 6 more ALU instructions a site, four sites at
// a time (the thresholds are stored as ~t, so that the flip mask is the sign
// bytes of u + ~t, gathered four at a time by prmt). The halo adds
// redundant updates (1.12x the tile's at B = 256, K = 8), and each launch
// pays a fixed cost for the box in and the tile out;
// sq2d_plan takes the largest tiles that still fill the card. A sweep moves
// 2 bytes a site once every K sweeps.

#include <cstdint>
#include <cuda_runtime.h>

#include "lanerng.cuh"

namespace {

constexpr int kTiledThreads = 256;
constexpr int kLoadBatch = 4;  // box rows a thread loads before it packs them

struct TiledArgs {
    const int8_t* src;     // [R, L, L], read
    int8_t* dst;           // [R, L, L], the tiles written
    const int32_t* seeds;  // [R]
    const int32_t* thr;    // [kl, 10]: this launch's rows
    const int32_t* rb;     // [2 kl, L, L/2]: this launch's planes, or null
    int8_t* samples;       // [R, nsamples, L, L], or null
    int nsamples, freq;
    int L, B, K, kl;       // tile side, halo 2K, sweeps in this launch (kl <= K)
    int t0;                // the call's sweep index of this launch's first sweep
    uint32_t ctr;          // 2 * (ctr0 + t0)
    int ntiles;            // tiles a side, ceil(L / B)
};

// Bytes of dynamic shared memory of a block: the E and O planes of the box
// (w rows of P bytes each, P = w/2 rounded up to 16), the launch's threshold
// rows, and the box's packed-column and row keys. ops/sq2d.py:tiled_bytes
// mirrors it.
__host__ __device__ __forceinline__ int tiled_pitch(int w) { return ((w >> 1) + 15) & ~15; }
__host__ __device__ __forceinline__ int tiled_bytes(int B, int K) {
    const int w = B + 4 * K;
    return 2 * w * tiled_pitch(w) + 4 * ((10 * K + 3) & ~3) + 4 * (((w >> 1) + 3) & ~3) + 4 * w;
}

// V bytes of one global row (V/2 site pairs), in registers.
template <int V>
struct Chunk {
    uint32_t w[V >= 4 ? V / 4 : 1];
};

template <int V>
__device__ __forceinline__ Chunk<V> load_chunk(const int8_t* g) {
    Chunk<V> c;
    if constexpr (V == 16) {
        const uint4 v = *reinterpret_cast<const uint4*>(g);
        c.w[0] = v.x, c.w[1] = v.y, c.w[2] = v.z, c.w[3] = v.w;
    } else if constexpr (V == 8) {
        const uint2 v = *reinterpret_cast<const uint2*>(g);
        c.w[0] = v.x, c.w[1] = v.y;
    } else if constexpr (V == 4) {
        c.w[0] = *reinterpret_cast<const uint32_t*>(g);
    } else {
        c.w[0] = *reinterpret_cast<const uint16_t*>(g);
    }
    return c;
}

// A chunk -> V/2 bytes each of E and O. Even rows put even columns in E, odd rows in O.
template <int V>
__device__ __forceinline__ void pack_chunk(const Chunk<V>& c, uint8_t* e, uint8_t* o, int odd) {
    if constexpr (V == 16) {
        uint2 ev = make_uint2(__byte_perm(c.w[0], c.w[1], 0x6420), __byte_perm(c.w[2], c.w[3], 0x6420));
        uint2 od = make_uint2(__byte_perm(c.w[0], c.w[1], 0x7531), __byte_perm(c.w[2], c.w[3], 0x7531));
        if (odd) { const uint2 t = ev; ev = od; od = t; }
        *reinterpret_cast<uint2*>(e) = ev;
        *reinterpret_cast<uint2*>(o) = od;
    } else if constexpr (V == 8) {
        const uint32_t ev = __byte_perm(c.w[0], c.w[1], 0x6420), od = __byte_perm(c.w[0], c.w[1], 0x7531);
        *reinterpret_cast<uint32_t*>(e) = odd ? od : ev;
        *reinterpret_cast<uint32_t*>(o) = odd ? ev : od;
    } else if constexpr (V == 4) {
        const uint16_t ev = (uint16_t)__byte_perm(c.w[0], 0, 0x20), od = (uint16_t)__byte_perm(c.w[0], 0, 0x31);
        *reinterpret_cast<uint16_t*>(e) = odd ? od : ev;
        *reinterpret_cast<uint16_t*>(o) = odd ? ev : od;
    } else {
        const uint8_t ev = (uint8_t)(c.w[0] & 0xFF), od = (uint8_t)(c.w[0] >> 8);
        *e = odd ? od : ev;
        *o = odd ? ev : od;
    }
}

// The inverse of pack_chunk: V/2 bytes each of E and O -> V bytes of a row.
template <int V>
__device__ __forceinline__ void store_unpack(int8_t* g, const uint8_t* e, const uint8_t* o, int odd) {
    if constexpr (V == 16) {
        uint2 ev = *reinterpret_cast<const uint2*>(e), od = *reinterpret_cast<const uint2*>(o);
        if (odd) { const uint2 t = ev; ev = od; od = t; }
        *reinterpret_cast<uint4*>(g) = make_uint4(__byte_perm(ev.x, od.x, 0x5140), __byte_perm(ev.x, od.x, 0x7362),
                                                  __byte_perm(ev.y, od.y, 0x5140), __byte_perm(ev.y, od.y, 0x7362));
    } else if constexpr (V == 8) {
        uint32_t ev = *reinterpret_cast<const uint32_t*>(e), od = *reinterpret_cast<const uint32_t*>(o);
        if (odd) { const uint32_t t = ev; ev = od; od = t; }
        *reinterpret_cast<uint2*>(g) = make_uint2(__byte_perm(ev, od, 0x5140), __byte_perm(ev, od, 0x7362));
    } else if constexpr (V == 4) {
        uint32_t ev = *reinterpret_cast<const uint16_t*>(e), od = *reinterpret_cast<const uint16_t*>(o);
        if (odd) { const uint32_t t = ev; ev = od; od = t; }
        *reinterpret_cast<uint32_t*>(g) = __byte_perm(ev, od, 0x5140);
    } else {
        const uint16_t ev = *e, od = *o;
        *reinterpret_cast<uint16_t*>(g) = odd ? (uint16_t)(od | (ev << 8)) : (uint16_t)(ev | (od << 8));
    }
}

// The tile (box rows and columns H .. H + B - 1, clipped to the lattice where
// the last tile a side is partial or B > L) into out[L, L].
template <int V>
__device__ __forceinline__ void store_tile(int8_t* out, const uint8_t* E, const uint8_t* O, int P, int H, int B,
                                           int L, int X0, int Y0) {
    // a thread keeps one chunk column m and takes every rs-th row
    const int nch = B / V, rs = kTiledThreads / nch, m = threadIdx.x % nch, y = Y0 + m * V;
    if ((int)threadIdx.x >= rs * nch || y >= L) return;
    for (int ii = threadIdx.x / nch; ii < B && X0 + ii < L; ii += rs) {
        const int off = (H + ii) * P + ((H + m * V) >> 1);
        store_unpack<V>(out + (size_t)(X0 + ii) * L + y, E + off, O + off, (H + ii) & 1);
    }
}

// The sign of each of four int32 values as one byte each: 0xFF where negative, else 0 (prmt's
// sign-replicating selectors: 0xB and 0xF take the sign of byte 3 of the first and second operand).
__device__ __forceinline__ uint32_t signs4(uint32_t d0, uint32_t d1, uint32_t d2, uint32_t d3) {
    uint32_t lo, hi;
    asm("prmt.b32 %0, %1, %2, 0xFB;" : "=r"(lo) : "r"(d0), "r"(d1));
    asm("prmt.b32 %0, %1, %2, 0xFB;" : "=r"(hi) : "r"(d2), "r"(d3));
    return __byte_perm(lo, hi, 0x5410);
}

// u + nt as int32 with its bit 31 the sign of the exact sum (u <= t for nt = ~t). A hashed draw u lies in
// [0, 2^31) and nt in [-2^31, 0] (the stored table), so the wrapped sum is exact; a draw from a random
// plane may be any int32, so the sum's sign is corrected where it overflowed (u and nt of one sign, the
// sum of the other), one LOP3.
template <bool RB>
__device__ __forceinline__ uint32_t flip_sign(uint32_t u, uint32_t nt) {
    const uint32_t d = u + nt;
    return RB ? d ^ ((d ^ u) & (d ^ nt)) : d;
}

// grid = (ntiles^2, R); one block per (tile, replica). The launch bound's one block an SM lets ptxas
// spend registers (47 to 55 by instance, against 32 to 40 without it; chip_smoke.py's build prints them)
// on running the row loop's four draws side by side: with one block an SM, two warps a scheduler, the
// loop's latency is hidden by its own instructions or not at all.
template <int V, bool RB>
__global__ void __launch_bounds__(kTiledThreads, 1) sq2d_tiled(const TiledArgs a) {
    extern __shared__ __align__(16) uint8_t smem[];
    const int L = a.L, W = L >> 1, B = a.B, H = 2 * a.K, w = B + 2 * H, hw = w >> 1;
    const int P = tiled_pitch(w);
    uint8_t* E = smem;
    uint8_t* O = smem + w * P;
    int* thr_s = reinterpret_cast<int*>(smem + 2 * w * P);
    int* kpos = thr_s + ((10 * a.K + 3) & ~3);  // global packed column of box column c
    int* xpos = kpos + ((hw + 3) & ~3);         // global row of box row i, times L/2
    const int r = blockIdx.y, tid = threadIdx.x;
    const int X0 = (blockIdx.x / a.ntiles) * B, Y0 = (blockIdx.x % a.ntiles) * B;
    const int x0 = ((X0 - H) % L + L) % L, y0 = ((Y0 - H) % L + L) % L;
    const size_t plane = (size_t)L * L;

    // thresholds as ~t = -t - 1, so that a draw u flips its site where u + ~t < 0 (u <= t; flip_sign). A
    // hashed draw lies in [0, 2^31), so a threshold below -1 flips no site, as -1 does, and is stored as
    // -1: then u + ~t cannot overflow.
    for (int f = tid; f < 10 * a.kl; f += kTiledThreads)
        thr_s[f] = ~(RB ? __ldg(a.thr + f) : max(__ldg(a.thr + f), -1));
    for (int f = tid; f < hw; f += kTiledThreads) kpos[f] = ((y0 >> 1) + f) % W;
    for (int f = tid; f < w; f += kTiledThreads) xpos[f] = ((x0 + f) % L) * W;
    __syncthreads();
    {
        // a thread keeps one chunk column m of the box and takes every rs-th row, with kLoadBatch loads
        // in flight
        const int nch = w / V, rs = kTiledThreads / nch, m = tid % nch;
        const int8_t* src = a.src + r * plane + (y0 + m * V) % L;
        if (tid < rs * nch)
            for (int i0 = tid / nch; i0 < w; i0 += kLoadBatch * rs) {
                Chunk<V> c[kLoadBatch];
#pragma unroll
                for (int u = 0; u < kLoadBatch; ++u)
                    if (i0 + u * rs < w) c[u] = load_chunk<V>(src + 2 * (size_t)xpos[i0 + u * rs]);
#pragma unroll
                for (int u = 0; u < kLoadBatch; ++u) {
                    const int i = i0 + u * rs, off = i * P + m * (V / 2);
                    if (i < w) pack_chunk<V>(c[u], E + off, O + off, i & 1);
                }
            }
    }
    __syncthreads();

    // a thread keeps one word column q (four packed columns) of the box for the launch, and takes rows
    // r0, r0 + RS, ... of each phase's region; its columns' global keys stay in registers
    const int nW = hw >> 2, RS = kTiledThreads / nW;
    const int q = tid % nW, r0 = tid / nW;
    const int4 kg = *reinterpret_cast<const int4*>(kpos + 4 * q);
    const uint32_t seed = (uint32_t)__ldg(a.seeds + r);
    const int nphases = 2 * a.kl;
    for (int jp = 0; jp < nphases; ++jp) {
        const int tl = jp >> 1, p = jp & 1;
        const int lo = jp + 1, hi = w - 2 - jp;  // the sites this phase updates: lo <= i, j <= hi
        // per row parity: 0xFE in each byte of the word whose site (box column 8q + 2b + par) is in range
        uint32_t in0 = 0, in1 = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
            const int j = 8 * q + 2 * b;
            in0 |= (j >= lo && j <= hi) ? 0xFEu << (8 * b) : 0u;
            in1 |= (j + 1 >= lo && j + 1 <= hi) ? 0xFEu << (8 * b) : 0u;
        }
        if (r0 < RS && (in0 | in1)) {
            uint8_t* Pp = p ? O : E;
            const uint8_t* Q = p ? E : O;
            const uint8_t* th = reinterpret_cast<const uint8_t*>(thr_s + 10 * tl);
            const uint32_t ctr = a.ctr + 2u * tl + p;
            const uint32_t ha0 = seed + ctr * 0xC2B2AE3Du, hb0 = ctr * 0x27D4EB2Eu;
            const int32_t* rbp = RB ? a.rb + (size_t)jp * L * W : nullptr;
            for (int i = lo + r0; i <= hi; i += RS) {
                const int par = (i + p) & 1;  // box column of packed column c: 2c + par
                uint8_t* row = Pp + i * P + 4 * q;
                const uint8_t* qr = Q + i * P + 4 * q;
                const uint32_t self = *reinterpret_cast<const uint32_t*>(row);
                const uint32_t up = *reinterpret_cast<const uint32_t*>(qr - P);
                const uint32_t dn = *reinterpret_cast<const uint32_t*>(qr + P);
                const uint32_t mid = *reinterpret_cast<const uint32_t*>(qr);
                const uint32_t nb = *reinterpret_cast<const uint32_t*>(qr + (par ? 4 : -4));
                const uint32_t side = par ? __funnelshift_r(mid, nb, 8) : __funnelshift_l(nb, mid, 8);
                // bit 1 of a spin's byte is set for -1 (0xFF) and clear for +1 (0x01): per byte, twice the
                // down neighbours plus ten for a down site, then 4 * the threshold's index
                // 5 * (s > 0) + (up neighbours) = 9 - 5 * (s < 0) - (down neighbours)
                constexpr uint32_t kOnes = 0x01010101u, kTwos = 0x02020202u;
                const uint32_t down2 = (up & kTwos) + (dn & kTwos) + (mid & kTwos) + (side & kTwos) + 5u * (self & kTwos);
                const uint32_t idx4 = 36u * kOnes - 2u * down2;
                const uint32_t xw = (uint32_t)xpos[i];
                const uint32_t ha = ha0 + xw * 0x9E3779B1u, hb = hb0 + xw * 0x85EBCA77u;
                uint32_t d[4];  // u - t - 1: negative where the site flips
#pragma unroll
                for (int b = 0; b < 4; ++b) {
                    const uint32_t k = (uint32_t)(b == 0 ? kg.x : b == 1 ? kg.y : b == 2 ? kg.z : kg.w);
                    const uint32_t nt = *reinterpret_cast<const uint32_t*>(th + __byte_perm(idx4, 0, 0x4440 | b));
                    d[b] = flip_sign<RB>(RB ? (uint32_t)__ldg(rbp + xw + k) : lane_draw31_split(ha, hb, k), nt);
                }
                *reinterpret_cast<uint32_t*>(row) = self ^ (signs4(d[0], d[1], d[2], d[3]) & (par ? in1 : in0));
            }
        }
        __syncthreads();
        const int t = a.t0 + tl + 1;  // sweeps done
        if (p == 1 && a.samples && t % a.freq == 0 && t / a.freq <= a.nsamples) {
            store_tile<V>(a.samples + ((size_t)r * a.nsamples + t / a.freq - 1) * plane, E, O, P, H, B, L, X0, Y0);
            __syncthreads();
        }
    }
    store_tile<V>(a.dst + r * plane, E, O, P, H, B, L, X0, Y0);
}

template <int V, bool RB>
cudaError_t launch_tiled(const TiledArgs& a, int R, int smem, cudaStream_t st) {
    cudaError_t e = cudaFuncSetAttribute(sq2d_tiled<V, RB>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    sq2d_tiled<V, RB><<<dim3(a.ntiles * a.ntiles, R), kTiledThreads, smem, st>>>(a);
    return cudaGetLastError();
}

}  // namespace

// Runs T sweeps of sq2d_tiled on `stream`: ceil(T / K) launches of up to K
// sweeps each, on tiles of B x B (B a multiple of 8, K even: ops/sq2d.py's
// sq2d_plan). s is read by the first launch only; the launches alternate
// between out and tmp so that the last writes out (tmp is unused, and may be
// null, for one launch). thr is [T, 10]; rb is [2T, L, L/2] or null; samples
// is [R, nsamples, L, L] or null, a slot written after every freq sweeps.
// Returns the first CUDA error, else 0.
extern "C" int sq2d_tiled_sweeps(const void* s, void* out, void* tmp, const void* seeds, const void* thr,
                                 const void* rb, void* samples, int R, int L, int T, int ctr0, int freq,
                                 int nsamples, int B, int K, void* stream) {
    if (B < 8 || B % 8 || K < 2 || K % 2 || L < 4 || L % 2 || (B + 4 * K) / 8 + 1 > kTiledThreads)
        return (int)cudaErrorInvalidValue;
    const int ntiles = (L + B - 1) / B, smem = tiled_bytes(B, K);
    if ((long long)ntiles * ntiles >= (1LL << 31)) return (int)cudaErrorInvalidValue;
    // the widest chunk of a row that L, B and 2K (so every box and tile column origin) and the buffers allow
    int V = 16;
    const uintptr_t align = (uintptr_t)s | (uintptr_t)out | (uintptr_t)tmp | (uintptr_t)samples;
    while (V > 2 && (L % V || B % V || (2 * K) % V || align % V)) V >>= 1;
    // a thread of the box load and of store_tile takes one chunk column (the tile's are fewer)
    if ((B + 4 * K) / V > kTiledThreads) return (int)cudaErrorInvalidValue;
    const int n = (T + K - 1) / K;
    const int8_t* in = static_cast<const int8_t*>(s);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    for (int m = 0; m < n; ++m) {
        const int t0 = m * K;
        int8_t* dst = static_cast<int8_t*>((n - 1 - m) % 2 == 0 ? out : tmp);
        TiledArgs a{in, dst, static_cast<const int32_t*>(seeds), static_cast<const int32_t*>(thr) + 10LL * t0,
                    rb ? static_cast<const int32_t*>(rb) + 2LL * t0 * L * (L / 2) : nullptr,
                    static_cast<int8_t*>(samples), nsamples, freq, L, B, K, T - t0 < K ? T - t0 : K, t0,
                    (uint32_t)(2 * (ctr0 + t0)), ntiles};
        cudaError_t e;
        switch (V * 2 + (rb != nullptr)) {
            case 32: e = launch_tiled<16, false>(a, R, smem, st); break;
            case 33: e = launch_tiled<16, true>(a, R, smem, st); break;
            case 16: e = launch_tiled<8, false>(a, R, smem, st); break;
            case 17: e = launch_tiled<8, true>(a, R, smem, st); break;
            case 8: e = launch_tiled<4, false>(a, R, smem, st); break;
            case 9: e = launch_tiled<4, true>(a, R, smem, st); break;
            case 4: e = launch_tiled<2, false>(a, R, smem, st); break;
            default: e = launch_tiled<2, true>(a, R, smem, st); break;
        }
        if (e != cudaSuccess) return (int)e;
        in = dst;
    }
    return 0;
}

extern "C" const char* pmc_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
