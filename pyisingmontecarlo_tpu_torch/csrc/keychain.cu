// The threefry2x32 key chains of the graph engines for sm_90a: every replica's
// key split once per move of every time step (or sweep) of a call, and the
// tables the moves read, in one launch.
//
// Replaces no Pallas kernel: the JAX package splits the keys inside its XLA
// steps (pyisingmontecarlo_tpu/engines/classical.py, time_step l.655-705 and
// the splits of _worm_walk l.477-482 and sw_cluster_update l.592-594;
// engines/worldline.py, sweep; engines/generic.py, sweep l.878-899 with the
// inner splits of segment_color_update l.771, term_kink_update l.817,
// slice_color_update l.745-746 and free_var_update l.873, and
// engines/generic_gm.py, sweep_gm l.761-790), through rng.split_keys,
// jax.random.randint and jax.random.bernoulli. The semantics and the numpy
// version it is held to bit for bit are rng.threefry_chain_reference in
// pyisingmontecarlo_tpu_torch/rng.py.
//
// The chain of T steps of S slots (plan[S][2]: kind, param). Each slot splits
// the key, keys, sub = split(key), then by kind: 0 plain writes the int32 lane
// seed (k0 ^ 0x9E3779B9 ^ (k1 << 1)) of sub; 1 worm and 4 slice write the
// lane seed of split(sub)[0] and randint(split(sub)[1], param) with jax's
// algorithm (param: nvars for a worm, the slice count for a slice); 2 cluster
// writes three lane seeds; 3 fan walks sub, k = split(sub) param times and
// writes each k's lane seed; 5 bits writes the param words of
// bernoulli(sub, 0.5, (param,)), 1 where the word's top bit is 0; 6 uniform
// writes the param words of uniform(sub, (param,)) as f32 bit patterns,
// (b >> 9 | 0x3F800000) as f32 - 1 of the word's bits b (the swap uniforms
// of pyisingmontecarlo_tpu_torch/tempering.py, one key). Lane seeds
// go to seeds[T][C][R], randint draws, bits and uniforms to v0[T][W][R] (C and W:
// rng.chain_columns); keys_out gets each replica's key after the T steps.
// threefry2x32 is the 20-round block function with the key schedule
// (k0, k1, k0 ^ k1 ^ 0x1BD11BDA); split(k) is the block at counters (0, 0)
// and (0, 1), the i-th 32 random bits the xor of the two words at (0, i).
//
// Design: only the spine, key -> split(key)[0], is serial along the T S
// slots; no slot's expansion feeds the next slot. A block takes 32 replicas
// (lane = replica). Its spine warp walks the slots and, for each, puts the
// key into a ring of kChainStages stages in shared memory, kChainBatch slots
// a stage, and computes key' = threefry(key, 0, 0): one block a slot, and
// nothing else on its path (it reads no plan; computing the sub-key there as
// well, a second block beside key', cost it 9-16% a call). Six expansion
// warps take the batches in turn (warp e the batches e, e + 6, ...), each
// keeping its own place in the plan and the tables (plan_columns: the
// columns of the slots it passes, a slot a lane), split off each slot's
// sub = threefry(key, 0, 1), expand it into the slot's outputs and store
// them, each store one row of 32 replicas. Producer and consumers meet at
// two mbarriers a stage (full: the spine's 32 lanes arrive; empty: the
// consuming warp's 32 lanes), once a batch. A stage's phase parity
// identifies its batch, since a consumer waits for batch g only after its
// batch g - 6 was written and the spine writes batch g only after batch
// g - kChainStages was read. Warp w issues from the SM's scheduler w % 4 (an
// H100 SM has four), so warp 4, which would share the spine's, only sets up
// and leaves.
//
// Bound: the spine is T S dependent steps, each one block's dependent chain:
// T S times one step's latency (a step chained alone in one thread, about
// 113 ns on an H100; PERF.md) is the chain's floor whatever the design.
// The roofline is far lower: the tables' bytes (4 R (C + W) T) at
// the HBM rate against every block's ALU instructions (about 50 a block) at
// the card's integer rate, at the main paths' R = 64 to 100. So the design
// keeps the expansion off the spine: a thread walking every block of every
// slot of its replica would run 144 blocks a sweep in line on the hard
// 32-ring plan, where the spine has 26.

// threefry_bits: jax.random.bits(key, (n,)) and jax.random.uniform(key, (n,))
// for R keys, one row each, on the card: bits[r][i] = y0 ^ y1 with (y0, y1) =
// threefry2x32(key_r, (i >> 32, i & 0xFFFFFFFF)), the uniform
// (bits >> 9 | 0x3F800000) as f32 - 1. The numpy version it is held to bit for
// bit is rng.random_bits / rng.uniform_f32. Replaces no Pallas kernel: the JAX
// package draws these inside its XLA programs, the spatially and tau-sharded
// sweeps' jax.random.uniform over whole state shapes
// (pyisingmontecarlo_tpu/parallel/spatial.py:76, parallel/tau.py:104,117-118).
// Bound: one block function a counter, 50 ALU instructions (SASS, nvcc 12.9),
// against 4 bytes written: the integer pipe, not HBM, sets the least time
// (0.024 ms against 0.010 ms for 8 M). One thread a counter in a grid-stride
// loop over the row, one grid row a key; the same threefry device function
// as the chain, written once.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) { return __funnelshift_l(x, x, r); }

struct Key {
    uint32_t k0, k1;
};

// threefry2x32(key, (x0, x1)) -> (y0, y1)
__device__ __forceinline__ Key threefry(Key k, uint32_t x0, uint32_t x1) {
    const uint32_t ks[3] = {k.k0, k.k1, k.k0 ^ k.k1 ^ 0x1BD11BDAu};
    constexpr int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
    x0 += ks[0];
    x1 += ks[1];
#pragma unroll
    for (int n = 0; n < 5; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            x0 += x1;
            x1 = rotl(x1, rot[n % 2][i]) ^ x0;
        }
        x0 += ks[(n + 1) % 3];
        x1 += ks[(n + 2) % 3] + static_cast<uint32_t>(n + 1);
    }
    return Key{x0, x1};
}

__device__ __forceinline__ int32_t lane_seed(Key k) {
    return static_cast<int32_t>(k.k0 ^ 0x9E3779B9u ^ (k.k1 << 1));
}

__device__ __forceinline__ uint32_t bits32(Key k) {
    const Key y = threefry(k, 0u, 0u);
    return y.k0 ^ y.k1;
}

// jax.random.randint(k, (), 0, span) for int32, span >= 1 (jax/_src/random.py _randint)
__device__ __forceinline__ int32_t randint(Key k, uint32_t span) {
    const uint32_t hi = bits32(threefry(k, 0u, 0u));
    const uint32_t lo = bits32(threefry(k, 0u, 1u));
    uint32_t mult = 65536u % span;
    mult = (mult * mult) % span;  // wraps to 0 for span > 2^16, as jax's uint32 product does
    return static_cast<int32_t>(((hi % span) * mult + lo % span) % span);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile(
        "{\n"
        ".reg .b64 state;\n"
        "mbarrier.arrive.shared::cta.b64 state, [%0];\n"
        "}\n" ::"r"(smem_addr(bar))
        : "memory");
}

// Waits until the phase of parity `parity` of bar has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
    asm volatile(
        "{\n"
        ".reg .pred done;\n"
        "WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
        "@!done bra WAIT;\n"
        "}\n" ::"r"(smem_addr(bar)),
        "r"(parity)
        : "memory");
}

// The lane seeds and int words a slot of this kind and param writes (rng._slot_columns), with no branch.
__device__ __forceinline__ int2 slot_columns(int kind, int param) {
    const bool one = kind == 0 || kind == 1 || kind == 4;
    return make_int2(one ? 1 : kind == 2 ? 3 : kind == 3 ? param : 0,
                     kind == 1 || kind == 4 ? 1 : kind == 5 || kind == 6 ? param : 0);
}

// The outputs of a slot from its sub-key: sp and vp point at the replica's
// entry of the slot's first seed column and first int word (rows R apart);
// nothing is stored where live is false.
__device__ __forceinline__ void expand(Key sub, int kind, int param, int32_t* sp, int32_t* vp, size_t R, bool live) {
    if (kind == 0) {
        if (live) *sp = lane_seed(sub);
    } else if (kind == 1 || kind == 4) {
        const int32_t seed = lane_seed(threefry(sub, 0u, 0u));
        const int32_t v = randint(threefry(sub, 0u, 1u), static_cast<uint32_t>(param));
        if (live) *sp = seed, *vp = v;
    } else if (kind == 2) {
        const Key k1 = threefry(sub, 0u, 0u);
        const int32_t a = lane_seed(threefry(sub, 0u, 1u));
        const Key k2 = threefry(k1, 0u, 0u);
        const int32_t b = lane_seed(threefry(k1, 0u, 1u)), c = lane_seed(threefry(k2, 0u, 1u));
        if (live) sp[0] = a, sp[R] = b, sp[2 * R] = c;
    } else if (kind == 3) {
        for (int j = 0; j < param; ++j) {
            const int32_t seed = lane_seed(threefry(sub, 0u, 1u));
            sub = threefry(sub, 0u, 0u);
            if (live) sp[j * R] = seed;
        }
    } else {  // bits (5) or uniform (6)
        for (int i = 0; i < param; ++i) {
            const Key y = threefry(sub, 0u, static_cast<uint32_t>(i));
            const uint32_t b = y.k0 ^ y.k1;
            const uint32_t u = __float_as_uint(__uint_as_float((b >> 9) | 0x3F800000u) - 1.0f);
            if (live) vp[i * R] = static_cast<int32_t>(kind == 5 ? (b < 0x80000000u ? 1u : 0u) : u);
        }
    }
}

constexpr int kChainWarps = 8;  // warp 0 the spine, 1-3 and 5-7 the expansion, 4 idle
constexpr int kExpandWarps = 6;
constexpr int kChainBatch = 8;    // slots a stage: the spine waits and arrives once a batch
constexpr int kChainStages = 16;  // more than kExpandWarps: a stage's parity names its batch

struct ChainStage {
    uint2 key[kChainBatch][32];  // the key each slot splits
};

// The seed columns and int words of the n slots from slot k of the plan on, cyclically, a slot a lane, summed over
// the warp (every lane gets the sums).
__device__ __forceinline__ int2 plan_columns(const int2* __restrict__ plan, int S, int k, int n) {
    const int lane = threadIdx.x & 31;
    int2 sum = make_int2(0, 0);
    for (int base = 0; base < n; base += 32) {
        if (base + lane < n) {
            const int2 p = __ldg(plan + (k + base + lane) % S);
            const int2 cw = slot_columns(p.x, p.y);
            sum.x += cw.x, sum.y += cw.y;
        }
    }
    return make_int2(__reduce_add_sync(0xffffffffu, sum.x), __reduce_add_sync(0xffffffffu, sum.y));
}

// grid: ceil(R / 32) blocks of kChainWarps warps, 32 replicas a block.
__global__ void __launch_bounds__(32 * kChainWarps) threefry_chain_kernel(
    const uint32_t* __restrict__ keys_in, uint32_t* __restrict__ keys_out, const int32_t* __restrict__ plan, int S,
    int J, int R, int32_t* __restrict__ seeds, int32_t* __restrict__ v0) {
    __shared__ ChainStage stage[kChainStages];
    __shared__ uint64_t full[kChainStages], empty[kChainStages];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int r = blockIdx.x * 32 + lane;
    const bool live = r < R;
    const int batches = (J + kChainBatch - 1) / kChainBatch;
    if (threadIdx.x < kChainStages) {
        mbar_init(&full[threadIdx.x], 32);
        mbar_init(&empty[threadIdx.x], 32);
    }
    __syncthreads();
    if (warp == 0) {  // the spine: key' = threefry(key, 0, 0), a batch of keys a stage
        Key key = live ? Key{keys_in[2 * r], keys_in[2 * r + 1]} : Key{0u, 0u};
        for (int g = 0; g < batches; ++g) {
            const int s = g % kChainStages, n = g / kChainStages;
            if (n > 0) mbar_wait(&empty[s], (n - 1) & 1);
#pragma unroll
            for (int b = 0; b < kChainBatch; ++b) {
                if (g * kChainBatch + b < J) {
                    stage[s].key[b][lane] = make_uint2(key.k0, key.k1);
                    key = threefry(key, 0u, 0u);
                }
            }
            mbar_arrive(&full[s]);
        }
        if (live) {
            keys_out[2 * r] = key.k0;
            keys_out[2 * r + 1] = key.k1;
        }
    } else if (warp != 4) {  // an expansion warp: batches e, e + kExpandWarps, ...
        const int e = warp < 4 ? warp - 1 : warp - 2;
        const int2* plan2 = reinterpret_cast<const int2*>(plan);
        // the batch's first slot in the plan, and its first seed column and int word, counted from seeds and v0
        int k = 0, col = 0, word = 0;
        {
            const int2 cw = plan_columns(plan2, S, 0, min(J, e * kChainBatch));
            k = e * kChainBatch % S, col = cw.x, word = cw.y;
        }
        for (int g = e; g < batches; g += kExpandWarps) {
            const int s = g % kChainStages, n = g / kChainStages;
            const int m = min(kChainBatch, J - g * kChainBatch);  // the batch's slots
            // lane b < m: slot b's (kind, param) and its first column and word, an exclusive scan over the lanes
            const int2 p = lane < m ? __ldg(plan2 + (k + lane) % S) : make_int2(0, 0);
            const int2 cw0 = lane < m ? slot_columns(p.x, p.y) : make_int2(0, 0);
            int2 cw = cw0;
#pragma unroll
            for (int d = 1; d < kChainBatch; d <<= 1) {
                const int x = __shfl_up_sync(0xffffffffu, cw.x, d), y = __shfl_up_sync(0xffffffffu, cw.y, d);
                if (lane >= d) cw.x += x, cw.y += y;
            }
            mbar_wait(&full[s], n & 1);
            for (int b = 0; b < m; ++b) {
                const uint2 u = stage[s].key[b][lane];
                const int kind = __shfl_sync(0xffffffffu, p.x, b), param = __shfl_sync(0xffffffffu, p.y, b);
                const int c = col + __shfl_sync(0xffffffffu, cw.x - cw0.x, b);
                const int w = word + __shfl_sync(0xffffffffu, cw.y - cw0.y, b);
                const Key sub = threefry(Key{u.x, u.y}, 0u, 1u);
                expand(sub, kind, param, seeds + (size_t)c * R + r, v0 + (size_t)w * R + r, static_cast<size_t>(R),
                       live);
            }
            mbar_arrive(&empty[s]);
            // past this batch and the other warps' batches before this warp's next
            const int skip = min(J - g * kChainBatch, kExpandWarps * kChainBatch);
            const int2 more = plan_columns(plan2, S, k, skip);
            k = (k + skip) % S, col += more.x, word += more.y;
        }
    }
}

constexpr int kBitsThreads = 256;

__global__ void __launch_bounds__(kBitsThreads) threefry_bits_kernel(const uint32_t* __restrict__ keys, long long n,
                                                                     int uniform, uint32_t* __restrict__ out) {
    const int r = blockIdx.y;
    const Key key{keys[2 * r], keys[2 * r + 1]};
    uint32_t* row = out + static_cast<long long>(r) * n;
    for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
         i += static_cast<long long>(gridDim.x) * blockDim.x) {
        const Key y = threefry(key, static_cast<uint32_t>(static_cast<unsigned long long>(i) >> 32),
                               static_cast<uint32_t>(i));
        const uint32_t b = y.k0 ^ y.k1;
        row[i] = uniform ? __float_as_uint(__uint_as_float((b >> 9) | 0x3F800000u) - 1.0f) : b;
    }
}

}  // namespace

// keys [R][2] uint32 (device), out [R][n] uint32 bits, or f32 uniforms when uniform != 0. On the caller's stream.
extern "C" int threefry_bits(const void* keys, int R, long long n, int uniform, void* out, void* stream) {
    if (R < 1 || R > 65535 || n < 1 || keys == nullptr || out == nullptr) return (int)cudaErrorInvalidValue;
    const long long want = (n + kBitsThreads - 1) / kBitsThreads;
    const unsigned gx = static_cast<unsigned>(want < (1LL << 20) ? want : (1LL << 20));
    threefry_bits_kernel<<<dim3(gx, R), kBitsThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(keys), n, uniform, static_cast<uint32_t*>(out));
    return (int)cudaGetLastError();
}

// keys_in/keys_out [R][2] uint32, plan [S][2] int32 (kind, param: nvars for a worm slot), seeds [T][C][R] int32
// (may be null when C == 0), v0 [T][W][R] int32 (may be null when W == 0). C and W must be the columns and int
// words of the plan (rng.chain_columns); T S < 2^31. On the caller's stream.
extern "C" int threefry_chain(const void* keys_in, void* keys_out, const void* plan, int S, int T, int C, int W,
                              int R, void* seeds, void* v0, void* stream) {
    if (R < 1 || S < 1 || T < 1 || C < 0 || W < 0 || (long long)S * T > 0x7fffffffLL ||
        (C > 0 && seeds == nullptr) || (W > 0 && v0 == nullptr))
        return (int)cudaErrorInvalidValue;
    threefry_chain_kernel<<<(R + 31) / 32, 32 * kChainWarps, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(keys_in), static_cast<uint32_t*>(keys_out), static_cast<const int32_t*>(plan),
        S, S * T, R, static_cast<int32_t*>(seeds), static_cast<int32_t*>(v0));
    return (int)cudaGetLastError();
}
