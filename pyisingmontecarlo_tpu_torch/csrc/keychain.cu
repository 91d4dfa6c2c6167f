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
// One thread per replica walks its key through T steps of S slots
// (plan[S][2]: kind, param). Each slot splits the key, keys, sub = split(key),
// then by kind: 0 plain writes the int32 lane seed (k0 ^ 0x9E3779B9 ^ (k1 << 1))
// of sub; 1 worm and 4 slice write the lane seed of split(sub)[0] and
// randint(split(sub)[1], param) with jax's algorithm (param: nvars for a worm,
// the slice count for a slice); 2 cluster writes three lane seeds; 3 fan walks
// sub, k = split(sub) param times and writes each k's lane seed; 5 bits writes
// the param words of bernoulli(sub, 0.5, (param,)), 1 where the word's top bit
// is 0. Lane seeds go to seeds[T][C][R], randint draws and bits to v0[T][W][R]
// (C and W: rng.chain_columns); keys_out gets each replica's key after the T
// steps. threefry2x32 is the 20-round block function with the key schedule
// (k0, k1, k0 ^ k1 ^ 0x1BD11BDA); split(k) is the block at counters (0, 0) and
// (0, 1), the i-th 32 random bits the xor of the two words at (0, i).
//
// Bound: the chain is serial along the steps and independent across replicas,
// so with R threads (64 to 100 on the main paths, one or two blocks of 128 on
// as many SMs) each warp issues its own threads' whole chain: every block of
// every slot (2 a plain slot, 8 a worm or slice, 7 a cluster, 2 + 2m a fan,
// 2 + m a bits slot), about 70 integer instructions each, at most one
// instruction a cycle. The tables' bytes (4 * R * (C + W) * T) are small beside
// that. The design keeps the chain in registers and writes each table entry
// once, coalesced across the replicas of a warp; nothing is read but the plan.
//
// threefry_bits: jax.random.bits(key, (n,)) and jax.random.uniform(key, (n,))
// for R keys, one row each, on the card: bits[r][i] = y0 ^ y1 with (y0, y1) =
// threefry2x32(key_r, (i >> 32, i & 0xFFFFFFFF)), the uniform
// (bits >> 9 | 0x3F800000) as f32 - 1. The numpy version it is held to bit for
// bit is rng.random_bits / rng.uniform_f32. Replaces no Pallas kernel: the JAX
// package draws these inside its XLA programs, the spatially and tau-sharded
// sweeps' jax.random.uniform over whole state shapes
// (pyisingmontecarlo_tpu/parallel/spatial.py:76, parallel/tau.py:104,117-118).
// Bound: one block function a counter, 50 ALU instructions (SASS, nvcc 12.9;
// chip_smoke.py's THREEFRY_ALU_OPS), against 4 bytes written: the integer
// pipe, not HBM, sets the least time (0.024 ms against 0.010 ms for 8 M). One thread a counter in a grid-stride loop over the row, one
// grid row a key; the same threefry device function as the chain, written once.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kChainThreads = 128;

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

__global__ void __launch_bounds__(kChainThreads) threefry_chain_kernel(
    const uint32_t* __restrict__ keys_in, uint32_t* __restrict__ keys_out, const int32_t* __restrict__ plan, int S,
    int T, int R, int32_t* __restrict__ seeds, int32_t* __restrict__ v0) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= R) return;
    Key key{keys_in[2 * r], keys_in[2 * r + 1]};
    int32_t* sp = seeds + r;
    int32_t* vp = v0 + r;
    for (int t = 0; t < T; ++t) {
        for (int k = 0; k < S; ++k) {
            Key sub = threefry(key, 0u, 1u);
            key = threefry(key, 0u, 0u);
            const int kind = __ldg(plan + 2 * k);
            const int param = __ldg(plan + 2 * k + 1);
            if (kind == 0) {
                *sp = lane_seed(sub);
                sp += R;
            } else if (kind == 1 || kind == 4) {
                *sp = lane_seed(threefry(sub, 0u, 0u));
                sp += R;
                *vp = randint(threefry(sub, 0u, 1u), static_cast<uint32_t>(param));
                vp += R;
            } else if (kind == 2) {
                const Key k1 = threefry(sub, 0u, 0u);
                sp[0] = lane_seed(threefry(sub, 0u, 1u));
                const Key k2 = threefry(k1, 0u, 0u);
                sp[R] = lane_seed(threefry(k1, 0u, 1u));
                sp[2 * R] = lane_seed(threefry(k2, 0u, 1u));
                sp += 3 * R;
            } else if (kind == 3) {
                for (int j = 0; j < param; ++j) {
                    *sp = lane_seed(threefry(sub, 0u, 1u));
                    sub = threefry(sub, 0u, 0u);
                    sp += R;
                }
            } else {
                for (int i = 0; i < param; ++i) {
                    const Key y = threefry(sub, 0u, static_cast<uint32_t>(i));
                    *vp = (y.k0 ^ y.k1) < 0x80000000u ? 1 : 0;
                    vp += R;
                }
            }
        }
    }
    keys_out[2 * r] = key.k0;
    keys_out[2 * r + 1] = key.k1;
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
// words of the plan (rng.chain_columns). On the caller's stream.
extern "C" int threefry_chain(const void* keys_in, void* keys_out, const void* plan, int S, int T, int C, int W,
                              int R, void* seeds, void* v0, void* stream) {
    if (R < 1 || S < 1 || T < 1 || C < 0 || W < 0 || (C > 0 && seeds == nullptr) || (W > 0 && v0 == nullptr))
        return (int)cudaErrorInvalidValue;
    const unsigned grid = (R + kChainThreads - 1) / kChainThreads;
    threefry_chain_kernel<<<grid, kChainThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(keys_in), static_cast<uint32_t*>(keys_out), static_cast<const int32_t*>(plan),
        S, T, R, static_cast<int32_t*>(seeds), static_cast<int32_t*>(v0));
    return (int)cudaGetLastError();
}
