// Checkerboard Glauber sweeps on R replicas of an L x L uniform-J periodic
// square lattice, for sm_90a.
//
// Replaces the three Pallas TPU kernels of pyisingmontecarlo_tpu/ops/sq2d_pallas.py:
// _kernel (plain sweeps, l.159), _kernel_sample (state staged every freq sweeps,
// l.180) and _kernel_testbits (explicit random planes, l.315), as one kernel
// with two optional modes. The semantics, the randomness contract and the plain
// PyTorch version it is held to are in pyisingmontecarlo_tpu_torch/ops/sq2d.py.
//
// Design: one launch per phase, two per sweep, all on the caller's stream. A
// thread updates one site of the active color in place in the [R, L, L] int8
// state (its four neighbours are of the other color, which no thread of the
// launch writes), so the launch needs no scratch. Acceptance compares a 31-bit
// draw with one of ten int31 thresholds of the sweep's row of a [T, 10] table
// made once on the host (never expf here: the plain version must agree bit for
// bit). In sampling mode the last phase of each freq block also writes the
// finished state into its slot of the [R, nsamples, L, L] buffer: the thread
// that updates (x, y) writes its untouched partner (x, y^1) too, so no copy
// kernel runs.
//
// What bounds it: at 1024^2 x 8 replicas the state is 8 MiB and stays in the
// 50 MB L2. Per updated site a phase reads five bytes (site and four
// neighbours, 64 contiguous bytes per warp and row), writes one, and runs about
// a dozen integer ops of hashing plus the indexing; so L2 bandwidth or the
// integer pipes bound it, and a 16384-sweep run is 32768 launches, whose gaps
// add to that. Multi-spin coding, temporal blocking and CUDA graphs are not
// done here.

#include <cstdint>
#include <cuda_runtime.h>

#include "lanerng.cuh"

namespace {

constexpr int kBlock = 128;

// grid = (ceil(W / kBlock), L, R): blockIdx.y is the row x, blockIdx.z the
// replica r, and the thread's packed column is k.
__global__ void __launch_bounds__(kBlock) sq2d_phase(
    int8_t* __restrict__ s,             // [R, L, L], updated in place
    const int32_t* __restrict__ seeds,  // [R]
    const int32_t* __restrict__ thr,    // [10]: this sweep's thresholds
    const int32_t* __restrict__ rb,     // [L, W] random plane, or null: hash
    int8_t* __restrict__ stage,         // slot 0 of this block's sample, or null
    long long stage_stride,             // bytes between replicas' samples
    int L, uint32_t ctr, int parity) {
    const int W = L >> 1;
    const int k = blockIdx.x * kBlock + threadIdx.x;
    if (k >= W) return;
    const int x = blockIdx.y;
    const int r = blockIdx.z;
    const int y = 2 * k + ((x + parity) & 1);

    int8_t* p = s + (size_t)r * L * L;
    const int row = x * L;
    const int up = (x == 0 ? L - 1 : x - 1) * L;
    const int dn = (x == L - 1 ? 0 : x + 1) * L;
    const int yl = y == 0 ? L - 1 : y - 1;
    const int yr = y == L - 1 ? 0 : y + 1;
    const int b = p[up + y] + p[dn + y] + p[row + yl] + p[row + yr];
    const int sv = p[row + y];
    const int t = __ldg(thr + 5 * (sv > 0) + ((b + 4) >> 1));
    const int pos = x * W + k;
    const int u = rb ? __ldg(rb + pos) : (int)lane_draw31((uint32_t)__ldg(seeds + r), (uint32_t)pos, ctr);
    const int8_t ns = (int8_t)(u <= t ? -sv : sv);
    p[row + y] = ns;
    if (stage) {
        int8_t* q = stage + (size_t)r * stage_stride;
        q[row + y] = ns;
        q[row + (y ^ 1)] = p[row + (y ^ 1)];
    }
}

}  // namespace

// Runs T sweeps (2T launches) on `stream`. thr is [T, 10]; rb is [2T, L, L/2]
// or null (then draws use counters 2 * (ctr0 + t) + phase); samples is
// [R, nsamples, L, L] or null, with a slot written after every freq sweeps.
// Returns cudaGetLastError() after the first failing launch, else 0.
extern "C" int sq2d_sweeps(void* s, const void* seeds, const void* thr, const void* rb,
                           void* samples, int R, int L, int T, int ctr0, int freq,
                           int nsamples, void* stream) {
    const int W = L / 2;
    const dim3 grid((W + kBlock - 1) / kBlock, L, R);
    const long long plane = (long long)L * L;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    for (int t = 0; t < T; ++t) {
        for (int ph = 0; ph < 2; ++ph) {
            int8_t* stage = nullptr;
            if (samples && ph == 1 && (t + 1) % freq == 0 && (t + 1) / freq <= nsamples)
                stage = static_cast<int8_t*>(samples) + ((t + 1) / freq - 1) * plane;
            const int32_t* rbp =
                rb ? static_cast<const int32_t*>(rb) + (long long)(2 * t + ph) * L * W : nullptr;
            sq2d_phase<<<grid, kBlock, 0, st>>>(
                static_cast<int8_t*>(s), static_cast<const int32_t*>(seeds),
                static_cast<const int32_t*>(thr) + 10LL * t, rbp, stage, nsamples * plane, L,
                (uint32_t)(2 * (ctr0 + t) + ph), ph);
            const cudaError_t e = cudaGetLastError();
            if (e != cudaSuccess) return (int)e;
        }
    }
    return 0;
}

extern "C" const char* pmc_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
