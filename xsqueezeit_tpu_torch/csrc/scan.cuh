// Block-wide scans shared by the port's kernels.
//
// One value per thread (Op::T: int, or a u64 of packed counts), warp
// shuffles inside each warp and one shared value per warp
// across warps.  blockDim.x must be a multiple of 32 (every launch in
// this package uses a fixed power of two).  Each scan ends with a barrier,
// so `scratch` may be reused by the next scan right away.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

struct SumOp {
    using T = int;
    __device__ static int identity() { return 0; }
    __device__ static int apply(int a, int b) { return a + b; }
};

// Sum of 64-bit unsigned values: fields packed side by side add without
// carries while each field's total stays within its width.
struct SumU64Op {
    using T = unsigned long long;
    __device__ static T identity() { return 0ull; }
    __device__ static T apply(T a, T b) { return a + b; }
};

struct MaxOp {
    using T = int;
    // every value scanned with MaxOp in this package is >= -1
    __device__ static int identity() { return -1; }
    __device__ static int apply(int a, int b) { return a > b ? a : b; }
};

// Inclusive scan of `v` over the block in thread order.  `scratch` holds 32
// values of shared memory; `*total` receives the scan of the whole block.
template <typename Op, typename V = typename Op::T>
__device__ __forceinline__ V block_inclusive_scan(
    typename Op::T v, typename Op::T* scratch, typename Op::T* total) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    V x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const V y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x = Op::apply(x, y);
    }
    if (lane == 31) scratch[warp] = x;
    __syncthreads();
    if (warp == 0) {
        V s = lane < nwarps ? scratch[lane] : Op::identity();
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const V y = __shfl_up_sync(0xffffffffu, s, o);
            if (lane >= o) s = Op::apply(s, y);
        }
        scratch[lane] = s;
    }
    __syncthreads();
    if (warp > 0) x = Op::apply(scratch[warp - 1], x);
    *total = scratch[nwarps - 1];
    __syncthreads();
    return x;
}

// Exclusive scan of `v` over the block in thread order (thread 0 gets the
// identity); otherwise as block_inclusive_scan.
template <typename Op, typename V = typename Op::T>
__device__ __forceinline__ V block_exclusive_scan(
    typename Op::T v, typename Op::T* scratch, typename Op::T* total) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    V x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const V y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x = Op::apply(x, y);
    }
    V ex = __shfl_up_sync(0xffffffffu, x, 1);
    if (lane == 0) ex = Op::identity();
    if (lane == 31) scratch[warp] = x;
    __syncthreads();
    if (warp == 0) {
        V s = lane < nwarps ? scratch[lane] : Op::identity();
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const V y = __shfl_up_sync(0xffffffffu, s, o);
            if (lane >= o) s = Op::apply(s, y);
        }
        scratch[lane] = s;
    }
    __syncthreads();
    if (warp > 0) ex = Op::apply(scratch[warp - 1], ex);
    *total = scratch[nwarps - 1];
    __syncthreads();
    return ex;
}
