// Inclusive prefix sums of an int64 array in one block: the offsets of
// K2's probes and buckets (one value each), computed on the stream
// between the kernels that need them, so that a wrapper queues its
// launches in one C call.  Static: each source that includes it has its
// own copy.
#pragma once

#include "common.cuh"

#define CT_SCAN_THREADS 1024
#define CT_SCAN_ITEMS 4

static __global__ void __launch_bounds__(CT_SCAN_THREADS)
ct_scan_kernel(const int64_t* __restrict__ in, int64_t n,
               int64_t* __restrict__ out) {
    __shared__ int64_t warp_tot[CT_SCAN_THREADS / 32];
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    int64_t carry = 0;
    for (int64_t base = 0; base < n;
         base += CT_SCAN_THREADS * CT_SCAN_ITEMS) {
        const int64_t i0 = base + (int64_t)threadIdx.x * CT_SCAN_ITEMS;
        int64_t v[CT_SCAN_ITEMS], sum = 0;
#pragma unroll
        for (int k = 0; k < CT_SCAN_ITEMS; ++k) {
            v[k] = i0 + k < n ? in[i0 + k] : 0;
            sum += v[k];
        }
        int64_t x = sum;                      // inclusive, within the warp
        for (int d = 1; d < 32; d <<= 1) {
            const int64_t y = __shfl_up_sync(0xffffffffu, x, d);
            if (lane >= d) x += y;
        }
        if (lane == 31) warp_tot[w] = x;
        __syncthreads();
        if (w == 0) {                         // inclusive over the warps
            int64_t t = warp_tot[lane];
            for (int d = 1; d < 32; d <<= 1) {
                const int64_t y = __shfl_up_sync(0xffffffffu, t, d);
                if (lane >= d) t += y;
            }
            warp_tot[lane] = t;
        }
        __syncthreads();
        int64_t run = carry + (w ? warp_tot[w - 1] : 0) + x - sum;
#pragma unroll
        for (int k = 0; k < CT_SCAN_ITEMS; ++k) {
            run += v[k];
            if (i0 + k < n) out[i0 + k] = run;
        }
        carry += warp_tot[CT_SCAN_THREADS / 32 - 1];
        __syncthreads();
    }
}

static inline cudaError_t ct_scan(const int64_t* in, int64_t n, int64_t* out,
                                  cudaStream_t st) {
    if (n > 0) ct_scan_kernel<<<1, CT_SCAN_THREADS, 0, st>>>(in, n, out);
    return cudaGetLastError();
}
