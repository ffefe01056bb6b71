// Single-pass tile scans with decoupled look-back (Merrill and Garland,
// "Single-pass Parallel Prefix Scan with Decoupled Look-back", 2016), for
// K10 assemble (assemble.cu) and K11 init_covered (init_covered.cu).
//
// A block takes its tile through an atomic ticket, not blockIdx, so every
// tile it waits on belongs to a block that is already running: the
// look-back cannot deadlock whatever order the blocks are scheduled in.
// Each tile publishes its aggregate as soon as it has it, then, once its
// exclusive prefix is known, its inclusive prefix.  The block finds a
// tile's exclusive prefix by folding its predecessors' values, one a
// thread, blockDim.x at a time, back to the nearest one that has
// published its inclusive prefix.  A round costs one dependent read, and
// the tiles in flight together are many, so the rounds, not the bytes,
// would bound a pass that read back 32 tiles a round.
//
// A value is W ints; the scan's operator combine(earlier, later) must be
// associative (not necessarily commutative) and have an identity.  The
// tile states live in one workspace the caller zeroes before the pass:
// flags int[nt] (0 nothing yet, 1 aggregate, 2 inclusive prefix), then
// the aggregates int[W * nt], then the inclusive prefixes int[W * nt].
// Aggregate and inclusive prefix have separate slots, so a value read
// after its flag is never overwritten.  Everything is in an anonymous
// namespace: each source that includes this header has its own copy.
#pragma once

#include "common.cuh"

#define CT_LB_FULL 0xFFFFFFFFu

namespace {

template <int W>
struct LbVal {
    int v[W];
};

// Ints of workspace for nt tiles of W-int values.
__host__ __device__ constexpr int64_t lb_ints(int64_t nt, int W) {
    return nt * (1 + 2 * W);
}

// The tile this block scans, from the ticket counter.  Every thread must
// call; the counter is zero before the pass.
__device__ __forceinline__ int64_t lb_ticket(int* counter) {
    __shared__ int tile;
    if (threadIdx.x == 0) tile = atomicAdd(counter, 1);
    __syncthreads();
    return tile;
}

template <int W>
struct LbTiles {
    int* flags;
    int* agg;
    int* inc;

    __device__ LbTiles(int* ws, int64_t nt)
        : flags(ws), agg(ws + nt), inc(ws + nt + (int64_t)W * nt) {}

    // Publish tile t's aggregate (inclusive = false) or inclusive prefix.
    // One thread calls.
    __device__ void publish(int64_t t, const LbVal<W>& x,
                            bool inclusive) const {
        volatile int* dst = (inclusive ? inc : agg) + t * W;
#pragma unroll
        for (int w = 0; w < W; ++w) dst[w] = x.v[w];
        __threadfence();
        ((volatile int*)flags)[t] = inclusive ? 2 : 1;
    }

    // The exclusive prefix of tile t > 0, for every thread of the block
    // (all must call; blockDim.x a multiple of 32).  Each round reads
    // blockDim.x predecessors, one a thread: warp w folds tiles
    // hi - 32w - 31 .. hi - 32w back to its nearest inclusive prefix,
    // then one thread folds the warps' values, nearest first, back to
    // the first warp that met an inclusive prefix.
    template <class Op>
    __device__ LbVal<W> exclusive(int64_t t, Op op) const {
        __shared__ LbVal<W> warp_val[32];
        __shared__ int warp_incl[32];
        __shared__ LbVal<W> result;
        __shared__ int done;
        const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
        LbVal<W> excl = op.identity();            // thread 0's running
        for (int64_t hi = t - 1; hi >= 0; hi -= blockDim.x) {
            // Tile 0 publishes its inclusive prefix at once, so a thread
            // past it is never folded.
            const int64_t j = hi - threadIdx.x;
            int f = 2;
            if (j >= 0) {
                do {
                    f = ((volatile int*)flags)[j];
                } while (f == 0);
            }
            __threadfence();
            const unsigned incl = __ballot_sync(CT_LB_FULL, f == 2);
            const int last = incl ? __ffs(incl) - 1 : 31;
            LbVal<W> x = op.identity();
            if (j >= 0 && lane <= last) {
                const volatile int* src = (f == 2 ? inc : agg) + j * W;
#pragma unroll
                for (int w = 0; w < W; ++w) x.v[w] = src[w];
            }
            // Lane L + d holds an earlier tile than lane L.
#pragma unroll
            for (int d = 1; d < 32; d <<= 1) {
                LbVal<W> y;
#pragma unroll
                for (int w = 0; w < W; ++w)
                    y.v[w] = __shfl_down_sync(CT_LB_FULL, x.v[w], d);
                if (lane + d < 32) x = op(y, x);
            }
            if (lane == 0) {
                warp_val[warp] = x;
                warp_incl[warp] = incl != 0;
            }
            __syncthreads();
            if (threadIdx.x == 0) {
                LbVal<W> acc = op.identity();
                int found = 0;
                for (int w = 0; w < (int)(blockDim.x >> 5) && !found; ++w) {
                    acc = op(warp_val[w], acc);
                    found = warp_incl[w];
                }
                excl = op(acc, excl);
                result = excl;
                done = found;
            }
            __syncthreads();
            if (done) break;
        }
        return result;
    }
};

}  // namespace
