// K11 init_covered: the solver's initial coverage, covered0 = the
// complement of the union of all intervals.
//
// Replaces catch_tpu/ops/set_cover.py _init_covered_jit (:661-668) and the
// same initialisation inside _solve_jit_padded (:928-932).  catch_tpu
// counts, for each position, the nonempty intervals [a, b) that hold it
// (a difference array and its prefix sum) and keeps the positions with a
// count of 0.  Position i lies in some nonempty [a, b) iff
// max{ b : a <= i } > i over the nonempty intervals, so:
//   1. reach[a] = the largest end of a nonempty interval starting at a:
//      one atomicMax a nonempty interval (catch_tpu's difference array
//      takes two atomic adds);
//   2. one single-pass inclusive max-scan of reach (lookback.cuh's
//      ticketed decoupled look-back), stored as covered[i] =
//      prefix_max[i] <= i.
// The result equals the count's for any overlap depth, and a maximum
// cannot overflow where a count could.  The caller zeroes reach and the
// look-back state with one memset: three launches a call.
//
// Bound on the card: device-memory bandwidth (two 4-byte reads an
// interval and one byte a position written).  The design moves reach
// besides (4 bytes a position: zeroed, updated by atomics that mostly hit
// L2, read once by the scan with 16-byte loads); a thread writes its 32
// positions' bytes as two 16-byte stores.  A tile is 8,192 positions, so
// that ebola175's axis takes about 400 tiles, near one wave of blocks:
// finer tiles spend more of the pass in look-back rounds.
#include "lookback.cuh"

#define IC_THREADS 256
#define IC_ITEMS 32
#define IC_TILE (IC_THREADS * IC_ITEMS)   // 8192 positions a tile

namespace {

struct MaxOp {
    __device__ LbVal<1> identity() const { return {{0}}; }
    __device__ LbVal<1> operator()(const LbVal<1>& a,
                                   const LbVal<1>& b) const {
        return {{max(a.v[0], b.v[0])}};
    }
};

__global__ void ic_reach_kernel(const int* __restrict__ ivl_start,
                                const int* __restrict__ ivl_end, int64_t M,
                                int vec, int* __restrict__ reach) {
    const int64_t i0 = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
    if (i0 >= M) return;
    int a[4], b[4];
    if (vec && i0 + 4 <= M) {
        const int4 s = *reinterpret_cast<const int4*>(ivl_start + i0);
        const int4 e = *reinterpret_cast<const int4*>(ivl_end + i0);
        a[0] = s.x; a[1] = s.y; a[2] = s.z; a[3] = s.w;
        b[0] = e.x; b[1] = e.y; b[2] = e.z; b[3] = e.w;
    } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            a[k] = i0 + k < M ? ivl_start[i0 + k] : 0;
            b[k] = i0 + k < M ? ivl_end[i0 + k] : 0;
        }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
        if (b[k] > a[k]) atomicMax(&reach[a[k]], b[k]);
}

__global__ void __launch_bounds__(IC_THREADS)
ic_scan_kernel(const int* __restrict__ reach, int64_t U, int64_t nt,
               int* ws, bool* __restrict__ covered) {
    __shared__ int warp_max[IC_THREADS / 32];
    const int64_t tile = lb_ticket(ws);
    const LbTiles<1> st(ws + 1, nt);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int64_t i0 = tile * IC_TILE + (int64_t)threadIdx.x * IC_ITEMS;
    const bool whole = i0 + IC_ITEMS <= U;
    int v[IC_ITEMS];
    if (whole) {
#pragma unroll
        for (int q = 0; q < IC_ITEMS / 4; ++q) {
            const int4 x = reinterpret_cast<const int4*>(reach + i0)[q];
            v[4 * q] = x.x; v[4 * q + 1] = x.y;
            v[4 * q + 2] = x.z; v[4 * q + 3] = x.w;
        }
    } else {
#pragma unroll
        for (int k = 0; k < IC_ITEMS; ++k)
            v[k] = i0 + k < U ? reach[i0 + k] : 0;
    }
    int m = 0;
#pragma unroll
    for (int k = 0; k < IC_ITEMS; ++k) m = max(m, v[k]);
    // Inclusive max over the warp, then over the warps.
    int x = m;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(CT_LB_FULL, x, d);
        if (lane >= d) x = max(x, y);
    }
    if (lane == 31) warp_max[warp] = x;
    __syncthreads();
    int agg = 0;
#pragma unroll
    for (int w = 0; w < IC_THREADS / 32; ++w) agg = max(agg, warp_max[w]);
    if (threadIdx.x == 0) st.publish(tile, {{agg}}, tile == 0);
    int run = 0;
    if (tile > 0) {
        run = st.exclusive(tile, MaxOp()).v[0];
        if (threadIdx.x == 0) st.publish(tile, {{max(run, agg)}}, true);
    }
    // The thread's exclusive prefix: the tile's, the earlier warps' and
    // the earlier lanes'.
    for (int w = 0; w < warp; ++w) run = max(run, warp_max[w]);
    const int before = __shfl_up_sync(CT_LB_FULL, x, 1);
    if (lane > 0) run = max(run, before);
    unsigned char c[IC_ITEMS];
#pragma unroll
    for (int k = 0; k < IC_ITEMS; ++k) {
        run = max(run, v[k]);
        c[k] = run <= i0 + k ? 1 : 0;
    }
    if (whole) {
#pragma unroll
        for (int h = 0; h < IC_ITEMS / 16; ++h) {
            uint4 out;
            unsigned* o = reinterpret_cast<unsigned*>(&out);
            const unsigned char* b = c + 16 * h;
#pragma unroll
            for (int q = 0; q < 4; ++q)
                o[q] = b[4 * q] | (b[4 * q + 1] << 8) | (b[4 * q + 2] << 16)
                       | ((unsigned)b[4 * q + 3] << 24);
            reinterpret_cast<uint4*>(covered + i0)[h] = out;
        }
    } else {
#pragma unroll
        for (int k = 0; k < IC_ITEMS; ++k)
            if (i0 + k < U) covered[i0 + k] = c[k];
    }
}

}  // namespace

// ws: lb_ints(ceil(U / IC_TILE), 1) + 1 ints (the ticket first), then
// reach at ws + reach_off (int32[U], 16-byte aligned); the memset zeroes
// both.  vec: ivl_start and ivl_end are 16-byte aligned.
extern "C" int ct_init_covered(const void* ivl_start, const void* ivl_end,
                               int64_t M, int vec, int64_t U, void* ws,
                               int64_t ws_ints, int64_t reach_off,
                               void* covered, void* stream) {
    cudaStream_t st = ct_stream(stream);
    if (U <= 0) return (int)cudaGetLastError();
    int* w = (int*)ws;
    int* reach = w + reach_off;
    const int64_t nt = (U + IC_TILE - 1) / IC_TILE;
    cudaMemsetAsync(w, 0, ws_ints * sizeof(int), st);
    if (M > 0)
        ic_reach_kernel<<<ct_blocks((M + 3) / 4, 256), 256, 0, st>>>(
            (const int*)ivl_start, (const int*)ivl_end, M, vec, reach);
    ic_scan_kernel<<<(unsigned)nt, IC_THREADS, 0, st>>>(reach, U, nt, w,
                                                        (bool*)covered);
    return (int)cudaGetLastError();
}
