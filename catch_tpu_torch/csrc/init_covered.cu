// K11 init_covered: the solver's initial coverage, covered0 = the
// complement of the union of all intervals.
//
// Replaces catch_tpu/ops/set_cover.py _init_covered_jit (:661-668) and the
// same initialisation inside _solve_jit_padded (:928-932).  Two steps:
//   1. a difference array: one thread per nonempty interval adds +1 at
//      its start and -1 at its end by integer atomics;
//   2. the inclusive prefix of the difference array (greedy.cuh's scan),
//      stored as covered[i] = prefix <= 0.
// The intervals overlap heavily (about 3.2 million of them on 3.3 million
// positions in the ebola175 design), so filling each range directly would
// write far more bytes than the difference array does.
//
// Bound on the card: device-memory bandwidth (two 4-byte reads an
// interval, the 4-byte difference array written, read twice, and one byte
// a position written); the atomics land on mostly distinct positions.
#include "greedy.cuh"

__global__ void covered_delta_kernel(const int* __restrict__ ivl_start,
                                     const int* __restrict__ ivl_end,
                                     int64_t M, int* __restrict__ delta) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= M) return;
    const int a = ivl_start[i], b = ivl_end[i];
    if (b > a) {
        atomicAdd(&delta[a], 1);
        atomicAdd(&delta[b], -1);
    }
}

namespace {

struct DeltaLoad {
    const int* delta;
    __device__ int operator()(int64_t i) const { return delta[i]; }
};

struct CoveredStore {
    bool* covered;
    __device__ void operator()(int64_t i, int v) const {
        covered[i] = v <= 0;
    }
};

}  // namespace

extern "C" int ct_init_covered(const void* ivl_start, const void* ivl_end,
                               int64_t M, int64_t U, void* delta, void* tiles,
                               void* covered, void* stream) {
    cudaStream_t st = ct_stream(stream);
    cudaMemsetAsync(delta, 0, (U + 1) * sizeof(int), st);
    if (M > 0)
        covered_delta_kernel<<<ct_blocks(M, 256), 256, 0, st>>>(
            (const int*)ivl_start, (const int*)ivl_end, M, (int*)delta);
    ct_scan(DeltaLoad{(const int*)delta}, CoveredStore{(bool*)covered}, U,
            (int*)tiles, st);
    return (int)cudaGetLastError();
}
