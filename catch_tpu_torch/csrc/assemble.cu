// K10 assemble: the device solver's boundary-indexed arrays from the
// merged instance (stage E).
//
// Replaces catch_tpu/ops/scan_instance.py _assemble_jit (:712-751).  The
// merged rows (key = set * nU + universe, universe-local start, end) are
// sorted by key.  Three passes, around two library primitives:
//   1. rows: one thread per row writes its global coordinates
//      (local + offsets[universe], int32) and its first-of-pair flag;
//   2. pairs (after torch.cumsum of the flags numbers the pairs): each
//      pair's first row writes set_of_pair = key / nU,
//      univ_of_pair = key % nU and pair_bounds[pair] = row; the last row
//      writes pair_bounds[P] = n;
//   3. maxima (after torch.searchsorted gives set_bounds): one thread per
//      set, a warp maximum and one atomic a warp, of the set's pair count
//      and interval count.  The maxima are over the real sets only; the
//      port does not pad the instance.
//
// Bound on the card: device-memory bandwidth (three 8-byte reads and two
// 4-byte writes a row, a few 4-byte accesses a pair and a set).
#include "common.cuh"

__global__ void assemble_rows_kernel(const int64_t* __restrict__ k,
                                     const int64_t* __restrict__ s,
                                     const int64_t* __restrict__ e, int64_t n,
                                     const int64_t* __restrict__ offsets,
                                     int64_t nU, int* __restrict__ gs,
                                     int* __restrict__ ge,
                                     int64_t* __restrict__ first) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const int64_t off = offsets[k[i] % nU];
    gs[i] = (int)(s[i] + off);
    ge[i] = (int)(e[i] + off);
    first[i] = (i == 0 || k[i] != k[i - 1]) ? 1 : 0;
}

__global__ void assemble_pairs_kernel(const int64_t* __restrict__ k,
                                      const int64_t* __restrict__ first,
                                      const int64_t* __restrict__ pair_incl,
                                      int64_t n, int64_t nU,
                                      int* __restrict__ set_of_pair,
                                      int* __restrict__ univ_of_pair,
                                      int* __restrict__ pair_bounds) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    if (first[i]) {
        const int64_t p = pair_incl[i] - 1;
        set_of_pair[p] = (int)(k[i] / nU);
        univ_of_pair[p] = (int)(k[i] % nU);
        pair_bounds[p] = (int)i;
    }
    if (i == n - 1) pair_bounds[pair_incl[i]] = (int)n;
}

__global__ void assemble_maxima_kernel(const int* __restrict__ set_bounds,
                                       const int* __restrict__ pair_bounds,
                                       int64_t S, int* __restrict__ maxima) {
    const int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    int np = 0, ni = 0;
    if (s < S) {
        const int p0 = set_bounds[s], p1 = set_bounds[s + 1];
        np = p1 - p0;
        ni = pair_bounds[p1] - pair_bounds[p0];
    }
    np = __reduce_max_sync(0xFFFFFFFFu, np);
    ni = __reduce_max_sync(0xFFFFFFFFu, ni);
    if ((threadIdx.x & 31) == 0) {
        atomicMax(&maxima[0], np);
        atomicMax(&maxima[1], ni);
    }
}

extern "C" int ct_assemble_rows(const void* k, const void* s, const void* e,
                                int64_t n, const void* offsets, int64_t nU,
                                void* gs, void* ge, void* first,
                                void* stream) {
    if (n > 0) {
        assemble_rows_kernel<<<ct_blocks(n, 256), 256, 0,
                               ct_stream(stream)>>>(
            (const int64_t*)k, (const int64_t*)s, (const int64_t*)e, n,
            (const int64_t*)offsets, nU, (int*)gs, (int*)ge,
            (int64_t*)first);
    }
    return (int)cudaGetLastError();
}

extern "C" int ct_assemble_pairs(const void* k, const void* first,
                                 const void* pair_incl, int64_t n, int64_t nU,
                                 void* set_of_pair, void* univ_of_pair,
                                 void* pair_bounds, void* stream) {
    if (n > 0) {
        assemble_pairs_kernel<<<ct_blocks(n, 256), 256, 0,
                                ct_stream(stream)>>>(
            (const int64_t*)k, (const int64_t*)first,
            (const int64_t*)pair_incl, n, nU, (int*)set_of_pair,
            (int*)univ_of_pair, (int*)pair_bounds);
    }
    return (int)cudaGetLastError();
}

extern "C" int ct_assemble_maxima(const void* set_bounds,
                                  const void* pair_bounds, int64_t S,
                                  void* maxima, void* stream) {
    if (S > 0) {
        assemble_maxima_kernel<<<ct_blocks(S, 256), 256, 0,
                                 ct_stream(stream)>>>(
            (const int*)set_bounds, (const int*)pair_bounds, S,
            (int*)maxima);
    }
    return (int)cudaGetLastError();
}
