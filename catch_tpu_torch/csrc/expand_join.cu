// K5 expand_join: minimizer join hits -> deduplicated (probe, alignment)
// pairs of the span scan.
//
// Replaces catch_tpu/ops/scan_sparse.py _expand_join_jit (:192-241).
// Its input is the host join: for every selected corpus position that
// hit the probe table, the run [lo, lo + cnt) of equal hashes in the
// sorted table and the position itself.  The TPU program resolved each
// hit's run by a scatter and a cumsum over a power-of-two hit buffer,
// then sorted two keys.  Here a torch.cumsum of the counts gives every
// run its output offset, one thread per run writes its cnt hits as the
// packed key probe * 2^34 + (pos - join_pos + Lmax - 1) (the key
// catch_tpu/ops/cover.py:360-364 builds; nonnegative, since an alignment
// reaches back at most Lmax - 1), one torch.sort orders the keys, and
// the compaction keeps the first row of every run of equal keys
// (ct_unique_flags, a torch.cumsum, then ct_join_emit).
//
// Bound on the card: the expansion is store bound, one 8-byte key per
// hit; the sort of the raw hits dominates (the plan K2's lookup_expand
// gave up for a probe-major merge join).  A run with many hits is walked by one
// thread: with w = 1 (k_seed <= 12) a frequent kj-mer can have
// thousands, so the work is imbalanced, but it is small next to the
// sort.
#include "common.cuh"

#define CT_JOIN_SHIFT 34

__global__ void expand_join_kernel(const int64_t* __restrict__ lo,
                                   const int64_t* __restrict__ cnt,
                                   const int64_t* __restrict__ off_incl,
                                   const int64_t* __restrict__ pos,
                                   int64_t n_runs,
                                   const int64_t* __restrict__ join_p,
                                   const int64_t* __restrict__ join_pos,
                                   int64_t lmax,
                                   int64_t* __restrict__ keys) {
    int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n_runs) return;
    const int64_t c = cnt[i];
    const int64_t base = off_incl[i] - c;
    const int64_t l = lo[i];
    const int64_t q = pos[i] + lmax - 1;
    for (int64_t j = 0; j < c; ++j) {
        const int64_t r = l + j;
        keys[base + j] = (join_p[r] << CT_JOIN_SHIFT) + (q - join_pos[r]);
    }
}

__global__ void unique_flags_kernel(const int64_t* __restrict__ k, int64_t n,
                                    int64_t* __restrict__ flags) {
    int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    flags[i] = (i == 0 || k[i] != k[i - 1]) ? 1 : 0;
}

__global__ void join_emit_kernel(const int64_t* __restrict__ k,
                                 const int64_t* __restrict__ flags,
                                 const int64_t* __restrict__ pos_incl,
                                 int64_t n, int64_t lmax,
                                 int64_t* __restrict__ p_out,
                                 int64_t* __restrict__ a_out) {
    int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n || !flags[i]) return;
    const int64_t d = pos_incl[i] - 1;
    p_out[d] = k[i] >> CT_JOIN_SHIFT;
    a_out[d] = (k[i] & ((1ll << CT_JOIN_SHIFT) - 1)) - (lmax - 1);
}

extern "C" int ct_expand_join(const void* lo, const void* cnt,
                              const void* off_incl, const void* pos,
                              int64_t n_runs, const void* join_p,
                              const void* join_pos, int64_t lmax,
                              void* keys, void* stream) {
    if (n_runs > 0) {
        expand_join_kernel<<<ct_blocks(n_runs, 256), 256, 0,
                             ct_stream(stream)>>>(
            (const int64_t*)lo, (const int64_t*)cnt,
            (const int64_t*)off_incl, (const int64_t*)pos, n_runs,
            (const int64_t*)join_p, (const int64_t*)join_pos, lmax,
            (int64_t*)keys);
    }
    return (int)cudaGetLastError();
}

extern "C" int ct_unique_flags(const void* k, int64_t n, void* flags,
                               void* stream) {
    if (n > 0) {
        unique_flags_kernel<<<ct_blocks(n, 256), 256, 0,
                              ct_stream(stream)>>>(
            (const int64_t*)k, n, (int64_t*)flags);
    }
    return (int)cudaGetLastError();
}

extern "C" int ct_join_emit(const void* k, const void* flags,
                            const void* pos_incl, int64_t n, int64_t lmax,
                            void* p_out, void* a_out, void* stream) {
    if (n > 0) {
        join_emit_kernel<<<ct_blocks(n, 256), 256, 0, ct_stream(stream)>>>(
            (const int64_t*)k, (const int64_t*)flags,
            (const int64_t*)pos_incl, n, lmax, (int64_t*)p_out,
            (int64_t*)a_out);
    }
    return (int)cudaGetLastError();
}
