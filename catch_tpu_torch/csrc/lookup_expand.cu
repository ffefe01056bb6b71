// K2 lookup_expand: sample hashes -> table hit ranges -> (probe,
// alignment) pairs, and the compaction that deduplicates them.
//
// Replaces catch_tpu/ops/scan_instance.py _lookup_jit/_lookup_core
// (:217-272), _expand_hits_jit (:293-338) and the compaction of
// _dedup_pairs_jit (:341-360).  The TPU version needed a 2^16-entry
// prefix table, 16-bit count halves, a planning grid and bucketed
// re-dispatch; here each sample does a plain binary search, a
// torch.cumsum of the counts gives every sample its output offset, and
// each sample writes its own hits (sample i of the call is sample
// first + i of the corpus, so a place can look up a range of the samples).
// A hit is written as the packed key
// probe * 2^32 + alignment (alignment >= 1 by the corpus's leading pad),
// so one torch.sort orders the pairs and the compaction keeps the first
// row of every run of equal keys.
//
// Bound on the card: the lookup is latency bound (about 23 dependent
// loads per sample into a table of a few MB that stays in L2); the
// expansion is store bound, one 8-byte key per hit.  A sample with many
// hits is walked by one thread; the work is imbalanced but small.
#include "common.cuh"

__global__ void lookup_kernel(const int64_t* __restrict__ tbl, int64_t n_tbl,
                              const int64_t* __restrict__ q, int64_t n_q,
                              int64_t* __restrict__ lo,
                              int64_t* __restrict__ cnt) {
    int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n_q) return;
    int64_t v = q[i];
    int64_t a = 0, b = n_tbl;
    while (a < b) {                      // first row >= v
        int64_t m = (a + b) >> 1;
        if (tbl[m] < v) a = m + 1; else b = m;
    }
    int64_t first = a;
    b = n_tbl;
    while (a < b) {                      // first row > v
        int64_t m = (a + b) >> 1;
        if (tbl[m] <= v) a = m + 1; else b = m;
    }
    lo[i] = first;
    cnt[i] = (v == CT_HMAX) ? 0 : a - first;
}

__global__ void expand_kernel(const int64_t* __restrict__ lo,
                              const int64_t* __restrict__ cnt,
                              const int64_t* __restrict__ off_incl,
                              int64_t n_q,
                              const int64_t* __restrict__ tbl_p,
                              const int64_t* __restrict__ tbl_pos,
                              int64_t s, int64_t first,
                              int64_t* __restrict__ keys) {
    int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n_q) return;
    int64_t c = cnt[i];
    if (c == 0) return;
    int64_t base = off_incl[i] - c;
    int64_t l = lo[i];
    int64_t g = (first + i) * s;
    for (int64_t j = 0; j < c; ++j) {
        int64_t r = l + j;
        keys[base + j] = (tbl_p[r] << 32) | (g - tbl_pos[r]);
    }
}

__global__ void unique_flags_kernel(const int64_t* __restrict__ k, int64_t n,
                                    int64_t* __restrict__ flags) {
    int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    flags[i] = (i == 0 || k[i] != k[i - 1]) ? 1 : 0;
}

__global__ void unique_emit_kernel(const int64_t* __restrict__ k,
                                   const int64_t* __restrict__ flags,
                                   const int64_t* __restrict__ pos_incl,
                                   int64_t n, int64_t* __restrict__ p_out,
                                   int64_t* __restrict__ a_out) {
    int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n || !flags[i]) return;
    int64_t d = pos_incl[i] - 1;
    p_out[d] = k[i] >> 32;
    a_out[d] = k[i] & 0xFFFFFFFFll;
}

extern "C" int ct_lookup(const void* tbl, int64_t n_tbl, const void* q,
                         int64_t n_q, void* lo, void* cnt, void* stream) {
    if (n_q > 0) {
        lookup_kernel<<<ct_blocks(n_q, 256), 256, 0, ct_stream(stream)>>>(
            (const int64_t*)tbl, n_tbl, (const int64_t*)q, n_q,
            (int64_t*)lo, (int64_t*)cnt);
    }
    return (int)cudaGetLastError();
}

extern "C" int ct_expand(const void* lo, const void* cnt,
                         const void* off_incl, int64_t n_q,
                         const void* tbl_p, const void* tbl_pos, int64_t s,
                         int64_t first, void* keys, void* stream) {
    if (n_q > 0) {
        expand_kernel<<<ct_blocks(n_q, 256), 256, 0, ct_stream(stream)>>>(
            (const int64_t*)lo, (const int64_t*)cnt,
            (const int64_t*)off_incl, n_q, (const int64_t*)tbl_p,
            (const int64_t*)tbl_pos, s, first, (int64_t*)keys);
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

extern "C" int ct_unique_emit(const void* k, const void* flags,
                              const void* pos_incl, int64_t n, void* p_out,
                              void* a_out, void* stream) {
    if (n > 0) {
        unique_emit_kernel<<<ct_blocks(n, 256), 256, 0,
                             ct_stream(stream)>>>(
            (const int64_t*)k, (const int64_t*)flags,
            (const int64_t*)pos_incl, n, (int64_t*)p_out, (int64_t*)a_out);
    }
    return (int)cudaGetLastError();
}
