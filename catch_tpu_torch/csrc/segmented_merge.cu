// K4 segmented_merge: merge overlapping or touching [start, end) spans
// per key, over spans sorted by (key, start).
//
// Replaces catch_tpu/ops/scan_instance.py _merge_jit/_merge_runs
// (:537-590) and _union_jit (:593-597, the same merge keyed by
// universe).  The caller sorts the packed key key * 2^32 + start with
// torch.sort and passes the permutation; the kernels then take the
// segmented inclusive running max of end over each key group across the
// WHOLE input (so the fault recorded at :559-562, a scan cut at the
// output width, cannot arise):
//   1. block scan: each block of 1024 rows scans its own rows in shared
//      memory and writes its aggregate (any group head seen, max since
//      the last head);
//   2. carry: one block scans the block aggregates, giving each block
//      the running max at the row before it;
//   3. fix-up: rows whose group began before their block take the carry,
//      and every row gets its merge flag first | start > rmax_prev;
//   4. emit: torch.cumsum of the flags gives each run its slot; a run's
//      first row writes (key, start) and its last row writes the end.
//
// Bound on the card: device-memory bandwidth (a few 8-byte reads and
// writes per row in each pass); the carry pass is one block walking
// n / 1024 aggregates.
#include "common.cuh"

#define CT_MB 1024   // rows per block scan

struct SegMax {
    int head;        // a group head lies in the range
    int64_t v;       // max of end since the range's last head
};

__device__ __forceinline__ SegMax seg_combine(SegMax l, SegMax r) {
    return SegMax{l.head | r.head, r.head ? r.v : (l.v > r.v ? l.v : r.v)};
}

// Inclusive segmented scan of one value per thread over the block.
__device__ SegMax block_seg_scan(SegMax x, SegMax* sh) {
    const int tid = threadIdx.x;
    sh[tid] = x;
    __syncthreads();
    for (int d = 1; d < blockDim.x; d <<= 1) {
        SegMax y = x;
        if (tid >= d) y = seg_combine(sh[tid - d], x);
        __syncthreads();
        sh[tid] = y;
        x = y;
        __syncthreads();
    }
    return x;
}

__global__ void merge_block_scan_kernel(const int64_t* __restrict__ sp,
                                        const int64_t* __restrict__ order,
                                        int64_t n,
                                        const int64_t* __restrict__ end,
                                        int64_t* __restrict__ local,
                                        int* __restrict__ agg_head,
                                        int64_t* __restrict__ agg_v) {
    __shared__ SegMax sh[CT_MB];
    const int64_t i = (int64_t)blockIdx.x * CT_MB + threadIdx.x;
    SegMax x{0, 0};
    if (i < n) {
        x.head = (i == 0 || (sp[i] >> 32) != (sp[i - 1] >> 32));
        x.v = end[order[i]];
    }
    x = block_seg_scan(x, sh);
    if (i < n) local[i] = x.v;
    if (threadIdx.x == CT_MB - 1) {
        agg_head[blockIdx.x] = x.head;
        agg_v[blockIdx.x] = x.v;
    }
}

// carry[b] = running max at row b * CT_MB - 1 (b >= 1).
__global__ void merge_carry_kernel(const int* __restrict__ agg_head,
                                   const int64_t* __restrict__ agg_v,
                                   int64_t nb, int64_t* __restrict__ carry) {
    __shared__ SegMax sh[CT_MB];
    SegMax run{0, 0};
    for (int64_t c0 = 0; c0 < nb; c0 += CT_MB) {
        const int64_t b = c0 + threadIdx.x;
        SegMax x{0, 0};
        if (b < nb) x = SegMax{agg_head[b], agg_v[b]};
        x = block_seg_scan(x, sh);
        SegMax full = seg_combine(run, x);
        if (b + 1 < nb) carry[b + 1] = full.v;
        __syncthreads();
        if (threadIdx.x == CT_MB - 1) sh[0] = full;
        __syncthreads();
        run = sh[0];
        __syncthreads();
    }
}

__global__ void merge_fixup_kernel(const int64_t* __restrict__ sp,
                                   const int64_t* __restrict__ local,
                                   const int64_t* __restrict__ carry,
                                   int64_t n, int64_t* __restrict__ rmax,
                                   int64_t* __restrict__ flags) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const int64_t b = i / CT_MB;
    const int64_t b0 = b * CT_MB;
    const int64_t key = sp[i] >> 32;
    // Full running max at row j of this block.
    auto full = [&](int64_t j) {
        int64_t r = local[j];
        if (b > 0 && (sp[j] >> 32) == (sp[b0 - 1] >> 32)) {
            int64_t c = carry[b];
            r = r > c ? r : c;
        }
        return r;
    };
    rmax[i] = full(i);
    const bool first = i == 0 || (sp[i - 1] >> 32) != key;
    bool new_run = first;
    if (!first) {
        const int64_t prev = i == b0 ? carry[b] : full(i - 1);
        new_run = (sp[i] & 0xFFFFFFFFll) > prev;
    }
    flags[i] = new_run ? 1 : 0;
}

__global__ void merge_emit_kernel(const int64_t* __restrict__ sp,
                                  const int64_t* __restrict__ rmax,
                                  const int64_t* __restrict__ flags,
                                  const int64_t* __restrict__ pos_incl,
                                  int64_t n, int64_t* __restrict__ out_k,
                                  int64_t* __restrict__ out_s,
                                  int64_t* __restrict__ out_e) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const int64_t r = pos_incl[i] - 1;
    if (flags[i]) {
        out_k[r] = sp[i] >> 32;
        out_s[r] = sp[i] & 0xFFFFFFFFll;
    }
    if (i == n - 1 || flags[i + 1]) out_e[r] = rmax[i];
}

extern "C" int ct_merge_block_scan(const void* sp, const void* order,
                                   int64_t n, const void* end, void* local,
                                   void* agg_head, void* agg_v,
                                   void* stream) {
    if (n > 0) {
        merge_block_scan_kernel<<<ct_blocks(n, CT_MB), CT_MB, 0,
                                  ct_stream(stream)>>>(
            (const int64_t*)sp, (const int64_t*)order, n,
            (const int64_t*)end, (int64_t*)local, (int*)agg_head,
            (int64_t*)agg_v);
    }
    return (int)cudaGetLastError();
}

extern "C" int ct_merge_carry(const void* agg_head, const void* agg_v,
                              int64_t nb, void* carry, void* stream) {
    if (nb > 1) {
        merge_carry_kernel<<<1, CT_MB, 0, ct_stream(stream)>>>(
            (const int*)agg_head, (const int64_t*)agg_v, nb,
            (int64_t*)carry);
    }
    return (int)cudaGetLastError();
}

extern "C" int ct_merge_fixup(const void* sp, const void* local,
                              const void* carry, int64_t n, void* rmax,
                              void* flags, void* stream) {
    if (n > 0) {
        merge_fixup_kernel<<<ct_blocks(n, 256), 256, 0,
                             ct_stream(stream)>>>(
            (const int64_t*)sp, (const int64_t*)local,
            (const int64_t*)carry, n, (int64_t*)rmax, (int64_t*)flags);
    }
    return (int)cudaGetLastError();
}

extern "C" int ct_merge_emit(const void* sp, const void* rmax,
                             const void* flags, const void* pos_incl,
                             int64_t n, void* out_k, void* out_s,
                             void* out_e, void* stream) {
    if (n > 0) {
        merge_emit_kernel<<<ct_blocks(n, 256), 256, 0,
                            ct_stream(stream)>>>(
            (const int64_t*)sp, (const int64_t*)rmax,
            (const int64_t*)flags, (const int64_t*)pos_incl, n,
            (int64_t*)out_k, (int64_t*)out_s, (int64_t*)out_e);
    }
    return (int)cudaGetLastError();
}
