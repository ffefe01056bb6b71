// K4 segmented_merge: merge overlapping or touching [start, end) spans
// per key; the merged runs come out sorted by (key, start).
//
// Replaces catch_tpu/ops/scan_instance.py _merge_jit/_merge_runs
// (:537-590) and _union_jit (:593-597, the same merge keyed by
// universe).  Its callers: the design scan's pair merge (ebola175:
// 3,670,370 spans, keys below 18,730 x 175), the per-universe union of
// the merged rows (3,209,031 rows, 175 keys), and the avoid scan's
// per-(probe, strand) merge.
//
// What bounds it on the H100: device-memory bytes, about 24 a row in
// and 24 a merged row out (0.072 ms for both calls of ebola175's stage
// D at the NVIDIA H100 SXM's published 3.35 TB/s, 700 W), while a
// global sort of the rows costs several passes over them.  So no global
// sort: the rows go into buckets of whole keys, and each bucket is
// sorted and merged where it lies, with no carry between blocks,
// because no key group crosses a bucket.
//
//   1. ct_sm_bounds: one pass for the smallest and largest key, the
//      largest start and end, and whether any end < start; the wrapper
//      reads them once, checks the ranges and picks shift.
//   2. ct_sm_run, phase 0: bucket = (key - kmin) >> shift.  Counts
//      (a block-private shared-memory histogram when the buckets are
//      few, as in the union, else warp-aggregated atomics: callers hand
//      over rows grouped by key), offsets (sm_scan), and each row
//      scattered into its bucket as a sort key sk = key_off << sb |
//      start (sb: the bits of the largest start) and a 32-bit end.  With
//      few buckets a block first groups a tile of rows by bucket in
//      shared memory, so that its writes to each bucket are contiguous
//      (the union's rows come in universe order 0, 1, ..., 174, 0, ...).
//   3. phase 1: each bucket sorted by sk, with its row index in the low
//      bits of the word, by a tier picked by its size:
//        warp   (2..512 rows): a bitonic network in registers and
//               shuffles, 32-bit words where they fit;
//        block  (up to the tile): an LSD radix sort over 4-bit digits of
//               sk's significant bits, 1,024 threads, ping-pong in
//               dynamic shared memory, with 32-bit words where shift +
//               sb + ib <= 32 (the union: a universe of 18,000-odd rows
//               a bucket);
//        device (above the tile): the same radix sort, one block, over
//               (sk, end) in device scratch.
//      Then the group's running max of end, the run flags and the
//      compaction, in three passes over the sorted bucket (one thread a
//      contiguous chunk, two group scans); the runs go to the bucket's
//      own slots of a second buffer, with their count.
//   4. phase 2: the run counts' offsets (sm_scan) sized the output
//      (the wrapper's second read), and one pass writes (key, start,
//      end) as int64 in bucket order, which is (key, start) order.
//
// Why ties need no stable sort: with end >= start (checked), the rows
// that share (key, start) all fall in one run whatever their order, and
// that run's end is their maximum.
#include "common.cuh"

#define SM_BLOCK_THREADS 1024   // block tier
#define SM_DEV_THREADS 512      // device tier
#define SM_WARP_THREADS 256     // warp tier: 8 warps a block
#define SM_WARP_TILE 512        // largest bucket a warp sorts
#define SM_WARP_IB 9            // bits of a row index below SM_WARP_TILE
#define SM_DIGIT_BITS 4
#define SM_DIGITS (1 << SM_DIGIT_BITS)
#define SM_HIST_BINS 2048       // block-private histogram up to this many
#define SM_STAGE 2048           // rows a block groups by bucket at once
#define SM_COUNTS_BYTES (SM_DIGITS * SM_BLOCK_THREADS * 2)   // u16 counts

typedef unsigned long long u64;

__device__ __forceinline__ unsigned sm_lanemask_lt() {
    unsigned m;
    asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
    return m;
}

__device__ __forceinline__ int64_t sm_min(int64_t x, int64_t y) {
    return x < y ? x : y;
}

// ----------------------------------------------------------------------
// Group scans
// ----------------------------------------------------------------------

struct SegMax {
    int head;      // a group head lies in the range
    uint32_t v;    // max of end since the range's last head
};

__device__ __forceinline__ SegMax seg_combine(SegMax l, SegMax r) {
    return SegMax{l.head | r.head, r.head ? r.v : (l.v > r.v ? l.v : r.v)};
}

// Exclusive scans over a group of G threads: a warp (G = 32, no
// shared memory, lanes of other warps apart) or the whole block of G
// threads (sh: G / 32 entries; every thread calls).
template <int G>
__device__ SegMax group_exscan_seg(SegMax x, SegMax* sh) {
    const int lane = threadIdx.x & 31;
    SegMax inc = x;
    for (int d = 1; d < 32; d <<= 1) {
        const SegMax y{__shfl_up_sync(0xffffffffu, inc.head, d),
                       __shfl_up_sync(0xffffffffu, inc.v, d)};
        if (lane >= d) inc = seg_combine(y, inc);
    }
    SegMax ex{__shfl_up_sync(0xffffffffu, inc.head, 1),
              __shfl_up_sync(0xffffffffu, inc.v, 1)};
    if (lane == 0) ex = SegMax{0, 0};
    if constexpr (G == 32) {
        return ex;
    } else {
        const int w = threadIdx.x >> 5;
        if (lane == 31) sh[w] = inc;
        __syncthreads();
        SegMax pre{0, 0};
        for (int j = 0; j < w; ++j) pre = seg_combine(pre, sh[j]);
        __syncthreads();
        return seg_combine(pre, ex);
    }
}

template <int G>
__device__ int64_t group_exscan_sum(int64_t x, int64_t* sh, int64_t* total) {
    const int lane = threadIdx.x & 31;
    int64_t inc = x;
    for (int d = 1; d < 32; d <<= 1) {
        const int64_t y = __shfl_up_sync(0xffffffffu, inc, d);
        if (lane >= d) inc += y;
    }
    if constexpr (G == 32) {
        *total = __shfl_sync(0xffffffffu, inc, 31);
        return inc - x;
    } else {
        const int w = threadIdx.x >> 5;
        if (lane == 31) sh[w] = inc;
        __syncthreads();
        int64_t pre = 0, all = 0;
        for (int j = 0; j < G / 32; ++j) {
            if (j < w) pre += sh[j];
            all += sh[j];
        }
        __syncthreads();
        *total = all;
        return pre + inc - x;
    }
}

template <int G>
__device__ u64 group_max(u64 x, u64* sh) {
    for (int d = 16; d > 0; d >>= 1) {
        const u64 y = __shfl_xor_sync(0xffffffffu, x, d);
        x = y > x ? y : x;
    }
    if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = x;
    __syncthreads();
    x = 0;
    for (int j = 0; j < G / 32; ++j) x = sh[j] > x ? sh[j] : x;
    __syncthreads();
    return x;
}

// Inclusive prefix sums of an int64 array of bucket values: tiles of
// SM_SCAN_TILE scanned by one block each (the tile totals to tot), then
// each later tile adds the totals before it.  Two launches whatever the
// length, where one block walking tens of thousands of buckets takes
// ~25 us.
#define SM_SCAN_ITEMS 4
#define SM_SCAN_TILE (1024 * SM_SCAN_ITEMS)

__global__ void __launch_bounds__(1024)
sm_scan_tiles_kernel(const int64_t* __restrict__ in, int64_t n,
                     int64_t* __restrict__ out, int64_t* __restrict__ tot) {
    __shared__ int64_t sh[1024 / 32];
    const int64_t i0 = (int64_t)blockIdx.x * SM_SCAN_TILE
        + (int64_t)threadIdx.x * SM_SCAN_ITEMS;
    int64_t v[SM_SCAN_ITEMS], sum = 0;
#pragma unroll
    for (int k = 0; k < SM_SCAN_ITEMS; ++k) {
        v[k] = i0 + k < n ? in[i0 + k] : 0;
        sum += v[k];
    }
    int64_t total;
    int64_t run = group_exscan_sum<1024>(sum, sh, &total);
#pragma unroll
    for (int k = 0; k < SM_SCAN_ITEMS; ++k) {
        run += v[k];
        if (i0 + k < n) out[i0 + k] = run;
    }
    if (threadIdx.x == 0) tot[blockIdx.x] = total;
}

__global__ void sm_scan_add_kernel(int64_t* __restrict__ out, int64_t n,
                                   const int64_t* __restrict__ tot) {
    const int64_t tile = (int64_t)blockIdx.x + 1;
    int64_t c = 0;
    for (int64_t j = 0; j < tile; ++j) c += tot[j];
    const int64_t hi = sm_min(n, (tile + 1) * SM_SCAN_TILE);
    for (int64_t i = tile * SM_SCAN_TILE + threadIdx.x; i < hi;
         i += blockDim.x)
        out[i] += c;
}

// tot: (n + SM_SCAN_TILE - 1) / SM_SCAN_TILE entries.
static cudaError_t sm_scan(const int64_t* in, int64_t n, int64_t* out,
                           int64_t* tot, cudaStream_t st) {
    if (n <= 0) return cudaGetLastError();
    const int64_t tiles = (n + SM_SCAN_TILE - 1) / SM_SCAN_TILE;
    sm_scan_tiles_kernel<<<(unsigned)tiles, 1024, 0, st>>>(in, n, out, tot);
    if (tiles > 1)
        sm_scan_add_kernel<<<(unsigned)(tiles - 1), 256, 0, st>>>(out, n,
                                                                  tot);
    return cudaGetLastError();
}

// ----------------------------------------------------------------------
// 1. Bounds
// ----------------------------------------------------------------------

// out[0] = max ~key (so ~out[0] is the smallest key), out[1] = max key,
// out[2] = max start, out[3] = max end, all as unsigned 64-bit words (a
// negative value is larger than any valid one); out[4] = 1 where some
// end < start.  out starts at 0; one atomic a block and value.
__global__ void __launch_bounds__(256)
sm_bounds_kernel(const int64_t* __restrict__ key,
                 const int64_t* __restrict__ start,
                 const int64_t* __restrict__ end, int64_t n,
                 u64* __restrict__ out) {
    __shared__ u64 sh[5][256 / 32];
    u64 v[5] = {0, 0, 0, 0, 0};
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t i0 = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i0 < n;
         i0 += 4 * stride) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            const int64_t i = i0 + u * stride;
            if (i < n) {
                const int64_t k = key[i], s = start[i], e = end[i];
                const u64 w[5] = {~(u64)k, (u64)k, (u64)s, (u64)e,
                                  e < s ? 1ull : 0};
#pragma unroll
                for (int j = 0; j < 5; ++j) v[j] = w[j] > v[j] ? w[j] : v[j];
            }
        }
    }
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
    for (int j = 0; j < 5; ++j) {
        for (int d = 16; d > 0; d >>= 1) {
            const u64 y = __shfl_xor_sync(0xffffffffu, v[j], d);
            v[j] = y > v[j] ? y : v[j];
        }
        if (lane == 0) sh[j][w] = v[j];
    }
    __syncthreads();
    if (threadIdx.x < 5) {
        u64 x = 0;
        for (int k = 0; k < 256 / 32; ++k)
            x = sh[threadIdx.x][k] > x ? sh[threadIdx.x][k] : x;
        if (x) atomicMax(&out[threadIdx.x], x);
    }
}

// ----------------------------------------------------------------------
// 2. Buckets
// ----------------------------------------------------------------------

// Bucket counts: block-private in shared memory for n_b <= SM_HIST_BINS,
// else warp lanes that share a bucket add once.
__global__ void sm_hist_kernel(const int64_t* __restrict__ key, int64_t n,
                               int64_t kmin, int shift, int64_t n_b,
                               u64* __restrict__ cnt) {
    __shared__ unsigned loc[SM_HIST_BINS];
    const bool priv = n_b <= SM_HIST_BINS;
    if (priv) {
        for (int64_t b = threadIdx.x; b < n_b; b += blockDim.x) loc[b] = 0;
        __syncthreads();
    }
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t base = (int64_t)blockIdx.x * blockDim.x; base < n;
         base += stride) {
        const int64_t i = base + threadIdx.x;
        const bool ok = i < n;
        const unsigned act = __ballot_sync(0xffffffffu, ok);
        if (!ok) continue;
        const int64_t b = (key[i] - kmin) >> shift;
        if (priv) {
            atomicAdd(&loc[b], 1u);
        } else {
            const unsigned grp = __match_any_sync(act, (u64)b);
            if ((grp & sm_lanemask_lt()) == 0)
                atomicAdd(&cnt[b], (u64)__popc(grp));
        }
    }
    if (priv) {
        __syncthreads();
        for (int64_t b = threadIdx.x; b < n_b; b += blockDim.x)
            if (loc[b]) atomicAdd(&cnt[b], (u64)loc[b]);
    }
}

// Each row into its bucket as (sk, end), for more than SM_HIST_BINS
// buckets: warp-aggregated atomics on cnt, which counts down to 0 (the
// callers' rows come grouped by key, so a warp's writes mostly go to one
// bucket).  The order within a bucket does not matter: it is sorted
// next.
__global__ void sm_scatter_kernel(const int64_t* __restrict__ key,
                                  const int64_t* __restrict__ start,
                                  const int64_t* __restrict__ end, int64_t n,
                                  int64_t kmin, int shift, int sb,
                                  const int64_t* __restrict__ bo_incl,
                                  u64* __restrict__ cnt,
                                  u64* __restrict__ W,
                                  uint32_t* __restrict__ E) {
    const u64 kmask = ((u64)1 << shift) - 1;
    const int lane = threadIdx.x & 31;
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t base = (int64_t)blockIdx.x * blockDim.x; base < n;
         base += stride) {
        const int64_t i = base + threadIdx.x;
        const bool ok = i < n;
        const unsigned act = __ballot_sync(0xffffffffu, ok);
        if (!ok) continue;
        const u64 k = (u64)(key[i] - kmin);
        const int64_t b = (int64_t)(k >> shift);
        const unsigned grp = __match_any_sync(act, (u64)b);
        const int leader = __ffs(grp) - 1;
        u64 old = 0;
        if (lane == leader) old = atomicAdd(&cnt[b], 0ull - (u64)__popc(grp));
        old = __shfl_sync(act, old, leader);
        const int64_t slot = bo_incl[b] - (int64_t)old
            + __popc(grp & sm_lanemask_lt());
        W[slot] = ((k & kmask) << sb) | (u64)start[i];
        E[slot] = (uint32_t)end[i];
    }
}

// The scatter for at most SM_HIST_BINS buckets.  A block takes a tile
// of SM_STAGE rows: ranks each row in its bucket (shared-memory
// atomics), scans the tile's counts, reserves each bucket's slots with
// one atomic on cnt, groups the tile by bucket in shared memory and
// writes each bucket's part as one contiguous run.  Dynamic shared
// memory: sm_stage_smem() bytes.
#define SM_STAGE_PER (SM_STAGE / 256)
__global__ void __launch_bounds__(256)
sm_scatter_staged_kernel(const int64_t* __restrict__ key,
                         const int64_t* __restrict__ start,
                         const int64_t* __restrict__ end, int64_t n,
                         int64_t kmin, int shift, int sb, int n_b,
                         const int64_t* __restrict__ bo_incl,
                         u64* __restrict__ cnt, u64* __restrict__ W,
                         uint32_t* __restrict__ E) {
    extern __shared__ __align__(16) unsigned char smem[];
    int64_t* at = (int64_t*)smem;                              // [bins]
    u64* sw = (u64*)(at + SM_HIST_BINS);                       // [stage]
    unsigned* loc = (unsigned*)(sw + SM_STAGE);                // [bins]
    unsigned* lo = loc + SM_HIST_BINS;                         // [bins]
    uint32_t* se = lo + SM_HIST_BINS;                          // [stage]
    uint16_t* sbk = (uint16_t*)(se + SM_STAGE);                // [stage]
    __shared__ int64_t sh_sum[256 / 32];
    const int tid = threadIdx.x;
    const u64 kmask = ((u64)1 << shift) - 1;
    const int per = (n_b + 255) / 256;
    const int q0 = min(tid * per, n_b), q1 = min(q0 + per, n_b);
    const int64_t n_tiles = (n + SM_STAGE - 1) / SM_STAGE;
    for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const int64_t r0 = t * SM_STAGE;
        const int rows = (int)sm_min(SM_STAGE, n - r0);
        for (int b = tid; b < n_b; b += 256) loc[b] = 0;
        __syncthreads();
        int bk[SM_STAGE_PER];
        unsigned rk[SM_STAGE_PER];
        u64 w[SM_STAGE_PER];
        uint32_t e[SM_STAGE_PER];
#pragma unroll
        for (int q = 0; q < SM_STAGE_PER; ++q) {
            const int i = tid + q * 256;
            if (i < rows) {
                const u64 k = (u64)(key[r0 + i] - kmin);
                bk[q] = (int)(k >> shift);
                w[q] = ((k & kmask) << sb) | (u64)start[r0 + i];
                e[q] = (uint32_t)end[r0 + i];
                rk[q] = atomicAdd(&loc[bk[q]], 1u);
            }
        }
        __syncthreads();
        int64_t sum = 0;
        for (int b = q0; b < q1; ++b) sum += loc[b];
        int64_t total;
        int64_t acc = group_exscan_sum<256>(sum, sh_sum, &total);
        for (int b = q0; b < q1; ++b) {
            const unsigned c = loc[b];
            lo[b] = (unsigned)acc;
            acc += c;
            if (c) at[b] = bo_incl[b] - (int64_t)atomicAdd(&cnt[b],
                                                          0ull - (u64)c);
        }
        __syncthreads();
#pragma unroll
        for (int q = 0; q < SM_STAGE_PER; ++q) {
            const int i = tid + q * 256;
            if (i < rows) {
                const unsigned p = lo[bk[q]] + rk[q];
                sw[p] = w[q];
                se[p] = e[q];
                sbk[p] = (uint16_t)bk[q];
            }
        }
        __syncthreads();
        for (int p = tid; p < rows; p += 256) {
            const int b = sbk[p];
            const int64_t slot = at[b] + (p - (int)lo[b]);
            W[slot] = sw[p];
            E[slot] = se[p];
        }
        __syncthreads();
    }
}

static size_t sm_stage_smem() {
    return (size_t)SM_HIST_BINS * (8 + 4 + 4) + (size_t)SM_STAGE * (8 + 4 + 2);
}

// ----------------------------------------------------------------------
// 3. Sort and merge a bucket
// ----------------------------------------------------------------------

template <int G>
__device__ __forceinline__ int group_rank() {
    return G == 32 ? (int)(threadIdx.x & 31) : (int)threadIdx.x;
}

// A sorted bucket in shared memory: word i holds sk << ib | row index,
// its end is ends[i].
template <typename Word>
struct SmemRows {
    const Word* w;
    const uint32_t* e;
    int ib;
    __device__ u64 sk(int64_t i) const { return (u64)(w[i] >> ib); }
    __device__ uint32_t end(int64_t i) const { return e[i]; }
};

// A sorted bucket in device memory.
struct GlobalRows {
    const u64* w;
    const uint32_t* e;
    __device__ u64 sk(int64_t i) const { return w[i]; }
    __device__ uint32_t end(int64_t i) const { return e[i]; }
};

// The runs of a sorted bucket of m rows: each run's first sk goes to
// RW[r] and its merged end to RE[r]; returns the run count (to every
// thread of the group).  A thread takes a contiguous chunk (of odd
// length: no bank conflicts); pass 1 gives each chunk's segmented max,
// a group scan the carry into it, pass 2 counts the chunk's runs, a
// group scan their offsets, and pass 3 writes them: a run's end is
// written by the thread that holds its last row.
template <int G, class Rows>
__device__ int64_t merge_sorted(const Rows& rows, int64_t m, int sb,
                                u64* __restrict__ RW,
                                uint32_t* __restrict__ RE, SegMax* sh_seg,
                                int64_t* sh_sum) {
    const int t = group_rank<G>();
    const u64 smask = ((u64)1 << sb) - 1;
    const int64_t chunk = ((m + G - 1) / G) | 1;
    const int64_t c0 = sm_min((int64_t)t * chunk, m);
    const int64_t c1 = sm_min(c0 + chunk, m);
    const u64 prev_key = c0 > 0 ? rows.sk(c0 - 1) >> sb : ~0ull;

    SegMax agg{0, 0};
    {
        u64 pk = prev_key;
        for (int64_t i = c0; i < c1; ++i) {
            const u64 k = rows.sk(i) >> sb;
            const uint32_t e = rows.end(i);
            if (i == 0 || k != pk) agg = SegMax{1, e};
            else agg.v = agg.v > e ? agg.v : e;
            pk = k;
        }
    }
    const uint32_t carry = group_exscan_seg<G>(agg, sh_seg).v;

    int64_t mine = 0;
    {
        u64 pk = prev_key;
        uint32_t run = carry;
        for (int64_t i = c0; i < c1; ++i) {
            const u64 sk = rows.sk(i);
            const u64 k = sk >> sb;
            const uint32_t e = rows.end(i);
            const bool head = i == 0 || k != pk;
            if (head || (uint32_t)(sk & smask) > run) ++mine;
            run = head ? e : (run > e ? run : e);
            pk = k;
        }
    }
    int64_t total;
    int64_t cur = group_exscan_sum<G>(mine, sh_sum, &total) - 1;

    u64 pk = prev_key;
    uint32_t run = carry;
    for (int64_t i = c0; i < c1; ++i) {
        const u64 sk = rows.sk(i);
        const u64 k = sk >> sb;
        const uint32_t e = rows.end(i);
        const bool head = i == 0 || k != pk;
        if (head || (uint32_t)(sk & smask) > run) {
            if (i > c0) RE[cur] = run;
            ++cur;
            RW[cur] = sk;
        }
        run = head ? e : (run > e ? run : e);
        pk = k;
    }
    if (c0 < c1) {
        bool last = c1 == m;
        if (!last) {
            const u64 sk = rows.sk(c1);
            last = (sk >> sb) != pk || (uint32_t)(sk & smask) > run;
        }
        if (last) RE[cur] = run;
    }
    return total;
}

// A bucket of m <= 32 * R rows sorted by one warp: word i = sk << 9 | i
// in register r of lane i % 32 (i = 32 r + lane), a bitonic network
// over 32 R entries (the missing ones the largest word), exchanges
// across lanes by shuffles and within a lane in registers; the first m
// words go to ws.
template <typename Word, int R>
__device__ __forceinline__ void warp_sort(const u64* __restrict__ Wb, int m,
                                          Word* ws) {
    const int lane = threadIdx.x & 31;
    Word v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const int i = (r << 5) | lane;
        v[r] = i < m ? (Word)((Wb[i] << SM_WARP_IB) | (u64)i) : (Word)~(Word)0;
    }
#pragma unroll
    for (int k = 2; k <= 32 * R; k <<= 1) {
#pragma unroll
        for (int j = k >> 1; j > 0; j >>= 1) {
            if (j >= 32) {
#pragma unroll
                for (int r = 0; r < R; ++r) {
                    const int r2 = r ^ (j >> 5);
                    if (r2 > r) {
                        const bool asc = ((((r << 5) | lane)) & k) == 0;
                        const Word x = v[r], y = v[r2];
                        if ((x > y) == asc) {
                            v[r] = y;
                            v[r2] = x;
                        }
                    }
                }
            } else {
#pragma unroll
                for (int r = 0; r < R; ++r) {
                    const Word x = v[r];
                    const Word y = __shfl_xor_sync(0xffffffffu, x, j);
                    const bool asc = ((((r << 5) | lane)) & k) == 0;
                    const bool lower = (lane & j) == 0;
                    const Word lo = x < y ? x : y, hi = x < y ? y : x;
                    v[r] = lower == asc ? lo : hi;
                }
            }
        }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const int i = (r << 5) | lane;
        if (i < m) ws[i] = v[r];
    }
}

// Warp tier: a warp per bucket of 2..wt rows (grid-stride): warp_sort
// over the next of 32, 64, 128, 256 or 512 entries, the ends gathered
// beside the sorted words, then merge_sorted<32>.  Buckets of one row are
// their own run; empty ones have none.  A larger bucket is listed for
// the block tier (list from the front, its count in n_list[0]) or the
// device tier (from the back, n_list[1]), so that those kernels visit
// only their own buckets.
template <typename Word>
__global__ void __launch_bounds__(SM_WARP_THREADS)
sm_warp_kernel(const u64* __restrict__ W, const uint32_t* __restrict__ E,
               const int64_t* __restrict__ bo_incl, int64_t n_b, int wt,
               int tile, int sb, u64* __restrict__ RW,
               uint32_t* __restrict__ RE, int64_t* __restrict__ rc,
               int64_t* __restrict__ list, u64* __restrict__ n_list) {
    extern __shared__ __align__(16) unsigned char wsm[];
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    const int wpb = SM_WARP_THREADS / 32;
    Word* ws = (Word*)wsm + wid * SM_WARP_TILE;
    uint32_t* es = (uint32_t*)((Word*)wsm + wpb * SM_WARP_TILE)
        + wid * SM_WARP_TILE;
    for (int64_t b = (int64_t)blockIdx.x * wpb + wid; b < n_b;
         b += (int64_t)gridDim.x * wpb) {
        const int64_t b0 = b == 0 ? 0 : bo_incl[b - 1];
        const int64_t m = bo_incl[b] - b0;
        if (m > wt) {
            if (lane == 0) {
                if (m <= tile) list[atomicAdd(&n_list[0], 1ull)] = b;
                else list[n_b - 1 - (int64_t)atomicAdd(&n_list[1], 1ull)] = b;
            }
            continue;
        }
        if (m <= 1) {
            if (lane == 0) {
                if (m == 1) {
                    RW[b0] = W[b0];
                    RE[b0] = E[b0];
                }
                rc[b] = m;
            }
            continue;
        }
        const int mi = (int)m;
        if (mi <= 32) warp_sort<Word, 1>(W + b0, mi, ws);
        else if (mi <= 64) warp_sort<Word, 2>(W + b0, mi, ws);
        else if (mi <= 128) warp_sort<Word, 4>(W + b0, mi, ws);
        else if (mi <= 256) warp_sort<Word, 8>(W + b0, mi, ws);
        else warp_sort<Word, 16>(W + b0, mi, ws);
        __syncwarp();
#pragma unroll 4
        for (int i = lane; i < mi; i += 32)
            es[i] = E[b0 + (int64_t)(ws[i] & ((1u << SM_WARP_IB) - 1))];
        __syncwarp();
        const int64_t r = merge_sorted<32>(SmemRows<Word>{ws, es, SM_WARP_IB},
                                           m, sb, RW + b0, RE + b0, nullptr,
                                           nullptr);
        if (lane == 0) rc[b] = r;
        __syncwarp();
    }
}

// Block tier: one block per listed bucket of wt + 1 .. tile rows
// (grid-stride).  Dynamic shared memory: the u16 digit counts
// [digit][thread], then two buffers of tile words.  The bucket's words
// sk << ib | row index are sorted by an LSD radix sort over 4-bit
// digits of sk's significant bits, a thread a contiguous chunk of odd
// length (no bank conflicts) counted in registers, ping-pong between
// the buffers; the ends are gathered into the free buffer, then
// merge_sorted<SM_BLOCK_THREADS>.
template <typename Word>
__global__ void __launch_bounds__(SM_BLOCK_THREADS)
sm_block_kernel(const u64* __restrict__ W, const uint32_t* __restrict__ E,
                const int64_t* __restrict__ bo_incl, int tile, int sb,
                int ib, u64* __restrict__ RW, uint32_t* __restrict__ RE,
                int64_t* __restrict__ rc, const int64_t* __restrict__ list,
                const u64* __restrict__ n_list) {
    constexpr int T = SM_BLOCK_THREADS;
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ SegMax sh_seg[T / 32];
    __shared__ int64_t sh_sum[T / 32];
    __shared__ u64 sh_max[T / 32];
    uint16_t* counts = (uint16_t*)smem;
    Word* bufA = (Word*)(smem + SM_COUNTS_BYTES);
    Word* bufB = bufA + tile;
    const int tid = threadIdx.x;
    const Word imask = (Word)(((u64)1 << ib) - 1);
    const int64_t nl = (int64_t)n_list[0];
    for (int64_t li = blockIdx.x; li < nl; li += gridDim.x) {
        const int64_t b = list[li];
        const int64_t b0 = b == 0 ? 0 : bo_incl[b - 1];
        const int m = (int)(bo_incl[b] - b0);
        u64 mx = 0;
#pragma unroll 8
        for (int i = tid; i < m; i += T) {
            const u64 sk = W[b0 + i];
            bufA[i] = (Word)((sk << ib) | (u64)i);
            mx = sk > mx ? sk : mx;
        }
        mx = group_max<T>(mx, sh_max);   // also orders the loads
        const int bits = mx ? 64 - __clzll(mx) : 0;
        const int passes = (bits + SM_DIGIT_BITS - 1) / SM_DIGIT_BITS;
        const int chunk = ((m + T - 1) / T) | 1;
        const int c0 = min(tid * chunk, m), c1 = min(c0 + chunk, m);
        Word* src = bufA;
        Word* dst = bufB;
        for (int ps = 0; ps < passes; ++ps) {
            const int sh = ib + ps * SM_DIGIT_BITS;
            // 16 counts of 8 bits in two registers (a chunk is < 256)
            u64 c_lo = 0, c_hi = 0;
            for (int i = c0; i < c1; ++i) {
                const int d = (int)((src[i] >> sh) & (SM_DIGITS - 1));
                if (d < 8) c_lo += 1ull << (8 * d);
                else c_hi += 1ull << (8 * (d - 8));
            }
            for (int d = 0; d < SM_DIGITS; ++d)
                counts[d * T + tid] = (uint16_t)(
                    (d < 8 ? c_lo >> (8 * d) : c_hi >> (8 * (d - 8))) & 255);
            __syncthreads();
            // exclusive scan of counts in [digit][thread] order: thread
            // tid takes the 16 entries from tid * 16
            uint16_t run[SM_DIGITS];
            int64_t sum = 0;
            for (int d = 0; d < SM_DIGITS; ++d) {
                run[d] = counts[tid * SM_DIGITS + d];
                sum += run[d];
            }
            int64_t total;
            int64_t at = group_exscan_sum<T>(sum, sh_sum, &total);
            for (int d = 0; d < SM_DIGITS; ++d) {
                counts[tid * SM_DIGITS + d] = (uint16_t)at;
                at += run[d];
            }
            __syncthreads();
            for (int i = c0; i < c1; ++i) {
                const Word v = src[i];
                const int d = (int)((v >> sh) & (SM_DIGITS - 1));
                dst[counts[d * T + tid]++] = v;
            }
            __syncthreads();
            Word* tmp = src;
            src = dst;
            dst = tmp;
        }
        uint32_t* ends = (uint32_t*)dst;
#pragma unroll 8
        for (int i = tid; i < m; i += T)
            ends[i] = E[b0 + (int64_t)(src[i] & imask)];
        __syncthreads();
        const int64_t r = merge_sorted<T>(SmemRows<Word>{src, ends, ib}, m,
                                          sb, RW + b0, RE + b0, sh_seg,
                                          sh_sum);
        if (tid == 0) rc[b] = r;
        __syncthreads();
    }
}

// Device tier: one block per listed bucket above the tile (grid-stride).
// A stable LSD radix sort over 4-bit digits of sk's significant bits
// moves (sk, end) between (W, E) and (RW, RE), an even number of passes
// so that the sorted bucket ends in (W, E); then merge_sorted writes its
// runs to (RW, RE).
__global__ void __launch_bounds__(SM_DEV_THREADS)
sm_device_kernel(u64* __restrict__ W, uint32_t* __restrict__ E,
                 const int64_t* __restrict__ bo_incl, int64_t n_b, int sb,
                 u64* __restrict__ RW, uint32_t* __restrict__ RE,
                 int64_t* __restrict__ rc, const int64_t* __restrict__ list,
                 const u64* __restrict__ n_list) {
    constexpr int T = SM_DEV_THREADS;
    __shared__ unsigned counts[SM_DIGITS * T];
    __shared__ SegMax sh_seg[T / 32];
    __shared__ int64_t sh_sum[T / 32];
    __shared__ u64 sh_max[T / 32];
    const int tid = threadIdx.x;
    const int64_t nl = (int64_t)n_list[1];
    for (int64_t li = blockIdx.x; li < nl; li += gridDim.x) {
        const int64_t b = list[n_b - 1 - li];
        const int64_t b0 = b == 0 ? 0 : bo_incl[b - 1];
        const int64_t m = bo_incl[b] - b0;
        u64 mx = 0;
        for (int64_t i = tid; i < m; i += T)
            mx = W[b0 + i] > mx ? W[b0 + i] : mx;
        mx = group_max<T>(mx, sh_max);
        const int bits = mx ? 64 - __clzll(mx) : 0;
        int passes = (bits + SM_DIGIT_BITS - 1) / SM_DIGIT_BITS;
        passes += passes & 1;
        const int64_t chunk = (m + T - 1) / T;
        const int64_t c0 = sm_min((int64_t)tid * chunk, m);
        const int64_t c1 = sm_min(c0 + chunk, m);
        u64* sw = W + b0;
        uint32_t* se = E + b0;
        u64* dw = RW + b0;
        uint32_t* de = RE + b0;
        for (int ps = 0; ps < passes; ++ps) {
            const int sh = ps * SM_DIGIT_BITS;
            for (int d = 0; d < SM_DIGITS; ++d) counts[d * T + tid] = 0;
            for (int64_t i = c0; i < c1; ++i) {
                const int d = sh < 64 ? (int)((sw[i] >> sh) & (SM_DIGITS - 1))
                                      : 0;
                ++counts[d * T + tid];
            }
            __syncthreads();
            unsigned run[SM_DIGITS];
            int64_t sum = 0;
            for (int d = 0; d < SM_DIGITS; ++d) {
                run[d] = counts[tid * SM_DIGITS + d];
                sum += run[d];
            }
            int64_t total;
            int64_t at = group_exscan_sum<T>(sum, sh_sum, &total);
            for (int d = 0; d < SM_DIGITS; ++d) {
                counts[tid * SM_DIGITS + d] = (unsigned)at;
                at += run[d];
            }
            __syncthreads();
            for (int64_t i = c0; i < c1; ++i) {
                const u64 v = sw[i];
                const int d = sh < 64 ? (int)((v >> sh) & (SM_DIGITS - 1))
                                      : 0;
                const unsigned o = counts[d * T + tid]++;
                dw[o] = v;
                de[o] = se[i];
            }
            __syncthreads();
            u64* tw = sw;
            sw = dw;
            dw = tw;
            uint32_t* te = se;
            se = de;
            de = te;
        }
        const int64_t r = merge_sorted<T>(GlobalRows{W + b0, E + b0}, m, sb,
                                          RW + b0, RE + b0, sh_seg, sh_sum);
        if (tid == 0) rc[b] = r;
        __syncthreads();
    }
}

// ----------------------------------------------------------------------
// 4. Emit
// ----------------------------------------------------------------------

// One block per bucket (grid-stride): its runs as int64 (key, start,
// end) rows at the run offsets.
__global__ void sm_emit_kernel(const u64* __restrict__ RW,
                               const uint32_t* __restrict__ RE,
                               const int64_t* __restrict__ bo_incl,
                               const int64_t* __restrict__ rc,
                               const int64_t* __restrict__ ro_incl,
                               int64_t n_b, int64_t kmin, int shift, int sb,
                               int64_t* __restrict__ out_k,
                               int64_t* __restrict__ out_s,
                               int64_t* __restrict__ out_e) {
    const u64 smask = ((u64)1 << sb) - 1;
    for (int64_t b = blockIdx.x; b < n_b; b += gridDim.x) {
        const int64_t b0 = b == 0 ? 0 : bo_incl[b - 1];
        const int64_t r = rc[b];
        const int64_t o = ro_incl[b] - r;
        const int64_t k0 = kmin + (b << shift);
        for (int64_t j = threadIdx.x; j < r; j += blockDim.x) {
            const u64 sk = RW[b0 + j];
            out_k[o + j] = k0 + (int64_t)(sk >> sb);
            out_s[o + j] = (int64_t)(sk & smask);
            out_e[o + j] = RE[b0 + j];
        }
    }
}

static unsigned sm_grid(int64_t n, int per_block, int64_t cap) {
    int64_t g = (n + per_block - 1) / per_block;
    return (unsigned)(g < 1 ? 1 : (g > cap ? cap : g));
}

template <typename K>
static cudaError_t sm_smem_attr(K* kernel, size_t bytes) {
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

extern "C" int ct_sm_bounds(const void* key, const void* start,
                            const void* end, int64_t n, void* out,
                            void* stream) {
    cudaStream_t st = ct_stream(stream);
    cudaError_t err = cudaMemsetAsync(out, 0, 5 * sizeof(u64), st);
    if (err != cudaSuccess) return (int)err;
    if (n > 0) {
        sm_bounds_kernel<<<sm_grid(n, 4 * 256, 132 * 8), 256, 0, st>>>(
            (const int64_t*)key, (const int64_t*)start, (const int64_t*)end,
            n, (u64*)out);
    }
    return (int)cudaGetLastError();
}

// The whole of segmented_merge after the bounds read, in three calls on
// one stream.  n_b buckets of keys kmin + (b << shift) ...; sb: bits of
// the largest start; ib: bits of a row index below the tile; tile: the
// block tier's rows (halved by the wrapper for 64-bit words; word32
// when shift + sb + ib <= 32).  ws64 (u64): W, RW [n]; ws32 (u32): E,
// RE [n]; wsb (int64): cnt, bo_incl, rc, ro_incl, list [n_b], the two
// list counts, then sm_scan's tile totals.
//   phase 0: bucket counts, offsets and the scatter;
//   phase 1: the three tiers and ro_incl, whose last entry the wrapper
//     reads;
//   phase 2: the rows into out_k, out_s, out_e [that total].
extern "C" int ct_sm_run(const void* key, const void* start, const void* end,
                         int64_t n, int64_t kmin, int shift, int64_t n_b,
                         int sb, int ib, int tile, int word32, void* ws64,
                         void* ws32, void* wsb, void* out_k, void* out_s,
                         void* out_e, int phase, void* stream) {
    if (n <= 0 || n_b <= 0) return (int)cudaGetLastError();
    cudaStream_t st = ct_stream(stream);
    u64* W = (u64*)ws64;
    u64* RW = W + n;
    uint32_t* E = (uint32_t*)ws32;
    uint32_t* RE = E + n;
    int64_t* cnt = (int64_t*)wsb;
    int64_t* bo = cnt + n_b;
    int64_t* rc = cnt + 2 * n_b;
    int64_t* ro = cnt + 3 * n_b;
    int64_t* list = cnt + 4 * n_b;
    u64* n_list = (u64*)(cnt + 5 * n_b);
    int64_t* tot = cnt + 5 * n_b + 2;
    cudaError_t err;
    if (phase == 0) {
        if ((err = cudaMemsetAsync(cnt, 0, n_b * sizeof(int64_t), st))
            != cudaSuccess)
            return (int)err;
        const bool few = n_b <= SM_HIST_BINS;
        sm_hist_kernel<<<sm_grid(n, 256, few ? 132 * 4 : 132 * 16), 256, 0,
                         st>>>((const int64_t*)key, n, kmin, shift, n_b,
                               (u64*)cnt);
        if ((err = sm_scan(cnt, n_b, bo, tot, st)) != cudaSuccess)
            return (int)err;
        if (few) {
            const size_t bytes = sm_stage_smem();
            if ((err = sm_smem_attr(sm_scatter_staged_kernel, bytes))
                != cudaSuccess)
                return (int)err;
            sm_scatter_staged_kernel<<<sm_grid(n, SM_STAGE, 132 * 8), 256,
                                       bytes, st>>>(
                (const int64_t*)key, (const int64_t*)start,
                (const int64_t*)end, n, kmin, shift, sb, (int)n_b, bo,
                (u64*)cnt, W, E);
        } else {
            sm_scatter_kernel<<<sm_grid(n, 256, 132 * 16), 256, 0, st>>>(
                (const int64_t*)key, (const int64_t*)start,
                (const int64_t*)end, n, kmin, shift, sb, bo, (u64*)cnt, W,
                E);
        }
        return (int)cudaGetLastError();
    }
    if (phase == 2) {
        const int64_t grid = n_b < 132 * 64 ? n_b : 132 * 64;
        sm_emit_kernel<<<(unsigned)grid, 256, 0, st>>>(
            RW, RE, bo, rc, ro, n_b, kmin, shift, sb, (int64_t*)out_k,
            (int64_t*)out_s, (int64_t*)out_e);
        return (int)cudaGetLastError();
    }
    const int wt = tile < SM_WARP_TILE ? tile : SM_WARP_TILE;
    if ((err = cudaMemsetAsync(n_list, 0, 2 * sizeof(u64), st))
        != cudaSuccess)
        return (int)err;
    int64_t grid = (n_b + 7) / 8;
    if (grid > 132 * 16) grid = 132 * 16;
    const size_t wwords = (size_t)(SM_WARP_THREADS / 32) * SM_WARP_TILE;
    if (shift + sb + SM_WARP_IB <= 32) {
        if ((err = sm_smem_attr(sm_warp_kernel<uint32_t>, wwords * (4 + 4)))
            != cudaSuccess)
            return (int)err;
        sm_warp_kernel<uint32_t><<<(unsigned)grid, SM_WARP_THREADS,
                                   wwords * (4 + 4), st>>>(
            W, E, bo, n_b, wt, tile, sb, RW, RE, rc, list, n_list);
    } else {
        if ((err = sm_smem_attr(sm_warp_kernel<u64>, wwords * (8 + 4)))
            != cudaSuccess)
            return (int)err;
        sm_warp_kernel<u64><<<(unsigned)grid, SM_WARP_THREADS,
                              wwords * (8 + 4), st>>>(
            W, E, bo, n_b, wt, tile, sb, RW, RE, rc, list, n_list);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const size_t bytes = SM_COUNTS_BYTES + 2 * (size_t)tile * (word32 ? 4 : 8);
    grid = n_b < 132 ? n_b : 132;
    if (word32) {
        if ((err = sm_smem_attr(sm_block_kernel<uint32_t>, bytes))
            != cudaSuccess)
            return (int)err;
        sm_block_kernel<uint32_t><<<(unsigned)grid, SM_BLOCK_THREADS, bytes,
                                    st>>>(W, E, bo, tile, sb, ib, RW, RE, rc,
                                          list, n_list);
    } else {
        if ((err = sm_smem_attr(sm_block_kernel<u64>, bytes)) != cudaSuccess)
            return (int)err;
        sm_block_kernel<u64><<<(unsigned)grid, SM_BLOCK_THREADS, bytes,
                               st>>>(W, E, bo, tile, sb, ib, RW, RE, rc,
                                     list, n_list);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    sm_device_kernel<<<(unsigned)grid, SM_DEV_THREADS, 0, st>>>(
        W, E, bo, n_b, sb, RW, RE, rc, list, n_list);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    return (int)sm_scan(rc, n_b, ro, tot, st);
}
