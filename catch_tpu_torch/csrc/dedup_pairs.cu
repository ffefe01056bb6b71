// K2 dedup_pairs: the distinct (p, a) pairs of int64 p and a in
// [0, 2^31), sorted by (p, a), without a library sort.
//
// Replaces catch_tpu/ops/scan_instance.py _dedup_pairs_jit (:341-360)
// where it runs apart from the expansion: on the mesh's lead, over the
// pairs that the places' sample ranges found (3.54 M on ebola175 at 4
// places, at most a few thousand a probe).
//
// One pass (ct_max_pair) finds the bucket count and checks the range;
// one host read.  Then one C call (ct_dd_run,
// emit = 0) buckets the pairs by probe: a histogram (warp-aggregated
// atomics: the caller's pairs come as place-sorted runs, so a warp's
// lanes mostly share one probe), the bucket offsets (scan.cuh), and
// each a scattered as 32 bits into its bucket.  Each bucket is then
// sorted in shared memory by a bitonic network over its next power of
// two, and the first of each run kept: a warp sorts a bucket of up to
// 1,024 pairs (ebola175's average bucket holds 189), a block one up to
// the tile (an argument of the launcher, a power of two).  A larger
// bucket is sorted in global scratch by a stable block-wide LSD radix
// sort over 4-bit digits of its significant bits, then compacted.
// Either way the distinct values go back to the bucket's own slots with
// their count; the counts' offsets and one host read size the output,
// and ct_dd_run (emit = 1) writes (p, a) as int64.
//
// Bound on the card: bytes (16 a pair in, 16 a distinct pair out, and
// the 4-byte bucket copy written and read); the sort of a bucket stays
// in shared memory, so the passes over device memory are fixed, and
// what is left is the host reads' round trips and the launches.
#include "common.cuh"
#include "scan.cuh"

#define DD_THREADS 256
#define DD_DIGIT_BITS 4
#define DD_DIGITS (1 << DD_DIGIT_BITS)
#define DD_WARP_TILE 1024   // largest bucket a warp sorts alone

__device__ __forceinline__ int64_t dd_min(int64_t x, int64_t y) {
    return x < y ? x : y;
}

__device__ __forceinline__ unsigned dd_lanemask_lt() {
    unsigned m;
    asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
    return m;
}

// out[0], out[1] = the largest x[i], y[i] as unsigned 64-bit words (so
// a negative value is larger than any valid one).  out starts at 0.
// The bounds read of dedup_pairs.
__global__ void max_pair_kernel(const int64_t* __restrict__ x,
                                const int64_t* __restrict__ y, int64_t n,
                                unsigned long long* __restrict__ out) {
    unsigned long long mx = 0, my = 0;
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += stride) {
        const unsigned long long u = (unsigned long long)x[i];
        const unsigned long long v = (unsigned long long)y[i];
        mx = u > mx ? u : mx;
        my = v > my ? v : my;
    }
    for (int d = 16; d > 0; d >>= 1) {
        const unsigned long long u = __shfl_xor_sync(0xffffffffu, mx, d);
        const unsigned long long v = __shfl_xor_sync(0xffffffffu, my, d);
        mx = u > mx ? u : mx;
        my = v > my ? v : my;
    }
    if ((threadIdx.x & 31) == 0) {
        atomicMax(&out[0], mx);
        atomicMax(&out[1], my);
    }
}

// Bucket counts; warp lanes that share a bucket add once.
__global__ void dd_hist_kernel(const int64_t* __restrict__ p, int64_t n,
                               unsigned long long* __restrict__ cnt) {
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t base = (int64_t)blockIdx.x * blockDim.x; base < n;
         base += stride) {
        const int64_t i = base + threadIdx.x;
        const bool ok = i < n;
        const unsigned act = __ballot_sync(0xffffffffu, ok);
        if (!ok) continue;
        const int64_t b = p[i];
        const unsigned grp = __match_any_sync(act, (unsigned long long)b);
        if ((grp & dd_lanemask_lt()) == 0)
            atomicAdd(&cnt[b], (unsigned long long)__popc(grp));
    }
}

// Each a into its bucket; cnt counts down to 0.
__global__ void dd_scatter_kernel(const int64_t* __restrict__ p,
                                  const int64_t* __restrict__ a, int64_t n,
                                  const int64_t* __restrict__ bo_incl,
                                  unsigned long long* __restrict__ cnt,
                                  uint32_t* __restrict__ buf) {
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    const int lane = threadIdx.x & 31;
    for (int64_t base = (int64_t)blockIdx.x * blockDim.x; base < n;
         base += stride) {
        const int64_t i = base + threadIdx.x;
        const bool ok = i < n;
        const unsigned act = __ballot_sync(0xffffffffu, ok);
        if (!ok) continue;
        const int64_t b = p[i];
        const unsigned grp = __match_any_sync(act, (unsigned long long)b);
        const int leader = __ffs(grp) - 1;
        unsigned long long old = 0;
        if (lane == leader)
            old = atomicAdd(&cnt[b], 0ull - (unsigned long long)__popc(grp));
        old = __shfl_sync(act, old, leader);
        const int64_t slot = bo_incl[b] - (int64_t)old
            + __popc(grp & dd_lanemask_lt());
        buf[slot] = (uint32_t)a[i];
    }
}

// Exclusive block-wide prefix sum of one value a thread; *total gets
// the sum.  Uses warp_sums[DD_THREADS / 32].
__device__ int64_t dd_block_scan(int64_t v, int64_t* warp_sums,
                                 int64_t* total) {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    int64_t x = v;
    for (int d = 1; d < 32; d <<= 1) {
        int64_t y = __shfl_up_sync(0xffffffffu, x, d);
        if (lane >= d) x += y;
    }
    __syncthreads();
    if (lane == 31) warp_sums[w] = x;
    __syncthreads();
    int64_t before = 0, all = 0;
    for (int j = 0; j < DD_THREADS / 32; ++j) {
        if (j < w) before += warp_sums[j];
        all += warp_sums[j];
    }
    *total = all;
    return before + x - v;
}

// Keep the first of each run of the sorted src[0, m) in dst (apart
// from src); returns the distinct count.  A thread takes a contiguous
// chunk, so the kept values stay in order.
__device__ int64_t dd_compact(const uint32_t* src, uint32_t* dst, int64_t m,
                              int64_t* warp_sums) {
    const int64_t chunk = (m + DD_THREADS - 1) / DD_THREADS;
    const int64_t c0 = dd_min((int64_t)threadIdx.x * chunk, m);
    const int64_t c1 = dd_min(c0 + chunk, m);
    int64_t mine = 0;
    uint32_t prev = c0 > 0 ? src[c0 - 1] : 0;
    for (int64_t i = c0; i < c1; ++i) {
        const uint32_t v = src[i];
        mine += (i == 0 || v != prev);
        prev = v;
    }
    int64_t total;
    int64_t at = dd_block_scan(mine, warp_sums, &total);
    prev = c0 > 0 ? src[c0 - 1] : 0;
    for (int64_t i = c0; i < c1; ++i) {
        const uint32_t v = src[i];
        if (i == 0 || v != prev) dst[at++] = v;
        prev = v;
    }
    return total;
}

// A warp per bucket of 2..wt pairs (wt = min(DD_WARP_TILE, tile)),
// grid-stride: the bucket in the warp's shared-memory tile, a bitonic
// network over its next power of two, the first of each run written
// back to its first slots; buckets of at most 1 pair are their own
// result.  Their number goes to dcnt.
__global__ void __launch_bounds__(DD_THREADS)
dd_sort_warp_kernel(uint32_t* __restrict__ buf,
                    const int64_t* __restrict__ bo_incl, int64_t n_buckets,
                    int wt, int64_t* __restrict__ dcnt) {
    extern __shared__ uint32_t smem[];          // DD_THREADS / 32 tiles
    const int lane = threadIdx.x & 31;
    uint32_t* ws = smem + (threadIdx.x >> 5) * wt;
    const int64_t wpb = DD_THREADS / 32;
    for (int64_t b = blockIdx.x * wpb + (threadIdx.x >> 5); b < n_buckets;
         b += gridDim.x * wpb) {
        const int64_t b0 = b == 0 ? 0 : bo_incl[b - 1];
        const int m = (int)dd_min(bo_incl[b] - b0, (int64_t)wt + 1);
        if (m > wt) continue;
        uint32_t* seg = buf + b0;
        if (m <= 1) {
            if (lane == 0) dcnt[b] = m;
            continue;
        }
        int n2 = 1;
        while (n2 < m) n2 <<= 1;
        for (int i = lane; i < n2; i += 32) ws[i] = i < m ? seg[i] : 0xffffffffu;
        __syncwarp();
        for (int k = 2; k <= n2; k <<= 1) {
            for (int j = k >> 1; j > 0; j >>= 1) {
                for (int t = lane; t < (n2 >> 1); t += 32) {
                    const int i = 2 * t - (t & (j - 1));
                    const int l = i + j;
                    const uint32_t x = ws[i], y = ws[l];
                    if ((x > y) == ((i & k) == 0)) {
                        ws[i] = y;
                        ws[l] = x;
                    }
                }
                __syncwarp();
            }
        }
        int at = 0;
        for (int base = 0; base < m; base += 32) {
            const int i = base + lane;
            uint32_t v = 0;
            bool first = false;
            if (i < m) {
                v = ws[i];
                first = i == 0 || v != ws[i - 1];
            }
            const unsigned bal = __ballot_sync(0xffffffffu, first);
            if (first) seg[at + __popc(bal & dd_lanemask_lt())] = v;
            at += __popc(bal);
        }
        if (lane == 0) dcnt[b] = at;
        __syncwarp();
    }
}

// One block per bucket above wt pairs (grid-stride; the others are
// skipped).  buf holds the buckets; tmp is scratch of the same length.
// Writes each bucket's distinct values back to its first slots and
// their number to dcnt.
__global__ void __launch_bounds__(DD_THREADS)
dd_sort_kernel(uint32_t* __restrict__ buf, uint32_t* __restrict__ tmp,
               const int64_t* __restrict__ bo_incl, int64_t n_buckets,
               int tile, int wt, int64_t* __restrict__ dcnt) {
    extern __shared__ uint32_t smem[];          // max(tile, 16 x 256) words
    __shared__ int64_t warp_sums[DD_THREADS / 32];
    __shared__ uint32_t max_word[DD_THREADS / 32];
    for (int64_t b = blockIdx.x; b < n_buckets; b += gridDim.x) {
        const int64_t b0 = b == 0 ? 0 : bo_incl[b - 1];
        const int64_t m = bo_incl[b] - b0;
        uint32_t* seg = buf + b0;
        if (m <= wt) continue;
        if (m <= tile) {
            int n2 = 1;
            while (n2 < m) n2 <<= 1;
            for (int i = threadIdx.x; i < n2; i += DD_THREADS)
                smem[i] = i < m ? seg[i] : 0xffffffffu;
            __syncthreads();
            for (int k = 2; k <= n2; k <<= 1) {
                for (int j = k >> 1; j > 0; j >>= 1) {
                    for (int t = threadIdx.x; t < (n2 >> 1); t += DD_THREADS) {
                        const int i = 2 * t - (t & (j - 1));   // low of pair
                        const int l = i + j;
                        const bool up = (i & k) == 0;
                        const uint32_t x = smem[i], y = smem[l];
                        if ((x > y) == up) {
                            smem[i] = y;
                            smem[l] = x;
                        }
                    }
                    __syncthreads();
                }
            }
            const int64_t d = dd_compact(smem, seg, m, warp_sums);
            if (threadIdx.x == 0) dcnt[b] = d;
            __syncthreads();
            continue;
        }
        // Oversize: stable LSD radix over the significant bits, seg <->
        // tmp, an odd number of passes so the sorted values end in tmp.
        uint32_t* other = tmp + b0;
        uint32_t mx = 0;
        for (int64_t i = threadIdx.x; i < m; i += DD_THREADS)
            mx = max(mx, seg[i]);
        for (int d = 16; d > 0; d >>= 1)
            mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, d));
        if ((threadIdx.x & 31) == 0) max_word[threadIdx.x >> 5] = mx;
        __syncthreads();
        mx = 0;
        for (int j = 0; j < DD_THREADS / 32; ++j) mx = max(mx, max_word[j]);
        const int bits = mx ? 32 - __clz(mx) : 1;
        int passes = (bits + DD_DIGIT_BITS - 1) / DD_DIGIT_BITS;
        if ((passes & 1) == 0) ++passes;
        const int64_t chunk = (m + DD_THREADS - 1) / DD_THREADS;
        const int64_t c0 = dd_min((int64_t)threadIdx.x * chunk, m);
        const int64_t c1 = dd_min(c0 + chunk, m);
        uint32_t* counts = smem;    // [digit][thread]
        const uint32_t* src = seg;
        uint32_t* dst = other;
        for (int ps = 0; ps < passes; ++ps) {
            const int shift = ps * DD_DIGIT_BITS;
            for (int dg = 0; dg < DD_DIGITS; ++dg)
                counts[dg * DD_THREADS + threadIdx.x] = 0;
            for (int64_t i = c0; i < c1; ++i) {
                const int dg = shift < 32 ? (src[i] >> shift) & (DD_DIGITS - 1)
                                          : 0;
                ++counts[dg * DD_THREADS + threadIdx.x];
            }
            __syncthreads();
            // exclusive scan over [digit][thread] in that order
            uint32_t run[DD_DIGITS];
            int64_t sum = 0;
            for (int j = 0; j < DD_DIGITS; ++j) {
                run[j] = counts[threadIdx.x * DD_DIGITS + j];
                sum += run[j];
            }
            int64_t total;
            int64_t at = dd_block_scan(sum, warp_sums, &total);
            __syncthreads();
            for (int j = 0; j < DD_DIGITS; ++j) {
                counts[threadIdx.x * DD_DIGITS + j] = (uint32_t)at;
                at += run[j];
            }
            __syncthreads();
            for (int64_t i = c0; i < c1; ++i) {
                const uint32_t v = src[i];
                const int dg = shift < 32 ? (v >> shift) & (DD_DIGITS - 1)
                                          : 0;
                dst[counts[dg * DD_THREADS + threadIdx.x]++] = v;
            }
            __syncthreads();
            const uint32_t* t = dst;
            dst = (uint32_t*)src;
            src = t;
        }
        // src is tmp's segment now (odd passes)
        const int64_t d = dd_compact(src, seg, m, warp_sums);
        if (threadIdx.x == 0) dcnt[b] = d;
        __syncthreads();
    }
}

// One block per bucket: its distinct values as int64 (p, a) rows.
__global__ void dd_emit_kernel(const uint32_t* __restrict__ buf,
                               const int64_t* __restrict__ bo_incl,
                               const int64_t* __restrict__ dcnt,
                               const int64_t* __restrict__ do_incl,
                               int64_t n_buckets, int64_t* __restrict__ p_out,
                               int64_t* __restrict__ a_out) {
    for (int64_t b = blockIdx.x; b < n_buckets; b += gridDim.x) {
        const int64_t b0 = b == 0 ? 0 : bo_incl[b - 1];
        const int64_t d = dcnt[b];
        const int64_t o = do_incl[b] - d;
        for (int64_t j = threadIdx.x; j < d; j += blockDim.x) {
            p_out[o + j] = b;
            a_out[o + j] = buf[b0 + j];
        }
    }
}

static unsigned dd_grid(int64_t n, int64_t cap) {
    int64_t g = (n + DD_THREADS - 1) / DD_THREADS;
    return (unsigned)(g < 1 ? 1 : (g > cap ? cap : g));
}

static cudaError_t dd_sort(uint32_t* buf, uint32_t* tmp,
                           const int64_t* bo_incl, int64_t n_buckets,
                           int tile, int64_t* dcnt, cudaStream_t st) {
    const int wt = tile < DD_WARP_TILE ? tile : DD_WARP_TILE;
    int64_t grid = (n_buckets + 7) / 8;
    if (grid > 132 * 16) grid = 132 * 16;
    dd_sort_warp_kernel<<<(unsigned)grid, DD_THREADS,
                          (DD_THREADS / 32) * wt * sizeof(uint32_t), st>>>(
        buf, bo_incl, n_buckets, wt, dcnt);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const int words = tile > DD_DIGITS * DD_THREADS ? tile
                                                    : DD_DIGITS * DD_THREADS;
    const size_t bytes = (size_t)words * sizeof(uint32_t);
    if (bytes > 48 * 1024) {
        err = cudaFuncSetAttribute(
            dd_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)bytes);
        if (err != cudaSuccess) return err;
    }
    grid = n_buckets < 132 * 4 ? n_buckets : 132 * 4;
    dd_sort_kernel<<<(unsigned)grid, DD_THREADS, bytes, st>>>(
        buf, tmp, bo_incl, n_buckets, tile, wt, dcnt);
    return cudaGetLastError();
}

// The whole of dedup_pairs after the bounds read, in two calls on one
// stream.  n_b = max p + 1 buckets; tile: a power of two.  ws32 (int32):
// buf, tmp [n].  ws64 (int64): cnt, bo_incl, dcnt, d_incl [n_b].
//   emit = 0: bucket counts and offsets, the scatter, the sorts, and
//     d_incl, whose last entry the wrapper reads;
//   emit = 1: the rows into p_out, a_out [that total].
extern "C" int ct_dd_run(const void* p, const void* a, int64_t n,
                         int64_t n_b, int tile, void* ws32, void* ws64,
                         void* p_out, void* a_out, int emit, void* stream) {
    if (n <= 0 || n_b <= 0) return (int)cudaGetLastError();
    cudaStream_t st = ct_stream(stream);
    uint32_t* buf = (uint32_t*)ws32;
    uint32_t* tmp = buf + n;
    int64_t* cnt = (int64_t*)ws64;
    int64_t* bo = cnt + n_b;
    int64_t* dcnt = cnt + 2 * n_b;
    int64_t* d_incl = cnt + 3 * n_b;
    const int64_t grid_b = n_b < 132 * 64 ? n_b : 132 * 64;
    if (emit) {
        dd_emit_kernel<<<(unsigned)grid_b, 128, 0, st>>>(
            buf, bo, dcnt, d_incl, n_b, (int64_t*)p_out, (int64_t*)a_out);
        return (int)cudaGetLastError();
    }
    cudaError_t err = cudaMemsetAsync(cnt, 0, n_b * sizeof(int64_t), st);
    if (err != cudaSuccess) return (int)err;
    dd_hist_kernel<<<dd_grid(n, 132 * 16), DD_THREADS, 0, st>>>(
        (const int64_t*)p, n, (unsigned long long*)cnt);
    if ((err = ct_scan(cnt, n_b, bo, st)) != cudaSuccess) return (int)err;
    dd_scatter_kernel<<<dd_grid(n, 132 * 16), DD_THREADS, 0, st>>>(
        (const int64_t*)p, (const int64_t*)a, n, bo,
        (unsigned long long*)cnt, buf);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    if ((err = dd_sort(buf, tmp, bo, n_b, tile, dcnt, st)) != cudaSuccess)
        return (int)err;
    return (int)ct_scan(dcnt, n_b, d_incl, st);
}

extern "C" int ct_max_pair(const void* x, const void* y, int64_t n,
                           void* out, void* stream) {
    if (n > 0) {
        max_pair_kernel<<<dd_grid(n, 132 * 8), DD_THREADS, 0,
                          ct_stream(stream)>>>(
            (const int64_t*)x, (const int64_t*)y, n,
            (unsigned long long*)out);
    }
    return (int)cudaGetLastError();
}

