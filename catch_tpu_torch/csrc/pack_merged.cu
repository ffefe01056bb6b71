// K9 pack_merged: the merged set-cover instance packed for its readback.
//
// Replaces catch_tpu/ops/scan_instance.py _pack_merged_jit (:611-658).
// The merged rows (key, start, end) are sorted by key, so the key delta
// from the previous row is nonnegative and usually tiny.  Each row
// becomes 4 + b_pos little-endian bytes:
//   u16 key delta (from 0 for the first row), b_pos bytes of start,
//   u16 length end - start.
// A row whose key delta or length exceeds 16 bits stores 0 in that field
// and is listed in the escape arrays with its row index, absolute key and
// end, which the host decoder applies (scan_instance.unpack_merged).  The
// caller picks b_pos from the largest universe-local coordinate, so a
// start always fits.
//
// Bound on the card: device-memory bandwidth (three 8-byte reads and
// 4 + b_pos bytes of writes a row; escapes are rare).  The design keeps
// every access coalesced and writes nothing a row but its bytes:
//   1. rows (pm_rows_kernel): a block of 256 threads takes a tile of
//      rows (2,048 by default; any multiple of 16 up to PM_MAX_TILE).  It
//      reads the tile's keys coalesced into shared memory, with the key
//      before the tile once, builds each row's bytes in shared memory, and
//      writes the tile's (4 + b_pos) * tile bytes out as aligned 16-byte
//      stores (a multiple of 16 bytes for every b_pos, since the tile is).
//      It counts the tile's escapes, one int64 a tile; no flag a row.
//   2. the one-block scan of csrc/scan.cuh turns the counts into
//      inclusive offsets, in the same C call; the wrapper reads the total
//      once.
//   3. escapes (pm_escapes_kernel), launched only when the total is above
//      0: a block a tile, returning at once where the tile has none; the
//      others recompute their rows' escape tests a pass of 256 rows at a
//      time and write (index, key, end) at the tile's offset plus the
//      row's rank (warp ballots and a prefix over the warps), so the
//      escapes stay ascending.
// With no escapes a call is two launches and one 8-byte host read.
// catch_tpu's fixed escape capacity and its unpacked fallback go: the
// escape arrays are sized from the count.
#include "common.cuh"
#include "scan.cuh"

#define PM_THREADS 256
#define PM_WARPS (PM_THREADS / 32)
#define PM_MAX_TILE 2048

// The row's escape test and its packed value: bits 0-15 the key delta,
// then b_pos bytes of start, then the u16 length (escaped fields 0).
template <int BPOS>
__device__ __forceinline__ uint64_t pm_row(int64_t dk, int64_t sv, int64_t ln,
                                           bool* esc) {
    const bool key_esc = dk > 0xFFFF;
    const bool len_esc = ln > 0xFFFF;
    *esc = key_esc || len_esc;
    const uint64_t smask = BPOS == 4 ? 0xFFFFFFFFull
                                     : ((1ull << (8 * BPOS)) - 1);
    return (key_esc ? 0ull : ((uint64_t)dk & 0xFFFF))
        | (((uint64_t)sv & smask) << 16)
        | ((len_esc ? 0ull : ((uint64_t)ln & 0xFFFF)) << (16 + 8 * BPOS));
}

// The 4 + BPOS low bytes of v at dst (shared memory): dst is 8-aligned
// for BPOS 4 (row r at 8r), 2-aligned for BPOS 2 (6r).
template <int BPOS>
__device__ __forceinline__ void pm_put(uint8_t* dst, uint64_t v) {
    if constexpr (BPOS == 4) {
        *reinterpret_cast<uint64_t*>(dst) = v;
    } else if constexpr (BPOS == 2) {
        uint16_t* d = reinterpret_cast<uint16_t*>(dst);
        d[0] = (uint16_t)v;
        d[1] = (uint16_t)(v >> 16);
        d[2] = (uint16_t)(v >> 32);
    } else {
#pragma unroll
        for (int b = 0; b < 4 + BPOS; ++b) dst[b] = (uint8_t)(v >> (8 * b));
    }
}

template <int BPOS>
__global__ void __launch_bounds__(PM_THREADS)
pm_rows_kernel(const int64_t* __restrict__ k, const int64_t* __restrict__ s,
               const int64_t* __restrict__ e, int64_t n, int tile,
               uint8_t* __restrict__ packed, int64_t* __restrict__ counts) {
    constexpr int W = 4 + BPOS;
    // [tile + 2 keys: the one before the tile first][tile * W bytes]; the
    // bytes start 16-aligned, as tile is a multiple of 16.
    extern __shared__ __align__(16) unsigned char pm_smem[];
    int64_t* sk = reinterpret_cast<int64_t*>(pm_smem);
    uint8_t* sb = pm_smem + 8 * (tile + 2);
    __shared__ int warp_esc[PM_WARPS];
    const int64_t tile0 = (int64_t)blockIdx.x * tile;
    const int rows = (int)min((int64_t)tile, n - tile0);
    for (int r = threadIdx.x; r < rows; r += PM_THREADS)
        sk[r + 1] = k[tile0 + r];
    if (threadIdx.x == 0) sk[0] = tile0 > 0 ? k[tile0 - 1] : 0;
    __syncthreads();
    int n_esc = 0;
    for (int r = threadIdx.x; r < rows; r += PM_THREADS) {
        const int64_t i = tile0 + r;
        const int64_t sv = s[i];
        bool esc;
        const uint64_t v = pm_row<BPOS>(sk[r + 1] - sk[r], sv, e[i] - sv,
                                        &esc);
        pm_put<BPOS>(sb + r * W, v);
        n_esc += esc;
    }
    n_esc = __reduce_add_sync(0xFFFFFFFFu, n_esc);
    if ((threadIdx.x & 31) == 0) warp_esc[threadIdx.x >> 5] = n_esc;
    __syncthreads();
    if (threadIdx.x == 0) {
        int64_t c = 0;
#pragma unroll
        for (int w = 0; w < PM_WARPS; ++w) c += warp_esc[w];
        counts[blockIdx.x] = c;
    }
    // The tile's bytes, 16 at a time, then the last partial chunk of the
    // final tile byte by byte; the tile starts 16-aligned in `packed`.
    const int nbytes = rows * W;
    uint8_t* out = packed + tile0 * W;
    const int n16 = nbytes >> 4;
    for (int c = threadIdx.x; c < n16; c += PM_THREADS)
        reinterpret_cast<int4*>(out)[c] = reinterpret_cast<const int4*>(sb)[c];
    for (int b = (n16 << 4) + threadIdx.x; b < nbytes; b += PM_THREADS)
        out[b] = sb[b];
}

__global__ void __launch_bounds__(PM_THREADS)
pm_escapes_kernel(const int64_t* __restrict__ k,
                  const int64_t* __restrict__ s,
                  const int64_t* __restrict__ e, int64_t n, int tile,
                  const int64_t* __restrict__ counts,
                  const int64_t* __restrict__ incl,
                  int64_t* __restrict__ esc_idx, int64_t* __restrict__ esc_key,
                  int64_t* __restrict__ esc_end) {
    const int64_t cnt = counts[blockIdx.x];
    if (cnt == 0) return;
    __shared__ int warp_n[PM_WARPS];
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int64_t tile0 = (int64_t)blockIdx.x * tile;
    const int rows = (int)min((int64_t)tile, n - tile0);
    int64_t out = incl[blockIdx.x] - cnt;
    for (int r0 = 0; r0 < rows; r0 += PM_THREADS) {
        const int r = r0 + threadIdx.x;
        const int64_t i = tile0 + r;
        bool esc = false;
        if (r < rows) {
            const int64_t dk = k[i] - (i > 0 ? k[i - 1] : 0);
            esc = dk > 0xFFFF || e[i] - s[i] > 0xFFFF;
        }
        const unsigned m = __ballot_sync(0xFFFFFFFFu, esc);
        if (lane == 0) warp_n[w] = __popc(m);
        __syncthreads();
        int before = 0, pass = 0;
#pragma unroll
        for (int j = 0; j < PM_WARPS; ++j) {
            before += j < w ? warp_n[j] : 0;
            pass += warp_n[j];
        }
        if (esc) {
            const int64_t o = out + before + __popc(m & ((1u << lane) - 1));
            esc_idx[o] = i;
            esc_key[o] = k[i];
            esc_end[o] = e[i];
        }
        out += pass;
        __syncthreads();
    }
}

// The packed rows, each tile's escape count (counts[0, n_tiles)) and their
// inclusive offsets (counts[n_tiles, 2 n_tiles)).
extern "C" int ct_pack_merged(const void* k, const void* s, const void* e,
                              int64_t n, int b_pos, int tile, void* packed,
                              void* counts, void* stream) {
    if (n <= 0) return (int)cudaGetLastError();
    const int64_t n_tiles = (n + tile - 1) / tile;
    const size_t smem = (size_t)8 * (tile + 2) + (size_t)(4 + b_pos) * tile;
    const cudaStream_t st = ct_stream(stream);
    const int64_t* kk = (const int64_t*)k;
    const int64_t* ss = (const int64_t*)s;
    const int64_t* ee = (const int64_t*)e;
    uint8_t* out = (uint8_t*)packed;
    int64_t* c = (int64_t*)counts;
    const unsigned grid = (unsigned)n_tiles;
    if (b_pos == 2)
        pm_rows_kernel<2><<<grid, PM_THREADS, smem, st>>>(kk, ss, ee, n, tile,
                                                          out, c);
    else if (b_pos == 3)
        pm_rows_kernel<3><<<grid, PM_THREADS, smem, st>>>(kk, ss, ee, n, tile,
                                                          out, c);
    else
        pm_rows_kernel<4><<<grid, PM_THREADS, smem, st>>>(kk, ss, ee, n, tile,
                                                          out, c);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    return (int)ct_scan(c, n_tiles, c + n_tiles, st);
}

extern "C" int ct_pack_escapes(const void* k, const void* s, const void* e,
                               int64_t n, int tile, const void* counts,
                               void* esc_idx, void* esc_key, void* esc_end,
                               void* stream) {
    if (n > 0) {
        const int64_t n_tiles = (n + tile - 1) / tile;
        pm_escapes_kernel<<<(unsigned)n_tiles, PM_THREADS, 0,
                            ct_stream(stream)>>>(
            (const int64_t*)k, (const int64_t*)s, (const int64_t*)e, n, tile,
            (const int64_t*)counts, (const int64_t*)counts + n_tiles,
            (int64_t*)esc_idx, (int64_t*)esc_key, (int64_t*)esc_end);
    }
    return (int)cudaGetLastError();
}
