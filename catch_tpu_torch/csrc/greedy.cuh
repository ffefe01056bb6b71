// Shared pieces of the set-cover kernels (greedy_v2.cu, greedy_v1.cu, see
// catch_tpu_torch/ops/set_cover.py; greedy_sharded.cu, see
// catch_tpu_torch/parallel/set_cover.py):
//   - an int32 prefix scan over the position axis in three passes (tile
//     sums, one block scanning the tile sums, tile writes), with the
//     item loaded and the inclusive prefix stored through functors, for
//     one row or, with the row on blockIdx.y, several rows at once;
//   - a greedy step's per-set candidate: eligibility and the float32
//     ratio, and the block minimum of (ratio, set id);
//   - the one-block decide step that ends every greedy step;
//   - for the incremental steps, whose intervals are grouped by pair
//     (pair_bounds) and pairs by set (set_bounds): each pair's uncovered
//     count from the prefix, once a call, the score pass of a group of
//     lanes a set, and the bits of their `stages` argument.
// The decide step, the pair count and the score pass are device
// functions too, so that greedy_sharded.cu runs them for each place of
// a table.  Everything is in an anonymous namespace: each source that
// includes this header gets its own copy of the kernels.
#pragma once

#include <climits>
#include <cmath>

#include "common.cuh"

#define CT_SCAN_THREADS 256
#define CT_SCAN_ITEMS 16
#define CT_SCAN_TILE (CT_SCAN_THREADS * CT_SCAN_ITEMS)  // 4096 items a tile
#define CT_FULL_MASK 0xFFFFFFFFu
#define CT_DECIDE_THREADS 1024
#define CT_GROUP_THREADS 256   // threads of a ct_group_score_kernel block
#define CT_RECOMPUTE 1         // `stages` bits of the incremental steps
#define CT_SCORE 2
#define CT_DECIDE 4
#define CT_UPDATE 8

namespace {

// Exclusive scan of one int per thread over the block (blockDim.x a
// multiple of 32); *total gets the block's sum.  Every thread must call.
__device__ __forceinline__ int ct_block_excl_scan(int x, int* total) {
    __shared__ int warp_sums[32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    int v = x;
    for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(CT_FULL_MASK, v, d);
        if (lane >= d) v += y;
    }
    if (lane == 31) warp_sums[warp] = v;
    __syncthreads();
    if (warp == 0) {
        int w = lane < nwarps ? warp_sums[lane] : 0;
        for (int d = 1; d < 32; d <<= 1) {
            const int y = __shfl_up_sync(CT_FULL_MASK, w, d);
            if (lane >= d) w += y;
        }
        warp_sums[lane] = w;
    }
    __syncthreads();
    const int before = warp > 0 ? warp_sums[warp - 1] : 0;
    *total = warp_sums[nwarps - 1];
    __syncthreads();   // warp_sums is reused by the next call
    return before + v - x;
}

// Pass 1: the sum of each tile of CT_SCAN_TILE items.  Row blockIdx.y
// keeps its gridDim.x tile sums at sums + blockIdx.y * gridDim.x.
template <class Load>
__global__ void ct_scan_tile_sums(Load load, int64_t n,
                                  int* __restrict__ sums) {
    const int64_t base = (int64_t)blockIdx.x * CT_SCAN_TILE
                         + (int64_t)threadIdx.x * CT_SCAN_ITEMS;
    int s = 0;
    for (int j = 0; j < CT_SCAN_ITEMS; ++j)
        if (base + j < n) s += load(base + j);
    int total;
    ct_block_excl_scan(s, &total);
    if (threadIdx.x == 0)
        sums[(int64_t)blockIdx.y * gridDim.x + blockIdx.x] = total;
}

// Pass 2: one block a row turns the row's tile sums into exclusive tile
// offsets, in place.
__global__ void ct_scan_carry(int* __restrict__ sums, int64_t nt) {
    sums += blockIdx.x * nt;
    int run = 0;
    for (int64_t c0 = 0; c0 < nt; c0 += blockDim.x) {
        const int64_t t = c0 + threadIdx.x;
        const int x = t < nt ? sums[t] : 0;
        int total;
        const int ex = ct_block_excl_scan(x, &total);
        if (t < nt) sums[t] = run + ex;
        run += total;
    }
}

// Pass 3: each item's inclusive prefix, handed to store(i, prefix).
template <class Load, class Store>
__global__ void ct_scan_write(Load load, Store store, int64_t n,
                              const int* __restrict__ offs) {
    const int64_t base = (int64_t)blockIdx.x * CT_SCAN_TILE
                         + (int64_t)threadIdx.x * CT_SCAN_ITEMS;
    int v[CT_SCAN_ITEMS];
    int s = 0;
    for (int j = 0; j < CT_SCAN_ITEMS; ++j) {
        v[j] = base + j < n ? load(base + j) : 0;
        s += v[j];
    }
    int total;
    int run = offs[(int64_t)blockIdx.y * gridDim.x + blockIdx.x]
              + ct_block_excl_scan(s, &total);
    for (int j = 0; j < CT_SCAN_ITEMS; ++j) {
        run += v[j];
        if (base + j < n) store(base + j, run);
    }
}

// Inclusive scans of load(0..n) into store, one a row: the functors
// read the row from blockIdx.y.  `tiles` holds rows * ceil(n /
// CT_SCAN_TILE) ints.
template <class Load, class Store>
void ct_scan_rows(Load load, Store store, int64_t n, int rows, int* tiles,
                  cudaStream_t st) {
    if (n <= 0 || rows <= 0) return;
    const int64_t nt = (n + CT_SCAN_TILE - 1) / CT_SCAN_TILE;
    const dim3 grid((unsigned)nt, rows);
    ct_scan_tile_sums<<<grid, CT_SCAN_THREADS, 0, st>>>(load, n, tiles);
    ct_scan_carry<<<rows, 1024, 0, st>>>(tiles, nt);
    ct_scan_write<<<grid, CT_SCAN_THREADS, 0, st>>>(load, store, n, tiles);
}

// The scan of one row; `tiles` holds ceil(n / CT_SCAN_TILE) ints.
template <class Load, class Store>
void ct_scan(Load load, Store store, int64_t n, int* tiles,
             cudaStream_t st) {
    ct_scan_rows(load, store, n, 1, tiles, st);
}

// The uncovered indicator.
struct UncoveredLoad {
    const bool* covered;
    __device__ int operator()(int64_t i) const { return covered[i] ? 0 : 1; }
};

// (ratio, set id) a is better than b: a smaller ratio, or the same ratio
// and a lower id (the first argmin, as jnp.argmin and torch.argmin).
__device__ __forceinline__ bool ct_better(float ra, int ia, float rb,
                                          int ib) {
    return ra < rb || (ra == rb && ia < ib);
}

// Block minimum of (r, i); every thread gets it back.
__device__ __forceinline__ void ct_block_min(float& r, int& i) {
    __shared__ float sr[32];
    __shared__ int si[32];
    for (int d = 16; d >= 1; d >>= 1) {
        const float r2 = __shfl_down_sync(CT_FULL_MASK, r, d);
        const int i2 = __shfl_down_sync(CT_FULL_MASK, i, d);
        if (ct_better(r2, i2, r, i)) { r = r2; i = i2; }
    }
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    if (lane == 0) { sr[warp] = r; si[warp] = i; }
    __syncthreads();
    if (warp == 0) {
        r = lane < nwarps ? sr[lane] : INFINITY;
        i = lane < nwarps ? si[lane] : INT_MAX;
        for (int d = 16; d >= 1; d >>= 1) {
            const float r2 = __shfl_down_sync(CT_FULL_MASK, r, d);
            const int i2 = __shfl_down_sync(CT_FULL_MASK, i, d);
            if (ct_better(r2, i2, r, i)) { r = r2; i = i2; }
        }
        if (lane == 0) { sr[0] = r; si[0] = i; }
    }
    __syncthreads();
    r = sr[0];
    i = si[0];
    __syncthreads();
}

// Set s with capped score sc: eligible when not in the cover, in the
// current rank tier and with a positive score; its ratio is
// cost / float32(score) by IEEE division (never a reciprocal product: the
// last bit decides ties), +inf when not eligible.  Threads past the last
// set pass s = -1 and take part in the block minimum with (+inf,
// INT_MAX).  Thread 0 writes the block's (ratio, id, any eligible); the
// id is s + id_base (the first set id of a shard's arrays).
__device__ __forceinline__ void ct_set_candidates(
        int64_t s, int sc, const bool* __restrict__ in_cover,
        const int* __restrict__ rank_idx, int cur_rank,
        const float* __restrict__ cost, float* __restrict__ blk_r,
        int* __restrict__ blk_i, int* __restrict__ blk_any,
        int id_base = 0) {
    float r = INFINITY;
    int i = INT_MAX;
    int elig = 0;
    if (s >= 0) {
        i = (int)s + id_base;
        elig = !in_cover[s] && rank_idx[s] == cur_rank && sc > 0;
        if (elig) r = __fdiv_rn(cost[s], __int2float_rn(sc));
    }
    const int any = __syncthreads_or(elig);
    ct_block_min(r, i);
    if (threadIdx.x == 0) {
        blk_r[blockIdx.x] = r;
        blk_i[blockIdx.x] = i;
        blk_any[blockIdx.x] = any;
    }
}

// The first (ratio, id) minimum over nb blocks' candidates into (r, i),
// for every thread of the block; returns whether any block had an
// eligible set.  Every thread must call.
__device__ __forceinline__ int ct_min_of_blocks(
        const float* __restrict__ blk_r, const int* __restrict__ blk_i,
        const int* __restrict__ blk_any, int64_t nb, float& r, int& i) {
    r = INFINITY;
    i = INT_MAX;
    int any = 0;
    for (int64_t b = threadIdx.x; b < nb; b += blockDim.x) {
        if (ct_better(blk_r[b], blk_i[b], r, i)) { r = blk_r[b]; i = blk_i[b]; }
        any |= blk_any[b];
    }
    any = __syncthreads_or(any);
    ct_block_min(r, i);
    return any;
}

// The decide step (one block of CT_DECIDE_THREADS): the global first
// argmin over the set blocks, active = any universe still needs
// positions, then pick, rank advance, stop and the chosen set's
// in_cover flag (in_cover may be null: the sharded solver's owner sets
// its own), as catch_tpu's _greedy_core/_greedy_core_v2.  With no
// eligible set the chosen id is the first argmin of all +inf, set 0.
// dec[0..1] = (chosen, pick) for the update kernel; the step's chosen
// and pick also go to chosens/picks[step] and, for the device-resident
// solver, order[n_chosen++] (either pointer may be null).
__device__ __forceinline__ void ct_decide(
        const float* __restrict__ blk_r, const int* __restrict__ blk_i,
        const int* __restrict__ blk_any, int64_t nb,
        const int* __restrict__ len_u, const int* __restrict__ can_uncover,
        int64_t nU, int n_rank_vals, int* cur_rank, bool* stop,
        bool* in_cover, int* dec, int* chosens, bool* picks, int step,
        int* order, int* n_chosen) {
    float r;
    int i;
    const int any = ct_min_of_blocks(blk_r, blk_i, blk_any, nb, r, i);
    int act = 0;
    for (int64_t u = threadIdx.x; u < nU; u += blockDim.x)
        act |= len_u[u] - can_uncover[u] > 0;
    act = __syncthreads_or(act);
    if (threadIdx.x != 0) return;
    const int chosen = nb > 0 ? i : 0;
    const bool pick = act && any;
    const bool adv = act && !any;
    const int cr = *cur_rank;
    *stop = !act || (adv && cr + 1 >= n_rank_vals);
    *cur_rank = cr + (adv ? 1 : 0);
    if (pick && in_cover) in_cover[chosen] = true;
    dec[0] = chosen;
    dec[1] = pick ? 1 : 0;
    if (chosens) {
        chosens[step] = chosen;
        picks[step] = pick;
    }
    if (order && pick) {
        order[*n_chosen] = chosen;
        *n_chosen += 1;
    }
}

__global__ void ct_decide_kernel(
        const float* __restrict__ blk_r, const int* __restrict__ blk_i,
        const int* __restrict__ blk_any, int64_t nb,
        const int* __restrict__ len_u, const int* __restrict__ can_uncover,
        int64_t nU, int n_rank_vals, int* cur_rank, bool* stop,
        bool* in_cover, int* dec, int* chosens, bool* picks, int step,
        int* order, int* n_chosen) {
    ct_decide(blk_r, blk_i, blk_any, nb, len_u, can_uncover, nU,
              n_rank_vals, cur_rank, stop, in_cover, dec, chosens, picks,
              step, order, n_chosen);
}

// The inclusive prefix of the scan into prefix[i + 1]; the first item
// also writes prefix[0] = 0.
struct PrefixFromZero {
    int* prefix;
    __device__ void operator()(int64_t i, int v) const {
        if (i == 0) prefix[0] = 0;
        prefix[i + 1] = v;
    }
};

// Thread p of the grid's x axis: pair_new[p] = the sum of prefix[end] -
// prefix[start] over the pair's intervals.
__device__ __forceinline__ void ct_pair_new(
        const int* __restrict__ prefix, const int* __restrict__ ivl_start,
        const int* __restrict__ ivl_end, const int* __restrict__ pair_bounds,
        int64_t P, int* __restrict__ pair_new) {
    const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= P) return;
    int s = 0;
    for (int i = pair_bounds[p]; i < pair_bounds[p + 1]; ++i)
        s += prefix[ivl_end[i]] - prefix[ivl_start[i]];
    pair_new[p] = s;
}

__global__ void ct_pair_new_kernel(const int* __restrict__ prefix,
                                   const int* __restrict__ ivl_start,
                                   const int* __restrict__ ivl_end,
                                   const int* __restrict__ pair_bounds,
                                   int64_t P, int* __restrict__ pair_new) {
    ct_pair_new(prefix, ivl_start, ivl_end, pair_bounds, P, pair_new);
}

// A group of G = 2^lg lanes per set reads the set's pair_new and
// univ_of_pair coalesced (none for a set in the cover or outside the rank
// tier), caps each pair by its universe's need max(len_u - can_uncover,
// 0) and reduces by shuffles; lane 0 takes the set's candidate
// (ct_set_candidates, whose id is the set's index + id_base).  Blocks of
// CT_GROUP_THREADS threads along the grid's x axis.
__device__ __forceinline__ void ct_group_score(
        const int* __restrict__ pair_new, const int* __restrict__ univ_of_pair,
        const int* __restrict__ set_bounds, int64_t S, int lg,
        const int* __restrict__ len_u, const int* __restrict__ can_uncover,
        const bool* __restrict__ in_cover, const int* __restrict__ rank_idx,
        const int* __restrict__ cur_rank, const float* __restrict__ cost,
        float* __restrict__ blk_r, int* __restrict__ blk_i,
        int* __restrict__ blk_any, int id_base) {
    const int G = 1 << lg;
    const int lane = threadIdx.x & (G - 1);
    const int64_t s = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> lg;
    const int cr = *cur_rank;
    int p0 = 0, p1 = 0;
    if (s < S) {
        // loaded together: a set in the cover or outside the rank tier
        // is not eligible whatever its score, and its pairs are not read
        p0 = set_bounds[s];
        const int end = set_bounds[s + 1];
        p1 = !in_cover[s] & (rank_idx[s] == cr) ? end : p0;
    }
    int sc = 0;
    for (int p = p0 + lane; p < p1; p += G) {
        const int u = univ_of_pair[p];
        sc += min(pair_new[p], max(len_u[u] - can_uncover[u], 0));
    }
    for (int d = G >> 1; d >= 1; d >>= 1)
        sc += __shfl_xor_sync(CT_FULL_MASK, sc, d);
    ct_set_candidates(s < S && lane == 0 ? s : -1, sc, in_cover, rank_idx,
                      cr, cost, blk_r, blk_i, blk_any, id_base);
}

__global__ void ct_group_score_kernel(const int* __restrict__ pair_new,
                                      const int* __restrict__ univ_of_pair,
                                      const int* __restrict__ set_bounds,
                                      int64_t S, int lg,
                                      const int* __restrict__ len_u,
                                      const int* __restrict__ can_uncover,
                                      const bool* __restrict__ in_cover,
                                      const int* __restrict__ rank_idx,
                                      const int* __restrict__ cur_rank,
                                      const float* __restrict__ cost,
                                      float* __restrict__ blk_r,
                                      int* __restrict__ blk_i,
                                      int* __restrict__ blk_any) {
    ct_group_score(pair_new, univ_of_pair, set_bounds, S, lg, len_u,
                   can_uncover, in_cover, rank_idx, cur_rank, cost, blk_r,
                   blk_i, blk_any, 0);
}

// The recompute at the start of an incremental call (4 launches): the
// uncovered prefix, prefix[i + 1] = positions not covered in [0, i], and
// from it each pair's uncovered count.  prefix: U + 1 ints; tiles: the
// scan's tile sums.
inline void ct_recompute_pair_new(void* covered, int64_t U, void* prefix,
                                  void* tiles, const void* ivl_start,
                                  const void* ivl_end,
                                  const void* pair_bounds, int64_t P,
                                  void* pair_new, cudaStream_t st) {
    ct_scan(UncoveredLoad{(const bool*)covered},
            PrefixFromZero{(int*)prefix}, U, (int*)tiles, st);
    if (U <= 0) cudaMemsetAsync(prefix, 0, sizeof(int), st);
    if (P > 0)
        ct_pair_new_kernel<<<ct_blocks(P, 256), 256, 0, st>>>(
            (const int*)prefix, (const int*)ivl_start, (const int*)ivl_end,
            (const int*)pair_bounds, P, (int*)pair_new);
}

}  // namespace
