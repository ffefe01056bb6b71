// K12 greedy_v2: greedy set-cover steps over a boundary-indexed instance.
//
// Replaces catch_tpu/ops/set_cover.py _steps_jit_v2 (:836-859) and its
// step _greedy_core_v2 (:765-833).  Intervals are grouped by pair
// (pair_bounds) and pairs by set (set_bounds).  catch_tpu recomputes
// every pair's uncovered count from a prefix over all U positions in
// every step; a pick changes coverage only inside the chosen set's
// intervals, so here each pair's count (pair_new) stays on the card for
// the whole call and changes only where the chosen set covers new
// positions.  One call runs n_steps steps with no host synchronisation:
//   recompute, once a call (4 launches): the uncovered prefix,
//      prefix[i + 1] = positions not covered in [0, i] (the three-pass
//      scan of greedy.cuh, which also writes prefix[0]), then one thread
//      per pair sums prefix[end] - prefix[start] over its intervals
//      (greedy.cuh's ct_recompute_pair_new);
//   then each step, 3 launches:
//   1. score (greedy.cuh's ct_group_score_kernel): a group of G lanes
//      per set (G a power of two up to 32, from the largest pair count
//      of a set) reads the set's pair_new and univ_of_pair coalesced
//      (none for a set in the cover or outside the rank tier), caps
//      each pair by its universe's need max(len_u - can_uncover, 0)
//      and reduces by shuffles; lane 0 applies eligibility and the
//      float32 ratio, and each block keeps its first (ratio, set id)
//      minimum (ct_set_candidates);
//   2. decide: ct_decide_kernel (greedy.cuh);
//   3. update, nothing unless the step picked: a block per piece of the
//      chosen set, a piece being one interval cut to one tile of
//      K12_TILE positions (a 32-way warp search finds its interval).
//      The block marks the piece's positions still uncovered and takes
//      their prefix in shared memory; through the overlap index (the
//      intervals that meet each tile, each read as one 16-byte record
//      of start, end, pair and universe) it subtracts from pair_new of
//      every interval's pair the count of those positions inside the
//      interval, takes the piece's count off its universe's len_u, and
//      covers the piece.
// The update is exact because a set's intervals are pairwise disjoint:
// a set has one pair per universe, universes own disjoint ranges of the
// axis, and a pair's intervals are merged (stage D, _merge_by_group).
// So the pieces are disjoint, a newly covered position is counted once
// for each interval holding it, and len_u[u] falls by exactly the
// chosen pair's pair_new, as in catch_tpu.  Steps after the stop change
// nothing but cur_rank: the decide step never reads the incoming stop.
//
// Bound on the card: device-memory bandwidth.  The recompute moves the
// old step's bytes once a call; a step reads pair_new and univ_of_pair
// (8 bytes a pair) and the set arrays once, and the update only the
// chosen set's tiles.  Launch gaps (3 a step) are the floor at small
// sizes.
#include "greedy.cuh"

#define K12_TILE 256           // positions a tile of the overlap index

namespace {

// Launched with max_pieces blocks of K12_TILE threads; block b takes
// piece b of the chosen set, if it has that many.
// ivl_rec[i] = (start, end, pair, universe) of interval i: a tile
// entry costs one 16-byte gather.
__global__ void k12_update_kernel(const int* __restrict__ dec,
                                  const int* __restrict__ set_bounds,
                                  const int* __restrict__ pair_bounds,
                                  const int* __restrict__ piece_off,
                                  const int4* __restrict__ ivl_rec,
                                  const int* __restrict__ tile_ptr,
                                  const int* __restrict__ tile_ivl,
                                  int* __restrict__ pair_new,
                                  int* __restrict__ len_u,
                                  bool* __restrict__ covered) {
    __shared__ int fresh_before[K12_TILE + 1];
    if (!dec[1]) return;
    const int c = dec[0];
    const int i0 = pair_bounds[set_bounds[c]];
    const int i1 = pair_bounds[set_bounds[c + 1]];
    const int g = piece_off[i0] + blockIdx.x;
    if (g >= piece_off[i1]) return;
    // The last interval of the set whose pieces start at or before g (it
    // has a piece: the next interval's pieces start after g), by a
    // 32-way search in every warp: a round narrows [lo, lo + n) to the
    // stride of the last lane whose candidate starts at or before g.
    const int lane = threadIdx.x & 31;
    int lo = i0, n = i1 - i0;
    while (n > 1) {
        const int stride = (n + 31) >> 5;
        const int i = lo + lane * stride;
        const unsigned ok = __ballot_sync(
            CT_FULL_MASK, lane * stride < n && piece_off[i] <= g);
        const int last = 31 - __clz(ok);     // lane 0's candidate is lo
        lo += last * stride;
        n = min(stride, n - last * stride);
    }
    const int4 piece = ivl_rec[lo];
    const int64_t t = piece.x / K12_TILE + (g - piece_off[lo]);
    const int64_t t0 = t * K12_TILE, t1 = t0 + K12_TILE;
    const int r0 = piece.x > t0 ? piece.x : (int)t0;
    const int r1 = piece.y < t1 ? piece.y : (int)t1;
    const int64_t x = (int64_t)r0 + threadIdx.x;
    const int fresh = x < r1 && !covered[x];
    int total;
    fresh_before[threadIdx.x] = ct_block_excl_scan(fresh, &total);
    if (threadIdx.x == 0) fresh_before[K12_TILE] = total;
    __syncthreads();
    if (total == 0) return;
    // each thread covers only the position it read
    if (fresh) covered[x] = true;
    if (threadIdx.x == 0) atomicSub(&len_u[piece.w], total);
    for (int k = tile_ptr[t] + threadIdx.x; k < tile_ptr[t + 1];
         k += blockDim.x) {
        const int4 r = ivl_rec[tile_ivl[k]];
        const int a = max(r.x, r0), b = min(r.y, r1);
        if (a < b) {
            const int n = fresh_before[b - r0] - fresh_before[a - r0];
            if (n) atomicSub(&pair_new[r.z], n);
        }
    }
}

// The overlap index's tile lists (set_cover.overlap_index on the card):
// a thread per interval counts its pieces into their tiles, then, after
// the counts' exclusive scan into tile_ptr, writes its id at each
// tile's cursor.  The order within a tile is the atomics'.
__global__ void k12_tile_count_kernel(const int* __restrict__ ivl_start,
                                      const int* __restrict__ ivl_end,
                                      int64_t M, int* __restrict__ count) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= M || ivl_end[i] <= ivl_start[i]) return;
    for (int t = ivl_start[i] / K12_TILE; t <= (ivl_end[i] - 1) / K12_TILE;
         ++t)
        atomicAdd(&count[t], 1);
}

__global__ void k12_tile_fill_kernel(const int* __restrict__ ivl_start,
                                     const int* __restrict__ ivl_end,
                                     int64_t M, int* __restrict__ cursor,
                                     int* __restrict__ tile_ivl) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= M || ivl_end[i] <= ivl_start[i]) return;
    for (int t = ivl_start[i] / K12_TILE; t <= (ivl_end[i] - 1) / K12_TILE;
         ++t)
        tile_ivl[atomicAdd(&cursor[t], 1)] = (int)i;
}

struct IntLoad {
    const int* x;
    __device__ int operator()(int64_t i) const { return x[i]; }
};

}  // namespace

// tile_ptr (n_tiles + 1 ints) and tile_ivl (as many ints as pieces) of
// the overlap index; count: n_tiles ints, scan_tiles: the scan's tile
// sums (ceil(n_tiles / CT_SCAN_TILE) ints).
extern "C" int ct_k12_index(const void* ivl_start, const void* ivl_end,
                            int64_t M, int64_t n_tiles, void* count,
                            void* scan_tiles, void* tile_ptr,
                            void* tile_ivl, void* stream) {
    cudaStream_t st = ct_stream(stream);
    if (n_tiles <= 0 || M <= 0) {
        cudaMemsetAsync(tile_ptr, 0, (n_tiles + 1) * sizeof(int), st);
        return (int)cudaGetLastError();
    }
    cudaMemsetAsync(count, 0, n_tiles * sizeof(int), st);
    k12_tile_count_kernel<<<ct_blocks(M, 256), 256, 0, st>>>(
        (const int*)ivl_start, (const int*)ivl_end, M, (int*)count);
    ct_scan(IntLoad{(const int*)count}, PrefixFromZero{(int*)tile_ptr},
            n_tiles, (int*)scan_tiles, st);
    cudaMemcpyAsync(count, tile_ptr, n_tiles * sizeof(int),
                    cudaMemcpyDeviceToDevice, st);
    k12_tile_fill_kernel<<<ct_blocks(M, 256), 256, 0, st>>>(
        (const int*)ivl_start, (const int*)ivl_end, M, (int*)count,
        (int*)tile_ivl);
    return (int)cudaGetLastError();
}

// `stages` selects the launches (greedy.cuh's CT_* bits): all of them
// for a call of n_steps steps from step0; one at a time for a split
// timed by events between calls.  lg: log2 of the lanes a set; nb:
// its score blocks.
extern "C" int ct_greedy_v2_steps(
        void* covered, int64_t U, void* len_u, const void* can_uncover,
        int64_t nU, void* in_cover, const void* cost, const void* rank_idx,
        int64_t S, const void* ivl_start, const void* ivl_end,
        const void* pair_bounds, const void* set_bounds,
        const void* univ_of_pair, int64_t P, int n_rank_vals,
        const void* ivl_rec, const void* piece_off, const void* tile_ptr,
        const void* tile_ivl, int lg, int64_t nb, int max_pieces,
        void* cur_rank, void* stop, void* chosens, void* picks, void* prefix,
        void* tiles, void* pair_new, void* blk_r, void* blk_i,
        void* blk_any, void* dec, int step0, int n_steps, int stages,
        void* stream) {
    cudaStream_t st = ct_stream(stream);
    if (stages & CT_RECOMPUTE) {
        ct_recompute_pair_new(covered, U, prefix, tiles, ivl_start, ivl_end,
                              pair_bounds, P, pair_new, st);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    const unsigned n_upd = max_pieces > 0 ? max_pieces : 1;
    for (int step = step0; step < step0 + n_steps; ++step) {
        if ((stages & CT_SCORE) && S > 0)
            ct_group_score_kernel<<<(unsigned)nb, CT_GROUP_THREADS, 0, st>>>(
                (const int*)pair_new, (const int*)univ_of_pair,
                (const int*)set_bounds, S, lg, (const int*)len_u,
                (const int*)can_uncover, (const bool*)in_cover,
                (const int*)rank_idx, (const int*)cur_rank,
                (const float*)cost, (float*)blk_r, (int*)blk_i,
                (int*)blk_any);
        if (stages & CT_DECIDE)
            ct_decide_kernel<<<1, CT_DECIDE_THREADS, 0, st>>>(
                (const float*)blk_r, (const int*)blk_i, (const int*)blk_any,
                S > 0 ? nb : 0, (const int*)len_u, (const int*)can_uncover,
                nU, n_rank_vals, (int*)cur_rank, (bool*)stop,
                (bool*)in_cover, (int*)dec, (int*)chosens, (bool*)picks,
                step, nullptr, nullptr);
        if (stages & CT_UPDATE)
            k12_update_kernel<<<n_upd, K12_TILE, 0, st>>>(
                (const int*)dec, (const int*)set_bounds,
                (const int*)pair_bounds, (const int*)piece_off,
                (const int4*)ivl_rec, (const int*)tile_ptr,
                (const int*)tile_ivl, (int*)pair_new,
                (int*)len_u, (bool*)covered);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    return (int)cudaGetLastError();
}
