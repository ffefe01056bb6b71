// K13 greedy_v1: greedy set-cover steps over an instance given by
// segment ids, regrouped set-major once a solve.
//
// Replaces catch_tpu/ops/set_cover.py _steps_jit (:630-658) and its step
// _greedy_core (:292-347) and, driven until the stop flag with the pick
// order kept on the device, the while-loop solver _solve_jit_padded
// (:917-945, _greedy_step :350-364).  The instance names each interval's
// pair and each pair's set and universe in any order; pair ids never
// leave a step, so ops/set_cover.py set_major_index renumbers the pairs
// in set order and groups the intervals by the new pair ids
// (pair_bounds, set_bounds) once a solve, with two indexes of
// K13_TILE-position tiles: the intervals that meet each tile (tile_ptr,
// tile_ivl) and, for each set, the tiles its intervals meet, each with
// the set's intervals there (set_grp, grp_tile, grp_off, grp_ivl).  Set
// ids stay the instance's.  As in K12 (greedy_v2.cu), each pair's
// uncovered count pair_new, catch_tpu's segment sum over the pair's
// intervals of their uncovered positions, stays on the card through a
// call.  One call runs n_steps steps with no host synchronisation:
//   recompute, once a call (greedy.cuh's ct_recompute_pair_new, 4
//      launches): the uncovered prefix, then a thread a pair;
//   then each step, 3 launches:
//   1. score: greedy.cuh's ct_group_score_kernel, a group of lanes a set;
//   2. decide: ct_decide_kernel (greedy.cuh), which also appends a pick
//      to `order` when the caller keeps the order on the device;
//   3. update, nothing unless the step picked: a block per tile that the
//      chosen set meets.  Its threads, one a position, OR the set's
//      intervals in that tile, so a position that several chosen
//      intervals hold counts once, and mark the positions still
//      uncovered; the block takes their prefix in shared memory and
//      covers them.  Through the tile's intervals (16-byte records of
//      start, end, pair and universe) it subtracts from pair_new of each
//      interval's pair the count of those positions inside the interval,
//      and, where the pair is one of the chosen set's, the same count
//      from its universe's len_u.
// The update is exact for any intervals, overlapping ones included.
// After it every position of the chosen set's intervals is covered, so
// each chosen pair's pair_new falls to 0: the counts taken off len_u sum
// to the chosen pairs' pair_new as it stood before the update, which is
// what catch_tpu subtracts.  Integer atomics give the same sums in any
// order, so the steps equal catch_tpu's and the plain twin's exactly.
// Steps after the stop change nothing but cur_rank: the decide step
// never reads the incoming stop.
//
// Bound on the card: device-memory bandwidth.  The recompute moves the
// old step's bytes once a call; a step reads pair_new and univ_of_pair
// (8 bytes a pair) and the set arrays once, and the update only the
// chosen set's tiles.  Launch gaps (3 a step) are the floor at small
// sizes.
#include "greedy.cuh"

#define K13_TILE 256   // positions a tile: ops/set_cover.py _K12_TILE

namespace {

// Launched with max_groups blocks of K13_TILE threads; block b takes the
// chosen set's tile group b, if it has that many.
// ivl_rec[i] = (start, end, pair, universe) of interval i.
__global__ void k13_update_kernel(const int* __restrict__ dec,
                                  const int* __restrict__ set_bounds,
                                  const int* __restrict__ set_grp,
                                  const int* __restrict__ grp_tile,
                                  const int* __restrict__ grp_off,
                                  const int* __restrict__ grp_ivl,
                                  const int4* __restrict__ ivl_rec,
                                  const int* __restrict__ tile_ptr,
                                  const int* __restrict__ tile_ivl,
                                  int* __restrict__ pair_new,
                                  int* __restrict__ len_u,
                                  bool* __restrict__ covered) {
    __shared__ int fresh_before[K13_TILE + 1];
    if (!dec[1]) return;
    const int c = dec[0];
    const int g = set_grp[c] + blockIdx.x;
    if (g >= set_grp[c + 1]) return;
    const int t = grp_tile[g];
    const int64_t t0 = (int64_t)t * K13_TILE, t1 = t0 + K13_TILE;
    const int64_t x = t0 + threadIdx.x;
    bool chosen = false;
    for (int k = grp_off[g]; k < grp_off[g + 1]; ++k) {
        const int4 r = ivl_rec[grp_ivl[k]];
        chosen |= r.x <= x && x < r.y;
    }
    // a chosen position lies inside an interval, so before U
    const int fresh = chosen && !covered[x];
    int total;
    fresh_before[threadIdx.x] = ct_block_excl_scan(fresh, &total);
    if (threadIdx.x == 0) fresh_before[K13_TILE] = total;
    __syncthreads();
    if (total == 0) return;
    // each thread covers only the position it read
    if (fresh) covered[x] = true;
    const int p0 = set_bounds[c], p1 = set_bounds[c + 1];
    for (int k = tile_ptr[t] + threadIdx.x; k < tile_ptr[t + 1];
         k += blockDim.x) {
        const int4 r = ivl_rec[tile_ivl[k]];
        const int64_t a = r.x > t0 ? r.x : t0, b = r.y < t1 ? r.y : t1;
        if (a < b) {
            const int n = fresh_before[b - t0] - fresh_before[a - t0];
            if (n) {
                atomicSub(&pair_new[r.z], n);
                if (r.z >= p0 && r.z < p1) atomicSub(&len_u[r.w], n);
            }
        }
    }
}

}  // namespace

// `stages` selects the launches (greedy.cuh's CT_* bits): all of them
// for a call of n_steps steps from step0; one at a time for a split
// timed by events between calls.  ivl_start, ivl_end, pair_bounds,
// set_bounds, univ_of_pair and the index arrays are set_major_index's;
// lg: log2 of the lanes a set; nb: its score blocks; max_groups: the
// most tiles a set meets.  order and n_chosen may be null.
extern "C" int ct_greedy_v1_steps(
        void* covered, int64_t U, void* len_u, const void* can_uncover,
        int64_t nU, void* in_cover, const void* cost, const void* rank_idx,
        int64_t S, const void* ivl_start, const void* ivl_end,
        const void* pair_bounds, const void* set_bounds,
        const void* univ_of_pair, int64_t P, int n_rank_vals,
        const void* ivl_rec, const void* tile_ptr, const void* tile_ivl,
        const void* set_grp, const void* grp_tile, const void* grp_off,
        const void* grp_ivl, int lg, int64_t nb, int max_groups,
        void* cur_rank, void* stop, void* chosens, void* picks, void* order,
        void* n_chosen, void* prefix, void* tiles, void* pair_new,
        void* blk_r, void* blk_i, void* blk_any, void* dec, int step0,
        int n_steps, int stages, void* stream) {
    cudaStream_t st = ct_stream(stream);
    if (stages & CT_RECOMPUTE) {
        ct_recompute_pair_new(covered, U, prefix, tiles, ivl_start, ivl_end,
                              pair_bounds, P, pair_new, st);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    const unsigned n_upd = max_groups > 0 ? max_groups : 1;
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
                step, (int*)order, (int*)n_chosen);
        if (stages & CT_UPDATE)
            k13_update_kernel<<<n_upd, K13_TILE, 0, st>>>(
                (const int*)dec, (const int*)set_bounds,
                (const int*)set_grp, (const int*)grp_tile,
                (const int*)grp_off, (const int*)grp_ivl,
                (const int4*)ivl_rec, (const int*)tile_ptr,
                (const int*)tile_ivl, (int*)pair_new, (int*)len_u,
                (bool*)covered);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    return (int)cudaGetLastError();
}
