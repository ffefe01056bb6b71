// K12 greedy_v2: greedy set-cover steps over a boundary-indexed instance.
//
// Replaces catch_tpu/ops/set_cover.py _steps_jit_v2 (:836-859) and its
// step _greedy_core_v2 (:765-833).  Intervals are grouped by pair
// (pair_bounds) and pairs by set (set_bounds), so each pair's and each
// set's sum is a loop over its own slice: no scatter.  One call runs
// n_steps steps with no host synchronisation; each step is a chain of
// launches on the caller's stream:
//   1. the uncovered prefix: prefix[i + 1] = positions not covered in
//      [0, i], by the three-pass scan of greedy.cuh;
//   2. pairs: one thread per pair sums prefix[end] - prefix[start] over
//      its intervals (pair_new) and caps it by its universe's need,
//      max(len_u - can_uncover, 0);
//   3. sets: one thread per set sums its capped pairs, applies
//      eligibility and the float32 ratio, and each block keeps its first
//      (ratio, set id) minimum;
//   4. decide: one block takes the global first argmin and sets pick,
//      the rank advance, stop, cur_rank and in_cover (greedy.cuh);
//   5. update: a block per interval of the chosen set (the launch is
//      sized by max_ivls_per_set) fills its range of `covered`, and block
//      0 takes each of the set's pairs' pair_new off its universe's
//      len_u.  The chosen set's intervals are few, so a direct fill is
//      the cheapest update.
// Steps after the stop change nothing but cur_rank, as in catch_tpu: the
// decide step never reads the incoming stop.
//
// Bound on the card: device-memory bandwidth.  A step reads `covered`,
// writes and gathers the prefix, and reads the interval, pair and set
// arrays once; the gathers into the prefix are random.  The launch
// overhead of the chain (8 launches a step) is the floor at small sizes;
// a CUDA graph or a persistent kernel is later work.
#include "greedy.cuh"

__global__ void v2_pair_kernel(const int* __restrict__ prefix,
                               const int* __restrict__ ivl_start,
                               const int* __restrict__ ivl_end,
                               const int* __restrict__ pair_bounds,
                               const int* __restrict__ univ_of_pair,
                               int64_t P, const int* __restrict__ len_u,
                               const int* __restrict__ can_uncover,
                               int* __restrict__ pair_new,
                               int* __restrict__ pair_capped) {
    const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= P) return;
    int s = 0;
    for (int i = pair_bounds[p]; i < pair_bounds[p + 1]; ++i)
        s += prefix[ivl_end[i]] - prefix[ivl_start[i]];
    const int u = univ_of_pair[p];
    const int need = max(len_u[u] - can_uncover[u], 0);
    pair_new[p] = s;
    pair_capped[p] = min(s, need);
}

__global__ void v2_set_kernel(const int* __restrict__ pair_capped,
                              const int* __restrict__ set_bounds, int64_t S,
                              const bool* __restrict__ in_cover,
                              const int* __restrict__ rank_idx,
                              const int* __restrict__ cur_rank,
                              const float* __restrict__ cost,
                              float* __restrict__ blk_r,
                              int* __restrict__ blk_i,
                              int* __restrict__ blk_any) {
    const int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    int sc = 0;
    if (s < S)
        for (int p = set_bounds[s]; p < set_bounds[s + 1]; ++p)
            sc += pair_capped[p];
    ct_set_candidates(s < S ? s : -1, sc, in_cover, rank_idx, *cur_rank,
                      cost, blk_r, blk_i, blk_any);
}

__global__ void v2_update_kernel(const int* __restrict__ dec,
                                 const int* __restrict__ set_bounds,
                                 const int* __restrict__ pair_bounds,
                                 const int* __restrict__ univ_of_pair,
                                 const int* __restrict__ pair_new,
                                 const int* __restrict__ ivl_start,
                                 const int* __restrict__ ivl_end,
                                 int* __restrict__ len_u,
                                 bool* __restrict__ covered) {
    if (!dec[1]) return;
    const int c = dec[0];
    const int p0 = set_bounds[c], p1 = set_bounds[c + 1];
    if (blockIdx.x == 0)
        for (int p = p0 + threadIdx.x; p < p1; p += blockDim.x)
            atomicSub(&len_u[univ_of_pair[p]], pair_new[p]);
    const int i = pair_bounds[p0] + blockIdx.x;
    if (i < pair_bounds[p1])
        for (int x = ivl_start[i] + threadIdx.x; x < ivl_end[i];
             x += blockDim.x)
            covered[x] = true;
}

extern "C" int ct_greedy_v2_steps(
        void* covered, int64_t U, void* len_u, const void* can_uncover,
        int64_t nU, void* in_cover, const void* cost, const void* rank_idx,
        int64_t S, const void* ivl_start, const void* ivl_end,
        const void* pair_bounds, const void* set_bounds,
        const void* univ_of_pair, int64_t P, int n_rank_vals,
        int max_ivls_per_set, int n_steps, void* cur_rank, void* stop,
        void* chosens, void* picks, void* prefix, void* tiles,
        void* pair_new, void* pair_capped, void* blk_r, void* blk_i,
        void* blk_any, void* dec, void* stream) {
    cudaStream_t st = ct_stream(stream);
    const unsigned nb_s = ct_blocks(S, 256);
    const unsigned n_upd = max_ivls_per_set > 0 ? max_ivls_per_set : 1;
    for (int step = 0; step < n_steps; ++step) {
        cudaMemsetAsync(prefix, 0, sizeof(int), st);
        ct_scan(UncoveredLoad{(const bool*)covered},
                PrefixStore{(int*)prefix}, U, (int*)tiles, st);
        if (P > 0)
            v2_pair_kernel<<<ct_blocks(P, 256), 256, 0, st>>>(
                (const int*)prefix, (const int*)ivl_start,
                (const int*)ivl_end, (const int*)pair_bounds,
                (const int*)univ_of_pair, P, (const int*)len_u,
                (const int*)can_uncover, (int*)pair_new,
                (int*)pair_capped);
        if (S > 0)
            v2_set_kernel<<<nb_s, 256, 0, st>>>(
                (const int*)pair_capped, (const int*)set_bounds, S,
                (const bool*)in_cover, (const int*)rank_idx,
                (const int*)cur_rank, (const float*)cost, (float*)blk_r,
                (int*)blk_i, (int*)blk_any);
        ct_decide_kernel<<<1, CT_DECIDE_THREADS, 0, st>>>(
            (const float*)blk_r, (const int*)blk_i, (const int*)blk_any,
            S > 0 ? nb_s : 0, (const int*)len_u, (const int*)can_uncover,
            nU, n_rank_vals, (int*)cur_rank, (bool*)stop, (bool*)in_cover,
            (int*)dec, (int*)chosens, (bool*)picks, step, nullptr, nullptr);
        v2_update_kernel<<<n_upd, 256, 0, st>>>(
            (const int*)dec, (const int*)set_bounds,
            (const int*)pair_bounds, (const int*)univ_of_pair,
            (const int*)pair_new, (const int*)ivl_start,
            (const int*)ivl_end, (int*)len_u, (bool*)covered);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    return (int)cudaGetLastError();
}
