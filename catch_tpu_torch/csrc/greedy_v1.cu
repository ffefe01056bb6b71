// K13 greedy_v1: greedy set-cover steps with unsorted segment sums.
//
// Replaces catch_tpu/ops/set_cover.py _steps_jit (:630-658) and its step
// _greedy_core (:292-347) and, driven until the stop flag with the pick
// order kept on the device, the while-loop solver _solve_jit_padded
// (:917-945, _greedy_step :350-364).  The instance names each interval's
// pair (pair_of_ivl) and each pair's set and universe, in any order.  One
// call runs n_steps steps with no host synchronisation; a step is:
//   1. the uncovered prefix (greedy.cuh's scan);
//   2. intervals: one thread per interval adds prefix[end] - prefix[start]
//      to pair_new[pair_of_ivl] by an integer atomic (greedy.cuh);
//   3. pairs: one thread per pair adds min(pair_new, need of its
//      universe) to score[set_of_pair] by an integer atomic (greedy.cuh);
//   4. sets: eligibility, the float32 ratio and each block's first
//      (ratio, set id) minimum (greedy.cuh);
//   5. decide (greedy.cuh), which also appends a pick to `order` when the
//      caller keeps the order on the device;
//   6. update: every interval whose set is the chosen one fills its
//      range of `covered`, and every pair of the chosen set takes its
//      pair_new off its universe's len_u by an atomic.
// Integer atomics give the same sums in any order, so the steps equal
// catch_tpu's and the plain twin's exactly.
//
// Bound on the card: device-memory bandwidth (every step reads all
// intervals, pairs and sets and the whole position axis); the atomics of
// pass 2 and 3 land on mostly distinct addresses.
#include "greedy.cuh"

__global__ void v1_set_kernel(const int* __restrict__ score, int64_t S,
                              const bool* __restrict__ in_cover,
                              const int* __restrict__ rank_idx,
                              const int* __restrict__ cur_rank,
                              const float* __restrict__ cost,
                              float* __restrict__ blk_r,
                              int* __restrict__ blk_i,
                              int* __restrict__ blk_any) {
    const int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    ct_set_candidates(s < S ? s : -1, s < S ? score[s] : 0, in_cover,
                      rank_idx, *cur_rank, cost, blk_r, blk_i, blk_any);
}

__global__ void v1_update_kernel(const int* __restrict__ dec,
                                 const int* __restrict__ set_of_pair,
                                 const int* __restrict__ pair_of_ivl,
                                 const int* __restrict__ ivl_start,
                                 const int* __restrict__ ivl_end, int64_t M,
                                 const int* __restrict__ univ_of_pair,
                                 const int* __restrict__ pair_new, int64_t P,
                                 int* __restrict__ len_u,
                                 bool* __restrict__ covered) {
    if (!dec[1]) return;
    const int c = dec[0];
    const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (t < M && set_of_pair[pair_of_ivl[t]] == c)
        for (int x = ivl_start[t]; x < ivl_end[t]; ++x) covered[x] = true;
    if (t < P && set_of_pair[t] == c)
        atomicSub(&len_u[univ_of_pair[t]], pair_new[t]);
}

extern "C" int ct_greedy_v1_steps(
        void* covered, int64_t U, void* len_u, const void* can_uncover,
        int64_t nU, void* in_cover, const void* cost, const void* rank_idx,
        int64_t S, const void* ivl_start, const void* ivl_end,
        const void* pair_of_ivl, int64_t M, const void* set_of_pair,
        const void* univ_of_pair, int64_t P, int n_rank_vals, int n_steps,
        void* cur_rank, void* stop, void* chosens, void* picks, void* order,
        void* n_chosen, void* prefix, void* tiles, void* pair_new,
        void* score, void* blk_r, void* blk_i, void* blk_any, void* dec,
        void* stream) {
    cudaStream_t st = ct_stream(stream);
    const unsigned nb_s = ct_blocks(S, 256);
    const int64_t n_upd = M > P ? M : P;
    for (int step = 0; step < n_steps; ++step) {
        cudaMemsetAsync(prefix, 0, sizeof(int), st);
        ct_scan(UncoveredLoad{(const bool*)covered},
                PrefixStore{(int*)prefix}, U, (int*)tiles, st);
        if (P > 0) cudaMemsetAsync(pair_new, 0, P * sizeof(int), st);
        if (S > 0) cudaMemsetAsync(score, 0, S * sizeof(int), st);
        if (M > 0)
            ct_ivl_sums_kernel<<<ct_blocks(M, 256), 256, 0, st>>>(
                (const int*)prefix, (const int*)ivl_start,
                (const int*)ivl_end, (const int*)pair_of_ivl, M,
                (int*)pair_new);
        if (P > 0)
            ct_pair_scores_kernel<<<ct_blocks(P, 256), 256, 0, st>>>(
                (const int*)pair_new, (const int*)set_of_pair,
                (const int*)univ_of_pair, P, (const int*)len_u,
                (const int*)can_uncover, 0, (int*)score);
        if (S > 0)
            v1_set_kernel<<<nb_s, 256, 0, st>>>(
                (const int*)score, S, (const bool*)in_cover,
                (const int*)rank_idx, (const int*)cur_rank,
                (const float*)cost, (float*)blk_r, (int*)blk_i,
                (int*)blk_any);
        ct_decide_kernel<<<1, CT_DECIDE_THREADS, 0, st>>>(
            (const float*)blk_r, (const int*)blk_i, (const int*)blk_any,
            S > 0 ? nb_s : 0, (const int*)len_u, (const int*)can_uncover,
            nU, n_rank_vals, (int*)cur_rank, (bool*)stop, (bool*)in_cover,
            (int*)dec, (int*)chosens, (bool*)picks, step, (int*)order,
            (int*)n_chosen);
        if (n_upd > 0)
            v1_update_kernel<<<ct_blocks(n_upd, 256), 256, 0, st>>>(
                (const int*)dec, (const int*)set_of_pair,
                (const int*)pair_of_ivl, (const int*)ivl_start,
                (const int*)ivl_end, M, (const int*)univ_of_pair,
                (const int*)pair_new, P, (int*)len_u, (bool*)covered);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    return (int)cudaGetLastError();
}
