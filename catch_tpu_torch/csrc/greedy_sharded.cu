// K18 greedy_sharded: greedy set-cover steps with the sets sharded over
// the places of a mesh and the coverage state replicated.
//
// Replaces catch_tpu/parallel/set_cover.py greedy_step_sharded (:114-181)
// and, driven until the stop flag, the loop of _solve_sharded_jit
// (:184-236).  Place d holds the sets [base, base + S) with their pairs
// and intervals (set_of_pair keeps global set ids, pair_of_ivl is local)
// and a replica of covered, len_u, order, n_chosen, cur_rank and stop.  A
// step has four phases, each one entry point for one place:
//   candidate  the uncovered prefix of the place's replica, the segment
//              sums of its shard (greedy.cuh's atomics), eligibility and
//              the float32 ratio, and the shard's first minimum as (ratio,
//              global set id, any eligible) in slot d of the candidates;
//              a shard without sets offers (+inf, base);
//   decide     greedy.cuh's decide step over the n candidates (catch_tpu's
//              pmin on the ratio, then pmin on the global id): pick, rank
//              advance, stop, order[n_chosen++] on this replica;
//   collect    the place that owns the chosen set flags it in its in_cover
//              and writes the set's intervals and each of its pairs'
//              (universe, pair_new) to row d of the update buffers; every
//              other place writes empty rows;
//   apply      every replica fills the listed intervals into covered and
//              takes the listed pair_new off len_u (what catch_tpu merges
//              by a psum of a (U + 1)-long delta; the chosen set's
//              intervals are few, so only they travel).
// Between candidate and decide, and between collect and apply, every place
// needs every other place's slot or row.  Places that share a card share
// the candidate slots and the update buffers, and their one stream orders
// the phases.  Places on distinct cards hold their own copies, and the
// caller copies slot d and row d from place d to the other cards between
// the phases.  No phase waits for the host, so the caller queues many
// steps at once.
//
// Integer atomics give the same sums in any order, and the minimum prefers
// the lower set id on equal ratios, so every replica equals catch_tpu's
// state after every step at any number of places.
//
// Bound on the card: device-memory bandwidth; every place reads its
// replica of the position axis and its shard every step.
#include "greedy.cuh"

struct GsPlace {
    bool* covered;
    int* len_u;
    const int* can_uncover;
    bool* in_cover;
    const float* cost;
    const int* rank_idx;
    const int* ivl_start;
    const int* ivl_end;
    const int* pair_of_ivl;
    const int* set_of_pair;
    const int* univ_of_pair;
    int* cur_rank;
    bool* stop;
    int* order;
    int* n_chosen;
    int* prefix;
    int* tiles;
    int* pair_new;
    int* score;
    float* blk_r;
    int* blk_i;
    int* blk_any;
    int* dec;
    int64_t S, M, P, base;
};

// The update buffers: row d holds what place d collected.  cnt[2 * d] and
// cnt[2 * d + 1] count its intervals and pairs; cap_i and cap_p are the
// row widths (the largest interval and pair counts of one set).
struct GsUpdate {
    int* cnt;
    int* ivl_start;
    int* ivl_end;
    int* univ;
    int* pair_new;
    int64_t cap_i, cap_p;
};

__global__ void gs_set_kernel(const int* __restrict__ score, int64_t S,
                              int base, const bool* __restrict__ in_cover,
                              const int* __restrict__ rank_idx,
                              const int* __restrict__ cur_rank,
                              const float* __restrict__ cost,
                              float* __restrict__ blk_r,
                              int* __restrict__ blk_i,
                              int* __restrict__ blk_any) {
    const int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    ct_set_candidates(s < S ? s : -1, s < S ? score[s] : 0, in_cover,
                      rank_idx, *cur_rank, cost, blk_r, blk_i, blk_any, base);
}

// One block: the shard's first (ratio, global id) minimum over its set
// blocks.
__global__ void gs_place_kernel(const float* __restrict__ blk_r,
                                const int* __restrict__ blk_i,
                                const int* __restrict__ blk_any, int64_t nb,
                                int base, float* cand_r, int* cand_i,
                                int* cand_any) {
    float r = INFINITY;
    int i = INT_MAX;
    int any = 0;
    for (int64_t b = threadIdx.x; b < nb; b += blockDim.x) {
        if (ct_better(blk_r[b], blk_i[b], r, i)) { r = blk_r[b]; i = blk_i[b]; }
        any |= blk_any[b];
    }
    any = __syncthreads_or(any);
    ct_block_min(r, i);
    if (threadIdx.x == 0) {
        *cand_r = r;
        *cand_i = nb > 0 ? i : base;
        *cand_any = any;
    }
}

__global__ void gs_collect_kernel(
        const int* __restrict__ dec, const int* __restrict__ set_of_pair,
        const int* __restrict__ pair_of_ivl,
        const int* __restrict__ ivl_start, const int* __restrict__ ivl_end,
        int64_t M, const int* __restrict__ univ_of_pair,
        const int* __restrict__ pair_new, int64_t P, int base, int64_t S,
        bool* __restrict__ in_cover, int* __restrict__ cnt,
        int* __restrict__ buf_s, int* __restrict__ buf_e,
        int* __restrict__ buf_u, int* __restrict__ buf_n) {
    if (!dec[1]) return;
    const int c = dec[0];
    const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (t == 0 && c >= base && c < base + S) in_cover[c - base] = true;
    if (t < M && set_of_pair[pair_of_ivl[t]] == c) {
        const int k = atomicAdd(&cnt[0], 1);
        buf_s[k] = ivl_start[t];
        buf_e[k] = ivl_end[t];
    }
    if (t < P && set_of_pair[t] == c) {
        const int k = atomicAdd(&cnt[1], 1);
        buf_u[k] = univ_of_pair[t];
        buf_n[k] = pair_new[t];
    }
}

// blockIdx.y is the row (the place that collected it).
__global__ void gs_apply_kernel(const int* __restrict__ cnt,
                                const int* __restrict__ buf_s,
                                const int* __restrict__ buf_e,
                                const int* __restrict__ buf_u,
                                const int* __restrict__ buf_n, int64_t cap_i,
                                int64_t cap_p, bool* __restrict__ covered,
                                int* __restrict__ len_u) {
    const int64_t row = blockIdx.y;
    const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (t < cnt[2 * row]) {
        const int end = buf_e[row * cap_i + t];
        for (int x = buf_s[row * cap_i + t]; x < end; ++x) covered[x] = true;
    }
    if (t < cnt[2 * row + 1])
        atomicSub(&len_u[buf_u[row * cap_p + t]], buf_n[row * cap_p + t]);
}

namespace {

void gs_candidate(const GsPlace& p, int64_t U, float* cand_r, int* cand_i,
                  int* cand_any, cudaStream_t st) {
    cudaMemsetAsync(p.prefix, 0, sizeof(int), st);
    ct_scan(UncoveredLoad{p.covered}, PrefixStore{p.prefix}, U, p.tiles, st);
    if (p.P > 0) cudaMemsetAsync(p.pair_new, 0, p.P * sizeof(int), st);
    if (p.S > 0) cudaMemsetAsync(p.score, 0, p.S * sizeof(int), st);
    if (p.M > 0)
        ct_ivl_sums_kernel<<<ct_blocks(p.M, 256), 256, 0, st>>>(
            p.prefix, p.ivl_start, p.ivl_end, p.pair_of_ivl, p.M, p.pair_new);
    if (p.P > 0)
        ct_pair_scores_kernel<<<ct_blocks(p.P, 256), 256, 0, st>>>(
            p.pair_new, p.set_of_pair, p.univ_of_pair, p.P, p.len_u,
            p.can_uncover, (int)p.base, p.score);
    const unsigned nb = p.S > 0 ? ct_blocks(p.S, 256) : 0;
    if (nb > 0)
        gs_set_kernel<<<nb, 256, 0, st>>>(
            p.score, p.S, (int)p.base, p.in_cover, p.rank_idx, p.cur_rank,
            p.cost, p.blk_r, p.blk_i, p.blk_any);
    gs_place_kernel<<<1, CT_DECIDE_THREADS, 0, st>>>(
        p.blk_r, p.blk_i, p.blk_any, nb, (int)p.base, cand_r, cand_i,
        cand_any);
}

void gs_decide(const GsPlace& p, int n_places, const float* cand_r,
               const int* cand_i, const int* cand_any, int64_t nU,
               int n_rank_vals, cudaStream_t st) {
    ct_decide_kernel<<<1, CT_DECIDE_THREADS, 0, st>>>(
        cand_r, cand_i, cand_any, n_places, p.len_u, p.can_uncover, nU,
        n_rank_vals, p.cur_rank, p.stop, nullptr, p.dec, nullptr, nullptr, 0,
        p.order, p.n_chosen);
}

void gs_collect(const GsPlace& p, const GsUpdate& u, int64_t row,
                cudaStream_t st) {
    cudaMemsetAsync(u.cnt + 2 * row, 0, 2 * sizeof(int), st);
    const int64_t n = p.M > p.P ? p.M : p.P;
    if (n > 0)
        gs_collect_kernel<<<ct_blocks(n, 256), 256, 0, st>>>(
            p.dec, p.set_of_pair, p.pair_of_ivl, p.ivl_start, p.ivl_end, p.M,
            p.univ_of_pair, p.pair_new, p.P, (int)p.base, p.S, p.in_cover,
            u.cnt + 2 * row, u.ivl_start + row * u.cap_i,
            u.ivl_end + row * u.cap_i, u.univ + row * u.cap_p,
            u.pair_new + row * u.cap_p);
}

void gs_apply(const GsPlace& p, const GsUpdate& u, int n_places,
              cudaStream_t st) {
    const int64_t n = u.cap_i > u.cap_p ? u.cap_i : u.cap_p;
    if (n > 0)
        gs_apply_kernel<<<dim3(ct_blocks(n, 256), n_places), 256, 0, st>>>(
            u.cnt, u.ivl_start, u.ivl_end, u.univ, u.pair_new, u.cap_i,
            u.cap_p, p.covered, p.len_u);
}

}  // namespace

// One phase of one place; the caller makes the place's card current.
extern "C" int ct_gs_candidate(const GsPlace* p, int64_t U, void* cand_r,
                               void* cand_i, void* cand_any, int64_t slot,
                               void* stream) {
    gs_candidate(*p, U, (float*)cand_r + slot, (int*)cand_i + slot,
                 (int*)cand_any + slot, ct_stream(stream));
    return (int)cudaGetLastError();
}

extern "C" int ct_gs_decide(const GsPlace* p, int n_places,
                            const void* cand_r, const void* cand_i,
                            const void* cand_any, int64_t nU,
                            int n_rank_vals, void* stream) {
    gs_decide(*p, n_places, (const float*)cand_r, (const int*)cand_i,
              (const int*)cand_any, nU, n_rank_vals, ct_stream(stream));
    return (int)cudaGetLastError();
}

extern "C" int ct_gs_collect(const GsPlace* p, const GsUpdate* u,
                             int64_t row, void* stream) {
    gs_collect(*p, *u, row, ct_stream(stream));
    return (int)cudaGetLastError();
}

extern "C" int ct_gs_apply(const GsPlace* p, const GsUpdate* u, int n_places,
                           void* stream) {
    gs_apply(*p, *u, n_places, ct_stream(stream));
    return (int)cudaGetLastError();
}
