// K18 greedy_sharded: greedy set-cover steps with the sets sharded over
// the places of a mesh and the coverage state replicated, on K13's
// incremental step (greedy_v1.cu).
//
// Replaces catch_tpu/parallel/set_cover.py greedy_step_sharded (:114-181)
// and, driven until the stop flag, the loop of _solve_sharded_jit
// (:184-236).  Place d holds the sets [base, base + S) with their pairs
// and intervals, and a replica of covered, len_u, order, n_chosen,
// cur_rank and stop.  Each shard is regrouped set-major once a solve
// (ops/set_cover.py set_major_index, on local set ids), and each place
// keeps its pairs' uncovered counts pair_new on the card through a call:
// catch_tpu's segment sum over each pair's intervals of their uncovered
// positions, taken from the place's own replica.
//
// Every launch serves all places of one card: a table of GsPlace records
// in device memory, the place on blockIdx.y (or blockIdx.x where a place
// is one block).  Place d writes slot d of the candidates and row d of
// the update rows, in its card's GsCard.  A call is:
//   recompute, once a call (4 launches): the uncovered prefix of each
//      replica (greedy.cuh's three-pass scan, a row a place), then a
//      thread a pair;
//   then each step, 4 launches, in phases:
//   offer   greedy.cuh's score pass over the place's pairs (a group of
//           lanes a set), then one block a place takes its first minimum
//           as (ratio, global id = base + local, any eligible) into slot
//           d; a shard without sets offers (+inf, base);
//   pick    one block a place: greedy.cuh's decide step over the n slots
//           on its replica (catch_tpu's pmin on the ratio, then on the
//           global id), then, in the same block, collect: the place that
//           owns the chosen set flags it in its in_cover and writes row d
//           from the set's own entries of its regrouping: each tile the
//           set meets with the set's intervals there, and each of its
//           pairs' (universe, pair_new); every other place writes an
//           empty row (the counts, no memset);
//   apply   on every replica, a block per listed tile ORs the row's
//           intervals there, marks the positions still uncovered, takes
//           their prefix in shared memory and covers them; through the
//           place's own tile index it subtracts the fresh count inside
//           each of its intervals from that interval's pair_new.  Block
//           0 also subtracts the row's pair_new from len_u.
// Between offer and pick, and between pick and apply, every place needs
// every other place's slot or row.  Places that share a card share its
// GsCard, and their one stream orders the phases.  Places on distinct
// cards hold their own GsCard, and the caller copies slot d and row d
// from place d's card to the other cards between the phases.  No phase
// waits for the host.
//
// The replicas are equal, so every place sees the same fresh positions,
// and the update keeps each place's pair_new equal to a full recompute,
// overlapping intervals included (as K13's).  The row's pair_new is the
// chosen pairs' count before the update, which catch_tpu subtracts from
// len_u.  Integer atomics give the same sums in any order, and the
// minimum prefers the lower set id on equal ratios, so every replica
// equals catch_tpu's state after every step at any number of places.
// Steps after the stop change nothing but cur_rank.
//
// Bound on the card: device-memory bandwidth.  The recompute reads each
// replica's axis once a call; a step reads each shard's pair_new and
// univ_of_pair and its set arrays once, and the update only the chosen
// set's tiles on each replica.  Launch gaps (4 a step a card) are the
// floor at small sizes.
#include "greedy.cuh"

#define GS_TILE 256   // positions a tile: ops/set_cover.py _K12_TILE

// One place.  The regrouping's pointers are null for a shard without
// sets.  All fields are 8 bytes: parallel/set_cover.py writes the table
// as int64 values in this order.
struct GsPlace {
    bool* covered;
    int* len_u;
    bool* in_cover;
    int* cur_rank;
    bool* stop;
    int* order;
    int* n_chosen;
    const int* can_uncover;
    const float* cost;
    const int* rank_idx;
    const int* ivl_start;
    const int* ivl_end;
    const int* pair_bounds;
    const int* set_bounds;
    const int* univ_of_pair;
    const int4* ivl_rec;
    const int* tile_ptr;
    const int* tile_ivl;
    const int* set_grp;
    const int* grp_tile;
    const int* grp_off;
    const int* grp_ivl;
    int* prefix;
    int* pair_new;
    float* blk_r;
    int* blk_i;
    int* blk_any;
    int* dec;
    int64_t S, P, nb, lg, base, slot;
};

// A card's candidate slots and update rows.  Row d: cnt[3 d .. 3 d + 2]
// count its tiles, interval entries and pairs; tile[d][g] is tile g's
// id and its intervals are ivl[d][off[d][g] .. off[d][g + 1]]; the pairs
// are (univ[d][k], pnew[d][k]).  cap_g, cap_e, cap_p: the most tiles,
// interval entries and pairs of one set.
struct GsCard {
    float* cand_r;
    int* cand_i;
    int* cand_any;
    int* cnt;
    int* tile;
    int* off;
    int2* ivl;
    int* univ;
    int* pnew;
    int64_t cap_g, cap_e, cap_p;
};

namespace {

// The uncovered indicator of place blockIdx.y's replica, and its
// inclusive prefix into prefix[i + 1] (prefix[0] = 0 from the first item).
struct GsUncovered {
    const GsPlace* places;
    __device__ int operator()(int64_t i) const {
        return places[blockIdx.y].covered[i] ? 0 : 1;
    }
};

struct GsPrefix {
    const GsPlace* places;
    __device__ void operator()(int64_t i, int v) const {
        int* prefix = places[blockIdx.y].prefix;
        if (i == 0) prefix[0] = 0;
        prefix[i + 1] = v;
    }
};

__global__ void gs_pair_new_kernel(const GsPlace* __restrict__ places) {
    const GsPlace& p = places[blockIdx.y];
    ct_pair_new(p.prefix, p.ivl_start, p.ivl_end, p.pair_bounds, p.P,
                p.pair_new);
}

__global__ void gs_score_kernel(const GsPlace* __restrict__ places) {
    const GsPlace& p = places[blockIdx.y];
    if (blockIdx.x >= p.nb) return;
    ct_group_score(p.pair_new, p.univ_of_pair, p.set_bounds, p.S, (int)p.lg,
                   p.len_u, p.can_uncover, p.in_cover, p.rank_idx,
                   p.cur_rank, p.cost, p.blk_r, p.blk_i, p.blk_any,
                   (int)p.base);
}

// One block a place: its first (ratio, global id) minimum over its score
// blocks into slot `slot`.
__global__ void gs_offer_kernel(const GsPlace* __restrict__ places,
                                GsCard c) {
    const GsPlace& p = places[blockIdx.x];
    float r;
    int i;
    const int any = ct_min_of_blocks(p.blk_r, p.blk_i, p.blk_any, p.nb, r, i);
    if (threadIdx.x == 0) {
        c.cand_r[p.slot] = r;
        c.cand_i[p.slot] = p.nb > 0 ? i : (int)p.base;
        c.cand_any[p.slot] = any;
    }
}

// One block a place: the decide step on its replica, then row `slot`:
// the chosen set's entries where the place owns it, else empty.
__global__ void gs_pick_kernel(const GsPlace* __restrict__ places, GsCard c,
                               int n_places, int64_t nU, int n_rank_vals) {
    __shared__ int decided[2];
    const GsPlace& p = places[blockIdx.x];
    ct_decide(c.cand_r, c.cand_i, c.cand_any, n_places, p.len_u,
              p.can_uncover, nU, n_rank_vals, p.cur_rank, p.stop, nullptr,
              p.dec, nullptr, nullptr, 0, p.order, p.n_chosen);
    if (threadIdx.x == 0) {
        decided[0] = p.dec[0];
        decided[1] = p.dec[1];
    }
    __syncthreads();
    const int64_t row = p.slot;
    int* cnt = c.cnt + 3 * row;
    const int chosen = decided[0];
    if (!decided[1] || chosen < p.base || chosen >= p.base + p.S) {
        if (threadIdx.x == 0) cnt[0] = cnt[1] = cnt[2] = 0;
        return;
    }
    const int s = chosen - (int)p.base;
    const int g0 = p.set_grp[s], ng = p.set_grp[s + 1] - g0;
    const int e0 = p.grp_off[g0], ne = p.grp_off[g0 + ng] - e0;
    const int q0 = p.set_bounds[s], nq = p.set_bounds[s + 1] - q0;
    int* tile = c.tile + row * c.cap_g;
    int* off = c.off + row * (c.cap_g + 1);
    int2* ivl = c.ivl + row * c.cap_e;
    for (int k = threadIdx.x; k < ng; k += blockDim.x) {
        tile[k] = p.grp_tile[g0 + k];
        off[k] = p.grp_off[g0 + k] - e0;
    }
    for (int k = threadIdx.x; k < ne; k += blockDim.x) {
        const int4 r = p.ivl_rec[p.grp_ivl[e0 + k]];
        ivl[k] = make_int2(r.x, r.y);
    }
    for (int k = threadIdx.x; k < nq; k += blockDim.x) {
        c.univ[row * c.cap_p + k] = p.univ_of_pair[q0 + k];
        c.pnew[row * c.cap_p + k] = p.pair_new[q0 + k];
    }
    if (threadIdx.x == 0) {
        off[ng] = ne;
        cnt[0] = ng;
        cnt[1] = ne;
        cnt[2] = nq;
        p.in_cover[s] = true;
    }
}

// Blocks of GS_TILE threads: block x takes tile x of the row, on the
// replica of place blockIdx.y.  The chosen set is shard chosen / S_loc's.
__global__ void gs_apply_kernel(const GsPlace* __restrict__ places,
                                GsCard c, int64_t S_loc) {
    __shared__ int fresh_before[GS_TILE + 1];
    const GsPlace& p = places[blockIdx.y];
    if (!p.dec[1]) return;
    const int64_t row = p.dec[0] / S_loc;
    const int* cnt = c.cnt + 3 * row;
    if (blockIdx.x == 0)
        for (int k = threadIdx.x; k < cnt[2]; k += blockDim.x) {
            const int n = c.pnew[row * c.cap_p + k];
            if (n) atomicSub(&p.len_u[c.univ[row * c.cap_p + k]], n);
        }
    const int g = blockIdx.x;
    if (g >= cnt[0]) return;
    const int t = c.tile[row * c.cap_g + g];
    const int* off = c.off + row * (c.cap_g + 1);
    const int2* ivl = c.ivl + row * c.cap_e;
    const int64_t t0 = (int64_t)t * GS_TILE, t1 = t0 + GS_TILE;
    const int64_t x = t0 + threadIdx.x;
    bool chosen = false;
    for (int k = off[g]; k < off[g + 1]; ++k)
        chosen |= ivl[k].x <= x && x < ivl[k].y;
    // a chosen position lies inside an interval, so before U
    const int fresh = chosen && !p.covered[x];
    int total;
    fresh_before[threadIdx.x] = ct_block_excl_scan(fresh, &total);
    if (threadIdx.x == 0) fresh_before[GS_TILE] = total;
    __syncthreads();
    if (total == 0) return;
    // each thread covers only the position it read
    if (fresh) p.covered[x] = true;
    if (!p.tile_ptr) return;
    for (int k = p.tile_ptr[t] + threadIdx.x; k < p.tile_ptr[t + 1];
         k += blockDim.x) {
        const int4 r = p.ivl_rec[p.tile_ivl[k]];
        const int64_t a = r.x > t0 ? r.x : t0, b = r.y < t1 ? r.y : t1;
        if (a < b) {
            const int n = fresh_before[b - t0] - fresh_before[a - t0];
            if (n) atomicSub(&p.pair_new[r.z], n);
        }
    }
}

}  // namespace

// The phases that `stages` selects (greedy.cuh's CT_* bits: RECOMPUTE,
// SCORE = offer, DECIDE = pick, UPDATE = apply) for the n_loc places of
// one card, whose table `places` lies on the card; the caller makes the
// card current.  n_places: the mesh's places (candidate slots and rows);
// max_nb, max_P: the most score blocks and pairs of a place on the card;
// tiles: n_loc * ceil(U / CT_SCAN_TILE) ints.
extern "C" int ct_gs_steps(const void* places, int n_loc, const GsCard* card,
                           int n_places, int64_t U, int64_t nU,
                           int n_rank_vals, int64_t S_loc, int64_t max_nb,
                           int64_t max_P, void* tiles, int stages,
                           void* stream) {
    cudaStream_t st = ct_stream(stream);
    const GsPlace* p = (const GsPlace*)places;
    const GsCard& c = *card;
    if (stages & CT_RECOMPUTE) {
        // with U = 0 every interval is [0, 0) and adds prefix[0] -
        // prefix[0] = 0
        ct_scan_rows(GsUncovered{p}, GsPrefix{p}, U, n_loc, (int*)tiles, st);
        if (max_P > 0)
            gs_pair_new_kernel<<<dim3(ct_blocks(max_P, 256), n_loc), 256, 0,
                                 st>>>(p);
    }
    if (stages & CT_SCORE) {
        if (max_nb > 0)
            gs_score_kernel<<<dim3((unsigned)max_nb, n_loc), CT_GROUP_THREADS,
                              0, st>>>(p);
        gs_offer_kernel<<<n_loc, CT_DECIDE_THREADS, 0, st>>>(p, c);
    }
    if (stages & CT_DECIDE) {
        gs_pick_kernel<<<n_loc, CT_DECIDE_THREADS, 0, st>>>(
            p, c, n_places, nU, n_rank_vals);
    }
    if (stages & CT_UPDATE) {
        const unsigned n_tiles = c.cap_g > 0 ? (unsigned)c.cap_g : 1;
        gs_apply_kernel<<<dim3(n_tiles, n_loc), GS_TILE, 0, st>>>(p, c,
                                                                 S_loc);
    }
    return (int)cudaGetLastError();
}
