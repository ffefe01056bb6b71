// K7 minhash_caps: capped-union MinHash intersection counts of query
// signatures against representative signatures, in four outputs.
//
// Replaces catch_tpu/utils/cluster.py _row_dists_kernel (:79) and
// _block_dists_kernel (:85) (entry ct_minhash_dists), _block_codes_kernel
// (:120) (ct_minhash_codes), _pair_caps_jit (:238) (ct_minhash_caps) and
// _assign_to_reps_jit (:205) (ct_minhash_assign).  All five TPU programs
// evaluate one estimator as a lax.scan over the N columns of the
// representative row B against the query row A: for column j, v = B[j],
//   lt = #{A < v},  eq = v in A,  ok = eq && lt + j - cm + 1 <= N,
// then cm += eq and cap += ok.  Both rows ascend, so lt is a pointer p
// into A that only moves forward and eq is A[p] == v.  The rank
// p + j - cm never falls along the walk (p only grows, cm by at most one
// a column), so once a column fails the rank test every later one does:
// every column counted before the first failure passes it, and cap
// equals cm there.  Duplicates inside a row count as the scan counts
// them: every column of B is visited, and p stops at the first A >= v.
//
// The walk (mh_walk) is a merge of A and B with one step a time: where
// A[p] < B[j] the pointer moves (p += 1), else column j is taken (cap +=
// eq, j += 1).  `left` = N - (p + j - cap) falls by one at every step
// but an equal column, and the walk ends where left reaches 0 or j
// reaches N: at most N + cap <= 2N steps.  Where p reaches N, left is
// cap - j <= 0 (each counted column is a column taken), so p needs no
// test of its own.  Every step has the same instructions, its loads and
// updates predicated, the two rows' positions kept as shared-memory
// pointers, and a warp votes whether any lane still walks only every
// MH_UNROLL steps.
//
// The lanes of a warp walk one query row against 32 representatives, a
// representative a lane.  A block stages a group of 32 representative
// rows interleaved (element j of lane l at j * 32 + l), so that the 32
// lanes, each at its own column, read 32 distinct banks, and tq query
// rows, which the lanes read as one row (a lane's reads of one query row
// conflict only where two pointers lie a multiple of 32 apart).  Every
// staged row has a pad word at N, which a finished pointer may read.
// Each warp takes the block's queries in turn; its 32 results are
// neighbouring outputs, written together.  ct_minhash_assign reduces a
// warp's 32 counts with two warp reductions (the largest count, then the
// first representative holding it); where the representatives fill
// more than one group, each group's best goes out as one 64-bit key
// (count + 1, then the complement of the index, so that the largest key
// is the first best) and a second kernel takes each query's largest.
//
// minhash_order_kernel checks that every row ascends, both matrices in
// one pass: each block writes its own flag byte (bit 0: a query row,
// bit 1: a representative row), so nothing needs clearing before it.
// Each entry point launches it, then its own kernels, then reads the
// flags back and waits for the stream once, and returns the flags'
// bits as a negative code: the wrapper raises on them.
//
// Bound on the card: integer and compare work, counted as 4 operations
// per (pair, column): Q * R * N * 4 against Q * N + R * N words of
// input.  A walk step is about a dozen instructions of one lane, and a
// pair takes N to 2N steps, so the kernel stays several times above
// that count.
#include "common.cuh"

#define MH_LANES 32
#define MH_WARPS 8
#define MH_MAX_TQ 64
#define MH_UNROLL 8
#define MH_ORDER_THREADS 256
#define MH_ORDER_MAX_BLOCKS 264

// The capped count of one lane: query row A (contiguous) against the
// lane's representative row B (stride MH_LANES), both N values and a pad
// word (which a pointer reaches as its walk ends).  A lane that is not
// `active` walks no step.  Every lane of the warp must call it: the
// lanes vote on when to stop.
__device__ __forceinline__ int mh_walk(const int32_t* __restrict__ A,
                                       const int32_t* __restrict__ B, int N,
                                       bool active) {
    const int32_t* pa = A;
    const int32_t* pb = B;
    const int32_t* const pb_end = B + N * MH_LANES;
    int cap = 0, left = active ? N : 0;
    int32_t a = *pa, b = *pb;
    for (;;) {
#pragma unroll
        for (int k = 0; k < MH_UNROLL; ++k) {
            const bool live = (pb < pb_end) & (left > 0);
            const bool lt = a < b;
            const bool eq = a == b;
            if (live & eq) ++cap;
            if (live & !eq) --left;
            if (live & lt) a = *++pa;
            if (live & !lt) {
                pb += MH_LANES;
                b = *pb;
            }
        }
        if (!__any_sync(0xffffffffu, (pb < pb_end) & (left > 0))) break;
    }
    return cap;
}

// Stage the block's representative group (interleaved) and query rows
// (contiguous), each row with its pad word; rows past the matrix are
// left unwritten (their lanes walk no step, their queries are skipped).
__device__ __forceinline__ void mh_stage(int32_t* sr, int32_t* sq,
                                         const int32_t* __restrict__ qs,
                                         int64_t q0, int nq,
                                         const int32_t* __restrict__ rs,
                                         int64_t r0, int nr, int N) {
    const int S = N + 1;
    const int32_t* rsrc = rs + r0 * N;
    for (int i = threadIdx.x; i < N * MH_LANES; i += blockDim.x) {
        const int l = i % MH_LANES, j = i / MH_LANES;
        if (l < nr) sr[i] = __ldg(rsrc + (int64_t)l * N + j);
    }
    const int32_t* qsrc = qs + q0 * N;
    for (int i = threadIdx.x; i < nq * N; i += blockDim.x) {
        const int t = i / N;
        sq[t * S + (i - t * N)] = qsrc[i];
    }
}

// MODE 0: float32 distance 1 - cap/N; 1: uint8 code; 2: uint8 cap;
// 3: int32 cap; 4: assign (best index and flag, or one key a group).
template <int MODE>
__global__ void __launch_bounds__(MH_LANES * MH_WARPS)
minhash_walk_kernel(const int32_t* __restrict__ qs, int64_t Q,
                    int64_t q_first, const int32_t* __restrict__ rs,
                    int64_t R, int N, int tq, int cap_thr, int cap_early,
                    void* __restrict__ out, uint8_t* __restrict__ ok_out,
                    uint64_t* __restrict__ part) {
    extern __shared__ int32_t smem[];
    const int S = N + 1;
    int32_t* sr = smem;
    int32_t* sq = smem + S * MH_LANES;
    const int64_t r0 = (int64_t)blockIdx.x * MH_LANES;
    const int64_t q0 = q_first + (int64_t)blockIdx.y * tq;
    const int nr = R - r0 < MH_LANES ? (int)(R - r0) : MH_LANES;
    const int nq = Q - q0 < tq ? (int)(Q - q0) : tq;
    mh_stage(sr, sq, qs, q0, nq, rs, r0, nr, N);
    __syncthreads();
    const int lane = threadIdx.x % MH_LANES;
    const int warp = threadIdx.x / MH_LANES, warps = blockDim.x / MH_LANES;
    for (int t = warp; t < nq; t += warps) {
        const int cap = mh_walk(sq + t * S, sr + lane, N, lane < nr);
        const int64_t q = q0 + t;
        if (MODE == 4) {
            const int c = lane < nr ? cap : -1;
            const int best = __reduce_max_sync(0xffffffffu, c);
            const int first = (int)__reduce_min_sync(
                0xffffffffu, c == best ? (unsigned)lane : MH_LANES);
            if (lane != 0) continue;
            const int64_t r = r0 + first;
            if (gridDim.x == 1) {
                ((int64_t*)out)[q] = r;
                ok_out[q] = best >= cap_thr;
            } else {
                part[(int64_t)blockIdx.x * Q + q] =
                    ((uint64_t)(best + 1) << 32) |
                    (uint64_t)(0xFFFFFFFFu - (uint32_t)r);
            }
            continue;
        }
        if (lane >= nr) continue;
        const int64_t o = q * R + r0 + lane;
        if (MODE == 0) {
            // catch_tpu's 1.0 - cap / N as XLA compiles it: the division
            // by the constant N becomes a product with its float32
            // reciprocal, fused with the subtraction (one rounding).
            ((float*)out)[o] =
                __fmaf_rn(-(float)cap, __frcp_rn((float)N), 1.0f);
        } else if (MODE == 1) {
            const int wt = cap >= cap_thr;
            ((uint8_t*)out)[o] = (uint8_t)(wt + (wt && cap >= cap_early));
        } else if (MODE == 2) {
            ((uint8_t*)out)[o] = (uint8_t)cap;
        } else {
            ((int32_t*)out)[o] = cap;
        }
    }
}

// Each query's largest key over the groups: the first best index, 0
// and no flag without a representative (argmax of catch_tpu's masked -1
// counts gives 0).
__global__ void minhash_assign_reduce_kernel(const uint64_t* __restrict__ part,
                                             int64_t Q, int groups,
                                             int cap_thr,
                                             int64_t* __restrict__ best_out,
                                             uint8_t* __restrict__ ok_out) {
    const int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (q >= Q) return;
    uint64_t key = 0;
    for (int g = 0; g < groups; ++g) {
        const uint64_t k = part[(int64_t)g * Q + q];
        key = k > key ? k : key;
    }
    best_out[q] = key ? (int64_t)(0xFFFFFFFFu - (uint32_t)key) : 0;
    ok_out[q] = key && (int)(key >> 32) - 1 >= cap_thr;
}

__global__ void minhash_order_kernel(const int32_t* __restrict__ qs,
                                     int64_t nq,
                                     const int32_t* __restrict__ rs,
                                     int64_t nr, int N,
                                     uint8_t* __restrict__ flags) {
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    const int64_t i0 = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    int bq = 0, br = 0;
    for (int64_t i = i0; i < nq; i += stride)
        if (i % N) bq |= qs[i] < qs[i - 1];
    for (int64_t i = i0; i < nr; i += stride)
        if (i % N) br |= rs[i] < rs[i - 1];
    bq = __syncthreads_or(bq);
    br = __syncthreads_or(br);
    if (threadIdx.x == 0) flags[blockIdx.x] = (uint8_t)(bq | (br << 1));
}

// The card's SM count and opt-in shared memory a block (cached a card).
static int mh_attribute(cudaDeviceAttr what, int slot) {
    static int cache[2][64];
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || dev >= 64) return 0;
    if (!cache[slot][dev]) {
        int v = 0;
        if (cudaDeviceGetAttribute(&v, what, dev) != cudaSuccess) return 0;
        cache[slot][dev] = v;
    }
    return cache[slot][dev];
}

// Launch the walk over every (query, representative) pair: groups of 32
// representatives on the grid's x, tiles of tq queries on its y (in
// several launches where the tiles pass the y limit).  tq is the most
// query rows that fit beside the group, at most MH_MAX_TQ, halved down
// to 8 while the grid has fewer than two blocks an SM.
template <int MODE>
static int launch_walk(const void* qs, int64_t Q, const void* rs, int64_t R,
                       int N, int cap_thr, int cap_early, void* out,
                       void* ok_out, void* part, void* stream) {
    if (Q <= 0 || R <= 0) return (int)cudaGetLastError();
    const int64_t row = (int64_t)(N + 1) * sizeof(int32_t);
    const int smem_max = mh_attribute(
        cudaDevAttrMaxSharedMemoryPerBlockOptin, 0);
    const int sms = mh_attribute(cudaDevAttrMultiProcessorCount, 1);
    if (!smem_max || !sms) return (int)cudaErrorInvalidDevice;
    int64_t fit = smem_max / row - MH_LANES;
    if (fit < 1) return (int)cudaErrorInvalidValue;
    int tq = (int)(fit < MH_MAX_TQ ? fit : MH_MAX_TQ);
    const int64_t groups = (R + MH_LANES - 1) / MH_LANES;
    while (tq > 8 && groups * ((Q + tq - 1) / tq) < 2 * sms) tq /= 2;
    if (tq > Q) tq = (int)Q;
    const int warps = tq < MH_WARPS ? tq : MH_WARPS;
    const size_t smem = (size_t)(MH_LANES + tq) * row;
    int err = (int)cudaFuncSetAttribute(
        (const void*)minhash_walk_kernel<MODE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err) return err;
    // query tiles ride the grid's y dimension, 65,535 tiles a launch
    const int64_t per_launch = (int64_t)65535 * tq;
    for (int64_t qa = 0; qa < Q; qa += per_launch) {
        const int64_t nq = Q - qa < per_launch ? Q - qa : per_launch;
        dim3 grid((unsigned)groups, (unsigned)((nq + tq - 1) / tq));
        minhash_walk_kernel<MODE><<<grid, warps * MH_LANES, smem,
                                    ct_stream(stream)>>>(
            (const int32_t*)qs, Q, qa, (const int32_t*)rs, R, N, tq,
            cap_thr, cap_early, out, (uint8_t*)ok_out, (uint64_t*)part);
        err = (int)cudaGetLastError();
        if (err) return err;
    }
    return 0;
}

// Launch the row-order check over qs (Q rows) and rs (R rows) into
// `blocks` flag bytes (none where blocks is 0).
static int order_launch(const void* qs, int64_t Q, const void* rs, int64_t R,
                        int N, void* flags, int blocks, void* stream) {
    if (blocks > 0)
        minhash_order_kernel<<<blocks, MH_ORDER_THREADS, 0,
                               ct_stream(stream)>>>(
            (const int32_t*)qs, Q * N, (const int32_t*)rs, R * N, N,
            (uint8_t*)flags);
    return (int)cudaGetLastError();
}

// After the launches: read the flag bytes back (the call's one
// synchronisation) and return 0, a CUDA error, or -(bit 0: an unsorted
// query row | bit 1: an unsorted representative row).
static int order_result(int err, const void* flags, int blocks,
                        void* stream) {
    if (err || blocks <= 0) return err;
    uint8_t host[MH_ORDER_MAX_BLOCKS];
    if (blocks > MH_ORDER_MAX_BLOCKS) return (int)cudaErrorInvalidValue;
    err = (int)cudaMemcpyAsync(host, flags, blocks, cudaMemcpyDeviceToHost,
                               ct_stream(stream));
    if (!err) err = (int)cudaStreamSynchronize(ct_stream(stream));
    if (err) return err;
    int bits = 0;
    for (int b = 0; b < blocks; ++b) bits |= host[b];
    return -bits;
}

// The row-order check alone.
extern "C" int ct_minhash_order(const void* qs, int64_t Q, const void* rs,
                                int64_t R, int N, void* flags, int blocks,
                                void* stream) {
    return order_result(order_launch(qs, Q, rs, R, N, flags, blocks, stream),
                        flags, blocks, stream);
}

// Each entry point below checks the row order of both matrices (blocks
// > 0), launches its kernels, and returns as order_result does: one
// call, one synchronisation.  With blocks = 0 it launches its kernels
// alone and returns without waiting.
template <int MODE>
static int checked_walk(const void* qs, int64_t Q, const void* rs, int64_t R,
                        int N, int cap_thr, int cap_early, void* out,
                        void* flags, int blocks, void* stream) {
    int err = order_launch(qs, Q, rs, R, N, flags, blocks, stream);
    if (!err)
        err = launch_walk<MODE>(qs, Q, rs, R, N, cap_thr, cap_early, out,
                                nullptr, nullptr, stream);
    return order_result(err, flags, blocks, stream);
}

extern "C" int ct_minhash_dists(const void* qs, int64_t Q, const void* rs,
                                int64_t R, int N, void* out, void* flags,
                                int blocks, void* stream) {
    return checked_walk<0>(qs, Q, rs, R, N, 0, 0, out, flags, blocks,
                           stream);
}

extern "C" int ct_minhash_codes(const void* qs, int64_t Q, const void* rs,
                                int64_t R, int N, int cap_thr, int cap_early,
                                void* out, void* flags, int blocks,
                                void* stream) {
    return checked_walk<1>(qs, Q, rs, R, N, cap_thr, cap_early, out, flags,
                           blocks, stream);
}

extern "C" int ct_minhash_caps(const void* qs, int64_t Q, const void* rs,
                               int64_t R, int N, int wide, void* out,
                               void* flags, int blocks, void* stream) {
    return wide ? checked_walk<3>(qs, Q, rs, R, N, 0, 0, out, flags, blocks,
                                  stream)
                : checked_walk<2>(qs, Q, rs, R, N, 0, 0, out, flags, blocks,
                                  stream);
}

// The first n_reps of rs's R rows are the representatives (the order
// check reads all R).  part: uint64[groups * Q] scratch, groups =
// ceil(n_reps / 32), read only where groups > 1.
extern "C" int ct_minhash_assign(const void* qs, int64_t Q, const void* rs,
                                 int64_t R, int64_t n_reps, int N,
                                 int cap_thr, void* best, void* ok,
                                 void* part, void* flags, int blocks,
                                 void* stream) {
    int err = order_launch(qs, Q, rs, R, N, flags, blocks, stream);
    const int64_t groups = (n_reps + MH_LANES - 1) / MH_LANES;
    if (!err && Q > 0)
        err = launch_walk<4>(qs, Q, rs, n_reps, N, cap_thr, 0, best, ok,
                             part, stream);
    if (!err && Q > 0 && groups != 1) {
        minhash_assign_reduce_kernel<<<ct_blocks(Q, 256), 256, 0,
                                       ct_stream(stream)>>>(
            (const uint64_t*)part, Q, (int)groups, cap_thr, (int64_t*)best,
            (uint8_t*)ok);
        err = (int)cudaGetLastError();
    }
    return order_result(err, flags, blocks, stream);
}
