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
// then cm += eq and cap += ok.  Both rows are ascending, so lt is a
// pointer into A that only moves forward and eq is A[lt] == v: an O(N)
// two-pointer walk per pair (capped_count).  Duplicates inside a row
// (a short sequence's tiled signature, a repeated k-mer) count exactly
// as the scan counts them: every column of B is visited, and the
// pointer stops at the first A >= v.  p + j - cm never decreases along
// the walk (p only grows, cm by at most 1 per column), so once a column
// fails the rank test every later one does, and the walk stops there.
//
// One thread per (query, representative) pair.  A block takes a tile of
// CT_TQ queries and CT_TR representatives and stages both tiles' rows in
// shared memory, so each row is read from device memory once per block.
// ct_minhash_assign walks every representative tile inside the block
// and reduces each query's best (largest cap, first index on ties) over
// the block's lanes.
//
// Bound on the card: integer and compare work, about 4 operations per
// (pair, column): Q * R * N * 4 against Q * N + R * N words of input.
// The walk's branches depend on the data and the smem reads of one warp
// hit data-dependent banks; both are accepted in this first version.
#include "common.cuh"

#define CT_TQ 16
#define CT_TR 16
#define CT_THREADS (CT_TQ * CT_TR)

__device__ __forceinline__ int capped_count(const int32_t* A,
                                            const int32_t* B, int N) {
    int p = 0, cm = 0, cap = 0;
    for (int j = 0; j < N; ++j) {
        const int32_t v = B[j];
        while (p < N && A[p] < v) ++p;
        if (p + j - cm + 1 > N) break;
        const int eq = (p < N && A[p] == v);
        cap += eq;
        cm += eq;
    }
    return cap;
}

// Stage rows [r0, r0 + rows) of an (n_rows, N) matrix into smem; rows
// past n_rows are left unwritten (their pairs are never evaluated).
__device__ __forceinline__ void stage_rows(int32_t* dst,
                                           const int32_t* __restrict__ src,
                                           int64_t r0, int rows,
                                           int64_t n_rows, int N) {
    int64_t avail = n_rows - r0;
    if (avail > rows) avail = rows;
    const int64_t words = avail * N;
    const int32_t* s = src + r0 * N;
    for (int64_t i = threadIdx.x; i < words; i += blockDim.x) dst[i] = s[i];
}

// MODE 0: float32 distance 1 - cap/N; 1: uint8 code; 2: uint8 cap;
// 3: int32 cap.
template <int MODE>
__global__ void minhash_pairs_kernel(const int32_t* __restrict__ qs,
                                     int64_t Q,
                                     const int32_t* __restrict__ rs,
                                     int64_t R, int N, int cap_thr,
                                     int cap_early, void* __restrict__ out) {
    extern __shared__ int32_t smem[];
    int32_t* sq = smem;
    int32_t* sr = smem + CT_TQ * N;
    const int64_t r0 = (int64_t)blockIdx.x * CT_TR;
    const int64_t q0 = (int64_t)blockIdx.y * CT_TQ;
    stage_rows(sq, qs, q0, CT_TQ, Q, N);
    stage_rows(sr, rs, r0, CT_TR, R, N);
    __syncthreads();
    const int tq = threadIdx.x / CT_TR, tr = threadIdx.x % CT_TR;
    const int64_t q = q0 + tq, r = r0 + tr;
    if (q >= Q || r >= R) return;
    const int cap = capped_count(sq + tq * N, sr + tr * N, N);
    const int64_t o = q * R + r;
    if (MODE == 0) {
        // catch_tpu's 1.0 - cap / N as XLA compiles it: the division by
        // the constant N becomes a product with its float32 reciprocal,
        // fused with the subtraction (one rounding).
        ((float*)out)[o] = __fmaf_rn(-(float)cap, __frcp_rn((float)N), 1.0f);
    } else if (MODE == 1) {
        const int wt = cap >= cap_thr;
        ((uint8_t*)out)[o] = (uint8_t)(wt + (wt && cap >= cap_early));
    } else if (MODE == 2) {
        ((uint8_t*)out)[o] = (uint8_t)cap;
    } else {
        ((int32_t*)out)[o] = cap;
    }
}

__global__ void minhash_assign_kernel(const int32_t* __restrict__ qs,
                                      int64_t Q,
                                      const int32_t* __restrict__ rs,
                                      int64_t n_reps, int N, int cap_thr,
                                      int64_t* __restrict__ best_out,
                                      uint8_t* __restrict__ ok_out) {
    extern __shared__ int32_t smem[];
    int32_t* sq = smem;
    int32_t* sr = smem + CT_TQ * N;
    __shared__ int red_cap[CT_THREADS];
    __shared__ int64_t red_idx[CT_THREADS];
    const int64_t q0 = (int64_t)blockIdx.x * CT_TQ;
    const int tq = threadIdx.x / CT_TR, tr = threadIdx.x % CT_TR;
    const int64_t q = q0 + tq;
    stage_rows(sq, qs, q0, CT_TQ, Q, N);
    int best_cap = -1;
    int64_t best_idx = INT64_MAX;
    for (int64_t r0 = 0; r0 < n_reps; r0 += CT_TR) {
        __syncthreads();
        stage_rows(sr, rs, r0, CT_TR, n_reps, N);
        __syncthreads();
        const int64_t r = r0 + tr;
        if (q < Q && r < n_reps) {
            const int cap = capped_count(sq + tq * N, sr + tr * N, N);
            // lanes visit their representatives in increasing order, so
            // a strict > keeps the first index of a tie
            if (cap > best_cap) {
                best_cap = cap;
                best_idx = r;
            }
        }
    }
    red_cap[threadIdx.x] = best_cap;
    red_idx[threadIdx.x] = best_idx;
    __syncthreads();
    if (tr != 0 || q >= Q) return;
    for (int l = 1; l < CT_TR; ++l) {
        const int c = red_cap[threadIdx.x + l];
        const int64_t i = red_idx[threadIdx.x + l];
        if (c > best_cap || (c == best_cap && i < best_idx)) {
            best_cap = c;
            best_idx = i;
        }
    }
    // no representative: every masked cap is -1 and argmax gives 0
    best_out[q] = best_cap < 0 ? 0 : best_idx;
    ok_out[q] = best_cap >= cap_thr;
}

// Dynamic shared memory above the 48 KB default needs the opt-in; the
// wrapper keeps N within what one block can hold.
static int set_smem(const void* kernel, size_t bytes) {
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int MODE>
static int launch_pairs(const void* qs, int64_t Q, const void* rs, int64_t R,
                        int N, int cap_thr, int cap_early, void* out,
                        void* stream) {
    if (Q > 0 && R > 0) {
        // query tiles ride the grid's y dimension
        if (ct_blocks(Q, CT_TQ) > 65535) return (int)cudaErrorInvalidValue;
        const size_t smem = (size_t)(CT_TQ + CT_TR) * N * sizeof(int32_t);
        int err = set_smem((const void*)minhash_pairs_kernel<MODE>, smem);
        if (err) return err;
        dim3 grid(ct_blocks(R, CT_TR), ct_blocks(Q, CT_TQ));
        minhash_pairs_kernel<MODE><<<grid, CT_THREADS, smem,
                                     ct_stream(stream)>>>(
            (const int32_t*)qs, Q, (const int32_t*)rs, R, N, cap_thr,
            cap_early, out);
    }
    return (int)cudaGetLastError();
}

extern "C" int ct_minhash_dists(const void* qs, int64_t Q, const void* rs,
                                int64_t R, int N, void* out, void* stream) {
    return launch_pairs<0>(qs, Q, rs, R, N, 0, 0, out, stream);
}

extern "C" int ct_minhash_codes(const void* qs, int64_t Q, const void* rs,
                                int64_t R, int N, int cap_thr, int cap_early,
                                void* out, void* stream) {
    return launch_pairs<1>(qs, Q, rs, R, N, cap_thr, cap_early, out, stream);
}

extern "C" int ct_minhash_caps(const void* qs, int64_t Q, const void* rs,
                               int64_t R, int N, int wide, void* out,
                               void* stream) {
    return wide ? launch_pairs<3>(qs, Q, rs, R, N, 0, 0, out, stream)
                : launch_pairs<2>(qs, Q, rs, R, N, 0, 0, out, stream);
}

extern "C" int ct_minhash_assign(const void* qs, int64_t Q, const void* rs,
                                 int64_t n_reps, int N, int cap_thr,
                                 void* best, void* ok, void* stream) {
    if (Q > 0) {
        const size_t smem = (size_t)(CT_TQ + CT_TR) * N * sizeof(int32_t);
        int err = set_smem((const void*)minhash_assign_kernel, smem);
        if (err) return err;
        minhash_assign_kernel<<<ct_blocks(Q, CT_TQ), CT_THREADS, smem,
                                ct_stream(stream)>>>(
            (const int32_t*)qs, Q, (const int32_t*)rs, n_reps, N, cap_thr,
            (int64_t*)best, (uint8_t*)ok);
    }
    return (int)cudaGetLastError();
}
