// K2 lookup_expand: the distinct (probe, alignment) pairs of the sample
// hashes, as a probe-major merge join.
//
// Replaces catch_tpu/ops/scan_instance.py _lookup_jit/_lookup_core
// (:217-272), _expand_hits_jit (:293-338) and the dedup of
// _dedup_pairs_jit (:341-360).  The TPU version (and this port's first
// one) expanded every raw hit, sample by sample, into a buffer and
// sorted it: on ebola175 30.6 M raw hits for 3.54 M distinct pairs, so
// the sort of the hits and its scratch (about 1 GB) set the time and
// the scan's peak memory.
//
// Here the plan is inverted and no raw hit is ever stored.  The
// wrapper sorts the call's n_q sample hashes with their ids
// (torch.sort, stable: equal hashes keep ascending ids); then one C
// call (ct_le_merge, emit = 0) packs them into 32-bit words and runs
// the counting pass over the probe-major seed table of stage T
// (csrc/rolling_hash.cu ct_seed_table: probe p's entries offset << 32 |
// hash in the first cnt[p] of its W slots), which it reads as it is.
// One warp per probe finds, for every offset of the
// probe, its run of equal hashes among the sorted samples by binary
// search (the top levels from a shared-memory sample of every
// stride-th hash, the rest from L2), and merges the runs: a run's
// alignments id * s + bias (bias = sample0 * s - offset) ascend with
// the ids, so the probe's pairs
// are a k-way merge of its offsets' runs.  A step takes the warp's
// minimum head (__reduce_min_sync on 32-bit alignments) and advances
// every head equal to it, which is the dedup; steps = distinct pairs,
// not raw hits.  The counting pass sizes the output (one host read of
// the total); the emit pass (ct_le_merge, emit = 1) reuses the runs it
// found and writes each probe's pairs at its offset, staged one per
// lane and stored 32 at a time.  A lane holds its
// offsets' heads in registers (2, 4 or 8 slots, from the table's row
// width W), with the next sample id of each loaded one advance ahead; a
// probe with more offsets than its warp's slots keeps them in scratch
// of one entry per table slot, so a probe may have any number of
// offsets and a run any length.
//
// Bound on the card: the bytes are small (the table, the samples, 16
// bytes a distinct pair); the time is the merge's dependent steps, two
// passes of one warp-wide minimum per distinct pair and the load of
// each advancing head's next sample id.  A probe's pairs are one a
// genome, and each advances the same ten or so offsets, so the load
// issued at one step is awaited at the next; running every probe warp
// the card holds at once, each taking the next probe as it ends, hides
// part of it (an L1 prefetch of the runs ahead of the cursors was
// measured slower).
#include "common.cuh"
#include "scan.cuh"

#include <climits>

#define LE_WARPS 8                  // warps (probes in flight) a block
#define LE_CACHE 2048               // sampled hashes kept in shared memory

// Sorted samples as 32-bit words and ids.
__global__ void le_pack_samples_kernel(const int64_t* __restrict__ qs,
                                       const int64_t* __restrict__ qi,
                                       int64_t n_q, uint32_t* __restrict__ sh,
                                       int32_t* __restrict__ sid) {
    int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n_q) {
        sh[i] = (uint32_t)qs[i];
        sid[i] = (int32_t)qi[i];
    }
}

// First index i in [0, n) with sh[i] >= h (UPPER: sh[i] > h), the top
// levels from the shared-memory sample cache[j] = sh[j * stride].
template <bool UPPER>
__device__ __forceinline__ int le_search(const uint32_t* __restrict__ sh,
                                         int n, const uint32_t* cache,
                                         int n_cache, int stride,
                                         uint32_t h) {
    int a = 0, b = n_cache;
    while (a < b) {
        int m = (a + b) >> 1;
        bool right = UPPER ? cache[m] <= h : cache[m] < h;
        if (right) a = m + 1; else b = m;
    }
    int lo = a == 0 ? 0 : (a - 1) * stride + 1;
    const int64_t top = (int64_t)a * stride;
    int hi = top < n ? (int)top : n;
    while (lo < hi) {
        int m = (lo + hi) >> 1;
        uint32_t v = __ldg(sh + m);
        bool right = UPPER ? v <= h : v < h;
        if (right) lo = m + 1; else hi = m;
    }
    return lo;
}

// What one merge pass reads and writes.
struct LeArgs {
    const uint32_t* sh;        // sorted sample hashes
    const int32_t* sid;        // their sample ids
    int n_q, stride, s;
    const int64_t* ent;        // the seed table: offset << 32 | hash
    const int32_t* cnt;        // entries of each probe
    int64_t width;             // slots of a probe in ent
    int64_t n_probes;
    int base;                  // sample0 * s: bias = base - offset
    int32_t* head;             // one entry per slot: the scratch path's
    int32_t* cur;              // heads and run cursors and ends; the
    int32_t* end;              // register path's runs, counting to emit
    int64_t* pair_cnt;
    const int64_t* pair_incl;
    int64_t* p_out;
    int64_t* a_out;
    unsigned long long* next;  // the next probe to take (starts at 0)
};

// One probe's output: EMIT = 0 counts; EMIT = 1 stages the k-th pair
// in lane k % 32 and stores 32 at a time, coalesced.
template <int EMIT>
struct LeOut {
    int64_t p, out, k;
    int staged;

    __device__ void push(int m, int lane, const LeArgs& g) {
        if (EMIT) {
            if ((k & 31) == lane) staged = m;
            if ((k & 31) == 31) {
                g.p_out[out + k - 31 + lane] = p;
                g.a_out[out + k - 31 + lane] = staged;
            }
        }
        ++k;
    }

    __device__ void flush(int lane, const LeArgs& g) {
        const int rest = (int)(k & 31);
        if (EMIT && lane < rest) {
            g.p_out[out + k - rest + lane] = p;
            g.a_out[out + k - rest + lane] = staged;
        }
    }
};

// The merge of a probe of at most 32 * J offsets, lane l holding
// offsets e0 + l + 32 j in registers: head, run cursor and end, bias,
// and the next sample id of the run, loaded one advance ahead.
template <int J, int EMIT>
__device__ void le_merge_regs(const LeArgs& g, const uint32_t* cache,
                              int n_cache, int64_t e0, int64_t e1, int lane,
                              LeOut<EMIT>& o) {
    int hd[J], cu[J], en[J], bi[J], nx[J];
    int mine = INT_MAX;
#pragma unroll
    for (int j = 0; j < J; ++j) {
        const int64_t e = e0 + lane + 32 * j;
        hd[j] = INT_MAX;
        cu[j] = en[j] = bi[j] = nx[j] = 0;
        if (e < e1) {
            const int64_t x = g.ent[e];
            int lo, hi;
            if (EMIT) {           // the counting pass found the runs
                lo = g.cur[e];
                hi = g.end[e];
            } else {
                const uint32_t h = (uint32_t)x;
                lo = le_search<false>(g.sh, g.n_q, cache, n_cache, g.stride,
                                      h);
                hi = le_search<true>(g.sh, g.n_q, cache, n_cache, g.stride,
                                     h);
                g.cur[e] = lo;
                g.end[e] = hi;
            }
            bi[j] = g.base - (int)(x >> 32);
            cu[j] = lo;
            en[j] = hi;
            if (lo < hi) hd[j] = __ldg(g.sid + lo) * g.s + bi[j];
            if (lo + 1 < hi) nx[j] = __ldg(g.sid + lo + 1);
        }
        mine = min(mine, hd[j]);
    }
    while (true) {
        const int m = __reduce_min_sync(0xffffffffu, mine);
        if (m == INT_MAX) break;
        o.push(m, lane, g);
        if (mine == m) {          // advance every head equal to m
            mine = INT_MAX;
#pragma unroll
            for (int j = 0; j < J; ++j) {
                if (hd[j] == m) {
                    const int c = ++cu[j];
                    hd[j] = c < en[j] ? nx[j] * g.s + bi[j] : INT_MAX;
                    if (c + 1 < en[j]) nx[j] = __ldg(g.sid + c + 1);
                }
                mine = min(mine, hd[j]);
            }
        }
    }
}

// An entry's bias, sample0 * s - its offset.
__device__ __forceinline__ int le_bias(const LeArgs& g, int64_t e) {
    return g.base - (int)(g.ent[e] >> 32);
}

// The same merge for a probe of any number of offsets, their state in
// the scratch arrays (one entry per table slot).
template <int EMIT>
__device__ void le_merge_scratch(const LeArgs& g, const uint32_t* cache,
                                 int n_cache, int64_t e0, int64_t e1,
                                 int lane, LeOut<EMIT>& o) {
    int mine = INT_MAX;
    for (int64_t e = e0 + lane; e < e1; e += 32) {
        const uint32_t h = (uint32_t)g.ent[e];
        const int lo = le_search<false>(g.sh, g.n_q, cache, n_cache,
                                        g.stride, h);
        const int hi = le_search<true>(g.sh, g.n_q, cache, n_cache,
                                       g.stride, h);
        const int v = lo < hi ? __ldg(g.sid + lo) * g.s + le_bias(g, e)
                              : INT_MAX;
        g.head[e] = v;
        g.cur[e] = lo;
        g.end[e] = hi;
        mine = min(mine, v);
    }
    while (true) {
        const int m = __reduce_min_sync(0xffffffffu, mine);
        if (m == INT_MAX) break;
        o.push(m, lane, g);
        if (mine == m) {
            mine = INT_MAX;
            for (int64_t e = e0 + lane; e < e1; e += 32) {
                int v = g.head[e];
                if (v == m) {
                    const int c = g.cur[e] + 1;
                    v = c < g.end[e]
                        ? __ldg(g.sid + c) * g.s + le_bias(g, e) : INT_MAX;
                    g.head[e] = v;
                    g.cur[e] = c;
                }
                mine = min(mine, v);
            }
        }
    }
}

// One warp per probe, each warp taking the next probe from a counter
// (the probes' pairs vary tenfold).  EMIT = 0: pair_cnt[p] = the
// probe's distinct pairs.  EMIT = 1: write them at pair_incl[p] -
// pair_cnt[p] (pair_incl the inclusive cumsum of the counts).  A probe
// of at most 32 * J entries merges in registers, a longer one (a table
// wider than 256 slots) in scratch.
template <int J, int EMIT>
__global__ void __launch_bounds__(32 * LE_WARPS)
le_merge_kernel(const LeArgs g) {
    __shared__ uint32_t cache[LE_CACHE];
    const int n_cache = (g.n_q + g.stride - 1) / g.stride;
    for (int j = threadIdx.x; j < n_cache; j += blockDim.x)
        cache[j] = g.sh[(int64_t)j * g.stride];
    __syncthreads();

    const int lane = threadIdx.x & 31;
    while (true) {
        unsigned long long taken = 0;
        if (lane == 0) taken = atomicAdd(g.next, 1ull);
        const int64_t p = (int64_t)__shfl_sync(0xffffffffu, taken, 0);
        if (p >= g.n_probes) break;
        const int64_t e0 = p * g.width;
        const int64_t e1 = e0 + g.cnt[p];
        LeOut<EMIT> o{p, EMIT ? g.pair_incl[p] - g.pair_cnt[p] : 0, 0, 0};
        if (e1 - e0 <= 32 * J)
            le_merge_regs<J, EMIT>(g, cache, n_cache, e0, e1, lane, o);
        else
            le_merge_scratch<EMIT>(g, cache, n_cache, e0, e1, lane, o);
        o.flush(lane, g);
        if (!EMIT && lane == 0) g.pair_cnt[p] = o.k;
    }
}

template <int J, int EMIT>
static cudaError_t le_launch(const LeArgs& g, cudaStream_t st) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, le_merge_kernel<J, EMIT>, 32 * LE_WARPS, 0);
    if (err == cudaSuccess)
        err = cudaMemsetAsync(g.next, 0, sizeof(*g.next), st);
    if (err != cudaSuccess) return err;
    // every warp resident at once, then each takes probes until none
    // is left
    int64_t blocks = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
    const int64_t need = (g.n_probes + LE_WARPS - 1) / LE_WARPS;
    if (blocks > need) blocks = need;
    le_merge_kernel<J, EMIT><<<(unsigned)blocks, 32 * LE_WARPS, 0, st>>>(g);
    return cudaGetLastError();
}

template <int EMIT>
static cudaError_t le_merge(const LeArgs& g, int lane_slots,
                            cudaStream_t st) {
    if (lane_slots == 2) return le_launch<2, EMIT>(g, st);
    if (lane_slots == 4) return le_launch<4, EMIT>(g, st);
    return le_launch<8, EMIT>(g, st);
}

// The whole of lookup_expand after the sample sort, in two calls on one
// stream.  ent, cnt: the seed table of n_probes probes, width slots
// each.  ws32 (int32): sh, sid [n_q]; head, cur, end [n_probes *
// width].  ws64 (int64): pair_cnt, pair_incl [n_probes], the probe
// counter [1].
//   emit = 0: the sorted samples (qs, qi) packed, the counting pass and
//     pair_incl, whose last entry the wrapper reads;
//   emit = 1: the emit pass into p_out, a_out [that total].
// lane_slots (2, 4 or 8): offsets a lane holds in registers.
extern "C" int ct_le_merge(const void* qs, const void* qi, int64_t n_q,
                           const void* ent, const void* cnt,
                           int64_t n_probes, int64_t width, int64_t base,
                           int64_t s, int lane_slots, void* ws32, void* ws64,
                           void* p_out, void* a_out, int emit, void* stream) {
    if (lane_slots != 2 && lane_slots != 4 && lane_slots != 8)
        return (int)cudaErrorInvalidValue;
    if (n_probes <= 0 || n_q <= 0 || width <= 0)
        return (int)cudaGetLastError();
    cudaStream_t st = ct_stream(stream);
    int32_t* w32 = (int32_t*)ws32;
    const int64_t n_slots = n_probes * width;
    uint32_t* sh = (uint32_t*)w32;
    int32_t* sid = w32 + n_q;
    int32_t* head = w32 + 2 * n_q;
    int32_t* cur = head + n_slots;
    int32_t* end = cur + n_slots;
    int64_t* w64 = (int64_t*)ws64;
    int64_t* pair_cnt = w64;
    int64_t* pair_incl = w64 + n_probes;
    LeArgs g{sh, sid, (int)n_q, (int)((n_q + LE_CACHE - 1) / LE_CACHE),
             (int)s, (const int64_t*)ent, (const int32_t*)cnt, width,
             n_probes, (int)base, head, cur, end, pair_cnt, pair_incl,
             (int64_t*)p_out, (int64_t*)a_out,
             (unsigned long long*)(w64 + 2 * n_probes)};
    if (emit) return (int)le_merge<1>(g, lane_slots, st);

    le_pack_samples_kernel<<<ct_blocks(n_q, 256), 256, 0, st>>>(
        (const int64_t*)qs, (const int64_t*)qi, n_q, sh, sid);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if ((err = le_merge<0>(g, lane_slots, st)) != cudaSuccess)
        return (int)err;
    return (int)ct_scan(pair_cnt, n_probes, pair_incl, st);
}
