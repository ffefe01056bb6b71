// K5 expand_join: minimizer join hits -> deduplicated (probe, alignment)
// pairs of the span scan, as a probe-major merge join; optionally with
// the scan's keep predicate folded in.
//
// Replaces catch_tpu/ops/scan_sparse.py _expand_join_jit (:192-241).
// Its input is the host join: for every selected corpus position that
// hit the probe table, the run [lo, lo + cnt) of equal hashes in the
// table (sorted by hash) and the position itself.  The TPU program (and
// this port's first version) expanded every raw hit into a key, probe *
// 2^34 + (pos - offset + Lmax - 1), and sorted the keys; a candidate
// pair shares about 15 selected minimizers, so the sort handled about 15
// keys for each pair it kept.
//
// Here no raw hit is ever stored, as in K2 (csrc/lookup_expand.cu).
// ct_ej_keys packs each run as lo << 34 | pos (a run of no hits taking
// lo = the table's rows), the wrapper sorts the keys (torch.sort), so
// that each table run owns one ascending segment of positions; the
// table has a probe-major index, built once for each searcher and card
// (scan_sparse.join_index: for each probe, its table rows and their
// offsets).  Then one C call (ct_ej_run, emit = 0):
//   1. ej_gather: the sorted runs' lo and pos, and the largest pos (one
//      atomic a block: with one a warp the kernel took 59 us at the
//      ebola175 analysis shape on an H100);
//   2. ej_mark: the first run of each segment writes the segment's
//      bounds [b, e) (e by binary search) to every table row of its run
//      [lo, lo + cnt); the other rows keep the empty [0, 0);
//   3. ej_merge, counting: a warp per work item, each warp taking the
//      next item from a counter.  An item is a probe and one of C
//      ranges of alignments (C = 1 where the probes alone fill the card;
//      up to 64 where they are few: ebola175's analysis has 159 probes
//      of about 1,000 pairs each).  It k-way merges the segments of the
//      probe's rows, each giving alignments pos - offset in ascending
//      order, from its range's start (a binary search in each segment)
//      to its end.  A step takes the warp's minimum head (two 32-bit
//      __reduce_min_sync on the 64-bit key pos + Lmax - 1 - offset) and
//      advances every head equal to it, past equal positions too (the
//      host join's slab overlap selects some positions twice): that is
//      the dedup, so the steps count distinct pairs, not raw hits.  The
//      pairs are staged one a lane; every 32 the lanes test them (the
//      keep predicate, where it is folded in) and count them with a
//      ballot;
//   4. the scan of csrc/scan.cuh: each item's output offset.
// The wrapper reads the total; the emit call (emit = 1) merges again and
// writes each item's pairs at its offset: (p, a), or with the keep
// predicate the six candidate fields of verify_spans, 32 pairs a store.
// A lane holds J of its probe's rows in registers (J = 1, 2, 4 or 8, from
// the index's widest probe), each with its head, the next position of
// its segment (loaded one advance ahead, and used only at the next), its
// cursor and end; a probe of more than 256 rows merges in one item with
// its heads in scratch of one entry a row.  So any segment length works
// (with w = 1 a frequent kj-mer gives thousands of positions), and any
// number of rows a probe.
//
// Bound on the card: the bytes are small (the runs, the index, the
// table's marks and 16 or 48 bytes a pair out); the time is the merge's
// dependent steps, a warp-wide minimum per distinct pair and the load of
// each advancing head's next position, in two passes.
#include "common.cuh"
#include "scan.cuh"

#define EJ_WARPS 8                      // warps (work items in flight) a block
#define EJ_SHIFT 34                     // the run key: lo << 34 | pos
#define EJ_GATHER_THREADS 256           // threads a block of ej_gather
#define EJ_NONE 0xFFFFFFFFFFFFFFFFull   // an exhausted head

// The runs' sort keys.
__global__ void ej_keys_kernel(const int64_t* __restrict__ lo,
                               const int64_t* __restrict__ cnt,
                               const int64_t* __restrict__ pos, int64_t n,
                               int64_t n_rows, int64_t* __restrict__ keys) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    keys[i] = ((cnt[i] > 0 ? lo[i] : n_rows) << EJ_SHIFT) | pos[i];
}

// The sorted runs' lo and pos, from the sorted keys (skey) or, where the
// wrapper sorted twice (skey null), by the order idx; and the largest
// pos, into *maxpos (0 before).
__global__ void ej_gather_kernel(const int64_t* __restrict__ skey,
                                 const int64_t* __restrict__ lo,
                                 const int64_t* __restrict__ cnt,
                                 const int64_t* __restrict__ pos,
                                 const int64_t* __restrict__ idx, int64_t n,
                                 int64_t n_rows, int64_t* __restrict__ slo,
                                 int64_t* __restrict__ spos,
                                 unsigned long long* __restrict__ maxpos) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    int64_t q = 0;
    if (i < n) {
        int64_t l;
        if (skey) {
            const int64_t k = skey[i];
            l = k >> EJ_SHIFT;
            q = k & ((1ll << EJ_SHIFT) - 1);
        } else {
            const int64_t k = idx[i];
            l = cnt[k] > 0 ? lo[k] : n_rows;
            q = pos[k];
        }
        slo[i] = l;
        spos[i] = q;
    }
    // the block's largest position, one atomic a block
    __shared__ unsigned long long warp_max[EJ_GATHER_THREADS / 32];
    unsigned long long m = q > 0 ? (unsigned long long)q : 0ull;
    for (int d = 16; d > 0; d >>= 1) {
        const unsigned long long o = __shfl_xor_sync(0xffffffffu, m, d);
        m = o > m ? o : m;
    }
    if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
    __syncthreads();
    if (threadIdx.x == 0) {
        for (int w = 1; w < EJ_GATHER_THREADS / 32; ++w)
            m = warp_max[w] > m ? warp_max[w] : m;
        atomicMax(maxpos, m);
    }
}

// Each segment's first run marks the rows of its table run with the
// segment's bounds.
__global__ void ej_mark_kernel(const int64_t* __restrict__ slo,
                               const int64_t* __restrict__ idx,
                               const int64_t* __restrict__ cnt, int64_t n,
                               int64_t n_rows, int64_t* __restrict__ seg_b,
                               int64_t* __restrict__ seg_e) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const int64_t l = slo[i];
    if (i > 0 && slo[i - 1] == l) return;
    int64_t a = i + 1, b = n;           // the first index past l's segment
    while (a < b) {
        const int64_t m = (a + b) >> 1;
        if (slo[m] <= l) a = m + 1; else b = m;
    }
    const int64_t r_end = l + cnt[idx[i]];
    const int64_t r1 = r_end < n_rows ? r_end : n_rows;
    for (int64_t r = l < 0 ? 0 : l; r < r1; ++r) {
        seg_b[r] = i;
        seg_e[r] = a;
    }
}

// The keep predicate of scan_sparse.keep_candidates, folded into the
// merge (starts null: no predicate, every pair is kept as (p, a)).
struct EjKeep {
    const int64_t* starts;     // the sequences' corpus bounds
    const int64_t* ends;
    int64_t n_seqs;
    const int64_t* plens;      // the probes' lengths
    int64_t lcf, k_seed;
};

// What one merge pass reads and writes.
struct EjArgs {
    const int64_t* spos;       // positions, sorted by (lo, pos)
    const int64_t* seg_b;      // each table row's segment [b, e)
    const int64_t* seg_e;
    const int64_t* ent_row;    // the probe-major index: each entry's row,
    const int64_t* ent_off;    // its offset,
    const int64_t* probe_end;  // and each probe's end (inclusive sums)
    int64_t n_probes;
    int64_t chunks;            // ranges of alignments a probe (C)
    const unsigned long long* maxpos;
    int64_t lmax1;             // Lmax - 1: keys pos + lmax1 - offset >= 0
    uint64_t* head;            // the scratch path's heads and cursors,
    int64_t* cur;              // one entry per index entry
    int64_t* pair_cnt;         // per item
    const int64_t* pair_incl;
    int64_t* out[6];           // (p, a), or the six candidate fields
    EjKeep keep;
    unsigned long long* next;  // the next item to take (starts at 0)
};

__device__ __forceinline__ uint64_t ej_min(uint64_t a, uint64_t b) {
    return a < b ? a : b;
}

// The warp's minimum of 64-bit keys below 2^63 (EJ_NONE where no lane
// has one).
__device__ __forceinline__ uint64_t ej_warp_min(uint64_t v) {
    const unsigned hi = __reduce_min_sync(0xffffffffu, (unsigned)(v >> 32));
    const unsigned lo = __reduce_min_sync(
        0xffffffffu, (unsigned)(v >> 32) == hi ? (unsigned)v : 0xffffffffu);
    return ((uint64_t)hi << 32) | lo;
}

// One item's output: the k-th distinct pair is staged in lane k % 32;
// every 32 (and at the end) the lanes test theirs and count the kept
// ones with a ballot; EMIT = 1 writes them from the item's offset.
template <int EMIT, int KEEP>
struct EjOut {
    int64_t p, out, kept, k, staged;

    __device__ void push(int64_t a, int lane, const EjArgs& g) {
        if ((k & 31) == lane) staged = a;
        if ((k++ & 31) == 31) group(32, lane, g);
    }

    __device__ void flush(int lane, const EjArgs& g) {
        if (k & 31) group((int)(k & 31), lane, g);
    }

    __device__ void group(int n_staged, int lane, const EjArgs& g) {
        bool ok = lane < n_staged;
        int64_t st = 0, ov = 0, thres = 0, n_seq = 0;
        if (KEEP && ok) {                  // keep_candidates, one pair
            const EjKeep& kp = g.keep;
            const int64_t a = staged;
            int64_t lo = 0, hi = kp.n_seqs;   // searchsorted(ends, a, right)
            while (lo < hi) {
                const int64_t m = (lo + hi) >> 1;
                if (kp.ends[m] <= a) lo = m + 1; else hi = m;
            }
            const int64_t sid = lo < kp.n_seqs - 1 ? lo : kp.n_seqs - 1;
            const int64_t s_lo = kp.starts[sid], s_hi = kp.ends[sid];
            const int64_t plen = kp.plens[p];
            st = s_lo > a ? s_lo : a;
            const int64_t en = s_hi < a + plen ? s_hi : a + plen;
            ov = en - st;
            n_seq = s_hi - s_lo;
            thres = plen < kp.lcf ? plen : kp.lcf;
            thres = thres < n_seq ? thres : n_seq;
            ok = ov >= (thres > kp.k_seed ? thres : kp.k_seed) && thres > 0;
        }
        const unsigned vote = __ballot_sync(0xffffffffu, ok);
        if (EMIT && ok) {
            const int64_t o = out + kept + __popc(vote & ((1u << lane) - 1));
            g.out[0][o] = p;
            if (KEEP) {
                g.out[1][o] = st;
                g.out[2][o] = st - staged;
                g.out[3][o] = ov;
                g.out[4][o] = thres;
                g.out[5][o] = n_seq;
            } else {
                g.out[1][o] = staged;
            }
        }
        kept += __popc(vote);
    }
};

// The merge of an item of at most 32 * J entries, lane l holding entries
// e0 + l + 32 j in registers: head key, the next position of its segment
// (loaded one advance ahead), cursor, end and bias; keys in [k_lo, k_hi).
template <int J, int EMIT, int KEEP>
__device__ void ej_merge_regs(const EjArgs& g, int64_t e0, int64_t e1,
                              uint64_t k_lo, uint64_t k_hi, int lane,
                              EjOut<EMIT, KEEP>& o) {
    uint64_t hd[J];
    int64_t nx[J], cu[J], en[J], bi[J];
    uint64_t mine = EJ_NONE;
#pragma unroll
    for (int j = 0; j < J; ++j) {
        const int64_t e = e0 + lane + 32 * j;
        hd[j] = EJ_NONE;
        nx[j] = cu[j] = en[j] = bi[j] = 0;
        if (e < e1) {
            const int64_t r = g.ent_row[e];
            bi[j] = g.lmax1 - g.ent_off[e];
            int64_t b = g.seg_b[r], h = g.seg_e[r];
            en[j] = h;
            const int64_t want = (int64_t)k_lo - bi[j];  // pos >= want
            while (k_lo > 0 && b < h) {
                const int64_t m = (b + h) >> 1;
                if (__ldg(g.spos + m) < want) b = m + 1; else h = m;
            }
            cu[j] = b;
            if (b < en[j]) {
                const uint64_t v = __ldg(g.spos + b) + bi[j];
                hd[j] = v < k_hi ? v : EJ_NONE;
            }
            if (b + 1 < en[j]) nx[j] = __ldg(g.spos + b + 1);
        }
        mine = ej_min(mine, hd[j]);
    }
    while (true) {
        const uint64_t m = ej_warp_min(mine);
        if (m == EJ_NONE) break;
        o.push((int64_t)m - g.lmax1, lane, g);
        if (mine == m) {          // advance every head equal to m
            mine = EJ_NONE;
#pragma unroll
            for (int j = 0; j < J; ++j) {
                while (hd[j] == m) {
                    const int64_t c = ++cu[j];
                    const uint64_t v = c < en[j] ? (uint64_t)(nx[j] + bi[j])
                                                 : EJ_NONE;
                    hd[j] = v < k_hi ? v : EJ_NONE;
                    if (c + 1 < en[j]) nx[j] = __ldg(g.spos + c + 1);
                }
                mine = ej_min(mine, hd[j]);
            }
        }
    }
}

// The same merge for a probe of any number of entries (one item: the
// whole range of alignments), their heads and cursors in scratch.
template <int EMIT, int KEEP>
__device__ void ej_merge_scratch(const EjArgs& g, int64_t e0, int64_t e1,
                                 int lane, EjOut<EMIT, KEEP>& o) {
    uint64_t mine = EJ_NONE;
    for (int64_t e = e0 + lane; e < e1; e += 32) {
        const int64_t r = g.ent_row[e];
        const int64_t b = g.seg_b[r];
        const uint64_t v = b < g.seg_e[r]
            ? __ldg(g.spos + b) + g.lmax1 - g.ent_off[e] : EJ_NONE;
        g.head[e] = v;
        g.cur[e] = b;
        mine = ej_min(mine, v);
    }
    while (true) {
        const uint64_t m = ej_warp_min(mine);
        if (m == EJ_NONE) break;
        o.push((int64_t)m - g.lmax1, lane, g);
        if (mine == m) {
            mine = EJ_NONE;
            for (int64_t e = e0 + lane; e < e1; e += 32) {
                uint64_t v = g.head[e];
                if (v == m) {
                    const int64_t r = g.ent_row[e];
                    const int64_t end = g.seg_e[r];
                    const int64_t bias = g.lmax1 - g.ent_off[e];
                    int64_t c = g.cur[e];
                    while (v == m) {
                        ++c;
                        v = c < end ? __ldg(g.spos + c) + bias : EJ_NONE;
                    }
                    g.head[e] = v;
                    g.cur[e] = c;
                }
                mine = ej_min(mine, v);
            }
        }
    }
}

// A warp per item (probe p = t / C, range c = t % C), each warp taking
// the next item from a counter.  EMIT = 0: pair_cnt[t] = the item's kept
// pairs.  EMIT = 1: write them at pair_incl[t] - pair_cnt[t].  J = 0:
// the scratch path (C = 1).
template <int J, int EMIT, int KEEP>
__global__ void __launch_bounds__(32 * EJ_WARPS)
ej_merge_kernel(const EjArgs g) {
    const int lane = threadIdx.x & 31;
    const int64_t n_items = g.n_probes * g.chunks;
    // keys lie in [0, maxpos + Lmax): C ranges of `width` keys
    const uint64_t width = (*g.maxpos + g.lmax1 + g.chunks) / g.chunks;
    while (true) {
        unsigned long long taken = 0;
        if (lane == 0) taken = atomicAdd(g.next, 1ull);
        const int64_t t = (int64_t)__shfl_sync(0xffffffffu, taken, 0);
        if (t >= n_items) break;
        const int64_t p = t / g.chunks, c = t % g.chunks;
        const int64_t e0 = p ? g.probe_end[p - 1] : 0;
        const int64_t e1 = g.probe_end[p];
        EjOut<EMIT, KEEP> o{p, EMIT ? g.pair_incl[t] - g.pair_cnt[t] : 0,
                            0, 0, 0};
        if constexpr (J > 0) {
            const uint64_t k_lo = c * width;
            const uint64_t k_hi = c + 1 < g.chunks ? k_lo + width : EJ_NONE;
            ej_merge_regs<J, EMIT, KEEP>(g, e0, e1, k_lo, k_hi, lane, o);
        } else {
            ej_merge_scratch<EMIT, KEEP>(g, e0, e1, lane, o);
        }
        o.flush(lane, g);
        if (!EMIT && lane == 0) g.pair_cnt[t] = o.kept;
    }
}

// Blocks of the merge kernel resident on the card at once (each
// instance's occupancy queried once).
template <int J, int EMIT, int KEEP>
static cudaError_t ej_launch(const EjArgs& g, cudaStream_t st) {
    static int per_sm = 0;
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err == cudaSuccess && per_sm == 0)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, ej_merge_kernel<J, EMIT, KEEP>, 32 * EJ_WARPS, 0);
    if (err == cudaSuccess)
        err = cudaMemsetAsync(g.next, 0, sizeof(*g.next), st);
    if (err != cudaSuccess) return err;
    // every warp resident at once, then each takes items until none is
    // left
    int64_t blocks = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
    const int64_t need = (g.n_probes * g.chunks + EJ_WARPS - 1) / EJ_WARPS;
    if (blocks > need) blocks = need;
    ej_merge_kernel<J, EMIT, KEEP>
        <<<(unsigned)blocks, 32 * EJ_WARPS, 0, st>>>(g);
    return cudaGetLastError();
}

template <int EMIT, int KEEP>
static cudaError_t ej_merge(const EjArgs& g, int lane_slots,
                            cudaStream_t st) {
    switch (lane_slots) {
        case 1: return ej_launch<1, EMIT, KEEP>(g, st);
        case 2: return ej_launch<2, EMIT, KEEP>(g, st);
        case 4: return ej_launch<4, EMIT, KEEP>(g, st);
        case 8: return ej_launch<8, EMIT, KEEP>(g, st);
        default: return ej_launch<0, EMIT, KEEP>(g, st);
    }
}

template <int EMIT>
static cudaError_t ej_merge_any(const EjArgs& g, int lane_slots,
                                cudaStream_t st) {
    return g.keep.starts ? ej_merge<EMIT, 1>(g, lane_slots, st)
                         : ej_merge<EMIT, 0>(g, lane_slots, st);
}

// keys (int64 [n]): the sort keys of the n runs.
extern "C" int ct_ej_keys(const void* lo, const void* cnt, const void* pos,
                          int64_t n, int64_t n_rows, void* keys,
                          void* stream) {
    if (n > 0)
        ej_keys_kernel<<<ct_blocks(n, 256), 256, 0, ct_stream(stream)>>>(
            (const int64_t*)lo, (const int64_t*)cnt, (const int64_t*)pos, n,
            n_rows, (int64_t*)keys);
    return (int)cudaGetLastError();
}

// The whole of expand_join after the sort of the runs, in two calls on
// one stream.  skey: the sorted keys of ct_ej_keys, or null where the
// wrapper sorted twice; idx: the runs' order by (lo, pos) either way; lo,
// cnt, pos: the n runs.  ent_row, ent_off, probe_end: the probe-major
// index of the table of n_rows rows and n_probes probes; chunks: the
// ranges of alignments a probe (1 with lane_slots 0).  starts, ends
// (n_seqs), plens, lcf, k_seed: the keep predicate, or starts null.  ws
// (int64): slo, spos [n]; seg_b, seg_e [n_rows]; pair_cnt, pair_incl
// [n_probes * chunks]; the item counter and the largest position [1 +
// 1]; with lane_slots 0 (a probe of more than 256 entries) the heads and
// cursors [n_rows] each.
//   emit = 0: the gather, the marks and the counting pass, and
//     pair_incl, whose last entry the wrapper reads;
//   emit = 1: the emit pass into out0..out5 [that total]: p, a, or with
//     the predicate the six candidate fields (pg, start, poff0, ov,
//     thres, n_seq).
// lane_slots (0, 1, 2, 4 or 8): entries a lane holds in registers.
extern "C" int ct_ej_run(const void* skey, const void* idx, const void* lo,
                         const void* cnt, const void* pos, int64_t n,
                         const void* ent_row, const void* ent_off,
                         const void* probe_end, int64_t n_probes,
                         int64_t n_rows, int64_t chunks, int64_t lmax,
                         int lane_slots, const void* starts,
                         const void* ends, int64_t n_seqs,
                         const void* plens, int64_t lcf, int64_t k_seed,
                         void* ws, void* out0, void* out1, void* out2,
                         void* out3, void* out4, void* out5, int emit,
                         void* stream) {
    if ((lane_slots != 0 && lane_slots != 1 && lane_slots != 2 &&
         lane_slots != 4 && lane_slots != 8) || chunks < 1 ||
        (lane_slots == 0 && chunks != 1) || (starts && n_seqs < 1))
        return (int)cudaErrorInvalidValue;
    if (n <= 0 || n_probes <= 0 || n_rows <= 0)
        return (int)cudaGetLastError();
    cudaStream_t st = ct_stream(stream);
    int64_t* w = (int64_t*)ws;
    int64_t* slo = w;
    int64_t* spos = slo + n;
    int64_t* seg_b = spos + n;
    int64_t* seg_e = seg_b + n_rows;
    int64_t* pair_cnt = seg_e + n_rows;
    int64_t* pair_incl = pair_cnt + n_probes * chunks;
    int64_t* next = pair_incl + n_probes * chunks;
    unsigned long long* maxpos = (unsigned long long*)(next + 1);
    EjArgs g{spos, seg_b, seg_e, (const int64_t*)ent_row,
             (const int64_t*)ent_off, (const int64_t*)probe_end, n_probes,
             chunks, maxpos, lmax - 1, (uint64_t*)(next + 2),
             next + 2 + n_rows, pair_cnt, pair_incl,
             {(int64_t*)out0, (int64_t*)out1, (int64_t*)out2,
              (int64_t*)out3, (int64_t*)out4, (int64_t*)out5},
             EjKeep{(const int64_t*)starts, (const int64_t*)ends, n_seqs,
                    (const int64_t*)plens, lcf, k_seed},
             (unsigned long long*)next};
    if (emit) return (int)ej_merge_any<1>(g, lane_slots, st);

    cudaError_t err = cudaMemsetAsync(maxpos, 0, sizeof(*maxpos), st);
    if (err == cudaSuccess)
        err = cudaMemsetAsync(seg_b, 0, 2 * n_rows * sizeof(int64_t), st);
    if (err != cudaSuccess) return (int)err;
    ej_gather_kernel<<<ct_blocks(n, EJ_GATHER_THREADS), EJ_GATHER_THREADS,
                       0, st>>>(
        (const int64_t*)skey, (const int64_t*)lo, (const int64_t*)cnt,
        (const int64_t*)pos, (const int64_t*)idx, n, n_rows, slo, spos,
        maxpos);
    ej_mark_kernel<<<ct_blocks(n, 256), 256, 0, st>>>(
        slo, (const int64_t*)idx, (const int64_t*)cnt, n, n_rows, seg_b,
        seg_e);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    if ((err = ej_merge_any<0>(g, lane_slots, st)) != cudaSuccess)
        return (int)err;
    return (int)ct_scan(pair_cnt, n_probes * chunks, pair_incl, st);
}
