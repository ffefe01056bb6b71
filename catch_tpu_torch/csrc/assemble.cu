// K10 assemble: the device solver's boundary-indexed arrays from the
// merged instance (stage E).
//
// Replaces catch_tpu/ops/scan_instance.py _assemble_jit (:712-751).  The
// merged rows (key = set * nU + universe, universe-local start, end) are
// sorted by key.  One single-pass kernel over tiles of AS_TILE rows:
//   - each row is read once (16-byte loads of two rows where aligned)
//     and writes its global coordinates (local + offsets[universe],
//     int32);
//   - a row whose key differs from the previous row's starts a pair.  A
//     warp numbers its 64 rows' pair starts by two ballots; the tile's 32
//     chunks are scanned by one warp, and the pairs before the tile come
//     from lookback.cuh's ticketed decoupled look-back over the earlier
//     tiles' values.  No flag array and no pair numbering go to device
//     memory;
//   - a pair's first row writes univ_of_pair[p] = key % nU and
//     pair_bounds[p] = row; a pair's first row whose set key / nU differs
//     from the previous row's fills set_bounds[s] = p for every set s in
//     (previous set, this set], so sets with no pairs get the next pair,
//     as a left-side search of the pairs' sets would;
//   - the per-set maxima (pair count, interval count) are taken where a
//     set ends: at the next set's first row, or after the last row.  The
//     set's first row may lie in an earlier tile, so the scanned value of
//     a range of rows is (pair starts in it, its last set-first row, that
//     row's pair number from the range's start), an associative
//     "the later set start wins" operator;
//   - the last row writes pair_bounds[P] = n, fills set_bounds up to S
//     with P, and stores P; the maxima go in by one atomicMax a block.
// The caller zeroes the ticket, the three results (P, max pairs, max
// intervals a set) and the look-back state with one memset and reads the
// results back once.  The maxima are over the real sets only; the port
// does not pad the instance.
//
// Bound on the card: device-memory bandwidth (three 8-byte reads and two
// 4-byte writes a row, 8 bytes a pair and 4 a set written).
#include "lookback.cuh"

#define AS_THREADS 256
#define AS_PIECES 4                              // two-row pieces a thread
#define AS_TILE (AS_THREADS * AS_PIECES * 2)     // 2048 rows a tile
#define AS_WARPS (AS_THREADS / 32)
#define AS_CHUNKS (AS_TILE / 64)                 // a warp's 64 rows

namespace {

// A range of rows: v[0] pair starts in it, v[1] its last set-first row
// (-1 if none), v[2] that row's pair number counted from the range's
// first row.
struct SegOp {
    __device__ LbVal<3> identity() const { return {{0, -1, 0}}; }
    __device__ LbVal<3> operator()(const LbVal<3>& a,
                                   const LbVal<3>& b) const {
        return b.v[1] >= 0 ? LbVal<3>{{a.v[0] + b.v[0], b.v[1],
                                       a.v[0] + b.v[2]}}
                           : LbVal<3>{{a.v[0] + b.v[0], a.v[1], a.v[2]}};
    }
};

// set_bounds[s] = p for every s in (lo, hi], clipped to [0, S].
__device__ __forceinline__ void fill_sets(int* __restrict__ set_bounds,
                                          int64_t lo, int64_t hi, int64_t S,
                                          int p) {
    const int64_t last = hi < S ? hi : S;
    for (int64_t s = lo + 1 > 0 ? lo + 1 : 0; s <= last; ++s)
        set_bounds[s] = p;
}

__global__ void __launch_bounds__(AS_THREADS)
as_kernel(const int64_t* __restrict__ key, const int64_t* __restrict__ start,
          const int64_t* __restrict__ end, int64_t n,
          const int64_t* __restrict__ offsets, int64_t nU, int64_t S,
          int vec, int* __restrict__ gs, int* __restrict__ ge,
          int* __restrict__ pair_bounds, int* __restrict__ univ_of_pair,
          int* __restrict__ set_bounds, int* ws, int64_t nt) {
    __shared__ LbVal<3> chunk[AS_CHUNKS];
    __shared__ LbVal<3> tile_agg;
    __shared__ int warp_mp[AS_WARPS], warp_mi[AS_WARPS];
    const int64_t tile = lb_ticket(ws);
    const LbTiles<3> st(ws + 4, nt);
    const SegOp op;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const unsigned lt = (1u << lane) - 1;
    const int64_t t0 = tile * AS_TILE;

    int64_t r0[AS_PIECES];
    int q0[AS_PIECES], q1[AS_PIECES], qp[AS_PIECES];
    int u0[AS_PIECES], u1[AS_PIECES];
    bool f0[AS_PIECES], f1[AS_PIECES], g0[AS_PIECES], g1[AS_PIECES];
    int ex[AS_PIECES];
#pragma unroll
    for (int j = 0; j < AS_PIECES; ++j) {
        // Piece j of warp w is chunk 8j + w: rows t0 + 64 (8j + w) +
        // 2 lane and the row after.
        const int64_t r = t0 + 2 * (threadIdx.x + (int64_t)AS_THREADS * j);
        r0[j] = r;
        int64_t k0 = -1, k1 = -1, s0 = 0, s1 = 0, e0 = 0, e1 = 0;
        const bool both = r + 1 < n;
        if (vec && both) {
            const longlong2 kk =
                *reinterpret_cast<const longlong2*>(key + r);
            const longlong2 ss =
                *reinterpret_cast<const longlong2*>(start + r);
            const longlong2 ee =
                *reinterpret_cast<const longlong2*>(end + r);
            k0 = kk.x; k1 = kk.y; s0 = ss.x; s1 = ss.y; e0 = ee.x; e1 = ee.y;
        } else {
            if (r < n) { k0 = key[r]; s0 = start[r]; e0 = end[r]; }
            if (both) {
                k1 = key[r + 1]; s1 = start[r + 1]; e1 = end[r + 1];
            }
        }
        q0[j] = k0 >= 0 ? (int)(k0 / nU) : -1;
        q1[j] = k1 >= 0 ? (int)(k1 / nU) : -1;
        u0[j] = k0 >= 0 ? (int)(k0 - (int64_t)q0[j] * nU) : 0;
        u1[j] = k1 >= 0 ? (int)(k1 - (int64_t)q1[j] * nU) : 0;
        if (both) {
            const int64_t o0 = offsets[u0[j]], o1 = offsets[u1[j]];
            *reinterpret_cast<int2*>(gs + r) =
                make_int2((int)(s0 + o0), (int)(s1 + o1));
            *reinterpret_cast<int2*>(ge + r) =
                make_int2((int)(e0 + o0), (int)(e1 + o1));
        } else if (r < n) {
            const int64_t o0 = offsets[u0[j]];
            gs[r] = (int)(s0 + o0);
            ge[r] = (int)(e0 + o0);
        }
        // The previous row's key and set: the lane before's second row,
        // or for lane 0 a load (the row is in L1 or L2).
        int64_t kp = __shfl_up_sync(CT_LB_FULL, k1, 1);
        int qprev = __shfl_up_sync(CT_LB_FULL, q1[j], 1);
        if (lane == 0) {
            kp = r > 0 && r <= n ? key[r - 1] : -1;
            qprev = kp >= 0 ? (int)(kp / nU) : -1;
        }
        qp[j] = qprev;
        f0[j] = r < n && k0 != kp;
        f1[j] = both && k1 != k0;
        g0[j] = f0[j] && q0[j] != qprev;
        g1[j] = f1[j] && q1[j] != q0[j];
        const unsigned b0 = __ballot_sync(CT_LB_FULL, f0[j]);
        const unsigned b1 = __ballot_sync(CT_LB_FULL, f1[j]);
        ex[j] = __popc(b0 & lt) + __popc(b1 & lt);
        const int mine = g1[j] ? 2 * lane + 1 : g0[j] ? 2 * lane : -1;
        const int last = __reduce_max_sync(CT_LB_FULL, mine);
        if (lane == 0) {
            int p = 0;
            if (last >= 0) {
                const int l = last >> 1;
                const unsigned m = (1u << l) - 1;
                p = __popc(b0 & m) + __popc(b1 & m)
                    + ((last & 1) ? (int)((b0 >> l) & 1) : 0);
            }
            chunk[AS_WARPS * j + warp] = LbVal<3>{{
                __popc(b0) + __popc(b1),
                last >= 0 ? (int)(r + last) : -1, p}};
        }
    }
    __syncthreads();

    // One warp: the chunks' exclusive values within the tile and the
    // tile's aggregate; then the block: the tile's exclusive value from
    // the look-back.
    if (warp == 0) {
        LbVal<3> x = chunk[lane];
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            LbVal<3> y;
#pragma unroll
            for (int w = 0; w < 3; ++w)
                y.v[w] = __shfl_up_sync(CT_LB_FULL, x.v[w], d);
            if (lane >= d) x = op(y, x);
        }
        LbVal<3> before;
#pragma unroll
        for (int w = 0; w < 3; ++w) {
            tile_agg.v[w] = __shfl_sync(CT_LB_FULL, x.v[w], 31);
            before.v[w] = __shfl_up_sync(CT_LB_FULL, x.v[w], 1);
        }
        chunk[lane] = lane > 0 ? before : op.identity();
        if (lane == 0) st.publish(tile, tile_agg, tile == 0);
    }
    __syncthreads();
    LbVal<3> carry = op.identity();
    if (tile > 0) {
        carry = st.exclusive(tile, op);
        if (threadIdx.x == 0) st.publish(tile, op(carry, tile_agg), true);
    }

    int mp = 0, mi = 0;
#pragma unroll
    for (int j = 0; j < AS_PIECES; ++j) {
        const int64_t r = r0[j];
        // The state before the chunk's first row: its pair number, and
        // the last set-first row before it with its pair number.
        const LbVal<3> b = op(carry, chunk[AS_WARPS * j + warp]);
        const int p0 = b.v[0] + ex[j];
        const int p1 = p0 + f0[j];
        if (f0[j]) { univ_of_pair[p0] = u0[j]; pair_bounds[p0] = (int)r; }
        if (f1[j]) { univ_of_pair[p1] = u1[j]; pair_bounds[p1] = (int)r + 1; }
        // The last set-first row of the earlier lanes of the chunk, as
        // (row - chunk's first row) * 64 + pairs before it in the chunk.
        int x = g1[j] ? ((2 * lane + 1) << 6 | (ex[j] + f0[j]))
                      : g0[j] ? ((2 * lane) << 6 | ex[j]) : -1;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int y = __shfl_up_sync(CT_LB_FULL, x, d);
            if (lane >= d) x = max(x, y);
        }
        int prev = __shfl_up_sync(CT_LB_FULL, x, 1);
        if (lane == 0) prev = -1;
        int64_t sr = b.v[1];
        int sp = b.v[2];
        if (prev >= 0) {
            sr = r - 2 * lane + (prev >> 6);
            sp = b.v[0] + (prev & 63);
        }
        if (g0[j]) {
            if (r > 0) {
                mp = max(mp, p0 - sp);
                mi = max(mi, (int)(r - sr));
            }
            fill_sets(set_bounds, qp[j], q0[j], S, p0);
            sr = r;
            sp = p0;
        }
        if (g1[j]) {
            mp = max(mp, p1 - sp);
            mi = max(mi, (int)(r + 1 - sr));
            fill_sets(set_bounds, q0[j], q1[j], S, p1);
            sr = r + 1;
            sp = p1;
        }
        if (r == n - 1 || r + 1 == n - 1) {
            const bool second = r + 1 == n - 1;
            const int P = second ? p1 + f1[j] : p0 + f0[j];
            mp = max(mp, P - sp);
            mi = max(mi, (int)(n - sr));
            fill_sets(set_bounds, second ? q1[j] : q0[j], S, S, P);
            pair_bounds[P] = (int)n;
            ws[1] = P;
        }
    }
    mp = __reduce_max_sync(CT_LB_FULL, mp);
    mi = __reduce_max_sync(CT_LB_FULL, mi);
    if (lane == 0) { warp_mp[warp] = mp; warp_mi[warp] = mi; }
    __syncthreads();
    if (threadIdx.x == 0) {
        for (int w = 1; w < AS_WARPS; ++w) {
            mp = max(mp, warp_mp[w]);
            mi = max(mi, warp_mi[w]);
        }
        if (mp > 0) atomicMax(&ws[2], mp);
        if (mi > 0) atomicMax(&ws[3], mi);
    }
}

}  // namespace

// ws: 4 + lb_ints(ceil(n / AS_TILE), 3) ints: the ticket, then P, the
// largest pair count and the largest interval count of a set, then the
// look-back state.  vec: key, start and end are 16-byte aligned.
extern "C" int ct_assemble(const void* key, const void* start,
                           const void* end, int64_t n, const void* offsets,
                           int64_t nU, int64_t S, int vec, void* gs, void* ge,
                           void* pair_bounds, void* univ_of_pair,
                           void* set_bounds, void* ws, void* stream) {
    cudaStream_t st = ct_stream(stream);
    const int64_t nt = (n + AS_TILE - 1) / AS_TILE;
    cudaMemsetAsync(ws, 0, (4 + lb_ints(nt, 3)) * sizeof(int), st);
    if (n <= 0) {
        cudaMemsetAsync(set_bounds, 0, (S + 1) * sizeof(int), st);
        cudaMemsetAsync(pair_bounds, 0, sizeof(int), st);
        return (int)cudaGetLastError();
    }
    as_kernel<<<(unsigned)nt, AS_THREADS, 0, st>>>(
        (const int64_t*)key, (const int64_t*)start, (const int64_t*)end, n,
        (const int64_t*)offsets, nU, S, vec, (int*)gs, (int*)ge,
        (int*)pair_bounds, (int*)univ_of_pair, (int*)set_bounds, (int*)ws,
        nt);
    return (int)cudaGetLastError();
}
