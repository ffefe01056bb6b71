// K3 verify_windows: window verification of (probe, alignment) pairs
// into extended, universe-local cover spans; and K6 verify_spans: the
// same windows, unmerged, in corpus coordinates.
//
// K3 replaces catch_tpu/ops/scan_instance.py _stage_c_jit (:382-530).  One
// thread per candidate walks the overlap of the probe row with the
// corpus once, byte by byte (no word-aligned gather, no pre-shifted
// probe copies, no row sort of mismatch positions).  The sentinel-padded
// mismatch positions P[0] = i_lo - 1, P[1..nm], then i_hi, arrive in
// order, so window t = [P[t] + 1, P[t+K+1]) is complete as soon as
// P[t+K+1] is known; a ring of the last K+2 positions gives its length
// and its longest exact run (the max of K+1 runs).  Windows t = 0..nm
// are emitted in order, the end index clamped to i_hi exactly as the
// JAX program pads P, so nested windows near the end come out as they
// do there.  The fast path (lcf >= probe length) and the cover
// extension, chromosome clamp and (probe * nU + universe) key follow
// :452-530.
//
// The output size is not known in advance: a count pass writes each
// candidate's span count, torch.cumsum turns the counts into offsets,
// and an emit pass recomputes and writes the spans.  This replaces the
// cap/tsw buffers and their overflow re-runs (:1142-1149).
//
// Bound on the card: one thread reads 2 x L bytes with no reuse between
// neighbouring threads' addresses (each candidate has its own
// alignment), so the kernel is bound by L1/L2 transactions, not by
// arithmetic.  A bit-parallel match mask over packed words is the next
// step for speed.
#include "common.cuh"

#define CT_KMAX 62   // largest mismatch count K the ring holds

struct VerifyParams {
    const uint8_t* mega;      // corpus codes, 0 = PAD
    const uint8_t* codes;     // probe codes [P, L] in solver order
    const int64_t* lens;      // probe lengths [P]
    const int64_t* pc;        // candidate probe ids [n]
    const int64_t* ac;        // candidate alignments [n]
    int64_t n;
    const int64_t* seq_starts;
    const int64_t* seq_ends;
    const int64_t* seq_lens;
    const int64_t* chrom_off;
    const int64_t* univ_of_seq;
    int64_t n_seqs;
    int L, K, k_seed, lcf, seed_req, fast_ok, ext;
    int64_t nU;
};

struct Span {
    int64_t key, start, end;
};

// The qualifying windows of one candidate: probe row prb against the
// corpus at alignment a (seq = mega + a) over the band [i_lo, i_hi),
// for a sequence of length n_seq and a cover threshold thres > 0.
// Calls emit(start, end) in corpus coordinates for every window, in
// order, and returns how many there were.
template <typename Emit>
__device__ int64_t enumerate_windows(const uint8_t* seq, const uint8_t* prb,
                                     int64_t a, int i_lo, int i_hi,
                                     int64_t thres, int64_t n_seq, int L,
                                     int K, int k_seed, int seed_req,
                                     int fast_ok, Emit emit) {
    const bool is_fast =
        fast_ok && (n_seq >= L || (K == 0 && n_seq >= k_seed));
    if (is_fast) {
        int nm = 0;
        for (int j = i_lo; j < i_hi; ++j) {
            uint8_t c = seq[j];
            nm += !(c == prb[j] && c > 0);
        }
        int64_t need = thres - K > k_seed ? thres - K : k_seed;
        if ((int64_t)(i_hi - i_lo - nm) >= need) {
            emit(a + i_lo, a + i_hi);
            return 1;
        }
        return 0;
    }

    const int R = K + 2;
    int ring[CT_KMAX + 2];
    int64_t n_out = 0;
    int idx = 0;                          // index of the newest P entry
    ring[0] = i_lo - 1;
    // Window t = idx - K - 1 closes when P[idx] arrives.
    auto close = [&]() {
        int t = idx - K - 1;
        if (t < 0) return;
        int left = ring[t % R];
        int right = ring[idx % R];
        if (right - left - 1 < thres) return;
        int seedmax = -1;
        for (int u = t; u < idx; ++u) {
            int run = ring[(u + 1) % R] - ring[u % R] - 1;
            seedmax = run > seedmax ? run : seedmax;
        }
        if (seedmax < seed_req) return;
        emit(left + 1 + a, right + a);
        ++n_out;
    };
    for (int j = i_lo; j < i_hi; ++j) {
        uint8_t c = seq[j];
        if (!(c == prb[j] && c > 0)) {
            ++idx;
            ring[idx % R] = j;
            close();
        }
    }
    // P[nm+1 ..] = i_hi closes windows up to t = nm.
    for (int x = 0; x <= K; ++x) {
        ++idx;
        ring[idx % R] = i_hi;
        close();
    }
    return n_out;
}

// Calls emit(span) for every qualifying span of candidate i, in order;
// returns how many there were.
template <typename Emit>
__device__ int64_t verify_candidate(const VerifyParams& v, int64_t i,
                                    Emit emit) {
    const int64_t p = v.pc[i];
    const int64_t a = v.ac[i];
    int64_t lo = 0, hi = v.n_seqs;       // searchsorted(seq_ends, a, right)
    while (lo < hi) {
        int64_t m = (lo + hi) >> 1;
        if (v.seq_ends[m] <= a) lo = m + 1; else hi = m;
    }
    const int64_t sid = lo < v.n_seqs - 1 ? lo : v.n_seqs - 1;
    const int64_t s_lo = v.seq_starts[sid];
    const int64_t s_hi = v.seq_ends[sid];
    const int64_t plen = v.lens[p];
    const int64_t start = a > s_lo ? a : s_lo;
    const int64_t en = s_hi < a + plen ? s_hi : a + plen;
    const int64_t n_seq = s_hi - s_lo;
    int64_t thres = v.lcf < plen ? v.lcf : plen;
    thres = thres < n_seq ? thres : n_seq;
    if (thres <= 0) return 0;
    // band [i_lo, i_hi) relative to the alignment a
    const int i_lo = (int)(start - a);
    const int i_hi = en - a > i_lo ? (int)(en - a) : i_lo;

    const int64_t base = v.seq_starts[sid];
    const int64_t seq_len = v.seq_lens[sid];
    const int64_t coff = v.chrom_off[sid];
    const int64_t key = p * v.nU + v.univ_of_seq[sid];
    return enumerate_windows(
        v.mega + a, v.codes + p * (int64_t)v.L, a, i_lo, i_hi, thres, n_seq,
        v.L, v.K, v.k_seed, v.seed_req, v.fast_ok,
        [&](int64_t sp_s, int64_t sp_e) {
            int64_t es = sp_s - base - v.ext;
            int64_t ee = sp_e - base + v.ext;
            es = es > 0 ? es : 0;
            ee = ee < seq_len ? ee : seq_len;
            emit(Span{key, es + coff, ee + coff});
        });
}

__global__ void verify_count_kernel(VerifyParams v,
                                    int64_t* __restrict__ counts) {
    int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= v.n) return;
    counts[i] = verify_candidate(v, i, [](const Span&) {});
}

__global__ void verify_emit_kernel(VerifyParams v,
                                   const int64_t* __restrict__ off_incl,
                                   int64_t* __restrict__ key,
                                   int64_t* __restrict__ s,
                                   int64_t* __restrict__ e) {
    int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= v.n) return;
    int64_t o = i ? off_incl[i - 1] : 0;
    verify_candidate(v, i, [&](const Span& sp) {
        key[o] = sp.key;
        s[o] = sp.start;
        e[o] = sp.end;
        ++o;
    });
}

static VerifyParams make_params(
        const void* mega, const void* codes, const void* lens,
        const void* pc, const void* ac, int64_t n, const void* seq_starts,
        const void* seq_ends, const void* seq_lens, const void* chrom_off,
        const void* univ_of_seq, int64_t n_seqs, int L, int K, int k_seed,
        int lcf, int seed_req, int fast_ok, int ext, int64_t nU) {
    VerifyParams v;
    v.mega = (const uint8_t*)mega;
    v.codes = (const uint8_t*)codes;
    v.lens = (const int64_t*)lens;
    v.pc = (const int64_t*)pc;
    v.ac = (const int64_t*)ac;
    v.n = n;
    v.seq_starts = (const int64_t*)seq_starts;
    v.seq_ends = (const int64_t*)seq_ends;
    v.seq_lens = (const int64_t*)seq_lens;
    v.chrom_off = (const int64_t*)chrom_off;
    v.univ_of_seq = (const int64_t*)univ_of_seq;
    v.n_seqs = n_seqs;
    v.L = L;
    v.K = K;
    v.k_seed = k_seed;
    v.lcf = lcf;
    v.seed_req = seed_req;
    v.fast_ok = fast_ok;
    v.ext = ext;
    v.nU = nU;
    return v;
}

extern "C" int ct_verify_count(
        const void* mega, const void* codes, const void* lens,
        const void* pc, const void* ac, int64_t n, const void* seq_starts,
        const void* seq_ends, const void* seq_lens, const void* chrom_off,
        const void* univ_of_seq, int64_t n_seqs, int L, int K, int k_seed,
        int lcf, int seed_req, int fast_ok, int ext, int64_t nU,
        void* counts, void* stream) {
    if (K < 0 || K > CT_KMAX) return (int)cudaErrorInvalidValue;
    if (n > 0) {
        VerifyParams v = make_params(mega, codes, lens, pc, ac, n,
                                     seq_starts, seq_ends, seq_lens,
                                     chrom_off, univ_of_seq, n_seqs, L, K,
                                     k_seed, lcf, seed_req, fast_ok, ext,
                                     nU);
        verify_count_kernel<<<ct_blocks(n, 128), 128, 0,
                              ct_stream(stream)>>>(v, (int64_t*)counts);
    }
    return (int)cudaGetLastError();
}

extern "C" int ct_verify_emit(
        const void* mega, const void* codes, const void* lens,
        const void* pc, const void* ac, int64_t n, const void* seq_starts,
        const void* seq_ends, const void* seq_lens, const void* chrom_off,
        const void* univ_of_seq, int64_t n_seqs, int L, int K, int k_seed,
        int lcf, int seed_req, int fast_ok, int ext, int64_t nU,
        const void* off_incl, void* key, void* s, void* e, void* stream) {
    if (K < 0 || K > CT_KMAX) return (int)cudaErrorInvalidValue;
    if (n > 0) {
        VerifyParams v = make_params(mega, codes, lens, pc, ac, n,
                                     seq_starts, seq_ends, seq_lens,
                                     chrom_off, univ_of_seq, n_seqs, L, K,
                                     k_seed, lcf, seed_req, fast_ok, ext,
                                     nU);
        verify_emit_kernel<<<ct_blocks(n, 128), 128, 0,
                             ct_stream(stream)>>>(
            v, (const int64_t*)off_incl, (int64_t*)key, (int64_t*)s,
            (int64_t*)e);
    }
    return (int)cudaGetLastError();
}

// ----------------------------------------------------------------------
// K6 verify_spans
// ----------------------------------------------------------------------

struct SpanParams {
    const uint8_t* mega;      // corpus codes, 0 = PAD
    const uint8_t* codes;     // probe codes [P, L]
    const int64_t* pg;        // candidate probe ids [n]
    const int64_t* start;     // clipped span start, corpus coordinates
    const int64_t* poff0;     // offset of start into the probe
    const int64_t* ov;        // overlap length
    const int64_t* thres;     // cover length threshold
    const int64_t* n_seq;     // length of the candidate's sequence
    int64_t n;
    int L, K, k_seed, seed_req, fast_ok;
};

template <typename Emit>
__device__ int64_t span_candidate(const SpanParams& v, int64_t i,
                                  Emit emit) {
    const int64_t thres = v.thres[i];
    if (thres <= 0) return 0;
    const int64_t p = v.pg[i];
    const int i_lo = (int)v.poff0[i];
    const int64_t a = v.start[i] - i_lo;
    return enumerate_windows(
        v.mega + a, v.codes + p * (int64_t)v.L, a, i_lo,
        i_lo + (int)v.ov[i], thres, v.n_seq[i], v.L, v.K, v.k_seed,
        v.seed_req, v.fast_ok,
        [&](int64_t sp_s, int64_t sp_e) { emit(Span{p, sp_s, sp_e}); });
}

__global__ void verify_spans_count_kernel(SpanParams v,
                                          int64_t* __restrict__ counts) {
    int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= v.n) return;
    counts[i] = span_candidate(v, i, [](const Span&) {});
}

__global__ void verify_spans_emit_kernel(SpanParams v,
                                         const int64_t* __restrict__ off_incl,
                                         int64_t* __restrict__ p,
                                         int64_t* __restrict__ s,
                                         int64_t* __restrict__ e) {
    int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= v.n) return;
    int64_t o = i ? off_incl[i - 1] : 0;
    span_candidate(v, i, [&](const Span& sp) {
        p[o] = sp.key;
        s[o] = sp.start;
        e[o] = sp.end;
        ++o;
    });
}

static SpanParams make_span_params(
        const void* mega, const void* codes, const void* pg,
        const void* start, const void* poff0, const void* ov,
        const void* thres, const void* n_seq, int64_t n, int L, int K,
        int k_seed, int seed_req, int fast_ok) {
    SpanParams v;
    v.mega = (const uint8_t*)mega;
    v.codes = (const uint8_t*)codes;
    v.pg = (const int64_t*)pg;
    v.start = (const int64_t*)start;
    v.poff0 = (const int64_t*)poff0;
    v.ov = (const int64_t*)ov;
    v.thres = (const int64_t*)thres;
    v.n_seq = (const int64_t*)n_seq;
    v.n = n;
    v.L = L;
    v.K = K;
    v.k_seed = k_seed;
    v.seed_req = seed_req;
    v.fast_ok = fast_ok;
    return v;
}

extern "C" int ct_verify_spans_count(
        const void* mega, const void* codes, const void* pg,
        const void* start, const void* poff0, const void* ov,
        const void* thres, const void* n_seq, int64_t n, int L, int K,
        int k_seed, int seed_req, int fast_ok, void* counts, void* stream) {
    if (K < 0 || K > CT_KMAX) return (int)cudaErrorInvalidValue;
    if (n > 0) {
        SpanParams v = make_span_params(mega, codes, pg, start, poff0, ov,
                                        thres, n_seq, n, L, K, k_seed,
                                        seed_req, fast_ok);
        verify_spans_count_kernel<<<ct_blocks(n, 128), 128, 0,
                                    ct_stream(stream)>>>(v, (int64_t*)counts);
    }
    return (int)cudaGetLastError();
}

extern "C" int ct_verify_spans_emit(
        const void* mega, const void* codes, const void* pg,
        const void* start, const void* poff0, const void* ov,
        const void* thres, const void* n_seq, int64_t n, int L, int K,
        int k_seed, int seed_req, int fast_ok, const void* off_incl,
        void* p, void* s, void* e, void* stream) {
    if (K < 0 || K > CT_KMAX) return (int)cudaErrorInvalidValue;
    if (n > 0) {
        SpanParams v = make_span_params(mega, codes, pg, start, poff0, ov,
                                        thres, n_seq, n, L, K, k_seed,
                                        seed_req, fast_ok);
        verify_spans_emit_kernel<<<ct_blocks(n, 128), 128, 0,
                                   ct_stream(stream)>>>(
            v, (const int64_t*)off_incl, (int64_t*)p, (int64_t*)s,
            (int64_t*)e);
    }
    return (int)cudaGetLastError();
}
