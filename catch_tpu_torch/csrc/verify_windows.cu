// K3 verify_windows: window verification of (probe, alignment) pairs
// into extended, universe-local cover spans; and K6 verify_spans: the
// same windows, unmerged, in corpus coordinates.  Both run one core.
//
// K3 replaces catch_tpu/ops/scan_instance.py _stage_c_jit (:382-530) and
// computes what it computes.  For candidate (probe p, alignment a) the
// band [i_lo, i_hi) is the overlap of the probe with a's sequence; the
// sentinel-padded mismatch positions of probe row p against the corpus
// over it are P[0] = i_lo - 1, P[1..nm], then i_hi; window t = [P[t] + 1,
// P[t+K+1]) for t = 0..nm qualifies when it is at least thres long and
// holds an exact run of at least seed_req (the max of its K+1 runs).
// The windows of a candidate come out left to right, the end clamped to
// i_hi exactly as the JAX program pads P, so nested windows near the
// band's end come out as they do there.  The fast path (fast_ok,
// :452-460) gives one span a candidate from the match count.  Spans are
// extended, clamped to the chromosome and keyed probe * nU + universe
// (:512-530).
//
// K6 replaces catch_tpu/ops/scan_sparse.py _verify_chunk/_verify_core
// (:65-154): the same window math, but each candidate comes with its
// fields (probe, clipped start, its offset into the probe, overlap,
// threshold, sequence length), so there is no search over the
// sequences, and its spans are [a + P[t] + 1, a + P[t+K+1]) in corpus
// coordinates, not extended; its fast path gives [start, start + ov)
// where the band's matches reach max(thres - K, k_seed).
//
// What bounds it on the H100: bytes, about 16 a pair in and 24 a span
// out (ebola175: 3,540,645 pairs, 3,670,370 spans, 0.045 ms at the
// NVIDIA H100 SXM's published 3.35 TB/s, 700 W).  The 3.3 MB corpus and
// the probe rows sit in L2.  Each candidate has its own alignment, so no
// two threads of a warp share a corpus line, and the corpus comes from
// L2 a candidate at a time: about 0.1 ms of ebola175's mask kernel is
// those loads, whether a thread loads its own band or eight lanes load
// it together (tried; no faster).  So each band is walked once, wide:
//   1. the mask kernel, a thread a candidate: the corpus is read 16 bytes
//      a load at 16-aligned addresses (a byte loop took a load a byte);
//      the probe row, which the warp's candidates share (pairs come
//      sorted by probe), as aligned words realigned with __funnelshift_r.
//      Four codes are compared per instruction (a xor, then a carry-free
//      "byte is nonzero" test, which holds for any of the 255 codes and
//      keeps PAD, code 0, from matching), and a multiply folds each
//      4-byte compare into 4 bits of the mismatch mask, 32 positions a
//      word.  The first VW_KEEP words stay in registers (L <= 113), the
//      rest go to scratch.  A band with fewer than thres - K matches
//      has no window and is not walked; otherwise its words go to
//      scratch, word-major so that the stores coalesce, their set bits,
//      found with __ffs, feed the window state, and the candidate's span
//      count goes to counts.
//   2. torch.cumsum turns the counts into offsets in place, and the
//      wrapper reads the total.
//   3. the emit kernel: each candidate with spans reads its mask words
//      back (not the corpus) and walks the same state again, writing its
//      spans from its offset.  Its loads are all issued before the
//      branch on its count (both kernels wait on memory more than they
//      compute: halving their occupancy doubles their time).
// The window state holds the last K+2 entries of P.  For K <= VW_KREG
// the kernels are instantiated per K and the entries are registers,
// shifted one place a mismatch; above it (to K = 62) they are a ring of
// 64 entries a thread in shared memory, indexed with & 63.  A job type
// (VwParams for K3, VsParams for K6) gives the kernels a candidate's
// fields and writes its spans; the mask core (VwMask, vw_build,
// VwWindows, vw_feed, vw_close) is one.  A candidate's alignment and
// its base address are 64-bit; its positions from the alignment are
// 32-bit.  K3's wrapper checks that mega has fewer than 2^31 bytes (its
// keys and positions are 32-bit elsewhere); K6 takes any corpus.  Where
// a candidate's loads would reach past either end of mega or codes, it
// reads the bytes inside one by one, so the contract stays "mega
// readable at [a, a + L)".
#include "common.cuh"

#define CT_KMAX 62      // largest mismatch count K
#define VW_THREADS 128  // threads a block of the kernels
#define VW_KREG 7       // largest K whose window state is in registers
#define VW_RING 64      // entries of the shared-memory ring above it
#define VW_KEEP 4       // mask words a thread keeps in registers (L <= 113)

// What the mask core reads: the corpus and the probe rows.
struct VwSrc {
    const uint8_t* mega;      // corpus codes, 0 = PAD
    int64_t n_mega;           // its bytes
    const uint8_t* codes;     // probe codes [P, L]
    int64_t n_codes;          // its bytes
    int L;
};

// One candidate's fields; positions relative to its alignment a.
struct Cand {
    int64_t a;
    int p, sid, i_lo, i_hi, thres;
    bool fast;
};

// The band's first byte lies off bytes above a 16-aligned address; the
// mask of a band of `band` positions takes this many 32-bit words.
__device__ __forceinline__ int vw_off(const VwSrc& v, const Cand& c) {
    return (int)((uintptr_t)(v.mega + c.a + c.i_lo) & 15);
}

__device__ __forceinline__ int vw_words(int off, int band) {
    return band > 0 ? (off + band + 31) >> 5 : 0;
}

__device__ __forceinline__ uint32_t vw_below(int n) {   // bits [0, n)
    return n <= 0 ? 0u : n >= 32 ? ~0u : (1u << n) - 1u;
}

// Bytes [addr, addr + 4) as a little-endian word, reading only those in
// [lo, hi); the others read as 0.
__device__ __forceinline__ uint32_t vw_word(uintptr_t addr, uintptr_t lo,
                                            uintptr_t hi) {
    if (addr >= lo && addr + 4 <= hi)
        return __ldg(reinterpret_cast<const unsigned int*>(addr));
    uint32_t w = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b)
        if (addr + b >= lo && addr + b < hi)
            w |= (uint32_t)*reinterpret_cast<const uint8_t*>(addr + b)
                 << (8 * b);
    return w;
}

// Bytes [addr, addr + 16), addr 16-aligned, the same way.
__device__ __forceinline__ uint4 vw_quad(uintptr_t addr, uintptr_t lo,
                                         uintptr_t hi) {
    if (addr >= lo && addr + 16 <= hi)
        return __ldg(reinterpret_cast<const uint4*>(addr));
    return make_uint4(vw_word(addr, lo, hi), vw_word(addr + 4, lo, hi),
                      vw_word(addr + 8, lo, hi), vw_word(addr + 12, lo, hi));
}

// Bit b (0..3) set where byte b of c differs from byte b of p or is 0.
__device__ __forceinline__ uint32_t vw_mismatch4(uint32_t c, uint32_t p) {
    const uint32_t lo7 = 0x7F7F7F7Fu;
    const uint32_t x = c ^ p;
    const uint32_t ne = ((x & lo7) + lo7) | x;   // bit 7 of a byte: x != 0
    const uint32_t nz = ((c & lo7) + lo7) | c;   // bit 7 of a byte: c != 0
    const uint32_t m = (ne | ~nz) & 0x80808080u;
    return (m * 0x00204081u) >> 28;              // bits 7, 15, 23, 31 -> 0-3
}

// The mismatch mask of one candidate's band, a 32-bit word at a time:
// bit k of word w stands for corpus byte A0 + 32w + k, where A0 is the
// 16-aligned address off bytes below the band's first byte, so its
// position from a is i_lo - off + 32w + k.  Bits outside the band are 0.
struct VwMask {
    uintptr_t A0, m_lo, m_hi;   // the first block; mega's bytes
    uintptr_t P0, c_lo, c_hi;   // the first aligned probe word; codes' bytes
    int ps;                     // the shift that realigns the probe words
    int off, nbits;             // the band's bits are [off, nbits)
    bool inside;                // every load lies inside mega and codes
    uint32_t prev;              // the last probe word loaded

    __device__ VwMask(const VwSrc& v, const Cand& c) {
        off = vw_off(v, c);
        A0 = (uintptr_t)(v.mega + c.a + c.i_lo) - off;
        m_lo = (uintptr_t)v.mega;
        m_hi = m_lo + v.n_mega;
        const uintptr_t pb = (uintptr_t)((intptr_t)v.codes
                                         + (int64_t)c.p * v.L + c.i_lo - off);
        ps = (int)(pb & 3) * 8;
        P0 = pb & ~(uintptr_t)3;
        c_lo = (uintptr_t)v.codes;
        c_hi = c_lo + v.n_codes;
        nbits = c.i_hi > c.i_lo ? off + c.i_hi - c.i_lo : 0;
        const uintptr_t blocks = 16 * (uintptr_t)((nbits + 15) >> 4);
        inside = A0 >= m_lo && A0 + blocks <= m_hi && P0 >= c_lo
                 && P0 + blocks + 4 <= c_hi;
    }

    // Word w, for w = 0, 1, ... in turn; G: loads check the bounds.
    template <bool G>
    __device__ __forceinline__ uint32_t word(int w) {
        uint32_t out = 0;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int blk = 2 * w + h;
            if (16 * blk >= nbits) break;
            const uintptr_t a = A0 + 16 * blk;
            const uint4 q = G ? vw_quad(a, m_lo, m_hi)
                              : __ldg(reinterpret_cast<const uint4*>(a));
            const uint32_t cw[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const uintptr_t pa = P0 + 4 * (4 * blk + k + 1);
                const uint32_t next =
                    G ? vw_word(pa, c_lo, c_hi)
                      : __ldg(reinterpret_cast<const unsigned int*>(pa));
                const uint32_t pw = __funnelshift_r(prev, next, ps);
                prev = next;
                out |= vw_mismatch4(cw[k], pw) << (16 * h + 4 * k);
            }
        }
        return out & vw_below(nbits - 32 * w) & ~vw_below(off - 32 * w);
    }
};

// Builds the nw words of a candidate's mask, a thread a candidate: the
// first VW_KEEP into keep (registers), the rest to masks[w * n + i];
// returns the mismatch count.
template <bool G>
__device__ __forceinline__ int vw_build(VwMask& m, int nw, uint32_t* keep,
                                        uint32_t* masks, int64_t n,
                                        int64_t i) {
    m.prev = G ? vw_word(m.P0, m.c_lo, m.c_hi)
               : __ldg(reinterpret_cast<const unsigned int*>(m.P0));
    int nm = 0;
#pragma unroll
    for (int w = 0; w < VW_KEEP; ++w) {
        keep[w] = w < nw ? m.word<G>(w) : 0u;
        nm += __popc(keep[w]);
    }
    for (int w = VW_KEEP; w < nw; ++w) {
        const uint32_t x = m.word<G>(w);
        masks[w * n + i] = x;
        nm += __popc(x);
    }
    return nm;
}

// The window state: the last K+2 entries of P, P[idx-K-1 .. idx].
// push(x) appends P[idx] = x, which closes window t = idx-K-1; it returns
// whether that window qualifies, with its left end P[t] in left.  Here
// K = KT and the entries are registers.
template <int KT>
struct VwWindows {
    int r[KT + 2];
    int idx;

    __device__ VwWindows(int first, int, int*) : idx(0) {
#pragma unroll
        for (int u = 0; u < KT + 2; ++u) r[u] = first;
    }
    __device__ __forceinline__ int k() const { return KT; }
    __device__ __forceinline__ bool push(int x, int thres, int seed_req,
                                         int& left) {
#pragma unroll
        for (int u = 0; u <= KT; ++u) r[u] = r[u + 1];
        r[KT + 1] = x;
        if (++idx <= KT) return false;
        left = r[0];
        if (x - left - 1 < thres) return false;
        int seedmax = r[1] - r[0] - 1;
#pragma unroll
        for (int u = 1; u <= KT; ++u)
            seedmax = max(seedmax, r[u + 1] - r[u] - 1);
        return seedmax >= seed_req;
    }
};

// Any K up to CT_KMAX: the entries in a shared-memory ring of VW_RING a
// thread, VW_THREADS apart (the block's threads on distinct banks).
template <>
struct VwWindows<-1> {
    int* ring;
    int idx, K;

    __device__ VwWindows(int first, int K_, int* ring_)
        : ring(ring_), idx(0), K(K_) {
        ring[0] = first;
    }
    __device__ __forceinline__ int k() const { return K; }
    __device__ __forceinline__ int& at(int u) {
        return ring[(u & (VW_RING - 1)) * VW_THREADS];
    }
    __device__ __forceinline__ bool push(int x, int thres, int seed_req,
                                         int& left) {
        at(++idx) = x;
        if (idx <= K) return false;
        left = at(idx - K - 1);
        if (x - left - 1 < thres) return false;
        int seedmax = -1;
        for (int u = idx - K - 1; u < idx; ++u)
            seedmax = max(seedmax, at(u + 1) - at(u) - 1);
        return seedmax >= seed_req;
    }
};

// Feeds the mismatches of one mask word (bit k at position j0 + k) to
// the window state; calls emit(left, right) for each window [left + 1,
// right) that qualifies and returns how many did.
template <class W, class Emit>
__device__ __forceinline__ int vw_feed(W& win, uint32_t word, int j0,
                                       const Cand& c, int seed_req,
                                       Emit& emit) {
    int n = 0;
    while (word) {
        const int j = j0 + __ffs(word) - 1;
        word &= word - 1;
        int left;
        if (win.push(j, c.thres, seed_req, left)) {
            emit(left, j);
            ++n;
        }
    }
    return n;
}

// P[nm+1 .. nm+K+1] = i_hi closes the windows up to t = nm.
template <class W, class Emit>
__device__ __forceinline__ int vw_close(W& win, const Cand& c, int seed_req,
                                        Emit& emit) {
    int n = 0;
    for (int x = 0; x <= win.k(); ++x) {
        int left;
        if (win.push(c.i_hi, c.thres, seed_req, left)) {
            emit(left, c.i_hi);
            ++n;
        }
    }
    return n;
}

// Pass 1: each candidate's span count, and its mask words in
// masks[w * n + i] where it may have spans.  Its mismatch count comes
// first: a window that qualifies is at least thres long and holds at
// most K mismatches, so a band with fewer than thres - K matches has
// none, and is not walked (ebola175: the 7.7% of candidates with 33 or
// more mismatches, which held the walk of a warp up).
template <int KT, class Job>
__global__ void __launch_bounds__(VW_THREADS)
vw_mask_kernel(const Job v, int64_t* __restrict__ counts,
               uint32_t* __restrict__ masks) {
    extern __shared__ int vw_ring[];
    const int64_t i = (int64_t)blockIdx.x * VW_THREADS + threadIdx.x;
    if (i >= v.n) return;
    Cand c;
    int cnt = 0;
    if (v.candidate(v.fields(i), c)) {
        VwMask m(v.src, c);
        const int band = c.i_hi - c.i_lo;
        const int nw = vw_words(m.off, band);
        uint32_t keep[VW_KEEP];
        const int nm = m.inside ? vw_build<false>(m, nw, keep, masks, v.n, i)
                                : vw_build<true>(m, nw, keep, masks, v.n, i);
        if (c.fast) {
            cnt = band - nm >= max(c.thres - v.K, v.k_seed);
        } else if (band - nm >= c.thres - v.K) {
            VwWindows<KT> win(c.i_lo - 1, v.K, vw_ring + threadIdx.x);
            auto none = [](int, int) {};
            const int j0 = c.i_lo - m.off;
#pragma unroll
            for (int w = 0; w < VW_KEEP; ++w) {
                if (w < nw) masks[w * v.n + i] = keep[w];
                cnt += vw_feed(win, keep[w], j0 + 32 * w, c, v.seed_req,
                               none);
            }
            for (int w = VW_KEEP; w < nw; ++w)
                cnt += vw_feed(win, masks[w * v.n + i], j0 + 32 * w, c,
                               v.seed_req, none);
            cnt += vw_close(win, c, v.seed_req, none);
        }
    }
    counts[i] = cnt;
}

// Pass 3: the spans of each candidate that has any, from its mask words,
// written from its offset by the job's Emit.
template <int KT, class Job>
__global__ void __launch_bounds__(VW_THREADS)
vw_emit_kernel(const Job v, const int64_t* __restrict__ off_incl,
               const uint32_t* __restrict__ masks,
               const typename Job::Out out) {
    extern __shared__ int vw_ring[];
    const int64_t i = (int64_t)blockIdx.x * VW_THREADS + threadIdx.x;
    if (i >= v.n) return;
    // Every load the candidate needs before the branch on its count, so
    // that they wait on memory together.
    const int64_t o = i ? off_incl[i - 1] : 0;
    const int64_t o_end = off_incl[i];
    const typename Job::Fields f = v.fields(i);
    const int rows = (v.src.L + 46) >> 5;     // the words a candidate has
    uint32_t keep[VW_KEEP];
#pragma unroll
    for (int w = 0; w < VW_KEEP; ++w)
        keep[w] = w < rows ? masks[w * v.n + i] : 0u;
    if (o == o_end) return;
    Cand c;
    v.candidate(f, c);
    typename Job::Emit emit(v, c, out, o);
    if (c.fast) {
        emit(c.i_lo - 1, c.i_hi);
        return;
    }
    const int off = vw_off(v.src, c);
    const int nw = vw_words(off, c.i_hi - c.i_lo);
    VwWindows<KT> win(c.i_lo - 1, v.K, vw_ring + threadIdx.x);
    const int j0 = c.i_lo - off;
#pragma unroll
    for (int w = 0; w < VW_KEEP; ++w)
        vw_feed(win, w < nw ? keep[w] : 0u, j0 + 32 * w, c, v.seed_req, emit);
    for (int w = VW_KEEP; w < nw; ++w)
        vw_feed(win, masks[w * v.n + i], j0 + 32 * w, c, v.seed_req, emit);
    vw_close(win, c, v.seed_req, emit);
}

template <int KT, class Job>
static void vw_launch(const Job& v, const int64_t* off_incl, uint32_t* masks,
                      int64_t* counts, const typename Job::Out& out,
                      cudaStream_t st) {
    const size_t smem = KT < 0 ? VW_RING * VW_THREADS * sizeof(int) : 0;
    const unsigned nb = ct_blocks(v.n, VW_THREADS);
    if (off_incl)
        vw_emit_kernel<KT, Job><<<nb, VW_THREADS, smem, st>>>(v, off_incl,
                                                              masks, out);
    else
        vw_mask_kernel<KT, Job><<<nb, VW_THREADS, smem, st>>>(v, counts,
                                                              masks);
}

// The mask pass (off_incl null) or the emit pass, instantiated for K.
template <class Job>
static int vw_run(const Job& v, const int64_t* off_incl, uint32_t* masks,
                  int64_t* counts, const typename Job::Out& out,
                  void* stream) {
    if (v.K < 0 || v.K > CT_KMAX) return (int)cudaErrorInvalidValue;
    if (v.n <= 0) return (int)cudaGetLastError();
    cudaStream_t st = ct_stream(stream);
    switch (v.K) {
#define VW_CASE(k) \
        case k: vw_launch<k>(v, off_incl, masks, counts, out, st); break;
        VW_CASE(0) VW_CASE(1) VW_CASE(2) VW_CASE(3)
        VW_CASE(4) VW_CASE(5) VW_CASE(6) VW_CASE(7)
#undef VW_CASE
        default: vw_launch<-1>(v, off_incl, masks, counts, out, st);
    }
    return (int)cudaGetLastError();
}
static_assert(VW_KREG == 7, "vw_run instantiates K = 0..VW_KREG");
static_assert(VW_RING >= CT_KMAX + 2, "the ring holds K + 2 entries");

// ----------------------------------------------------------------------
// K3 verify_windows
// ----------------------------------------------------------------------

// K3's job: a candidate is (pc[i], ac[i]); its sequence is found by a
// binary search over the sequence ends, and its spans are extended,
// clamped to the chromosome and keyed probe * nU + universe.
struct VwParams {
    VwSrc src;
    const int64_t* lens;      // probe lengths [P]
    const int64_t* pc;        // candidate probe ids [n]
    const int64_t* ac;        // candidate alignments [n]
    int64_t n;
    const int64_t* seq_starts;
    const int64_t* seq_ends;
    const int64_t* seq_lens;
    const int64_t* chrom_off;
    const int64_t* univ_of_seq;
    int n_seqs;
    int K, k_seed, lcf, seed_req, fast_ok, ext;
    int64_t nU;

    struct Fields {
        int p, a;
    };
    struct Out {
        int64_t *key, *s, *e;
    };

    __device__ __forceinline__ Fields fields(int64_t i) const {
        return Fields{(int)pc[i], (int)ac[i]};
    }

    // Fills c for the candidate (p, a); false when its threshold is <= 0
    // (no span).
    __device__ __forceinline__ bool candidate(const Fields& f,
                                              Cand& c) const {
        const int a = f.a;
        c.p = f.p;
        c.a = a;
        int lo = 0, hi = n_seqs;         // searchsorted(seq_ends, a, right)
        while (lo < hi) {
            const int m = (lo + hi) >> 1;
            if (seq_ends[m] <= a) lo = m + 1; else hi = m;
        }
        c.sid = lo < n_seqs - 1 ? lo : n_seqs - 1;
        const int s_lo = (int)seq_starts[c.sid];
        const int s_hi = (int)seq_ends[c.sid];
        const int plen = (int)lens[c.p];
        const int start = a > s_lo ? a : s_lo;
        const int en = s_hi < a + plen ? s_hi : a + plen;
        const int n_seq = s_hi - s_lo;
        c.thres = min(min(lcf, plen), n_seq);
        c.i_lo = start - a;
        c.i_hi = en - a > c.i_lo ? en - a : c.i_lo;
        c.fast = fast_ok && (n_seq >= src.L || (K == 0 && n_seq >= k_seed));
        return c.thres > 0;
    }

    // Writes window [left + 1, right) of candidate c, extended and
    // clamped, at out[o], o counting up from the candidate's offset.
    struct Emit {
        const Out out;
        int64_t o, base, seq_len, coff, key;
        int ext;

        __device__ Emit(const VwParams& v, const Cand& c, const Out& out_,
                        int64_t o_)
            : out(out_), o(o_), base(v.seq_starts[c.sid] - c.a),
              seq_len(v.seq_lens[c.sid]), coff(v.chrom_off[c.sid]),
              key((int64_t)c.p * v.nU + v.univ_of_seq[c.sid]), ext(v.ext) {}

        __device__ __forceinline__ void operator()(int left, int right) {
            int64_t es = left + 1 - base - ext;
            int64_t ee = right - base + ext;
            es = es > 0 ? es : 0;
            ee = ee < seq_len ? ee : seq_len;
            out.key[o] = key;
            out.s[o] = es + coff;
            out.e[o] = ee + coff;
            ++o;
        }
    };
};

static VwParams vw_params(
        const void* mega, int64_t n_mega, const void* codes, int64_t n_codes,
        const void* lens, const void* pc, const void* ac, int64_t n,
        const void* seq_starts, const void* seq_ends, const void* seq_lens,
        const void* chrom_off, const void* univ_of_seq, int64_t n_seqs,
        int L, int K, int k_seed, int lcf, int seed_req, int fast_ok,
        int ext, int64_t nU) {
    VwParams v;
    v.src = VwSrc{(const uint8_t*)mega, n_mega, (const uint8_t*)codes,
                  n_codes, L};
    v.lens = (const int64_t*)lens;
    v.pc = (const int64_t*)pc;
    v.ac = (const int64_t*)ac;
    v.n = n;
    v.seq_starts = (const int64_t*)seq_starts;
    v.seq_ends = (const int64_t*)seq_ends;
    v.seq_lens = (const int64_t*)seq_lens;
    v.chrom_off = (const int64_t*)chrom_off;
    v.univ_of_seq = (const int64_t*)univ_of_seq;
    v.n_seqs = (int)n_seqs;
    v.K = K;
    v.k_seed = k_seed;
    v.lcf = lcf;
    v.seed_req = seed_req;
    v.fast_ok = fast_ok;
    v.ext = ext;
    v.nU = nU;
    return v;
}

#define VW_ARGS                                                              \
    const void *mega, int64_t n_mega, const void *codes, int64_t n_codes,    \
        const void *lens, const void *pc, const void *ac, int64_t n,         \
        const void *seq_starts, const void *seq_ends, const void *seq_lens,  \
        const void *chrom_off, const void *univ_of_seq, int64_t n_seqs,      \
        int L, int K, int k_seed, int lcf, int seed_req, int fast_ok,        \
        int ext, int64_t nU
#define VW_PARAMS                                                            \
    vw_params(mega, n_mega, codes, n_codes, lens, pc, ac, n, seq_starts,     \
              seq_ends, seq_lens, chrom_off, univ_of_seq, n_seqs, L, K,      \
              k_seed, lcf, seed_req, fast_ok, ext, nU)

// counts: int64[n]; masks: uint32[words * n], words = (L + 46) / 32.
extern "C" int ct_vw_mask(VW_ARGS, void* counts, void* masks, void* stream) {
    return vw_run(VW_PARAMS, nullptr, (uint32_t*)masks, (int64_t*)counts,
                  VwParams::Out{}, stream);
}

// off_incl: the inclusive sums of ct_vw_mask's counts; key, s, e: int64
// of its total.
extern "C" int ct_vw_emit(VW_ARGS, const void* off_incl, const void* masks,
                          void* key, void* s, void* e, void* stream) {
    return vw_run(VW_PARAMS, (const int64_t*)off_incl, (uint32_t*)masks,
                  nullptr, VwParams::Out{(int64_t*)key, (int64_t*)s,
                                         (int64_t*)e}, stream);
}

// ----------------------------------------------------------------------
// K6 verify_spans
// ----------------------------------------------------------------------

// K6's job: a candidate is its six fields.  Its alignment a = start -
// poff0 is 64-bit (the span scan's corpus reaches 2^34 positions); its
// band [poff0, poff0 + ov) is clamped to the probe row [0, L), which
// changes nothing for the span scan's candidates (keep_candidates gives
// 0 <= poff0 and poff0 + ov <= the probe's length) and keeps any other
// input's loads inside the row.  Its spans are [a + left + 1, a + right)
// in corpus coordinates.
struct VsParams {
    VwSrc src;
    const int64_t *pg, *start, *poff0, *ov, *thres, *n_seq;
    int64_t n;
    int K, k_seed, seed_req, fast_ok;

    struct Fields {
        int64_t p, start, poff0, ov, thres, n_seq;
    };
    struct Out {
        int64_t *p, *s, *e;
    };

    __device__ __forceinline__ Fields fields(int64_t i) const {
        return Fields{pg[i], start[i], poff0[i], ov[i], thres[i], n_seq[i]};
    }

    // Fills c; false when the threshold is <= 0 (no span).
    __device__ __forceinline__ bool candidate(const Fields& f,
                                              Cand& c) const {
        const int64_t L = src.L;
        const int64_t i_lo = f.poff0 < 0 ? 0 : f.poff0 < L ? f.poff0 : L;
        int64_t i_hi = f.poff0 + f.ov;
        i_hi = i_hi < i_lo ? i_lo : i_hi < L ? i_hi : L;
        c.p = (int)f.p;
        c.sid = 0;
        c.a = f.start - f.poff0;
        c.i_lo = (int)i_lo;
        c.i_hi = (int)i_hi;
        // a window holds at most L positions, so any threshold above
        // L + K (the fast path's need, thres - K, above L) is as good
        const int64_t t_max = L + CT_KMAX + 1;
        c.thres = (int)(f.thres < t_max ? f.thres : t_max);
        c.fast = fast_ok && (f.n_seq >= L || (K == 0 && f.n_seq >= k_seed));
        return f.thres > 0;
    }

    struct Emit {
        const Out out;
        int64_t o, a, p;

        __device__ Emit(const VsParams&, const Cand& c, const Out& out_,
                        int64_t o_)
            : out(out_), o(o_), a(c.a), p(c.p) {}

        __device__ __forceinline__ void operator()(int left, int right) {
            out.p[o] = p;
            out.s[o] = a + left + 1;
            out.e[o] = a + right;
            ++o;
        }
    };
};

static VsParams vs_params(const void* mega, int64_t n_mega,
                          const void* codes, int64_t n_codes, int L,
                          const void* pg, const void* start,
                          const void* poff0, const void* ov,
                          const void* thres, const void* n_seq, int64_t n,
                          int K, int k_seed, int seed_req, int fast_ok) {
    VsParams v;
    v.src = VwSrc{(const uint8_t*)mega, n_mega, (const uint8_t*)codes,
                  n_codes, L};
    v.pg = (const int64_t*)pg;
    v.start = (const int64_t*)start;
    v.poff0 = (const int64_t*)poff0;
    v.ov = (const int64_t*)ov;
    v.thres = (const int64_t*)thres;
    v.n_seq = (const int64_t*)n_seq;
    v.n = n;
    v.K = K;
    v.k_seed = k_seed;
    v.seed_req = seed_req;
    v.fast_ok = fast_ok;
    return v;
}

#define VS_ARGS                                                              \
    const void *mega, int64_t n_mega, const void *codes, int64_t n_codes,    \
        int L, const void *pg, const void *start, const void *poff0,         \
        const void *ov, const void *thres, const void *n_seq, int64_t n,     \
        int K, int k_seed, int seed_req, int fast_ok
#define VS_PARAMS                                                            \
    vs_params(mega, n_mega, codes, n_codes, L, pg, start, poff0, ov, thres,  \
              n_seq, n, K, k_seed, seed_req, fast_ok)

// counts: int64[n]; masks: uint32[words * n], words = (L + 46) / 32.
extern "C" int ct_vs_mask(VS_ARGS, void* counts, void* masks, void* stream) {
    return vw_run(VS_PARAMS, nullptr, (uint32_t*)masks, (int64_t*)counts,
                  VsParams::Out{}, stream);
}

// off_incl: the inclusive sums of ct_vs_mask's counts; p, s, e: int64
// of its total.
extern "C" int ct_vs_emit(VS_ARGS, const void* off_incl, const void* masks,
                          void* p, void* s, void* e, void* stream) {
    return vw_run(VS_PARAMS, (const int64_t*)off_incl, (uint32_t*)masks,
                  nullptr, VsParams::Out{(int64_t*)p, (int64_t*)s,
                                         (int64_t*)e}, stream);
}
