"""Plain models of the span scan's two kernel designs against catch_tpu.

csrc/verify_windows.cu's K6 job (verify_spans on K3's mask core) and
csrc/expand_join.cu's probe-major merge join (expand_join) run only on
the card, so their designs are modelled here step by step, in plain
Python over numpy and PyTorch on the CPU, and held against the JAX
programs they replace (catch_tpu/ops/scan_sparse.py _verify_chunk and
_expand_join_jit) and against the port's twins on the same inputs, made
from numpy seeds.  Every comparison is exact.

The K6 model builds each candidate's mismatch mask as the kernel does
(32 positions a word from the 16-aligned block below the band's first
byte), skips a band with fewer than thres - K matches, and walks the set
bits through the window state: K + 2 registers shifted a mismatch up to
K = 7, a ring of 64 entries indexed & 63 above.  Only the alignment is
64-bit; the positions from it are checked to fit 32 bits, which is what
lets the kernel take a corpus past 2^31 bytes (modelled by a shift of
every corpus position, with no 2 GB array).

The K5 model sorts the runs by (lo, pos) with the port's own _run_order,
marks each table row with its segment of positions, and merges each
work item (a probe and one of scan_sparse._chunks ranges of its
alignments) as a warp of 32 lanes does: the minimum of the lanes' 64-bit
keys from two 32-bit minima, every head equal to it advanced past equal
positions, with the lanes' register slots (scan_sparse._lane_slots) or
the scratch path above 256 rows; the pairs staged 32 at a time and
tested with the keep predicate where it is folded in.
"""

import bisect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from catch_tpu.ops import scan_sparse as jss
from catch_tpu_torch.ops import cover as tcover
from catch_tpu_torch.ops import scan_sparse as tss
from catch_tpu_torch.probe import Probe as TProbe
from test_torch_cuda import _verify_inputs
from test_torch_span_scan import _pad32, _pow2

CPU = torch.device("cpu")
KMAX = 62
RING = 64
KREG = 7
NONE = (1 << 64) - 1
I32 = 1 << 31


def _i32(x):
    """x, checked to fit the kernel's 32-bit band-relative positions."""
    assert -I32 <= x < I32
    return x


# ----------------------------------------------------------------------
# K6: the mask walk with K6's fields and fast path
# ----------------------------------------------------------------------

class _Windows:
    """VwWindows: the last K + 2 entries of P.  push(x) appends P[idx] =
    x and returns the left end of the window it closes when that window
    qualifies, else None."""

    def __init__(self, first, K):
        self.K, self.idx = K, 0
        if K <= KREG:
            self.r = [first] * (K + 2)
        else:
            self.ring = [None] * RING
            self.ring[0] = first

    def push(self, x, thres, seed_req):
        K = self.K
        self.idx += 1
        if K <= KREG:
            self.r = self.r[1:] + [x]
            if self.idx <= K:
                return None
            left = self.r[0]
            if x - left - 1 < thres:
                return None
            seedmax = max(self.r[u + 1] - self.r[u] - 1
                          for u in range(K + 1))
        else:
            self.ring[self.idx & (RING - 1)] = x
            if self.idx <= K:
                return None
            left = self.ring[(self.idx - K - 1) & (RING - 1)]
            if x - left - 1 < thres:
                return None
            seedmax = max(self.ring[(u + 1) & (RING - 1)]
                          - self.ring[u & (RING - 1)] - 1
                          for u in range(self.idx - K - 1, self.idx))
        return left if seedmax >= seed_req else None


def _mask_words(mega, codes, shift, addr0, p, a, i_lo, i_hi):
    """VwMask: the words of the band's mismatch mask.  Corpus position x
    is mega[x - shift] at address addr0 + x; bytes outside mega read 0;
    bit k of word w stands for position i_lo - off + 32 w + k from a."""
    off = (addr0 + a + i_lo) & 15
    band = i_hi - i_lo
    nw = (off + band + 31) >> 5 if band > 0 else 0
    words = []
    for w in range(nw):
        x = 0
        for k in range(32):
            j = _i32(i_lo - off + 32 * w + k)
            if not i_lo <= j < i_hi:
                continue
            m = a + j - shift
            c = int(mega[m]) if 0 <= m < len(mega) else 0
            if c == 0 or c != int(codes[p, j]):
                x |= 1 << k
        words.append(x)
    return off, words


def k6_model(mega, codes, cand, *, K, k_seed, seed_req, fast_ok, shift=0,
             addr0=0):
    """The spans (p, start, end) of csrc/verify_windows.cu's K6 job,
    candidate by candidate, windows left to right."""
    L = codes.shape[1]
    out = []
    for p, start, poff0, ov, thres, n_seq in zip(*(np.asarray(x).tolist()
                                                   for x in cand)):
        if thres <= 0:
            continue
        i_lo = min(max(poff0, 0), L)
        i_hi = min(max(poff0 + ov, i_lo), L)
        a = start - poff0                         # the 64-bit alignment
        thr = min(thres, L + KMAX + 1)
        fast = fast_ok and (n_seq >= L or (K == 0 and n_seq >= k_seed))
        off, words = _mask_words(mega, codes, shift, addr0, p, a, i_lo,
                                 i_hi)
        band = i_hi - i_lo
        nm = sum(bin(x).count("1") for x in words)
        if fast:
            if band - nm >= max(thr - K, k_seed):
                out.append((p, a + i_lo, a + i_hi))
            continue
        if band - nm < thr - K:
            continue
        win = _Windows(_i32(i_lo - 1), K)
        spans = []
        j0 = _i32(i_lo - off)
        for w, x in enumerate(words):
            while x:
                bit = (x & -x).bit_length() - 1
                x &= x - 1
                j = _i32(j0 + 32 * w + bit)
                left = win.push(j, thr, seed_req)
                if left is not None:
                    spans.append((left, j))
        for _ in range(K + 1):
            left = win.push(i_hi, thr, seed_req)
            if left is not None:
                spans.append((left, i_hi))
        out += [(p, a + left + 1, a + right) for left, right in spans]
    return out


def _jax_spans(mega, codes, cand, *, K, k_seed, seed_req, fast_ok):
    C = _pow2(max(len(cand[0]), 1 << 10))
    cap = 8 * C
    sp_p, sp_s, sp_e, _, nq = jss._verify_chunk(
        jnp.asarray(mega), jnp.asarray(codes),
        *[_pad32(x, C) for x in cand], jnp.int32(k_seed), L=codes.shape[1],
        K=K, C=C, cap=cap, seed_req=seed_req, fast_ok=fast_ok)
    nq = int(nq)
    assert nq <= cap
    return list(zip(*(np.asarray(x[:nq]).tolist()
                      for x in (sp_p, sp_s, sp_e))))


# (K, fast_ok, L, lcf, k_seed, seed_req)
K6_CASES = [
    (0, False, 37, 30, 8, 8), (0, True, 37, 30, 8, 8),
    (1, False, 61, 40, 10, 10), (1, True, 61, 40, 10, 10),
    (7, False, 100, 60, 10, 10), (7, True, 100, 60, 10, 10),
    (8, False, 100, 60, 10, 10), (8, True, 100, 60, 10, 10),
    (62, False, 100, 40, 6, 6), (62, True, 100, 40, 6, 6),
    (2, False, 61, 40, 10, 25),           # an island of exact match
    (3, False, 13, 12, 4, 4),             # bands within 16 bytes of mega
]


@pytest.mark.parametrize("K,fast_ok,L,lcf,k_seed,seed_req", K6_CASES,
                         ids=[f"K{c[0]}-{'fast' if c[1] else 'walk'}-L{c[2]}"
                              + ("-island" if c[5] > c[4] else "")
                              for c in K6_CASES])
def test_k6_mask_walk_matches_catch_tpu(K, fast_ok, L, lcf, k_seed,
                                        seed_req):
    """The model of K6 equals _verify_chunk's spans in order, and the
    port's twin, for mega's address at each of 4 alignments."""
    mega, codes, cand = _verify_inputs(K * 7 + L, L, lcf, k_seed)
    kw = dict(K=K, k_seed=k_seed, seed_req=seed_req, fast_ok=fast_ok)
    want = _jax_spans(mega, codes, cand, **kw)
    assert len(want) > 10
    twin = tss._verify_spans_plain(
        torch.from_numpy(mega), torch.from_numpy(codes),
        *(torch.from_numpy(x) for x in cand), **kw)
    assert list(zip(*(x.tolist() for x in twin))) == want
    for addr0 in (0, 3, 8, 15):
        assert k6_model(mega, codes, cand, addr0=addr0, **kw) == want


@pytest.mark.parametrize("shift,addr0", [
    (I32 + 16, 0), (I32 + 5, 11), (I32 - 1500, 7), ((1 << 33) + 1234567, 2)],
    ids=["2^31+16", "2^31+5", "across-2^31", "2^33"])
def test_k6_offsets_past_2_31(shift, addr0):
    """Candidates whose alignment lies past 2^31 (every corpus position
    shifted): the model's spans are catch_tpu's shifted, and every
    position it keeps from an alignment fits 32 bits."""
    K, L = 2, 61
    mega, codes, cand = _verify_inputs(5, L, 40, 10)
    kw = dict(K=K, k_seed=10, seed_req=10, fast_ok=False)
    want = _jax_spans(mega, codes, cand, **kw)
    moved = list(cand)
    moved[1] = cand[1] + shift
    got = k6_model(mega, codes, moved, shift=shift, addr0=addr0, **kw)
    assert got == [(p, s + shift, e + shift) for p, s, e in want]
    assert len(got) > 10
    a = moved[1] - moved[2]
    if shift >= I32:
        assert int(a.min()) >= I32
    else:
        assert int(a.min()) < I32 <= int(a.max())


# ----------------------------------------------------------------------
# K5: the probe-major merge join
# ----------------------------------------------------------------------

def _warp_min(keys):
    """ej_warp_min: the minimum of 32 lanes' 64-bit keys from two 32-bit
    minima."""
    hi = min(k >> 32 for k in keys)
    lo = min((k & 0xFFFFFFFF) if k >> 32 == hi else 0xFFFFFFFF
             for k in keys)
    return (hi << 32) | lo


def _keep_one(p, a, keep):
    """keep_candidates' predicate on one pair: its six candidate fields,
    or None."""
    starts, ends = keep["starts"], keep["ends"]
    sid = min(bisect.bisect_right(ends, a), len(ends) - 1)
    s_lo, s_hi, plen = starts[sid], ends[sid], keep["plens"][p]
    st = max(s_lo, a)
    ov = min(s_hi, a + plen) - st
    n_seq = s_hi - s_lo
    thres = min(min(plen, keep["lcf"]), n_seq)
    if ov >= max(thres, keep["k_seed"]) and thres > 0:
        return (p, st, st - a, ov, thres, n_seq)
    return None


def k5_model(lo, cnt, pos, join_p, join_pos, lmax, keep=None):
    """The output of csrc/expand_join.cu's merge join, in its order:
    the pairs (p, a), or with `keep` (plain lists of starts, ends and
    plens, and lcf and k_seed) the kept pairs' six candidate fields;
    and the lane slots and the ranges a probe it took."""
    lo_t, cnt_t, pos_t = (torch.from_numpy(np.ascontiguousarray(x))
                          for x in (lo, cnt, pos))
    jp, jpos = (torch.from_numpy(np.ascontiguousarray(x))
                for x in (join_p, join_pos))
    index = tss.join_index(jp, jpos)
    R = len(join_p)
    keys = None                                               # ej_keys
    if R < tss._PACKED_ROWS:
        keys = (torch.where(cnt_t > 0, lo_t, R) << 34) | pos_t
    skey, idx = tss._run_order(lo_t, cnt_t, pos_t, R, keys)
    idx = idx.tolist()
    slo = [int(lo[k]) if cnt[k] > 0 else R for k in idx]      # ej_gather
    spos = [int(pos[k]) for k in idx]
    if skey is not None:
        assert (skey >> 34).tolist() == slo
        assert (skey & ((1 << 34) - 1)).tolist() == spos
    n = len(idx)
    seg = [(0, 0)] * R
    for i in range(n):                                        # ej_mark
        if i > 0 and slo[i - 1] == slo[i]:
            continue
        e = bisect.bisect_right(slo, slo[i], i + 1)
        for r in range(max(slo[i], 0), min(slo[i] + int(cnt[idx[i]]), R)):
            seg[r] = (i, e)
    slots = tss._lane_slots(index["width"])
    C = tss._chunks(index["n_probes"], slots)
    rows, offs = index["row"].tolist(), index["off"].tolist()
    end = index["end"].tolist()
    lmax1 = lmax - 1
    width = (max(spos + [0]) + lmax1 + C) // C
    out = []
    for t in range(index["n_probes"] * C):                    # ej_merge
        p, c = divmod(t, C)
        k_lo = c * width
        k_hi = k_lo + width if c + 1 < C else NONE
        e0, e1 = (end[p - 1] if p else 0), end[p]
        # lane l's entries: e0 + l + 32 j, j < slots (all j on the
        # scratch path)
        lanes = [list(range(e0 + lane, e1, 32))[:slots or None]
                 for lane in range(32)]
        assert sum(map(len, lanes)) == e1 - e0
        head, cur = {}, {}

        def key(e, i):
            v = spos[i] + lmax1 - offs[e] if i < seg[rows[e]][1] else NONE
            return v if v < k_hi else NONE

        for e in range(e0, e1):
            b, en = seg[rows[e]]
            if k_lo > 0:
                b = bisect.bisect_left(spos, k_lo - (lmax1 - offs[e]), b, en)
            cur[e] = b
            head[e] = key(e, b)
        staged = []

        def group():
            for a in staged:
                x = (p, a) if keep is None else _keep_one(p, a, keep)
                if x is not None:
                    out.append(x)
            staged.clear()

        while True:
            mine = [min([head[e] for e in ln] or [NONE]) for ln in lanes]
            m = _warp_min(mine)
            if m == NONE:
                break
            staged.append(m - lmax1)
            if len(staged) == 32:
                group()
            for lane, ln in enumerate(lanes):
                if mine[lane] == m:
                    for e in ln:
                        while head[e] == m:
                            cur[e] += 1
                            head[e] = key(e, cur[e])
        group()
    return out, slots, C


def _jax_pairs(lo, cnt, pos, join_p, join_pos):
    total = int(cnt.sum())
    S, T = _pow2(len(lo)), _pow2(max(total, 1))
    pj, aj, _, n = jss._expand_join_jit(
        _pad32(lo, S), _pad32(cnt, S), _pad32(pos, S), jnp.int32(total),
        jnp.asarray(join_p.astype(np.int32)),
        jnp.asarray(join_pos.astype(np.int32)), T=T, S=S, cap=T)
    n = int(n)
    return list(zip(np.asarray(pj[:n]).tolist(), np.asarray(aj[:n]).tolist()))


def _random_corpus(rng, n_seqs, lo, hi, base=None):
    bases = np.array(list("ACGT"))
    out = []
    for _ in range(n_seqs):
        n = int(rng.integers(lo, hi))
        if base is None:
            out.append("".join(rng.choice(bases, size=n)))
        else:
            s = base[:n].copy()
            m = rng.random(n) < 0.03
            s[m] = rng.choice(bases, size=int(m.sum()))
            out.append("".join(s))
    return out


def _join_case(case, monkeypatch):
    """(lo, cnt, pos, join_p, join_pos, lmax) of a host join on the CPU."""
    rng = np.random.default_rng(["w9", "w1", "hot", "slab_overlap",
                                 "wide_probe", "empty_runs",
                                 "two_sorts"].index(case) + 40)
    bases = np.array(list("ACGT"))
    base = rng.choice(bases, size=1200)
    pl, ps, k = 60, 25, 20
    seqs = _random_corpus(rng, 6, 300, 1200, base)
    if case in ("w1", "empty_runs", "two_sorts"):
        k = 10
    if case == "hot":
        # 40 probes share a stretch of 20 A: with k = 10 (w = 1) the
        # run of AAAAAAAAAA's table rows holds 11 rows a probe, and the
        # corpus's stretches of A give it hundreds of positions
        k = 10
        seqs = ["".join(rng.choice(bases, size=30)) + "A" * 300 + s
                + "A" * 200 for s in seqs]
    if case == "wide_probe":
        pl, ps, k = 300, 150, 10                  # 291 rows a probe
    if case == "slab_overlap":
        monkeypatch.setattr(tss, "_JOIN_SLAB", 997)
    probes = []
    for s in seqs:
        for i in range(0, len(s) - pl + 1, ps):
            probes.append(s[i:i + pl])
    if case == "hot":
        probes += ["".join(rng.choice(bases, size=20)) + "A" * 20
                   + "".join(rng.choice(bases, size=20)) for _ in range(40)]
    probes = list(dict.fromkeys(probes))
    t = tcover.ProbeSearcher([TProbe.from_str(x) for x in probes],
                             tcover.CoverModel(2, 40), kmer_probe_map_k=k,
                             device=CPU)
    mega, starts, ends, total = tss.corpus_codes(t, seqs)
    lo, cnt, pos = tss.join_runs(t, mega[:total])
    if case == "empty_runs":
        # runs of no hits, some at a real run's lo, mixed in
        m = 300
        at = np.sort(rng.integers(0, len(lo), size=m))
        lo = np.insert(lo, at, np.where(rng.random(m) < 0.5, lo[at],
                                        rng.integers(0, len(t._join_p),
                                                     size=m)))
        cnt = np.insert(cnt, at, 0)
        pos = np.insert(pos, at, rng.integers(0, total, size=m))
    if case == "two_sorts":
        monkeypatch.setattr(tss, "_PACKED_ROWS", 1)
    keep = dict(starts=starts.tolist(), ends=ends.tolist(),
                plens=t.probe_lens.astype(np.int64).tolist(),
                lcf=int(t.lcf_static), k_seed=int(t.k_seed))
    return (lo.astype(np.int64), cnt.astype(np.int64), pos.astype(np.int64),
            t._join_p, t._join_pos, int(t.Lmax), t._join_kw, keep)


@pytest.mark.parametrize("case", ["w9", "w1", "hot", "slab_overlap",
                                  "wide_probe", "empty_runs", "two_sorts"])
def test_k5_merge_join_matches_catch_tpu(case, monkeypatch):
    """The model of K5 equals _expand_join_jit's pairs and the twin's,
    with minimizers (w = 9) and without (w = 1), a kj-mer of hundreds of
    positions and a table run of hundreds of rows, the slab overlap's
    duplicate positions, a probe of more rows than a warp's register
    slots, runs of no hits, and the two-sort order; and with the keep
    predicate folded in, keep_candidates' candidates of those pairs."""
    lo, cnt, pos, join_p, join_pos, lmax, kw, keep = _join_case(
        case, monkeypatch)
    want = _jax_pairs(lo, cnt, pos, join_p, join_pos)
    assert len(want) > 100
    got, slots, chunks = k5_model(lo, cnt, pos, join_p, join_pos, lmax)
    assert got == want
    tp, ta = tss._expand_join_plain(
        *(torch.from_numpy(np.ascontiguousarray(x))
          for x in (lo, cnt, pos, join_p, join_pos)), lmax)
    assert list(zip(tp.tolist(), ta.tolist())) == want
    kept, _, _ = k5_model(lo, cnt, pos, join_p, join_pos, lmax, keep)
    cand = tss._keep_plain(
        *(torch.tensor(x, dtype=torch.int64) for x in zip(*want)),
        **{k: torch.tensor(v) if isinstance(v, list) else v
           for k, v in keep.items()})
    assert kept == list(zip(*(x.tolist() for x in cand)))
    assert 0 < len(kept) <= len(want)
    assert chunks == (1 if slots == 0 else
                      min(64, -(-4096 // (int(join_p.max()) + 1))))
    assert kw[1] == (9 if case in ("w9", "slab_overlap") else 1)
    raw = int(cnt.sum())
    if case == "hot":
        runs = np.diff(np.flatnonzero(np.diff(np.r_[-1, np.sort(lo), -2])))
        assert int(cnt.max()) >= 400 and runs.max() >= 200 and raw > 10 * len(
            want)
    if case == "slab_overlap":
        assert len(np.unique(pos)) < len(pos)
    if case == "wide_probe":
        assert slots == 0
    else:
        assert slots in (1, 2, 4, 8)
    if case == "empty_runs":
        assert (cnt == 0).sum() == 300
