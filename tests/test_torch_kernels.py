"""Each scan kernel's plain-PyTorch twin against the JAX program it
replaces (catch_tpu/ops/scan_instance.py), on the same inputs.

The twins are what catch_tpu_torch runs for CPU tensors; on the card
chip_smoke.py holds each CUDA kernel against its twin.  Every comparison
is exact: hashes, positions and keys are integers.  Inputs are made from
numpy seeds.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from catch_tpu.ops import scan_instance as sj
from catch_tpu_torch.filters.candidates import (
    make_candidate_probes_from_sequences)
from catch_tpu_torch.filters.duplicate import DuplicateFilter
from catch_tpu_torch.ops import scan_instance as si
from catch_tpu_torch.ops.cover import CoverModel, ProbeSearcher

BASES = np.array(list("ACGT"))
CPU = torch.device("cpu")
I32MAX = np.iinfo(np.int32).max


def _mutate(rng, seq, rate, alphabet=BASES):
    seq = seq.copy()
    m = rng.random(len(seq)) < rate
    seq[m] = rng.choice(alphabet, size=int(m.sum()))
    return seq


def _genomes(rng, n_genomes, n_len, mut=0.03, n_chrs=1, alphabet=BASES):
    """Genomes as lists of chromosome strings, mutated from one base."""
    base = rng.choice(alphabet, size=n_len)
    out = []
    for _ in range(n_genomes):
        seq = _mutate(rng, base, mut, alphabet)
        bounds = np.linspace(0, n_len, n_chrs + 1).astype(int)
        out.append(["".join(seq[a:b])
                    for a, b in zip(bounds[:-1], bounds[1:])])
    return out


def _short_chr_genomes(rng):
    """One long chromosome per genome plus two copies of its pieces
    shorter than the 80 bp probes."""
    base = rng.choice(BASES, size=900)
    out = []
    for _ in range(4):
        seq = _mutate(rng, base, 0.02)
        out.append(["".join(seq), "".join(seq[100:150]),
                    "".join(seq[300:370])])
    return out


def _contrived_genomes(rng):
    """Two-chromosome genomes over a contrived alphabet of nine letters
    (runs of 'N' shared by every genome), with a tenth letter, 'Z', only
    in the second chromosomes: the probes, tiled from the first, lack
    it, so it reads as PAD in the corpus."""
    letters = np.array(list("ABCDEFGHN"))
    base = rng.choice(letters[:-1], size=1000)
    for s0 in rng.integers(0, 990, size=6):
        base[s0:s0 + 8] = "N"
    out = []
    for _ in range(4):
        seq = _mutate(rng, base, 0.03, letters)
        tail = seq[500:].copy()
        tail[rng.random(len(tail)) < 0.01] = "Z"
        out.append(["".join(seq[:500]), "".join(tail)])
    return out


class Scan:
    """The port's scan inputs for a corpus, probes tiled from the
    first chromosome of every genome (probe_length bp every half of
    it)."""

    def __init__(self, genomes, model_kw, k_seed=None, probe_length=80):
        seqs = [s for g in genomes for s in g]
        probes = DuplicateFilter()._filter(
            make_candidate_probes_from_sequences(
                [g[0] for g in genomes], probe_length=probe_length,
                probe_stride=probe_length // 2))
        self.searcher = ProbeSearcher(probes, CoverModel(**model_kw))
        if k_seed is not None:
            self.searcher.k_seed = k_seed
        univ, off = [], []
        for j, g in enumerate(genomes):
            pos = 0
            for s in g:
                univ.append(j)
                off.append(pos)
                pos += len(s)
        pid = np.arange(len(self.searcher.probes))
        self.st, self.total, _ = si.prepare_corpus(
            self.searcher, seqs, univ, off, pid, CPU)
        self.kj, self.s = si.join_params_stride(self.searcher)
        self.nU = len(genomes)
        self.codes = self.st["codes"].numpy()
        self.P, self.L = self.codes.shape

    def flat(self):
        row = self.L + self.kj
        flat = np.zeros(self.P * row + self.kj - 1, dtype=np.uint8)
        flat[:self.P * row].reshape(self.P, row)[:, :self.L] = self.codes
        return flat, row

    def jax_table(self):
        flat, row = self.flat()
        return sj._build_table_jit(jnp.asarray(flat), kj=self.kj, row=row,
                                   TBL=sj._next_pow2(self.P * row))

    def mega(self, Q):
        """Corpus codes padded for Q samples (the JAX programs slice
        Q * s + kj - 1 codes and gather whole words)."""
        mega = self.st["mega"].numpy()
        n = max(len(mega), Q * self.s + self.kj)
        n += -n % 4
        return np.concatenate([mega, np.zeros(n - len(mega), np.uint8)])

    def pairs(self):
        tbl = si.build_table(self.st["codes"], self.kj)
        q = si.rolling_hash(self.st["mega"], -(-self.total // self.s),
                            self.s, self.kj, self.total - self.kj)
        return si.lookup_expand(*tbl, q, self.s)


def _corpus_scan(seed=17, model_kw=None, probe_length=80, contrived=False,
                 **kw):
    rng = np.random.default_rng(seed)
    genomes = (_contrived_genomes(rng) if contrived
               else _genomes(rng, 4, 1000, **kw))
    return Scan(genomes, model_kw or dict(mismatches=2, lcf_thres=60),
                probe_length=probe_length)


# ----------------------------------------------------------------------
# K1 rolling_hash
# ----------------------------------------------------------------------

def test_rolling_hash_matches_numpy_uint32():
    """The int64 twin equals a hash computed in numpy uint32 arithmetic,
    including the clamp and the PAD and last_pos sentinels."""
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 5, size=4000).astype(np.uint8)
    codes[rng.random(4000) < 0.9] = rng.integers(1, 5, size=1).item()
    kj, stride, n_out, last = 13, 3, 1200, 3000
    h = np.zeros(n_out, dtype=np.uint32)
    ok = np.arange(n_out) * stride <= last
    with np.errstate(over="ignore"):
        for j in range(kj):
            c = codes[j:j + (n_out - 1) * stride + 1:stride].astype(
                np.uint32)
            h = h * np.uint32(si.MULT) + c
            ok &= c > 0
    want = np.where(ok, np.minimum(h, np.uint32(si.HMAX - 1)).astype(
        np.int64), si.HMAX)
    got = si.rolling_hash(torch.from_numpy(codes), n_out, stride, kj, last)
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want)
    assert (want == si.HMAX).any() and (want < si.HMAX).any()


def _jax_table(codes, kj):
    """_build_table_jit's table of uint8[P, L] probe codes, laid out as
    catch_tpu lays them out ([L codes][kj PAD])."""
    P, L = codes.shape
    row = L + kj
    flat = np.zeros(P * row + kj - 1, dtype=np.uint8)
    flat[:P * row].reshape(P, row)[:, :L] = codes
    return sj._build_table_jit(jnp.asarray(flat), kj=kj, row=row,
                               TBL=sj._next_pow2(P * row))


def _assert_table_equals_jax(codes, kj):
    """build_table's twin against _build_table_jit: the same (hash,
    probe, offset) entries as sets, the table's valid rows; probe-major,
    offsets ascending within a probe, 0 in the unused slots."""
    ent, cnt = si.build_table(torch.from_numpy(codes), kj)
    assert ent.dtype == torch.int64 and cnt.dtype == torch.int32
    P, L = codes.shape
    assert tuple(ent.shape) == (P, max(L - kj + 1, 0))
    jh, jp, jpos = (np.asarray(x).astype(np.int64)
                    for x in _jax_table(codes, kj))
    jv = jh != si.HMAX
    th, tp, tpos = (x.numpy() for x in si.table_entries(ent, cnt))
    assert len(th) == int(jv.sum())
    assert sorted(zip(jh[jv], jp[jv], jpos[jv])) == sorted(zip(th, tp, tpos))
    key = tp * (L + 1) + tpos
    assert np.all(key[1:] > key[:-1])
    slot = np.arange(ent.shape[1])[None, :]
    assert not ent.numpy()[slot >= cnt.numpy()[:, None]].any()
    return ent, cnt


def test_rolling_hash_table_matches_build_table_jit():
    sc = _corpus_scan()
    ent, cnt = _assert_table_equals_jax(sc.codes, sc.kj)
    assert int(cnt.sum()) > 0


def _table_case(case, rng):
    """(codes uint8[P, L], kj, s) for a stage-T edge case: PAD inside
    probes, probes shorter than kj (and one of 40 codes), one probe, or
    an L that is not a multiple of 4."""
    P = 1 if case == "one_probe" else 12
    L = 83 if case == "odd_L" else 80
    codes = rng.integers(1, 5, size=(P, L)).astype(np.uint8)
    if case == "pad_inside":
        codes[rng.random((P, L)) < 0.03] = 0
    if case == "short_probe":
        codes[3, 9:] = 0
        codes[5, 40:] = 0
    return codes, 12, 9


def _jax_pairs(jtable, mega, total, kj, s):
    """catch_tpu's stage B pairs of all samples of the corpus `mega`
    against a _build_table_jit table."""
    jh, jp, jpos = jtable
    Q = sj._next_pow2(-(-total // s))
    n = max(len(mega), Q * s + kj)
    n += -n % 4
    mega = np.concatenate([mega, np.zeros(n - len(mega), np.uint8)])
    jq = sj._hash_samples_jit(jnp.asarray(mega), jnp.int32(0),
                              jnp.int32(total - kj), kj=kj, s=s, Q=Q)
    lo, cnt, _, _, _ = sj._lookup_jit(jh, jq, full=True,
                                      rounds=sj._LK_ROUNDS)
    T = sj._next_pow2(max(1, int(np.asarray(cnt).sum())))
    p, a, n = sj._stage_b_jit(lo, cnt, jnp.int32(0), jnp.int32(0),
                              jnp.int32(Q), jp, jpos, T=T, Q=Q, CAP=T, s=s)
    n = int(n)
    return list(zip(np.asarray(p)[:n].tolist(), np.asarray(a)[:n].tolist()))


@pytest.mark.parametrize("case", ["pad_inside", "short_probe", "one_probe",
                                  "odd_L"])
def test_build_table_and_pairs_match_jax_edge_cases(case):
    """Stage T's twin against _build_table_jit, and lookup_expand's pairs
    from its table against catch_tpu's lookup and stage B, on probes
    with PAD inside, probes shorter than kj, one probe, and L = 83."""
    rng = np.random.default_rng(["pad_inside", "short_probe", "one_probe",
                                 "odd_L"].index(case))
    codes, kj, s = _table_case(case, rng)
    ent, cnt = _assert_table_equals_jax(codes, kj)
    P, L = codes.shape
    if case == "short_probe":
        assert int(cnt[3]) == 0 and int(cnt[5]) == 40 - kj + 1
    # A corpus that holds every probe (mutated) behind a pad of L + kj.
    body = [np.where(rng.random(L) < 0.02, rng.integers(1, 5, size=L),
                     row)[row > 0] for row in codes]
    body = np.concatenate(body + [rng.integers(1, 5, size=300)]).astype(
        np.uint8)
    mega = np.concatenate([np.zeros(L + kj, np.uint8), body,
                           np.zeros(L + s + kj, np.uint8)])
    total = L + kj + len(body)
    want = _jax_pairs(_jax_table(codes, kj), mega, total, kj, s)
    q = si.rolling_hash(torch.from_numpy(mega), -(-total // s), s, kj,
                        total - kj)
    pc, ac = si.lookup_expand(ent, cnt, q, s)
    assert list(zip(pc.tolist(), ac.tolist())) == want
    assert len(want) >= P - (case == "short_probe")


def test_rolling_hash_samples_match_hash_samples_jit():
    sc = _corpus_scan(seed=5, n_chrs=3)
    Q = -(-sc.total // sc.s)
    mega = sc.mega(Q)
    n_last = sc.total - sc.kj
    jq = sj._hash_samples_jit(jnp.asarray(mega), jnp.int32(0),
                              jnp.int32(n_last), kj=sc.kj, s=sc.s, Q=Q)
    tq = si.rolling_hash(torch.from_numpy(mega), Q, sc.s, sc.kj, n_last)
    assert np.array_equal(np.asarray(jq).astype(np.int64), tq.numpy())


# ----------------------------------------------------------------------
# K2 lookup_expand
# ----------------------------------------------------------------------

def test_lookup_expand_matches_lookup_and_stage_b():
    sc = _corpus_scan(seed=9)
    Q = sj._next_pow2(-(-sc.total // sc.s))
    mega = sc.mega(Q)
    n_last = sc.total - sc.kj
    jh, jp, jpos = sc.jax_table()
    jq = sj._hash_samples_jit(jnp.asarray(mega), jnp.int32(0),
                              jnp.int32(n_last), kj=sc.kj, s=sc.s, Q=Q)
    lo, cnt, _, _, maxb = sj._lookup_jit(jh, jq, full=False,
                                         rounds=sj._LK_ROUNDS)
    assert int(maxb) < 1 << sj._LK_ROUNDS
    lo, cnt = np.asarray(lo), np.asarray(cnt)

    tbl = si.build_table(sc.st["codes"], sc.kj)
    tq = si.rolling_hash(torch.from_numpy(mega), Q, sc.s, sc.kj, n_last)
    assert (cnt > 0).any()

    # Pairs: the union of stage B over three subranges of the samples.
    T = sj._next_pow2(int(cnt.sum()))
    want = set()
    for i0, i1 in ((0, Q // 3), (Q // 3, 2 * Q // 3), (2 * Q // 3, Q)):
        p, a, n = sj._stage_b_jit(
            jnp.asarray(lo), jnp.asarray(cnt), jnp.int32(0), jnp.int32(i0),
            jnp.int32(i1), jp, jpos, T=T, Q=Q, CAP=T, s=sc.s)
        n = int(n)
        want |= set(zip(np.asarray(p)[:n].tolist(),
                        np.asarray(a)[:n].tolist()))
    pc, ac = si.lookup_expand(*tbl, tq, sc.s)
    got = list(zip(pc.tolist(), ac.tolist()))
    assert got == sorted(set(got))          # sorted, no duplicates
    assert set(got) == want
    assert min(ac.tolist()) >= 1            # the leading pad


def _low_complexity_genomes(rng):
    """Genomes with a poly-A run and a tandem repeat: probes that repeat
    a kj-mer, and samples in long runs of equal hashes."""
    base = rng.choice(BASES, size=1000)
    base[200:500] = "A"
    base[600:760] = list("ACGT" * 40)
    return [["".join(_mutate(rng, base, 0.01))] for _ in range(4)]


@pytest.mark.parametrize("low_complexity,g0_sevenths", [
    (False, 3), (True, 0), (True, 5)],
    ids=["sample0", "low_complexity", "low_complexity_sample0"])
def test_lookup_expand_matches_stage_b_hard_inputs(low_complexity,
                                                   g0_sevenths):
    """The twin's inverted plan (samples sorted, each probe offset's run
    found by searchsorted) against _lookup_jit + _stage_b_jit over the
    samples from g0 on: at a nonzero g0 (lookup_expand's sample0), and
    on low-complexity probes."""
    rng = np.random.default_rng(23)
    sc = Scan(_low_complexity_genomes(rng) if low_complexity
              else _genomes(rng, 4, 1000), dict(mismatches=2, lcf_thres=60))
    n_all = -(-sc.total // sc.s)
    g0 = n_all * g0_sevenths // 7
    Q = sj._next_pow2(n_all - g0)
    mega = sc.mega(g0 + Q)
    n_last = sc.total - sc.kj
    jh, jp, jpos = sc.jax_table()
    jq = sj._hash_samples_jit(jnp.asarray(mega), jnp.int32(g0),
                              jnp.int32(n_last), kj=sc.kj, s=sc.s, Q=Q)
    lo, cnt, _, _, _ = sj._lookup_jit(jh, jq, full=True,
                                      rounds=sj._LK_ROUNDS)
    T = sj._next_pow2(int(np.asarray(cnt).sum()))
    p, a, n = sj._stage_b_jit(lo, cnt, jnp.int32(g0), jnp.int32(0),
                              jnp.int32(Q), jp, jpos, T=T, Q=Q, CAP=T,
                              s=sc.s)
    n = int(n)
    want = list(zip(np.asarray(p)[:n].tolist(), np.asarray(a)[:n].tolist()))

    tbl = si.build_table(sc.st["codes"], sc.kj)
    tq = si.rolling_hash(torch.from_numpy(mega[g0 * sc.s:]), Q, sc.s, sc.kj,
                         n_last - g0 * sc.s)
    pc, ac = si.lookup_expand(*tbl, tq, sc.s, sample0=g0)
    assert list(zip(pc.tolist(), ac.tolist())) == want
    assert n > 0
    if low_complexity:
        h = tq[tq != si.HMAX]
        assert int(torch.unique(h, return_counts=True)[1].max()) >= 20
        th, tp, _ = si.table_entries(*tbl)
        pairs = set(zip(th.tolist(), tp.tolist()))
        assert len(pairs) < th.numel()   # a probe repeats a kj-mer


def test_lookup_expand_alignment_limit():
    q = torch.zeros(10, dtype=torch.int64)
    ent, cnt = torch.zeros((1, 1), dtype=torch.int64), torch.ones(
        1, dtype=torch.int32)
    with pytest.raises(ValueError, match="31-bit"):
        si.lookup_expand(ent, cnt, q, 2 ** 28, sample0=0)


# ----------------------------------------------------------------------
# K3 verify_windows
# ----------------------------------------------------------------------

def _stage_c_parity(sc, model_kw, ext):
    pc, ac = sc.pairs()
    n = int(pc.numel())
    assert n > 0
    sr = sc.searcher
    island = model_kw.get("island_of_exact_match", 0)
    seed_req = max(sr.k_seed, island) if island > 0 else sr.k_seed
    args = dict(K=int(sr.K_static), k_seed=int(sr.k_seed),
                lcf=int(sr.lcf_static), seed_req=int(seed_req),
                fast_ok=bool(sr.fast_ok), ext=ext, nU=sc.nU)
    st = sc.st
    key, us, ue = si.verify_windows(
        st["mega"], st["codes"], st["lens"], pc, ac, st["seq_starts"],
        st["seq_ends"], st["seq_lens"], st["chrom_off"], st["univ_of_seq"],
        **args)

    # The JAX program, at the shapes its own pipeline would give it.  It
    # gathers whole words of L + 4 codes, so it takes L a multiple of 4:
    # other probe lengths go in padded by PAD columns, which no band
    # reaches (only the fast path reads L itself).
    L, P = sc.L, sc.P
    Lj = L + -L % 4
    assert Lj == L or not args["fast_ok"]
    Lw = Lj + 4
    codes_shift = np.zeros((4 * P, Lw), dtype=np.uint8)
    for r in range(4):
        codes_shift[r * P:(r + 1) * P, r:r + L] = sc.codes
    C = sj._next_pow2(n)
    pcj = np.full(C, I32MAX, np.int32)
    pcj[:n] = pc.numpy()
    acj = np.zeros(C, np.int32)
    acj[:n] = ac.numpy()
    cap = sj._next_pow2(max(int(key.numel()), 1)) * 2

    def i32(name):
        return jnp.asarray(st[name].numpy().astype(np.int32))

    jk, js, je, nq, ovf = sj._stage_c_jit(
        jnp.asarray(sc.mega(0)), jnp.asarray(codes_shift),
        jnp.asarray(st["lens"].numpy().astype(np.int32)), jnp.asarray(pcj),
        jnp.asarray(acj), jnp.int32(0), jnp.int32(n), i32("seq_starts"),
        i32("seq_ends"), i32("seq_lens"), i32("chrom_off"),
        i32("univ_of_seq"), jnp.int32(args["k_seed"]),
        jnp.int32(args["lcf"]), jnp.int32(sc.nU), L=Lj, K=args["K"], C=C,
        cap=cap, seed_req=args["seed_req"], fast_ok=args["fast_ok"],
        ext=ext, tsw=1 << 30)
    nq = int(nq)
    assert nq <= cap and int(ovf) == 0
    assert nq > 0
    # Same candidate order, windows left to right: equal in order.
    assert np.array_equal(np.asarray(jk)[:nq], key.numpy())
    assert np.array_equal(np.asarray(js)[:nq], us.numpy())
    assert np.array_equal(np.asarray(je)[:nq], ue.numpy())
    return args


@pytest.mark.parametrize("model_kw,ext,n_chrs,L,contrived", [
    (dict(mismatches=2, lcf_thres=60), 30, 1, 80, False),
    (dict(mismatches=0, lcf_thres=60), 0, 1, 80, False),
    (dict(mismatches=2, lcf_thres=80), 0, 1, 80, False),     # fast path
    (dict(mismatches=1, lcf_thres=60, island_of_exact_match=25), 10, 1, 80,
     False),
    (dict(mismatches=2, lcf_thres=60), 20, 3, 80, False),    # multi-chrom
    (dict(mismatches=2, lcf_thres=60), 30, 1, 75, False),
    (dict(mismatches=2, lcf_thres=100), 30, 2, 150, False),
    (dict(mismatches=5, lcf_thres=60), 30, 1, 80, False),
    (dict(mismatches=3, lcf_thres=50), 40, 2, 80, True),
], ids=["m2_l60_e30", "m0", "fast_m2_l80", "island25", "multichrom", "L75",
        "L150", "m5", "contrived_alphabet"])
def test_verify_windows_matches_stage_c_jit(model_kw, ext, n_chrs, L,
                                            contrived):
    sc = _corpus_scan(seed=23, model_kw=model_kw, probe_length=L,
                      contrived=contrived, n_chrs=n_chrs)
    assert sc.L == L
    args = _stage_c_parity(sc, model_kw, ext)
    if model_kw["lcf_thres"] == 80:
        assert args["fast_ok"]
    if contrived:
        # A-H and N are codes; Z, which no probe holds, reads as PAD
        assert sc.searcher.alphabet.size == 9
        st = sc.st
        inside = torch.cat([st["mega"][a:b] for a, b in zip(
            st["seq_starts"].tolist(), st["seq_ends"].tolist())])
        assert bool((inside == 0).any())


def test_verify_windows_k0_sequences_shorter_than_probes():
    """K = 0 with the fast path on: chromosomes shorter than the 80 bp
    probes take the exact-count path when at least k_seed long (the
    seed is set to 20 so pairs reach them)."""
    rng = np.random.default_rng(31)
    model_kw = dict(mismatches=0, lcf_thres=80)
    sc = Scan(_short_chr_genomes(rng), model_kw, k_seed=20)
    assert sc.searcher.fast_ok
    _stage_c_parity(sc, model_kw, ext=5)


# ----------------------------------------------------------------------
# K4 segmented_merge
# ----------------------------------------------------------------------

def _jax_merge(k, s, e):
    n = len(k)
    mk, ms, me, nr = sj._merge_jit(
        jnp.asarray(k.astype(np.int32))[None],
        jnp.asarray(s.astype(np.int32))[None],
        jnp.asarray(e.astype(np.int32))[None], OUT=sj._next_pow2(n))
    nr = int(nr)
    return tuple(np.asarray(x)[:nr].astype(np.int64) for x in (mk, ms, me))


def test_segmented_merge_matches_merge_and_union_jit():
    rng = np.random.default_rng(3)
    n, nU = 5000, 7
    k = rng.integers(0, 60, size=n)
    s = rng.integers(0, 3000, size=n)
    e = s + rng.integers(1, 80, size=n)
    want = _jax_merge(k, s, e)
    got = si.segmented_merge(*(torch.from_numpy(x) for x in (k, s, e)))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w)

    W = sj._next_pow2(len(want[0]))
    pad = W - len(want[0])
    uk, us, ue, nr = sj._union_jit(
        jnp.asarray(np.concatenate([want[0], np.full(pad, I32MAX)]).astype(
            np.int32)),
        jnp.asarray(np.concatenate([want[1], np.zeros(pad)]).astype(
            np.int32)),
        jnp.asarray(np.concatenate([want[2], np.zeros(pad)]).astype(
            np.int32)), jnp.int32(nU), OUT=W)
    nr = int(nr)
    tk, ts, te = si.segmented_merge(got[0] % nU, got[1], got[2])
    assert np.array_equal(tk.numpy(), np.asarray(uk)[:nr])
    assert np.array_equal(ts.numpy(), np.asarray(us)[:nr])
    assert np.array_equal(te.numpy(), np.asarray(ue)[:nr])


def _jax_union(merged, nU):
    """_union_jit on merged rows (numpy), padded as catch_tpu pads."""
    W = sj._next_pow2(len(merged[0]))
    pad = W - len(merged[0])
    uk, us, ue, nr = sj._union_jit(
        jnp.asarray(np.concatenate([merged[0], np.full(pad, I32MAX)])
                    .astype(np.int32)),
        jnp.asarray(np.concatenate([merged[1], np.zeros(pad)])
                    .astype(np.int32)),
        jnp.asarray(np.concatenate([merged[2], np.zeros(pad)])
                    .astype(np.int32)), jnp.int32(nU), OUT=W)
    nr = int(nr)
    return tuple(np.asarray(x)[:nr].astype(np.int64) for x in (uk, us, ue))


def _merge_rows(case, rng):
    """(key, start, end) of one hard case for the merge, in the order a
    caller might hand them over."""
    if case == "unsorted":
        n = 4000
        k = rng.integers(0, 300, size=n)
        s = rng.integers(0, 20_000, size=n)
        e = s + rng.integers(0, 200, size=n)
    elif case == "ties_and_duplicates":
        base_k = rng.integers(0, 40, size=300)
        base_s = rng.integers(0, 5000, size=300)
        pick = rng.integers(0, 300, size=3000)
        k, s = base_k[pick], base_s[pick]
        e = s + rng.integers(0, 120, size=3000)
        e[::5] = s[::5]                      # empty spans among them
        k = np.concatenate([k, k[:500]])     # exact duplicates
        s = np.concatenate([s, s[:500]])
        e = np.concatenate([e, e[:500]])
    elif case == "touching_and_nested":
        starts = np.cumsum(rng.integers(1, 50, size=1000))
        ends = np.concatenate([starts[1:], [starts[-1] + 10]])
        touch = (np.repeat(np.arange(10), 100), starts, ends)
        outer_s = rng.integers(0, 10_000, size=400)
        outer_e = outer_s + rng.integers(100, 1000, size=400)
        inner_s = outer_s + rng.integers(0, 50, size=400)
        inner_e = np.minimum(inner_s + rng.integers(0, 50, size=400), outer_e)
        nest_k = rng.integers(10, 30, size=400)
        k = np.concatenate([touch[0], nest_k, nest_k])
        s = np.concatenate([touch[1], outer_s, inner_s])
        e = np.concatenate([touch[2], outer_e, inner_e])
    else:   # one row a key, over many keys
        n = 5000
        k = rng.permutation(n) * 3 + 1
        s = rng.integers(0, 1 << 20, size=n)
        e = s + rng.integers(0, 1000, size=n)
    order = rng.permutation(len(k))
    return k[order], s[order], e[order]


@pytest.mark.parametrize("case", ["unsorted", "ties_and_duplicates",
                                  "touching_and_nested", "one_row_a_key"])
def test_segmented_merge_hard_cases_match_merge_and_union_jit(case):
    """The port's merge and union against _merge_jit and _union_jit on
    rows in no order, with (key, start) ties, duplicates, touching and
    nested spans, and one row a key."""
    rng = np.random.default_rng(len(case))
    nU = 7
    k, s, e = _merge_rows(case, rng)
    want = _jax_merge(k, s, e)
    got = si.segmented_merge(*(torch.from_numpy(x) for x in (k, s, e)))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w)
    assert len(want[0]) < len(k) or case == "one_row_a_key"
    union = si.segmented_merge(got[0] % nU, got[1], got[2])
    for g, w in zip(union, _jax_union(want, nU)):
        assert np.array_equal(g.numpy(), w)


@pytest.mark.parametrize("bad", ["key_2^31", "negative_key", "start_2^32",
                                 "end_before_start"])
def test_segmented_merge_rejects_rows_out_of_range(bad):
    k = torch.tensor([0, 5, 9], dtype=torch.int64)
    s = torch.tensor([10, 20, 30], dtype=torch.int64)
    e = torch.tensor([15, 25, 35], dtype=torch.int64)
    if bad == "key_2^31":
        k[1] = 1 << 31
    elif bad == "negative_key":
        k[0] = -1
    elif bad == "start_2^32":
        s[2], e[2] = 1 << 32, 1 << 32
    else:
        e[1] = 19
    with pytest.raises(ValueError, match="segmented_merge"):
        si.segmented_merge(k, s, e)


@pytest.mark.parametrize("n,kmax,smax,tile,want_shift,want_word32", [
    (3_209_031, 174, 18_845, si.MERGE_TILE, 0, True),        # the union
    (3_670_370, 18_730 * 175 - 1, 18_845, si.MERGE_TILE, 7, False),
    (1, (1 << 31) - 1, (1 << 32) - 1, si.MERGE_TILE, 17, False),
    (1_000_000, 0, 5000, 64, 0, True),                       # one key
    (10, (1 << 31) - 1, 3, 64, 31, False),
], ids=["union", "pair", "ranges_full", "one_key", "keys_spread"])
def test_merge_plan_buckets_and_words(n, kmax, smax, tile, want_shift,
                                      want_word32):
    """The bucket plan of the card route: whole keys a bucket, a word
    sk << ib | row within 64 bits (32 where it fits), and a bucket count
    near n / 128 and never above 2^14 + 1 where the word caps the
    shift."""
    plan = si._merge_plan(n, 0, kmax, smax, tile)
    assert plan["shift"] == want_shift
    assert plan["word32"] == want_word32
    assert plan["shift"] + plan["sb"] + plan["ib"] <= (32 if want_word32
                                                       else 64)
    assert plan["n_b"] == (kmax >> plan["shift"]) + 1
    assert plan["n_b"] <= max(n // 128, (1 << 14) + 1)
    assert plan["tile"] == (tile if want_word32 else tile // 2)


def test_merge_tiers_count_every_bucket():
    rng = np.random.default_rng(8)
    k = torch.from_numpy(np.concatenate([rng.integers(0, 2000, size=6000),
                                         np.full(400, 2001)]))
    s = torch.from_numpy(rng.integers(0, 1000, size=k.numel()))
    t = si.merge_tiers(k, s, s + 1, tile=300)
    assert t["single"] + t["warp"] + t["block"] + t["device"] == t["n_b"]
    assert t["largest"] >= 400 and t["device"] >= 1
    assert si.merge_tiers(k[:0], s[:0], s[:0]) == {}


def test_segmented_merge_group_longer_than_out_width():
    """The inputs of catch_tpu's regression test: one long interval and
    many short gapped ones in one group merge into one run."""
    n = 1 << 14
    k = np.zeros(n, np.int64)
    s = np.zeros(n, np.int64)
    e = np.zeros(n, np.int64)
    s[0], e[0] = 0, 100000
    s[1:] = 3 * np.arange(1, n)
    e[1:] = s[1:] + 1
    mk, ms, me, nr = sj._merge_runs(
        jnp.asarray(k.astype(np.int32)), jnp.asarray(s.astype(np.int32)),
        jnp.asarray(e.astype(np.int32)), n)
    got = si.segmented_merge(*(torch.from_numpy(x) for x in (k, s, e)))
    assert int(nr) == 1 == got[0].numel()
    assert (int(got[1][0]), int(got[2][0])) == (int(ms[0]), int(me[0])) \
        == (0, 100000)


def test_segmented_merge_union_group_longer_than_union_cap():
    nU = 4
    n = 1 << 13
    k = np.arange(n, dtype=np.int64) * nU + 1
    s = np.zeros(n, np.int64)
    e = np.zeros(n, np.int64)
    s[0], e[0] = 0, 50000
    s[1:] = 5 * np.arange(1, n)
    e[1:] = s[1:] + 2
    uk, us, ue, nr = sj._union_jit(
        jnp.asarray(k.astype(np.int32)), jnp.asarray(s.astype(np.int32)),
        jnp.asarray(e.astype(np.int32)), jnp.int32(nU), OUT=1 << 8)
    tk, ts, te = si.segmented_merge(*(torch.from_numpy(x) for x in (
        k % nU, s, e)))
    assert int(nr) == 1 == tk.numel()
    assert (int(tk[0]), int(ts[0]), int(te[0])) == \
        (int(uk[0]), int(us[0]), int(ue[0])) == (1, 0, 50000)


# ----------------------------------------------------------------------
# K9 pack_merged
# ----------------------------------------------------------------------

def _merged_rows(seed, n, b_pos, n_key_jumps, n_long):
    """Merged-like rows sorted by key: small key steps, a few jumps and
    lengths beyond 16 bits, starts filling b_pos bytes."""
    rng = np.random.default_rng(seed)
    dk = rng.integers(0, 4, size=n)
    dk[rng.choice(n, size=n_key_jumps, replace=False)] = rng.integers(
        0x10000, 0x200000, size=n_key_jumps)
    k = np.cumsum(dk)
    top = min(1 << (8 * b_pos), 1 << 30)
    s = rng.integers(0, top, size=n)
    s[0] = top - 1            # a start that uses every byte
    ln = rng.integers(0, 3000, size=n)
    ln[rng.choice(n, size=n_long, replace=False)] = rng.integers(
        0x10000, 0x20000, size=n_long)
    ln[1] = 0xFFFF            # the largest length that does not escape
    return k, s, s + ln


@pytest.mark.parametrize("b_pos,n_key_jumps,n_long", [
    (2, 0, 0), (2, 3, 2), (3, 5, 0), (4, 2, 7)])
def test_pack_merged_matches_pack_merged_jit(b_pos, n_key_jumps, n_long):
    """The packed bytes and the escape lists equal _pack_merged_jit's,
    and both decoders give the rows back."""
    n = 3000
    k, s, e = _merged_rows(b_pos + n_long, n, b_pos, n_key_jumps, n_long)
    N = sj._next_pow2(n)
    pad = N - n + 5

    def j32(x):
        return jnp.asarray(np.concatenate([x, np.zeros(pad, np.int64)])
                           .astype(np.int32))

    packed_j, idx_j, key_j, end_j, n_esc = sj._pack_merged_jit(
        j32(k), j32(s), j32(e), jnp.int32(n), N=N, b_pos=b_pos,
        ECAP=sj._ESC_CAP)
    n_esc = int(n_esc)
    got = si.pack_merged(*(torch.from_numpy(x) for x in (k, s, e)), b_pos)
    assert got[0].dtype == torch.uint8
    assert np.array_equal(got[0].numpy(),
                          np.asarray(packed_j)[:n * (4 + b_pos)])
    assert got[1].numel() == n_esc >= min(1, n_key_jumps + n_long)
    for g, w in zip(got[1:], (idx_j, key_j, end_j)):
        assert np.array_equal(g.numpy(), np.asarray(w)[:n_esc])

    rows = si.unpack_merged(*(x.numpy() for x in got), b_pos)
    want = sj._unpack_merged(dict(n_merged=n, packed=(
        packed_j, idx_j, key_j, end_j, n_esc, N, b_pos)))
    for g, w, x in zip(rows, want, (k, s, e)):
        assert g.dtype == np.int64
        assert np.array_equal(g, w) and np.array_equal(g, x)


def test_pack_merged_empty_and_bad_width():
    e = torch.empty(0, dtype=torch.int64)
    out = si.pack_merged(e, e, e, 2)
    assert all(x.numel() == 0 for x in out)
    assert all(x.size == 0 for x in si.unpack_merged(
        *(x.numpy() for x in out), 2))
    with pytest.raises(ValueError):
        si.pack_merged(e, e, e, 5)
    assert [si.pack_width(m) for m in (0, 0xFFFF, 0x10000, 0xFFFFFF,
                                       0x1000000)] == [2, 2, 3, 3, 4]


def test_wrappers_reject_mixed_devices_and_dtypes():
    t = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(TypeError):
        si.segmented_merge(t.to(torch.int32), t, t)
    with pytest.raises(ValueError):
        si.rolling_hash(torch.zeros(3, dtype=torch.uint8), 4, 1, 2, 10)
    with pytest.raises(ValueError):
        si._on_cpu(t, torch.zeros(1, device="meta"))
