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


def _mutate(rng, seq, rate):
    seq = seq.copy()
    m = rng.random(len(seq)) < rate
    seq[m] = rng.choice(BASES, size=int(m.sum()))
    return seq


def _genomes(rng, n_genomes, n_len, mut=0.03, n_chrs=1):
    """Genomes as lists of chromosome strings, mutated from one base."""
    base = rng.choice(BASES, size=n_len)
    out = []
    for _ in range(n_genomes):
        seq = _mutate(rng, base, mut)
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


class Scan:
    """The port's scan inputs for a corpus, probes tiled from the
    first chromosome of every genome (80 bp every 40)."""

    def __init__(self, genomes, model_kw, k_seed=None):
        seqs = [s for g in genomes for s in g]
        probes = DuplicateFilter()._filter(
            make_candidate_probes_from_sequences(
                [g[0] for g in genomes], probe_length=80, probe_stride=40))
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


def _corpus_scan(seed=17, model_kw=None, **kw):
    rng = np.random.default_rng(seed)
    return Scan(_genomes(rng, 4, 1000, **kw),
                model_kw or dict(mismatches=2, lcf_thres=60))


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


def test_rolling_hash_table_matches_build_table_jit():
    sc = _corpus_scan()
    jh, jp, jpos = (np.asarray(x).astype(np.int64) for x in sc.jax_table())
    th, tp, tpos = (x.numpy() for x in si.build_table(sc.st["codes"], sc.kj))
    jv, tv = jh != si.HMAX, th != si.HMAX
    assert jv.sum() == tv.sum() > 0
    assert sorted(zip(jh[jv], jp[jv], jpos[jv])) == \
        sorted(zip(th[tv], tp[tv], tpos[tv]))
    # stable: equal hashes keep flat-index order
    flat_idx = tp * (sc.L + sc.kj) + tpos
    same = th[1:] == th[:-1]
    assert np.all(flat_idx[1:][same] > flat_idx[:-1][same])


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
    tlo, tcnt = si.lookup_ranges_plain(tbl[0], tq)
    assert np.array_equal(tcnt.numpy(), cnt)
    hit = cnt > 0
    assert hit.any()
    assert np.array_equal(tlo.numpy()[hit], lo[hit])

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

    # The JAX program, at the shapes its own pipeline would give it.
    L, P = sc.L, sc.P
    Lw = L + 4
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
        jnp.int32(args["lcf"]), jnp.int32(sc.nU), L=L, K=args["K"], C=C,
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


@pytest.mark.parametrize("model_kw,ext,n_chrs", [
    (dict(mismatches=2, lcf_thres=60), 30, 1),
    (dict(mismatches=0, lcf_thres=60), 0, 1),
    (dict(mismatches=2, lcf_thres=80), 0, 1),     # fast path
    (dict(mismatches=1, lcf_thres=60, island_of_exact_match=25), 10, 1),
    (dict(mismatches=2, lcf_thres=60), 20, 3),    # multi-chromosome
], ids=["m2_l60_e30", "m0", "fast_m2_l80", "island25", "multichrom"])
def test_verify_windows_matches_stage_c_jit(model_kw, ext, n_chrs):
    sc = _corpus_scan(seed=23, model_kw=model_kw, n_chrs=n_chrs)
    args = _stage_c_parity(sc, model_kw, ext)
    if model_kw["lcf_thres"] == 80:
        assert args["fast_ok"]


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
