"""catch_tpu_torch's CUDA kernels against their plain-PyTorch twins, on
the card.

Every test here needs a CUDA device and skips without one.  The card's
host has no JAX, so this file imports neither jax nor catch_tpu, and it
runs there without tests/conftest.py (which imports jax):

    python -m pytest --noconftest -o markers=cuda -q tests/test_torch_cuda.py

The inputs cover the paths the smoke run (chip_smoke.py) does not: the
window fast path, islands, several chromosomes, sequences shorter than
the probes, merge groups that cross the kernel's 1024-row blocks at
every boundary case, the span scan without minimizers (w = 1) and in
many expansion slabs, and empty inputs.  Every comparison is exact.
"""

import numpy as np
import pytest
import torch

from catch_tpu_torch.filters.candidates import (
    make_candidate_probes_from_sequences)
from catch_tpu_torch.ops import scan_instance as si
from catch_tpu_torch.ops import scan_sparse as ss
from catch_tpu_torch.ops.cover import CoverModel, ProbeSearcher

BASES = np.array(list("ACGT"))

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _assert_equal(got, want):
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and w.device.type == "cuda"
        assert torch.equal(g, w)


def _genomes(seed, n_chrs, short):
    rng = np.random.default_rng(seed)
    base = rng.choice(BASES, size=1200)
    out = []
    for _ in range(5):
        seq = base.copy()
        m = rng.random(len(seq)) < 0.04
        seq[m] = rng.choice(BASES, size=int(m.sum()))
        bounds = np.linspace(0, len(seq), n_chrs + 1).astype(int)
        chrs = ["".join(seq[a:b]) for a, b in zip(bounds[:-1], bounds[1:])]
        if short:
            chrs += ["".join(seq[100:150]), "".join(seq[300:370])]
        out.append(chrs)
    return out


@pytest.mark.parametrize("model_kw,ext,n_chrs,short,k_seed", [
    (dict(mismatches=2, lcf_thres=60), 30, 1, False, None),
    (dict(mismatches=0, lcf_thres=60), 0, 1, False, None),
    (dict(mismatches=2, lcf_thres=80), 0, 1, False, None),
    (dict(mismatches=1, lcf_thres=60, island_of_exact_match=25), 10, 1,
     False, None),
    (dict(mismatches=2, lcf_thres=60), 20, 3, False, None),
    (dict(mismatches=0, lcf_thres=80), 5, 1, True, 20),
], ids=["m2_l60_e30", "m0", "fast_m2_l80", "island25", "multichrom",
        "k0_short_seqs"])
def test_kernels_equal_twins(cuda, model_kw, ext, n_chrs, short, k_seed):
    genomes = _genomes(11, n_chrs, short)
    seqs = [s for g in genomes for s in g]
    probes = list(dict.fromkeys(make_candidate_probes_from_sequences(
        [g[0] for g in genomes], probe_length=80, probe_stride=40)))
    searcher = ProbeSearcher(probes, CoverModel(**model_kw))
    if k_seed is not None:
        searcher.k_seed = k_seed
    univ, off = [], []
    for j, g in enumerate(genomes):
        pos = 0
        for s in g:
            univ.append(j)
            off.append(pos)
            pos += len(s)
    st, total, _ = si.prepare_corpus(searcher, seqs, univ, off,
                                     np.arange(len(probes)), cuda)
    kj, s = si.join_params_stride(searcher)
    n_samples = -(-total // s)

    q = si.rolling_hash(st["mega"], n_samples, s, kj, total - kj)
    _assert_equal([q], [si._rolling_hash_plain(st["mega"], n_samples, s,
                                               kj, total - kj)])
    tbl = si.build_table(st["codes"], kj)

    pc, ac = si.lookup_expand(*tbl, q, s)
    _assert_equal((pc, ac), si._lookup_expand_plain(*tbl, q, s))
    assert pc.numel() > 0

    island = model_kw.get("island_of_exact_match", 0)
    args = dict(K=int(searcher.K_static), k_seed=int(searcher.k_seed),
                lcf=int(searcher.lcf_static),
                seed_req=max(int(searcher.k_seed), island),
                fast_ok=bool(searcher.fast_ok), ext=ext, nU=len(genomes))
    vt = (st["mega"], st["codes"], st["lens"], pc, ac, st["seq_starts"],
          st["seq_ends"], st["seq_lens"], st["chrom_off"], st["univ_of_seq"])
    spans = si.verify_windows(*vt, **args)
    _assert_equal(spans, si._verify_windows_plain(*vt, **args))
    assert spans[0].numel() > 0

    merged = si.segmented_merge(*spans)
    _assert_equal(merged, si._segmented_merge_plain(*spans))
    union_in = (merged[0] % len(genomes), merged[1], merged[2])
    _assert_equal(si.segmented_merge(*union_in),
                  si._segmented_merge_plain(*union_in))


@pytest.mark.parametrize("n", [1, 1023, 1024, 1025, 2049, 5000,
                               (1 << 20) + 1025])
def test_segmented_merge_block_boundaries(cuda, n):
    """Groups that start, end and run across the 1024-row blocks, and
    (at the largest n) more block aggregates than one carry chunk."""
    rng = np.random.default_rng(n)
    k = np.sort(rng.integers(0, max(1, n // 3000), size=n))
    s = rng.integers(0, 1 << 20, size=n)
    e = s + rng.integers(1, 400, size=n)
    s[::997] = 0
    e[::997] = 1 << 20        # long spans that swallow their group
    k, s, e = (torch.from_numpy(x).to(cuda) for x in (k, s, e))
    _assert_equal(si.segmented_merge(k, s, e),
                  si._segmented_merge_plain(k, s, e))


def test_empty_inputs(cuda):
    e = torch.empty(0, dtype=torch.int64, device=cuda)
    assert all(x.numel() == 0 for x in si.segmented_merge(e, e, e))
    assert si.rolling_hash(torch.zeros(4, dtype=torch.uint8, device=cuda),
                           0, 1, 2, 0).numel() == 0
    tbl = torch.tensor([5, 9, si.HMAX], dtype=torch.int64, device=cuda)
    q = torch.tensor([1, 2, si.HMAX], dtype=torch.int64, device=cuda)
    p, a = si.lookup_expand(tbl, tbl, tbl, q, 3)
    assert p.numel() == a.numel() == 0


@pytest.mark.parametrize("b_pos,n", [(2, 1), (2, 5000), (3, 70000),
                                     (4, 1 << 20)])
def test_pack_merged_equals_twin(cuda, b_pos, n):
    """Packed bytes and escapes, with key jumps and lengths past 16 bits
    and a start that fills every byte; the host decoder gives the rows
    back."""
    rng = np.random.default_rng(n)
    dk = rng.integers(0, 4, size=n)
    dk[::1777] = 0x12345
    k = np.cumsum(dk)
    top = min(1 << (8 * b_pos), 1 << 40)
    s = rng.integers(0, top, size=n)
    s[-1] = top - 1
    e = s + rng.integers(0, 3000, size=n)
    e[::2311] += 0x10000
    rows = [torch.from_numpy(x).to(cuda) for x in (k, s, e)]
    got = si.pack_merged(*rows, b_pos)
    _assert_equal(got, si._pack_merged_plain(*rows, b_pos))
    assert got[1].numel() >= 1
    for g, w in zip(si.unpack_merged(*(x.cpu().numpy() for x in got),
                                     b_pos), (k, s, e)):
        assert np.array_equal(g, w)
    empty = torch.empty(0, dtype=torch.int64, device=cuda)
    assert all(x.numel() == 0 for x in si.pack_merged(empty, empty, empty,
                                                       b_pos))


def test_design_on_cuda_equals_cpu(cuda):
    """The whole slice on the card gives the CPU twins' probe set."""
    from catch_tpu_torch.filters.set_cover_filter import SetCoverFilter
    from catch_tpu_torch.genome import Genome

    genomes = [Genome.from_one_seq(g[0]) for g in _genomes(4, 1, False)]
    probes = make_candidate_probes_from_sequences(
        [g.seqs[0] for g in genomes], probe_length=80, probe_stride=40)
    out = {}
    for dev in ("cpu", "cuda"):
        f = SetCoverFilter(2, 60, cover_extension=25, device=dev)
        out[dev] = [p.seq_str for p in f.filter(
            [list(probes)], [genomes], input_is_grouped=True)[0]]
    assert out["cuda"] == out["cpu"] and out["cpu"]


def _span_corpus(seed):
    """Sequences mutated from one shared base, plus two shorter than the
    60 bp probes (one of them empty)."""
    rng = np.random.default_rng(seed)
    base = rng.choice(BASES, size=900)
    seqs = []
    for _ in range(6):
        seq = base[:int(rng.integers(150, 900))].copy()
        m = rng.random(len(seq)) < 0.025
        seq[m] = rng.choice(BASES, size=int(m.sum()))
        seqs.append("".join(seq))
    return seqs + ["ACGT", ""]


@pytest.mark.parametrize("model_kw,k", [
    (dict(mismatches=2, lcf_thres=40), 20),
    (dict(mismatches=2, lcf_thres=60), 20),
    (dict(mismatches=0, lcf_thres=30), 20),
    (dict(mismatches=2, lcf_thres=40, island_of_exact_match=25), 20),
    (dict(mismatches=2, lcf_thres=40), 10),
], ids=["mismatch", "fast_path", "exact", "island", "w1_k10"])
def test_span_kernels_equal_twins(cuda, model_kw, k):
    """expand_join and verify_spans against their twins on the card, and
    the whole span scan on the card against the CPU."""
    seqs = _span_corpus(3)
    probes = list(dict.fromkeys(make_candidate_probes_from_sequences(
        seqs[:6], probe_length=60, probe_stride=25)))
    searcher = ProbeSearcher(probes, CoverModel(**model_kw),
                             kmer_probe_map_k=k, device=cuda)
    mega, starts, ends, total = ss.corpus_codes(searcher, seqs)
    lo, cnt, pos = (torch.from_numpy(x).to(cuda)
                    for x in ss.join_runs(searcher, mega[:total]))
    assert searcher._join_kw[1] == (1 if k == 10 else 9)
    tbl = ss.join_table(searcher, cuda)
    pa = ss.expand_join(lo, cnt, pos, *tbl, searcher.Lmax)
    _assert_equal(pa, ss._expand_join_plain(lo, cnt, pos, *tbl,
                                            searcher.Lmax))
    cand = ss.keep_candidates(searcher, *pa,
                              torch.from_numpy(starts).to(cuda),
                              torch.from_numpy(ends).to(cuda))
    vt = (torch.from_numpy(mega).to(cuda),
          torch.from_numpy(searcher.probe_codes).to(cuda)) + cand
    vargs = ss.verify_args(searcher)
    spans = ss.verify_spans(*vt, **vargs)
    _assert_equal(spans, ss._verify_spans_plain(*vt, **vargs))
    assert spans[0].numel() > 0
    on_cpu = ProbeSearcher(probes, CoverModel(**model_kw),
                           kmer_probe_map_k=k, device=torch.device("cpu"))
    for g, w in zip(searcher.find_probe_covers_flat(seqs),
                    on_cpu.find_probe_covers_flat(seqs)):
        assert np.array_equal(g, w)


def test_span_scan_many_slabs(cuda, monkeypatch):
    """Expansion slabs of 256 hits on the card give the CPU's spans."""
    seqs = _span_corpus(4)
    probes = list(dict.fromkeys(make_candidate_probes_from_sequences(
        seqs[:6], probe_length=60, probe_stride=25)))
    want = ProbeSearcher(probes, CoverModel(2, 40), device=torch.device(
        "cpu")).find_probe_covers_flat(seqs)
    monkeypatch.setattr(ss, "_EXPAND_SLAB", 1 << 8)
    ss.expand_join.launches = 0
    got = ProbeSearcher(probes, CoverModel(2, 40),
                        device=cuda).find_probe_covers_flat(seqs)
    assert ss.expand_join.launches > 5
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def test_span_kernels_empty_inputs(cuda):
    e = torch.empty(0, dtype=torch.int64, device=cuda)
    p, a = ss.expand_join(e, e, e, e, e, 60)
    assert p.numel() == a.numel() == 0
    z = torch.zeros(3, dtype=torch.int64, device=cuda)
    p, a = ss.expand_join(z, z, z, z, z, 60)     # runs of no hits
    assert p.numel() == a.numel() == 0
    mega = torch.zeros(8, dtype=torch.uint8, device=cuda)
    codes = torch.zeros((1, 4), dtype=torch.uint8, device=cuda)
    out = ss.verify_spans(mega, codes, e, e, e, e, e, e, K=2, k_seed=4,
                          seed_req=4, fast_ok=False)
    assert all(x.numel() == 0 for x in out)
    with pytest.raises(ValueError, match="K=63"):
        ss.verify_spans(mega, codes, e, e, e, e, e, e, K=63, k_seed=4,
                        seed_req=4, fast_ok=False)


def test_identify_design_on_cuda_equals_cpu(cuda):
    """Identification ranks over two groupings, on the card and on the
    CPU, give one probe set."""
    from catch_tpu_torch.designer import ProbeDesigner
    from catch_tpu_torch.filters.duplicate import DuplicateFilter
    from catch_tpu_torch.filters.set_cover_filter import SetCoverFilter
    from catch_tpu_torch.genome import Genome

    groups = [[Genome.from_one_seq(g[0]) for g in _genomes(s, 1, False)]
              for s in (5, 6)]
    out = {}
    for dev in ("cpu", "cuda"):
        scf = SetCoverFilter(2, 60, identify=True, coverage=0.3,
                             cover_extension=10, device=dev)
        d = ProbeDesigner(groups, [DuplicateFilter(), scf],
                          probe_length=80, probe_stride=40)
        d.design()
        out[dev] = [p.seq_str for p in d.final_probes]
    assert out["cuda"] == out["cpu"] and out["cpu"]


def _signatures(seed, n, N, hi):
    """n ascending int32 signature rows of width N drawn from [0, hi): a
    small hi puts duplicates inside rows and ties between pairs."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.sort(rng.integers(0, hi, size=(n, N)),
                                    axis=1).astype(np.int32))


@pytest.mark.parametrize("N,hi", [(1, 3), (40, 60), (100, 150),
                                  (100, 2**31 - 1), (300, 400),
                                  (1000, 1500)],
                         ids=["N1", "N40", "N100", "N100_wide", "N300",
                              "N1000_smem_opt_in"])
def test_minhash_caps_equal_twins(cuda, N, hi):
    from catch_tpu_torch.ops import minhash as mh

    qs_c, rs_c = _signatures(1, 37, N, hi), _signatures(2, 29, N, hi)
    qs, rs = qs_c.to(cuda), rs_c.to(cuda)
    thr, early = max(1, N // 3), max(1, N // 2)
    for kernel, twin, args in (
            (mh.minhash_dists, mh._minhash_dists_plain, ()),
            (mh.minhash_codes, mh._minhash_codes_plain, (thr, early)),
            (mh.minhash_caps, mh._minhash_caps_plain, ())):
        got = kernel(qs, rs, *args)
        torch.cuda.synchronize()
        want = twin(qs, rs, *args)
        assert got.dtype == want.dtype
        assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
        assert torch.equal(got.cpu(), twin(qs_c, rs_c, *args))
    for n_reps in (0, 1, 17, 29):
        got = mh.minhash_assign(qs, rs, n_reps, thr)
        torch.cuda.synchronize()
        _assert_equal(got, mh._minhash_assign_plain(qs, rs, n_reps, thr))
    # a query against copies of itself: every representative ties
    same = qs[:1].repeat(20, 1)
    best, ok = mh.minhash_assign(qs[:5], same, 20, thr)
    _assert_equal((best, ok), mh._minhash_assign_plain(qs[:5], same, 20,
                                                       thr))


def test_minhash_caps_raise_on_unsorted_rows(cuda):
    from catch_tpu_torch.ops import minhash as mh

    sigs = _signatures(3, 8, 40, 1000).to(cuda)
    bad = sigs.clone()
    bad[5] = torch.flip(bad[5], [0])
    for fn, args in ((mh.minhash_dists, ()), (mh.minhash_codes, (3, 5)),
                     (mh.minhash_caps, ()), (mh.minhash_assign, (8, 3))):
        with pytest.raises(ValueError, match="not ascending"):
            fn(sigs, bad, *args)
        with pytest.raises(ValueError, match="not ascending"):
            fn(bad, sigs, *args)


def test_minhash_sig_equals_twin(cuda):
    from catch_tpu_torch.ops import minhash as mh

    rng = np.random.default_rng(4)
    p = mh.MERSENNE_P
    codes = np.concatenate([rng.integers(0, p, size=(700, 91)),
                            rng.integers(p - 1000, p, size=(300, 91))])
    ab = np.stack([np.concatenate([rng.integers(1, p + 1, size=60),
                                   rng.integers(p - 100, p + 1, size=15)]),
                   rng.integers(0, p + 1, size=75)], 1)
    codes = torch.from_numpy(codes.astype(np.int32))
    ab = torch.from_numpy(ab.astype(np.int32))
    got = mh.minhash_sig(codes.to(cuda), ab.to(cuda))
    torch.cuda.synchronize()
    want = mh._minhash_sig_plain(codes.to(cuda), ab.to(cuda))
    _assert_equal((got,), (want,))
    assert torch.equal(got.cpu(), mh._minhash_sig_plain(codes, ab))
