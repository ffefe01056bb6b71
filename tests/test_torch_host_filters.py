"""The port's host filters against catch_tpu's, on the CPU.

ReverseComplementFilter, NExpansionFilter, PolyAFilter, FastaFilter,
NaiveRedundantFilter, DominatingSetFilter and AdapterFilter of
catch_tpu_torch take the inputs of catch_tpu's own filter tests
(tests/test_filters.py) and seeded random ones; every output (sequences,
headers and order) and every vote must equal catch_tpu's exactly.  The
port's AdapterFilter takes its votes from the span scan's plain-PyTorch
twins here (device "cpu"); catch_tpu's from its per-sequence host scan.
"""

import random

import numpy as np
import pytest

from catch_tpu.filters import adapter as jadapter
from catch_tpu.filters import dominating_set as jdominating
from catch_tpu.filters import fasta as jfasta
from catch_tpu.filters import n_expansion as jn_expansion
from catch_tpu.filters import naive_redundant as jnaive
from catch_tpu.filters import polya as jpolya
from catch_tpu.filters import reverse_complement as jrc
from catch_tpu.filters.duplicate import DuplicateFilter as JDuplicate
from catch_tpu.filters.set_cover_filter import SetCoverFilter as JSetCover
from catch_tpu.genome import Genome as JGenome
from catch_tpu.probe import Probe as JProbe
from catch_tpu_torch.filters import adapter as tadapter
from catch_tpu_torch.filters import dominating_set as tdominating
from catch_tpu_torch.filters import fasta as tfasta
from catch_tpu_torch.filters import n_expansion as tn_expansion
from catch_tpu_torch.filters import naive_redundant as tnaive
from catch_tpu_torch.filters import polya as tpolya
from catch_tpu_torch.filters import reverse_complement as trc
from catch_tpu_torch.filters.duplicate import DuplicateFilter as TDuplicate
from catch_tpu_torch.filters.set_cover_filter import (
    SetCoverFilter as TSetCover)
from catch_tpu_torch.genome import Genome as TGenome
from catch_tpu_torch.probe import Probe as TProbe

ADAPTER_A = ("ATACGCCATGCTGGGTCTCC", "CGTACTTGGGAGTCGGCCAT")
ADAPTER_B = ("AGGCCCTGGCTGCTGATATG", "GACCTTTTGGGACAGCGGTG")


def _both(fn):
    """fn(probe class, package modules) for catch_tpu and the port."""
    return fn(JProbe, "j"), fn(TProbe, "t")


def _out(probes):
    return [(p.seq_str, p.header) for p in probes]


def _random_probes(rng, n, length, alphabet="ACGT"):
    return ["".join(rng.choice(list(alphabet), size=length))
            for _ in range(n)]


# ----------------------------------------------------------------------
# ReverseComplementFilter, NExpansionFilter, PolyAFilter, FastaFilter
# ----------------------------------------------------------------------

@pytest.mark.parametrize("seqs", [["ATCG"], ["ANCG"], ["ACGTTGCA", "GGGA",
                                                       "NNAT"]])
def test_reverse_complement_filter_equals_catch_tpu(seqs):
    j, t = (_out(m.ReverseComplementFilter()._filter(
        [P.from_str(s) for s in seqs])) for P, m in ((JProbe, jrc),
                                                    (TProbe, trc)))
    assert t == j
    assert len(t) == 2 * len(seqs)


@pytest.mark.parametrize("seqs, limit", [
    (["ATCG"], 3), (["ANCG"], 3), (["ANCN"], 3), (["NNNN"], 1),
    (["NNNN"], None), (["NANNNAANNCG", "ACGT", "NNNNNNNN"], 2)])
def test_n_expansion_filter_equals_catch_tpu(seqs, limit):
    outs = []
    for P, m in ((JProbe, jn_expansion), (TProbe, tn_expansion)):
        random.seed(13)
        outs.append(_out(m.NExpansionFilter(
            limit_n_expansion_randomly=limit)._filter(
                [P.from_str(s) for s in seqs])))
    assert outs[1] == outs[0]
    assert all("N" not in s for s, _ in outs[1])


@pytest.mark.parametrize("seqs, args", [
    (["AAAAAACG", "TTTTTTCG", "ATCGATCG"], (6, 0)),
    (["AAAGAAAC", "ACGTACGT"], (7, 1, 3)),
    (["AAAGAAAC"], (7, 1)),
    ([], (6, 0)),
    ("random", (10, 2)),
])
def test_polya_filter_equals_catch_tpu(seqs, args):
    if seqs == "random":
        rng = np.random.default_rng(3)
        seqs = [s[:20] + "A" * int(rng.integers(4, 14)) + s[20:]
                for s in _random_probes(rng, 40, 40, "ACGTA")]
    j, t = (_out(m.PolyAFilter(*args)._filter([P.from_str(s) for s in seqs]))
            for P, m in ((JProbe, jpolya), (TProbe, tpolya)))
    assert t == j


@pytest.mark.parametrize("skip_rc", [False, True])
def test_fasta_filter_equals_catch_tpu(tmp_path, skip_rc):
    path = tmp_path / "keep.fasta"
    path.write_text(">one\nGGGG\n>two\nAAAA\n>three | reverse complement "
                    "of x\nCCCC\n")
    seqs = ["AAAA", "CCCC", "GGGG", "TTTT", "AAAA"]
    j, t = (_out(m.FastaFilter(str(path), skip_reverse_complements=skip_rc)
                 ._filter([P.from_str(s) for s in seqs]))
            for P, m in ((JProbe, jfasta), (TProbe, tfasta)))
    assert t == j
    assert [s for s, _ in t] == (["GGGG", "AAAA", "AAAA"] if skip_rc
                                 else ["GGGG", "AAAA", "AAAA", "CCCC"])


# ----------------------------------------------------------------------
# NaiveRedundantFilter and DominatingSetFilter
# ----------------------------------------------------------------------

def _redundancy_fns(m):
    return {
        "default": None,
        "shift1": m.redundant_shift_and_mismatch_count(shift=1,
                                                       mismatch_thres=1),
        "lcs_plain": m.redundant_longest_common_substring(
            mismatches=0, lcf_thres=5, prune_with_heuristic_and_anchor=False),
        "lcs_anchor": m.redundant_longest_common_substring(
            mismatches=2, lcf_thres=30),
    }


def _naive_inputs(case):
    if case == "letters":
        return ["ABCDEF", "ABCDEF", "GHIJKL", "BCDEFG", "ZZZZZZ", "ABCDEX",
                "XBCDEF", "QRSTUV"]
    rng = np.random.default_rng(5)
    base = _random_probes(rng, 1, 120)[0]
    out = []
    for i in range(30):
        s = list(base[i % 4 * 10:i % 4 * 10 + 60])
        for pos in rng.integers(0, 60, size=int(rng.integers(0, 4))):
            s[pos] = str(rng.choice(list("ACGT")))
        out.append("".join(s))
    return out


@pytest.mark.parametrize("filt", ["naive", "dominating"])
@pytest.mark.parametrize("fn, case", [
    ("default", "letters"), ("shift1", "letters"), ("lcs_plain", "letters"),
    ("default", "random"), ("shift1", "random"), ("lcs_plain", "random"),
    ("lcs_anchor", "random")])
def test_redundancy_filters_equal_catch_tpu(filt, fn, case):
    seqs = _naive_inputs(case)
    outs = []
    for P, naive, dom in ((JProbe, jnaive, jdominating),
                          (TProbe, tnaive, tdominating)):
        # the anchored test samples k-mers from numpy's global generator
        np.random.seed(1)
        cls = (naive.NaiveRedundantFilter if filt == "naive"
               else dom.DominatingSetFilter)
        outs.append(_out(cls(_redundancy_fns(naive)[fn])._filter(
            [P.from_str(s) for s in seqs])))
    assert outs[1] == outs[0]
    assert 0 < len(outs[1]) <= len(set(seqs))


# ----------------------------------------------------------------------
# AdapterFilter
# ----------------------------------------------------------------------

def _tiles(groups, length=6, stride=3):
    """catch_tpu's candidate tiling of the letter sequences."""
    from catch_tpu.filters.candidates import (
        make_candidate_probes_from_sequences)
    return [p.seq_str for g in groups for s in g
            for p in make_candidate_probes_from_sequences(
                [s], probe_length=length, probe_stride=stride)]


# The cases of catch_tpu's TestAdapterFilter (tests/test_filters.py:274),
# sequences shorter than a probe among them, and a random corpus.
ADAPTER_CASES = {
    "one_genome": ([["ABCDEFGHIJKLMNOPQRSTUVWXYZ"]], None, 0),
    "two_genomes": ([["ABCDEFGHIJKLMNOPQRSTUVWXYZ"],
                     ["ZYXWVUTSRQPONMLKJIHGFEDCBA"]], None, 0),
    "almost_identical_m0": ([["ABCDEFGHIJKLMNOP", "ABCDEFGHXJKLMNOP"]],
                            ["ABCDEF", "FGHIJK", "FGHXJK", "KLMNOP"], 0),
    "almost_identical_m1": ([["ABCDEFGHIJKLMNOP", "ABCDEFGHXJKLMNOP"]],
                            ["ABCDEF", "FGHIJK", "FGHXJK", "KLMNOP"], 1),
    "misaligned": ([["ABCDEFGHIJKLMNOPQR", "XYZABCDEFGHIJKLMNOPQR"]],
                   ["XYZABC", "ABCDEF", "DEFGHI", "GHIJKL", "JKLMNO",
                    "MNOPQR"], 0),
    "three_genomes": ([["ABCDEFGHEFKLMN", "ABCDEFKLMN", "ABCDEFKLMNO"]],
                      ["ABCDEF", "EFKLMN"], 0),
    "with_mismatches": ([["ABCDEFGHIJKLMNO", "ABCXEFGXIJKXMNO",
                          "ABCDEFGYYJKLMNO", "ABCDEXGHIJKLXNO",
                          "ABCDEFGHIJKLMNX", "AXCDEFGHIJKLMNO",
                          "ABCDEFGHIYYLMNO"]],
                        ["ABCDEF", "DEFGHI", "GHIJKL", "JKLMNO", "DEFGYY",
                         "GYYJKL", "IYYLMN"], 1),
    "short_sequences": ([["ABCDEFGHIJKL", "ABCD", "CDEFG", "GHIJKL"]],
                        ["ABCDEF", "DEFGHI", "GHIJKL"], 0),
}


def _adapter_run(P, G, F, groups, seqs, m, lcf, k, **kw):
    tg = [[G.from_one_seq(s) for s in g] for g in groups]
    probes = [P.from_str(s) for s in seqs]
    f = F(ADAPTER_A, ADAPTER_B, mismatches=m, lcf_thres=lcf,
          kmer_probe_map_k=k, **kw)
    votes = f._make_votes_across_target_genomes(probes, tg)
    return votes, _out(f.filter(probes, tg))


def _adapter_both(groups, seqs, m, lcf, k):
    j = _adapter_run(JProbe, JGenome, jadapter.AdapterFilter, groups, seqs,
                     m, lcf, k)
    t = _adapter_run(TProbe, TGenome, tadapter.AdapterFilter, groups, seqs,
                     m, lcf, k, device="cpu")
    return j, t


@pytest.mark.parametrize("case", sorted(ADAPTER_CASES))
def test_adapter_filter_equals_catch_tpu(case):
    groups, seqs, m = ADAPTER_CASES[case]
    if seqs is None:
        seqs = _tiles(groups)
    j, t = _adapter_both(groups, seqs, m, 6, 3)
    assert t == j
    assert len(t[1]) == len(seqs)


def _dna_corpus(seed, n_genomes=6, length=900):
    rng = np.random.default_rng(seed)
    base = _random_probes(rng, 1, length)[0]
    genomes = []
    for i in range(n_genomes):
        s = np.array(list(base[:length - 37 * i]))
        flip = rng.random(len(s)) < 0.02
        s[flip] = rng.choice(list("ACGT"), size=int(flip.sum()))
        genomes.append("".join(s))
    return genomes


@pytest.mark.parametrize("m, lcf", [(0, 100), (2, 100), (3, 80)])
def test_adapter_filter_random_corpus_equals_catch_tpu(m, lcf):
    """Set-cover picks of a mutated corpus, voted over two groups: the
    span scan's fast path (lcf = L) and its windows (lcf < L)."""
    genomes = _dna_corpus(17)
    groups = [genomes[:3], genomes[3:]]
    seqs = [g[i:i + 100] for g in genomes for i in range(0, len(g) - 99, 37)]
    j, t = _adapter_both(groups, seqs, m, lcf, 20)
    assert t == j
    a_votes = sum(1 for a, b in t[0] if a > b)
    assert 0 < a_votes < len(t[0])


def test_adapter_filter_bad_args_and_device():
    for F, kw in ((jadapter.AdapterFilter, {}),
                  (tadapter.AdapterFilter, {"device": "cpu"})):
        with pytest.raises(ValueError):
            F(("A",), ADAPTER_B, mismatches=0, lcf_thres=6, **kw)
    with pytest.raises(TypeError):
        tadapter.AdapterFilter(ADAPTER_A, ADAPTER_B, mismatches=0,
                               lcf_thres=6)


def test_adapter_filter_not_group_local():
    af = tadapter.AdapterFilter(("AT", "CG"), ("GG", "TT"), mismatches=0,
                                lcf_thres=6, device="cpu")
    assert af.group_local is False
    scf = TSetCover(mismatches=0, lcf_thres=6, identify=True, coverage=0.5,
                    device="cpu")
    assert scf.group_local is False
    assert TDuplicate().group_local is True
    jaf = jadapter.AdapterFilter(("AT", "CG"), ("GG", "TT"), mismatches=0,
                                 lcf_thres=6)
    assert jaf.group_local is af.group_local
    assert JSetCover(mismatches=0, lcf_thres=6, identify=True,
                     coverage=0.5).group_local is scf.group_local
    assert JDuplicate().group_local is TDuplicate().group_local
