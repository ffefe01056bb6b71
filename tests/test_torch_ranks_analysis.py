"""Identification and avoided-genome ranks, and the coverage Analyzer, of
catch_tpu_torch against catch_tpu and the goldens, on the CPU.

The port's SetCoverFilter ranks, its rank-tiered pick order, its
Analyzer and both CLIs run the span scan through the kernels'
plain-PyTorch twins here (--device cpu).  Every comparison is exact.
"""

import gzip
import os
from collections import OrderedDict

import numpy as np
import pytest

from catch_tpu.analysis import Analyzer as JAnalyzer
from catch_tpu.cli import design as jdesign
from catch_tpu.filters.candidates import (
    make_candidate_probes_from_sequences as jcandidates)
from catch_tpu.filters.duplicate import DuplicateFilter as JDuplicate
from catch_tpu.filters.set_cover_filter import SetCoverFilter as JFilter
from catch_tpu.genome import Genome as JGenome
from catch_tpu.probe import Probe as JProbe
from catch_tpu.utils import seq_io as jseq_io
from catch_tpu_torch.analysis import Analyzer as TAnalyzer
from catch_tpu_torch.cli import analyze_probe_coverage as tanalyze
from catch_tpu_torch.cli import design as tdesign
from catch_tpu_torch.designer import ProbeDesigner
from catch_tpu_torch.filters.candidates import (
    make_candidate_probes_from_sequences as tcandidates)
from catch_tpu_torch.filters.duplicate import DuplicateFilter as TDuplicate
from catch_tpu_torch.filters.set_cover_filter import (
    SetCoverFilter as TFilter, _reverse_complement)
from catch_tpu_torch.genome import Genome as TGenome
from catch_tpu_torch.probe import Probe as TProbe
from catch_tpu_torch.utils import seq_io as tseq_io

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "data", "golden")
FIXTURE = os.path.join(REPO, "tests", "data", "zaire_ebolavirus.fasta.gz")


def _records(path):
    recs, header, seq = set(), None, []
    for line in open(path):
        line = line.strip()
        if line.startswith(">"):
            if header is not None:
                recs.add((header, "".join(seq)))
            header, seq = line, []
        else:
            seq.append(line)
    if header is not None:
        recs.add((header, "".join(seq)))
    return recs


def _golden(name):
    return os.path.join(GOLDEN, name)


# ----------------------------------------------------------------------
# The identify and avoid goldens
# ----------------------------------------------------------------------

def test_identify_golden_through_filter():
    ga = tseq_io.read_genomes_from_fasta(_golden("identify_a.fasta"))
    gb = tseq_io.read_genomes_from_fasta(_golden("identify_b.fasta"))
    scf = TFilter(mismatches=0, lcf_thres=60, identify=True, coverage=0.5,
                  device="cpu")
    assert not scf.group_local
    d = ProbeDesigner([ga, gb], [TDuplicate(), scf], probe_length=60,
                      probe_stride=30)
    d.design()
    want = {s for _, s in _records(_golden("ref_identify_m0.fasta"))}
    assert len(want) == 8
    assert {p.seq_str for p in d.final_probes} == want


def test_avoid_golden_through_filter():
    gt = tseq_io.read_genomes_from_fasta(_golden("avoid_target.fasta"))
    scf = TFilter(mismatches=0, lcf_thres=60,
                  avoided_genomes=[_golden("avoid_bg.fasta")], device="cpu")
    assert scf.group_local
    d = ProbeDesigner([gt], [TDuplicate(), scf], probe_length=60,
                      probe_stride=30)
    d.design()
    want = {s for _, s in _records(_golden("ref_avoid_m0.fasta"))}
    assert len(want) == 10
    assert {p.seq_str for p in d.final_probes} == want


@pytest.mark.parametrize("argv,golden", [
    (["identify_a.fasta", "identify_b.fasta", "-i", "-c", "0.5"],
     "ref_identify_m0.fasta"),
    (["avoid_target.fasta", "--avoid-genomes", "avoid_bg.fasta",
      "--use-native-dict-when-finding-tolerant-coverage"],
     "ref_avoid_m0.fasta"),
], ids=["identify", "avoid"])
def test_goldens_through_cli(tmp_path, argv, golden):
    argv = [_golden(a) if a.endswith(".fasta") else a for a in argv]
    out = str(tmp_path / "probes.fasta")
    tdesign.main(tdesign.init_and_parse_args(
        argv + ["-o", out, "-pl", "60", "-ps", "30", "-m", "0", "-e", "0",
                "--device", "cpu"]))
    assert _records(out) == _records(_golden(golden))


def test_tolerant_identify_cli_equals_catch_tpu(tmp_path):
    """-mt, -lt and --island-of-exact-match-tolerant reach the ranks as
    they do in catch_tpu."""
    flags = [_golden("identify_a.fasta"), _golden("identify_b.fasta"),
             "-pl", "60", "-ps", "30", "-m", "0", "-e", "5", "-i",
             "-c", "0.4", "-mt", "3", "-lt", "40",
             "--island-of-exact-match-tolerant", "15"]
    out_t, out_j = str(tmp_path / "t.fasta"), str(tmp_path / "j.fasta")
    tdesign.main(tdesign.init_and_parse_args(
        flags + ["-o", out_t, "--device", "cpu"]))
    jdesign.main(jdesign.init_and_parse_args(
        "basic", flags + ["-o", out_j, "--num-devices", "1"]))
    with open(out_t) as a, open(out_j) as b:
        assert a.read() == b.read()


# ----------------------------------------------------------------------
# Ranks and the rank-tiered pick order
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def ranked(tmp_path_factory):
    """Two groupings of ebola genomes and a 3 x 30 kb random background
    with 12 planted 300 bp pieces of the first genome."""
    recs, cur = [], None
    with gzip.open(FIXTURE, "rt") as f:
        for line in f:
            if line.startswith(">"):
                if len(recs) == 4:
                    break
                cur = [line.strip(), []]
                recs.append(cur)
            else:
                cur[1].append(line.strip())
    seqs = ["".join(r[1]) for r in recs]
    rng = np.random.default_rng(5)
    bases = np.array(list("ACGT"))
    bg = tmp_path_factory.mktemp("bg") / "bg.fasta"
    with open(bg, "w") as f:
        for c in range(3):
            chrom = rng.choice(bases, size=30000)
            for _ in range(4):
                at = int(rng.integers(0, len(seqs[0]) - 300))
                to = int(rng.integers(0, 30000 - 300))
                chrom[to:to + 300] = list(seqs[0][at:at + 300])
            f.write(f">bg{c}\n{''.join(chrom)}\n")
    groups = [seqs[:2], seqs[2:3]]
    return groups, str(bg)


def _filters(bg, **kw):
    kw = dict(mismatches=2, lcf_thres=60, mismatches_tolerant=3,
              lcf_thres_tolerant=50, identify=True, avoided_genomes=[bg],
              coverage=0.6, cover_extension=20, **kw)
    return JFilter(**kw), TFilter(**kw, device="cpu")


def _groups(groups, genome, probe):
    gg = [[genome.from_one_seq(s) for s in g] for g in groups]
    make = jcandidates if genome is JGenome else tcandidates
    dup = JDuplicate if genome is JGenome else TDuplicate
    cands = dup()._filter(make([s for g in groups[:1] for s in g],
                               probe_length=100, probe_stride=50))
    return gg, cands


def test_make_ranks_equals_catch_tpu(ranked, monkeypatch):
    """Identification hits per grouping and avoided bp, both strands,
    over avoided-sequence batches of 2^15 bp, densified into ranks."""
    groups, bg = ranked
    jf, tf = _filters(bg)
    for cls in (JFilter, TFilter):
        monkeypatch.setattr(cls, "_AVOID_BATCH_BP", 1 << 15)
    jg, jc = _groups(groups, JGenome, JProbe)
    tg, tc = _groups(groups, TGenome, TProbe)
    assert [p.seq_str for p in jc] == [p.seq_str for p in tc]
    want = jf._make_ranks(jc, jg)
    got = tf._make_ranks(tc, tg)
    assert got.dtype == np.int64
    assert np.array_equal(got, want)
    assert len(np.unique(want)) >= 3


def test_rank_tiered_pick_order_equals_catch_tpu(ranked, monkeypatch):
    """With several rank tiers, the port's picks come in catch_tpu's
    order."""
    groups, bg = ranked
    jf, tf = _filters(bg)
    jg, jc = _groups(groups, JGenome, JProbe)
    tg, tc = _groups(groups, TGenome, TProbe)
    ranks = jf._make_ranks(jc, jg)
    monkeypatch.setenv("CATCH_TPU_INSTANCE", "force")
    stats = {"scan_seconds": 0.0, "solve_seconds": 0.0,
             "candidates_evaluated": 0, "set_cover_picks": 0}
    want = jf._solve_group_device(jf._prepare_scan(jc, jg[0]), jg[0], ranks,
                                  jf._make_universe_p(jg[0]), dict(stats))
    got = tf._solve_group(tc, tg[0], ranks, dict(stats))
    assert list(got) == list(want)
    assert len(np.unique(ranks[got])) >= 2


def test_reverse_complement_matches_catch_tpu():
    from catch_tpu.filters.set_cover_filter import (
        _reverse_complement as jrc)
    s = "ACGTNNRYacgtAAGGCCTT-X"
    assert _reverse_complement(s) == jrc(s)


# ----------------------------------------------------------------------
# The Analyzer (cases of tests/test_coverage_analysis.py)
# ----------------------------------------------------------------------

ANALYSES = {
    "two_genomes": (
        [["ATCCATCCATNGGGTTTGAAGCG"], {"chr1": "CCCCCC",
                                      "chr2": "NTGAAGCG"}],
        ["ATCCAT", "TTTGAA", "GAAGCG", "ATGGAT", "AAACCC"],
        dict(cover_extension=0, rc_too=True)),
    "cover_extension": (
        [["ATCCATCCATNGGGTTTGAAGCG"], {"chr1": "CCCCCCA",
                                      "chr2": "ANTGAAGCG"}],
        ["ATCCAT", "TTTGAA", "GAAGCG", "ATGGAT", "CCCCCC", "AAACCC"],
        dict(cover_extension=2, rc_too=True)),
    "no_rc": (
        [["ATCCATCCATNGGGTTTGAAGCG"]],
        ["ATCCAT", "TTTGAA", "GAAGCG"],
        dict(cover_extension=2, rc_too=False)),
}


def _analyzer(case, genome, probe, cls, **dev):
    targets, probes, kw = ANALYSES[case]
    gs = [genome.from_one_seq(t[0]) if isinstance(t, list)
          else genome.from_chrs(OrderedDict(t)) for t in targets]
    a = cls([probe.from_str(p) for p in probes], mismatches=0,
            lcf_thres=6, target_genomes=[[g] for g in gs],
            target_genomes_names=[f"g_{i}" for i in range(len(gs))],
            kmer_probe_map_k=3, **kw, **dev)
    a.run(window_length=6, window_stride=3)
    return a


@pytest.mark.parametrize("case", list(ANALYSES))
def test_analyzer_equals_catch_tpu(case, tmp_path, capsys):
    j = _analyzer(case, JGenome, JProbe, JAnalyzer)
    t = _analyzer(case, TGenome, TProbe, TAnalyzer, device="cpu")
    for attr in ("target_covers", "bp_covered", "average_coverage",
                 "sliding_coverage"):
        assert getattr(t, attr) == getattr(j, attr), attr
    assert [(p.seq_str, c) for p, c in t.probe_map_counts.items()] == [
        (p.seq_str, c) for p, c in j.probe_map_counts.items()]
    assert t._make_data_matrix_string() == j._make_data_matrix_string()
    for writer in ("write_data_matrix_as_tsv",
                   "write_sliding_window_coverage",
                   "write_probe_map_counts"):
        getattr(j, writer)(str(tmp_path / "j.tsv"))
        getattr(t, writer)(str(tmp_path / "t.tsv"))
        assert (tmp_path / "t.tsv").read_text() == \
            (tmp_path / "j.tsv").read_text(), writer
    capsys.readouterr()
    j.print_analysis()
    want = capsys.readouterr().out
    t.print_analysis()
    assert capsys.readouterr().out == want


def test_analyze_cli_ebola175_equals_goldens(tmp_path):
    """The analysis CLI on the first 175 ebola genomes gives the TSVs
    catch_tpu made (tests/data/golden/make_span_goldens.py)."""
    fasta = tmp_path / "ebola175.fasta"
    n = 0
    with gzip.open(FIXTURE, "rt") as f, open(fasta, "w") as out:
        for line in f:
            if line.startswith(">"):
                n += 1
                if n > 175:
                    break
            out.write(line)
    a_tsv, c_tsv = tmp_path / "a.tsv", tmp_path / "c.tsv"
    tanalyze.main(tanalyze.init_and_parse_args([
        "-d", str(fasta), "-f", _golden("torch_ebola175_m2.fasta"),
        "-m", "2", "-l", "60", "-e", "50", "--max-num-processes", "2",
        "--write-analysis-to-tsv", str(a_tsv),
        "--write-probe-map-counts-to-tsv", str(c_tsv), "--device", "cpu"]))
    assert a_tsv.read_text() == open(
        _golden("ebola175_m2_analysis.tsv")).read()
    assert c_tsv.read_text() == open(
        _golden("ebola175_m2_probe_map_counts.tsv")).read()


def test_design_analysis_flags_equal_catch_tpu(tmp_path, capsys):
    flags = [_golden("avoid_target.fasta"), "-pl", "60", "-ps", "30",
             "-m", "1", "-l", "50", "-e", "10", "--print-analysis"]
    outs = {}
    for name in ("t", "j"):
        files = [str(tmp_path / f"{name}{i}.tsv") for i in range(3)]
        argv = flags + ["-o", str(tmp_path / f"{name}.fasta"),
                        "--write-analysis-to-tsv", files[0],
                        "--write-sliding-window-coverage", files[1],
                        "--write-probe-map-counts-to-tsv", files[2]]
        capsys.readouterr()
        if name == "t":
            tdesign.main(tdesign.init_and_parse_args(
                argv + ["--device", "cpu"]))
        else:
            jdesign.main(jdesign.init_and_parse_args(
                "basic", argv + ["--num-devices", "1"]))
        outs[name] = [capsys.readouterr().out] + [
            open(p).read() for p in files + [str(tmp_path / f"{name}.fasta")]]
    assert outs["t"] == outs["j"]
    assert "NUMBER OF PROBES" in outs["t"][0]


def test_analyze_cli_refuses_downloads():
    args = tanalyze.init_and_parse_args(
        ["-d", "download:186538", "-f", "p.fasta", "-m", "0", "-l", "60",
         "--device", "cpu"])
    with pytest.raises(ValueError, match="network"):
        tanalyze.main(args)
