"""Custom cover functions, the dict-input set cover and the small host
utilities of catch_tpu_torch against catch_tpu, on the CPU.

A custom hybridization function is a Python callable, so both packages
scan a model that has one on the host, sequence by sequence: the port's
ProbeSearcher, SetCoverFilter (with and without a custom tolerant
function) and Analyzer must give catch_tpu's spans, candidate counts,
picks and tables exactly, and launch no kernel and reach no device scan.
set_cover.build_instance, _solve_host, approx and approx_multiuniverse
must give catch_tpu's instance and picks on random set systems.
"""

import signal
import time

import numpy as np
import pytest

from catch_tpu.analysis import Analyzer as JAnalyzer
from catch_tpu.filters.set_cover_filter import SetCoverFilter as JFilter
from catch_tpu.genome import Genome as JGenome
from catch_tpu.ops import cover as jcover
from catch_tpu.ops import set_cover as jset_cover
from catch_tpu.probe import Probe as JProbe
from catch_tpu_torch.analysis import Analyzer as TAnalyzer
from catch_tpu_torch.filters.set_cover_filter import SetCoverFilter as TFilter
from catch_tpu_torch.genome import Genome as TGenome
from catch_tpu_torch.ops import cover as tcover
from catch_tpu_torch.ops import scan_instance as si
from catch_tpu_torch.ops import scan_sparse
from catch_tpu_torch.ops import set_cover as tset_cover
from catch_tpu_torch.probe import Probe as TProbe
from catch_tpu_torch.utils import dynamic_load, timeout

# catch_tpu's fixture for test_custom_cover_range_fn
# (tests/test_set_cover_filter.py:354).
COVERS_ABC = (
    "def covers_abc(probe_seq, sequence, kmer_start, kmer_end,\n"
    "               full_probe_len, full_sequence_len):\n"
    "    probe_seq = ''.join(probe_seq)\n"
    "    if 'ABC' in probe_seq and 'ABC' in sequence:\n"
    "        i = sequence.index('ABC')\n"
    "        return (i, i + len('ABC'))\n"
    "    return None\n")

# An anchored model on DNA: the window of at least 40 nt around the
# anchor with at most 3 mismatches, grown greedily to the right.
ANCHORED = (
    "def anchored(probe_seq, sequence, kmer_start, kmer_end,\n"
    "             full_probe_len, full_sequence_len):\n"
    "    mism, end = 0, kmer_end\n"
    "    while end < len(sequence):\n"
    "        mism += probe_seq[end] != sequence[end]\n"
    "        if mism > 3:\n"
    "            break\n"
    "        end += 1\n"
    "    start = max(0, kmer_start - 10)\n"
    "    return (start, end) if end - start >= 40 else None\n")


def _fn_file(tmp_path, src, name="fns.py"):
    path = tmp_path / name
    path.write_text(src)
    return str(path)


def _block_device_scans(monkeypatch, span_scan=True):
    """A device scan reached from here fails the test."""
    def boom(*a, **k):
        raise AssertionError("a custom model reached a device scan")
    monkeypatch.setattr(si, "scan_to_boundary_instance", boom)
    if span_scan:
        monkeypatch.setattr(scan_sparse, "scan_spans", boom)


@pytest.fixture
def no_device_scan(monkeypatch):
    _block_device_scans(monkeypatch)


def _corpus(seed, n_seqs=5, length=700):
    rng = np.random.default_rng(seed)
    base = "".join(rng.choice(list("ACGT"), size=length))
    out = []
    for i in range(n_seqs):
        s = np.array(list(base[17 * i:]))
        flip = rng.random(len(s)) < 0.03
        s[flip] = rng.choice(list("ACGT"), size=int(flip.sum()))
        out.append("".join(s))
    out.append(out[0][:30])     # shorter than a probe
    return out


# ----------------------------------------------------------------------
# ProbeSearcher's host scan
# ----------------------------------------------------------------------

def test_custom_cover_fn(no_device_scan):
    """catch_tpu's test_custom_cover_fn (tests/test_cover.py:240)."""
    def fn(probe_seq, sequence, kmer_start, kmer_end, full_probe_len,
           full_seq_len):
        if probe_seq == sequence:
            return (0, len(sequence))
        return None

    got = []
    for P, C in ((JProbe, jcover), (TProbe, tcover)):
        p = P.from_str("CDEFGH")
        searcher = C.ProbeSearcher([p], C.CoverModel(custom_fn=fn),
                                   kmer_probe_map_k=3)
        got.append(({q.seq_str: r for q, r in searcher.find_probe_covers(
            "ABCDEFGHIJKL").items()}, searcher.stats))
    assert got[1] == got[0] == ({"CDEFGH": [(2, 8)]}, {"candidates": 1})


@pytest.mark.parametrize("n_probes", [3, 60])
def test_custom_host_scan_equals_catch_tpu(tmp_path, n_probes,
                                          no_device_scan):
    """Spans and candidate counts of the host scan, through both phase-1
    routes: the dense scan (3 probes) and the k-mer join (60)."""
    fn = dynamic_load.load_function_from_path(
        _fn_file(tmp_path, ANCHORED), "anchored")
    seqs = _corpus(3)
    cand = [seqs[i % 5][37 * i % 500:][:100] for i in range(n_probes)]
    got = []
    for P, C in ((JProbe, jcover), (TProbe, tcover)):
        s = C.ProbeSearcher([P.from_str(x) for x in cand],
                            C.CoverModel(custom_fn=fn), kmer_probe_map_k=15)
        flat = s.find_probe_covers_flat(seqs)
        o = np.lexsort(flat[::-1])
        got.append(([x[o].tolist() for x in flat], s.stats["candidates"],
                     [{q.seq_str: r for q, r in s.find_probe_covers(
                         seq, merge_overlapping=m).items()}
                      for seq in seqs[:2] for m in (True, False)]))
        dense = ((len(seqs[0]) + 99) * len(s.probes) * 100
                 <= s._HOST_PHASE1_MAX_CELLS)
        assert dense == (n_probes == 3)
    assert got[1] == got[0]
    assert len(got[1][0][0]) > 0


def test_custom_model_never_reaches_a_device_scan():
    searcher = tcover.ProbeSearcher([TProbe.from_str("ACGT" * 25)],
                                    tcover.CoverModel(custom_fn=len))
    with pytest.raises(NotImplementedError):
        scan_sparse.verify_args(searcher)
    with pytest.raises(NotImplementedError):
        si.scan_to_boundary_instance(
            searcher, ["ACGT" * 30], np.zeros(1, np.int64),
            np.zeros(1, np.int64), np.array([120]), 1, 0, np.ones(1),
            np.zeros(1, np.int64), "cpu")


# ----------------------------------------------------------------------
# SetCoverFilter and Analyzer with custom functions
# ----------------------------------------------------------------------

def test_custom_cover_range_fn(tmp_path, no_device_scan):
    """catch_tpu's test_custom_cover_range_fn
    (tests/test_set_cover_filter.py:354)."""
    path = _fn_file(tmp_path, COVERS_ABC)
    out = []
    for P, G, F, kw in ((JProbe, JGenome, JFilter, {}),
                        (TProbe, TGenome, TFilter, {"device": "cpu"})):
        tg = [[G.from_one_seq("AAAAAAAAABCBBBBBBBBBB"),
               G.from_one_seq("AAAAAAAAABCBBBBBBBBBB")]]
        cands = [[P.from_str(p)
                  for p in ["AAAAAA", "AAABCB", "BBBBBB", "XXXXXX"]]]
        f = F(0, 0, coverage=3, custom_cover_range_fn=(path, "covers_abc"),
              kmer_probe_map_k=3, **kw)
        out.append([[p.seq_str for p in g]
                    for g in f.filter(cands, tg, input_is_grouped=True)])
    assert out[1] == out[0] == [["AAABCB"]]


def _groups(G, seqs):
    return [[G.from_one_seq(s) for s in seqs[:3]],
            [G.from_one_seq(s) for s in seqs[3:]]]


@pytest.mark.parametrize("tolerant, extension, coverage, avoid", [
    (None, 0, 1.0, False), (None, 20, 0.8, True),
    ("anchored", 20, 0.8, False), ("anchored", 0, 1.0, True),
    ("covers_abc", 0, 1.0, False)])
def test_set_cover_filter_custom_fns_equal_catch_tpu(
        tmp_path, monkeypatch, tolerant, extension, coverage, avoid):
    """Picks of a custom model, with the default or a custom tolerant
    model giving the identification ranks and, with `avoid`, the
    avoided-genome ranks (tolerant None: the tolerant model is the
    default one, mismatches 3, on the span scan)."""
    _block_device_scans(monkeypatch, span_scan=tolerant is not None)
    path = _fn_file(tmp_path, ANCHORED + COVERS_ABC)
    seqs = _corpus(7, length=400)
    cands = [s[i:i + 60] for s in seqs[:5] for i in range(0, 300, 40)]
    kw = dict(mismatches=3, lcf_thres=60, identify=True, coverage=coverage,
              cover_extension=extension, kmer_probe_map_k=20,
              custom_cover_range_fn=(path, "anchored"))
    if avoid:
        bg = tmp_path / "avoid.fasta"
        bg.write_text(f">bg\n{_corpus(8, n_seqs=1, length=400)[0]}"
                      f"{seqs[2][50:170]}\n")
        kw["avoided_genomes"] = [str(bg)]
    if tolerant:
        kw["custom_cover_range_tolerant_fn"] = (path, tolerant)
    out = []
    for P, G, F, dev in ((JProbe, JGenome, JFilter, {}),
                         (TProbe, TGenome, TFilter, {"device": "cpu"})):
        groups = _groups(G, seqs)
        probes = [[P.from_str(s) for s in cands[:24]],
                  [P.from_str(s) for s in cands[20:]]]
        f = F(**kw, **dev)
        C = jcover if F is JFilter else tcover
        searcher = C.ProbeSearcher(probes[0], f.tolerant_model,
                                   kmer_probe_map_k=20, **dev)
        bp = f._tolerant_bp_batched(searcher, seqs)
        ranks = f._make_ranks(probes[0], groups)
        picks = f.filter(probes, groups, input_is_grouped=True)
        out.append((bp.tolist(), ranks.tolist(),
                    [[p.seq_str for p in g] for g in picks]))
    assert out[1] == out[0]
    assert all(out[1][2])
    assert any(out[1][0]) == (tolerant != "covers_abc")


@pytest.mark.parametrize("rc_too", [False, True])
def test_analyzer_custom_fn_equals_catch_tpu(tmp_path, capsys, rc_too,
                                             no_device_scan):
    path = _fn_file(tmp_path, ANCHORED)
    seqs = _corpus(11)
    probes = [s[i:i + 100] for s in seqs[:2] for i in range(0, 500, 90)]
    out = []
    for P, G, A, dev in ((JProbe, JGenome, JAnalyzer, {}),
                         (TProbe, TGenome, TAnalyzer, {"device": "cpu"})):
        a = A([P.from_str(s) for s in probes], 0, 100, _groups(G, seqs),
              ["one", "two"], custom_cover_range_fn=(path, "anchored"),
              cover_extension=5, kmer_probe_map_k=15, rc_too=rc_too, **dev)
        a.run()
        a.print_analysis()
        a.write_data_matrix_as_tsv(str(tmp_path / "m.tsv"))
        a.write_probe_map_counts(str(tmp_path / "c.tsv"))
        out.append((capsys.readouterr().out,
                    (tmp_path / "m.tsv").read_text(),
                    (tmp_path / "c.tsv").read_text()))
    assert out[1] == out[0]
    assert "NUMBER OF PROBES" in out[1][0]


# ----------------------------------------------------------------------
# build_instance, _solve_host, approx and approx_multiuniverse
# ----------------------------------------------------------------------

def _set_system(seed):
    rng = np.random.default_rng(seed)
    n_univ = int(rng.integers(1, 4))
    sets = {}
    for s in range(int(rng.integers(1, 40))):
        sid = f"s{s}" if seed % 2 else s
        sets[sid] = {u: set(rng.integers(0, 60, size=int(
            rng.integers(0, 25))).tolist())
            for u in range(n_univ) if rng.random() < 0.8}
    univ = sorted({u for v in sets.values() for u in v})
    p = {u: float(rng.choice([1.0, 0.5, 0.9])) for u in univ}
    ranks = {s: int(rng.integers(0, 3)) for s in sets}
    costs = {s: float(rng.choice([1.0, 2.0, 0.5])) for s in sets}
    return sets, p, ranks, costs


@pytest.mark.parametrize("seed", range(8))
def test_approx_multiuniverse_equals_catch_tpu(seed):
    sets, p, ranks, costs = _set_system(seed)
    for kw in ({}, {"universe_p": p}, {"universe_p": p, "ranks": ranks},
               {"costs": costs, "ranks": ranks}):
        assert (tset_cover.approx_multiuniverse(sets, **kw)
                == jset_cover.approx_multiuniverse(sets, **kw))
    single = {s: set().union(*v.values()) if v else set()
              for s, v in sets.items()}
    for q in (1.0, 0.7):
        assert (tset_cover.approx(single, p=q)
                == jset_cover.approx(single, p=q))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("intervalsets", [False, True])
def test_build_instance_and_solve_host_equal_catch_tpu(seed, intervalsets):
    """The instance's arrays, and the full-rescan solver's pick order,
    which the lazy solver must give too."""
    sets, p, ranks, costs = _set_system(seed)
    if intervalsets:
        sets = {s: {u: (min(v), max(v) + 1) for u, v in d.items() if v}
                for s, d in sets.items()}
    kw = dict(costs=costs, universe_p=p, ranks=ranks,
              use_intervalsets=intervalsets)
    ji, jids = jset_cover.build_instance(sets, **kw)
    ti, tids = tset_cover.build_instance(sets, **kw)
    assert tids == jids
    assert sorted(vars(ti)) == sorted(vars(ji))
    for k, v in vars(ji).items():
        np.testing.assert_array_equal(getattr(ti, k), v, err_msg=k)
    order = jset_cover._solve_host(ji)
    np.testing.assert_array_equal(tset_cover._solve_host(ti), order)
    np.testing.assert_array_equal(tset_cover._solve_host_lazy(ti), order)


def test_approx_rejects_bad_p():
    for m in (tset_cover, jset_cover):
        with pytest.raises(ValueError):
            m.approx({0: {1}}, p=1.5)
        with pytest.raises(ValueError):
            m.approx_multiuniverse({0: {0: {1}}}, use_arrays=True,
                                   use_intervalsets=True)


# ----------------------------------------------------------------------
# dynamic_load and timeout
# ----------------------------------------------------------------------

def test_dynamic_load(tmp_path):
    path = _fn_file(tmp_path, COVERS_ABC + "x = 3\n", "model.py")
    fn = dynamic_load.load_function_from_path(path, "covers_abc")
    assert fn("ABCD", "XABC", 0, 3, 4, 4) == (1, 4)
    assert dynamic_load.load_module_from_path(path).x == 3
    for name in ("missing", "x"):
        with pytest.raises(ValueError, match="no callable"):
            dynamic_load.load_function_from_path(path, name)


def test_time_limit():
    with timeout.time_limit(5):
        pass
    with pytest.raises(timeout.TimeoutException):
        with timeout.time_limit(1):
            time.sleep(3)
    assert signal.alarm(0) == 0
