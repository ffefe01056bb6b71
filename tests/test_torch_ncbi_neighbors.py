"""The NCBI client (utils/ncbi_neighbors.py) and the CLIs' `download:`
datasets of catch_tpu_torch against catch_tpu, on the CPU, with no
network.

An autouse fixture puts a fake in place of urllib.request.urlopen that
raises on any URL it was not given (tests/torch_fake_ncbi.py), so no
test can wait on a network.  Every case of tests/test_ncbi_neighbors.py
runs against both modules, through the fake's responses rather than
patched fetchers; fetch_fastas and urlopen_with_tries give the same
URLs, sleeps and tempfile bytes in both; both packages' CLIs, on one
fake in one process (so one set order), give byte-equal outputs; two
gloo ranks whose download orders differ raise before any scan.  Last,
the host closure of the cover model against catch_tpu's.
"""

import gzip
import os
import random
import urllib.error

import numpy as np
import pytest

from catch_tpu.cli import analyze_probe_coverage as janalyze
from catch_tpu.cli import design as jdesign
from catch_tpu.ops import cover as jcover
from catch_tpu.utils import ncbi_neighbors as jnn
from catch_tpu_torch.cli import analyze_probe_coverage as tanalyze
from catch_tpu_torch.cli import design as tdesign
from catch_tpu_torch.ops import cover as tcover
from catch_tpu_torch.utils import ncbi_neighbors as tnn
from torch_fake_ncbi import FakeNCBI, read_records, write_fasta
from torch_ranks import python_script, rank_envs, run_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "data", "zaire_ebolavirus.fasta.gz")
MODULES = {"catch_tpu": jnn, "catch_tpu_torch": tnn}


@pytest.fixture(autouse=True)
def no_network(monkeypatch):
    """A fake NCBI that knows no URL, and no API key in either module."""
    for mod in MODULES.values():
        monkeypatch.setattr(mod, "ncbi_api_key", None)
    return FakeNCBI().install(monkeypatch)


@pytest.fixture(params=list(MODULES))
def nn(request):
    return MODULES[request.param]


@pytest.fixture
def sleeps(monkeypatch):
    """time.sleep made a no-op that records its arguments."""
    seen = []
    monkeypatch.setattr(tnn.time, "sleep", seen.append)
    return seen


def _check_url(url, expected_start, expected_fields):
    start, fields = url.split("?")
    assert start == expected_start
    assert sorted(fields.split("&")) == sorted(expected_fields)


def test_ncbi_neighbors_url(nn):
    _check_url(nn.ncbi_neighbors_url(123),
               "https://www.ncbi.nlm.nih.gov/genomes/GenomesGroup.cgi",
               ["taxid=123", "cmd=download2"])


def test_ncbi_fasta_download_url(nn):
    _check_url(nn.ncbi_fasta_download_url(["A123", "A456", "B789"]),
               "https://eutils.ncbi.nlm.nih.gov/entrez/eutils/efetch.fcgi",
               ["id=A123,A456,B789", "db=nuccore", "rettype=fasta",
                "retmode=text"])


def test_api_key_in_urls(nn, monkeypatch):
    monkeypatch.setattr(nn, "ncbi_api_key", "SECRET")
    assert "api_key=SECRET" in nn.ncbi_neighbors_url(5)
    assert "api_key=SECRET" in nn.ncbi_fasta_download_url(["A1"])


def test_influenza_url(nn):
    assert nn.ncbi_influenza_genomes_url("genomeset").endswith(
        "genomeset.dat.gz")
    with pytest.raises(AssertionError):
        nn.ncbi_influenza_genomes_url("bogus")


NEIGHBORS_TABLE = (
    "## Comment line 1\n"
    "## Comment line 2\n"
    "## Columns:\tRepresentative\tNeighbor\tHost\tSelected lineage\t"
    "Taxonomy name\tSegment name\n"
    "NC_0123\tKY456\tvertebrate,human\tFamilyA,GenusA,SpeciesA\t"
    "SpeciesA\tsegment \n"
    "NC_0456\tAB123\tinvertebrate\tFamilyB,GenusB,SpeciesB\tSpeciesB\t"
    "segment 1\n"
    "NC_0456\tAB456\tinvertebrate\tFamilyB,GenusB,SpeciesB\tSpeciesB\t"
    "segment 2\n")
TABLE_RECORDS = [("KY456 a", "ACGTACGT"), ("AB123 b", "GGCCAATT"),
                 ("AB456 c", "TTTTCCCC")]


def test_construct_neighbors(nn, monkeypatch):
    fake = FakeNCBI(table=NEIGHBORS_TABLE, taxid=123).install(monkeypatch)
    expected = [
        nn.Neighbor("KY456", "NC_0123", ["vertebrate", "human"],
                    ("FamilyA", "GenusA", "SpeciesA"), "SpeciesA", ""),
        nn.Neighbor("AB123", "NC_0456", ["invertebrate"],
                    ("FamilyB", "GenusB", "SpeciesB"), "SpeciesB", "1"),
        nn.Neighbor("AB456", "NC_0456", ["invertebrate"],
                    ("FamilyB", "GenusB", "SpeciesB"), "SpeciesB", "2"),
    ]
    assert nn.construct_neighbors(123) == expected
    assert fake.urls == [nn.ncbi_neighbors_url(123)]


def test_bad_column_order(nn, monkeypatch):
    table = ("## Columns:\tNeighbor\tRepresentative\tHost\t"
             "Selected lineage\tTaxonomy name\tSegment name\n")
    FakeNCBI(table=table).install(monkeypatch)
    with pytest.raises(Exception, match="column layout"):
        nn.construct_neighbors(123)


INFLUENZA_TABLE = (
    "AB123\tHuman\t1\tH1N1\tUSA\t2018\t2300\t"
    "Influenza A virus (A/USA/1/2018(H1N1))\t\t10000\n"
    "AB456\tHuman\t2\t\tUSA\t2018\t2200\tInfluenza A virus (A/USA/2018)\n"
    "AB789\tHuman\t3\tH1N1\tUSA\t2018\t2200\t"
    "Influenza A virus (A/USA/2018)\n"
    "CD123\tHuman\t4\tH1N1\tUSA\t\t2300\tInfluenza A virus (A/USA)\n"
    "CD456\tHuman\t5\tH1N1\tUSA\t3000\t2200\t"
    "Influenza A virus (A/USA/3000)\n"
    "CD789\tHuman\t6\tH3N2\tChina\t2015\t2200\t"
    "Influenza A virus (A/China/2015)\n"
    "EF123\tHuman\t1\t\tUSA\t2016\t2300\tInfluenza B virus (B/USA/2016)\n")


def test_construct_influenza_genome_neighbors(nn, monkeypatch):
    """From a canned gzip dump of genomeset: the species filter drops
    influenza B's line, the year filter the record of 3000 and the
    undated one."""
    url = nn.ncbi_influenza_genomes_url("genomeset")
    fake = FakeNCBI(extra={url: gzip.compress(INFLUENZA_TABLE.encode())})
    fake.install(monkeypatch)
    lineage = ("Orthomyxoviridae", "Alphainfluenzavirus",
               "Influenza A virus")
    expected = [
        nn.Neighbor("AB123", None, ["Human"], lineage,
                    "Influenza A virus (A/USA/1/2018(H1N1))", "1",
                    {"subtype": "H1N1", "country": "USA", "year": 2018,
                     "seq_len": 2300}),
        nn.Neighbor("AB456", None, ["Human"], lineage,
                    "Influenza A virus (A/USA/2018)", "2",
                    {"subtype": "", "country": "USA", "year": 2018,
                     "seq_len": 2200}),
        nn.Neighbor("AB789", None, ["Human"], lineage,
                    "Influenza A virus (A/USA/2018)", "3",
                    {"subtype": "H1N1", "country": "USA", "year": 2018,
                     "seq_len": 2200}),
        nn.Neighbor("CD789", None, ["Human"], lineage,
                    "Influenza A virus (A/China/2015)", "6",
                    {"subtype": "H3N2", "country": "China", "year": 2015,
                     "seq_len": 2200}),
    ]
    assert nn.construct_influenza_genome_neighbors(11320) == expected
    assert fake.urls == [url]


def test_bad_influenza_taxid(nn):
    with pytest.raises(ValueError):
        nn.construct_influenza_genome_neighbors(999)


def test_facade_writes_accessions(nn, monkeypatch, tmp_path, sleeps):
    fake = FakeNCBI(TABLE_RECORDS, table=NEIGHBORS_TABLE).install(
        monkeypatch)
    acc_file = tmp_path / "accs.txt"
    tf = nn.construct_fasta_for_taxid("123", write_to=str(acc_file))
    assert sorted(fake.served) == ["AB123", "AB456", "KY456"]
    assert acc_file.read_text().splitlines() == ["AB123", "AB456", "KY456"]
    want = "".join(">%s\n%s\n" % r for r in fake.served_records()) + "\n"
    assert tf.read().decode() == want
    tf.close()
    assert len(fake.urls) == 2 and sleeps == [0.5]


def test_facade_segment_filter(nn, monkeypatch, sleeps):
    """A segment keeps its neighbors; one that no neighbor has raises."""
    fake = FakeNCBI(TABLE_RECORDS, table=NEIGHBORS_TABLE).install(
        monkeypatch)
    nn.construct_fasta_for_taxid(123, segment="1").close()
    assert fake.served == ["AB123"]
    with pytest.raises(Exception, match="After filtering for segment"):
        nn.construct_fasta_for_taxid(123, segment="9")


def test_facade_no_neighbors(nn, monkeypatch):
    FakeNCBI(table=NEIGHBORS_TABLE.split("NC_0123")[0]).install(monkeypatch)
    with pytest.raises(Exception, match="No neighbors were found"):
        nn.construct_fasta_for_taxid(123)


def test_invalid_taxid(nn):
    with pytest.raises(ValueError, match="not a valid NCBI taxonomic ID"):
        nn.construct_fasta_for_taxid("abc")


@pytest.mark.parametrize("key", [None, "K3Y"])
def test_fetch_fastas_equal_in_both(key, monkeypatch, sleeps):
    """Batches of 3 over 8 accessions: the same URLs in the same order,
    the same sleeps (2 requests a second, 7 with a key) and the same
    tempfile bytes."""
    records = [(f"ACC{i}.1 genome {i}", "ACGT" * (i + 1)) for i in range(8)]
    accs = [h.split()[0] for h, _ in records][::-1]
    got = {}
    for name, mod in MODULES.items():
        monkeypatch.setattr(mod, "ncbi_api_key", key)
        fake = FakeNCBI(records).install(monkeypatch)
        del sleeps[:]
        tf = mod.fetch_fastas(accs, batch_size=3)
        got[name] = (fake.urls, list(sleeps), tf.read())
        tf.close()
    assert got["catch_tpu_torch"] == got["catch_tpu"]
    urls, waits, data = got["catch_tpu_torch"]
    assert len(urls) == 3 and urls[0] == tnn.ncbi_fasta_download_url(
        accs[:3])
    assert all(("api_key=" + key in u) if key else ("api_key" not in u)
               for u in urls)
    assert waits == [1.0 / (7 if key else 2)] * 3
    assert data.decode().count(">") == 8 and data.endswith(b"\n\n")


def _http_error(url):
    return urllib.error.HTTPError(url, 503, "busy", {}, None)


def _flaky(n_errors, error=_http_error):
    """An urlopen that fails n_errors times, then answers b'ok'."""
    calls = []

    def urlopen(url):
        calls.append(url)
        if len(calls) <= n_errors:
            raise error(url)
        return b"ok"
    return urlopen, calls


@pytest.mark.parametrize("seed", [0, 7])
def test_urlopen_with_tries_waits_alike(seed, monkeypatch, sleeps):
    """Two HTTP errors, then an answer: under random.seed(k) before each
    package's call, the same doubling waits with the same jitter."""
    got = {}
    for name, mod in MODULES.items():
        urlopen, calls = _flaky(2)
        monkeypatch.setattr(mod.urllib.request, "urlopen", urlopen)
        del sleeps[:]
        random.seed(seed)
        assert mod.urlopen_with_tries("u") == b"ok"
        got[name] = (len(calls), list(sleeps))
    assert got["catch_tpu_torch"] == got["catch_tpu"]
    n, waits = got["catch_tpu"]
    assert n == 3 and len(waits) == 2
    assert 6 <= waits[0] <= 65 and 11 <= waits[1] <= 70


def test_urlopen_with_tries_gives_up(nn, monkeypatch, sleeps):
    """Five HTTP errors re-raise the last; four waits come before it."""
    urlopen, calls = _flaky(5)
    monkeypatch.setattr(nn.urllib.request, "urlopen", urlopen)
    with pytest.raises(urllib.error.HTTPError):
        nn.urlopen_with_tries("u")
    assert len(calls) == 5 and len(sleeps) == 4


def test_urlopen_with_tries_other_error_at_once(nn, monkeypatch, sleeps):
    urlopen, calls = _flaky(1, lambda url: OSError("no route"))
    monkeypatch.setattr(nn.urllib.request, "urlopen", urlopen)
    with pytest.raises(OSError, match="no route"):
        nn.urlopen_with_tries("u")
    assert len(calls) == 1 and sleeps == []


# --- The CLIs on one fake, in one process ---------------------------------

TAXID = "186538"


def _ebola_fake(monkeypatch, n, segments=None):
    return FakeNCBI(read_records(FIXTURE, n), taxid=TAXID,
                    segments=segments).install(monkeypatch)


def _design_both(tmp_path, monkeypatch, dataset, flags):
    """Each package's design CLI on `dataset` with `flags` (a '{out}' in
    them is each run's own directory); returns, a package each, the
    probe FASTA's bytes and the URLs asked for."""
    monkeypatch.setenv("CATCH_TPU_INSTANCE", "force")
    got = {}
    for name in ("catch_tpu_torch", "catch_tpu"):
        out = tmp_path / name
        out.mkdir()
        fake = _ebola_fake(monkeypatch, 10, ["segment %d" % (i % 2 + 1)
                                             for i in range(10)])
        argv = [dataset, "-o", str(out / "p.fasta"), "-pl", "100", "-m",
                "2", "-l", "60", "-e", "50"] + [
                    f.format(out=out) for f in flags]
        if name == "catch_tpu":
            jdesign.main(jdesign.init_and_parse_args(
                "basic", argv + ["--num-devices", "1"]))
        else:
            tdesign.main(tdesign.init_and_parse_args(
                argv + ["--device", "cpu"]))
        got[name] = ((out / "p.fasta").read_bytes(), fake.urls, fake.served)
    assert got["catch_tpu_torch"] == got["catch_tpu"]
    return got["catch_tpu_torch"]


def test_cli_download_equals_catch_tpu(tmp_path, monkeypatch, sleeps):
    """download:TAXID over 10 ebola genomes; the design equals one of a
    FASTA of the records in the order the fake served them."""
    probes, urls, served = _design_both(tmp_path, monkeypatch,
                                        "download:" + TAXID, [])
    assert len(urls) == 2 and sorted(served) == sorted(
        h.split()[0] for h, _ in read_records(FIXTURE, 10))
    fake = FakeNCBI(read_records(FIXTURE, 10))
    fake.served = served
    fasta = write_fasta(tmp_path / "served.fasta", fake.served_records())
    tdesign.main(tdesign.init_and_parse_args(
        [fasta, "-o", str(tmp_path / "f.fasta"), "-pl", "100", "-m", "2",
         "-l", "60", "-e", "50", "--device", "cpu"]))
    assert (tmp_path / "f.fasta").read_bytes() == probes
    assert probes.count(b">") > 50


def test_cli_download_segment_equals_catch_tpu(tmp_path, monkeypatch,
                                               sleeps):
    """download:TAXID-2 keeps the genomes the table gives segment 2."""
    _, urls, served = _design_both(tmp_path, monkeypatch,
                                   f"download:{TAXID}-2", [])
    want = [h.split()[0] for h, _ in read_records(FIXTURE, 10)][1::2]
    assert sorted(served) == sorted(want)


def test_cli_write_taxid_acc_equals_catch_tpu(tmp_path, monkeypatch, sleeps):
    """--write-taxid-acc names the file from the text before the segment
    is split off; --ncbi-api-key reaches every URL."""
    _design_both(tmp_path, monkeypatch, f"download:{TAXID}-1",
                 ["--write-taxid-acc", "{out}", "--ncbi-api-key", "KEY"])
    accs = {name: (tmp_path / name / f"{TAXID}-1.txt").read_bytes()
            for name in ("catch_tpu_torch", "catch_tpu")}
    assert accs["catch_tpu_torch"] == accs["catch_tpu"]
    want = sorted(h.split()[0] for h, _ in read_records(FIXTURE, 10)[::2])
    assert accs["catch_tpu"].decode().splitlines() == want
    assert tnn.ncbi_api_key == "KEY" and jnn.ncbi_api_key == "KEY"


def test_analyze_cli_download_equals_catch_tpu(tmp_path, monkeypatch,
                                               sleeps, capsys):
    probes = os.path.join(REPO, "tests", "data", "golden",
                          "ref_ebola5_m0.fasta")
    got = {}
    for name in ("catch_tpu_torch", "catch_tpu"):
        fake = _ebola_fake(monkeypatch, 6)
        files = [str(tmp_path / f"{name}{i}.tsv") for i in range(3)]
        argv = ["-d", "download:" + TAXID, "-f", probes, "-m", "0", "-l",
                "100", "--print-analysis",
                "--write-analysis-to-tsv", files[0],
                "--write-sliding-window-coverage", files[1],
                "--write-probe-map-counts-to-tsv", files[2]]
        capsys.readouterr()
        if name == "catch_tpu":
            janalyze.main(janalyze.init_and_parse_args(argv))
        else:
            tanalyze.main(tanalyze.init_and_parse_args(
                argv + ["--device", "cpu"]))
        got[name] = [capsys.readouterr().out, fake.urls] + [
            open(p).read() for p in files]
    assert got["catch_tpu_torch"] == got["catch_tpu"]
    assert "taxid:" + TAXID + ", genome 5" in got["catch_tpu"][2]


# --- Ranks ----------------------------------------------------------------

# One rank: a fake NCBI of the first 3 ebola genomes, then the design CLI
# on download:TAXID; prints the served order, then DESIGNED or RAISED.
_RANK = r"""
import sys
sys.path.insert(0, "tests")
from torch_fake_ncbi import FakeNCBI, read_records
from catch_tpu_torch.cli import design
from catch_tpu_torch.utils import ncbi_neighbors
ncbi_neighbors.time.sleep = lambda s: None
fake = FakeNCBI(read_records(sys.argv[1], 3)).install()
scanned = []
run = design.probe_designer.ProbeDesigner.design
design.probe_designer.ProbeDesigner.design = (
    lambda self: (scanned.append(1), run(self))[1])
try:
    design.main(design.init_and_parse_args(sys.argv[2:]))
except ValueError as e:
    print("SERVED", ",".join(fake.served))
    print("RAISED", "PYTHONHASHSEED" in str(e), len(scanned), flush=True)
else:
    print("SERVED", ",".join(fake.served))
    print("DESIGNED", len(scanned), flush=True)
"""


@pytest.mark.parametrize("seeds", [("3", "3"), ("1", "2")],
                         ids=["same_order", "different_orders"])
def test_ranks_check_their_groups(seeds, tmp_path):
    """Two gloo ranks download for themselves.  With one PYTHONHASHSEED
    they hold the same group and design it, each writing the design of
    the served order; with two whose orders differ, both raise, naming
    PYTHONHASHSEED, before any scan."""
    outs = [str(tmp_path / f"rank{r}.fasta") for r in range(2)]
    envs = rank_envs(2, 1)
    for env, seed in zip(envs, seeds):
        env["PYTHONHASHSEED"] = seed
    logs = run_ranks(
        [python_script(_RANK) + [FIXTURE, "download:" + TAXID, "-o", o,
                                 "-pl", "100", "-m", "0", "-e", "0",
                                 "--device", "cpu"] for o in outs],
        envs, timeout=600)
    served = [log.split("SERVED ")[1].split()[0].split(",") for log in logs]
    if seeds[0] == seeds[1]:
        assert served[0] == served[1]
        assert all("DESIGNED 1" in log for log in logs)
        fake = FakeNCBI(read_records(FIXTURE, 3))
        fake.served = served[0]
        fasta = write_fasta(tmp_path / "served.fasta", fake.served_records())
        want = str(tmp_path / "one.fasta")
        tdesign.main(tdesign.init_and_parse_args(
            [fasta, "-o", want, "-pl", "100", "-m", "0", "-e", "0",
             "--device", "cpu"]))
        for o in outs:
            assert open(o).read() == open(want).read()
    else:
        assert served[0] != served[1], "the seeds gave one order"
        assert all("RAISED True 0" in log for log in logs)
        assert not any(os.path.exists(o) for o in outs)


# --- The cover model's host closure ---------------------------------------

@pytest.mark.parametrize("island", [0, 30])
@pytest.mark.parametrize("lcf_thres", [40, 75])
@pytest.mark.parametrize("mismatches", [0, 1, 2, 3])
def test_lcs_closure_equals_catch_tpu(mismatches, lcf_thres, island):
    """probe_covers_sequence_by_longest_common_substring on seeded random
    60-nt probes against windows with 0-8 substitutions outside a 12-nt
    anchor at the probe's start, middle or end (lcf_thres 40 below the
    probe length, 75 above it)."""
    rng = np.random.default_rng(100 * mismatches + lcf_thres + island)
    args = (mismatches, lcf_thres, island)
    jfn = jcover.probe_covers_sequence_by_longest_common_substring(*args)
    tfn = tcover.probe_covers_sequence_by_longest_common_substring(*args)
    L, k = 60, 12
    covered = 0
    for trial in range(60):
        probe = rng.choice(list("ACGT"), L)
        seq = np.concatenate([probe, rng.choice(list("ACGT"), 20)])
        s = (0, L // 2 - k // 2, L - k)[trial % 3]
        outside = np.setdiff1d(np.arange(L), np.arange(s, s + k))
        for pos in rng.choice(outside, rng.integers(0, 9), replace=False):
            seq[pos] = "ACGT"[("ACGT".index(seq[pos]) + 1) % 4]
        p, q = "".join(probe), "".join(seq)
        for full_seq_len in (len(q), 1000):
            got = tfn(p, q, s, s + k, L, full_seq_len)
            assert got == jfn(p, q, s, s + k, L, full_seq_len)
            covered += got is not None
    assert covered > 0 or lcf_thres > L
