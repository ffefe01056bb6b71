"""The port's near-duplicate filters and its design_large path against
catch_tpu, on the CPU.

Both filters run the cases of tests/test_filters.py's
TestNearDuplicateFilter in both packages; the MinHash signature matrix
(the minhash_sig twin) must equal catch_tpu's numpy matrix.  Then a
clustered ProbeDesigner and the design_large CLI on a few mutated copies
of the first ebola genome, once with 'choose' giving 'simple' and once,
with short fragments, giving 'hierarchical'.  The tolerance is exact
equality: the same probes in the same order, the same FASTA bytes.
"""

import gzip
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from catch_tpu.cli import design as jdesign
from catch_tpu.designer import ProbeDesigner as JDesigner
from catch_tpu.filters import near_duplicate as jnd
from catch_tpu.filters.set_cover_filter import SetCoverFilter as JSCF
from catch_tpu.genome import Genome as JGenome
from catch_tpu.probe import Probe as JProbe
from catch_tpu.utils import lsh as jlsh
from catch_tpu_torch.cli import design as tdesign
from catch_tpu_torch.designer import ProbeDesigner as TDesigner
from catch_tpu_torch.filters import near_duplicate as tnd
from catch_tpu_torch.filters.set_cover_filter import SetCoverFilter as TSCF
from catch_tpu_torch.genome import Genome as TGenome
from catch_tpu_torch.probe import Probe as TProbe
from catch_tpu_torch.utils import lsh as tlsh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "data", "zaire_ebolavirus.fasta.gz")
BASES = np.array(list("ACGT"))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The twins run many small tensor ops; with test workers sharing the
    host's cores, one intra-op thread keeps each op from stalling."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(make_j, make_t, seqs):
    """The filter's output in each package, as sequence lists."""
    out_j = make_j()._filter([JProbe.from_str(s) for s in seqs])
    out_t = make_t()._filter([TProbe.from_str(s) for s in seqs])
    return [p.seq_str for p in out_j], [p.seq_str for p in out_t]


def test_hamming_removes_near_duplicates():
    seqs = ["ATCGTCGCGG"] * 3 + ["ATCGTCGCGT", "TTTTTTTTTT"]
    want, got = _both(
        lambda: jnd.NearDuplicateFilterWithHammingDistance(2, 10),
        lambda: tnd.NearDuplicateFilterWithHammingDistance(2, 10,
                                                           device="cpu"),
        seqs)
    assert got == want == ["ATCGTCGCGG", "TTTTTTTTTT"]


def test_minhash_removes_near_duplicates():
    base = "ATCGTCGCGGAATTCCGGATCGCGATATTCGAGG"
    variant = base[:20] + "T" + base[21:]
    distinct = "GGGGGGGGCCCCCCCCAAAATTTTGGGGCCCCAA"
    want, got = _both(
        lambda: jnd.NearDuplicateFilterWithMinHash(0.5, kmer_size=5),
        lambda: tnd.NearDuplicateFilterWithMinHash(0.5, kmer_size=5,
                                                   device="cpu"),
        [base, base, variant, distinct])
    assert got == want
    assert base in got and distinct in got and variant not in got


def test_keeps_all_when_distant():
    want, got = _both(
        lambda: jnd.NearDuplicateFilterWithHammingDistance(2, 10),
        lambda: tnd.NearDuplicateFilterWithHammingDistance(2, 10,
                                                           device="cpu"),
        ["AAAAAAAAAA", "CCCCCCCCCC", "GGGGGGGGGG"])
    assert got == want and len(got) == 3


def _mutated(rng, n_clusters, copies, length, mut):
    out = []
    for _ in range(n_clusters):
        base = rng.choice(BASES, size=length)
        for _ in range(copies):
            s = base.copy()
            m = rng.random(length) < mut
            s[m] = rng.choice(BASES, size=int(m.sum()))
            out.append("".join(s))
    return out


def test_grouped_thread_pool_deterministic():
    """Groups filtered on the thread pool equal per-group sequential
    calls, and catch_tpu's grouped output."""
    rng = np.random.default_rng(5)
    groups = [_mutated(rng, 1, 200, 100, 0.02) for _ in range(6)]
    f = tnd.NearDuplicateFilterWithMinHash(0.5, device="cpu")
    pool = f.filter([[TProbe.from_str(s) for s in g] for g in groups],
                    input_is_grouped=True)
    f2 = tnd.NearDuplicateFilterWithMinHash(0.5, device="cpu")
    seq = [f2._filter([TProbe.from_str(s) for s in g]) for g in groups]
    ref = jnd.NearDuplicateFilterWithMinHash(0.5).filter(
        [[JProbe.from_str(s) for s in g] for g in groups],
        input_is_grouped=True)
    for a, b, c in zip(pool, seq, ref):
        assert [p.seq_str for p in a] == [p.seq_str for p in b] == \
            [p.seq_str for p in c]


@pytest.mark.parametrize("kind", ["hamming", "minhash"])
def test_batched_sweep_matches_generic_and_catch_tpu(kind):
    """The batched engine reproduces the generic per-probe lookup, and
    both equal catch_tpu's output."""
    make = {
        "hamming": lambda m, **kw: m.NearDuplicateFilterWithHammingDistance(
            8, 60, seed=5, **kw),
        "minhash": lambda m, **kw: m.NearDuplicateFilterWithMinHash(
            0.5, kmer_size=8, seed=5, **kw)}[kind]
    rng = np.random.default_rng(99)
    seqs = _mutated(rng, 12, 8, 60, 0.04)
    rng.shuffle(seqs)
    seqs = seqs + seqs[::7]
    probes = [TProbe.from_str(s) for s in seqs]
    out_b = make(tnd, device="cpu")._filter(list(probes))
    occurrences = {}
    for p in probes:
        occurrences[p] = occurrences.get(p, 0) + 1
    input_sorted = [p for p, _ in sorted(occurrences.items(),
                                         key=lambda t: t[1], reverse=True)]
    out_g = make(tnd, device="cpu")._sweep_generic(
        input_sorted, list(occurrences.keys()))
    out_j = make(jnd)._filter([JProbe.from_str(s) for s in seqs])
    assert [p.seq_str for p in out_b] == [p.seq_str for p in out_g] == \
        [p.seq_str for p in out_j]
    assert 10 <= len(out_b) < len(occurrences)


def test_minhash_signature_matrix_equals_catch_tpu():
    """Points of several lengths (one kernel call per length group), the
    default 10-mers and the design_large threshold: H = 75."""
    rng = np.random.default_rng(12)
    seqs = [s[:n] for s, n in zip(_mutated(rng, 30, 4, 120, 0.05),
                                  rng.integers(20, 121, size=120))]
    j = jlsh.BatchedNearNeighbor(
        jlsh.MinHashFamily(10, rng=np.random.default_rng(0)), 3, 0.6, 0.8,
        seqs)
    t = tlsh.BatchedNearNeighbor(
        tlsh.MinHashFamily(10, rng=np.random.default_rng(0)), 3, 0.6, 0.8,
        seqs, device="cpu")
    assert t._sig.shape == (120, 75)
    assert np.array_equal(t._sig, j._sig)
    for qi in (0, 17, 119):
        assert np.array_equal(t.neighbors_of(qi), j.neighbors_of(qi))


def test_filters_take_their_device(monkeypatch):
    f = tnd.NearDuplicateFilterWithMinHash(0.6, device="cpu")
    h = tnd.NearDuplicateFilterWithHammingDistance(2, 100, device="cpu")
    assert f.device == torch.device("cpu") and not f.device_bound
    assert not h.device_bound
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="not available"):
        tnd.NearDuplicateFilterWithMinHash(0.6, device="cuda")


def _ebola_copies(n_strains, copies, seed=0):
    """Mutated copies of the first ebola genome: strains 12% apart,
    copies 0.5% apart within a strain."""
    with gzip.open(FIXTURE, "rt") as f:
        lines = f.read().split(">")[1].splitlines()[1:]
    base = np.array(list("".join(lines).upper()))
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_strains):
        strain = base.copy()
        m = rng.random(len(strain)) < 0.12
        strain[m] = rng.choice(BASES, size=int(m.sum()))
        for _ in range(copies):
            s = strain.copy()
            m = rng.random(len(s)) < 0.005
            s[m] = rng.choice(BASES, size=int(m.sum()))
            out.append("".join(s))
    return out


def test_clustered_probe_designer_equals_catch_tpu():
    seqs = _ebola_copies(2, 2, seed=1)
    designs = []
    for D, G, ND, SCF, kw in (
            (JDesigner, JGenome, jnd.NearDuplicateFilterWithMinHash, JSCF,
             {}),
            (TDesigner, TGenome, tnd.NearDuplicateFilterWithMinHash, TSCF,
             {"device": "cpu"})):
        scf = SCF(mismatches=5, lcf_thres=100, cover_extension=50, **kw)
        pb = D([[G.from_one_seq(s) for s in seqs]],
               [ND(0.6, **kw), scf], probe_length=100, probe_stride=50,
               cluster_threshold=0.15, cluster_merge_after=scf,
               cluster_method="choose", **kw)
        pb.design()
        designs.append(pb)
    j, t = designs
    assert [p.seq_str for p in t.candidate_probes] == \
        [p.seq_str for p in j.candidate_probes]
    assert [p.seq_str for p in t.final_probes] == \
        [p.seq_str for p in j.final_probes]
    assert len(t.final_probes) > 100


def _write_datasets(tmp_path, seqs, n_sets):
    paths = []
    for d in range(n_sets):
        path = tmp_path / f"set{d}.fasta"
        with open(path, "w") as f:
            for i, s in enumerate(seqs[d::n_sets]):
                f.write(f">set{d}_genome{i}\n{s}\n")
        paths.append(str(path))
    return paths


@pytest.mark.parametrize("extra", [[], ["--cluster-from-fragments", "5000"]],
                         ids=["choose_simple", "choose_hierarchical"])
def test_design_large_cli_equals_catch_tpu(tmp_path, extra):
    paths = _write_datasets(tmp_path, _ebola_copies(2, 2), 2)
    out_j, out_t = str(tmp_path / "jax.fasta"), str(tmp_path / "port.fasta")
    jdesign.main(jdesign.init_and_parse_args(
        "large", paths + ["-o", out_j, "--num-devices", "1"] + extra))
    pb = tdesign.main(tdesign.init_and_parse_args(
        paths + ["-o", out_t, "--device", "cpu"] + extra, args_type="large"))
    assert pb.cluster_method == "choose"
    with open(out_t) as a, open(out_j) as b:
        port, ref = a.read(), b.read()
    assert port == ref and port.count(">") > 100


def test_design_cli_with_lsh_hamming_equals_catch_tpu(tmp_path):
    paths = _write_datasets(tmp_path, _ebola_copies(1, 2), 1)
    flags = ["-pl", "100", "-m", "3", "-e", "50",
             "--filter-with-lsh-hamming", "3"]
    out_j, out_t = str(tmp_path / "jax.fasta"), str(tmp_path / "port.fasta")
    jdesign.main(jdesign.init_and_parse_args(
        "basic", paths + ["-o", out_j, "--num-devices", "1"] + flags))
    tdesign.main(tdesign.init_and_parse_args(
        paths + ["-o", out_t, "--device", "cpu"] + flags))
    with open(out_t) as a, open(out_j) as b:
        assert a.read() == b.read()


def test_large_defaults_and_flag_errors(tmp_path):
    args = tdesign.init_and_parse_args(["in.fasta", "-o", "o.fasta"],
                                       args_type="large")
    assert (args.mismatches, args.cover_extension,
            args.cluster_and_design_separately, args.cluster_from_fragments,
            args.filter_with_lsh_minhash, args.device,
            args.cluster_and_design_separately_method) == (
                5, 50, 0.15, 50000, 0.6, "cuda", "choose")
    basic = tdesign.init_and_parse_args(["in.fasta", "-o", "o.fasta"])
    assert (basic.mismatches, basic.cluster_and_design_separately,
            basic.filter_with_lsh_minhash) == (0, None, None)
    with pytest.raises(ValueError):
        tdesign.init_and_parse_args(["x", "-o", "y"], args_type="huge")
    fasta = _write_datasets(tmp_path, _ebola_copies(1, 1), 1)
    out = ["-o", str(tmp_path / "o.fasta"), "--device", "cpu"]
    for extra, msg in (
            (["--filter-with-lsh-hamming", "2", "--filter-with-lsh-minhash",
              "0.6"], "mutually exclusive"),
            (["--cluster-from-fragments", "5000"], "only applies"),
            (["--cluster-and-design-separately", "0.15", "-i"],
             "cannot be combined")):
        with pytest.raises(Exception, match=msg):
            tdesign.main(tdesign.init_and_parse_args(fasta + out + extra))


def test_design_large_module_defaults_to_cuda(tmp_path):
    """python -m catch_tpu_torch.cli.design_large asks for CUDA by
    default, and raises where there is none."""
    fasta = _write_datasets(tmp_path, _ebola_copies(1, 1), 1)
    code = ("import torch, runpy, sys\n"
            "torch.cuda.is_available = lambda: False\n"
            f"sys.argv = ['design_large', {fasta[0]!r}, '-o', "
            f"{str(tmp_path / 'o.fasta')!r}]\n"
            "runpy.run_module('catch_tpu_torch.cli.design_large', "
            "run_name='__main__')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "torch.cuda is not available" in proc.stderr
