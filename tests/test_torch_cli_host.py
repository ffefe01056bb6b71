"""The design and design_naively CLIs of catch_tpu_torch with the flags
of the host filters and custom functions, against catch_tpu's CLIs, on
the CPU.

Counterparts of catch_tpu's test_design_rc_and_adapters,
test_skip_set_cover_with_filter_from_fasta, test_adapter_args_require_flag
and TestDesignNaivelyCLI (tests/test_cli.py), and more flags: the probe
FASTAs (sequences, headers and order) and the printed output must equal
catch_tpu's exactly.  Where a flag draws from Python's `random`, or the
naive filters from numpy's global generator, both packages start from
the same seed.
"""

import random
import subprocess
import sys

import numpy as np
import pytest
import torch

from catch_tpu.cli import design as jdesign
from catch_tpu.cli import design_naively as jnaive
from catch_tpu_torch.cli import design as tdesign
from catch_tpu_torch.cli import design_naively as tnaive


def _mutate(rng, s, rate):
    out = list(s)
    for i in range(len(out)):
        if rng.random() < rate:
            out[i] = str(rng.choice(list("ACGT")))
    return "".join(out)


@pytest.fixture
def small_fasta(tmp_path):
    """catch_tpu's small_fasta fixture (tests/test_cli.py): four 2%
    mutants of one random 500 nt genome."""
    rng = np.random.default_rng(0)
    base = "".join(rng.choice(list("ACGT"), size=500))
    path = tmp_path / "genomes.fasta"
    with open(path, "w") as f:
        for i in range(4):
            f.write(f">g{i}\n{_mutate(rng, base, 0.02)}\n")
    return str(path)


@pytest.fixture
def n_fasta(tmp_path):
    """Genomes with runs of N and poly(A) stretches."""
    rng = np.random.default_rng(4)
    base = "".join(rng.choice(list("ACGT"), size=400))
    base = base[:100] + "A" * 14 + base[114:200] + "NNAN" + base[204:]
    path = tmp_path / "n.fasta"
    with open(path, "w") as f:
        for i in range(3):
            s = _mutate(rng, base, 0.02)
            s = s[:300] + "N" * (i + 1) + s[301 + i:]
            f.write(f">n{i}\n{s}\n")
    return str(path)


BASE = ["-pl", "60", "-ps", "30", "-m", "1", "-l", "60"]


def _designs(tmp_path, capsys, inputs, flags, seed=None):
    """Run both CLIs; returns ((FASTA, stdout) of catch_tpu, of the
    port)."""
    out = []
    for name in ("j", "t"):
        path = str(tmp_path / f"{name}.fasta")
        argv = list(inputs) + ["-o", path] + flags
        if seed is not None:
            random.seed(seed)
        if name == "j":
            jdesign.main(jdesign.init_and_parse_args("basic", argv))
        else:
            tdesign.main(tdesign.init_and_parse_args(argv
                                                     + ["--device", "cpu"]))
        with open(path) as f:
            out.append((f.read(), capsys.readouterr().out))
    return out


@pytest.mark.parametrize("extra", [
    [], ["--print-analysis"], ["--adapter-a", "AAAA", "CCCC", "--adapter-b",
                               "GGGG", "TTTT"]])
def test_design_rc_and_adapters(small_fasta, tmp_path, capsys, extra):
    j, t = _designs(tmp_path, capsys, [small_fasta],
                    BASE + ["--add-adapters", "--add-reverse-complements"]
                    + extra)
    assert t == j
    headers = t[0].splitlines()[::2]
    assert sum("reverse complement" in h for h in headers) * 2 == \
        len(headers)
    width = 100 if not extra or extra[0] != "--adapter-a" else 68
    assert all(len(s) == width for s in t[0].splitlines()[1::2])


@pytest.mark.parametrize("cluster", [False, True])
def test_skip_set_cover_with_filter_from_fasta(small_fasta, tmp_path,
                                               capsys, cluster):
    extra = (["--cluster-and-design-separately", "0.15"] if cluster
             else [])
    first, t1 = _designs(tmp_path, capsys, [small_fasta], BASE + extra)
    assert t1 == first
    keep = tmp_path / "first.fasta"
    keep.write_text(t1[0])
    j, t = _designs(tmp_path, capsys, [small_fasta],
                    BASE + extra + ["--filter-from-fasta", str(keep),
                                    "--skip-set-cover"])
    assert t == j
    assert sorted(t[0].splitlines()[1::2]) == \
        sorted(t1[0].splitlines()[1::2])


def test_adapter_args_require_flag(small_fasta, tmp_path):
    for argv in ([small_fasta, "-o", str(tmp_path / "p.fasta"),
                  "--adapter-a", "AA", "TT"],
                 [small_fasta, "-o", str(tmp_path / "p.fasta"),
                  "--limit-target-genomes", "2",
                  "--limit-target-genomes-randomly-with-replacement", "2"]):
        with pytest.raises(Exception):
            jdesign.main(jdesign.init_and_parse_args("basic", argv))
        with pytest.raises(Exception):
            tdesign.main(tdesign.init_and_parse_args(argv
                                                     + ["--device", "cpu"]))


@pytest.mark.parametrize("flags", [
    ["--expand-n", "1"], ["--expand-n"], ["--filter-polya", "10", "1"],
    ["--limit-target-genomes-randomly-with-replacement", "5"],
    ["--filter-polya", "8", "0", "--expand-n", "2",
     "--add-reverse-complements"]])
def test_host_filter_flags_equal_catch_tpu(n_fasta, tmp_path, capsys, flags):
    j, t = _designs(tmp_path, capsys, [n_fasta], BASE + flags, seed=29)
    assert t == j
    assert t[0].count(">") > 0
    assert "N" not in "".join(t[0].splitlines()[1::2]) or \
        "--expand-n" not in flags


_FN = (
    "def covers(probe_seq, sequence, kmer_start, kmer_end,\n"
    "           full_probe_len, full_sequence_len):\n"
    "    mism = sum(a != b for a, b in zip(probe_seq, sequence))\n"
    "    return (0, len(sequence)) if mism <= 2 else None\n"
    "\n\n"
    "def tolerant(probe_seq, sequence, kmer_start, kmer_end,\n"
    "             full_probe_len, full_sequence_len):\n"
    "    return (max(0, kmer_start - 20), min(len(sequence), kmer_end + 20))\n")


@pytest.mark.parametrize("flags", [
    [], ["--add-adapters", "--print-analysis", "-e", "10"],
    ["-i", "--custom-hybridization-fn-tolerant", "{fn}", "tolerant"]])
def test_custom_hybridization_fn_equals_catch_tpu(small_fasta, n_fasta,
                                                  tmp_path, capsys, flags):
    fn = tmp_path / "model.py"
    fn.write_text(_FN)
    inputs = [small_fasta] + ([n_fasta] if "-i" in flags else [])
    flags = [a.format(fn=fn) for a in flags]
    j, t = _designs(tmp_path, capsys, inputs,
                    BASE + ["--custom-hybridization-fn", str(fn), "covers"]
                    + flags)
    assert t == j
    assert t[0].count(">") > 0


# ----------------------------------------------------------------------
# design_naively
# ----------------------------------------------------------------------

def _naive(tmp_path, capsys, argv):
    out = []
    for mod, extra in ((jnaive, []), (tnaive, ["--device", "cpu"])):
        random.seed(3)
        np.random.seed(1)
        mod.main(mod.init_and_parse_args(argv + extra))
        out.append(capsys.readouterr().out)
    return out


@pytest.mark.parametrize("flags", [
    ["-nrf", "1", "50"], ["-dsf", "1", "50"],
    ["-nrf", "1", "50", "--print-analysis"],
    ["-dsf", "2", "40", "--add-reverse-complements", "--print-analysis"],
    ["--limit-target-genomes", "2"],
    ["-nrf", "0", "60",
     "--limit-target-genomes-randomly-with-replacement", "3"]])
def test_design_naively_equals_catch_tpu(small_fasta, tmp_path, capsys,
                                         flags):
    j, t = _naive(tmp_path, capsys, [small_fasta, "-pl", "60", "-ps", "30"]
                  + flags)
    assert t == j
    if "--print-analysis" in flags:
        assert "NUMBER OF PROBES" in t
    else:
        assert int(t.strip()) > 0


def test_design_naively_refusals(small_fasta, monkeypatch):
    for argv in ([small_fasta, "-nrf", "1", "50", "-dsf", "1", "50"],
                 [small_fasta, "--limit-target-genomes", "2",
                  "--limit-target-genomes-randomly-with-replacement", "2"],
                 ["no-such-file.fasta"]):
        with pytest.raises(ValueError):
            jnaive.main(jnaive.init_and_parse_args(argv))
        with pytest.raises(ValueError):
            tnaive.main(tnaive.init_and_parse_args(argv + ["--device",
                                                           "cpu"]))
    assert tnaive.init_and_parse_args([small_fasta]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="not available"):
        tnaive.main(tnaive.init_and_parse_args([small_fasta]))


def test_design_naively_module_runs(small_fasta):
    proc = subprocess.run(
        [sys.executable, "-m", "catch_tpu_torch.cli.design_naively",
         small_fasta, "-pl", "60", "-ps", "30", "--device", "cpu"],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) > 0
