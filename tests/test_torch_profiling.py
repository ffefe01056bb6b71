"""The port's profiling hooks (catch_tpu_torch/utils/profiling.py) on the
CPU.

With CATCH_TPU_PROFILE_DIR unset, maybe_trace makes no directory, imports
nothing and starts no profiler.  With it set, each region gives one
torch.profiler chrome trace per process, on its first run, holding the
region's record_function event; CPU activity only for a CPU device; one
capture at a time.  The four regions are reached through the CLIs:
ebola5's design (scan_instance, and set_cover_solve under
CATCH_TPU_SOLVE=device) and a coverage analysis (cover_scan_join,
cover_scan_verify), whose outputs must not change.  snapshot_phases must
equal catch_tpu's.
"""

import gzip
import json
import os
import subprocess
import sys
import threading

import pytest
import torch

from catch_tpu.utils import profiling as jprofiling
from catch_tpu_torch.cli import analyze_probe_coverage as tanalyze
from catch_tpu_torch.cli import design as tdesign
from catch_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
REGIONS = ("scan_instance", "set_cover_solve", "cover_scan_join",
           "cover_scan_verify")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The twins run many small tensor ops; with test workers sharing the
    host's cores, one intra-op thread keeps each op from stalling."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def fresh(monkeypatch):
    """No region captured yet in this process, and the variable unset."""
    monkeypatch.setattr(profiling, "_captured", set())
    monkeypatch.setattr(profiling, "_capturing", False)
    monkeypatch.delenv("CATCH_TPU_PROFILE_DIR", raising=False)
    monkeypatch.delenv("CATCH_TPU_SOLVE", raising=False)


@pytest.fixture
def activities(monkeypatch):
    """Records the activities of every profiler maybe_trace starts."""
    seen = []
    real = torch.profiler.profile

    def spy(*args, **kwargs):
        seen.append(list(kwargs["activities"]))
        return real(*args, **kwargs)

    monkeypatch.setattr(torch.profiler, "profile", spy)
    return seen


def _traces(root):
    """{region: [trace file names]} under root."""
    if not os.path.isdir(root):
        return {}
    return {r: sorted(os.listdir(os.path.join(root, r)))
            for r in sorted(os.listdir(root))}


def _names(root, region):
    (name,) = os.listdir(os.path.join(root, region))
    with open(os.path.join(root, region, name)) as f:
        return {e.get("name") for e in json.load(f)["traceEvents"]}


def test_unset_variable_is_free(tmp_path):
    """In a fresh interpreter: no profiler, no import of torch, no
    directory, nothing captured."""
    code = (
        "import os, sys\n"
        "from catch_tpu_torch.utils import profiling\n"
        "with profiling.maybe_trace('scan_instance', 'cuda'):\n"
        "    pass\n"
        "assert 'torch' not in sys.modules, 'imported torch'\n"
        "assert not profiling._captured and not os.listdir('.')\n")
    env = {k: v for k, v in os.environ.items()
           if k != "CATCH_TPU_PROFILE_DIR"}
    env["PYTHONPATH"] = REPO
    subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                   check=True, timeout=120)


def test_unset_variable_starts_no_profiler(fresh, activities, tmp_path,
                                           monkeypatch):
    monkeypatch.chdir(tmp_path)
    for region in REGIONS:
        with profiling.maybe_trace(region, torch.device("cpu")):
            torch.ones(3).sum()
    assert activities == [] and not profiling._captured
    assert os.listdir(tmp_path) == []


def test_each_region_traced_once(fresh, activities, tmp_path, monkeypatch):
    root = str(tmp_path / "traces")
    monkeypatch.setenv("CATCH_TPU_PROFILE_DIR", root)
    for _ in range(3):
        for region in REGIONS:
            with profiling.maybe_trace(region, "cpu"):
                torch.ones(8).cumsum(0)
    assert activities == [[torch.profiler.ProfilerActivity.CPU]] * 4
    traces = _traces(root)
    assert sorted(traces) == sorted(REGIONS)
    for region in REGIONS:
        assert traces[region] == [f"{os.getpid()}.pt.trace.json"]
        assert region in _names(root, region)
    assert not profiling._capturing


def test_a_region_that_raises_is_traced(fresh, tmp_path, monkeypatch):
    root = str(tmp_path / "traces")
    monkeypatch.setenv("CATCH_TPU_PROFILE_DIR", root)
    with pytest.raises(ZeroDivisionError):
        with profiling.maybe_trace("scan_instance"):
            1 / 0
    assert "scan_instance" in _names(root, "scan_instance")
    assert not profiling._capturing


def test_a_profiler_that_fails_is_logged(fresh, tmp_path, monkeypatch,
                                         caplog):
    def broken(*args, **kwargs):
        raise RuntimeError("no profiler here")

    monkeypatch.setattr(torch.profiler, "profile", broken)
    monkeypatch.setenv("CATCH_TPU_PROFILE_DIR", str(tmp_path))
    ran = []
    with profiling.maybe_trace("scan_instance"):
        ran.append(1)
    assert ran == [1] and "Could not start profiler" in caplog.text
    assert not profiling._capturing


def test_another_capture_running_leaves_a_region_uncaptured(
        fresh, tmp_path, monkeypatch):
    root = str(tmp_path / "traces")
    monkeypatch.setenv("CATCH_TPU_PROFILE_DIR", root)
    with profiling.maybe_trace("scan_instance"):
        with profiling.maybe_trace("set_cover_solve"):
            pass
        assert profiling._captured == {"scan_instance"}
    with profiling.maybe_trace("set_cover_solve"):
        pass
    traces = _traces(root)
    assert sorted(traces) == ["scan_instance", "set_cover_solve"]
    assert "set_cover_solve" not in _names(root, "scan_instance")


@pytest.mark.parametrize("n_threads", [2, 16])
def test_threads_in_one_region_capture_once(fresh, tmp_path, monkeypatch,
                                            n_threads):
    root = str(tmp_path / "traces")
    monkeypatch.setenv("CATCH_TPU_PROFILE_DIR", root)
    start = threading.Barrier(n_threads)
    done = []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            start.wait(timeout=60)
            with profiling.maybe_trace("scan_instance", "cpu"):
                torch.ones(64).cumsum(0)
            done.append(1)

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert len(done) == n_threads
    assert _traces(root) == {"scan_instance":
                             [f"{os.getpid()}.pt.trace.json"]}
    assert not profiling._capturing


def test_snapshot_phases_equals_catch_tpu():
    phases = [("scan:setup", 0.123456), ("scan:stage_a", 1.005),
              ("scan:setup", 2.5e-3), ("set_cover:solve", 12.3449999),
              ("filter:SetCoverFilter", 0.0049)]
    try:
        for mod in (profiling, jprofiling):
            mod.reset_phases()
            for k, v in phases:
                mod.add_phase(k, v)
        got = profiling.snapshot_phases()
        assert got == jprofiling.snapshot_phases()
        assert got["scan:setup"] == 0.13 and got["filter:SetCoverFilter"] == 0
    finally:
        profiling.reset_phases()
        jprofiling.reset_phases()


def _subset(tmp_path, n):
    path = tmp_path / f"ebola{n}.fasta"
    recs = []
    with gzip.open(os.path.join(DATA, "zaire_ebolavirus.fasta.gz"),
                   "rt") as f:
        for line in f:
            if line.startswith(">"):
                if len(recs) == n:
                    break
                recs.append([line])
            else:
                recs[-1].append(line)
    with open(path, "w") as out:
        for r in recs:
            out.writelines(r)
    return str(path)


def _records(text):
    """The (header, sequence) records of a FASTA text, as a set."""
    recs = set()
    for rec in text.split(">")[1:]:
        header, *seq = rec.strip().split("\n")
        recs.add((header, "".join(seq)))
    return recs


def test_design_regions_leave_the_output_unchanged(fresh, tmp_path,
                                                   monkeypatch):
    """ebola5 m0 through cli/design.py --device cpu: without the variable,
    with it (scan_instance captured), and with it under
    CATCH_TPU_SOLVE=device (scan_instance and set_cover_solve captured
    in a fresh process state): the same FASTA each time."""
    fasta = _subset(tmp_path, 5)
    outs = []
    for i, (env, solve) in enumerate(((None, None), ("a", None),
                                      ("b", "device"))):
        monkeypatch.setattr(profiling, "_captured", set())
        if env:
            monkeypatch.setenv("CATCH_TPU_PROFILE_DIR",
                               str(tmp_path / env))
        if solve:
            monkeypatch.setenv("CATCH_TPU_SOLVE", solve)
        out = tmp_path / f"probes{i}.fasta"
        tdesign.main(tdesign.init_and_parse_args([
            fasta, "-o", str(out), "-pl", "100", "-m", "0", "-e", "0",
            "--device", "cpu"]))
        outs.append(out.read_bytes())
    assert outs[0] == outs[1] == outs[2]
    with open(os.path.join(DATA, "golden", "ref_ebola5_m0.fasta")) as f:
        assert _records(outs[0].decode()) == _records(f.read())
    assert sorted(_traces(str(tmp_path / "a"))) == ["scan_instance"]
    assert sorted(_traces(str(tmp_path / "b"))) == ["scan_instance",
                                                    "set_cover_solve"]
    for region in ("scan_instance", "set_cover_solve"):
        assert region in _names(str(tmp_path / "b"), region)


def test_analysis_regions_leave_the_output_unchanged(fresh, tmp_path,
                                                     monkeypatch):
    """The coverage analysis of ebola5 with ebola5's golden probes (-m 2
    -l 60 -e 50): cover_scan_join and cover_scan_verify captured, the
    TSVs unchanged."""
    fasta = _subset(tmp_path, 5)
    tsvs = []
    for i, env in enumerate((None, "t")):
        if env:
            monkeypatch.setenv("CATCH_TPU_PROFILE_DIR", str(tmp_path / env))
        a_tsv, c_tsv = tmp_path / f"a{i}.tsv", tmp_path / f"c{i}.tsv"
        tanalyze.main(tanalyze.init_and_parse_args([
            "-d", fasta, "-f",
            os.path.join(DATA, "golden", "ref_ebola5_m0.fasta"),
            "-m", "2", "-l", "60", "-e", "50",
            "--write-analysis-to-tsv", str(a_tsv),
            "--write-probe-map-counts-to-tsv", str(c_tsv),
            "--device", "cpu"]))
        tsvs.append((a_tsv.read_bytes(), c_tsv.read_bytes()))
    assert tsvs[0] == tsvs[1]
    root = str(tmp_path / "t")
    assert sorted(_traces(root)) == ["cover_scan_join", "cover_scan_verify"]
    for region in ("cover_scan_join", "cover_scan_verify"):
        assert region in _names(root, region)
