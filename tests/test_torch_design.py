"""The port's design slice end to end on the CPU, and its boundaries.

catch_tpu_torch.cli.design --device cpu runs the kernels' plain-PyTorch
twins; its probe sets must equal the golden and catch_tpu's own output.
Two fresh interpreters show the port runs without JAX.
"""

import gzip
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from catch_tpu.cli import design as jdesign
from catch_tpu_torch import _build
from catch_tpu_torch.analysis import Analyzer
from catch_tpu_torch.cli import design as tdesign
from catch_tpu_torch.device import resolve_device
from catch_tpu_torch.filters.set_cover_filter import SetCoverFilter
from catch_tpu_torch.ops import scan_instance as si
from catch_tpu_torch.ops.cover import CoverModel, ProbeSearcher
from catch_tpu_torch.probe import Probe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
FIXTURE = os.path.join(DATA, "zaire_ebolavirus.fasta.gz")


def _subset(tmp_path, n):
    """The first n records of the Ebola fixture as a FASTA file."""
    path = tmp_path / f"ebola{n}.fasta"
    recs = []
    with gzip.open(FIXTURE, "rt") as f:
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


def _port_design(argv):
    return tdesign.main(tdesign.init_and_parse_args(argv))


def test_cli_ebola5_m0_equals_golden(tmp_path):
    out = str(tmp_path / "probes.fasta")
    pb = _port_design([_subset(tmp_path, 5), "-o", out, "-pl", "100",
                       "-m", "0", "-e", "0", "--device", "cpu"])
    golden = _records(os.path.join(DATA, "golden", "ref_ebola5_m0.fasta"))
    assert len(golden) == 426
    assert _records(out) == golden
    assert pb.filters[-1].last_run_stats["set_cover_picks"] == 426


def test_cli_ebola10_m2_equals_catch_tpu(tmp_path, monkeypatch):
    fasta = _subset(tmp_path, 10)
    flags = ["-pl", "100", "-m", "2", "-l", "60", "-e", "50"]
    out_t = str(tmp_path / "port.fasta")
    _port_design([fasta, "-o", out_t, "--device", "cpu"] + flags)
    monkeypatch.setenv("CATCH_TPU_INSTANCE", "force")
    out_j = str(tmp_path / "jax.fasta")
    jdesign.main(jdesign.init_and_parse_args(
        "basic", [fasta, "-o", out_j, "--num-devices", "1"] + flags))
    with open(out_t) as a, open(out_j) as b:
        port, ref = a.read(), b.read()
    assert port == ref
    assert port.count(">") > 100


_NO_JAX = r'''
import sys
{block}
from catch_tpu_torch.cli import analyze_probe_coverage, design
design.main(design.init_and_parse_args(
    [{fasta!r}, "-o", {out!r}, "-pl", "100", "-m", "2", "-l", "60",
     "-e", "50", "--device", "cpu"] + {extra!r}))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "catch_tpu"))
assert not bad, bad
print("NO_JAX_OK")
'''

_BLOCK_JAX = r'''
import importlib.abc
class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "catch_tpu"):
            raise ModuleNotFoundError(f"{name} is blocked")
        return None
sys.meta_path.insert(0, _Block())
try:
    import jax
    raise SystemExit("jax was importable")
except ModuleNotFoundError:
    pass
'''


_ON_A_MESH = r'''
assert "catch_tpu_torch.parallel.set_cover" in sys.modules
assert "catch_tpu_torch.parallel.mesh" in sys.modules
print("MESH_OK")
'''


@pytest.mark.parametrize("block,mesh", [("", False), (_BLOCK_JAX, False),
                                        (_BLOCK_JAX, True)],
                         ids=["jax_installed", "jax_blocked",
                              "jax_blocked_on_a_mesh"])
def test_port_runs_without_jax(tmp_path, block, mesh):
    """With `mesh`, the design runs with --num-devices 2 over two virtual
    CPU places, so catch_tpu_torch/parallel/ is imported there too."""
    code = _NO_JAX.format(block=block, fasta=_subset(tmp_path, 2),
                          out=str(tmp_path / "p.fasta"),
                          extra=["--num-devices", "2"] if mesh else [])
    env = dict(os.environ)
    if mesh:
        code += _ON_A_MESH
        env["CATCH_TPU_VIRTUAL_DEVICES"] = "2"
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "NO_JAX_OK" in proc.stdout
    assert ("MESH_OK" in proc.stdout) == mesh
    assert _records(str(tmp_path / "p.fasta"))


@pytest.mark.parametrize("argv", [
    ["--custom-hybridization-fn", "m.py", "f"], ["--add-adapters"],
    ["--filter-polya", "10", "2"],
    ["--skip-set-cover"],
    ["--add-reverse-complements"],
])
def test_cli_refuses_unported_flags(argv, capsys):
    with pytest.raises(SystemExit) as e:
        tdesign.init_and_parse_args(["in.fasta", "-o", "out.fasta"] + argv)
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "not supported by catch_tpu_torch" in err
    assert argv[0] in err


def test_cuda_without_cuda_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="not available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="not available"):
        _port_design([_subset(tmp_path, 1), "-o", str(tmp_path / "o")])
    with pytest.raises(ValueError):
        resolve_device("meta")
    assert resolve_device("cpu") == torch.device("cpu")


def test_unported_features_raise():
    with pytest.raises(NotImplementedError, match="item 12"):
        SetCoverFilter(2, 60, custom_cover_range_fn=("m.py", "f"),
                       device="cpu")
    with pytest.raises(NotImplementedError, match="item 12"):
        SetCoverFilter(2, 60, custom_cover_range_tolerant_fn=("m.py", "f"),
                       device="cpu")
    with pytest.raises(NotImplementedError, match="item 12"):
        Analyzer([], 2, 60, [[]], custom_cover_range_fn=("m.py", "f"),
                 device="cpu")
    probes = [Probe("ACGT" * 25)]
    searcher = ProbeSearcher(probes, CoverModel(None, 60))
    assert searcher.K_static is None
    with pytest.raises(NotImplementedError):
        si.scan_to_boundary_instance(
            searcher, ["ACGT" * 30], np.zeros(1, np.int64),
            np.zeros(1, np.int64), np.array([120]), 1, 0, np.ones(1),
            np.zeros(1, np.int64), torch.device("cpu"))


def test_cpu_tensors_take_the_twins(monkeypatch):
    """CPU tensors never reach the kernel library, and launch counts
    stay at zero."""
    def no_library():
        raise AssertionError("a CPU tensor reached the kernel library")
    monkeypatch.setattr(_build, "library", no_library)
    si.reset_launches()
    codes = torch.randint(1, 5, (400,), dtype=torch.uint8)
    h = si.rolling_hash(codes, 100, 3, 12, 300)
    p, a = si.lookup_expand(*si.build_table(codes.view(4, 100), 12), h, 3)
    assert {(0, 0), (1, 100), (2, 200)} <= set(zip(p.tolist(), a.tolist()))
    k = torch.arange(10, dtype=torch.int64)
    si.segmented_merge(k % 3, k, k + 2)
    assert all(fn.launches == 0 for fn in si.KERNELS.values())


def test_build_key_follows_the_sources(tmp_path, monkeypatch):
    """The build directory is keyed by the sources: an edit gives a new
    key, so a stale library is never loaded."""
    for name in os.listdir(_build.CSRC):
        with open(os.path.join(_build.CSRC, name)) as f:
            (tmp_path / name).write_text(f.read())
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    key = _build.source_hash()
    assert [os.path.basename(p) for p in _build.sources()] == sorted(
        os.listdir(_build.CSRC))
    with open(tmp_path / "rolling_hash.cu", "a") as f:
        f.write("\n// edited\n")
    assert _build.source_hash() != key
