"""What the benchmark's modules load, by whole top-level names: neither
the harness nor the reference may load JAX or the JAX package
(catch_tpu), and the reference loads nothing of the program either."""
import json
import subprocess
import sys

import pytest

from bench_port import run
from bench_port.tests.conftest import ROOT

LOADED = ("import json, sys; {imports}; "
          "print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))")


def top_level_names(imports):
    out = subprocess.run(
        [sys.executable, "-c", LOADED.format(imports=imports)], cwd=ROOT,
        capture_output=True, text=True, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_reference_loads_neither_jax_nor_any_catch_package():
    names = top_level_names(
        "import bench_port.reference, bench_port.check, "
        "bench_port.traffic; from bench_port import plugins; "
        "[plugins.load('checks', c) for c in ('design', 'design_large')]; "
        "plugins.load('generators', 'fasta_draw')")
    assert not names & {"jax", "jaxlib", "flax", "catch_tpu",
                        "catch_tpu_torch"}, names


def test_the_harness_and_the_program_load_no_jax():
    names = top_level_names(
        "import bench_port.run as r; import bench_port.trace, "
        "bench_port.roofline, bench_port.traffic, bench_port.plugins; "
        "import catch_tpu_torch.cli.design, catch_tpu_torch.cli.design_large; "
        "bench_port.plugins.load('entries', 'design'); "
        "[r.reader(m) for m in ('design_s', 'tiling_s.design')]")
    assert "catch_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "catch_tpu"}, names


@pytest.mark.parametrize("loaded,bad", [
    (["catch_tpu_torch.ops.set_cover", "numpy"], []),
    (["catch_tpu.ops.cover"], ["catch_tpu"]),
    (["jax.numpy", "jaxlib"], ["jax", "jaxlib"]),
    (["flaxen", "jaxtyping"], []),
])
def test_forbidden_names_are_whole_words(monkeypatch, loaded, bad):
    mods = {m: object() for m in loaded}
    monkeypatch.setattr(sys, "modules", mods)
    assert run.forbidden_loaded() == bad


def test_no_result_without_a_card(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    assert run.main(["--workload", "ebola175-m2", "--seed", "1",
                     "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""
