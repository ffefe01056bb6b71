"""On the card: the reference there agrees with itself on the CPU, and a
small run through the harness is correct while its control is not.
Each test skips where there is no CUDA card (decided inside it)."""
import os

import pytest
import torch

from bench_port import reference as R
from bench_port import run
from bench_port.tests.conftest import ROOT


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.fixture(scope="module")
def ebola10():
    recs = R.read_fasta(os.path.join(ROOT, "bench_port", "data",
                                     "zaire_ebolavirus.fasta.gz"))
    return [[s] for _, s in recs[:10]]


@pytest.mark.cuda
def test_spans_and_design_on_the_card_equal_the_cpu(ebola10):
    need_card()
    model = R.Model(100, 50, 2, 60, 50)
    seqs = [g[0] for g in ebola10]
    cands = R.candidates(seqs, model)

    def spans(device):
        return set(zip(*(x.tolist() for x in R.spans(cands, seqs, model,
                                                     device))))
    assert spans("cuda") == spans("cpu")
    assert R.design(ebola10, model, "cuda")[0] == \
        R.design(ebola10, model, "cpu")[0]


@pytest.mark.cuda
@pytest.mark.parametrize("control", [False, True])
def test_a_small_run_on_the_card(control):
    need_card()
    cell, config, tr, e2e, layer = run.load_cell("ebola175-m2")
    tr = dict(tr, jobs=2, check_jobs=1)
    config = dict(config, corpus=dict(config["corpus"], n_genomes=20))
    res = run.run_cell(config, tr, e2e, layer, seed=2**32 + 5, seconds=0.01,
                       trace=not control, device="cuda", control=control)
    assert res["correct"] != control, res["checks"]
    assert res["device"]["platform"] == "gpu"
