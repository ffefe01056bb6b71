"""The port's standard pool search against catch_tpu's on the V-All
2016-06 grid (10,657 computed design points, 296 datasets), on the CPU.

tests/test_pool.py TestVAllGrid's 60-dataset slice at its share of the
published 350,000-probe budget, in both packages with numpy's global
generator seeded with 1 just before each: the chosen parameters and the
probe count must be equal, the loss equal to rel=1e-12, and the result
written as a TSV must equal the golden that
tests/data/golden/make_pool_goldens.py made with catch_tpu's CLI (about
45 s a package on one CPU core).  The full 296-dataset search runs tens
of minutes a package: opt in with CATCH_TPU_SLOW_TESTS=1, as
tests/test_pool.py does.
"""

import logging
import os

import numpy as np
import pytest

from catch_tpu.pool import param_search as jps
from catch_tpu_torch.pool import param_search as tps
from catch_tpu_torch.utils import pool_probes_io as tio

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


@pytest.fixture(autouse=True)
def _quiet():
    logging.disable(logging.WARNING)
    yield
    logging.disable(logging.NOTSET)


@pytest.fixture(scope="module")
def vall():
    return tio.read_table_of_probe_counts(
        os.path.join(DATA, "num-probes.V-All.201606.tsv"))


def _both(probe_counts, budget):
    out = []
    for ps in (tps, jps):
        np.random.seed(1)
        out.append(ps.standard_search(probe_counts, budget))
    got, want = out
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == pytest.approx(want[2], rel=1e-12)
    opt_params, count, loss = got
    assert 0.8 * budget < count <= budget and np.isfinite(loss)
    assert all(m == int(m) and ce == int(ce)
               for m, ce in opt_params.values())
    assert any(m > 0 for m, _ in opt_params.values())
    return got


def test_vall_slice_equals_catch_tpu_and_golden(vall, tmp_path):
    param_names, probe_counts = vall
    subset = {d: probe_counts[d] for d in sorted(probe_counts)[::5][:60]}
    opt_params, _, _ = _both(
        subset, int(350000 * len(subset) / len(probe_counts)))
    tsv = tmp_path / "vall60.tsv"
    tio.write_param_values_across_datasets(param_names, opt_params, str(tsv))
    with open(os.path.join(DATA, "golden", "pool_vall60.tsv"), "rb") as f:
        assert tsv.read_bytes() == f.read()


def test_vall_350k_full_equals_catch_tpu(vall):
    if not os.environ.get("CATCH_TPU_SLOW_TESTS"):
        pytest.skip("full 296-dataset V-All search takes tens of minutes a "
                    "package; opt in with CATCH_TPU_SLOW_TESTS=1")
    _both(vall[1], 350000)
