"""The port's n-dimensional pool search against catch_tpu's on the
published V-WAfr grid, on the CPU.

As tests/test_torch_pool_search.py, for higher_dimensional_search:
typical budgets (the 90,000-probe result written as the golden TSV that
tests/data/golden/make_pool_goldens.py made with catch_tpu's CLI),
budgets too small to meet, and a made-up third parameter.  The third
parameter runs on 8 of the grid's 19 datasets: its search over all 19
(57 parameters through scipy's approximate gradients) takes about 105 s
a package on one CPU core, against about 12 s for the 8.
"""

import logging
import os

import numpy as np
import pytest

from catch_tpu.pool import param_search as jps
from catch_tpu_torch.pool import param_search as tps
from catch_tpu_torch.utils import pool_probes_io as tio

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
VWAFR = os.path.join(DATA, "num-probes.V-WAfr.201506.tsv")
COEFFS = (1.0, 1.0 / 100.0)


@pytest.fixture(autouse=True)
def _quiet():
    logging.disable(logging.WARNING)
    yield
    logging.disable(logging.NOTSET)


@pytest.fixture(scope="module")
def vwafr():
    return tio.read_table_of_probe_counts(VWAFR)


def _search(ps, *args, **kwargs):
    np.random.seed(1)
    return ps.higher_dimensional_search(*args, **kwargs)


def _assert_same(got, want):
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == pytest.approx(want[2], rel=1e-12)


@pytest.mark.parametrize("limit", [90000, 200000])
def test_nd_search_equals_catch_tpu(vwafr, limit, tmp_path):
    param_names, probe_counts = vwafr
    want = _search(jps, param_names, probe_counts, limit, loss_coeffs=COEFFS)
    got = _search(tps, param_names, probe_counts, limit, loss_coeffs=COEFFS)
    _assert_same(got, want)
    opt_params, count, _ = got
    assert 0.9 * limit < count <= limit
    m, ce = opt_params["ebola_zaire-with-2014"]
    assert m <= 3 and ce <= 20
    m, ce = opt_params["hiv1_without_ltr"]
    assert m > 3 or ce > 20
    if limit == 90000:
        tsv = tmp_path / "nd.tsv"
        tio.write_param_values_across_datasets(param_names, opt_params,
                                               str(tsv), type="float")
        with open(os.path.join(DATA, "golden",
                               "pool_vwafr_90000_nd.tsv"), "rb") as f:
            assert tsv.read_bytes() == f.read()


@pytest.mark.parametrize("limit", [1, 1000, 10000])
def test_nd_search_too_small_counts_raise_the_same(vwafr, limit):
    param_names, probe_counts = vwafr
    errs = []
    for ps in (tps, jps):
        with pytest.raises(ps.CannotSatisfyProbeCountConstraintError) as e:
            _search(ps, param_names, probe_counts, limit,
                    loss_coeffs=COEFFS)
        errs.append((type(e.value).__name__, str(e.value)))
    assert errs[0] == errs[1]


def test_nd_search_with_third_param_equals_catch_tpu(vwafr):
    """tests/test_pool.py's third parameter (a count penalty around
    p3 = 20) on 8 datasets at their share of its 150,000 probes."""
    _, probe_counts = vwafr
    datasets = sorted(probe_counts)[::2][:8]
    pc = {}
    for d in datasets:
        pc[d] = {}
        for param_vals, count in probe_counts[d].items():
            for k in [0, 10, 20, 30, 40]:
                pc[d][tuple(param_vals) + (k,)] = \
                    count + 100000 * (k / 20.0 - 1) ** 2
    limit = 150000 * len(datasets) // len(probe_counts)
    names = ("mismatches", "cover_extension", "p3")
    want = _search(jps, names, pc, limit, loss_coeffs=(1.0, 1.0, 1.0))
    got = _search(tps, names, pc, limit, loss_coeffs=(1.0, 1.0, 1.0))
    _assert_same(got, want)
    assert got[1] < limit
    for m, ce, p3 in got[0].values():
        assert 10 <= p3 <= 30
