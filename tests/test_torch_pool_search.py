"""The port's standard pool search and cli/pool.py against catch_tpu's on
the published V-WAfr grid, on the CPU.

The searches of tests/test_pool.py's TestSearchFunctions (typical
budgets, loss coefficients, dataset weights, budgets too small to meet)
run in both packages with numpy's global generator seeded with 1 just
before each: the initial guess draws from it.  The chosen parameters
and the probe count must be equal, the loss equal to rel=1e-12, and an
error the same class name and message.  cli/pool.py of both packages
must write the same TSV, equal to the golden that
tests/data/golden/make_pool_goldens.py made with catch_tpu, and print
the same lines.  A search takes about 10 s on one CPU core; the
n-dimensional searches and the V-All slice are in
tests/test_torch_pool_search_nd.py and tests/test_torch_pool_vall.py,
so that workers that take whole files run them side by side.
"""

import logging
import os

import numpy as np
import pytest

from catch_tpu.cli import pool as jpool
from catch_tpu.pool import param_search as jps
from catch_tpu_torch.cli import pool as tpool
from catch_tpu_torch.pool import param_search as tps
from catch_tpu_torch.utils import pool_probes_io as tio

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
VWAFR = os.path.join(DATA, "num-probes.V-WAfr.201506.tsv")


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
    return ps.standard_search(*args, **kwargs)


def _weights(probe_counts):
    w = {d: 1.0 for d in probe_counts}
    w["hiv1_without_ltr"] = w["hepatitis_c"] = 1000.0
    return w


@pytest.mark.parametrize("limit,kw", [
    (90000, {}),
    (200000, {}),
    (50000, dict(loss_coeffs=(0.01, 1.0))),
    (420000, "weights"),
], ids=["typical_90000", "typical_200000", "coefficients", "weights"])
def test_standard_search_equals_catch_tpu(vwafr, limit, kw):
    _, probe_counts = vwafr
    if kw == "weights":
        kw = dict(dataset_weights=_weights(probe_counts))
    want = _search(jps, probe_counts, limit, **kw)
    got = _search(tps, probe_counts, limit, **kw)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == pytest.approx(want[2], rel=1e-12)
    opt_params, count, _ = got
    assert count <= limit and set(opt_params) == set(probe_counts)
    if "loss_coeffs" in kw:
        assert all(m > 5 for m, _ in opt_params.values())
    elif "dataset_weights" in kw:
        for d in ("hiv1_without_ltr", "hepatitis_c"):
            assert opt_params[d][0] <= 2 and opt_params[d][1] <= 20
    else:
        assert count > 0.9 * limit
        m, ce = opt_params["ebola_zaire-with-2014"]
        assert m <= 3 and ce <= 20
        m, ce = opt_params["hiv1_without_ltr"]
        assert m > 3 or ce > 20


@pytest.mark.parametrize("limit", [1, 1000, 10000])
def test_standard_search_too_small_counts_raise_the_same(vwafr, limit):
    _, probe_counts = vwafr
    errs = []
    for ps in (tps, jps):
        with pytest.raises(ps.CannotSatisfyProbeCountConstraintError) as e:
            _search(ps, probe_counts, limit)
        errs.append((type(e.value).__name__, str(e.value)))
    assert errs[0] == errs[1]


def test_cli_equals_catch_tpu_and_golden(tmp_path, capsys):
    """num-probes.V-WAfr.201506.tsv 90000 --round-params 1 10: the same
    TSV bytes and stdout from both CLIs, the TSV equal to the golden."""
    outs = []
    for name, cli in (("torch", tpool), ("jax", jpool)):
        tsv = tmp_path / f"{name}.tsv"
        args = cli.init_and_parse_args([VWAFR, "90000", str(tsv),
                                        "--round-params", "1", "10"])
        np.random.seed(1)
        cli.main(args)
        outs.append((tsv.read_bytes(), capsys.readouterr().out))
    assert outs[0] == outs[1]
    with open(os.path.join(DATA, "golden",
                           "pool_vwafr_90000_round_1_10.tsv"), "rb") as f:
        assert outs[0][0] == f.read()
    lines = outs[0][1].splitlines()
    assert len(lines) == 2 and lines[0].startswith("Number of probes: ")
    assert lines[1].startswith("Loss: ")
