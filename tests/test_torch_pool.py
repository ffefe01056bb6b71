"""The port's pool optimizer against catch_tpu's, piece by piece, on the
CPU.

The counterparts of tests/test_pool.py's helper and TSV tests, and the
interpolators and the loss of both packages on the same inputs: every
grid point and 200 seeded off-grid points of the published V-WAfr grid,
and the loss at seeded parameter vectors.  The pool optimizer is host
numpy and scipy in both packages, so every comparison is exact.  The
searches themselves are in tests/test_torch_pool_search.py.
"""

import logging
import os
import subprocess
import sys

import numpy as np
import pytest

from catch_tpu.cli import pool as jpool
from catch_tpu.pool import interpolate_count as jic
from catch_tpu.pool import param_search as jps
from catch_tpu.utils import pool_probes_io as jio
from catch_tpu_torch.cli import pool as tpool
from catch_tpu_torch.pool import interpolate_count as tic
from catch_tpu_torch.pool import param_search as tps
from catch_tpu_torch.utils import pool_probes_io as tio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
VWAFR = os.path.join(DATA, "num-probes.V-WAfr.201506.tsv")


@pytest.fixture(autouse=True)
def _quiet():
    logging.disable(logging.WARNING)
    yield
    logging.disable(logging.NOTSET)


@pytest.fixture(scope="module")
def vwafr():
    return tio.read_table_of_probe_counts(VWAFR)


def _both(fn_name, *args, seed=1, **kwargs):
    """fn_name of param_search in both packages, numpy's global generator
    seeded the same just before each."""
    np.random.seed(seed)
    want = getattr(jps, fn_name)(*args, **kwargs)
    np.random.seed(seed)
    got = getattr(tps, fn_name)(*args, **kwargs)
    return got, want


# ----------------------------------------------------------------------
# tests/test_pool.py TestHelperFunctions
# ----------------------------------------------------------------------

PC_STANDARD = {"d1": {(1, 10): 6000, (2, 10): 5000, (2, 20): 4500,
                      (4, 10): 4000, (4, 20): 3000, (5, 20): 2500}}
PC_ND = {"d1": {(1, 0): 6000, (2, 10): 5000, (2, 20): 4500,
                (4, 10): 4000, (4, 20): 3000, (4, 30): 2500},
         "d2": {(6, 40): 10, (7, 60): 20}}
PC_ROUND = {"d1": {(1, 0): 6000, (1, 10): 5500, (1, 20): 5400,
                   (2, 10): 5000, (2, 20): 4500, (4, 10): 4000,
                   (4, 20): 3000, (4, 30): 2500},
            "d2": {(2, 10): 10000, (3, 0): 2000, (3, 10): 1100,
                   (4, 10): 1000, (2, 20): 9000, (3, 20): 900,
                   (4, 20): 10}}


def test_bounds_and_initial_guess_standard():
    bounds = tps._make_param_bounds_standard(PC_STANDARD)
    assert bounds == jps._make_param_bounds_standard(PC_STANDARD)
    got, want = _both("_make_initial_guess", PC_STANDARD, bounds, 2)
    assert np.array_equal(got, want)
    assert 2 <= got[0] <= 4 and 10 <= got[1] <= 20


def test_bounds_and_initial_guess_nd():
    assert tps._make_param_bounds_nd(PC_ND) == jps._make_param_bounds_nd(
        PC_ND)
    got, want = _both("_make_initial_guess", PC_ND, None, 2)
    assert np.array_equal(got, want)
    assert tuple(got[0:2]) in PC_ND["d1"]
    assert tuple(got[2:4]) in PC_ND["d2"]


@pytest.mark.parametrize("params,limit,rounds,expect", [
    ([2.5, 12, 4, 15], 4560, (1, 10), [2, 20, 4, 20]),
    ([2.5, 12.3, 4, 14.2], 5500, (1, 1), None),
], ids=["round10", "round1"])
def test_round_params(params, limit, rounds, expect):
    kw = dict(mismatches_round=rounds[0], cover_extension_round=rounds[1])
    args = (params, PC_ROUND, limit, (1.0, 1.0 / 100.0),
            {"d1": 1.0, "d2": 1.0})
    got = tps._round_params(*args, **kw)
    assert got == jps._round_params(*args, **kw)
    if expect is not None:
        assert got == expect
    assert all(v == int(v) for v in got)


def test_round_params_over_the_limit_raises_the_same():
    args = ([4, 20, 4, 20], PC_ROUND, 100, (1.0, 0.01),
            {"d1": 1.0, "d2": 1.0})
    with pytest.raises(jps.CannotSatisfyProbeCountConstraintError) as j:
        jps._round_params(*args)
    with pytest.raises(tps.CannotSatisfyProbeCountConstraintError) as t:
        tps._round_params(*args)
    assert str(t.value) == str(j.value)


# ----------------------------------------------------------------------
# tests/test_pool.py TestPoolProbesIO
# ----------------------------------------------------------------------

def test_read_vwafr_equals_catch_tpu(vwafr):
    assert vwafr == jio.read_table_of_probe_counts(VWAFR)
    assert vwafr[0] == ("mismatches", "cover_extension")
    assert "ebola_zaire-with-2014" in vwafr[1]


@pytest.mark.parametrize("type_", ["int", "float"])
def test_write_roundtrip_equals_catch_tpu(vwafr, tmp_path, type_):
    param_names, probe_counts = vwafr
    rng = np.random.default_rng(3)
    vals = {d: (int(rng.integers(0, 8)), float(rng.uniform(0, 100)))
            for d in probe_counts}
    got, want = tmp_path / "t.tsv", tmp_path / "j.tsv"
    tio.write_param_values_across_datasets(param_names, vals, str(got),
                                           type=type_)
    jio.write_param_values_across_datasets(param_names, vals, str(want),
                                           type=type_)
    assert got.read_bytes() == want.read_bytes()
    lines = got.read_text().splitlines()
    assert lines[0] == "dataset\tmismatches\tcover_extension"
    assert len(lines) == len(probe_counts) + 1


def test_write_unknown_type_raises_the_same(tmp_path):
    errs = []
    for io in (tio, jio):
        with pytest.raises(ValueError) as e:
            io.write_param_values_across_datasets(
                ("a",), {"d": (1,)}, str(tmp_path / "x.tsv"), type="hex")
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_trailing_tab_rows_parse(tmp_path):
    f = tmp_path / "counts.tsv"
    f.write_text("dataset\tmismatches\tcover_extension\t"
                 "num_probes\nd1\t2\t10\t100\t\nd1\t3\t20\t90\r\n")
    names, counts = tio.read_table_of_probe_counts(str(f))
    assert (names, counts) == jio.read_table_of_probe_counts(str(f))
    assert names == ("mismatches", "cover_extension")
    assert counts["d1"][(2.0, 10.0)] == 100
    assert counts["d1"][(3.0, 20.0)] == 90


def test_weights_read_equals_catch_tpu(tmp_path):
    wf = tmp_path / "w.tsv"
    wf.write_text("dataset\tweight\nd1\t1.0\nd2\t2.5\nd3\t0.5\n")
    got = tio.read_table_of_dataset_weights(str(wf), ["d1", "d2"])
    assert got == jio.read_table_of_dataset_weights(str(wf), ["d1", "d2"])
    assert got == {"d1": 1.0, "d2": 2.5, "d3": 0.5}


COUNTS_HEAD = "dataset\tmismatches\tnum_probes\n"


@pytest.mark.parametrize("reader,text", [
    ("counts", "name\tmismatches\tnum_probes\nd1\t1\t5\n"),
    ("counts", "dataset\tmismatches\tcount\nd1\t1\t5\n"),
    ("counts", COUNTS_HEAD + "d1\t1\t5\t7\n"),
    ("counts", COUNTS_HEAD + "d1\t1\t5\nd1\t1.0\t6\n"),
    ("weights", "dataset\tweight\nd1\t1.0\n"),
    ("weights", "dataset\tw\nd1\t1.0\n"),
    ("weights", "dataset\tweight\nd1\t1.0\t2\n"),
    ("weights", "dataset\tweight\nd1\t1.0\nd1\t2.0\n"),
], ids=["no_dataset_column", "no_num_probes_column", "field_count",
        "duplicate_point", "missing_dataset", "weights_header",
        "weights_field_count", "duplicate_weight"])
def test_malformed_tables_raise_the_same(tmp_path, reader, text):
    """The same error in both packages: the class name and the message
    (the two PoolTableError classes are different objects)."""
    f = tmp_path / "t.tsv"
    f.write_text(text)
    errs = []
    for io in (tio, jio):
        with pytest.raises(ValueError) as e:
            if reader == "counts":
                io.read_table_of_probe_counts(str(f))
            else:
                io.read_table_of_dataset_weights(str(f), ["d1", "d2"])
        errs.append((type(e.value).__name__, str(e.value)))
    assert errs[0] == errs[1]
    assert errs[0][0] == "PoolTableError"


@pytest.mark.parametrize("table,flags", [
    ("vwafr", ["--use-nd", "--round-params", "1", "10"]),
    ("vwafr", ["--loss-coeffs", "1"]),
    ("three", []),
], ids=["nd_with_round_params", "loss_coeffs_count", "standard_on_three"])
def test_cli_argument_errors_equal_catch_tpu(tmp_path, table, flags):
    """cli/pool.py's refusals, raised before any search: the same class
    and message from both packages."""
    if table == "three":
        path = tmp_path / "three.tsv"
        path.write_text("dataset\tmismatches\tcover_extension\tp3\t"
                        "num_probes\nd1\t1\t10\t0\t5\n")
    else:
        path = VWAFR
    errs = []
    for cli in (tpool, jpool):
        args = cli.init_and_parse_args(
            [str(path), "100", str(tmp_path / "out.tsv")] + flags)
        with pytest.raises(ValueError) as e:
            cli.main(args)
        errs.append((type(e.value).__name__, str(e.value)))
    assert errs[0] == errs[1]
    assert not (tmp_path / "out.tsv").exists()


# ----------------------------------------------------------------------
# The interpolators and the loss
# ----------------------------------------------------------------------

def _same(got, want):
    """Exactly equal, NaN (outside the n-dimensional grid's hull) equal
    to NaN."""
    return got == want or (np.isnan(got) and np.isnan(want))


def _off_grid(probe_counts, bounds, n, seed):
    """n packed parameter vectors drawn uniformly inside `bounds`."""
    rng = np.random.default_rng(seed)
    lo, hi = np.array(bounds, dtype=np.float64).T
    return lo + (hi - lo) * rng.random((n, len(bounds)))


@pytest.mark.parametrize("kind", ["standard", "nd"])
def test_interpolators_equal_catch_tpu(vwafr, kind):
    """Every grid point and 200 seeded off-grid points of every dataset:
    the per-dataset interpolators of both packages agree exactly (NaN
    where the n-dimensional one has no value)."""
    _, probe_counts = vwafr
    make = {"standard": "_make_interp_probe_count_for_dataset_standard_fn",
            "nd": "_make_interp_probe_count_for_dataset_nd_fn"}[kind]
    got_fn = getattr(tic, make)(probe_counts)
    want_fn = getattr(jic, make)(probe_counts)
    datasets = sorted(probe_counts)
    bounds = (tps._make_param_bounds_standard if kind == "standard"
              else tps._make_param_bounds_nd)(probe_counts)
    xs = _off_grid(probe_counts, bounds, 200, seed=7)
    n = 0
    for i, d in enumerate(datasets):
        points = [list(p) for p in probe_counts[d]]
        points += [list(x[2 * i:2 * i + 2]) for x in xs]
        for p in points:
            got, want = got_fn(d, p), want_fn(d, p)
            assert _same(got, want), (d, p, got, want)
            n += 1
        if kind == "standard":   # the nd one rescales: off by an ulp
            for p, count in probe_counts[d].items():
                assert got_fn(d, list(p)) == count
    assert n >= 200 * len(datasets)


@pytest.mark.parametrize("kind", ["standard", "nd"])
def test_total_and_loss_equal_catch_tpu(vwafr, kind):
    """The summed count and the loss (at several barrier weights, past
    the probe limit and, for nd, outside the grid's hull) at 50 seeded
    parameter vectors."""
    _, probe_counts = vwafr
    total_t = tic._make_total_probe_count_across_datasets_fn(
        probe_counts, interp_fn_type=kind)
    total_j = jic._make_total_probe_count_across_datasets_fn(
        probe_counts, interp_fn_type=kind)
    bounds = (tps._make_param_bounds_standard if kind == "standard"
              else tps._make_param_bounds_nd)(probe_counts)
    weights = {d: 1.0 + i % 3 for i, d in enumerate(sorted(probe_counts))}
    for limit in (90000, 200000):
        loss_t = tps._make_loss_fn(probe_counts, limit, (1.0, 0.01),
                                   weights, interp_fn_type=kind)
        loss_j = jps._make_loss_fn(probe_counts, limit, (1.0, 0.01),
                                   weights, interp_fn_type=kind)
        for x in _off_grid(probe_counts, bounds, 50, seed=limit):
            assert _same(total_t(x), total_j(x))
            for eps in (10.0, 1.0, 0.01, 0):
                assert loss_t(x, eps) == loss_j(x, eps)


def test_port_imports_neither_scipy_nor_the_reference():
    """In a fresh interpreter, the port's pool CLI imports no scipy (the
    search imports it inside the functions that need it), no JAX and
    nothing of catch_tpu."""
    code = ("import sys; import catch_tpu_torch.cli.pool; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('scipy', 'jax', 'catch_tpu')); assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=120)
