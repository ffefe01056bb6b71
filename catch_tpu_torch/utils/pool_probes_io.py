# Copied from catch_tpu/utils/pool_probes_io.py.
"""TSV I/O for the pool optimizer.

File-format contract (kept compatible with the reference tooling,
reference catch/utils/pool_probes_io.py): a *probe-count table*
is tab-separated with a header whose first column is ``dataset`` and
last column is ``num_probes``; every column between those two names a
design parameter.  A *dataset-weights table* has exactly the two
columns ``dataset`` and ``weight``.  The writer emits one row per
dataset, sorted by dataset name, with the chosen parameter values.
"""

import csv
import logging

logger = logging.getLogger(__name__)

__all__ = ["read_table_of_probe_counts", "read_table_of_dataset_weights",
           "write_param_values_across_datasets"]


class PoolTableError(ValueError):
    """A pool TSV violated its format contract."""


def _tsv_rows(fn):
    """Yield (row_number, fields) for each line of a TSV file.

    Trailing empty fields are dropped (a data row ending in a tab, or
    carrying a stray '\\r', parses the same as without — matching the
    line.rstrip().split('\\t') behavior of the tools that produce
    these files)."""
    with open(fn, newline="") as f:
        for rownum, fields in enumerate(csv.reader(f, delimiter="\t")):
            if fields and fields[-1].endswith("\r"):
                fields[-1] = fields[-1].rstrip("\r")
            while fields and fields[-1] == "":
                fields.pop()
            yield rownum, fields


def read_table_of_probe_counts(fn):
    """Parse a probe-count table.

    Returns:
        (param_names, counts) where param_names is a tuple of the
        parameter column names and counts maps
        dataset -> {tuple-of-param-values -> probe count}.
    """
    param_names = None
    counts = {}
    for rownum, fields in _tsv_rows(fn):
        if rownum == 0:
            if not fields or fields[0] != "dataset":
                raise PoolTableError(
                    "%s: probe-count header must start with a "
                    "'dataset' column (got %r)" % (fn, fields[:1]))
            if fields[-1] != "num_probes":
                raise PoolTableError(
                    "%s: probe-count header must end with a "
                    "'num_probes' column (got %r)" % (fn, fields[-1]))
            param_names = tuple(fields[1:-1])
            continue
        if len(fields) != len(param_names) + 2:
            raise PoolTableError(
                "%s row %d: expected %d fields, found %d"
                % (fn, rownum + 1, len(param_names) + 2, len(fields)))
        dataset, point, n = \
            fields[0], tuple(map(float, fields[1:-1])), int(fields[-1])
        per_dataset = counts.setdefault(dataset, {})
        if point in per_dataset:
            raise PoolTableError(
                "%s row %d: duplicate parameter point %r for dataset %s"
                % (fn, rownum + 1, point, dataset))
        per_dataset[point] = n
    return param_names, counts


def read_table_of_dataset_weights(fn, datasets_to_check=None):
    """Parse a dataset-weights table into {dataset: weight}.

    If datasets_to_check is given, every name in it must appear in the
    table (extra rows are allowed and kept).
    """
    weights = {}
    for rownum, fields in _tsv_rows(fn):
        if rownum == 0:
            if fields[:2] != ["dataset", "weight"] or len(fields) != 2:
                raise PoolTableError(
                    "%s: weights header must be exactly "
                    "'dataset<TAB>weight' (got %r)" % (fn, fields))
            continue
        if len(fields) != 2:
            raise PoolTableError(
                "%s row %d: expected 2 fields, found %d"
                % (fn, rownum + 1, len(fields)))
        dataset = fields[0]
        if dataset in weights:
            raise PoolTableError(
                "%s row %d: dataset %s has more than one weight row"
                % (fn, rownum + 1, dataset))
        weights[dataset] = float(fields[1])

    missing = [d for d in (datasets_to_check or ()) if d not in weights]
    if missing:
        raise PoolTableError(
            "%s: no weight row for dataset(s): %s"
            % (fn, ", ".join(sorted(missing))))
    return weights


def write_param_values_across_datasets(param_names, param_vals, out_tsv,
                                       type="int"):
    """Write chosen per-dataset parameter values as a TSV.

    param_vals maps dataset -> sequence of values (one per
    param_names entry); `type` selects integer or float rendering.
    """
    try:
        fmt = {"int": "%d", "float": "%f"}[type]
    except KeyError:
        raise ValueError("type must be 'int' or 'float', not %r" % type)
    with open(out_tsv, "w", newline="") as f:
        w = csv.writer(f, delimiter="\t", lineterminator="\n")
        w.writerow(("dataset",) + tuple(param_names))
        for dataset in sorted(param_vals):
            w.writerow((dataset,)
                       + tuple(fmt % v for v in param_vals[dataset]))
