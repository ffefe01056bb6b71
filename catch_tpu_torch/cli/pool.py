#!/usr/bin/env python3
# Copied from catch_tpu/cli/pool.py.
"""Pool probes across datasets by searching for optimal parameters.

Flag-compatible with reference bin/pool.py:16-140.
"""

import argparse
import logging

from catch_tpu_torch.pool import param_search
from catch_tpu_torch.utils import log, pool_probes_io, version

logger = logging.getLogger(__name__)


def main(args):
    param_names, probe_counts = pool_probes_io.read_table_of_probe_counts(
        args.probe_count_tsv)

    if args.dataset_weights_tsv:
        dataset_weights = pool_probes_io.read_table_of_dataset_weights(
            args.dataset_weights_tsv, probe_counts.keys())
    else:
        dataset_weights = None

    if args.loss_coeffs and len(args.loss_coeffs) != len(param_names):
        raise ValueError(
            "--loss-coeffs got %d coefficients but the probe-count "
            "table has %d parameter columns; give exactly one "
            "coefficient per parameter" % (len(args.loss_coeffs),
                                           len(param_names)))

    if args.use_nd:
        if args.round_params:
            raise ValueError(
                "--round-params only applies to the standard "
                "2-parameter search; the n-dimensional search "
                "(--use-nd) keeps parameters fractional, so pick one "
                "of the two flags")
        s_results = param_search.higher_dimensional_search(
            param_names, probe_counts, args.target_probe_count,
            loss_coeffs=args.loss_coeffs,
            dataset_weights=dataset_weights)
        write_type = "float"
    else:
        if param_names != ("mismatches", "cover_extension"):
            raise ValueError(
                "the standard search expects exactly the columns "
                "'mismatches' then 'cover_extension' (table has: %s); "
                "pass --use-nd to optimize over a different or larger "
                "parameter set" % ", ".join(param_names))
        s_results = param_search.standard_search(
            probe_counts, args.target_probe_count,
            round_params=args.round_params,
            loss_coeffs=args.loss_coeffs,
            dataset_weights=dataset_weights)
        write_type = "int"

    opt_params, opt_params_count, opt_params_loss = s_results

    pool_probes_io.write_param_values_across_datasets(
        param_names, opt_params, args.param_vals_tsv, type=write_type)

    print("Number of probes: %d" % opt_params_count)
    print("Loss: %f" % opt_params_loss)


def init_and_parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("probe_count_tsv",
        help=("Path to TSV with probe counts for each dataset and "
              "combination of parameters (first column 'dataset', last "
              "'num_probes', intermediary columns are parameters)"))
    parser.add_argument("target_probe_count", type=int,
        help=("Constraint on the total number of probes in the design"))
    parser.add_argument("param_vals_tsv",
        help="Path to output TSV of optimal parameter values")
    parser.add_argument("--round-params", nargs=2, type=int,
        help=("<m> <e>: snap the chosen mismatches value to a "
              "multiple of m and the cover_extension value to a "
              "multiple of e before reporting"))
    parser.add_argument("--use-nd", action="store_true",
        help=("Use the n-dimensional interpolation and search (required "
              "for tables with more than 2 parameters; outputs "
              "fractional values)"))
    parser.add_argument("--loss-coeffs", nargs="+", type=float,
        help=("Coefficients on parameters in the loss function, in "
              "table column order (default: 1 for mismatches, 1/100 for "
              "cover_extension; with --use-nd, 1 for all)"))
    parser.add_argument("--dataset-weights", dest="dataset_weights_tsv",
        help=("Path to TSV with a weight for each dataset ('dataset' / "
              "'weight' columns) for the loss function"))
    parser.add_argument("--debug", dest="log_level",
        action="store_const", const=logging.DEBUG,
        default=logging.WARNING, help="Debug output")
    parser.add_argument("--verbose", dest="log_level",
        action="store_const", const=logging.INFO, help="Verbose output")
    parser.add_argument("--version", "-V", action="version",
        version=version.get_version())
    return parser.parse_args(argv)


def run():
    args = init_and_parse_args()
    log.configure_logging(args.log_level)
    main(args)


if __name__ == "__main__":
    run()
