#!/usr/bin/env python3
# Copied from catch_tpu/cli/analyze_probe_coverage.py (plus --device).
"""Run the coverage analysis on a provided list of probe sequences, on a
GPU.

Flag-compatible with catch_tpu's analyze_probe_coverage: a dataset is a
FASTA file or `download:TAXID`, fetched from NCBI
(utils/ncbi_neighbors.py, which needs the network).  `--device`
(default `cuda`) says where the scan runs; a missing CUDA device is an
error, never a quiet switch to the CPU.
`--max-num-processes` is accepted and unused, as in catch_tpu.

Run as ``python -m catch_tpu_torch.cli.analyze_probe_coverage``.
"""

import argparse
import logging
import os

from catch_tpu_torch.analysis import coverage as coverage_analysis
from catch_tpu_torch.device import resolve_device
from catch_tpu_torch.probe import Probe
from catch_tpu_torch.utils import log, ncbi_neighbors, seq_io, version


def main(args):
    """Run the analysis; returns the Analyzer."""
    device = resolve_device(args.device)
    genomes_grouped = []
    genomes_grouped_names = []
    for ds in args.dataset:
        if ds.startswith("download:"):
            taxid = ds[len("download:"):]
            ds_fasta_tf = ncbi_neighbors.construct_fasta_for_taxid(taxid)
            genomes_grouped.append(
                seq_io.read_genomes_from_fasta(ds_fasta_tf.name))
            genomes_grouped_names.append("taxid:" + str(taxid))
            ds_fasta_tf.close()
        elif os.path.isfile(ds):
            genomes_grouped.append(seq_io.read_genomes_from_fasta(ds))
            genomes_grouped_names.append(os.path.basename(ds))
        else:
            raise ValueError(
                "Dataset labels are not allowed as input. Please specify "
                "only NCBI taxonomy IDs to download (via "
                "'download:taxid') or FASTA files. If you already "
                "specified a FASTA file, please check that the path to "
                f"'{ds}' is valid.")

    if args.limit_target_genomes:
        genomes_grouped = [genomes[:args.limit_target_genomes]
                           for genomes in genomes_grouped]

    fasta = seq_io.read_fasta(args.probes_fasta)
    probes = [Probe.from_str(seq) for _, seq in fasta.items()]

    analyzer = coverage_analysis.Analyzer(
        probes, args.mismatches, args.lcf_thres, genomes_grouped,
        genomes_grouped_names,
        island_of_exact_match=args.island_of_exact_match,
        cover_extension=args.cover_extension,
        kmer_probe_map_k=args.kmer_probe_map_k, device=device)
    analyzer.run()
    if args.write_analysis_to_tsv:
        analyzer.write_data_matrix_as_tsv(args.write_analysis_to_tsv)
    if args.write_sliding_window_coverage:
        analyzer.write_sliding_window_coverage(
            args.write_sliding_window_coverage)
    if args.write_probe_map_counts_to_tsv:
        analyzer.write_probe_map_counts(args.write_probe_map_counts_to_tsv)
    if args.print_analysis:
        analyzer.print_analysis()
    return analyzer


def init_and_parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-d", "--dataset", nargs="+", required=True,
        help=("One or more target datasets ('download:TAXID' or a FASTA "
              "path)"))
    parser.add_argument("-f", "--probes-fasta", required=True,
        help="Path to a FASTA file with the probe sequences to analyze")
    parser.add_argument("-m", "--mismatches", required=True, type=int,
        help=("Allow for this number of mismatches when determining "
              "whether a probe covers a sequence"))
    parser.add_argument("-l", "--lcf-thres", required=True, type=int,
        help=("Cover threshold: shared substring length with at most "
              "MISMATCHES mismatches"))
    parser.add_argument("--island-of-exact-match", type=int, default=0,
        help=("(Optional) Require an exact match of at least this "
              "length for a probe to cover a sequence"))
    parser.add_argument("-e", "--cover-extension", type=int, default=0,
        help="Extend coverage on each side of a probe by this many nt")
    parser.add_argument("--limit-target-genomes", type=int,
        help="(Optional) Use only the first N target genomes per dataset")
    parser.add_argument("--print-analysis", dest="print_analysis",
        action="store_true", help="Print analysis of the coverage")
    parser.add_argument("--write-analysis-to-tsv",
        help="(Optional) File for a TSV matrix of the coverage analysis")
    parser.add_argument("--write-sliding-window-coverage",
        help="(Optional) File for sliding-window average coverage")
    parser.add_argument("--write-probe-map-counts-to-tsv",
        help=("(Optional) File for a TSV of the number of sequences "
              "each probe maps to"))

    def check_max_num_processes(val):
        ival = int(val)
        if ival >= 1:
            return ival
        raise argparse.ArgumentTypeError(
            "MAX_NUM_PROCESSES must be an int >= 1")

    parser.add_argument("--max-num-processes",
        type=check_max_num_processes,
        help="(Optional) Accepted for compatibility; unused")
    parser.add_argument("--kmer-probe-map-k", type=int, default=10,
        help=("(Optional) Seed k-mer length when mapping probes to "
              "target sequences"))
    parser.add_argument("--device", default="cuda",
        help="Device of the scan: 'cuda' (or 'cuda:N') or 'cpu'")
    parser.add_argument("--debug", dest="log_level",
        action="store_const", const=logging.DEBUG,
        default=logging.WARNING, help="Debug output")
    parser.add_argument("--verbose", dest="log_level",
        action="store_const", const=logging.INFO, help="Verbose output")
    parser.add_argument("-V", "--version", action="version",
        version=version.get_version())
    return parser.parse_args(argv)


def run():
    args = init_and_parse_args()
    log.configure_logging(args.log_level)
    main(args)


if __name__ == "__main__":
    run()
