#!/usr/bin/env python3
# Copied from catch_tpu/cli/design_naively.py (with --device).
"""Design probes in naive ways (baselines for comparison).

Flag-compatible with reference bin/design_naively.py:26-197, with
`--device` (default `cuda`) for the --print-analysis scan; a missing
CUDA device is an error, never a quiet switch to the CPU.
"""

import argparse
import logging
import os
import random

from catch_tpu_torch import designer as probe_designer
from catch_tpu_torch.analysis import coverage as coverage_analysis
from catch_tpu_torch.device import resolve_device
from catch_tpu_torch.filters import naive_redundant
from catch_tpu_torch.filters.dominating_set import DominatingSetFilter
from catch_tpu_torch.filters.duplicate import DuplicateFilter
from catch_tpu_torch.filters.naive_redundant import NaiveRedundantFilter
from catch_tpu_torch.filters.reverse_complement import ReverseComplementFilter
from catch_tpu_torch.utils import log, seq_io, version


def main(args):
    device = resolve_device(args.device)
    ds = args.dataset
    if os.path.isfile(ds):
        seqs = [seq_io.read_genomes_from_fasta(ds)]
    else:
        raise ValueError(
            "%r is not a readable file; this command takes a FASTA "
            "path (named dataset labels are not supported here)" % ds)

    if (args.limit_target_genomes and
            args.limit_target_genomes_randomly_with_replacement):
        raise ValueError(
            "--limit-target-genomes and "
            "--limit-target-genomes-randomly-with-replacement are "
            "mutually exclusive; choose one way to subsample")
    elif args.limit_target_genomes:
        seqs = [genomes[:args.limit_target_genomes] for genomes in seqs]
    elif args.limit_target_genomes_randomly_with_replacement:
        k = args.limit_target_genomes_randomly_with_replacement
        seqs = [random.choices(genomes, k=k) for genomes in seqs]

    filters = [DuplicateFilter()]
    mismatches = None

    if args.naive_redundant_filter and args.dominating_set_filter:
        raise ValueError(
            "pick either --naive-redundant-filter or "
            "--dominating-set-filter, not both — they are alternative "
            "redundancy strategies over the same graph")
    elif args.naive_redundant_filter or args.dominating_set_filter:
        if args.naive_redundant_filter:
            mismatches, lcf_thres = args.naive_redundant_filter
            filt_class = NaiveRedundantFilter
        if args.dominating_set_filter:
            mismatches, lcf_thres = args.dominating_set_filter
            filt_class = DominatingSetFilter
        redundant_fn = naive_redundant.redundant_longest_common_substring(
            mismatches, lcf_thres)
        filters.append(filt_class(redundant_fn))

    if args.add_reverse_complements:
        filters.append(ReverseComplementFilter())

    pb = probe_designer.ProbeDesigner(
        seqs, filters, probe_length=args.probe_length,
        probe_stride=args.probe_stride, device=device)
    pb.design()

    if args.print_analysis:
        mismatch_thres = mismatches if mismatches is not None else 0
        analyzer = coverage_analysis.Analyzer(
            pb.final_probes, mismatch_thres, args.probe_length, seqs,
            [args.dataset], device=device)
        analyzer.run()
        analyzer.print_analysis()
    else:
        print(len(pb.final_probes))


def init_and_parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("dataset", help="Path to fasta file")
    parser.add_argument("-pl", "--probe-length", type=int, default=100,
        help="Length in bp of every designed probe (default 100)")
    parser.add_argument("-ps", "--probe-stride", type=int, default=50,
        help=("Spacing in bp between consecutive candidate probe "
              "start positions (default 50)"))
    parser.add_argument("-nrf", "--naive-redundant-filter", nargs=2,
        type=int,
        help=("Args: <MISMATCHES> <LCF_THRES>. Greedily remove probes "
              "redundant to an earlier probe (LCS with <= MISMATCHES "
              "mismatches of length >= LCF_THRES)"))
    parser.add_argument("-dsf", "--dominating-set-filter", nargs=2,
        type=int,
        help=("Args: <MISMATCHES> <LCF_THRES>. Approximate a smallest "
              "dominating set over the redundancy graph"))
    parser.add_argument("--add-reverse-complements",
        dest="add_reverse_complements", action="store_true",
        help="Add to the output the reverse complement of each probe")
    parser.add_argument("--limit-target-genomes", type=int,
        help="Design against only the first N input genomes")
    parser.add_argument(
        "--limit-target-genomes-randomly-with-replacement", type=int,
        help="Design against N genomes sampled uniformly with "
             "replacement from the input")
    parser.add_argument("--print-analysis", dest="print_analysis",
        action="store_true",
        help="Print analysis of the probe set's coverage")
    parser.add_argument("--device", default="cuda",
        help=("Device of the --print-analysis scan: 'cuda' (or "
              "'cuda:N') or 'cpu'"))
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
