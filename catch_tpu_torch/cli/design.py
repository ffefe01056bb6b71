#!/usr/bin/env python3
"""Design probes for genome capture on a GPU (main executable).

The port of catch_tpu/cli/design.py for the flags the slices serve:
datasets as FASTA files, candidate tiling, duplicate or near-duplicate
removal (MinHash or Hamming LSH), MinHash clustering of the inputs with
a design per cluster, set cover under the mismatch/LCS model,
identification, avoided genomes, the tolerant model and the coverage
analysis, with the same flag names and the same 'basic' and 'large'
defaults.  `--device` (default `cuda`) says where the kernels run; a
missing CUDA device is an error, never a quiet switch to the CPU.  Every
other flag of catch_tpu's CLI is refused with the ROADMAP item that
will bring it.

Run as ``python -m catch_tpu_torch.cli.design``, or with the 'large'
defaults as ``python -m catch_tpu_torch.cli.design_large``.
"""

import argparse
import logging
import os

from catch_tpu_torch import designer as probe_designer
from catch_tpu_torch.analysis import coverage as coverage_analysis
from catch_tpu_torch.device import resolve_device
from catch_tpu_torch.filters import base as filter_base
from catch_tpu_torch.filters.duplicate import DuplicateFilter
from catch_tpu_torch.filters.near_duplicate import (
    NearDuplicateFilterWithHammingDistance, NearDuplicateFilterWithMinHash)
from catch_tpu_torch.filters.set_cover_filter import SetCoverFilter
from catch_tpu_torch.utils import log, seq_io, version

_ARGS_TYPES = ("basic", "large")

# Flags of catch_tpu/cli/design.py that the port refuses, with where
# in ROADMAP.md queue 1 they come back.
_REFUSED = {
    ("--write-taxid-acc", "--ncbi-api-key"):
        "NCBI downloads need the network",
    ("--num-devices",): "ROADMAP queue 1, item 10",
    ("--custom-hybridization-fn", "--custom-hybridization-fn-tolerant",
     "--filter-from-fasta", "--skip-set-cover", "--add-adapters",
     "--adapter-a", "--adapter-b", "--filter-polya",
     "--add-reverse-complements", "--expand-n",
     "--limit-target-genomes-randomly-with-replacement"):
        "ROADMAP queue 1, item 12",
}


class _Refuse(argparse.Action):
    def __call__(self, parser, namespace, values, option_string=None):
        parser.error(f"{option_string} is not supported by catch_tpu_torch "
                     f"yet ({self.help})")


def main(args):
    """Run the design; returns the ProbeDesigner (its filters hold the
    run statistics)."""
    log.configure_logging(args.log_level)
    logger = logging.getLogger(__name__)
    device = resolve_device(args.device)

    if args.args_type == "large":
        logger.warning(
            "design_large relaxes several defaults (e.g. -m, -e) to "
            "favor runtime over probe count; see 'design_large --help' "
            "for the values, and pass any argument explicitly to "
            "override its relaxed default.")

    genomes_grouped = []
    genomes_grouped_names = []
    for ds in args.dataset:
        if not os.path.isfile(ds):
            raise ValueError(
                f"Cannot interpret dataset {ds!r}: catch_tpu_torch reads "
                "FASTA files only ('download:' and 'collection:' inputs "
                "are not supported)")
        genomes_grouped.append(seq_io.read_genomes_from_fasta(ds))
        genomes_grouped_names.append(os.path.basename(ds))
    if args.limit_target_genomes:
        genomes_grouped = [genomes[:args.limit_target_genomes]
                           for genomes in genomes_grouped]

    if args.args_type != "large":
        total_input_size = sum(sum(g.size() for g in genomes)
                               for genomes in genomes_grouped)
        if ((len(args.dataset) > 1 and not args.identify)
                or total_input_size > 10000000):
            recommended = []
            if (not args.filter_with_lsh_hamming
                    and not args.filter_with_lsh_minhash):
                recommended.append("--filter-with-lsh-minhash 0.6")
            if not args.cluster_and_design_separately:
                recommended.append("--cluster-and-design-separately 0.15")
            if not args.cluster_from_fragments:
                recommended.append("--cluster-from-fragments 50000")
            rec_str = ""
            if recommended:
                rec_str = (" Suggested flags: "
                           + ", ".join("'" + x + "'" for x in recommended))
            logger.warning(
                "This is a large input; if runtime or memory become a "
                "problem, design_large (or the individual speed flags "
                "it enables) trades a slightly larger probe set for a "
                f"much cheaper design.{rec_str}")

    avoided_genomes_fasta = []
    for ag in args.avoid_genomes or ():
        if not os.path.isfile(ag):
            raise ValueError(
                f"--avoid-genomes entry {ag!r} is not an existing FASTA "
                "file (named dataset labels are not supported here)")
        avoided_genomes_fasta.append(ag)

    if not args.lcf_thres:
        args.lcf_thres = args.probe_length
    for name, val in (("PROBE_STRIDE", args.probe_stride),
                      ("LCF_THRES", args.lcf_thres),
                      ("ISLAND_OF_EXACT_MATCH",
                       args.island_of_exact_match)):
        if val > args.probe_length:
            logger.warning(
                "%s (%d) exceeds PROBE_LENGTH (%d); such settings are "
                "rarely what you want and their behavior is not "
                "well-defined", name, val, args.probe_length)
    if args.mismatches / args.probe_length > 0.15:
        logger.warning(
            "MISMATCHES (%d) is unusually high for PROBE_LENGTH (%d); "
            "expect a slower design and, in practice, weaker "
            "enrichment", args.mismatches, args.probe_length)

    if args.kmer_probe_map_k:
        if args.kmer_probe_map_k > args.probe_length:
            raise Exception(
                "KMER_PROBE_MAP_K (%d) cannot exceed PROBE_LENGTH (%d)"
                % (args.kmer_probe_map_k, args.probe_length))
        kmer_probe_map_k = args.kmer_probe_map_k
        kmer_probe_map_k_analyzer = args.kmer_probe_map_k
    else:
        kmer_probe_map_k = 20
        kmer_probe_map_k_analyzer = 10

    if args.small_seq_skip is not None and args.small_seq_min is not None:
        raise Exception(
            "--small-seq-skip and --small-seq-min are mutually "
            "exclusive")

    if args.cluster_and_design_separately and args.identify:
        raise Exception(
            "--identify needs the per-dataset genome groupings, which "
            "--cluster-and-design-separately collapses; the two cannot "
            "be combined")
    if args.cluster_from_fragments and \
            not args.cluster_and_design_separately:
        raise Exception(
            "--cluster-from-fragments only applies when "
            "--cluster-and-design-separately is set")

    if (args.filter_with_lsh_hamming is not None
            and args.filter_with_lsh_minhash is not None):
        raise Exception("--filter-with-lsh-hamming and "
                        "--filter-with-lsh-minhash are mutually "
                        "exclusive")
    if args.filter_with_lsh_hamming is not None:
        if args.filter_with_lsh_hamming > args.mismatches:
            logger.warning(
                "FILTER_WITH_LSH_HAMMING (%d) above MISMATCHES (%d) "
                "can collapse probes the model distinguishes, so the "
                "design may fall short of the requested coverage",
                args.filter_with_lsh_hamming, args.mismatches)
        dedup = NearDuplicateFilterWithHammingDistance(
            args.filter_with_lsh_hamming, args.probe_length, device=device)
    elif args.filter_with_lsh_minhash is not None:
        if args.mismatches < 3:
            logger.warning(
                "At MISMATCHES=%d (<= 2), MinHash near-duplicate "
                "collapsing (especially with a large threshold) can "
                "leave the design short of the requested coverage",
                args.mismatches)
        dedup = NearDuplicateFilterWithMinHash(
            args.filter_with_lsh_minhash, device=device)
    else:
        dedup = DuplicateFilter()

    if args.max_num_processes is not None:
        filter_base.set_max_num_processes_for_filter_over_groupings(
            args.max_num_processes)

    scf = SetCoverFilter(
        mismatches=args.mismatches, lcf_thres=args.lcf_thres,
        island_of_exact_match=args.island_of_exact_match,
        mismatches_tolerant=args.mismatches_tolerant,
        lcf_thres_tolerant=args.lcf_thres_tolerant,
        island_of_exact_match_tolerant=args.island_of_exact_match_tolerant,
        identify=args.identify, avoided_genomes=avoided_genomes_fasta,
        coverage=args.coverage, cover_extension=args.cover_extension,
        kmer_probe_map_k=kmer_probe_map_k,
        kmer_probe_map_use_native_dict=(
            args.use_native_dict_when_finding_tolerant_coverage),
        device=device)
    cluster_kw = {}
    if args.cluster_and_design_separately:
        # --skip-set-cover is refused (item 12), so the clusters merge
        # after the set cover.
        cluster_kw = dict(
            cluster_threshold=args.cluster_and_design_separately,
            cluster_merge_after=scf,
            cluster_method=args.cluster_and_design_separately_method,
            cluster_fragment_length=args.cluster_from_fragments)
    pb = probe_designer.ProbeDesigner(
        genomes_grouped, [dedup, scf],
        probe_length=args.probe_length, probe_stride=args.probe_stride,
        allow_small_seqs=args.small_seq_min,
        seq_length_to_skip=args.small_seq_skip, device=device,
        **cluster_kw)
    pb.design()

    seq_io.write_probe_fasta(pb.final_probes, args.output_probes)

    if (args.print_analysis or args.write_analysis_to_tsv
            or args.write_sliding_window_coverage
            or args.write_probe_map_counts_to_tsv):
        # --add-reverse-complements is refused (item 12), so the
        # analysis scans the forward strands, as catch_tpu does without
        # that flag.
        analyzer = coverage_analysis.Analyzer(
            pb.final_probes, args.mismatches, args.lcf_thres,
            genomes_grouped, genomes_grouped_names,
            island_of_exact_match=args.island_of_exact_match,
            cover_extension=args.cover_extension,
            kmer_probe_map_k=kmer_probe_map_k_analyzer, rc_too=False,
            device=device)
        analyzer.run()
        if args.write_analysis_to_tsv:
            analyzer.write_data_matrix_as_tsv(args.write_analysis_to_tsv)
        if args.write_sliding_window_coverage:
            analyzer.write_sliding_window_coverage(
                args.write_sliding_window_coverage)
        if args.write_probe_map_counts_to_tsv:
            analyzer.write_probe_map_counts(
                args.write_probe_map_counts_to_tsv)
        if args.print_analysis:
            analyzer.print_analysis()
    else:
        print(len(pb.final_probes))
    return pb


def init_and_parse_args(argv=None, args_type="basic"):
    """Parse command-line arguments with catch_tpu's 'basic' or 'large'
    defaults."""
    if args_type not in _ARGS_TYPES:
        raise ValueError(
            f"Argument type '{args_type}' is invalid; it must be one of "
            f"{_ARGS_TYPES}")
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)

    parser.add_argument("dataset", nargs="+",
        help="One or more target datasets (e.g., one per species), each "
             "a path to a FASTA file")
    parser.add_argument("-o", "--output-probes", required=True,
        help=("The file to which all final probes should be written "
              "(FASTA format)"))
    parser.add_argument("-pl", "--probe-length", type=int, default=100,
        help="Make probes be PROBE_LENGTH nt long")
    parser.add_argument("-ps", "--probe-stride", type=int, default=50,
        help=("Generate candidate probes from the input that are "
              "separated by PROBE_STRIDE nt"))
    parser.add_argument("-m", "--mismatches", type=int,
        default={"basic": 0, "large": 5}[args_type],
        help=("Allow for MISMATCHES mismatches when determining whether "
              "a probe covers a sequence"))
    parser.add_argument("-l", "--lcf-thres", type=int,
        help=("(Optional) Cover threshold: shared substring length with "
              "at most MISMATCHES mismatches; defaults to PROBE_LENGTH"))
    parser.add_argument("--island-of-exact-match", type=int, default=0,
        help=("(Optional) Require an exact match of at least this "
              "length for a probe to cover a sequence"))

    def check_coverage(val):
        fval = float(val)
        ival = int(fval)
        if 0 <= fval <= 1:
            return fval
        elif fval > 1 and fval == ival:
            return ival
        raise argparse.ArgumentTypeError(
            "%s is an invalid coverage value" % val)

    parser.add_argument("-c", "--coverage", type=check_coverage,
        default=1.0,
        help=("Fraction of each target genome to cover (float in "
              "[0,1]), or number of bp to cover (int > 1)"))
    parser.add_argument("-e", "--cover-extension", type=int,
        default={"basic": 0, "large": 50}[args_type],
        help="Extend coverage on each side of a probe by this many nt")
    parser.add_argument("-i", "--identify", dest="identify",
        action="store_true",
        help=("Design probes meant to identify a dataset against the "
              "others; coverage should generally be small"))
    parser.add_argument("--avoid-genomes", nargs="+",
        help=("One or more FASTA files of genomes to avoid (probes are "
              "penalized by how much they cover them)"))
    parser.add_argument("-mt", "--mismatches-tolerant", type=int,
        help="(Optional) More tolerant value for 'mismatches'")
    parser.add_argument("-lt", "--lcf-thres-tolerant", type=int,
        help="(Optional) More tolerant value for 'lcf_thres'")
    parser.add_argument("--island-of-exact-match-tolerant", type=int,
        default=0,
        help="(Optional) More tolerant value for 'island_of_exact_match'")
    parser.add_argument("--print-analysis", dest="print_analysis",
        action="store_true",
        help="Print analysis of the probe set's coverage")
    parser.add_argument("--write-analysis-to-tsv",
        help="(Optional) File for a TSV matrix of the coverage analysis")
    parser.add_argument("--write-sliding-window-coverage",
        help=("(Optional) File for average probe-set coverage within "
              "sliding windows of each target genome"))
    parser.add_argument("--write-probe-map-counts-to-tsv",
        help=("(Optional) File for a TSV of the number of sequences "
              "each probe maps to (not counting reverse complements)"))

    def check_cluster_and_design_separately(val):
        fval = float(val)
        if 0 < fval <= 0.5:
            return fval
        raise argparse.ArgumentTypeError(
            "%s is an invalid average nucleotide dissimilarity" % val)

    parser.add_argument("--cluster-and-design-separately",
        type=check_cluster_and_design_separately,
        default={"basic": None, "large": 0.15}[args_type],
        help=("(Optional) Cluster input sequences at this average "
              "nucleotide dissimilarity threshold (in (0,0.5]; ~0.15 "
              "recommended), design separately per cluster, and merge"))
    parser.add_argument("--cluster-and-design-separately-method",
        choices=["choose", "simple", "hierarchical"], default="choose",
        help=("(Optional) Clustering method: connected components "
              "('simple'), agglomerative ('hierarchical'), or a "
              "heuristic choice ('choose')"))
    parser.add_argument("--cluster-from-fragments", type=int,
        default={"basic": None, "large": 50000}[args_type],
        help=("(Optional) Break sequences into fragments of this length "
              "(~50000 recommended) and cluster the fragments; requires "
              "--cluster-and-design-separately"))
    parser.add_argument("--filter-with-lsh-hamming", type=int,
        help=("(Optional) Filter near-duplicate candidate probes via "
              "Hamming-distance LSH at this distance (commensurate with "
              "but not greater than MISMATCHES)"))

    def check_filter_with_lsh_minhash(val):
        fval = float(val)
        if 0.0 <= fval <= 1.0:
            return fval
        raise argparse.ArgumentTypeError(
            "%s is an invalid Jaccard distance" % val)

    parser.add_argument("--filter-with-lsh-minhash",
        type=check_filter_with_lsh_minhash,
        default={"basic": None, "large": 0.6}[args_type],
        help=("(Optional) Filter near-duplicate candidate probes via "
              "MinHash LSH at this maximum Jaccard distance (10-mers; "
              "values ~0.5-0.7 typical)"))
    parser.add_argument("--limit-target-genomes", type=int,
        help="(Optional) Use only the first N target genomes per dataset")
    parser.add_argument("--small-seq-skip", type=int,
        help=("(Optional) Do not create candidate probes from sequences "
              "of length <= SMALL_SEQ_SKIP"))
    parser.add_argument("--small-seq-min", type=int,
        help=("(Optional) Allow input sequences shorter than "
              "PROBE_LENGTH, down to this minimum length (the candidate "
              "probe equals the sequence)"))

    def check_max_num_processes(val):
        ival = int(val)
        if ival >= 1:
            return ival
        raise argparse.ArgumentTypeError(
            "MAX_NUM_PROCESSES must be an int >= 1")

    parser.add_argument("--max-num-processes",
        type=check_max_num_processes,
        help="(Optional) Cap on the threads that filter groups in parallel")
    parser.add_argument("--kmer-probe-map-k", type=int,
        help=("(Optional) Seed k-mer length for mapping candidate "
              "probes to target sequences (pigeonhole when possible, "
              "else this length)"))
    parser.add_argument("--use-native-dict-when-finding-tolerant-coverage",
        dest="use_native_dict_when_finding_tolerant_coverage",
        action="store_true",
        help=("Accepted for compatibility with the reference CLI; no "
              "shared-memory dict exists in this implementation"))
    parser.add_argument("--device", default="cuda",
        help=("Device of the kernels (scans, clustering, MinHash "
              "signatures): 'cuda' (or 'cuda:N') or 'cpu'"))
    parser.add_argument("--debug", dest="log_level",
        action="store_const", const=logging.DEBUG,
        default=logging.WARNING, help="Debug output")
    parser.add_argument("--verbose", dest="log_level",
        action="store_const", const=logging.INFO, help="Verbose output")
    parser.add_argument("-V", "--version", action="version",
        version=version.get_version())

    for flags, reason in _REFUSED.items():
        parser.add_argument(*flags, nargs="*", action=_Refuse,
                            help=f"not supported yet: {reason}")
    args = parser.parse_args(argv)
    args.args_type = args_type
    return args


def run():
    main(init_and_parse_args())


if __name__ == "__main__":
    run()
