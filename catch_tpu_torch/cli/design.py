#!/usr/bin/env python3
"""Design probes for genome capture on a GPU (main executable).

The port of catch_tpu/cli/design.py: datasets as FASTA files, candidate
tiling, the FASTA and poly(A) filters, duplicate or near-duplicate
removal (MinHash or Hamming LSH), MinHash clustering of the inputs with
a design per cluster, set cover under the mismatch/LCS model or a
custom hybridization function, identification, avoided genomes, the
tolerant model, adapters, N expansion, reverse complements, skipping
the set cover and the coverage analysis, with the same flag names and
the same 'basic' and 'large' defaults.  A dataset is a FASTA file or
`download:TAXID[-SEGMENT]`, fetched from NCBI (utils/ncbi_neighbors.py,
which needs the network), with `--write-taxid-acc` and
`--ncbi-api-key` as in catch_tpu.  `--device` (default `cuda`)
says where the kernels run; a missing CUDA device is an error, never a
quiet switch to the CPU.  `--num-devices` spreads the scans over a mesh
of that many devices; a mesh that cannot be built is an error too.
With CATCH_TPU_COORDINATOR or CATCH_TPU_MULTIHOST in the environment the
process joins a process group first (parallel/distributed.py), and the
mesh spans every rank's devices, `--num-devices` counting them all;
every rank reads (or downloads) its own datasets and writes its own
output, as catch_tpu's does.  The ranks must then hold the same groups
in the same order: a download's order follows PYTHONHASHSEED, so ranks
whose groups differ raise before any scan.

Run as ``python -m catch_tpu_torch.cli.design``, or with the 'large'
defaults as ``python -m catch_tpu_torch.cli.design_large``.
"""

import argparse
import hashlib
import logging
import os
import random

from catch_tpu_torch import designer as probe_designer
from catch_tpu_torch.analysis import coverage as coverage_analysis
from catch_tpu_torch.device import resolve_device
from catch_tpu_torch.filters import base as filter_base
from catch_tpu_torch.filters.adapter import AdapterFilter
from catch_tpu_torch.filters.duplicate import DuplicateFilter
from catch_tpu_torch.filters.fasta import FastaFilter
from catch_tpu_torch.filters.n_expansion import NExpansionFilter
from catch_tpu_torch.filters.near_duplicate import (
    NearDuplicateFilterWithHammingDistance, NearDuplicateFilterWithMinHash)
from catch_tpu_torch.filters.polya import PolyAFilter
from catch_tpu_torch.filters.reverse_complement import ReverseComplementFilter
from catch_tpu_torch.filters.set_cover_filter import SetCoverFilter
from catch_tpu_torch.genome import Genome
from catch_tpu_torch.parallel import distributed
from catch_tpu_torch.parallel import mesh as device_mesh
from catch_tpu_torch.utils import log, ncbi_neighbors, seq_io, version

_ARGS_TYPES = ("basic", "large")


def _read_dataset(path):
    """One genome a record of the FASTA at `path`, and the records'
    names."""
    fasta = seq_io.read_fasta(path)
    return [Genome.from_one_seq(seq) for seq in fasta.values()], list(fasta)


def _check_groups_agree(group_names, records_grouped):
    """Raise on every rank of a process group unless all ranks read the
    same records, in the same order, into every group.

    Each rank reads its own datasets; a `download:` dataset comes in the
    order of a set of accessions, which follows PYTHONHASHSEED.  Ranks
    that design different instances would wait forever in a collective,
    so this runs before any scan."""
    digests = [hashlib.sha256("\n".join(records).encode()).hexdigest()
               for records in records_grouped]
    every = distributed.all_gather_object(digests)
    differ = [name for i, name in enumerate(group_names)
              if any(rank[i] != digests[i] for rank in every)]
    if differ:
        raise ValueError(
            f"The ranks of the process group read the groups {differ} "
            "with different records, or in a different order; a "
            "'download:' dataset's order follows PYTHONHASHSEED, so give "
            "every rank the same PYTHONHASHSEED")


def main(args):
    """Run the design; returns the ProbeDesigner (its filters hold the
    run statistics)."""
    log.configure_logging(args.log_level)
    logger = logging.getLogger(__name__)
    distributed.maybe_initialize()
    device = resolve_device(args.device)

    if args.args_type == "large":
        logger.warning(
            "design_large relaxes several defaults (e.g. -m, -e) to "
            "favor runtime over probe count; see 'design_large --help' "
            "for the values, and pass any argument explicitly to "
            "override its relaxed default.")

    if args.ncbi_api_key:
        ncbi_neighbors.ncbi_api_key = args.ncbi_api_key

    # Load one genome group per dataset argument: either a FASTA path
    # or 'download:TAXID[-SEGMENT]' fetched from NCBI.
    genomes_grouped = []
    genomes_grouped_names = []
    records_grouped = []
    for ds in args.dataset:
        if ds.startswith("collection:"):
            raise ValueError(
                "'collection:' inputs are not supported here; give each "
                "dataset as a FASTA path or as 'download:taxid'.")
        elif ds.startswith("download:"):
            taxid = ds[len("download:"):]
            taxid_fn = (os.path.join(args.write_taxid_acc,
                                     str(taxid) + ".txt")
                        if args.write_taxid_acc else None)
            taxid, _, segment = taxid.partition("-")
            ds_fasta_tf = ncbi_neighbors.construct_fasta_for_taxid(
                taxid, segment=segment or None, write_to=taxid_fn)
            genomes, records = _read_dataset(ds_fasta_tf.name)
            genomes_grouped_names.append("taxid:" + str(taxid))
            ds_fasta_tf.close()
        elif os.path.isfile(ds):
            genomes, records = _read_dataset(ds)
            genomes_grouped_names.append(os.path.basename(ds))
        else:
            raise ValueError(
                f"Cannot interpret dataset {ds!r}: it is neither an "
                "existing FASTA file nor a 'download:taxid' spec "
                "(named dataset labels are not supported). If it was "
                "meant to be a FASTA path, check that the path exists.")
        genomes_grouped.append(genomes)
        records_grouped.append(records)
    if distributed.is_initialized():
        _check_groups_agree(genomes_grouped_names, records_grouped)

    if (args.limit_target_genomes and
            args.limit_target_genomes_randomly_with_replacement):
        raise Exception(
            "--limit-target-genomes and "
            "--limit-target-genomes-randomly-with-replacement are "
            "mutually exclusive")
    elif args.limit_target_genomes:
        genomes_grouped = [genomes[:args.limit_target_genomes]
                           for genomes in genomes_grouped]
    elif args.limit_target_genomes_randomly_with_replacement:
        k = args.limit_target_genomes_randomly_with_replacement
        genomes_grouped = [random.choices(genomes, k=k)
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
        if args.probe_length <= 20:
            logger.warning(
                "With a PROBE_LENGTH this small (%d), a small "
                "--kmer-probe-map-k makes the probe-to-target mapping "
                "more sensitive", args.probe_length)
        kmer_probe_map_k = 20
        kmer_probe_map_k_analyzer = 10

    if args.add_adapters:
        if not (args.adapter_a or args.adapter_b):
            logger.warning(
                "--add-adapters without --adapter-a/--adapter-b uses "
                "the built-in default adapter sequences")
    else:
        if args.adapter_a or args.adapter_b:
            raise Exception(
                "--adapter-a/--adapter-b have no effect unless "
                "--add-adapters is also given")

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

    custom_cover_range_fn = (tuple(args.custom_hybridization_fn)
                             if args.custom_hybridization_fn else None)
    custom_cover_range_tolerant_fn = (
        tuple(args.custom_hybridization_fn_tolerant)
        if args.custom_hybridization_fn_tolerant else None)

    # The ordered filter chain, as catch_tpu assembles it.
    filters = []
    if args.filter_from_fasta:
        filters.append(FastaFilter(args.filter_from_fasta,
                                   skip_reverse_complements=True))

    if args.filter_polya:
        polya_length, polya_mismatches = args.filter_polya
        if polya_length > args.probe_length:
            logger.warning(
                "The poly(A) run length to filter (%d) exceeds "
                "PROBE_LENGTH (%d); no probe can contain such a run",
                polya_length, args.probe_length)
        if polya_length < 10:
            logger.warning(
                "A poly(A) run length this short (%d) will drop many "
                "probes", polya_length)
        if polya_mismatches > 10:
            logger.warning(
                "Tolerating %d mismatches in poly(A) runs is "
                "aggressive and will drop many probes", polya_mismatches)
        filters.append(PolyAFilter(polya_length, polya_mismatches))

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
        filters.append(NearDuplicateFilterWithHammingDistance(
            args.filter_with_lsh_hamming, args.probe_length, device=device))
    elif args.filter_with_lsh_minhash is not None:
        if args.mismatches < 3:
            logger.warning(
                "At MISMATCHES=%d (<= 2), MinHash near-duplicate "
                "collapsing (especially with a large threshold) can "
                "leave the design short of the requested coverage",
                args.mismatches)
        filters.append(NearDuplicateFilterWithMinHash(
            args.filter_with_lsh_minhash, device=device))
    else:
        filters.append(DuplicateFilter())

    if args.max_num_processes is not None:
        filter_base.set_max_num_processes_for_filter_over_groupings(
            args.max_num_processes)

    # Device mesh: spread the scans over the visible devices of
    # --device's type when there is more than one, as catch_tpu does;
    # with a process group, every rank's devices.
    mesh = None
    n_dev = device_mesh.place_count(device)
    limit = args.num_devices if args.num_devices else n_dev
    if args.max_num_processes is not None:
        limit = min(limit, args.max_num_processes)
    n_use = min(n_dev, limit)
    if n_use > 1:
        mesh = device_mesh.make_mesh(n_use, device)
        logger.info("Spreading the scans across %d devices", n_use)

    scf = SetCoverFilter(
        mismatches=args.mismatches, lcf_thres=args.lcf_thres,
        island_of_exact_match=args.island_of_exact_match,
        mismatches_tolerant=args.mismatches_tolerant,
        lcf_thres_tolerant=args.lcf_thres_tolerant,
        island_of_exact_match_tolerant=args.island_of_exact_match_tolerant,
        custom_cover_range_fn=custom_cover_range_fn,
        custom_cover_range_tolerant_fn=custom_cover_range_tolerant_fn,
        identify=args.identify, avoided_genomes=avoided_genomes_fasta,
        coverage=args.coverage, cover_extension=args.cover_extension,
        kmer_probe_map_k=kmer_probe_map_k,
        kmer_probe_map_use_native_dict=(
            args.use_native_dict_when_finding_tolerant_coverage),
        device=device, mesh=mesh)
    filters.append(scf)

    if args.add_adapters:
        adapter_a = (tuple(args.adapter_a) if args.adapter_a
                     else ("ATACGCCATGCTGGGTCTCC", "CGTACTTGGGAGTCGGCCAT"))
        adapter_b = (tuple(args.adapter_b) if args.adapter_b
                     else ("AGGCCCTGGCTGCTGATATG", "GACCTTTTGGGACAGCGGTG"))
        filters.append(AdapterFilter(
            adapter_a, adapter_b, mismatches=args.mismatches,
            lcf_thres=args.lcf_thres,
            island_of_exact_match=args.island_of_exact_match,
            custom_cover_range_fn=custom_cover_range_fn,
            kmer_probe_map_k=kmer_probe_map_k, device=device))

    if args.expand_n is not None:
        filters.append(NExpansionFilter(
            limit_n_expansion_randomly=args.expand_n))

    if args.add_reverse_complements:
        filters.append(ReverseComplementFilter())

    if args.skip_set_cover:
        filter_before_scf = filters[filters.index(scf) - 1]
        filters.remove(scf)

    cluster_kw = {}
    if args.cluster_and_design_separately:
        cluster_kw = dict(
            cluster_threshold=args.cluster_and_design_separately,
            cluster_merge_after=(filter_before_scf if args.skip_set_cover
                                 else scf),
            cluster_method=args.cluster_and_design_separately_method,
            cluster_fragment_length=args.cluster_from_fragments)
    pb = probe_designer.ProbeDesigner(
        genomes_grouped, filters,
        probe_length=args.probe_length, probe_stride=args.probe_stride,
        allow_small_seqs=args.small_seq_min,
        seq_length_to_skip=args.small_seq_skip, device=device,
        **cluster_kw)
    pb.design()

    seq_io.write_probe_fasta(pb.final_probes, args.output_probes)

    if (args.print_analysis or args.write_analysis_to_tsv
            or args.write_sliding_window_coverage
            or args.write_probe_map_counts_to_tsv):
        analyzer = coverage_analysis.Analyzer(
            pb.final_probes, args.mismatches, args.lcf_thres,
            genomes_grouped, genomes_grouped_names,
            island_of_exact_match=args.island_of_exact_match,
            custom_cover_range_fn=custom_cover_range_fn,
            cover_extension=args.cover_extension,
            kmer_probe_map_k=kmer_probe_map_k_analyzer,
            rc_too=args.add_reverse_complements, device=device)
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
        help=("One or more target datasets (e.g., one per species), "
              "each either 'download:TAXID' (NCBI download; "
              "'download:TAXID-SEGMENT' for segmented viruses) or a "
              "path to a FASTA file"))
    parser.add_argument("-o", "--output-probes", required=True,
        help=("The file to which all final probes should be written "
              "(FASTA format)"))
    parser.add_argument("--write-taxid-acc",
        help=("If 'download:' labels are used, write downloaded "
              "accessions to WRITE_TAXID_ACC/TAXID.txt"))
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
    parser.add_argument("--custom-hybridization-fn", nargs=2,
        help=("(Optional) Args: <PATH> <FUNC>; dynamically loaded "
              "custom hybridization model (6-argument contract; see the "
              "reference documentation), run on the host"))

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
    parser.add_argument("--custom-hybridization-fn-tolerant", nargs=2,
        help="(Optional) More tolerant custom hybridization model")
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
    parser.add_argument("--filter-from-fasta",
        help=("(Optional) Keep only candidate probes equal to sequences "
              "in this FASTA (headers containing 'reverse complement' "
              "are ignored); useful with --skip-set-cover"))
    parser.add_argument("--skip-set-cover", dest="skip_set_cover",
        action="store_true",
        help="Skip the set cover filter")
    parser.add_argument("--add-adapters", dest="add_adapters",
        action="store_true",
        help=("Add adapters to the ends of probes; to specify adapter "
              "sequences, use --adapter-a and --adapter-b"))
    parser.add_argument("--adapter-a", nargs=2,
        help="(Optional) Args: <X> <Y>; custom A adapter (5'/3' ends)")
    parser.add_argument("--adapter-b", nargs=2,
        help="(Optional) Args: <X> <Y>; custom B adapter (5'/3' ends)")
    parser.add_argument("--filter-polya", nargs=2, type=int,
        help=("(Optional) Args: <X> <Y>; drop probes containing X or "
              "more 'A' bases tolerating up to Y mismatches (likewise "
              "'T')"))
    parser.add_argument("--add-reverse-complements",
        dest="add_reverse_complements", action="store_true",
        help="Add to the output the reverse complement of each probe")
    parser.add_argument("--expand-n", nargs="?", type=int, default=None,
        const=3,
        help=("Expand 'N' bases into real bases; optional INT limits the "
              "number expanded (default 3), the rest replaced randomly"))

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
    parser.add_argument(
        "--limit-target-genomes-randomly-with-replacement", type=int,
        help=("(Optional) Randomly select N target genomes per dataset "
              "with replacement"))
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
    parser.add_argument("--num-devices", type=int,
        help=("(Optional) Spread the scans over a mesh of at most this "
              "many devices, --device first (default: all that are "
              "visible, on every rank of a process group; also capped "
              "by --max-num-processes)"))
    parser.add_argument("--kmer-probe-map-k", type=int,
        help=("(Optional) Seed k-mer length for mapping candidate "
              "probes to target sequences (pigeonhole when possible, "
              "else this length)"))
    parser.add_argument("--use-native-dict-when-finding-tolerant-coverage",
        dest="use_native_dict_when_finding_tolerant_coverage",
        action="store_true",
        help=("Accepted for compatibility with the reference CLI; no "
              "shared-memory dict exists in this implementation"))
    parser.add_argument("--ncbi-api-key",
        help=("API key to use for NCBI e-utils (increases the limit on "
              "requests/second)"))
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

    args = parser.parse_args(argv)
    args.args_type = args_type
    return args


def run():
    main(init_and_parse_args())


if __name__ == "__main__":
    run()
