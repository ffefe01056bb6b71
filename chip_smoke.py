#!/usr/bin/env python3
"""Smoke run of catch_tpu_torch's design, span, design_large, solver, mesh,
trace, pool, process-group and NCBI download paths on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. the card (nvidia-smi name and power limit), torch, CUDA, nvcc and
     triton versions;
  2. the build of the CUDA kernels from catch_tpu_torch/csrc/;
  3. the six design-scan kernels (build_table, stage T's seed table, and
     pack_merged, the readback, among them) against their plain-PyTorch
     twins on the card, on the inputs the ebola175 design gives them:
     outputs must be exactly equal; the median, min and max times of
     both from CUDA events; stage T's peak device memory; the raw hit
     count beside the pairs, lookup_expand's
     time split step by step, verify_windows' (the mask kernel, the
     cumsum and its read, the emit kernel) with stage C's peak device
     memory above its inputs, segmented_merge's for both calls of stage
     D (the pair merge and the union) with the buckets each tier took,
     and stage D's peak device memory above its inputs;
  4. ebola5 (-pl 100 -m 0 -e 0) through catch_tpu_torch.cli.design on
     cuda; the probe set must equal tests/data/golden/ref_ebola5_m0.fasta;
  5. ebola175 (-pl 100 -m 2 -l 60 -e 50), the first 175 genomes of
     tests/data/zaire_ebolavirus.fasta.gz, through the same CLI on cuda,
     with every kernel's launch count set to 0 just before; the output
     must equal tests/data/golden/torch_ebola175_m2.fasta byte for byte,
     and the six design kernels must have launched;
  6. the two span-scan kernels, expand_join and verify_spans, against
     their twins on the inputs of their three callers (span_shapes): the
     first batch (75 Mbp, both strands) of phase 8's avoid scan, phase
     9's analysis (w = 1) and one adapter vote of phase 24 (i) (the
     first ebola175 genome against torch_ebola175_m2.fasta's probes):
     exactly equal; CUDA-event medians, min and max (the avoid batch's
     in the JSON line);
  7. the identify and avoid goldens through catch_tpu_torch.cli.design
     on cuda (ref_identify_m0.fasta, ref_avoid_m0.fasta);
  8. the avoid scan at real size (bench.py's avoid configuration): the
     ranks of the candidates of the first 8 ebola genomes (-pl 100
     -ps 50) against a 100 Mbp background with planted ebola pieces,
     under SetCoverFilter(mismatches=2, lcf_thres=60,
     cover_extension=50), counting launches; the ranks must equal
     tests/data/golden/avoid100m_ranks.tsv; the buckets each tier of
     segmented_merge took in each of its calls; the span kernels' calls,
     launches, summed CUDA-event ms and smallest, median and largest
     shapes (span_totals);
  9. catch_tpu_torch.cli.analyze_probe_coverage on ebola175 with the
     probes of torch_ebola175_m2.fasta (-m 2 -l 60 -e 50) on cuda,
     counting launches; both TSVs must equal their goldens; the span
     kernels' totals as in phase 8;
 10. design_large through catch_tpu_torch.cli.design_large on cuda, with
     its defaults, on the 2,000-genome influenza-like corpus
     (influenza_like_segments(n_genomes=2000, seed=0), 8 segment FASTAs,
     27,176,000 bp; greedy clustering), counting launches: the probe
     FASTA must equal tests/data/golden/flu2000_design_large.fasta byte
     for byte, and minhash_assign, minhash_caps, minhash_sig and the
     six design-scan kernels must have launched;
 11. the same on the 10,000-genome corpus of bench.py:107-127 (80,000
     sequences, 135,880,000 bp): the clusters must equal
     flu10k_clusters.tsv.gz and the FASTA flu10k_design_large.fasta; the
     run goes under torch.profiler (CUDA activity only), which gives the
     card's busy share and, from the trace, each MinHash entry point's
     kernel launches and summed device time beside its calls' smallest,
     median and largest shapes; the run keeps the inputs of the largest
     near-duplicate group's minhash_sig call, of the last full greedy
     wave, of the largest minhash_caps call and of the largest cluster's
     pack_merged call;
 12. the clustering step of design_large's defaults on the 51 Mbp scale
     corpus of bench.py:130-158 (2,700 mutated ebola genomes): 'choose'
     gives 'simple' (minhash_codes), and with fragments of 10,000 nt
     'hierarchical' (minhash_dists); both must equal their goldens;
     each clustering's MinHash calls, their summed CUDA-event time and
     their smallest, median and largest shapes;
 13. minhash_caps' four entry points, minhash_sig and pack_merged against
     their twins at those shapes (phase 11's group, wave, caps call and
     cluster, phase 12's fragments and the first FLU_ALL_PAIRS (4,096)
     flu10k sequences): exactly equal, the float32 distances bit for
     bit; CUDA-event medians, min and max; the inputs are saved to
     build/chip_smoke/minhash_inputs.pt for tools/minhash_split.py;
 14. ebola175 m2 as in phase 5 with CATCH_TPU_SOLVE=device (stage E and
     the greedy steps on the card), counting launches: the FASTA must
     equal torch_ebola175_m2.fasta byte for byte, and assemble,
     init_covered, greedy_v2 and the scan's kernels must have launched,
     and pack_merged (the host route's readback) not; the peak
     allocated device memory before stage E (stage D's) beside the peak
     after it, which stage E must not raise;
     then phase 7's identify and avoid goldens again under the variable
     (rank tiers on the card);
 15. bench.py's solver instance (bench.py:178-198: 100,000 sets, 128
     universes of 8,192, 4 intervals a set, default_rng(5)), built by the
     port's build_instance_from_cover_arrays, solved by the host lazy
     solver, solve_boundary_instance (K10-K12), solve_instance(
     force_device=True) and _solve_device (K13), counting launches: the
     four pick orders must be equal; each is timed;
 16. assemble and init_covered on phase 15's instance (printed, not in
     the JSON line), then on phase 14's instance, greedy_v2 on one
     64-step dispatch from its initial state, greedy_v1 on one of phase
     15's instance, and greedy_v2 on one of phase 15's instance (printed,
     not in the JSON line), against their twins: exactly equal, the
     whole state included; CUDA-event medians, min and max; greedy_v2's
     and greedy_v1's bounds the smaller of a full recompute every step
     and the incremental design's own bytes (incremental_work);
     greedy_v1's regrouping timed apart and its launches counted by
     torch.profiler: 3 a step.

 17. the device mesh, with CATCH_TPU_VIRTUAL_DEVICES=4 set for this
     process (four places on the one card; restored after): ebola175 m2
     as in phase 5 with --num-devices 4, on the host-solver route and
     then with CATCH_TPU_SOLVE=device, counting launches: both FASTAs
     must equal torch_ebola175_m2.fasta byte for byte, the candidates
     evaluated and the picks must equal phase 5's, rolling_hash,
     lookup_expand and verify_windows must have launched for every place
     (the counts by place must add up to the totals), and build_table
     (one table for every place) and dedup_pairs on the lead;
 18. the span scan on the mesh: phase 7's identify and avoid goldens
     with --num-devices 4, then phase 8's 100 Mbp avoid ranks through a
     SetCoverFilter(mesh=make_mesh(4)): equal to avoid100m_ranks.tsv,
     verify_spans_sharded launched and verify_spans not;
 19. the sharded solver: phase 15's solver instance and ebola175's host
     instance (read back in phase 17) through solve_instance_sharded and
     solve_instance(force_device=True, mesh=...) at 1, 2, 4 and 8 places:
     every pick order must equal the host lazy solver's (and so phase
     15's); each is timed;
 20. greedy_sharded on one 64-step dispatch of each instance at 4 places
     and verify_spans_sharded on phase 6's inputs at 4 places against
     their twins: exactly equal, every place's state included and all
     replicas equal; dedup_pairs on the pairs that the four places of
     phase 17's scan hand to the lead, against its twin and against one
     torch.unique of the packed keys (torch.unique over the (pair, 2)
     rows and its step split printed beside); CUDA-event medians, min
     and max.  greedy_sharded's bound is the smaller of a full recompute
     every step on every place and the incremental design's own bytes
     (k18_work), and its launches are counted by torch.profiler: at most
     4 a step at 4 places on the one card (fails above that).

 21. ebola175 m2 as in phase 5 with the scan's block constants
     (scan_instance._BLOCK_PAIR_KEYS, _BLOCK_POSITIONS) patched to 2^20:
     4 probe blocks and at least 3 corpus blocks; on the host solver's
     route, the device solver's, and the device solver's with the
     position-axis limit (set_cover._DEVICE_AXIS_LIMIT) patched below the
     axis, which takes the host route, and the device solver's with
     K12's piece limit (set_cover._K12_PIECE_LIMIT) patched below the
     instance's pieces, which takes the host route after stage E: each
     FASTA must equal torch_ebola175_m2.fasta byte for byte, the
     candidates and picks phase 5's; build_table must have launched
     once per probe block, rolling_hash, lookup_expand and
     verify_windows once per block pair, pack_merged only on the host
     routes, assemble only where stage E ran and greedy_v2 only on the
     device route;
 22. the splits at real size, scan only, at the unpatched limits:
     ebola175's candidates against ebola175 and 8 random genomes of
     272,000,000 bp (default_rng(11); past 2^31 positions, corpus
     blocks), and against 115,000 pieces of 1,000 bp of ebola175 at
     default_rng(12) offsets (P x nU past 2^31, probe blocks): the rows
     of the first 175 universes, re-keyed, must equal a scan of those
     universes alone; wall seconds, blocks, pairs and peak device
     memory;
 23. one random chromosome of 2,200,000,000 bp (default_rng(13)), past
     2^31 positions, so scanned in pieces, with an ebola175 genome
     planted across each piece edge, scan only, ebola175's candidates:
     near each edge the merged rows must equal a scan of the window
     edge +- 1,000,000 alone, and some must cross the edge; wall
     seconds, pieces, pairs and peak device memory.
 24. the host filters, custom functions and design_naively, each against
     a golden that catch_tpu made on the CPU
     (tests/data/golden/make_host_goldens.py): (i) ebola175 as in phase 5
     with --add-adapters --add-reverse-complements, with the launch
     counts set to 0 just before: the FASTA must equal
     ebola175_m2_adapters_rc.fasta byte for byte, the adapter votes
     must have launched expand_join and verify_spans (the design has no
     other span scan; their totals as in phase 8), and the forward
     probes without their adapters must be torch_ebola175_m2.fasta's;
     (ii) the same flags with
     --filter-from-fasta on (i)'s forward probes without adapters and
     --skip-set-cover: the same records as (i), and no design-scan
     kernel launched; (iii) ebola5 -pl 100 with --custom-hybridization-fn
     on CUSTOM_FN_SRC: equal to ebola5_custom_fn.fasta, and no kernel
     launched (the model routes to the host scan); (iv)
     catch_tpu_torch.cli.design_naively on ebola5 with -nrf 2 60 and with
     -dsf 2 60, --print-analysis, in a child process (naive_command): the
     output (probe count and table) must equal
     ebola5_naive_{nrf,dsf}_2_60.txt.  Wall seconds of each, and the
     filter and span phases of (i).
 25. (i) ebola175 m2 as in phase 14 (CATCH_TPU_SOLVE=device) without
     CATCH_TPU_PROFILE_DIR, then with it set to build/chip_smoke/traces/:
     the design, phase 9's analysis and the design again; every output
     must equal its golden, each of the four regions (scan_instance,
     set_cover_solve, cover_scan_join, cover_scan_verify) must have
     exactly one trace, the second design must add none, and the traces
     must hold the kernels of TRACE_KERNELS by their __global__ names,
     and a kernel for every launch made inside the region's span;
     each region's device busy share (device_busy) and the three
     designs' wall seconds.  (ii) catch_tpu_torch's cli/pool.py on the
     three cases of pool_cases() in child processes (pool_command): the
     TSVs must equal the goldens that
     tests/data/golden/make_pool_goldens.py made with catch_tpu; the
     numpy and scipy versions and each run's wall seconds.
 26. two ranks on the one card (catch_tpu_torch/parallel/distributed.py:
     a gloo group on 127.0.0.1, CATCH_TPU_VIRTUAL_DEVICES=2 in each, a
     mesh of 4 places across the processes; the card's compute mode is
     printed first, and an exclusive one fails): ebola175 m2 as in phase
     5, then phase 7's identify and avoid goldens, through
     catch_tpu_torch.cli.design with --num-devices 4 in both ranks, each
     rank writing its own output: every output must equal its golden
     (ebola175's byte for byte), verify_spans_sharded and the place
     kernels must have launched in each rank; then
     solve_instance_sharded across the ranks on ebola175's instance
     (phase 17's): the pick order must equal the host lazy solver's
     (phase 19's), with init_covered and greedy_sharded launched; and
     one 64-step greedy_sharded dispatch across the ranks from the
     start, against the twin across the ranks, every state exactly
     equal; its host-clock median, min and max of 5 beside phase 20's
     one-process time, and the exchanges between the ranks a step;
 27. ebola175 m2 named as download:186538, with the tests' fake NCBI
     (tests/torch_fake_ncbi.py) in place of urllib.request.urlopen (the
     first 175 fixture records as the taxid's neighbors table, efetch
     batches in the order asked): (i)
     catch_tpu_torch.cli.design with --write-taxid-acc and
     --ncbi-api-key on cuda, with every launch count set to 0 just
     before; its FASTA must equal the design of a FASTA of the records
     in the order served (the order of a set of accessions, so of
     PYTHONHASHSEED), the accession file the 175 accessions sorted, the
     URLs one neighbors request and efetch batches of 100 and 75, each
     with the key, and the six design kernels must have launched; (ii)
     catch_tpu_torch.cli.analyze_probe_coverage on download:186538 with
     torch_ebola175_m2.fasta's probes: its three TSVs must equal those
     of the served order's FASTA, the group's name aside.

Each phase prints its wall seconds as it ends.  The line before the
last is the card's name and power limit; the one before it a JSON
object with one entry per kernel entry point (times, launches on its
path, and the bound: bytes over 3.35 TB/s or operations over 67 T/s,
the H100's non-tensor 32-bit rate, whichever is larger); the last line
is {"ok": true, "device": {...}}.  Scratch files go under
build/chip_smoke/.
"""

import contextlib
import gzip
import json
import math
import os
import re
import statistics
import subprocess
import sys
import threading
import time
import urllib.parse
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "tests", "data", "zaire_ebolavirus.fasta.gz")
GOLDEN = os.path.join(ROOT, "tests", "data", "golden")
WORK = os.path.join(ROOT, "build", "chip_smoke")
REPLACES = {
    "build_table": "catch_tpu/ops/scan_instance.py:129",
    "rolling_hash": "catch_tpu/ops/scan_instance.py:174",
    "lookup_expand": "catch_tpu/ops/scan_instance.py:217",
    "dedup_pairs": "catch_tpu/ops/scan_instance.py:341",
    "verify_windows": "catch_tpu/ops/scan_instance.py:382",
    "segmented_merge": "catch_tpu/ops/scan_instance.py:537",
    "pack_merged": "catch_tpu/ops/scan_instance.py:611",
    "expand_join": "catch_tpu/ops/scan_sparse.py:192",
    "verify_spans": "catch_tpu/ops/scan_sparse.py:65",
    "minhash_dists": "catch_tpu/utils/cluster.py:85",
    "minhash_codes": "catch_tpu/utils/cluster.py:120",
    "minhash_caps": "catch_tpu/utils/cluster.py:238",
    "minhash_assign": "catch_tpu/utils/cluster.py:205",
    "minhash_sig": "catch_tpu/utils/lsh.py:257",
    "assemble": "catch_tpu/ops/scan_instance.py:712",
    "init_covered": "catch_tpu/ops/set_cover.py:661",
    "greedy_v2": "catch_tpu/ops/set_cover.py:836",
    "greedy_v1": "catch_tpu/ops/set_cover.py:630",
    "verify_spans_sharded": "catch_tpu/ops/scan_sparse.py:157",
    "greedy_sharded": "catch_tpu/parallel/set_cover.py:114",
}
SOURCES = {name: f"catch_tpu_torch/csrc/{name}.cu" for name in REPLACES}
SOURCES["build_table"] = "catch_tpu_torch/csrc/rolling_hash.cu"
for _name in ("verify_spans", "verify_spans_sharded"):
    SOURCES[_name] = "catch_tpu_torch/csrc/verify_windows.cu"
for _name in ("minhash_dists", "minhash_codes", "minhash_assign"):
    SOURCES[_name] = "catch_tpu_torch/csrc/minhash_caps.cu"
DESIGN_KERNELS = ["build_table", "rolling_hash", "lookup_expand",
                  "verify_windows", "segmented_merge", "pack_merged"]
SOLVER_KERNELS = ["assemble", "init_covered", "greedy_v2"]
PLACE_KERNELS = ["rolling_hash", "lookup_expand", "verify_windows"]
MESH_PLACES = 4

# bench.py's solver-throughput instance (bench.py:178-198).
SOLVER_N_SETS, SOLVER_N_UNIV, SOLVER_U_LEN = 100_000, 128, 8192

# Phase 13's second all-pairs check: the first this many flu10k
# signatures.  It was 8,192; a run of the whole script past 600 s of its
# 1,200 s limit cut it, as it repeats at a larger size what the check on
# phase 12's 5,400 fragments and phase 12 itself cover (its two twins
# take about 11 s a call at 8,192, a quarter of that at 4,096).
FLU_ALL_PAIRS = 4096

# Phase 24's custom hybridization function, written to a file and loaded
# by --custom-hybridization-fn (tests/data/golden/make_host_goldens.py
# writes the same file for catch_tpu's golden).
CUSTOM_FN_NAME = "covers_within_two"
CUSTOM_FN_SRC = '''"""A custom hybridization model for chip_smoke phase 24."""


def covers_within_two(probe_seq, sequence, kmer_start, kmer_end,
                      full_probe_len, full_sequence_len):
    """Covers the whole overlap when it is at least 60 nt long and holds
    at most 2 mismatches."""
    if len(sequence) < 60:
        return None
    mismatches = sum(a != b for a, b in zip(probe_seq, sequence))
    return (0, len(sequence)) if mismatches <= 2 else None
'''


def write_custom_fn():
    """Phase 24's custom function file; returns its path."""
    path = os.path.join(WORK, "custom_hybridization_fn.py")
    with open(path, "w") as f:
        f.write(CUSTOM_FN_SRC)
    return path


def naive_command(package, argv):
    """design_naively of `package` in a child process, with numpy's
    global generator seeded and PYTHONHASHSEED fixed: its redundancy
    test samples k-mers from that generator and takes one k-mer of a set
    of strings, whose order follows the string hash.  Returns (argv,
    environment) for subprocess.run in WORK, where the dataset is named
    by its file name alone (the analysis table prints the name)."""
    code = (f"import sys, numpy; from {package}.cli import design_naively"
            " as d; numpy.random.seed(0); "
            "d.main(d.init_and_parse_args(sys.argv[1:]))")
    env = dict(os.environ, PYTHONHASHSEED="0")
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in [env.get("PYTHONPATH")] if p])
    return [sys.executable, "-c", code] + list(argv), env


# Phase 25's pool cases: (golden TSV, the CLI's arguments around the
# output path).  The V-All slice is tests/test_pool.py TestVAllGrid's:
# every fifth dataset of the 296, the first 60, at their share of the
# published 350,000-probe budget.
VWAFR_COUNTS = os.path.join(ROOT, "tests", "data",
                            "num-probes.V-WAfr.201506.tsv")
VALL_COUNTS = os.path.join(ROOT, "tests", "data",
                           "num-probes.V-All.201606.tsv")
VALL_SLICE, VALL_DATASETS, VALL_BUDGET = 60, 296, 350_000


def vall_slice():
    """The V-All slice's probe-count table, the original rows of its 60
    datasets; returns (path, budget)."""
    with open(VALL_COUNTS) as f:
        head, *rows = f.readlines()
    names = sorted({r.split("\t", 1)[0] for r in rows})
    if len(names) != VALL_DATASETS:
        fail(f"{VALL_COUNTS} holds {len(names)} datasets, not "
             f"{VALL_DATASETS}")
    keep = set(names[::5][:VALL_SLICE])
    path = os.path.join(WORK, "num-probes.V-All.201606.slice60.tsv")
    with open(path, "w") as f:
        f.write(head)
        f.writelines(r for r in rows if r.split("\t", 1)[0] in keep)
    return path, VALL_BUDGET * VALL_SLICE // VALL_DATASETS


def pool_cases():
    """Phase 25's three pool CLI runs: (golden name, arguments before
    the output TSV, arguments after it)."""
    vall, budget = vall_slice()
    return [("pool_vwafr_90000_round_1_10.tsv", [VWAFR_COUNTS, "90000"],
             ["--round-params", "1", "10"]),
            ("pool_vwafr_90000_nd.tsv", [VWAFR_COUNTS, "90000"],
             ["--use-nd", "--loss-coeffs", "1", "0.01"]),
            ("pool_vall60.tsv", [vall, str(budget)], [])]


def pool_command(package, argv):
    """cli/pool.py of `package` in a child process, numpy's global
    generator seeded with 1 after the import: the search's initial guess
    draws from it.  Returns (argv, environment) for subprocess."""
    code = (f"import sys, numpy; from {package}.cli import pool; "
            "numpy.random.seed(1); pool.run()")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in [env.get("PYTHONPATH")] if p])
    return [sys.executable, "-c", code] + list(argv), env


# The H100's published rates (SXM, 700 W): device memory 3.35 TB/s, and
# 67 T operations/s outside the tensor cores, the rate used for these
# integer and compare kernels.
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12


def fail(msg):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def run(cmd):
    p = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    if p.returncode != 0:
        fail(f"{' '.join(cmd)} exited {p.returncode}: {p.stderr}")
    return p.stdout.strip()


def write_subset(n):
    """The first n records of the fixture as a FASTA file."""
    path = os.path.join(WORK, f"ebola{n}.fasta")
    recs = []
    with gzip.open(FIXTURE, "rt") as f:
        for line in f:
            if line.startswith(">"):
                if len(recs) == n:
                    break
                recs.append([line])
            else:
                recs[-1].append(line)
    with open(path, "w") as out:
        for r in recs:
            out.writelines(r)
    return path


AVOID_BG_BP = 100_000_000
AVOID_BG_CHROMS = 4


def write_background(path, frag_src):
    """The avoid benchmark's background FASTA (bench.py:292-312): 4 random
    chromosomes of 25 Mbp from numpy.random.default_rng(11), each with
    five 500 bp fragments of `frag_src` (the first ebola genome) planted
    at random places.  Written once; an existing file is kept."""
    import numpy as np

    if os.path.exists(path):
        return path
    rng = np.random.default_rng(11)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    per = AVOID_BG_BP // AVOID_BG_CHROMS
    with open(path + ".tmp", "w") as f:
        for c in range(AVOID_BG_CHROMS):
            chrom = bases[rng.integers(0, 4, size=per)]
            for _ in range(5):
                fs = int(rng.integers(0, len(frag_src) - 500))
                frag = np.frombuffer(frag_src[fs:fs + 500].encode(),
                                     dtype=np.uint8)
                at = int(rng.integers(0, per - 500))
                chrom[at:at + 500] = frag
            f.write(">bgchrom%d\n" % c)
            f.write(chrom.tobytes().decode())
            f.write("\n")
    os.replace(path + ".tmp", path)
    return path


def write_flu(n_genomes):
    """The influenza-like corpus of bench.py:107-127 at n_genomes: 8
    segment FASTAs from influenza_like_segments(seed=0), one dataset
    each.  Returns (paths, total bp)."""
    from catch_tpu_torch.utils.synthetic import (influenza_like_segments,
                                                 write_segment_fastas)

    segs, subtype_of = influenza_like_segments(n_genomes=n_genomes, seed=0)
    paths = write_segment_fastas(segs, subtype_of,
                                 os.path.join(WORK, f"flu{n_genomes}"))
    return paths, sum(s.size for s in segs)


SCALE_STRAINS, SCALE_COPIES_PER = 30, 90
SCALE_STRAIN_MUT, SCALE_COPY_MUT = 0.12, 0.005


def scale_seqs():
    """The 51 Mbp scale corpus of bench.py:130-158: 30 strains mutated
    12% from the first ebola genome, 90 copies of each mutated 0.5%
    further, from numpy.random.default_rng(0)."""
    import numpy as np

    from catch_tpu_torch.utils import seq_io

    base = np.frombuffer(seq_io.read_genomes_from_fasta(FIXTURE)[0]
                         .seqs[0].encode(), dtype=np.uint8)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    rng = np.random.default_rng(0)

    def mutate(seq, rate):
        out = seq.copy()
        m = np.flatnonzero(rng.random(len(out)) < rate)
        out[m] = bases[rng.integers(0, 4, size=len(m))]
        return out

    seqs = []
    for _ in range(SCALE_STRAINS):
        strain = mutate(base, SCALE_STRAIN_MUT)
        for _ in range(SCALE_COPIES_PER):
            seqs.append(mutate(strain, SCALE_COPY_MUT).tobytes().decode())
    return seqs


def read_cluster_ranks(path):
    """A cluster golden: one cluster rank per sequence."""
    with gzip.open(path, "rt") as f:
        return [int(line) for line in f]


def cluster_ranks(clusters, n):
    """Each sequence's cluster rank, clusters in the order given."""
    rank = [-1] * n
    for r, members in enumerate(clusters):
        for i in members:
            rank[i] = r
    return rank


def fasta_records(path):
    recs, header, seq = set(), None, []
    for line in open(path):
        line = line.strip()
        if line.startswith(">"):
            if header is not None:
                recs.add((header, "".join(seq)))
            header, seq = line, []
        else:
            seq.append(line)
    if header is not None:
        recs.add((header, "".join(seq)))
    return recs


def cuda_ms(torch, fn, reps, warm=True):
    """(median, min, max) milliseconds of fn() from CUDA events, after a
    warm-up call unless the caller has just made one."""
    if warm:
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times), min(times), max(times)


class Steps:
    """CUDA events between the named steps of one call (a K2 wrapper's
    `steps` argument)."""

    def __init__(self, torch):
        self.torch, self.marks = torch, []

    def mark(self, name):
        e = self.torch.cuda.Event(enable_timing=True)
        e.record()
        self.marks.append((name, e))

    def split(self):
        self.torch.cuda.synchronize()
        return {name: a.elapsed_time(b) for (_, a), (name, b)
                in zip(self.marks, self.marks[1:])}


def step_split(torch, fn, reps=10):
    """Median ms of each step of fn(steps) over reps calls after a
    warm-up, as one printable string."""
    fn(Steps(torch))
    splits = []
    for _ in range(reps):
        st = Steps(torch)
        fn(st)
        splits.append(st.split())
    return ", ".join(f"{k} {statistics.median(sp[k] for sp in splits):.4f}"
                     for k in splits[0])


def max_abs_err(torch, got, want):
    """Max |got - want| over tuples of tensors of equal shapes and types.
    A float32 pair that differs in any bit counts at least 1."""
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            fail(f"{g.dtype} {tuple(g.shape)} != {w.dtype} {tuple(w.shape)}")
        if not g.numel():
            continue
        if g.is_floating_point():
            err = max(err, float((g - w).abs().max()))
            if not torch.equal(g.view(torch.int32), w.view(torch.int32)):
                err = max(err, 1)
        else:
            err = max(err, int((g.to(torch.int64)
                                - w.to(torch.int64)).abs().max()))
    return err


def bound(work):
    """(bound ms, what bounds it) of (bytes moved, operations)."""
    nbytes, ops = work
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / OPS_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def ebola175_scan():
    """The ebola175 design's scan inputs (-pl 100 -m 2 -l 60): its
    searcher over the candidates, each searcher probe's candidate id,
    the sequences with their universes and chromosome offsets, and the
    number of candidates."""
    from catch_tpu_torch.filters.candidates import (
        make_candidate_probes_from_sequences)
    from catch_tpu_torch.filters.duplicate import DuplicateFilter
    from catch_tpu_torch.ops.cover import CoverModel, ProbeSearcher
    from catch_tpu_torch.utils import seq_io

    genomes = seq_io.read_genomes_from_fasta(write_subset(175))
    seqs = [s for g in genomes for s in g.seqs]
    probes = DuplicateFilter()._filter(make_candidate_probes_from_sequences(
        seqs, probe_length=100, probe_stride=50))
    searcher = ProbeSearcher(probes, CoverModel(2, 60))
    pid_of = {p: i for i, p in enumerate(probes)}
    pid = [pid_of[p] for p in searcher.probes]
    univ, off = [], []
    for j, g in enumerate(genomes):
        pos = 0
        for x in g.seqs:
            univ.append(j)
            off.append(pos)
            pos += len(x)
    return searcher, pid, seqs, univ, off, len(probes)


def kernel_inputs(torch, device):
    """The inputs each kernel gets in the ebola175 design."""
    from catch_tpu_torch.ops import scan_instance as si

    searcher, pid, seqs, univ, off, n_probes = ebola175_scan()
    nU = max(univ) + 1
    st, total, _ = si.prepare_corpus(searcher, seqs, univ, off, pid, device)
    kj, s = si.join_params_stride(searcher)
    K, k_seed = int(searcher.K_static), int(searcher.k_seed)
    return dict(searcher=searcher, st=st, total=total, kj=kj, s=s, K=K,
                k_seed=k_seed, nU=nU, n_probes=n_probes,
                corpus_bp=sum(len(x) for x in seqs))


def check_kernels(torch, device):
    """Phase 3: every kernel against its twin; returns the JSON rows."""
    from catch_tpu_torch.ops import scan_instance as si

    x = kernel_inputs(torch, device)
    st, kj, s, K, nU = x["st"], x["kj"], x["s"], x["K"], x["nU"]
    P, L = st["codes"].shape
    W = max(L - kj + 1, 0)
    n_samples = -(-x["total"] // s)
    print(f"ebola175 shapes: {x['n_probes']} candidate probes, {P} unique, "
          f"L={L}, corpus {x['corpus_bp']} bp in {x['total']} positions, "
          f"{n_samples} samples, kj={kj}, s={s}, K={K}", flush=True)

    def k1t(fn):
        return fn(st["codes"], kj)

    def k1(hash_fn):
        return hash_fn(st["mega"], n_samples, s, kj, x["total"] - kj)

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    table = k1t(si.build_table)
    torch.cuda.synchronize()
    n_ent = int(table[1].sum())
    print(f"build_table: {P} x {W} slots, {n_ent} entries; stage T's peak "
          f"{(torch.cuda.max_memory_allocated() - base) / 2**20:.1f} MiB "
          "above its inputs", flush=True)
    q = k1(si.rolling_hash)

    def k2(fn):
        return fn(*table, q, s)

    pc, ac = k2(si.lookup_expand)
    vargs = dict(K=K, k_seed=x["k_seed"], lcf=int(x["searcher"].lcf_static),
                 seed_req=x["k_seed"], fast_ok=bool(x["searcher"].fast_ok),
                 ext=50, nU=nU)
    vt = (st["mega"], st["codes"], st["lens"], pc, ac, st["seq_starts"],
          st["seq_ends"], st["seq_lens"], st["chrom_off"], st["univ_of_seq"])

    def k3(fn):
        return fn(*vt, **vargs)

    key, us, ue = k3(si.verify_windows)

    def k4(fn):
        mk, ms, me = fn(key, us, ue)
        return (mk, ms, me) + tuple(fn(mk % nU, ms, me))

    qs, h = torch.sort(q).values, si.table_entries(*table)[0]
    n_raw = int((torch.searchsorted(qs, h, right=True)
                 - torch.searchsorted(qs, h)).sum())
    del qs, h
    print(f"ebola175 shapes: {int(q.numel())} sample hashes, {n_raw} raw "
          f"hits, {int(pc.numel())} candidate pairs, {int(key.numel())} "
          "spans", flush=True)
    print("lookup_expand steps (ms, CUDA-event medians): " + step_split(
        torch, lambda st: si._lookup_expand_cuda(*table, q, s, 0, steps=st)),
          flush=True)
    print("verify_windows steps (ms, CUDA-event medians): " + step_split(
        torch, lambda st: si._verify_windows_cuda(*vt, steps=st, **vargs)),
          flush=True)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    k3(si.verify_windows)
    torch.cuda.synchronize()
    print("verify_windows: stage C's peak "
          f"{(torch.cuda.max_memory_allocated() - base) / 2**20:.1f} MiB "
          "above its inputs", flush=True)
    mk, ms, me = si._segmented_merge_plain(key, us, ue)
    for what, rows in (("pair merge", (key, us, ue)),
                       ("union", (mk % nU, ms, me))):
        print(f"segmented_merge steps, {what} (ms, CUDA-event medians): "
              + step_split(torch, lambda st, rows=rows:
                           si._segmented_merge_cuda(*rows, si.MERGE_TILE,
                                                    steps=st)), flush=True)
        print(f"segmented_merge tiers, {what}: {si.merge_tiers(*rows)}",
              flush=True)
    del mk, ms, me
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    k4(si.segmented_merge)
    torch.cuda.synchronize()
    print("segmented_merge: stage D's peak (both calls) "
          f"{(torch.cuda.max_memory_allocated() - base) / 2**20:.1f} MiB "
          "above its inputs", flush=True)
    # Bytes (each input read once, each output written once) and
    # operations each function needs on these inputs: K1 two operations
    # (a multiply-add) per code of each window, the table's row of W
    # slots of 8 bytes and a 4-byte count a probe; K2 the table, the
    # samples and 16 bytes a pair out, a binary search per entry among
    # the samples and a step per pair; K3 a compare per aligned probe
    # position; K4 a pass over each merge's input.
    n_q, n_pairs = q.numel(), pc.numel()
    merged = k4(si.segmented_merge)
    n_in, n_mid, n_out = key.numel(), merged[0].numel(), merged[3].numel()
    b_pos = si.pack_width(int((st["chrom_off"] + st["seq_lens"]).max()))
    return compare(torch, [
        ("build_table", k1t, si._build_table_plain, si.build_table, 20,
         (P * L + 8 * P * W + 4 * P, 2 * kj * P * W)),
        ("rolling_hash", k1, si._rolling_hash_plain, si.rolling_hash, 20,
         (x["total"] + 8 * n_samples, 2 * kj * n_samples)),
        ("lookup_expand", k2, si._lookup_expand_plain, si.lookup_expand, 10,
         (8 * P * W + 4 * P + 8 * n_q + 16 * n_pairs,
          n_ent * max(1, (n_q - 1).bit_length()) + n_pairs)),
        ("verify_windows", k3, si._verify_windows_plain, si.verify_windows,
         5, (x["total"] + st["codes"].numel() + 16 * n_pairs
             + 24 * key.numel(), n_pairs * L)),
        ("segmented_merge", k4, si._segmented_merge_plain,
         si.segmented_merge, 10,
         (24 * (n_in + 2 * n_mid + n_out), n_in + n_mid)),
        pack_case(si, merged[:3], b_pos, "ebola175"),
    ])


def pack_case(si, rows, b_pos, what):
    """The compare case of pack_merged on merged rows: K9 reads each row
    once (24 bytes) and writes 4 + b_pos bytes of it and 24 bytes per
    escape, with an operation per byte it writes."""
    n = rows[0].numel()
    n_esc = si._pack_merged_plain(*rows, b_pos)[1].numel()
    print(f"pack_merged shapes ({what}): {n} merged rows, b_pos={b_pos}, "
          f"{n_esc} escapes", flush=True)
    out_bytes = (4 + b_pos) * n + 24 * n_esc
    return ("pack_merged", lambda f: f(*rows, b_pos), si._pack_merged_plain,
            si.pack_merged, 20, (24 * n + out_bytes, out_bytes))


def compare(torch, cases, twin_reps=None):
    """Each kernel against its twin on the same inputs: exactly equal,
    then CUDA-event medians, min and max of both (the twin over
    twin_reps calls, by default half the kernel's and at least 2),
    beside the bound of the case's (bytes, operations); returns the
    JSON rows.  A case may end with a function of no arguments that
    computes the same result by one PyTorch call; it is held to the
    kernel's result and timed as library_ms, which is null where no
    single call computes the function."""
    rows = []
    for name, call, twin, kernel, reps, work, *library in cases:
        got, want = call(kernel), call(twin)
        torch.cuda.synchronize()
        err = max_abs_err(torch, got, want)
        if err != 0:
            fail(f"{name}: kernel differs from its twin (max abs err {err})")
        ms_lib = None
        if library:
            if max_abs_err(torch, library[0](), got) != 0:
                fail(f"{name}: the library call differs from the kernel")
            ms_lib = cuda_ms(torch, library[0], max(2, reps // 2))[0]
            print(f"{name}: one PyTorch call {ms_lib:.3f} ms", flush=True)
        ms_k, lo_k, hi_k = cuda_ms(torch, lambda: call(kernel), reps)
        # the equality check just called the twin: with twin_reps given
        # that call is its warm-up
        ms_t, lo_t, hi_t = cuda_ms(torch, lambda: call(twin),
                                   twin_reps or max(2, reps // 2),
                                   warm=twin_reps is None)
        bound_ms, bound_by = bound(work)
        print(f"{name}: equal to twin; kernel {ms_k:.3f} ms "
              f"[{lo_k:.3f}, {hi_k:.3f}], twin {ms_t:.3f} ms "
              f"[{lo_t:.3f}, {hi_t:.3f}]; bound {bound_ms:.4f} ms "
              f"({bound_by}: {work[0]} bytes, {work[1]} operations)",
              flush=True)
        rows.append(dict(name=name, route="cuda",
                         source=SOURCES[name],
                         replaces=REPLACES[name], launches=None,
                         max_abs_err=err, ms=ms_k, ms_min=lo_k, ms_max=hi_k,
                         plain_ms=ms_t, plain_ms_min=lo_t, plain_ms_max=hi_t,
                         bound_ms=bound_ms, bound_by=bound_by,
                         library_ms=ms_lib))
    return rows


def span_shapes(device, scf, cands, bg):
    """(name, searcher, strands) of the span scan's three callers: the
    avoid scan's first batch, the ebola175 analysis (kmer_probe_map_k
    10: w = 1; every genome, both strands) and one adapter vote (the
    first ebola175 genome, one strand); the last two against
    torch_ebola175_m2.fasta's probes (-m 2 -l 60)."""
    from catch_tpu_torch.filters.set_cover_filter import _reverse_complement
    from catch_tpu_torch.ops.cover import CoverModel, ProbeSearcher
    from catch_tpu_torch.probe import Probe
    from catch_tpu_torch.utils import seq_io

    batch, batch_bp = [], 0
    for seq in seq_io.iterate_fasta(bg):
        batch.append(seq)
        batch_bp += len(seq)
        if batch_bp >= scf._AVOID_BATCH_BP:
            break
    yield "avoid batch 1", ProbeSearcher(
        cands, scf.tolerant_model, kmer_probe_map_k=scf.kmer_probe_map_k,
        device=device), batch + [_reverse_complement(x) for x in batch]
    del batch
    probes = [Probe.from_str(x) for x in seq_io.read_fasta(os.path.join(
        GOLDEN, "torch_ebola175_m2.fasta")).values()]
    genomes = seq_io.read_genomes_from_fasta(write_subset(175))
    strands = []
    for g in genomes:
        strands += list(g.seqs) + [_reverse_complement(x) for x in g.seqs]
    yield "analysis", ProbeSearcher(probes, CoverModel(2, 60),
                                    kmer_probe_map_k=10,
                                    device=device), strands
    yield "adapter vote", ProbeSearcher(probes, CoverModel(2, 60),
                                        kmer_probe_map_k=20,
                                        device=device), [genomes[0].seqs[0]]


def spans_work(n_mega, n_codes, L, cand, n_spans):
    """(bytes, operations) that verify_spans needs on these candidates:
    the corpus bytes under their bands (each band read once, at most the
    whole corpus), the probe rows, 48 bytes a candidate in and 24 a span
    out; a compare a band position.  A candidate's band is [poff0, poff0
    + ov) clamped to the probe row, as csrc/verify_windows.cu's VsParams
    takes it."""
    lo = cand[2].clamp(0, L)
    band = int(((cand[2] + cand[3]).clamp(max=L) - lo).clamp(min=0).sum())
    return (min(n_mega, band) + n_codes + 48 * cand[0].numel()
            + 24 * n_spans, band)


def check_span_kernels(torch, device, scf, cands, bg):
    """Phase 6: expand_join and verify_spans against their twins on the
    inputs of each of span_shapes; returns the JSON rows (the avoid
    batch's) and phase 20's inputs (the avoid batch's candidates)."""
    import numpy as np

    from catch_tpu_torch.ops import scan_sparse as ss

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    rows, kept = None, None
    for what, searcher, strands in span_shapes(device, scf, cands, bg):
        t0 = time.time()
        mega, starts, ends, total = ss.corpus_codes(searcher, strands)
        lo, cnt, pos = ss.join_runs(searcher, mega[:total])
        host_s = time.time() - t0
        if int(cnt.sum()) > ss._EXPAND_SLAB:
            fail(f"{what}: the span scan needs more than one expansion slab")
        lo_t, cnt_t, pos_t = put(lo), put(cnt), put(pos)
        tb = ss.device_tables(searcher, device)
        lmax = int(searcher.Lmax)
        keep = ss.keep_args(searcher, put(starts), put(ends))

        # the scan's call: the keep predicate folded into K5
        def k5(fn, lo_t=lo_t, cnt_t=cnt_t, pos_t=pos_t, tb=tb, lmax=lmax,
               keep=keep):
            return fn(lo_t, cnt_t, pos_t, tb["join_p"], tb["join_pos"], lmax,
                      keep)

        def kernel5(*args, tb=tb):
            return ss.expand_join(*args[:6], tb["index"], args[6])

        def twin5(*args):
            return ss._keep_plain(*ss._expand_join_plain(*args[:6]),
                                  **args[6])

        n_pairs = ss.expand_join(lo_t, cnt_t, pos_t, tb["join_p"],
                                 tb["join_pos"], lmax, tb["index"])[0].numel()
        cand = k5(kernel5)
        mega_t, codes_t = put(mega), tb["codes"]
        vargs = ss.verify_args(searcher)

        def k6(fn, mega_t=mega_t, codes_t=codes_t, cand=cand, vargs=vargs):
            return fn(mega_t, codes_t, *cand, **vargs)

        n_cand, n_spans = cand[0].numel(), k6(ss.verify_spans)[0].numel()
        print(f"{what} shapes: {len(strands)} strands, {total} corpus "
              f"positions, {searcher.probe_codes.shape[0]} unique probes, "
              f"join (kj, w) = {searcher._join_kw}, "
              f"{len(searcher._join_h)} table rows; {len(lo)} runs, "
              f"{int(cnt.sum())} hits, {n_pairs} pairs, {n_cand} "
              f"kept, {n_spans} spans; host join {host_s:.2f} s",
              flush=True)
        # K5 reads the runs, the table and the sequence bounds and writes
        # 48 bytes a kept candidate, with an operation a raw hit; K6 as
        # spans_work counts.
        out = compare(torch, [
            ("expand_join", k5, twin5, kernel5, 10,
             (24 * len(lo) + 16 * tb["join_p"].numel() + 16 * len(starts)
              + 48 * n_cand, int(cnt.sum()))),
            ("verify_spans", k6, ss._verify_spans_plain, ss.verify_spans,
             10, spans_work(mega_t.numel(), codes_t.numel(),
                            codes_t.shape[1], cand, n_spans)),
        ])
        if rows is None:
            rows = out
            # phase 20 verifies the same candidates over four places; they
            # wait on the host meanwhile
            kept = dict(mega=mega, codes=searcher.probe_codes,
                        cand=[x.cpu() for x in cand], vargs=vargs,
                        n_spans=n_spans)
        del lo_t, cnt_t, pos_t, mega_t, cand
    return kept, rows


# The span kernels' entry points, whose real totals phases 8, 9 and 24
# (i) print.
SPAN_ENTRIES = ("expand_join", "verify_spans")


@contextlib.contextmanager
def span_calls(torch, log):
    """scan_sparse's span kernel wrappers wrapped so that each call
    appends (name, its input size, its output size, events) to log:
    expand_join's cnt (a tensor, read afterwards) and its pairs (or kept
    candidates, where the keep predicate is folded in), verify_spans'
    candidates and spans; two CUDA events on the current stream bracket
    the call.  A wrapper counts its launches on the name it has in the
    module, which is the wrapped function for a while: each call hands
    them on to the wrapper itself."""
    from catch_tpu_torch.ops import scan_sparse as ss
    saved = {n: getattr(ss, n) for n in SPAN_ENTRIES}

    def wrap(name, fn):
        def wrapped(*args, **kwargs):
            ev = tuple(torch.cuda.Event(enable_timing=True)
                       for _ in range(2))
            ev[0].record()
            out = fn(*args, **kwargs)
            ev[1].record()
            fn.launches += wrapped.launches
            wrapped.launches = 0
            size = out[0].numel()
            if name == "expand_join":
                size = (size, "kept" if len(out) == 6 else "pairs")
            log.append((name, args[1] if name == "expand_join" else
                        args[2].numel(), size, ev))
            return out
        wrapped.launches = 0
        return wrapped

    for n, fn in saved.items():
        setattr(ss, n, wrap(n, fn))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(ss, n, fn)


def span_totals(what, log, launches):
    """Print, for each span kernel called in `log` (span_calls), its
    calls, its launches, the calls' summed CUDA-event ms and its
    smallest, median and largest call: (runs, raw hits, its output and
    whether those are pairs or kept candidates) of expand_join by hits,
    (candidates, spans) of verify_spans by candidates.  Returns {entry
    point: (calls, launches, summed ms)}."""
    out = {}
    for name in SPAN_ENTRIES:
        calls = []
        for n, x, y, (a, b) in log:
            if n != name:
                continue
            shape = ((x.numel(), int(x.sum())) + y if name == "expand_join"
                     else (x, y))
            calls.append((shape, a.elapsed_time(b)))
        if not calls:
            continue
        calls.sort(key=lambda c: c[0][1] if name == "expand_join"
                   else c[0][0])
        ms = sum(t for _, t in calls)
        labels = ("runs, raw hits, out" if name == "expand_join"
                  else "candidates, spans")
        print(f"{what}: {name}: {len(calls)} calls, {launches[name]} "
              f"launches, {ms:.4f} ms summed over the calls' CUDA events; "
              f"shapes ({labels}) smallest {calls[0][0]}, median "
              f"{calls[len(calls) // 2][0]}, largest {calls[-1][0]}",
              flush=True)
        out[name] = (len(calls), launches[name], ms)
    return out


def avoid_setup(device):
    """The avoid configuration of bench.py:266-331: the candidates of
    the first 8 ebola genomes, the filter, and the background FASTA."""
    from catch_tpu_torch.filters.candidates import (
        make_candidate_probes_from_sequences)
    from catch_tpu_torch.filters.duplicate import DuplicateFilter
    from catch_tpu_torch.filters.set_cover_filter import SetCoverFilter
    from catch_tpu_torch.utils import seq_io

    genomes = seq_io.read_genomes_from_fasta(write_subset(8))
    t0 = time.time()
    bg = write_background(os.path.join(WORK, "background_100mbp.fasta"),
                          genomes[0].seqs[0])
    print(f"background: {AVOID_BG_BP} bp in {AVOID_BG_CHROMS} chromosomes "
          f"({time.time() - t0:.1f} s to write)", flush=True)
    cands = DuplicateFilter()._filter(make_candidate_probes_from_sequences(
        [s for g in genomes for s in g.seqs], probe_length=100,
        probe_stride=50))
    scf = SetCoverFilter(mismatches=2, lcf_thres=60, cover_extension=50,
                         avoided_genomes=[bg], device=device)
    return genomes, cands, scf, bg


def expected_ranks(n_cands):
    """The ranks of avoid100m_ranks.tsv (made by catch_tpu on the CPU):
    (1, avoided bp) for each listed candidate, (0, 0) for the others,
    densified as SetCoverFilter._make_ranks does."""
    import numpy as np

    path = os.path.join(GOLDEN, "avoid100m_ranks.tsv")
    with open(path) as f:
        head = f.readline()
        if int(head.split()[1]) != n_cands:
            fail(f"{path} is for another candidate set: {head.strip()}")
        flagged = dict(tuple(map(int, line.split())) for line in f)
    vals = [(1, flagged[i]) if i in flagged else (0, 0)
            for i in range(n_cands)]
    idx = {t: i for i, t in enumerate(sorted(set(vals)))}
    return np.array([idx[t] for t in vals], dtype=np.int64), len(flagged)


def counted(torch, si, profiling, fn):
    """Run fn with every launch count and phase set to 0 just before;
    returns (fn's result, wall seconds, launches, peak device bytes)."""
    profiling.reset_phases()
    si.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {name: f.launches for name, f in si.KERNELS.items()}
    return out, wall, launches, torch.cuda.max_memory_allocated()


def print_phases(profiling, prefixes):
    for k, v in sorted(profiling.phase_seconds.items()):
        if k.startswith(prefixes):
            print(f"  phase {k}: {v:.4f} s", flush=True)


def require_launched(launches, names, what):
    for name in names:
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched by {what}")


class PhaseClock:
    """Prints each chip_smoke phase's wall seconds as it ends."""

    def __init__(self):
        self.t0 = time.time()

    def done(self, n):
        now = time.time()
        print(f"chip_smoke phase {n}: {now - self.t0:.1f} s", flush=True)
        self.t0 = now


def ebola175_analysis(in175):
    """Phases 9 and 25: catch_tpu_torch.cli.analyze_probe_coverage on
    ebola175 with torch_ebola175_m2.fasta's probes on cuda; both TSVs
    must equal their goldens."""
    from catch_tpu_torch.cli import analyze_probe_coverage as analyze
    tsv = {k: os.path.join(WORK, f"ebola175_m2_{k}.tsv")
           for k in ("analysis", "probe_map_counts")}
    analyze.main(analyze.init_and_parse_args([
        "-d", in175, "-f", os.path.join(GOLDEN, "torch_ebola175_m2.fasta"),
        "-m", "2", "-l", "60", "-e", "50",
        "--write-analysis-to-tsv", tsv["analysis"],
        "--write-probe-map-counts-to-tsv", tsv["probe_map_counts"],
        "--device", "cuda"]))
    for k, path in tsv.items():
        if not same_bytes(path, os.path.join(GOLDEN,
                                             f"ebola175_m2_{k}.tsv")):
            fail(f"ebola175 {k} TSV differs from its golden")


def identify_avoid_goldens(tag="", extra=()):
    """Phases 7, 14 and 18: the identify and avoid goldens through the CLI
    on cuda (`extra`: more flags)."""
    for name, argv in (
            ("identify", ["identify_a.fasta", "identify_b.fasta", "-i",
                          "-c", "0.5"]),
            ("avoid", ["avoid_target.fasta", "--avoid-genomes",
                       "avoid_bg.fasta"])):
        out = os.path.join(WORK, f"{name}_m0{tag}.fasta")
        argv = [os.path.join(GOLDEN, a) if a.endswith(".fasta") else a
                for a in argv]
        design(argv + ["-o", out, "-pl", "60", "-ps", "30", "-m", "0",
                       "-e", "0", "--device", "cuda"] + list(extra))
        golden = os.path.join(GOLDEN, f"ref_{name}_m0.fasta")
        if fasta_records(out) != fasta_records(golden):
            fail(f"{name} m0 probe set{tag} differs from {golden}")
        print(f"{name} m0{tag}: {len(fasta_records(out))} probes, equal to "
              "golden", flush=True)


def design(args, args_type="basic"):
    from catch_tpu_torch.cli import design as cli
    return cli.main(cli.init_and_parse_args(args, args_type=args_type))


def same_bytes(a, b):
    with open(a, "rb") as x, open(b, "rb") as y:
        return x.read() == y.read()


@contextlib.contextmanager
def recording(module, name, keep):
    """module.name wrapped so that keep(args, kwargs, result) sees every
    call; the function itself still runs (and counts its launches)."""
    fn = getattr(module, name)

    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        keep(args, kwargs, out)
        return out

    setattr(module, name, wrapped)
    try:
        yield
    finally:
        setattr(module, name, fn)


@contextlib.contextmanager
def peak_around(torch, module, name, log):
    """module.name wrapped so that each call appends (the peak allocated
    device bytes before it, the peak after it) to log: the call raised
    the process's peak where the second is larger."""
    fn = getattr(module, name)

    def wrapped(*args, **kwargs):
        torch.cuda.synchronize()
        before = torch.cuda.max_memory_allocated()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        log.append((before, torch.cuda.max_memory_allocated()))
        return out

    setattr(module, name, wrapped)
    try:
        yield
    finally:
        setattr(module, name, fn)


# The MinHash entry points, and the entry point of each template mode of
# csrc/minhash_caps.cu's pair kernel (minhash_walk_kernel; before it,
# minhash_pairs_kernel, modes 0-3).
MINHASH_ENTRIES = ("minhash_sig", "minhash_assign", "minhash_caps",
                   "minhash_dists", "minhash_codes")
MINHASH_MODES = {"0": "minhash_dists", "1": "minhash_codes",
                 "2": "minhash_caps", "3": "minhash_caps",
                 "4": "minhash_assign"}
# Phase 13's inputs, kept for tools/minhash_split.py.
MINHASH_INPUTS = os.path.join(WORK, "minhash_inputs.pt")


def minhash_entry(symbol):
    """The MinHash entry point that launches the kernel of this
    __global__ name (this design's or the one before it), "order check"
    for the row-order pass that minhash_caps.cu's four entry points
    share, None for another kernel."""
    if "minhash_sig" in symbol:
        return "minhash_sig"
    if "minhash_order" in symbol:
        return "order check"
    if "minhash_assign" in symbol:
        return "minhash_assign"
    m = re.search(r"minhash_(?:pairs|walk)_kernel<(\d)>", symbol)
    return MINHASH_MODES[m.group(1)] if m else None


def call_shape(name, args):
    """(U, n, H) of a minhash_sig call, (Q, n_reps, N) of minhash_assign,
    (Q, R, N) of the others."""
    if name == "minhash_sig":
        return (args[0].shape[0], args[0].shape[1], args[1].shape[0])
    if name == "minhash_assign":
        return (args[0].shape[0], int(args[2]), args[0].shape[1])
    return (args[0].shape[0], args[1].shape[0], args[0].shape[1])


@contextlib.contextmanager
def minhash_calls(torch, module, names, log, events=False):
    """module's entry points `names` wrapped so that each call appends
    (name, shape, events) to log; with `events`, two CUDA events on the
    current stream bracket the call (else events is None)."""
    saved = {n: getattr(module, n) for n in names}

    def wrap(name, fn):
        def wrapped(*args, **kwargs):
            ev = None
            if events:
                ev = tuple(torch.cuda.Event(enable_timing=True)
                           for _ in range(2))
                ev[0].record()
            out = fn(*args, **kwargs)
            if events:
                ev[1].record()
            log.append((name, call_shape(name, args), ev))
            return out
        return wrapped

    for n, fn in saved.items():
        setattr(module, n, wrap(n, fn))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(module, n, fn)


def trace_minhash_ms(path):
    """{entry point or "order check": (kernel launches, summed device
    ms)} of the MinHash kernels in a chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "kernel":
            name = minhash_entry(e.get("name", ""))
            if name:
                n, ms = out.get(name, (0, 0.0))
                out[name] = (n + 1, ms + e["dur"] / 1e3)
    return out


def minhash_totals(torch, what, log, device_ms=None):
    """Print, for each MinHash entry point called in `log`, its calls,
    its summed time and its smallest, median and largest call by work
    (Q x R x N or U x n x H): the kernels' launches and device ms from
    `device_ms` (trace_minhash_ms) where given, else the calls' CUDA
    events (the whole wrapper call, its order check included).  Returns
    {entry point: (calls, summed ms)}."""
    torch.cuda.synchronize()
    out = {}
    for name in MINHASH_ENTRIES:
        calls = sorted(((shape, ev) for n, shape, ev in log if n == name),
                       key=lambda c: math.prod(c[0]))
        if not calls:
            continue
        if device_ms is not None:
            n_k, ms = device_ms.get(name, (0, 0.0))
            how = f"{n_k} kernel launches, {ms:.4f} device ms summed"
        else:
            ms = sum(a.elapsed_time(b) for _, (a, b) in calls)
            how = f"{ms:.4f} ms summed over the calls' CUDA events"
        shapes = [calls[0][0], calls[len(calls) // 2][0], calls[-1][0]]
        print(f"{what}: {name}: {len(calls)} calls, {how}; shapes "
              f"smallest {shapes[0]}, median {shapes[1]}, largest "
              f"{shapes[2]}", flush=True)
        out[name] = (len(calls), ms)
    if device_ms and "order check" in device_ms:
        n_k, ms = device_ms["order check"]
        print(f"{what}: the row-order check: {n_k} kernel launches, "
              f"{ms:.4f} device ms summed", flush=True)
    return out


def device_busy(path, since=None):
    """(device events, busy seconds, seconds by kind) of a chrome trace:
    the union of the card's kernel, copy and set intervals (those that
    start at `since` or later, where given)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ivs, by_kind = [], {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in (
                "kernel", "gpu_memcpy", "gpu_memset") and (
                since is None or e["ts"] >= since):
            ivs.append((e["ts"], e["ts"] + e["dur"]))
            by_kind[e["cat"]] = by_kind.get(e["cat"], 0.0) + e["dur"] / 1e6
    busy, reach = 0.0, float("-inf")
    for a, b in sorted(ivs):
        if b > reach:
            busy += b - max(a, reach)
            reach = b
    return len(ivs), busy / 1e6, by_kind


def run_design_large(torch, si, profiling, n_genomes, name, profile=False):
    """Phases 10 and 11: design_large through the CLI on cuda, counting
    launches; the clusters (where a golden exists) and the FASTA must
    equal their goldens.  With `profile`, the run goes under
    torch.profiler (CUDA activity) and the card's busy share is printed.
    Returns the launches and what phase 13 keeps: the arguments of the
    largest minhash_sig and minhash_caps calls, of the last full greedy
    wave's minhash_assign call and of the largest cluster's readback
    (its packed rows), and the clustering's signature matrix."""
    from catch_tpu_torch.utils import cluster, lsh

    paths, bp = write_flu(n_genomes)
    out = os.path.join(WORK, f"{name}_design_large.fasta")
    kept, calls, lock = {}, [], threading.Lock()

    def keeper(what, size):
        def keep(args, kwargs, res):
            with lock:
                if what not in kept or size(args) > size(kept[what]):
                    kept[what] = args
        return keep

    def keep_wave(args, kwargs, res):
        # the last full wave (the final one may be short)
        if "assign" not in kept or \
                args[0].shape[0] >= kept["assign"][0].shape[0]:
            kept["assign"] = args

    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA]) if profile \
        else contextlib.nullcontext()
    mh_log = []
    with minhash_calls(torch, cluster, ["minhash_assign", "minhash_caps"],
                       mh_log), \
            minhash_calls(torch, lsh, ["minhash_sig"], mh_log), \
            recording(cluster, "cluster_with_minhash_signatures",
                   lambda a, k, r: calls.append(
                       (len(a[0]), k["cluster_method"], r))), \
            recording(cluster, "signature_matrix",
                      lambda a, k, r: kept.__setitem__("sigs", r)), \
            recording(cluster, "minhash_assign", keep_wave), \
            recording(cluster, "minhash_caps", keeper(
                "caps", lambda a: a[0].shape[0] * a[1].shape[0])), \
            recording(si, "instance_to_host", keeper(
                "pack", lambda a: a[0]["packed"][0].numel())), \
            recording(lsh, "minhash_sig", keeper(
                "sig", lambda a: a[0].shape[0])), prof:
        pb, wall, launches, peak = counted(
            torch, si, profiling, lambda: design(
                paths + ["-o", out, "--device", "cuda"], "large"))
    (n_seqs, method, clusters), = calls
    print(f"{name} design_large: {len(pb.final_probes)} probes from "
          f"{len(pb.candidate_probes)} candidates; {n_seqs} sequences, "
          f"{bp} bp, {len(clusters)} clusters ({method}) of "
          f"{len(clusters[-1])}-{len(clusters[0])}; wall {wall:.3f} s; "
          f"peak allocated device memory {peak / 2**20:.1f} MiB", flush=True)
    print_phases(profiling, ("cluster", "candidate", "filter", "set_cover",
                             "scan"))
    print(f"launches in the {name} design_large: {launches}", flush=True)
    if profile:
        trace = os.path.join(WORK, f"{name}_design_large_trace.json")
        prof.export_chrome_trace(trace)
        n_ev, busy, by_kind = device_busy(trace)
        kinds = ", ".join(f"{k} {v:.4f} s" for k, v in sorted(by_kind.items()))
        print(f"{name} design_large under torch.profiler (CUDA activity): "
              f"{n_ev} device events; the card busy {busy:.4f} s of the "
              f"{wall:.3f} s wall, {100 * busy / wall:.4f}% ({kinds})",
              flush=True)
        minhash_totals(torch, f"{name} MinHash totals (trace)", mh_log,
                       trace_minhash_ms(trace))
    golden = os.path.join(GOLDEN, f"{name}_clusters.tsv.gz")
    if os.path.exists(golden):
        if cluster_ranks(clusters, n_seqs) != read_cluster_ranks(golden):
            fail(f"{name} clusters differ from {golden}")
        print(f"{name} clusters equal to golden", flush=True)
    if not same_bytes(out, os.path.join(GOLDEN,
                                        f"{name}_design_large.fasta")):
        fail(f"{name} design_large output differs from its golden")
    print(f"{name} design_large FASTA equal to golden", flush=True)
    require_launched(launches, DESIGN_KERNELS + [
        "minhash_assign", "minhash_caps", "minhash_sig"],
        f"the {name} design_large")
    return launches, kept


def cluster_scale(torch, si, profiling, device):
    """Phase 12: the clustering step of design_large's defaults on the
    51 Mbp scale corpus, as ProbeDesigner._cluster_genomes runs it, with
    fragments of 50,000 nt ('choose' gives 'simple') and of 10,000 nt
    ('hierarchical'); both must equal their goldens.  Returns per kernel
    its launches and the signature matrix it got."""
    from catch_tpu_torch.designer import ProbeDesigner
    from catch_tpu_torch.genome import Genome
    from catch_tpu_torch.utils import cluster

    t0 = time.time()
    genomes = [Genome.from_one_seq(x) for x in scale_seqs()]
    print(f"scale corpus: {len(genomes)} genomes, "
          f"{sum(g.size() for g in genomes)} bp ({time.time() - t0:.1f} s "
          "to make)", flush=True)
    out = {}
    for frag, method, name, kernel in (
            (50000, "simple", "scale51m_clusters_simple", "minhash_codes"),
            (10000, "hierarchical",
             "scale51m_frag10k_clusters_hierarchical", "minhash_dists")):
        pb = ProbeDesigner([genomes], [], probe_length=100, probe_stride=50,
                           cluster_threshold=0.15, cluster_method="choose",
                           cluster_fragment_length=frag, device=device)
        calls, sigs, mh_log = [], [], []
        with recording(cluster, "cluster_with_minhash_signatures",
                       lambda a, k, r: calls.append(
                           (len(a[0]), k["cluster_method"], r))), \
                recording(cluster, "signature_matrix",
                          lambda a, k, r: sigs.append(r)), \
                minhash_calls(torch, cluster, ["minhash_dists",
                                               "minhash_codes"],
                              mh_log, events=True):
            _, wall, launches, peak = counted(torch, si, profiling,
                                              pb._cluster_genomes)
        (n, got, clusters), = calls
        if got != method:
            fail(f"fragments of {frag}: 'choose' gave {got}, not {method}")
        if cluster_ranks(clusters, n) != read_cluster_ranks(
                os.path.join(GOLDEN, f"{name}.tsv.gz")):
            fail(f"scale corpus clusters ({method}) differ from {name}")
        print(f"scale corpus, fragments of {frag}: {n} sequences, "
              f"{len(clusters)} clusters ({method}), equal to golden; wall "
              f"{wall:.3f} s; peak allocated device memory "
              f"{peak / 2**20:.1f} MiB; launches {launches}", flush=True)
        print_phases(profiling, ("cluster",))
        minhash_totals(torch, f"scale corpus ({method}) MinHash totals",
                       mh_log)
        require_launched(launches, [kernel], f"the {method} clustering")
        out[kernel] = (launches[kernel], sigs[-1])
    return out


def save_minhash_inputs(torch, kept, frag_sigs, flu_sigs):
    """Phase 13's inputs, on the CPU, to MINHASH_INPUTS: the arguments
    of the kept minhash_sig, minhash_assign and minhash_caps calls, and
    the two all-pairs signature matrices."""
    torch.save({k: tuple(x.cpu() if hasattr(x, "cpu") else x for x in v)
                for k, v in dict(sig=kept["sig"], assign=kept["assign"],
                                 caps=kept["caps"], frag_sigs=(frag_sigs,),
                                 flu_sigs=(flu_sigs,)).items()},
               MINHASH_INPUTS)


def check_minhash_kernels(torch, si, kept, frag_sigs, flu_sigs):
    """Phase 13: minhash_caps' four entry points and minhash_sig against
    their twins at the shapes phases 11 and 12 gave them, and
    pack_merged at flu10k's largest cluster.  Returns the JSON rows of
    the MinHash kernels (the all-pairs entries at phase 12's fragment
    shapes)."""
    from catch_tpu_torch.ops import minhash as mh
    from catch_tpu_torch.utils import cluster

    save_minhash_inputs(torch, kept, frag_sigs, flu_sigs)
    codes, ab = kept["sig"]
    (U, n), H = codes.shape, ab.shape[0]
    wave, reps, n_reps, cap_thr = kept["assign"]
    (Q, N), R = wave.shape, reps.shape[0]
    blk, blk_r = kept["caps"]
    C, C_r = blk.shape[0], blk_r.shape[0]
    print(f"minhash_sig shapes: the largest near-duplicate group, U={U} "
          f"unique candidate probes, n={n} k-mers, H={H} hash functions; "
          f"greedy wave: Q={Q} queries, R={R} representatives, N={N}; "
          f"largest minhash_caps call: {C} x {C_r} leftovers of a wave",
          flush=True)

    def pairs(q, r, out_bytes):
        # bytes: both signature blocks and the output; operations: four
        # (two compares, two adds) per (pair, column) of the walk
        return 4 * (q + r) * N + out_bytes * q * r, 4 * q * r * N

    rows = compare(torch, [
        ("minhash_sig", lambda f: (f(codes, ab),), mh._minhash_sig_plain,
         mh.minhash_sig, 10, (4 * U * n + 8 * H + 4 * U * H, 4 * U * n * H)),
        ("minhash_assign", lambda f: f(wave, reps, n_reps, cap_thr),
         mh._minhash_assign_plain, mh.minhash_assign, 10,
         (4 * (Q + R) * N + 9 * Q, 4 * Q * R * N)),
        ("minhash_caps", lambda f: (f(blk, blk_r),), mh._minhash_caps_plain,
         mh.minhash_caps, 10, pairs(C, C_r, 1)),
    ])
    # the rows pack_merged got, decoded from what it gave; packing them
    # again must give the same bytes
    dev = kept["pack"][0]
    packed, b_pos = dev["packed"], dev["b_pos"]
    merged = tuple(torch.from_numpy(x).to(wave.device) for x in
                   si.unpack_merged(*(x.cpu().numpy() for x in packed),
                                    b_pos))
    if max_abs_err(torch, si.pack_merged(*merged, b_pos), packed):
        fail("pack_merged of the decoded flu10k rows differs from the run's")
    compare(torch, [pack_case(si, merged, b_pos,
                              "flu10k's largest cluster")])
    cap_t = cluster._min_cap(N, cluster._jaccard_dist_from_mash_dist(0.15,
                                                                     12))
    cap_e = cluster._min_cap(N, cluster._jaccard_dist_from_mash_dist(0.02,
                                                                     12))
    for sigs, what in ((frag_sigs, "phase 12's fragments"),
                       (flu_sigs, "the first flu10k sequences")):
        m = sigs.shape[0]
        print(f"all-pairs shapes: {m} signatures of {what}, N={N}",
              flush=True)
        # the twin takes seconds here: one timed call
        got = compare(torch, [
            ("minhash_dists", lambda f, x=sigs: (f(x, x),),
             mh._minhash_dists_plain, mh.minhash_dists, 5, pairs(m, m, 4)),
            ("minhash_codes", lambda f, x=sigs: (f(x, x, cap_t, cap_e),),
             mh._minhash_codes_plain, mh.minhash_codes, 5, pairs(m, m, 1)),
        ], twin_reps=1)
        print(f"row shapes: one of the {m} signatures against all",
              flush=True)
        compare(torch, [("minhash_dists", lambda f, x=sigs: (
            f(x[m // 2:m // 2 + 1], x),), mh._minhash_dists_plain,
            mh.minhash_dists, 20, pairs(1, m, 4))])
        if sigs is frag_sigs:
            rows += got
    return rows


@contextlib.contextmanager
def environ(name, value):
    """The environment variable `name` set to `value` (or unset, for
    None) for the block, and restored after it."""
    before = os.environ.get(name)
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value
    try:
        yield
    finally:
        if before is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = before


def solve_on_device():
    """CATCH_TPU_SOLVE=device for the block: the set-cover filter keeps
    the instance on the card and runs the device solver."""
    return environ("CATCH_TPU_SOLVE", "device")


def device_solve_design(torch, si, profiling, in175):
    """Phase 14: ebola175 m2 through the CLI with the device solver,
    counting launches, then the identify and avoid goldens under it.
    Returns the launches and the run's assembled instance."""
    from catch_tpu_torch.ops import set_cover as sct

    out = os.path.join(WORK, "ebola175_m2_device_solve.fasta")
    kept, peaks = [], []
    with solve_on_device(), recording(si, "ensure_assembled",
                                      lambda a, k, r: kept.append(r)), \
            peak_around(torch, si, "ensure_assembled", peaks):
        pb, wall, launches, peak = counted(torch, si, profiling, lambda: design(
            [in175, "-o", out, "-pl", "100", "-m", "2", "-l", "60", "-e",
             "50", "--device", "cuda"]))
    (before_e, after_e), = peaks
    print(f"peak allocated device memory before stage E (stage D's) "
          f"{before_e / 2**20:.1f} MiB, after stage E "
          f"{after_e / 2**20:.1f} MiB", flush=True)
    if after_e > before_e:
        fail("stage E raised the device route's peak device memory")
    if not same_bytes(out, os.path.join(GOLDEN, "torch_ebola175_m2.fasta")):
        fail("ebola175 m2 with the device solver differs from "
             "torch_ebola175_m2.fasta")
    stats = pb.filters[-1].last_run_stats
    solve_s = profiling.phase_seconds["set_cover:solve"]
    steps = launches["greedy_v2"] * sct._STEPS_PER_DISPATCH
    dev, = kept
    print(f"ebola175 m2 with the device solver: {len(pb.final_probes)} "
          f"probes, equal to golden; wall {wall:.3f} s; set_cover:solve "
          f"{solve_s:.4f} s for {stats['set_cover_picks']} picks in {steps} "
          f"steps ({1e3 * solve_s / steps:.4f} ms a step, "
          f"{stats['set_cover_picks'] / solve_s:.1f} picks/s); instance "
          f"{dev['n_merged']} intervals, {dev['univ_of_pair'].numel()} "
          f"pairs, {dev['cost'].numel()} sets, {dev['u_len']} positions; "
          f"max {dev['max_pairs_per_set']} pairs and "
          f"{dev['max_ivls_per_set']} intervals a set; peak allocated "
          f"device memory {peak / 2**20:.1f} MiB", flush=True)
    print_phases(profiling, ("candidate", "filter", "set_cover", "scan"))
    print(f"launches in the device-solver run: {launches}", flush=True)
    scan_kernels = [k for k in DESIGN_KERNELS if k != "pack_merged"]
    require_launched(launches, scan_kernels + SOLVER_KERNELS,
                     "the ebola175 design with the device solver")
    if launches["pack_merged"]:
        fail("the device solver's route packed the instance for a readback")
    si.reset_launches()
    with solve_on_device():
        identify_avoid_goldens(" (device solver)")
    require_launched({n: f.launches for n, f in si.KERNELS.items()},
                     SOLVER_KERNELS, "the identify and avoid designs")
    return launches, dev


def solver_instance(sct):
    """bench.py's solver instance (bench.py:178-198), by the port's copy
    of build_instance_from_cover_arrays."""
    import numpy as np

    rng = np.random.default_rng(5)
    n_ivl = SOLVER_N_SETS * 4
    set_ids = np.repeat(np.arange(SOLVER_N_SETS), 4)
    univ_ids = rng.integers(0, SOLVER_N_UNIV, size=n_ivl)
    starts = rng.integers(0, SOLVER_U_LEN - 400, size=n_ivl)
    ends = starts + rng.integers(150, 400, size=n_ivl)
    return sct.build_instance_from_cover_arrays(
        set_ids, univ_ids, starts, ends, n_sets=SOLVER_N_SETS,
        n_universes=SOLVER_N_UNIV, universe_p=np.ones(SOLVER_N_UNIV))


def solver_bench(torch, si, profiling, device):
    """Phase 15: the four solvers on bench.py's instance, counting
    launches; every pick order must equal the host lazy solver's.  Each
    device solver runs twice (wall clock to a synchronised end).
    Returns the instance, the host's pick order and the launches."""
    import numpy as np

    from catch_tpu_torch.ops import set_cover as sct

    t0 = time.time()
    inst = solver_instance(sct)
    print(f"solver instance: {SOLVER_N_SETS} sets, {inst.u_len} positions, "
          f"{len(inst.ivl_start)} intervals, {len(inst.set_of_pair)} pairs "
          f"({time.time() - t0:.1f} s to build)", flush=True)
    t0 = time.time()
    want = sct._solve_host_lazy(inst)
    host_s = time.time() - t0
    print(f"host lazy solver: {len(want)} picks in {host_s:.3f} s "
          f"({len(want) / host_s:.1f} picks/s)", flush=True)
    solvers = (
        ("solve_boundary_instance (K10-K12)", "greedy_v2",
         lambda: sct.solve_boundary_instance(
             sct.assembled_instance(inst, device), SOLVER_N_SETS)),
        ("solve_instance(force_device=True) (K13)", "greedy_v1",
         lambda: sct.solve_instance(inst, force_device=True, device=device)),
        ("_solve_device (K13, order on the card)", "greedy_v1",
         lambda: sct._solve_device(inst, device)))

    def run_all():
        for name, kernel, fn in solvers:
            for attempt in (1, 2):
                n0 = si.KERNELS[kernel].launches
                torch.cuda.synchronize()
                t0 = time.time()
                got = fn()
                torch.cuda.synchronize()
                dt = time.time() - t0
                steps = (si.KERNELS[kernel].launches - n0) \
                    * sct._STEPS_PER_DISPATCH
                if not np.array_equal(got, want):
                    fail(f"{name}: pick order differs from the host lazy "
                         "solver's")
                print(f"{name}, run {attempt}: {len(got)} picks, equal to "
                      f"the host's; {dt:.4f} s, {steps} steps, "
                      f"{1e3 * dt / steps:.4f} ms a step, "
                      f"{len(got) / dt:.1f} picks/s", flush=True)

    _, wall, launches, peak = counted(torch, si, profiling, run_all)
    print(f"launches in the solver runs: {launches}; peak allocated device "
          f"memory {peak / 2**20:.1f} MiB", flush=True)
    require_launched(launches, SOLVER_KERNELS + ["greedy_v1"],
                     "the solver runs")
    return inst, want, launches


def step_work(U, M, P, S, nU, ivl_bytes, pair_bytes):
    """(bytes, operations) of one greedy step with a full recompute:
    `covered`, the prefix, and the interval, pair, set and universe
    arrays once."""
    return (U + 4 * (U + 1) + ivl_bytes * M + pair_bytes * P + 13 * S
            + 8 * nU, U + M + P + S)


def union_positions(starts, ends):
    """Positions that the intervals (int64 numpy arrays) hold, each
    counted once."""
    import numpy as np

    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    reach = np.maximum.accumulate(np.concatenate([s[:1], e]))[:-1]
    return int(np.clip(e - np.maximum(s, reach), 0, None).sum())


def incremental_work(name, what, U, S, nU, d, chosens, picks, full_step):
    """The (bytes, operations) of one K12 or K13 dispatch that bound_ms
    takes: the smaller bound of (a) a full recompute every step
    (full_step = step_work of one step, catch_tpu's) and (b) the
    incremental design's own: the recompute once (`covered` and the
    intervals read, the prefix and pair_new written, pair_bounds read),
    each step's score pass (pair_new and univ_of_pair, 8 bytes a pair;
    the set arrays, 13 bytes a set; the universe arrays), and each
    pick's chosen positions (the union of the set's intervals) read and
    written.  d: the instance grouped by pair and set (ivl_start,
    ivl_end, pair_bounds, set_bounds); chosens and picks: the twin's
    steps."""
    import numpy as np

    s, e, pb, sb = (d[k].cpu().numpy().astype(np.int64) for k in (
        "ivl_start", "ivl_end", "pair_bounds", "set_bounds"))
    M, P, n_steps = len(s), len(pb) - 1, len(picks)
    chosen_pos = sum(union_positions(s[pb[sb[c]]:pb[sb[c + 1]]],
                                     e[pb[sb[c]]:pb[sb[c + 1]]])
                     for c in chosens[picks].tolist())
    full = (n_steps * full_step[0], n_steps * full_step[1])
    incr = (U + 4 * (U + 1) + 8 * M + 8 * P + 4
            + n_steps * (8 * P + 13 * S + 8 * nU) + 2 * chosen_pos,
            U + M + P + n_steps * (P + S) + chosen_pos)
    return smaller_work(name, what, n_steps, int(picks.sum()), chosen_pos,
                        full, incr)


def smaller_work(name, what, n_steps, n_picks, chosen_pos, full, incr):
    """Prints both works of a greedy dispatch, (a) a full recompute
    every step and (b) the incremental design's own, with their bounds;
    returns the one of the smaller bound."""
    print(f"{name} work ({what}, {n_steps} steps, {n_picks} picks over "
          f"{chosen_pos} chosen positions): a full recompute every step "
          f"{full[0]} bytes, {full[1]} operations (bound "
          f"{bound(full)[0]:.4f} ms); the incremental step's own "
          f"{incr[0]} bytes, {incr[1]} operations (bound "
          f"{bound(incr)[0]:.4f} ms); the bound is the smaller", flush=True)
    return min(full, incr, key=lambda w: bound(w)[0])


def k18_work(torch, psc, what, inst, part, states0, n_steps):
    """The work of one K18 dispatch of n_steps from states0 at the
    places of `part` (smaller_work): (a) a full recompute every step on
    every place, the old bound, and (b) the incremental design's own,
    summed over the places with each replicated part counted once a
    place: each place's recompute once (its replica's axis, its
    intervals and pairs), each step's score pass over every shard's
    pairs and sets and each replica's universe arrays, and each pick's
    chosen positions read and written on every replica.  The picks are
    the twin's on a copy of states0."""
    import numpy as np

    states = psc._greedy_steps_sharded_plain(
        [{k: v.clone() for k, v in s.items()} for s in states0], part,
        n_steps)
    order = states[0]["order"][:int(states[0]["n_chosen"])].cpu().numpy()
    set_of_ivl = np.asarray(inst.set_of_pair)[np.asarray(inst.pair_of_ivl)]
    by_set = np.argsort(set_of_ivl, kind="stable")
    bounds = np.searchsorted(set_of_ivl[by_set], np.arange(inst.n_sets + 1))
    s = np.asarray(inst.ivl_start, dtype=np.int64)[by_set]
    e = np.asarray(inst.ivl_end, dtype=np.int64)[by_set]
    chosen_pos = sum(union_positions(s[bounds[c]:bounds[c + 1]],
                                     e[bounds[c]:bounds[c + 1]])
                     for c in order.tolist())
    U, nU, n = inst.u_len, inst.n_universes, len(part["shards"])
    shapes = [(sh["ivl_start"].numel(), sh["set_of_pair"].numel(),
               sh["cost"].numel()) for sh in part["shards"]]
    full = [step_work(U, M, P, S, nU, 12, 8) for M, P, S in shapes]
    full = (n_steps * sum(w[0] for w in full),
            n_steps * sum(w[1] for w in full))
    M, P, S = (sum(x) for x in zip(*shapes))
    incr = (n * (U + 4 * (U + 1) + 4) + 8 * M + 8 * P
            + n_steps * (8 * P + 13 * S + 8 * nU * n) + 2 * n * chosen_pos,
            n * U + M + P + n_steps * (P + S) + n * chosen_pos)
    return smaller_work("greedy_sharded", f"{what}, {n} places", n_steps,
                        len(order), chosen_pos, full, incr)


def k12_work(torch, sct, what, dev, state0, n_steps):
    """incremental_work of one K12 dispatch of n_steps from state0 on
    the assembled instance dev; the picks are the twin's on a copy of
    state0."""
    U, S = dev["u_len"], dev["cost"].numel()
    M, P = dev["ivl_start"].numel(), dev["univ_of_pair"].numel()
    nU = dev["can_uncover"].numel()
    _, chosens, picks = sct._greedy_steps_v2_plain(
        {k: v.clone() for k, v in state0.items()}, dev, n_steps)
    return incremental_work("greedy_v2", what, U, S, nU, dev, chosens.cpu(),
                            picks.cpu(), step_work(U, M, P, S, nU, 8, 8))


def device_launches(torch, fn):
    """{name: launches} of the port's own launches (kernels and memsets)
    in one fn() call, from torch.profiler (CUDA activity).  A capture
    after earlier ones in a process can lose its first kernel records
    (utils/profiling.py _WARM_UP_LAUNCHES), so the capture first launches
    as many one-element adds (PyTorch's kernels, at::native) and waits;
    PyTorch's own kernels are left out of the count."""
    from catch_tpu_torch.utils import profiling

    w = torch.zeros(1, device="cuda")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(profiling._WARM_UP_LAUNCHES):
            w.add_(1)
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    return {ev.key[:60]: ev.count for ev in prof.key_averages()
            if "at::native" not in ev.key
            and (getattr(ev, "device_time_total", None)
                 or getattr(ev, "cuda_time_total", 0))}


def k13_dispatch(torch, sct, inst, consts, state0, n_steps):
    """K13 on one n_steps dispatch of phase 15's instance: the
    regrouping's CUDA-event time apart from the dispatch's (the
    dispatch in phase 16's row finds it kept in consts), the launches
    of one dispatch by name and a step (launches of n_steps or more a
    dispatch, over n_steps; 3 by the design: fails otherwise), and the
    work of the bound (incremental_work, the old full recompute 12 bytes
    an interval)."""
    idx = sct.k13_index(consts, inst.u_len)
    rebuild = (lambda: sct.set_major_index(*(consts[k] for k in (
        "ivl_start", "ivl_end", "pair_of_ivl", "set_of_pair",
        "univ_of_pair")), inst.n_sets, inst.u_len))
    ms, lo, hi = cuda_ms(torch, rebuild, 5)
    print(f"greedy_v1's regrouping (set_major_index, once a solve): "
          f"{ms:.3f} ms [{lo:.3f}, {hi:.3f}]; {idx['tile_ivl'].numel()} "
          f"pieces, {idx['grp_tile'].numel()} set tiles, at most "
          f"{idx['max_groups']} a set", flush=True)
    state = {k: v.clone() for k, v in state0.items()}
    counts = device_launches(torch, lambda: sct.greedy_steps_v1(
        state, consts, n_steps))
    per_step = sum(n for n in counts.values() if n >= n_steps) / n_steps
    print(f"greedy_v1 launches in one {n_steps}-step dispatch: {counts}; "
          f"{per_step:g} a step", flush=True)
    if per_step != 3:
        fail(f"greedy_v1 makes {per_step:g} launches a step, not 3")
    _, chosens, picks = sct._greedy_steps_v1_plain(
        {k: v.clone() for k, v in state0.items()}, consts, n_steps)
    U, S, nU = inst.u_len, inst.n_sets, inst.n_universes
    M, P = len(inst.ivl_start), len(inst.set_of_pair)
    return incremental_work("greedy_v1", "solver instance", U, S, nU, idx,
                            chosens.cpu(), picks.cpu(),
                            step_work(U, M, P, S, nU, 12, 8))


def check_solver_kernels(torch, device, dev, inst):
    """Phase 16: K10-K13 against their twins: assemble and init_covered
    on phase 15's instance (printed first; their rows in the JSON line
    are ebola175's), then on phase 14's instance, one 64-step greedy_v2
    dispatch from its initial state, one 64-step greedy_v1 dispatch of
    phase 15's instance (after k13_dispatch); then greedy_v2 on one
    64-step dispatch of phase 15's instance (printed; its row is not in
    the JSON line, which holds ebola175's).  Returns the JSON rows."""
    from catch_tpu_torch.ops import scan_instance as si
    from catch_tpu_torch.ops import set_cover as sct

    n, S, U = dev["merged"][0].numel(), dev["cost"].numel(), dev["u_len"]
    P, nU = dev["univ_of_pair"].numel(), len(dev["offsets"]) - 1
    n_steps = sct._STEPS_PER_DISPATCH

    def setup_cases(d):
        """K10 and K11 on the assembled instance d: the cases of
        compare().  Bytes each input read once and each output written
        once, and an operation per element.  K10: 24 bytes a row in, 8
        out, the pair arrays (pair_bounds, univ_of_pair) and set_bounds
        out.  K11: the intervals in, a byte a position out."""
        mk, ms, me = d["merged"]
        off = torch.from_numpy(d["offsets"]).to(device)
        n, S, U = mk.numel(), d["cost"].numel(), d["u_len"]
        P, nU = d["univ_of_pair"].numel(), off.numel() - 1

        def k10(f):
            out = f(mk, ms, me, off, S)
            return out[:5] + (torch.tensor(out[5:], device=device),)

        def k11(f):
            return (f(d["ivl_start"], d["ivl_end"], U),)

        return [
            ("assemble", k10, si._assemble_plain, si.assemble, 10,
             (32 * n + 8 * (nU + 1) + 4 * (2 * P + 1) + 4 * (S + 1),
              n + P + S)),
            ("init_covered", k11, sct._init_covered_plain, sct.init_covered,
             20, (8 * n + U, n + U))]

    def stepper(state0, consts):
        def call(f):
            state, chosens, picks = f(
                {k: v.clone() for k, v in state0.items()}, consts, n_steps)
            return tuple(state.values()) + (chosens, picks)
        return call

    state12 = sct.initial_state(sct.init_covered(
        dev["ivl_start"], dev["ivl_end"], U), dev["u_size"], S)
    consts, u_size = sct._instance_consts(inst, device)
    state13 = sct.initial_state(sct.init_covered(
        consts["ivl_start"], consts["ivl_end"], inst.u_len), u_size,
        inst.n_sets)
    M13, P13 = len(inst.ivl_start), len(inst.set_of_pair)
    print(f"solver kernel shapes: ebola175 {n} merged rows, {P} pairs, {S} "
          f"sets, {nU} universes, {U} positions; bench instance {M13} "
          f"intervals, {P13} pairs, {inst.n_sets} sets, {inst.u_len} "
          f"positions; {n_steps} steps a dispatch", flush=True)
    # K10 and K11: setup_cases; K12: k12_work; K13: k13_dispatch.
    v2 = k12_work(torch, sct, "ebola175", dev, state12, n_steps)
    v1 = k13_dispatch(torch, sct, inst, consts, state13, n_steps)
    dev15 = sct.assembled_instance(inst, device)
    state15 = sct.initial_state(sct.init_covered(
        dev15["ivl_start"], dev15["ivl_end"], dev15["u_len"]),
        dev15["u_size"], inst.n_sets)
    v2_15 = k12_work(torch, sct, "solver instance", dev15, state15, n_steps)
    print("assemble and init_covered on phase 15's solver instance:",
          flush=True)
    compare(torch, setup_cases(dev15))
    rows = compare(torch, setup_cases(dev) + [
        ("greedy_v2", stepper(state12, dev), sct._greedy_steps_v2_plain,
         sct.greedy_steps_v2, 5, v2),
        ("greedy_v1", stepper(state13, consts), sct._greedy_steps_v1_plain,
         sct.greedy_steps_v1, 5, v1),
    ])
    print("greedy_v2 on phase 15's solver instance:", flush=True)
    compare(torch, [("greedy_v2", stepper(state15, dev15),
                     sct._greedy_steps_v2_plain, sct.greedy_steps_v2, 5,
                     v2_15)])
    return rows


def virtual_places(n):
    """CATCH_TPU_VIRTUAL_DEVICES=n for the block: n places are visible on
    the one card."""
    return environ("CATCH_TPU_VIRTUAL_DEVICES", str(n))


def mesh_design(torch, si, profiling, in175, stats5):
    """Phase 17: ebola175 m2 through the CLI with --num-devices 4 on both
    solver routes, counting launches.  Returns the host route's instance
    (as instance_to_host read it back) and the last route's launches."""
    kept = []
    for route, ctx, needed in (
            ("host solver", contextlib.nullcontext(),
             DESIGN_KERNELS + ["dedup_pairs"]),
            ("device solver", solve_on_device(),
             [k for k in DESIGN_KERNELS if k != "pack_merged"]
             + SOLVER_KERNELS + ["dedup_pairs"])):
        out = os.path.join(WORK, f"ebola175_m2_mesh_{route.split()[0]}.fasta")
        with virtual_places(MESH_PLACES), ctx, recording(
                si, "instance_to_host", lambda a, k, r: kept.append(r)):
            pb, wall, launches, peak = counted(
                torch, si, profiling, lambda: design(
                    [in175, "-o", out, "-pl", "100", "-m", "2", "-l", "60",
                     "-e", "50", "--device", "cuda", "--num-devices",
                     str(MESH_PLACES)]))
        what = f"ebola175 m2 on {MESH_PLACES} places, {route}"
        if not same_bytes(out, os.path.join(GOLDEN,
                                            "torch_ebola175_m2.fasta")):
            fail(f"{what}: output differs from torch_ebola175_m2.fasta")
        scf = pb.filters[-1]
        stats = scf.last_run_stats
        if scf.mesh is None or scf.mesh.size != MESH_PLACES:
            fail(f"{what}: the filter got the mesh {scf.mesh}")
        got = (stats["candidates_evaluated"], stats["set_cover_picks"])
        if got != stats5:
            fail(f"{what}: (candidates, picks) {got} differ from the "
                 f"single-place run's {stats5}")
        print(f"{what}: {len(pb.final_probes)} probes, equal to golden; "
              f"wall {wall:.3f} s; {got[0]} candidates and {got[1]} picks, "
              f"as on one place; peak allocated device memory "
              f"{peak / 2**20:.1f} MiB", flush=True)
        print_phases(profiling, ("set_cover", "scan"))
        by_place = stats["launches_by_place"]
        print(f"launches ({what}): {launches}; by place: {by_place}",
              flush=True)
        require_launched(launches, needed, what)
        for d in range(MESH_PLACES):
            require_launched(by_place.get(d, dict.fromkeys(PLACE_KERNELS, 0)),
                             PLACE_KERNELS, f"place {d} of {what}")
        for k in PLACE_KERNELS:
            by = sum(v[k] for v in by_place.values())
            if launches[k] != by:
                fail(f"{what}: {launches[k]} launches of {k}, but the "
                     f"places count {by}")
        if launches["build_table"] != 1:
            fail(f"{what}: {launches['build_table']} launches of "
                 "build_table, not one table for every place")
    inst, = kept
    return inst, launches


def mesh_span_scan(torch, si, profiling, device, cands, genomes8, bg, ref):
    """Phase 18: the identify and avoid goldens and the 100 Mbp avoid
    ranks on 4 places; `ref` is phase 8's (wall, peak bytes).  Returns the
    launches of the avoid scan."""
    from catch_tpu_torch.filters.set_cover_filter import SetCoverFilter
    from catch_tpu_torch.parallel import make_mesh

    with virtual_places(MESH_PLACES):
        si.reset_launches()
        identify_avoid_goldens(f" ({MESH_PLACES} places)",
                               ["--num-devices", str(MESH_PLACES)])
        require_launched({n: f.launches for n, f in si.KERNELS.items()},
                         ["verify_spans_sharded"] + PLACE_KERNELS,
                         "the identify and avoid designs on the mesh")
        scf = SetCoverFilter(mismatches=2, lcf_thres=60, cover_extension=50,
                             avoided_genomes=[bg], device=device,
                             mesh=make_mesh(MESH_PLACES, device))
        want, n_flagged = expected_ranks(len(cands))
        ranks, wall, launches, peak = counted(
            torch, si, profiling, lambda: scf._make_ranks(cands, [genomes8]))
    if not (ranks == want).all():
        fail(f"avoid ranks on {MESH_PLACES} places differ from "
             "avoid100m_ranks.tsv")
    print(f"avoid 100 Mbp on {MESH_PLACES} places: ranks equal to golden "
          f"({len(cands)} candidates, {n_flagged} flagged); wall {wall:.3f} "
          f"s (one place: {ref[0]:.3f} s); {2 * AVOID_BG_BP / wall:.0f} bp/s "
          f"over both strands (one place: {2 * AVOID_BG_BP / ref[0]:.0f}); "
          f"peak allocated device memory {peak / 2**20:.1f} MiB (one place: "
          f"{ref[1] / 2**20:.1f} MiB)", flush=True)
    print_phases(profiling, ("span",))
    print(f"launches in the avoid scan on the mesh: {launches}", flush=True)
    require_launched(launches, ["expand_join", "verify_spans_sharded",
                                "segmented_merge"], "the avoid scan on the mesh")
    if launches["verify_spans"]:
        fail("the avoid scan on the mesh verified through verify_spans")
    return launches


def sharded_solver_bench(torch, si, profiling, device, instances):
    """Phase 19: each (name, instance, host pick order) through
    solve_instance_sharded and solve_instance(force_device=True, mesh=)
    at 1, 2, 4 and 8 places, counting launches; every pick order must
    equal the host's.  The wall clock runs over the whole call (the
    partition on the host and its copy to the places included) to a
    synchronised end; the steps' share is the solver's own phase
    solve_sharded:steps.  Returns the launches."""
    import numpy as np

    from catch_tpu_torch.ops import set_cover as sct
    from catch_tpu_torch.parallel import make_mesh, solve_instance_sharded

    def run_all():
        for name, inst, want in instances:
            for n in (1, 2, 4, 8):
                with virtual_places(n):
                    mesh = make_mesh(n, device)
                for label, fn in (
                        ("solve_instance_sharded",
                         lambda: solve_instance_sharded(inst, mesh=mesh)),
                        ("solve_instance(force_device=True, mesh=)",
                         lambda: sct.solve_instance(inst, force_device=True,
                                                    device=device,
                                                    mesh=mesh))):
                    n0 = {k: si.KERNELS[k].launches
                          for k in ("greedy_sharded", "greedy_v1")}
                    profiling.reset_phases()
                    torch.cuda.synchronize()
                    t0 = time.time()
                    got = fn()
                    torch.cuda.synchronize()
                    dt = time.time() - t0
                    ran = {k: si.KERNELS[k].launches - v
                           for k, v in n0.items()}
                    kernel = max(ran, key=ran.get)
                    steps = ran[kernel] * sct._STEPS_PER_DISPATCH
                    if not np.array_equal(got, want):
                        fail(f"{name}, {label} on {n} places: pick order "
                             "differs from the host lazy solver's")
                    # the sharded solver books its steps apart from its
                    # partition; the one-place K13 route books nothing
                    step_s = profiling.phase_seconds.get(
                        "solve_sharded:steps", dt)
                    print(f"{name}, {label}, {n} places ({kernel}): "
                          f"{len(got)} picks, equal to the host's; {dt:.4f} "
                          f"s, {len(got) / dt:.1f} picks/s; {steps} steps in "
                          f"{step_s:.4f} s, {1e3 * step_s / steps:.4f} ms a "
                          f"step", flush=True)

    _, wall, launches, peak = counted(torch, si, profiling, run_all)
    print(f"launches in the sharded solver runs: {launches}; peak allocated "
          f"device memory {peak / 2**20:.1f} MiB", flush=True)
    require_launched(launches, ["init_covered", "greedy_sharded"],
                     "the sharded solver runs")
    return launches


def check_mesh_kernels(torch, device, instances, span_inputs):
    """Phase 20: greedy_sharded on one 64-step dispatch of each instance,
    verify_spans_sharded on phase 6's candidates and dedup_pairs on the
    ebola175 scan's joined pairs, at 4 places, against their twins.
    Returns the JSON rows (greedy_sharded at the last instance's
    shapes)."""
    from catch_tpu_torch.ops import scan_sparse as ss
    from catch_tpu_torch.ops import set_cover as sct
    from catch_tpu_torch.parallel import make_mesh
    from catch_tpu_torch.parallel import set_cover as psc

    n = MESH_PLACES
    n_steps = sct._STEPS_PER_DISPATCH
    with virtual_places(n):
        mesh = make_mesh(n, device)
    rows = []
    for name, inst, _ in instances:
        part = psc.place_partition(psc.partition_instance(inst, n),
                                   inst.can_uncover, mesh)
        consts, u_size = sct._instance_consts(inst, device)
        states0 = psc.initial_states(sct.init_covered(
            consts["ivl_start"], consts["ivl_end"], inst.u_len), u_size, part)
        del consts

        def steps(f, part=part, states0=states0):
            states = f([{k: v.clone() for k, v in s.items()}
                        for s in states0], part, n_steps)
            for other in states[1:]:
                for k in ("covered", "len_u", "order", "n_chosen",
                          "cur_rank", "stop"):
                    if not torch.equal(other[k], states[0][k]):
                        fail(f"greedy_sharded ({name}): the replicas of {k} "
                             "differ")
            return tuple(t for s in states for t in s.values())

        shapes = [(s["ivl_start"].numel(), s["set_of_pair"].numel(),
                   s["cost"].numel()) for s in part["shards"]]
        print(f"greedy_sharded shapes ({name}): {n} places, "
              f"{inst.u_len} positions and {inst.n_universes} universes "
              f"replicated; (intervals, pairs, sets) per place {shapes}; "
              f"{n_steps} steps", flush=True)
        work = k18_work(torch, psc, name, inst, part, states0, n_steps)
        rows = compare(torch, [
            ("greedy_sharded", steps, psc._greedy_steps_sharded_plain,
             psc.greedy_steps_sharded, 5, work)])
        # the regrouping is kept in the shards by now: the count holds
        # the recompute and the steps alone
        states = [{k: v.clone() for k, v in s.items()} for s in states0]
        counts = device_launches(torch, lambda: psc.greedy_steps_sharded(
            states, part, n_steps))
        per_step = sum(c for c in counts.values() if c >= n_steps) / n_steps
        print(f"greedy_sharded launches in one {n_steps}-step dispatch at "
              f"{n} places on one card ({name}): {counts}; {per_step:g} a "
              f"step", flush=True)
        if per_step > 4:
            fail(f"greedy_sharded makes {per_step:g} launches a step, not "
                 "at most 4")
        del part, states0, states

    def put(x):
        return torch.from_numpy(x).to(device)

    x = span_inputs
    cand = [c.to(device) for c in x["cand"]]
    replicas = [(put(x["mega"]), put(x["codes"])) for _ in range(n)]
    n_cand, L = cand[0].numel(), x["codes"].shape[1]
    print(f"verify_spans_sharded shapes: {n} places, each with a replica of "
          f"the {len(x['mega'])}-position corpus and the "
          f"{x['codes'].shape[0]} probe rows; {n_cand} candidates in blocks "
          f"of about {-(-n_cand // n)}; {x['n_spans']} spans", flush=True)

    def twin(reps, *cand, **kw):
        return ss._verify_spans_plain(*reps[0], *cand, **kw)

    # The function does verify_spans' work (spans_work): the places hold
    # replicas, but each candidate is verified by one place only.
    rows += compare(torch, [
        ("verify_spans_sharded", lambda f: f(replicas, *cand, **x["vargs"]),
         twin, ss.verify_spans_sharded, 10,
         spans_work(len(x["mega"]), x["codes"].size, L, cand,
                    x["n_spans"]))])
    del replicas, cand
    return rows + compare(torch, [dedup_case(torch, device, n)])


def dedup_case(torch, device, n):
    """The compare case of dedup_pairs on the pairs that the n places of
    the mesh-split ebola175 scan hand to the lead: each place's
    lookup_expand over its range of samples, joined in place order.  The
    function reads each pair once and writes each distinct pair once (16
    bytes either way) and sorts them; one torch.unique of the packed keys
    (p << 32) | a computes the same (torch.unique over the (pair, 2) rows
    too, printed on its own line)."""
    from catch_tpu_torch.ops import scan_instance as si

    x = kernel_inputs(torch, device)
    st, kj, s, total = x["st"], x["kj"], x["s"], x["total"]
    table = si.build_table(st["codes"], kj)
    ranges = si.split_range(-(-total // s), n)
    pairs = [si.lookup_expand(
        *table, si.rolling_hash(st["mega"][g0 * s:], g1 - g0, s, kj,
                                total - kj - g0 * s), s, sample0=g0)
             for g0, g1 in zip(ranges, ranges[1:])]
    p, a = si.join_on(device, pairs)
    n_in, n_out = p.numel(), si.dedup_pairs(p, a)[0].numel()
    print(f"dedup_pairs shapes: {n_in} pairs from {n} places "
          f"{[q[0].numel() for q in pairs]}, {n_out} distinct", flush=True)
    del x, st, table, pairs
    rows2 = torch.stack((p, a), dim=1)
    ms_rows = cuda_ms(torch, lambda: torch.unique(rows2, dim=0), 5)[0]
    del rows2
    print(f"dedup_pairs: torch.unique(dim=0) over the (pair, 2) rows "
          f"{ms_rows:.3f} ms", flush=True)
    print("dedup_pairs steps (ms, CUDA-event medians): " + step_split(
        torch, lambda st: si._dedup_pairs_cuda(p, a, si.DEDUP_TILE,
                                               steps=st)), flush=True)
    keys = (p << 32) | a

    def packed_unique():
        k = torch.unique(keys)
        return k >> 32, k & 0xFFFFFFFF

    return ("dedup_pairs", lambda f: f(p, a), si._dedup_pairs_plain,
            si.dedup_pairs, 10,
            (16 * (n_in + n_out), n_in * max(1, (n_in - 1).bit_length())),
            packed_unique)


@contextlib.contextmanager
def patched(module, name, value):
    """module.name set to value for the block."""
    before = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, before)


BLOCK_LIMIT = 1 << 20   # phase 21's _BLOCK_PAIR_KEYS and _BLOCK_POSITIONS


def blocked_design(torch, si, profiling, in175, stats5):
    """Phase 21: ebola175 m2 through the CLI with both block constants
    patched to 2^20 (4 probe blocks, 4 corpus blocks), on the host
    solver's route, the device solver's, the device solver's with the
    position-axis limit patched below the axis (so the host route takes
    over before stage E), and the device solver's with K12's piece
    limit patched below the instance's pieces (so the host route takes
    over after stage E, before any greedy step).  Every FASTA must equal
    torch_ebola175_m2.fasta, the candidates and picks phase 5's;
    build_table once per probe block, rolling_hash, lookup_expand and
    verify_windows once per block pair, assemble only where stage E ran,
    pack_merged only where the host solver ran, and greedy_v2 only
    where the device solver ran."""
    from catch_tpu_torch.ops import set_cover as sct

    blocks = []
    for route, axis, pieces, assembled, on_card in (
            ("host solver", sct._DEVICE_AXIS_LIMIT, sct._K12_PIECE_LIMIT,
             False, False),
            ("device solver", sct._DEVICE_AXIS_LIMIT, sct._K12_PIECE_LIMIT,
             True, True),
            ("device solver, axis limit 1000", 1000, sct._K12_PIECE_LIMIT,
             False, False),
            ("device solver, K12 piece limit 1000", sct._DEVICE_AXIS_LIMIT,
             1000, True, False)):
        out = os.path.join(WORK, f"ebola175_m2_blocks_{len(blocks)}.fasta")
        ctx = solve_on_device() if route.startswith("device") \
            else contextlib.nullcontext()
        with patched(si, "_BLOCK_PAIR_KEYS", BLOCK_LIMIT), \
                patched(si, "_BLOCK_POSITIONS", BLOCK_LIMIT), \
                patched(sct, "_DEVICE_AXIS_LIMIT", axis), \
                patched(sct, "_K12_PIECE_LIMIT", pieces), ctx, recording(
                    si, "scan_to_boundary_instance",
                    lambda a, k, r: blocks.append(a[0].stats["blocks"])):
            pb, wall, launches, peak = counted(
                torch, si, profiling, lambda: design(
                    [in175, "-o", out, "-pl", "100", "-m", "2", "-l", "60",
                     "-e", "50", "--device", "cuda"]))
        what = f"ebola175 m2 in blocks of 2^20, {route}"
        if not same_bytes(out, os.path.join(GOLDEN,
                                            "torch_ebola175_m2.fasta")):
            fail(f"{what}: output differs from torch_ebola175_m2.fasta")
        stats = pb.filters[-1].last_run_stats
        got = (stats["candidates_evaluated"], stats["set_cover_picks"])
        if got != stats5:
            fail(f"{what}: (candidates, picks) {got} differ from phase 5's "
                 f"{stats5}")
        n_p, n_c = blocks[-1]
        if n_p != 4 or n_c < 3:
            fail(f"{what}: {n_p} probe blocks and {n_c} corpus blocks")
        pairs = n_p * n_c
        want = {"build_table": n_p, "rolling_hash": pairs,
                "lookup_expand": pairs,
                "verify_windows": pairs, "segmented_merge": 2 * n_p + 1,
                "pack_merged": 0 if on_card else 1,
                "assemble": 1 if assembled else 0}
        for name, n in want.items():
            if launches[name] != n:
                fail(f"{what}: {launches[name]} launches of {name}, not {n}")
        if (launches["greedy_v2"] > 0) != on_card:
            fail(f"{what}: {launches['greedy_v2']} launches of greedy_v2")
        print(f"{what}: {len(pb.final_probes)} probes, equal to golden; "
              f"{n_p} probe blocks x {n_c} corpus blocks; {got[0]} "
              f"candidates and {got[1]} picks, as unsplit; wall {wall:.3f} "
              f"s; peak allocated device memory {peak / 2**20:.1f} MiB",
              flush=True)
        print_phases(profiling, ("candidate", "filter", "set_cover", "scan"))
        print(f"launches ({what}): {launches}", flush=True)


BG_GENOMES, BG_BP = 8, 272_000_000   # phase 22 (i): 2,176,000,000 bp
N_PIECES, PIECE_BP = 115_000, 1000   # phase 22 (ii)


def scan_only(torch, si, profiling, device, searcher, pid, sequences,
              seq_univ, chrom_off, n_universes, ext=50):
    """Phases 22 and 23: scan_to_boundary_instance alone, at cover
    extension ext, with the phases and the peak device memory counted
    from 0.  Returns (dev, info): wall seconds, bp, blocks, candidate
    pairs and peak bytes."""
    import numpy as np

    searcher.stats.clear()
    searcher.stats["candidates"] = 0
    lens = [len(x) for x in sequences]
    profiling.reset_phases()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    dev, _ = si.scan_to_boundary_instance(
        searcher, sequences, np.asarray(seq_univ), np.asarray(chrom_off),
        np.asarray(lens), n_universes, ext, np.ones(n_universes), pid,
        device)
    torch.cuda.synchronize()
    return dev, dict(wall=time.time() - t0, bp=sum(lens),
                     blocks=searcher.stats["blocks"],
                     pairs=searcher.stats["candidates"],
                     peak=torch.cuda.max_memory_allocated())


def blocked_scans(torch, si, profiling, device):
    """Phase 22: the splits at real size, at the unpatched limits, scan
    only (scan_to_boundary_instance): (i) ebola175's candidates against
    ebola175 and 8 random background genomes of 272,000,000 bp
    (default_rng(11)), past 2^31 positions, so in corpus blocks; (ii)
    the same candidates against 115,000 pieces of 1,000 bp cut from
    ebola175 at default_rng(12) offsets, each a genome, so P x nU passes
    2^31 and the probes go in blocks.  In each, the merged rows of the
    first 175 universes, re-keyed, must equal a scan of those universes
    alone, with their sizes and offsets."""
    import numpy as np

    searcher, pid, seqs, univ, off, _ = ebola175_scan()
    n_e = max(univ) + 1
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)

    def scan(sequences, seq_univ, chrom_off, n_universes):
        return scan_only(torch, si, profiling, device, searcher, pid,
                         sequences, seq_univ, chrom_off, n_universes)

    def check(what, dev, info, ref, n_universes):
        mk, ms, me = dev["merged"]
        u = mk % n_universes
        sel = u < n_e
        got = ((mk[sel] // n_universes) * n_e + u[sel], ms[sel], me[sel])
        for g, w in zip(got, ref["merged"]):
            if not torch.equal(g, w):
                fail(f"{what}: the rows of the first {n_e} universes differ "
                     "from their scan alone")
        if not (np.array_equal(dev["u_size_host"][:n_e], ref["u_size_host"])
                and np.array_equal(dev["offsets"][:n_e + 1], ref["offsets"])):
            fail(f"{what}: the first {n_e} universes' sizes or offsets differ")
        print(f"{what}: {info['bp']} bp, {info['blocks'][0]} probe blocks x "
              f"{info['blocks'][1]} corpus blocks, {info['pairs']} candidate "
              f"pairs, {dev['n_merged']} merged rows; wall {info['wall']:.3f} "
              f"s; peak allocated device memory {info['peak'] / 2**20:.1f} "
              f"MiB; the first {n_e} universes' {int(sel.sum())} rows equal "
              "their scan alone", flush=True)
        print_phases(profiling, ("scan",))

    # (i) corpus blocks
    t0 = time.time()
    rng = np.random.default_rng(11)
    bg = [bases[rng.integers(0, 4, size=BG_BP, dtype=np.uint8)].tobytes()
          .decode() for _ in range(BG_GENOMES)]
    print(f"background: {BG_GENOMES} genomes of {BG_BP} bp "
          f"({time.time() - t0:.1f} s to make)", flush=True)
    ref, ref_info = scan(seqs, univ, off, n_e)
    print(f"ebola175 alone: {ref_info['blocks']} blocks, {ref_info['pairs']} "
          f"candidate pairs, wall {ref_info['wall']:.3f} s", flush=True)
    dev, info = scan(seqs + bg, univ + list(range(n_e, n_e + BG_GENOMES)),
                     off + [0] * BG_GENOMES, n_e + BG_GENOMES)
    if info["blocks"][0] != 1 or info["blocks"][1] < 2:
        fail(f"(i): blocks {info['blocks']}, not 1 x 2 or more")
    check(f"phase 22 (i), ebola175 and {BG_GENOMES} x {BG_BP} bp", dev,
          info, ref, n_e + BG_GENOMES)
    del dev, bg
    torch.cuda.empty_cache()

    # (ii) probe blocks
    cat = "".join(seqs)
    offs = np.random.default_rng(12).integers(0, len(cat) - PIECE_BP,
                                              size=N_PIECES)
    pieces = [cat[o:o + PIECE_BP] for o in offs]
    if len(searcher.probes) * N_PIECES < si._BLOCK_PAIR_KEYS:
        fail("(ii): P x nU does not pass the probe blocks' key range")
    ref, _ = scan(pieces[:n_e], list(range(n_e)), [0] * n_e, n_e)
    dev, info = scan(pieces, list(range(N_PIECES)), [0] * N_PIECES,
                     N_PIECES)
    if info["blocks"][0] < 2 or info["blocks"][1] != 1:
        fail(f"(ii): blocks {info['blocks']}, not 2 or more x 1")
    check(f"phase 22 (ii), {N_PIECES} pieces of {PIECE_BP} bp", dev, info,
          ref, N_PIECES)
    del dev
    torch.cuda.empty_cache()


LONG_BP = 2_200_000_000   # phase 23: one chromosome past 2^31 positions
EDGE_WINDOW = 1_000_000   # phase 23: the reference scans edge +- this
EDGE_MARGIN = 10_000      # phase 23: rows compared keep this off its ends


def long_chromosome(torch, si, profiling, device):
    """Phase 23: one random chromosome of 2,200,000,000 bp
    (default_rng(13)), past 2^31 positions, so cut into pieces; scan only
    (scan_to_boundary_instance), ebola175's candidates, cover extension
    50.  An ebola175 genome is planted across each piece edge, its
    middle on the edge.  Near each edge, the merged rows must equal a
    scan of the chromosome's window edge +- 1,000,000 alone (one block),
    shifted by the window's start: every row that lies 10,000 bp or more
    inside the window, in both."""
    import numpy as np

    searcher, pid, seqs, _, _, _ = ebola175_scan()
    ext = 50
    lens = np.array([LONG_BP])
    layout = si.corpus_layout(searcher, lens)
    plan = si.plan_corpus_blocks(searcher, lens, layout, ext)
    if len(plan) < 2 or any(core is None for *_, core in plan):
        fail(f"phase 23: {LONG_BP} bp gave the blocks {plan}, not pieces")
    edges = [core[0] - int(layout[0]) for *_, core in plan[1:]]
    t0 = time.time()
    rng = np.random.default_rng(13)
    chrom = np.frombuffer(b"ACGT", dtype=np.uint8)[
        rng.integers(0, 4, size=LONG_BP, dtype=np.uint8)]
    for j, e in enumerate(edges):
        g = np.frombuffer(seqs[j].encode(), dtype=np.uint8)
        chrom[e - len(g) // 2:e - len(g) // 2 + len(g)] = g
    chrom = chrom.tobytes().decode()
    print(f"long chromosome: {LONG_BP} bp, {len(plan)} pieces, edges at "
          f"{edges} with ebola175 genomes {list(range(len(edges)))} "
          f"planted across them ({time.time() - t0:.1f} s to make)",
          flush=True)

    def scan(sequence):
        return scan_only(torch, si, profiling, device, searcher, pid,
                         [sequence], [0], [0], 1, ext)

    dev, info = scan(chrom)
    if info["blocks"] != (1, len(plan)):
        fail(f"phase 23: the scan ran in {info['blocks']} blocks, not "
             f"(1, {len(plan)})")
    print(f"phase 23, one chromosome of {LONG_BP} bp: {info['blocks'][1]} "
          f"pieces, {info['pairs']} candidate pairs, {dev['n_merged']} "
          f"merged rows; wall {info['wall']:.3f} s; peak allocated device "
          f"memory {info['peak'] / 2**20:.1f} MiB", flush=True)
    print_phases(profiling, ("scan",))
    mk, ms, me = dev["merged"]
    for e in edges:
        lo, hi = e - EDGE_WINDOW, e + EDGE_WINDOW
        ref, ref_info = scan(chrom[lo:hi])
        if ref_info["blocks"] != (1, 1):
            fail(f"phase 23: the window at {lo} took {ref_info['blocks']}")
        rk, rs, re_ = ref["merged"]
        rs, re_ = rs + lo, re_ + lo
        inner = (ms >= lo + EDGE_MARGIN) & (me <= hi - EDGE_MARGIN)
        ref_inner = (rs >= lo + EDGE_MARGIN) & (re_ <= hi - EDGE_MARGIN)
        got = (mk[inner], ms[inner], me[inner])
        want = (rk[ref_inner], rs[ref_inner], re_[ref_inner])
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            fail(f"phase 23: the rows near the edge at {e} differ from the "
                 "scan of its window alone")
        across = int(((got[1] < e) & (got[2] > e)).sum())
        if across == 0:
            fail(f"phase 23: no merged row crosses the edge at {e}")
        print(f"phase 23, edge at {e}: {int(inner.sum())} merged rows in "
              f"[{lo + EDGE_MARGIN}, {hi - EDGE_MARGIN}), {across} of them "
              f"across the edge, equal to the scan of [{lo}, {hi}) alone "
              f"({ref_info['pairs']} candidate pairs)", flush=True)
    del dev, mk, ms, me, chrom
    torch.cuda.empty_cache()


def fasta_in_order(path):
    """(header, sequence) records of a FASTA file in file order."""
    recs = []
    for line in open(path):
        line = line.strip()
        if line.startswith(">"):
            recs.append([line, ""])
        elif line:
            recs[-1][1] += line
    return [tuple(r) for r in recs]


# Phase 24 (i)'s design flags beside its input and output.
ADAPTER_FLAGS = ["-pl", "100", "-m", "2", "-l", "60", "-e", "50", "--device",
                 "cuda", "--add-adapters", "--add-reverse-complements"]


def host_modules(torch, si, profiling, in175):
    """Phase 24: the host filters, custom functions and design_naively
    against catch_tpu's goldens (module docstring)."""
    flags = ADAPTER_FLAGS
    span_kernels = ["expand_join", "verify_spans"]

    # (i) adapters and reverse complements.
    out1 = os.path.join(WORK, "ebola175_m2_adapters_rc.fasta")
    span_log = []
    with span_calls(torch, span_log):
        _, wall, launches, peak = counted(torch, si, profiling,
                                          lambda: design([in175, "-o", out1]
                                                         + flags))
    if not same_bytes(out1, os.path.join(GOLDEN,
                                         "ebola175_m2_adapters_rc.fasta")):
        fail("phase 24 (i): the adapter and rc design differs from "
             "ebola175_m2_adapters_rc.fasta")
    forward = [(h, s) for h, s in fasta_in_order(out1)
               if h.endswith("| from target sequence")]
    plain = {s for _, s in fasta_records(
        os.path.join(GOLDEN, "torch_ebola175_m2.fasta"))}
    if {s[20:-20] for _, s in forward} != plain or \
            2 * len(forward) != len(fasta_in_order(out1)):
        fail("phase 24 (i): without adapters and reverse complements the "
             "probes are not torch_ebola175_m2.fasta's")
    print(f"phase 24 (i), ebola175 m2 with adapters and reverse "
          f"complements: {2 * len(forward)} probes, equal to golden; "
          f"without them equal to torch_ebola175_m2.fasta; wall {wall:.3f} "
          f"s; peak allocated device memory {peak / 2**20:.1f} MiB",
          flush=True)
    print_phases(profiling, ("candidate", "filter", "set_cover", "scan",
                             "span"))
    print("launches of the adapter votes: " + ", ".join(
        f"{k} {launches[k]}" for k in span_kernels), flush=True)
    print(f"launches in the adapter design: {launches}", flush=True)
    require_launched(launches, span_kernels, "the adapter votes")
    require_launched(launches, DESIGN_KERNELS, "the adapter design")
    span_totals("phase 24 (i) adapter-vote span totals", span_log, launches)

    # (ii) the same design re-processed without its set cover.
    keep = os.path.join(WORK, "ebola175_m2_forward.fasta")
    with open(keep, "w") as f:
        for h, s in forward:
            f.write(f"{h}\n{s[20:-20]}\n")
    out2 = os.path.join(WORK, "ebola175_m2_skip_set_cover.fasta")
    _, wall, launches, _ = counted(torch, si, profiling, lambda: design(
        [in175, "-o", out2, "--filter-from-fasta", keep,
         "--skip-set-cover"] + flags))
    if fasta_records(out2) != fasta_records(out1):
        fail("phase 24 (ii): --filter-from-fasta --skip-set-cover differs "
             "from (i)")
    if any(launches[k] for k in DESIGN_KERNELS):
        fail(f"phase 24 (ii): a design-scan kernel launched without the "
             f"set cover: {launches}")
    require_launched(launches, span_kernels, "the adapter votes of (ii)")
    print(f"phase 24 (ii), --filter-from-fasta --skip-set-cover: the "
          f"records of (i); wall {wall:.3f} s; launches of the adapter "
          "votes: " + ", ".join(f"{k} {launches[k]}" for k in span_kernels),
          flush=True)
    print_phases(profiling, ("filter",))

    # (iii) a custom hybridization function, on the host.
    out3 = os.path.join(WORK, "ebola5_custom_fn.fasta")
    pb, wall, launches, _ = counted(torch, si, profiling, lambda: design(
        [write_subset(5), "-o", out3, "-pl", "100",
         "--custom-hybridization-fn", write_custom_fn(), CUSTOM_FN_NAME,
         "--device", "cuda"]))
    if not same_bytes(out3, os.path.join(GOLDEN, "ebola5_custom_fn.fasta")):
        fail("phase 24 (iii): the custom-function design differs from "
             "ebola5_custom_fn.fasta")
    if any(launches.values()):
        fail(f"phase 24 (iii): the custom model launched kernels: "
             f"{launches}")
    stats = pb.filters[-1].last_run_stats
    print(f"phase 24 (iii), ebola5 with --custom-hybridization-fn: "
          f"{len(pb.final_probes)} probes, equal to golden; no kernel "
          f"launched; wall {wall:.3f} s; {stats['candidates_evaluated']} "
          f"candidates; scan {stats['scan_seconds']:.3f} s, solve "
          f"{stats['solve_seconds']:.3f} s", flush=True)

    # (iv) design_naively, in a child process (naive_command).
    for flag in ("-nrf", "-dsf"):
        argv, env = naive_command("catch_tpu_torch", [
            "ebola5.fasta", flag, "2", "60", "--print-analysis", "--device",
            "cuda"])
        t0 = time.time()
        p = subprocess.run(argv, env=env, cwd=WORK, capture_output=True,
                           text=True, timeout=300)
        wall = time.time() - t0
        if p.returncode != 0:
            fail(f"phase 24 (iv): design_naively {flag} exited "
                 f"{p.returncode}: {p.stderr}")
        name = f"ebola5_naive_{flag[1:]}_2_60.txt"
        with open(os.path.join(GOLDEN, name)) as f:
            if p.stdout != f.read():
                fail(f"phase 24 (iv): design_naively {flag} 2 60 differs "
                     f"from {name}")
        print(f"phase 24 (iv), design_naively {flag} 2 60: "
              f"{p.stdout.splitlines()[0]}, table equal to golden; wall "
              f"{wall:.3f} s (a child process)", flush=True)


# Phase 25 (i): the trace regions (catch_tpu_torch/utils/profiling.py
# maybe_trace), and for each the kernels its trace must hold: wrapper ->
# strings of the __global__ names of its kernels in catch_tpu_torch/csrc/
# (K3 and K6 share csrc/verify_windows.cu's kernels: their job types
# tell them apart), one of which must appear.
TRACE_REGIONS = ("scan_instance", "set_cover_solve", "cover_scan_join",
                 "cover_scan_verify")
TRACE_KERNELS = {
    "scan_instance": {
        "rolling_hash": ("rolling_hash_kernel",),
        "lookup_expand": ("le_merge_kernel",),
        "verify_windows": ("VwParams",),
        "segmented_merge": ("sm_bounds_kernel", "sm_hist_kernel",
                            "sm_warp_kernel", "sm_block_kernel",
                            "sm_device_kernel", "sm_emit_kernel")},
    "set_cover_solve": {"greedy_v2": ("ct_pair_new_kernel",
                                      "ct_group_score_kernel",
                                      "k12_update_kernel")},
    "cover_scan_verify": {"verify_spans": ("VsParams",)},
}


def trace_files(root):
    """{region: [trace files]} under root."""
    return {r: sorted(os.listdir(os.path.join(root, r)))
            for r in sorted(os.listdir(root))} if os.path.isdir(root) else {}


def region_trace(path, region):
    """Of the record_function(region) span of a trace: (kernel names,
    kernels, kernel launches, seconds, start ts).  The launches are those
    made inside the span, the kernels those correlated with them (the
    capture's warm-up launches come before the span)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("name") == region
             and e.get("cat") == "user_annotation" and e.get("ph") == "X"]
    if not spans:
        fail(f"phase 25: the {region} trace holds no {region} event")
    span = max(spans, key=lambda e: e["dur"])
    a0, a1 = span["ts"], span["ts"] + span["dur"]
    inside = {e["args"]["correlation"] for e in events
              if e.get("cat") == "cuda_runtime"
              and "LaunchKernel" in e.get("name", "") and a0 <= e["ts"] <= a1}
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"
               and e.get("args", {}).get("correlation") in inside]
    return set(kernels), len(kernels), len(inside), span["dur"] / 1e6, a0


def traced_regions(torch, si, profiling, in175):
    """Phase 25 (i): ebola175 m2 with the device solver, without and
    with CATCH_TPU_PROFILE_DIR, then the analysis and a second design
    with it: the outputs equal their goldens, each region has one trace
    holding its kernels, and the second design adds none."""
    import shutil

    root = os.path.join(WORK, "traces")
    shutil.rmtree(root, ignore_errors=True)
    golden = os.path.join(GOLDEN, "torch_ebola175_m2.fasta")
    walls = {}

    def design175(tag):
        out = os.path.join(WORK, f"ebola175_m2_{tag}.fasta")
        _, walls[tag], launches, _ = counted(
            torch, si, profiling, lambda: design(
                [in175, "-o", out, "-pl", "100", "-m", "2", "-l", "60",
                 "-e", "50", "--device", "cuda"]))
        if not same_bytes(out, golden):
            fail(f"phase 25: ebola175 m2 ({tag}) differs from "
                 "torch_ebola175_m2.fasta")
        require_launched(launches, ["greedy_v2"], f"the {tag} design")

    with solve_on_device():
        with environ("CATCH_TPU_PROFILE_DIR", None):
            design175("untraced")
        with environ("CATCH_TPU_PROFILE_DIR", root):
            design175("traced")
            _, walls["analysis"], _, _ = counted(
                torch, si, profiling, lambda: ebola175_analysis(in175))
            first = trace_files(root)
            design175("again")
    if trace_files(root) != first:
        fail(f"phase 25: the second design added a trace: {first} -> "
             f"{trace_files(root)}")
    if sorted(first) != sorted(TRACE_REGIONS) or any(
            len(v) != 1 for v in first.values()):
        fail(f"phase 25: not one trace a region: {first}")
    print(f"phase 25 (i): ebola175 m2 with the device solver, equal to "
          f"golden each time: wall {walls['untraced']:.3f} s without "
          f"CATCH_TPU_PROFILE_DIR, {walls['traced']:.3f} s with it (the "
          f"first run: two captures and their export), "
          f"{walls['again']:.3f} s a second time with it (no capture); "
          f"the analysis with it {walls['analysis']:.3f} s, TSVs equal to "
          f"goldens; one trace a region: {first}", flush=True)
    for region in TRACE_REGIONS:
        path = os.path.join(root, region, first[region][0])
        kernels, n_kernels, n_launches, region_s, start = region_trace(
            path, region)
        if n_kernels != n_launches:
            fail(f"phase 25: the {region} trace holds {n_kernels} kernels "
                 f"of {n_launches} launches")
        for wrapper, syms in TRACE_KERNELS.get(region, {}).items():
            if not any(sym in k for sym in syms for k in kernels):
                fail(f"phase 25: the {region} trace holds no kernel of "
                     f"{wrapper} ({syms}); it holds {sorted(kernels)}")
        n_ev, busy, by_kind = device_busy(path, since=start)
        kinds = ", ".join(f"{k} {v:.6f} s" for k, v in sorted(
            by_kind.items()))
        print(f"  trace {region}: {os.path.getsize(path)} bytes; region "
              f"{region_s:.6f} s; {n_kernels} kernels of its {n_launches} "
              f"launches, {len(kernels)} names; from its start {n_ev} "
              f"device events, the card busy {busy:.6f} s, "
              f"{100 * busy / region_s:.4f}% of the region ({kinds}); "
              f"kernels required: "
              f"{sorted(TRACE_KERNELS.get(region, {})) or 'none'}",
              flush=True)


def pool_runs():
    """Phase 25 (ii): catch_tpu_torch's cli/pool.py on the three golden
    cases, in three child processes at once (pool_command); each TSV must
    equal its golden."""
    import numpy
    import scipy

    print(f"phase 25 (ii): numpy {numpy.__version__}, scipy "
          f"{scipy.__version__}", flush=True)
    procs = []
    try:
        for name, before, after in pool_cases():
            out = os.path.join(WORK, name)
            argv, env = pool_command("catch_tpu_torch",
                                     before + [out] + after)
            procs.append((name, out, time.time(), subprocess.Popen(
                argv, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)))
        for name, out, t0, p in procs:
            stdout, stderr = p.communicate(timeout=240)
            wall = time.time() - t0
            if p.returncode != 0:
                fail(f"phase 25 (ii): the pool CLI for {name} exited "
                     f"{p.returncode}: {stderr[-2000:]}")
            if not same_bytes(out, os.path.join(GOLDEN, name)):
                fail(f"phase 25 (ii): the pool CLI's TSV differs from "
                     f"{name}; it printed {stdout!r}")
            print(f"  pool {name}: TSV equal to golden; "
                  f"{'; '.join(stdout.splitlines())}; wall {wall:.3f} s "
                  "(a child process, three at once)", flush=True)
    finally:
        for _, _, _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


# Phase 26: one rank of two on the card.  argv: the work directory, the
# ebola175 FASTA.  Writes <work>/ranks/rank<r>.json.
RANK_SCRIPT = r"""
import json, os, pickle, runpy, statistics, sys, time
import numpy as np
import torch
from catch_tpu_torch.parallel import distributed
work, in175 = sys.argv[1], sys.argv[2]
golden = os.path.join("tests", "data", "golden")
if not distributed.maybe_initialize():
    sys.exit("no process group was initialized")
rank = distributed.process_index()
from catch_tpu_torch.ops import scan_instance as si
from catch_tpu_torch.ops import scan_sparse
from catch_tpu_torch.ops import set_cover as sct
from catch_tpu_torch.parallel import distributed as dd
from catch_tpu_torch.parallel import make_mesh
from catch_tpu_torch.parallel import set_cover as psc
from catch_tpu_torch.utils import profiling


def cli(argv):
    sys.argv = ["design"] + argv + ["--device", "cuda", "--num-devices", "4"]
    runpy.run_module("catch_tpu_torch.cli.design", run_name="__main__")


res = dict(rank=rank, wall={}, span_verify={})
gathers = []
gather = dd.all_gather_rows
dd.all_gather_rows = lambda *a: (gathers.append(1), gather(*a))[1]
si.reset_launches()
t0 = time.time()
cli([in175, "-o", os.path.join(work, f"ebola175_m2_rank{rank}.fasta"),
     "-pl", "100", "-m", "2", "-l", "60", "-e", "50"])
torch.cuda.synchronize()
res["wall"]["ebola175 m2"] = time.time() - t0
for name, argv in (
        ("identify", ["identify_a.fasta", "identify_b.fasta", "-i", "-c",
                      "0.5"]),
        ("avoid", ["avoid_target.fasta", "--avoid-genomes",
                   "avoid_bg.fasta"])):
    profiling.reset_phases()
    t0 = time.time()
    cli([os.path.join(golden, a) if a.endswith(".fasta") else a
         for a in argv] + ["-o", os.path.join(work, f"{name}_m0_rank{rank}"
                           ".fasta"), "-pl", "60", "-ps", "30", "-m", "0",
                           "-e", "0"])
    torch.cuda.synchronize()
    res["wall"][name] = time.time() - t0
    res["span_verify"][name] = profiling.phase_seconds.get("span:verify", 0)
res["design_launches"] = {n: f.launches for n, f in si.KERNELS.items()}
res["span_exchanges"] = len(gathers)

with open(os.path.join(work, "ebola175_instance.pkl"), "rb") as f:
    inst, want = pickle.load(f)
mesh = make_mesh(4, "cuda")
si.reset_launches()
e0 = psc.greedy_steps_sharded.exchanges
torch.cuda.synchronize()
t0 = time.time()
order = psc.solve_instance_sharded(inst, mesh=mesh)
torch.cuda.synchronize()
res["wall"]["solve_instance_sharded"] = time.time() - t0
res["solve_equal"] = bool(np.array_equal(order, want))
res["solve_picks"] = len(order)
res["solve_exchanges"] = psc.greedy_steps_sharded.exchanges - e0
res["solve_launches"] = {n: f.launches for n, f in si.KERNELS.items()}

# one 64-step dispatch from the start, against the twin across the ranks
n = sct._STEPS_PER_DISPATCH
part = psc.place_partition(psc.partition_instance(inst, 4),
                           inst.can_uncover, mesh)
consts, u_size = sct._instance_consts(inst, mesh.lead)
states0 = psc.initial_states(sct.init_covered(
    consts["ivl_start"], consts["ivl_end"], inst.u_len), u_size, part)


def clone():
    return [{k: v.clone() for k, v in s.items()} for s in states0]


got = psc.greedy_steps_sharded(clone(), part, n)
twin = psc._greedy_steps_sharded_plain(clone(), part, n)
torch.cuda.synchronize()
res["k18_equal"] = all(torch.equal(g[k], w[k])
                       for g, w in zip(got, twin) for k in g)
times = []
for _ in range(5):
    states = clone()
    torch.cuda.synchronize()
    e0 = psc.greedy_steps_sharded.exchanges
    t0 = time.time()
    psc.greedy_steps_sharded(states, part, n)
    torch.cuda.synchronize()
    times.append(1e3 * (time.time() - t0))
    res["k18_exchanges"] = psc.greedy_steps_sharded.exchanges - e0
res["k18_ms"] = [statistics.median(times), min(times), max(times)]
res["k18_steps"] = n
with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
    json.dump(res, f)
"""
RANK_PLACES = 2


def run_two_ranks(script, args, timeout):
    """`script` (Python source) in two processes on the card, each with
    `args`, joined by a gloo group on 127.0.0.1 with RANK_PLACES virtual
    places each; every rank is killed when one fails or the time runs
    out, and the failure prints each rank's stderr tail (kept in
    build/chip_smoke/ranks/)."""
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    logs = os.path.join(WORK, "ranks")
    os.makedirs(logs, exist_ok=True)
    procs = []
    for rank in range(2):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("CATCH_TPU_")}
        env.update(CATCH_TPU_COORDINATOR=f"127.0.0.1:{port}",
                   CATCH_TPU_NUM_PROCESSES="2", CATCH_TPU_PROCESS_ID=str(rank),
                   CATCH_TPU_VIRTUAL_DEVICES=str(RANK_PLACES),
                   OMP_NUM_THREADS="4", PYTHONPATH=ROOT)
        with open(os.path.join(logs, f"rank{rank}.err"), "w") as err:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", script] + args, cwd=ROOT,
                env=env, stdout=subprocess.DEVNULL, stderr=err))
    deadline = time.time() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if time.time() > deadline or any(p.returncode for p in procs):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    codes = [p.returncode for p in procs]
    if any(codes):
        for rank in range(2):
            with open(os.path.join(logs, f"rank{rank}.err")) as f:
                print(f"rank {rank} (exit {codes[rank]}) stderr tail:\n"
                      f"{f.read()[-3000:]}", file=sys.stderr, flush=True)
        fail(f"the two ranks exited with {codes} (timeout {timeout} s)")


def two_ranks(card, inst175, want175, k18_row):
    """Phase 26: two ranks on the one card, two virtual places each (a
    mesh of 4 across processes): ebola175 m2, the identify and avoid
    goldens through the CLI with --num-devices 4 in both ranks (each
    rank writes its own output), then solve_instance_sharded on
    ebola175's instance and one 64-step K18 dispatch across the ranks
    against the twin across the ranks.  `k18_row`: phase 20's
    greedy_sharded row (one process, 4 places, ebola175's instance)."""
    import pickle

    mode = run(["nvidia-smi", "--query-gpu=compute_mode",
                "--format=csv,noheader"]).splitlines()[0].strip()
    print(f"compute mode: {mode}", flush=True)
    if "exclusive" in mode.lower():
        fail(f"the card's compute mode is {mode}: two ranks cannot share it")
    work = os.path.join(WORK, "ranks")
    os.makedirs(work, exist_ok=True)
    for name in os.listdir(work):
        os.remove(os.path.join(work, name))
    with open(os.path.join(work, "ebola175_instance.pkl"), "wb") as f:
        pickle.dump((inst175, want175), f)
    t0 = time.time()
    run_two_ranks(RANK_SCRIPT, [work, write_subset(175)], timeout=300)
    wall = time.time() - t0
    results = []
    for rank in range(2):
        with open(os.path.join(work, f"rank{rank}.json")) as f:
            results.append(json.load(f))
        out = os.path.join(work, f"ebola175_m2_rank{rank}.fasta")
        if not same_bytes(out, os.path.join(GOLDEN,
                                            "torch_ebola175_m2.fasta")):
            fail(f"ebola175 m2 in rank {rank} of 2 differs from "
                 "torch_ebola175_m2.fasta")
        for name in ("identify", "avoid"):
            out = os.path.join(work, f"{name}_m0_rank{rank}.fasta")
            if fasta_records(out) != fasta_records(
                    os.path.join(GOLDEN, f"ref_{name}_m0.fasta")):
                fail(f"{name} m0 in rank {rank} of 2 differs from its "
                     "golden")
    for r in results:
        what = f"rank {r['rank']} of 2"
        if not r["solve_equal"]:
            fail(f"{what}: solve_instance_sharded's pick order differs from "
                 "the host lazy solver's")
        if not r["k18_equal"]:
            fail(f"{what}: greedy_sharded across the ranks differs from its "
                 "twin across the ranks")
        require_launched(r["design_launches"], ["verify_spans_sharded"]
                         + PLACE_KERNELS, f"the designs in {what}")
        require_launched(r["solve_launches"], ["init_covered",
                                               "greedy_sharded"],
                         f"the sharded solve in {what}")
        walls = "; ".join(f"{k} {v:.3f} s" for k, v in r["wall"].items())
        print(f"{what} ({RANK_PLACES} places of 4): ebola175 m2, identify "
              f"and avoid equal to their goldens; solve_instance_sharded "
              f"{r['solve_picks']} picks, equal to the host's; wall: "
              f"{walls}; {card}", flush=True)
        ms, lo, hi = r["k18_ms"]
        n = r["k18_steps"]
        print(f"{what}: greedy_sharded across 2 ranks, one {n}-step "
              f"dispatch of ebola175's instance at 4 places: {ms:.3f} ms "
              f"[{lo:.3f}, {hi:.3f}] (host clock to a synchronised end), "
              f"{ms / n:.4f} ms a step; one process at 4 places (phase 20, "
              f"CUDA events): {k18_row['ms']:.3f} ms; exchanges in the "
              f"dispatch: {r['k18_exchanges']} ({r['k18_exchanges'] / n:.4f} "
              f"a step: 2 a step and 1 a call); in the solve: "
              f"{r['solve_exchanges']}; {card}", flush=True)
        sv = "; ".join(f"{k} {v:.4f} s" for k, v in r["span_verify"].items())
        print(f"{what}: the span scans' verify (phase span:verify, the "
              f"exchange included): {sv}; {r['span_exchanges']} exchanges "
              f"in the designs (2 a span scan); {card}", flush=True)
        print(f"launches in {what}: designs {r['design_launches']}; solve "
              f"{r['solve_launches']}", flush=True)
    print(f"two ranks: {wall:.1f} s from start to exit", flush=True)

# Phase 27's taxid and API key.
NCBI_TAXID = "186538"
NCBI_KEY = "CHIPSMOKEKEY"


def ncbi_download(torch, si, profiling):
    """Phase 27: ebola175 m2 named as download:NCBI_TAXID, with the tests'
    fake NCBI (tests/torch_fake_ncbi.py: the first 175 fixture records
    as the taxid's neighbors table, efetch batches in the order asked,
    any other URL an error) in place of urllib.request.urlopen: (i) the
    design CLI with --write-taxid-acc and --ncbi-api-key, counting
    launches; its FASTA must equal the design of the records in the
    order served, the accession file must hold the 175 accessions
    sorted, and the URLs must be one neighbors request and two efetch
    batches (100 + 75), each with the key; (ii) the analysis CLI on
    download:NCBI_TAXID with torch_ebola175_m2.fasta's probes: its three
    outputs must equal those of the served order's FASTA, the group's
    name aside."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_fake_ncbi import NEIGHBORS, FakeNCBI, read_records, write_fasta
    from catch_tpu_torch.cli import analyze_probe_coverage as analyze
    from catch_tpu_torch.utils import ncbi_neighbors

    records = read_records(FIXTURE, 175)
    fake = FakeNCBI(records, taxid=NCBI_TAXID)
    work = os.path.join(WORK, "ncbi")
    os.makedirs(work, exist_ok=True)
    for name in os.listdir(work):
        os.remove(os.path.join(work, name))
    flags = ["-pl", "100", "-m", "2", "-l", "60", "-e", "50", "--device",
             "cuda"]
    real_urlopen = urllib.request.urlopen
    fake.install()
    try:
        out = os.path.join(work, "download.fasta")
        pb, wall, launches, _ = counted(torch, si, profiling, lambda: design(
            ["download:" + NCBI_TAXID, "-o", out, "--write-taxid-acc", work,
             "--ncbi-api-key", NCBI_KEY] + flags))
        require_launched(launches, DESIGN_KERNELS,
                         "the design of download:" + NCBI_TAXID)
        urls = list(fake.urls)
        sizes = [len(urllib.parse.parse_qs(u.partition("?")[2])["id"][0]
                     .split(",")) for u in urls[1:]]
        if (len(urls) != 3 or not urls[0].startswith(NEIGHBORS)
                or sizes != [100, 75]
                or not all(f"api_key={NCBI_KEY}" in u for u in urls)):
            fail(f"phase 27: the URLs asked for were {urls}")
        with open(os.path.join(work, NCBI_TAXID + ".txt")) as f:
            if f.read().split() != sorted(fake.order):
                fail("phase 27: the accession file does not hold the 175 "
                     "accessions, sorted")
        served = write_fasta(os.path.join(work, "served.fasta"),
                             fake.served_records())
        same = os.path.join(work, "served_design.fasta")
        design([served, "-o", same] + flags)
        if not same_bytes(out, same):
            fail("phase 27: the design of download:" + NCBI_TAXID
                 + " differs from that of the served order's FASTA")
        n_served = len(fake.served)
        print(f"download:{NCBI_TAXID} m2: {len(pb.final_probes)} probes, "
              f"equal to the design of the served order's FASTA "
              f"({len(fasta_records(same))} probes); wall {wall:.3f} s; "
              f"{len(urls)} URLs (efetch batches {sizes}, each with the "
              f"key); served order starts {fake.served[:3]}", flush=True)
        print(f"launches in the download design: {launches}", flush=True)

        outputs = {}
        for what, dataset in (("download", "download:" + NCBI_TAXID),
                              ("fasta", None)):
            if dataset is None:
                dataset = write_fasta(
                    os.path.join(work, "served_analysis.fasta"),
                    fake.served_records()[n_served:])
            files = [os.path.join(work, f"{what}_{k}.tsv")
                     for k in ("analysis", "windows", "map_counts")]
            analyze.main(analyze.init_and_parse_args([
                "-d", dataset, "-f",
                os.path.join(GOLDEN, "torch_ebola175_m2.fasta"),
                "-m", "2", "-l", "60", "-e", "50",
                "--write-analysis-to-tsv", files[0],
                "--write-sliding-window-coverage", files[1],
                "--write-probe-map-counts-to-tsv", files[2],
                "--device", "cuda"]))
            outputs[what] = []
            for path in files:
                with open(path) as f:
                    outputs[what].append(f.read())
        named = [t.replace(f"taxid:{NCBI_TAXID}, genome",
                           "served_analysis.fasta, genome")
                 for t in outputs["download"]]
        if named != outputs["fasta"]:
            fail("phase 27: the analysis of download:" + NCBI_TAXID
                 + " differs from that of the served order's FASTA")
        if f"taxid:{NCBI_TAXID}, genome 174" not in outputs["download"][0]:
            fail("phase 27: the analysis does not name the group taxid:"
                 + NCBI_TAXID)
        print(f"download:{NCBI_TAXID} analysis: the three outputs equal "
              "those of the served order's FASTA, the group's name aside; "
              f"{len(fake.urls) - len(urls)} URLs", flush=True)
    finally:
        urllib.request.urlopen = real_urlopen
        ncbi_neighbors.ncbi_api_key = None


def main():
    if not os.path.isdir(os.path.join(ROOT, "catch_tpu_torch")):
        fail("catch_tpu_torch/ is not beside chip_smoke.py; run it from the "
             "root of a checkout")
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda is not available")
    os.makedirs(WORK, exist_ok=True)
    device = torch.device("cuda", 0)
    clock = PhaseClock()

    # Phase 1: the card and the toolchain.
    card = run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}", flush=True)
    from catch_tpu_torch import _build
    print(run([_build._nvcc(), "--version"]).splitlines()[-1], flush=True)
    try:
        import triton
        print(f"triton {triton.__version__}", flush=True)
    except ImportError:
        print("triton: not installed", flush=True)
    clock.done(1)

    # Phase 2: build.
    t0 = time.time()
    _build.library()
    print(f"kernel build: {time.time() - t0:.1f} s "
          f"(nvcc {_build.build_seconds:.1f} s)", flush=True)
    clock.done(2)

    # Phase 3: the design kernels against their twins.
    rows = check_kernels(torch, device)
    clock.done(3)

    from catch_tpu_torch.ops import scan_instance as si
    # Importing scan_sparse registers its kernels in si.KERNELS.
    from catch_tpu_torch.ops import scan_sparse  # noqa: F401
    from catch_tpu_torch.utils import profiling

    # Phase 4: ebola5 m0 (the verify fast path).
    out5 = os.path.join(WORK, "ebola5_m0.fasta")
    design([write_subset(5), "-o", out5, "-pl", "100", "-m", "0", "-e", "0",
            "--device", "cuda"])
    if fasta_records(out5) != fasta_records(
            os.path.join(GOLDEN, "ref_ebola5_m0.fasta")):
        fail("ebola5 m0 probe set differs from ref_ebola5_m0.fasta")
    print(f"ebola5 m0: {len(fasta_records(out5))} probes, equal to golden",
          flush=True)
    clock.done(4)

    # Phase 5: ebola175 m2 through the CLI, counting launches.
    design_kernels = [r["name"] for r in rows]
    out175 = os.path.join(WORK, "ebola175_m2.fasta")
    in175 = write_subset(175)
    pb, wall, launches, peak = counted(torch, si, profiling, lambda: design(
        [in175, "-o", out175, "-pl", "100", "-m", "2", "-l", "60", "-e",
         "50", "--device", "cuda"]))
    with open(out175, "rb") as a, open(
            os.path.join(GOLDEN, "torch_ebola175_m2.fasta"), "rb") as b:
        if a.read() != b.read():
            fail("ebola175 m2 output differs from torch_ebola175_m2.fasta")
    stats = pb.filters[-1].last_run_stats
    print(f"ebola175 m2: {len(pb.final_probes)} probes, equal to golden; "
          f"wall {wall:.3f} s; {stats['candidates_evaluated']} candidates; "
          f"{stats['set_cover_picks']} picks; peak allocated device memory "
          f"{peak / 2**20:.1f} MiB", flush=True)
    stats5 = (stats["candidates_evaluated"], stats["set_cover_picks"])
    print_phases(profiling, ("candidate", "filter", "set_cover", "scan"))
    print(f"launches in the ebola175 run: {launches}", flush=True)
    require_launched(launches, design_kernels, "the ebola175 design")
    for r in rows:
        r["launches"] = launches[r["name"]]
    clock.done(5)

    # Phase 6: the span kernels against their twins at the avoid shapes.
    genomes8, cands, scf, bg = avoid_setup(device)
    span_inputs, span_rows = check_span_kernels(torch, device, scf, cands,
                                                bg)
    clock.done(6)

    # Phase 7: the identify and avoid goldens through the CLI.
    identify_avoid_goldens()
    clock.done(7)

    # Phase 8: the avoid scan at real size, counting launches.
    want, n_flagged = expected_ranks(len(cands))
    tiers = []   # a few ms of the wall: the inputs are not kept
    span_log = []
    with recording(si, "_segmented_merge_cuda", lambda args, kwargs, res:
                   tiers.append((int(args[0].numel()),
                                 si.merge_tiers(*args[:3])))), \
            span_calls(torch, span_log):
        ranks, wall, launches, peak = counted(
            torch, si, profiling, lambda: scf._make_ranks(cands, [genomes8]))
    if not (ranks == want).all():
        fail("avoid ranks differ from avoid100m_ranks.tsv")
    for i, (n, t) in enumerate(tiers):
        print(f"segmented_merge tiers, avoid call {i + 1} of {len(tiers)}: "
              f"{n} rows, {t}", flush=True)
    print(f"avoid 100 Mbp: ranks equal to golden ({len(cands)} candidates, "
          f"{n_flagged} flagged); wall {wall:.3f} s; "
          f"{2 * AVOID_BG_BP / wall:.0f} bp/s over both strands; peak "
          f"allocated device memory {peak / 2**20:.1f} MiB", flush=True)
    print_phases(profiling, ("span",))
    print(f"launches in the avoid scan: {launches}", flush=True)
    require_launched(launches, ["expand_join", "verify_spans",
                                "segmented_merge"], "the avoid scan")
    span_totals("avoid 100 Mbp span totals", span_log, launches)
    for r in span_rows:
        r["launches"] = launches[r["name"]]
    avoid_ref = (wall, peak)
    clock.done(8)

    # Phase 9: coverage analysis of ebola175 through the CLI.
    span_log = []
    with span_calls(torch, span_log):
        _, wall, launches, peak = counted(torch, si, profiling,
                                          lambda: ebola175_analysis(in175))
    print(f"ebola175 analysis: both TSVs equal to goldens; wall {wall:.3f} s;"
          f" peak allocated device memory {peak / 2**20:.1f} MiB",
          flush=True)
    print_phases(profiling, ("span",))
    print(f"launches in the analysis: {launches}", flush=True)
    require_launched(launches, ["expand_join", "verify_spans"],
                     "the analysis")
    span_totals("ebola175 analysis span totals", span_log, launches)
    clock.done(9)
    rows += span_rows

    # Importing the clustering registers the MinHash kernels.
    from catch_tpu_torch.utils import cluster  # noqa: F401

    # Phase 10: design_large on flu2000.
    run_design_large(torch, si, profiling, 2000, "flu2000")
    clock.done(10)

    # Phase 11: design_large on flu10k, keeping kernel inputs.
    launches, kept = run_design_large(torch, si, profiling, 10000, "flu10k",
                                      profile=True)
    clock.done(11)

    # Phase 12: the all-pairs methods on the 51 Mbp scale corpus.
    scale = cluster_scale(torch, si, profiling, device)
    clock.done(12)

    # Phase 13: the MinHash kernels against their twins.
    mh_rows = check_minhash_kernels(torch, si, kept,
                                    scale["minhash_dists"][1],
                                    kept["sigs"][:FLU_ALL_PAIRS])
    for r in mh_rows:
        r["launches"] = (scale[r["name"]][0] if r["name"] in scale
                         else launches[r["name"]])
    rows += mh_rows
    clock.done(13)

    # Phase 14: ebola175 m2 and the rank goldens with the device solver.
    solver_launches, dev175 = device_solve_design(torch, si, profiling, in175)
    clock.done(14)

    # Phase 15: the four solvers on bench.py's solver instance.
    inst, want_bench, k13_launches = solver_bench(torch, si, profiling,
                                                  device)
    clock.done(15)

    # Phase 16: the solver kernels against their twins.
    for r in check_solver_kernels(torch, device, dev175, inst):
        r["launches"] = (k13_launches if r["name"] == "greedy_v1"
                         else solver_launches)[r["name"]]
        rows.append(r)
    clock.done(16)

    # Importing the sharded solver registers its kernel.
    from catch_tpu_torch.ops import set_cover as sct
    from catch_tpu_torch.parallel import set_cover  # noqa: F401

    # Phase 17: ebola175 m2 on four places, both solver routes.
    inst175, mesh_scan_launches = mesh_design(torch, si, profiling, in175,
                                              stats5)
    clock.done(17)

    # Phase 18: the span scan on four places.
    span_launches = mesh_span_scan(torch, si, profiling, device, cands,
                                   genomes8, bg, avoid_ref)
    clock.done(18)

    # Phase 19: the sharded solver at 1, 2, 4 and 8 places.
    t0 = time.time()
    want175 = sct._solve_host_lazy(inst175)
    print(f"ebola175 instance: {inst175.n_sets} sets, {inst175.u_len} "
          f"positions, {len(inst175.ivl_start)} intervals, "
          f"{len(inst175.set_of_pair)} pairs; host lazy solver "
          f"{len(want175)} picks in {time.time() - t0:.3f} s", flush=True)
    instances = [("solver instance", inst, want_bench),
                 ("ebola175 instance", inst175, want175)]
    mesh_launches = sharded_solver_bench(torch, si, profiling, device,
                                         instances)
    clock.done(19)

    # Phase 20: the mesh's kernels against their twins.
    for r in check_mesh_kernels(torch, device, instances, span_inputs):
        r["launches"] = {"greedy_sharded": mesh_launches,
                         "verify_spans_sharded": span_launches,
                         "dedup_pairs": mesh_scan_launches}[r["name"]][
                             r["name"]]
        rows.append(r)
    clock.done(20)

    # Phase 21: ebola175 m2 in blocks, both solver routes and the limits.
    blocked_design(torch, si, profiling, in175, stats5)
    clock.done(21)

    # Phase 22: the splits at real size, scan only.
    blocked_scans(torch, si, profiling, device)
    clock.done(22)

    # Phase 23: one chromosome longer than a corpus block, scan only.
    long_chromosome(torch, si, profiling, device)
    clock.done(23)

    # Phase 24: the host filters, custom functions and design_naively.
    host_modules(torch, si, profiling, in175)
    clock.done(24)

    # Phase 25: the four trace regions, and the pool CLI.
    traced_regions(torch, si, profiling, in175)
    pool_runs()
    clock.done(25)

    # Phase 26: two ranks on the card.
    two_ranks(card, inst175, want175,
              next(r for r in rows if r["name"] == "greedy_sharded"))
    clock.done(26)

    # Phase 27: ebola175 m2 from a download: dataset, with a fake NCBI.
    ncbi_download(torch, si, profiling)
    clock.done(27)

    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
