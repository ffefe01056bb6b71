#!/usr/bin/env python3
"""Make the span-scan goldens with catch_tpu (the JAX reference) on the CPU.

Run from the root of a checkout:

    JAX_PLATFORMS=cpu python tests/data/golden/make_span_goldens.py [avoid] [analysis]

avoid:    the avoided-genome ranks of bench.py's avoid configuration
          (bench.py:266-331): candidates tiled from the first 8 ebola
          genomes (-pl 100 -ps 50, DuplicateFilter), SetCoverFilter(
          mismatches=2, lcf_thres=60, cover_extension=50) against the 100
          Mbp background that chip_smoke.write_background makes.  Writes
          avoid100m_ranks.tsv: the candidates with avoided bp > 0.
analysis: catch_tpu.cli.analyze_probe_coverage on the first 175 ebola
          genomes with the probes of torch_ebola175_m2.fasta (-m 2 -l 60
          -e 50).  Writes ebola175_m2_analysis.tsv and
          ebola175_m2_probe_map_counts.tsv.

Inputs go under build/chip_smoke/, the same files chip_smoke.py makes.
"""

import os
import sys
import time

import numpy as np

GOLDEN = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(GOLDEN)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def make_avoid():
    from catch_tpu.filters.candidates import (
        make_candidate_probes_from_sequences)
    from catch_tpu.filters.duplicate import DuplicateFilter
    from catch_tpu.filters.set_cover_filter import SetCoverFilter
    from catch_tpu.utils import seq_io

    genomes = seq_io.read_genomes_from_fasta(chip_smoke.FIXTURE)[:8]
    bg = chip_smoke.write_background(
        os.path.join(chip_smoke.WORK, "background_100mbp.fasta"),
        genomes[0].seqs[0])
    cands = DuplicateFilter()._filter(make_candidate_probes_from_sequences(
        [s for g in genomes for s in g.seqs], probe_length=100,
        probe_stride=50))
    scf = SetCoverFilter(mismatches=2, lcf_thres=60, cover_extension=50,
                         avoided_genomes=[bg])
    # Record catch_tpu's own per-batch avoided bp (per searcher row).
    rows = []
    scan = scf._tolerant_bp_batched

    def recording(searcher, seqs, rc_too=True):
        bp = scan(searcher, seqs, rc_too)
        rows.append((searcher, bp))
        return bp

    scf._tolerant_bp_batched = recording
    t0 = time.time()
    ranks = scf._make_ranks(cands, [genomes])
    print(f"catch_tpu _make_ranks: {time.time() - t0:.1f} s, "
          f"{len(rows)} batches", flush=True)
    searcher = rows[0][0]
    row_of = {p: i for i, p in enumerate(searcher.probes)}
    pid_of = np.array([row_of[p] for p in cands], dtype=np.int64)
    avoided = sum(bp for _, bp in rows)[pid_of]
    flagged = np.flatnonzero(avoided > 0)
    assert np.array_equal(flagged, np.flatnonzero(ranks > ranks.min()))
    with open(os.path.join(GOLDEN, "avoid100m_ranks.tsv"), "w") as f:
        f.write(f"# {len(cands)} candidates; candidate index and avoided bp "
                "of each candidate with avoided bp > 0\n")
        for i in flagged:
            f.write(f"{i}\t{avoided[i]}\n")
    print(f"{len(cands)} candidates, {len(flagged)} flagged", flush=True)


def make_analysis():
    from catch_tpu.cli import analyze_probe_coverage as cli

    fasta = chip_smoke.write_subset(175)
    t0 = time.time()
    cli.main(cli.init_and_parse_args([
        "-d", fasta, "-f", os.path.join(GOLDEN, "torch_ebola175_m2.fasta"),
        "-m", "2", "-l", "60", "-e", "50",
        "--write-analysis-to-tsv",
        os.path.join(GOLDEN, "ebola175_m2_analysis.tsv"),
        "--write-probe-map-counts-to-tsv",
        os.path.join(GOLDEN, "ebola175_m2_probe_map_counts.tsv")]))
    print(f"catch_tpu analysis: {time.time() - t0:.1f} s", flush=True)


def main(argv):
    parts = argv or ["avoid", "analysis"]
    os.makedirs(chip_smoke.WORK, exist_ok=True)
    for part in parts:
        {"avoid": make_avoid, "analysis": make_analysis}[part]()


if __name__ == "__main__":
    main(sys.argv[1:])
