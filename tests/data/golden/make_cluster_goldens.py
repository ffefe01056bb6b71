#!/usr/bin/env python3
"""Make the design_large and clustering goldens with catch_tpu (the JAX
reference) on the CPU.

Run from the root of a checkout:

    JAX_PLATFORMS=cpu python tests/data/golden/make_cluster_goldens.py \
        [flu2000] [flu10k] [scale]

flu2000: catch_tpu.cli.design_large, with its defaults and nothing else,
         on influenza_like_segments(n_genomes=2000, seed=0) written as 8
         segment FASTAs.  Writes flu2000_design_large.fasta.
flu10k:  the same on 10,000 genomes (bench.py:107-127's corpus).  Writes
         flu10k_design_large.fasta and, from the same run, the clusters
         the designer's _cluster_genomes found, as flu10k_clusters.tsv.gz.
scale:   the clustering step alone of design_large's defaults
         (threshold 0.15, method 'choose') on the 51 Mbp scale corpus of
         bench.py:130-158, once with fragments of 50,000 (-> 'simple')
         and once with fragments of 10,000 (-> 'hierarchical').  Writes
         scale51m_clusters_simple.tsv.gz and
         scale51m_frag10k_clusters_hierarchical.tsv.gz.

A cluster file has one line per clustered sequence, in the order
_cluster_genomes numbers them: the rank of its cluster in catch_tpu's
size-descending cluster order.  Inputs go under build/chip_smoke/, the
same files chip_smoke.py makes.
"""

import gzip
import os
import sys
import time

GOLDEN = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(GOLDEN)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


class _Recorder:
    """Records the clusters of every cluster_with_minhash_signatures call
    the designer makes."""

    def __init__(self):
        from catch_tpu.utils import cluster
        self.module, self.fn, self.calls = cluster, \
            cluster.cluster_with_minhash_signatures, []

    def __enter__(self):
        def recording(seqs, *args, **kwargs):
            clusters = self.fn(seqs, *args, **kwargs)
            self.calls.append((len(seqs), kwargs.get("cluster_method"),
                               clusters))
            return clusters
        self.module.cluster_with_minhash_signatures = recording
        return self

    def __exit__(self, *exc):
        self.module.cluster_with_minhash_signatures = self.fn


def write_clusters(path, n, clusters):
    with gzip.GzipFile(path, "wb", mtime=0) as f:
        f.write("".join(f"{r}\n" for r in chip_smoke.cluster_ranks(
            clusters, n)).encode())
    print(f"{os.path.basename(path)}: {n} sequences, {len(clusters)} "
          f"clusters, {os.path.getsize(path)} bytes", flush=True)


def design_large(n_genomes, name, clusters_path=None):
    from catch_tpu.cli import design
    from catch_tpu.utils.synthetic import (influenza_like_segments,
                                           write_segment_fastas)

    segs, subtype_of = influenza_like_segments(n_genomes=n_genomes, seed=0)
    paths = write_segment_fastas(
        segs, subtype_of, os.path.join(chip_smoke.WORK, f"flu{n_genomes}"))
    out = os.path.join(GOLDEN, f"{name}_design_large.fasta")
    t0, c0 = time.time(), time.process_time()
    with _Recorder() as rec:
        design.main(design.init_and_parse_args("large", paths + ["-o", out]))
    with open(out) as f:
        n_probes = sum(line.startswith(">") for line in f)
    print(f"{name} design_large: {n_probes} probes; wall "
          f"{time.time() - t0:.1f} s, CPU {time.process_time() - c0:.1f} s; "
          f"{sum(s.size for s in segs)} bp", flush=True)
    if clusters_path is not None:
        (n, method, clusters), = rec.calls
        print(f"{name} clustering: method {method}", flush=True)
        write_clusters(clusters_path, n, clusters)


def make_scale():
    from catch_tpu.designer import ProbeDesigner
    from catch_tpu.genome import Genome

    genomes = [Genome.from_one_seq(s) for s in chip_smoke.scale_seqs()]
    for frag, method, name in ((50000, "simple", "scale51m_clusters_simple"),
                               (10000, "hierarchical",
                                "scale51m_frag10k_clusters_hierarchical")):
        pb = ProbeDesigner([genomes], [], probe_length=100, probe_stride=50,
                           cluster_threshold=0.15, cluster_method="choose",
                           cluster_fragment_length=frag)
        t0, c0 = time.time(), time.process_time()
        with _Recorder() as rec:
            pb._cluster_genomes()
        (n, got, clusters), = rec.calls
        assert got == method, (got, method)
        print(f"{name}: wall {time.time() - t0:.1f} s, CPU "
              f"{time.process_time() - c0:.1f} s", flush=True)
        write_clusters(os.path.join(GOLDEN, f"{name}.tsv.gz"), n, clusters)


def main(argv):
    os.makedirs(chip_smoke.WORK, exist_ok=True)
    parts = {
        "flu2000": lambda: design_large(2000, "flu2000"),
        "flu10k": lambda: design_large(10000, "flu10k", os.path.join(
            GOLDEN, "flu10k_clusters.tsv.gz")),
        "scale": make_scale,
    }
    for part in argv or list(parts):
        parts[part]()


if __name__ == "__main__":
    main(sys.argv[1:])
