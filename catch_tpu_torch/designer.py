# Copied from catch_tpu/designer.py.
"""ProbeDesigner: candidate generation + ordered filter pipeline.

Grouped candidate generation, grouped filtering, optional MinHash
clustering of the inputs (with fragmenting and the 'choose' heuristic)
where filters up to ``cluster_merge_after`` run per cluster, outputs
merge, and the remaining filters run ungrouped.  The final probes are
deduplicated in first-occurrence order so the output FASTA is
reproducible.  The clustering's pairwise work runs on ``device``.
"""

import logging
import os
import time

from catch_tpu_torch import genome
from catch_tpu_torch.device import resolve_device
from catch_tpu_torch.filters import base as filter_base
from catch_tpu_torch.filters import candidates as candidate_probes
from catch_tpu_torch.utils import cluster, profiling

logger = logging.getLogger(__name__)

__all__ = ["ProbeDesigner"]


def _dedup_preserving_order(probes):
    seen = set()
    out = []
    for p in probes:
        if p not in seen:
            seen.add(p)
            out.append(p)
    return out


class ProbeDesigner:
    """Generates candidate probes and passes them through filters."""

    def __init__(self, genomes, filters, probe_length, probe_stride,
                 allow_small_seqs=None, seq_length_to_skip=None,
                 cluster_threshold=None, cluster_merge_after=None,
                 cluster_method=None, cluster_fragment_length=None,
                 device="cuda"):
        """Args follow catch_tpu's ProbeDesigner; `device` is where the
        clustering's pairwise work runs (read only when
        cluster_threshold is set)."""
        self.genomes = genomes
        self.filters = filters
        self.probe_length = probe_length
        self.probe_stride = probe_stride
        self.allow_small_seqs = allow_small_seqs
        self.seq_length_to_skip = seq_length_to_skip
        self.cluster_threshold = cluster_threshold
        self.cluster_merge_after = cluster_merge_after
        self.cluster_method = cluster_method
        self.cluster_fragment_length = cluster_fragment_length
        self.device = device

    def _cluster_genomes(self):
        """Cluster all sequences (across groups/genomes) into pseudo-
        groups of single-sequence Genomes."""
        device = resolve_device(self.device)
        if len(self.genomes) > 1:
            logger.warning(
                "There are >1 groups of genomes in the input, but "
                "clustering these will override those groupings; "
                "differential identification or other tasks that rely on "
                "group separation may no longer work as intended")

        seqs = {}
        seq_idx = 0
        for genomes_from_group in self.genomes:
            for g in genomes_from_group:
                if self.cluster_fragment_length is not None:
                    g_seqs = g.break_into_fragments(
                        self.cluster_fragment_length,
                        include_full_end=True).seqs
                else:
                    g_seqs = g.seqs
                for s in g_seqs:
                    if (self.seq_length_to_skip is not None
                            and len(s) <= self.seq_length_to_skip):
                        continue
                    seqs[seq_idx] = s
                    seq_idx += 1

        if self.cluster_method == "choose":
            # Fragmenting multiple long genomes chains connected
            # components; use hierarchical then
            if self.cluster_fragment_length is not None:
                num_sequences = 0
                total_seq_len = 0
                for genomes_from_group in self.genomes:
                    for g in genomes_from_group:
                        num_sequences += len(g.seqs)
                        total_seq_len += g.size()
                average_seq_len = total_seq_len / num_sequences
                if (num_sequences > 1
                        and average_seq_len > self.cluster_fragment_length):
                    cluster_method_to_use = "hierarchical"
                else:
                    cluster_method_to_use = "simple"
            else:
                cluster_method_to_use = "simple"
        else:
            cluster_method_to_use = self.cluster_method

        logger.info(
            "Clustering %d sequences using MinHash signatures, at an "
            "average nucleotide dissimilarity threshold of %f", seq_idx,
            self.cluster_threshold)
        t0 = time.time()
        clusters = cluster.cluster_with_minhash_signatures(
            seqs, threshold=self.cluster_threshold,
            cluster_method=cluster_method_to_use, device=device)
        profiling.add_phase("cluster_genomes", time.time() - t0)
        logger.info("Found %d clusters with sizes: %s", len(clusters),
                    [len(c) for c in clusters])

        clustered_genomes = []
        for clust in clusters:
            clustered_genomes.append(
                [genome.Genome.from_one_seq(seqs[i]) for i in clust])
        return clustered_genomes

    def _pass_through_filters(self, probes, genomes, filters):
        assert len(probes) == len(genomes)
        if (len(probes) > 1 and len(filters) > 1
                and (filter_base._max_num_processes or 2) > 1
                and all(f.group_local for f in filters)):
            return self._filter_groups_pipelined(probes, genomes,
                                                 filters)
        for f in filters:
            logger.info("Starting filter %s", f.__class__.__name__)
            t0 = time.time()
            probes = f.filter(probes, genomes, input_is_grouped=True)
            profiling.add_phase("filter:" + f.__class__.__name__,
                                time.time() - t0)
        return probes

    def _filter_groups_pipelined(self, probes, genomes, filters):
        """Run the whole filter chain per group, groups overlapped on a
        thread pool, device-bound filters serialized on one lock.

        Every filter here is group-local (checked by the caller), so
        running group g's chain end to end gives the output of the
        stage-at-a-time loop; only scheduling changes.  Per-filter
        phase accounting becomes cumulative busy time across threads.
        """
        import threading
        from concurrent.futures import ThreadPoolExecutor

        logger.info("Running %d filters over %d groups pipelined",
                    len(filters), len(probes))
        # ONE lock shared by every device-bound filter: there is one
        # device, and per-filter locks would let two device-bound
        # stages from different groups interleave on it.
        device_lock = threading.Lock()
        locks = {id(f): device_lock for f in filters if f.device_bound}
        for f in filters:
            if hasattr(f, "last_run_stats"):
                f.last_run_stats = None
            f.stats_accumulate = True
        try:
            def run_group(g):
                p = probes[g]
                for f in filters:
                    lk = locks.get(id(f))
                    if lk is None:
                        t0 = time.time()
                        p = f.filter([p], [genomes[g]],
                                     input_is_grouped=True)[0]
                        profiling.add_phase(
                            "filter:" + f.__class__.__name__,
                            time.time() - t0)
                    else:
                        with lk:
                            # timed inside the lock so the phase is
                            # busy time, not queue wait
                            t0 = time.time()
                            p = f.filter([p], [genomes[g]],
                                         input_is_grouped=True)[0]
                            profiling.add_phase(
                                "filter:" + f.__class__.__name__,
                                time.time() - t0)
                return p

            workers = (filter_base._max_num_processes
                       or min(os.cpu_count() or 1, 8))
            # one extra worker so a group can occupy the device while
            # `workers` others run host-bound stages
            workers = max(2, min(workers + 1, len(probes)))
            with ThreadPoolExecutor(max_workers=workers) as pool:
                return list(pool.map(run_group, range(len(probes))))
        finally:
            for f in filters:
                f.stats_accumulate = False

    def _pass_through_filters_ungrouped(self, probes, genomes, filters):
        for f in filters:
            logger.info("Starting filter %s", f.__class__.__name__)
            t0 = time.time()
            probes = f.filter(probes, genomes, input_is_grouped=False)
            profiling.add_phase("filter:" + f.__class__.__name__,
                                time.time() - t0)
        return probes

    def _design_for_genomes(self, genomes, filters):
        logger.info("Building candidate probes from target sequences")
        t0 = time.time()
        candidates = []
        for genomes_from_group in genomes:
            candidates_for_group = []
            for g in genomes_from_group:
                candidates_for_group += \
                    candidate_probes.make_candidate_probes_from_sequences(
                        g.seqs, probe_length=self.probe_length,
                        probe_stride=self.probe_stride,
                        allow_small_seqs=self.allow_small_seqs,
                        seq_length_to_skip=self.seq_length_to_skip)
            if len(candidates_for_group) == 0:
                logger.warning(
                    "There are no candidate probes for a grouping of "
                    "genomes; it is possible that --small-seq-skip or "
                    "--small-seq-min are incompatible with the input "
                    "sequence lengths, especially if "
                    "--cluster-and-design-separately is set small.")
            candidates.append(candidates_for_group)
        profiling.add_phase("candidate_probes", time.time() - t0)

        probes = self._pass_through_filters(candidates, genomes, filters)
        return (candidates, probes)

    def design(self):
        """Run the design; stores self.candidate_probes and
        self.final_probes."""
        if self.cluster_threshold is None:
            candidates, probes = self._design_for_genomes(self.genomes,
                                                          self.filters)
            self.candidate_probes = [p for group in candidates
                                     for p in group]
            self.final_probes = _dedup_preserving_order(
                [p for group in probes for p in group])
            return

        assert self.cluster_merge_after is not None
        assert self.cluster_merge_after in self.filters
        filter_merge_idx = self.filters.index(self.cluster_merge_after) + 1
        filters_before_merge = self.filters[:filter_merge_idx]
        filters_after_merge = self.filters[filter_merge_idx:]

        clustered_genomes = self._cluster_genomes()
        candidates_by_cluster, probes_by_cluster = \
            self._design_for_genomes(clustered_genomes,
                                     filters_before_merge)

        self.candidate_probes = [p for group in candidates_by_cluster
                                 for p in group]
        probes = _dedup_preserving_order(
            [p for group in probes_by_cluster for p in group])
        probes = self._pass_through_filters_ungrouped(
            probes, clustered_genomes, filters_after_merge)
        self.final_probes = probes
