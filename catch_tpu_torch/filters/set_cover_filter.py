"""SetCoverFilter: probe selection by multi-universe set cover.

Port of catch_tpu/filters/set_cover_filter.py (the constructor and
_filter).  Every group takes the device scan of ops/scan_instance on the
filter's `device`, reads the merged instance back once, and solves it
with the lazy greedy solver on the host.  There is no size-based route
to a host scan and no fallback: a failing scan raises.

Not ported yet (ROADMAP queue 1): identification ranks and avoided
genomes (item 6, they need the unmerged span API), and custom cover
functions.
"""

import logging
import time

import numpy as np

from catch_tpu_torch.device import resolve_device
from catch_tpu_torch.filters.base import BaseFilter
from catch_tpu_torch.ops import scan_instance, set_cover
from catch_tpu_torch.ops.cover import CoverModel, ProbeSearcher
from catch_tpu_torch.utils import profiling

logger = logging.getLogger(__name__)

__all__ = ["SetCoverFilter"]


class SetCoverFilter(BaseFilter):
    """Selects candidate probes via greedy multi-universe set cover."""

    device_bound = True
    # Without identification every group's output depends on that
    # group alone.
    group_local = True

    def __init__(self, mismatches, lcf_thres, island_of_exact_match=0,
                 custom_cover_range_fn=None, identify=False,
                 avoided_genomes=(), coverage=1.0, cover_extension=0,
                 kmer_probe_map_k=20, *, device):
        """Args follow catch_tpu's SetCoverFilter; `device` (a name or a
        torch.device) is where the scan runs, checked by
        device.resolve_device."""
        if custom_cover_range_fn is not None:
            raise NotImplementedError(
                "custom cover functions are not ported to catch_tpu_torch "
                "yet (ROADMAP queue 1)")
        if identify or avoided_genomes:
            raise NotImplementedError(
                "identification and avoided genomes are not ported to "
                "catch_tpu_torch yet (ROADMAP queue 1, item 6)")
        self.device = resolve_device(device)
        self.model = CoverModel(mismatches, lcf_thres, island_of_exact_match)
        self.coverage = coverage
        self.cover_extension = cover_extension
        self.kmer_probe_map_k = kmer_probe_map_k
        self.requires_probe_groupings = True

    def _prepare_scan(self, candidate_probes, target_genomes):
        """Searcher + flattened corpus bookkeeping."""
        searcher = ProbeSearcher(candidate_probes, self.model,
                                 kmer_probe_map_k=self.kmer_probe_map_k)
        # Reference semantics: later duplicates take the id
        probe_id = {}
        for i, p in enumerate(candidate_probes):
            probe_id[p] = i
        pid_of = np.array([probe_id[p] for p in searcher.probes],
                          dtype=np.int64)

        sequences, seq_univ, seq_off, seq_len = [], [], [], []
        for j, gnm in enumerate(target_genomes):
            length_so_far = 0
            for sequence in gnm.seqs:
                sequences.append(sequence)
                seq_univ.append(j)
                seq_off.append(length_so_far)
                seq_len.append(len(sequence))
                length_so_far += len(sequence)
        return (searcher, pid_of, sequences, np.array(seq_univ, np.int64),
                np.array(seq_off, np.int64), np.array(seq_len, np.int64))

    def _make_universe_p(self, target_genomes):
        """Required coverage per universe (reference :761-792)."""
        if self.coverage <= 1.0:
            return np.full(len(target_genomes), self.coverage,
                           dtype=np.float64)
        p = np.empty(len(target_genomes), dtype=np.float64)
        for j, gnm in enumerate(target_genomes):
            desired = min(self.coverage, gnm.size())
            p[j] = float(desired) / gnm.size()
        return p

    def _solve_group(self, possible_probes, target_genomes, stats):
        """Scan the group on the device and solve it; returns the
        chosen candidate ids in pick order."""
        t0 = time.time()
        searcher, pid_of, sequences, seq_univ, seq_off, seq_len = \
            self._prepare_scan(possible_probes, target_genomes)
        profiling.add_phase("set_cover:prepare", time.time() - t0)
        universe_p = self._make_universe_p(target_genomes)
        # No identification or avoided genomes: every candidate shares
        # one rank.
        rank_idx = np.zeros(len(possible_probes), dtype=np.int32)
        costs = np.ones(len(possible_probes), dtype=np.float32)
        t0 = time.time()
        dev, perm = scan_instance.scan_to_boundary_instance(
            searcher, sequences, seq_univ, seq_off, seq_len,
            len(target_genomes), self.cover_extension, universe_p, pid_of,
            self.device)
        inst = scan_instance.instance_to_host(
            dev, perm, pid_of, len(possible_probes), rank_idx, 1, costs)
        stats["scan_seconds"] += time.time() - t0
        t0 = time.time()
        chosen = set_cover.solve_instance(inst)
        stats["solve_seconds"] += time.time() - t0
        profiling.add_phase("set_cover:solve", time.time() - t0)
        stats["set_cover_picks"] += len(chosen)
        stats["candidates_evaluated"] += searcher.stats["candidates"]
        return np.asarray(chosen, dtype=np.int64)

    def _filter(self, input, target_genomes_grouped):
        """Per-group set-cover selection; input is grouped probes."""
        # The designer's group pipeline calls this once per group;
        # with accumulation on, totals aggregate across those calls.
        stats = getattr(self, "last_run_stats", None)
        if stats is None or not getattr(self, "stats_accumulate", False):
            stats = {"scan_seconds": 0.0, "solve_seconds": 0.0,
                     "candidates_evaluated": 0, "set_cover_picks": 0}
        self.last_run_stats = stats
        selected_probes = []
        for group_i, (possible_probes, target_genomes) in enumerate(
                zip(input, target_genomes_grouped)):
            possible_probes = list(possible_probes)
            logger.info("Building set cover input (group %d of %d)",
                        group_i + 1, len(input))
            if len(possible_probes) == 0:
                selected_probes.append([])
                continue
            chosen = self._solve_group(possible_probes, target_genomes,
                                       stats)
            # Deterministic output order: ascending candidate id.
            selected_probes.append(
                [possible_probes[i] for i in np.sort(chosen)])
        return selected_probes
