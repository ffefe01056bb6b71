"""SetCoverFilter: probe selection by multi-universe set cover.

Port of catch_tpu/filters/set_cover_filter.py.  Every group takes the
device scan of ops/scan_instance on the filter's `device`, packs the
merged instance and reads it back once, and solves it with the lazy
greedy solver on the host, in rank tiers.  With CATCH_TPU_SOLVE=device in the environment,
as in catch_tpu, the instance stays on the device instead: stage E
(scan_instance.ensure_assembled) and the greedy steps
(set_cover.solve_boundary_instance) run there, and only the picks come
back; a failure raises.  A group whose position axis does not fit the
device solver's int32 coordinates takes the host route, as in
catch_tpu.  Identification ranks and avoided-genome ranks come from the
tolerant model's unmerged span scan (ops/scan_sparse) on the same
device, merged there per (probe, strand).  There is no
size-based route to a host scan and no fallback: a failing scan raises.

A custom cover function (custom_cover_range_fn, loaded by
utils/dynamic_load) is a Python callable, so a model with one takes
catch_tpu's host route for it: ProbeSearcher's host scan, the flat cover
arrays, set_cover.build_instance_from_cover_arrays and the host lazy
solver, with no kernel; a custom tolerant function gives its ranks from
the same host scan, merged on the host.  The route is chosen by the
model alone.

With `mesh` (a parallel.mesh.Mesh led by `device`), every searcher the
filter builds gets it: the design scan splits its hashing, lookup and
verification over the places, and the span scan its verification (on a
mesh across processes, over every rank's places, exchanging the spans).  As
in catch_tpu, the filter itself never reaches the sharded solver: the
host route solves on the host, and CATCH_TPU_SOLVE=device solves on the
lead whatever the mesh.  The caller still holds one lock around the
whole filter call, so design_large's group threads take turns on the
mesh as they do on one device.
"""

import logging
import os
import time

import numpy as np
import torch

from catch_tpu_torch.device import resolve_device
from catch_tpu_torch.filters.base import BaseFilter
from catch_tpu_torch.ops import scan_instance, scan_sparse, set_cover
from catch_tpu_torch.ops.cover import CoverModel, ProbeSearcher
from catch_tpu_torch.utils import dynamic_load, profiling, seq_io

logger = logging.getLogger(__name__)

__all__ = ["SetCoverFilter"]

_RC_TABLE = str.maketrans("ACGT", "TGCA")


def _reverse_complement(sequence):
    """Reverse complement of A/C/G/T; every other character stays."""
    return sequence[::-1].translate(_RC_TABLE)


class SetCoverFilter(BaseFilter):
    """Selects candidate probes via greedy multi-universe set cover."""

    device_bound = True

    @property
    def group_local(self):
        # Identification ranks count hits across ALL groupings, so the
        # filter is only safe to run one group at a time when
        # identification is off.  (Avoided-genome ranks scan only the
        # group's own candidates against external FASTAs: group-local.)
        # On a mesh across processes the span scans exchange between
        # the ranks, which must meet them in one order: the groups then
        # go one after another, in order, on every rank.
        spans_ranks = self.mesh is not None and self.mesh.spans_ranks
        return not self.identify and not spans_ranks

    def __init__(self, mismatches, lcf_thres, island_of_exact_match=0,
                 mismatches_tolerant=None, lcf_thres_tolerant=None,
                 island_of_exact_match_tolerant=None,
                 custom_cover_range_fn=None,
                 custom_cover_range_tolerant_fn=None, identify=False,
                 avoided_genomes=(), coverage=1.0, cover_extension=0,
                 kmer_probe_map_k=20, kmer_probe_map_use_native_dict=False,
                 *, device, mesh=None):
        """Args follow catch_tpu's SetCoverFilter;
        kmer_probe_map_use_native_dict is accepted for compatibility and
        ignored.  `device` (a name or a torch.device) is where the scans
        run, checked by device.resolve_device; `mesh`, if given, must be
        led by it."""
        self.device = resolve_device(device)
        if mesh is not None and mesh.lead != self.device:
            raise ValueError(f"the mesh is led by {mesh.lead}, the filter "
                             f"runs on {self.device}")
        self.mesh = mesh
        if custom_cover_range_fn is not None:
            fn_path, fn_name = custom_cover_range_fn
            fn = dynamic_load.load_function_from_path(fn_path, fn_name)
            self.model = CoverModel(custom_fn=fn)
        else:
            self.model = CoverModel(mismatches, lcf_thres,
                                    island_of_exact_match)
        if not mismatches_tolerant:
            mismatches_tolerant = mismatches
        if not lcf_thres_tolerant:
            lcf_thres_tolerant = lcf_thres
        if not island_of_exact_match_tolerant:
            island_of_exact_match_tolerant = island_of_exact_match
        if custom_cover_range_tolerant_fn is not None:
            fn_path, fn_name = custom_cover_range_tolerant_fn
            fn = dynamic_load.load_function_from_path(fn_path, fn_name)
            self.tolerant_model = CoverModel(custom_fn=fn)
        else:
            self.tolerant_model = CoverModel(
                mismatches_tolerant, lcf_thres_tolerant,
                island_of_exact_match_tolerant)
        if identify:
            if (coverage <= 1.0 and coverage >= 0.25) or \
               (coverage > 1 and coverage >= 5000):
                logger.warning(
                    "Identification is enabled but the required coverage "
                    "is high; generally coverage should be small when "
                    "performing identification")
        self.identify = identify
        self.avoided_genomes = list(avoided_genomes)
        self.coverage = coverage
        self.cover_extension = cover_extension
        self.kmer_probe_map_k = kmer_probe_map_k
        self.requires_probe_groupings = True

    def _prepare_scan(self, candidate_probes, target_genomes):
        """Searcher + flattened corpus bookkeeping."""
        searcher = ProbeSearcher(candidate_probes, self.model,
                                 kmer_probe_map_k=self.kmer_probe_map_k,
                                 mesh=self.mesh)
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

    def _make_cover_arrays(self, prepared):
        """Cover spans of every candidate in every target genome, from
        the searcher's host scan of a custom model.

        Returns flat arrays (set_ids, univ_ids, starts, ends) with
        cover extension applied and clamped per chromosome, and
        coordinates offset into genome-global positions
        (reference set_cover_filter.py:414-470).
        """
        searcher, pid_of, sequences, seq_univ, seq_off, seq_len = prepared
        logger.info("Computing coverage across %d target sequences on "
                    "the host", len(sequences))
        p_idx, s_idx, st, en = searcher.find_probe_covers_flat(sequences)
        if len(p_idx) == 0:
            z = np.empty(0, dtype=np.int64)
            return z, z.copy(), z.copy(), z.copy()
        st = np.maximum(0, st - self.cover_extension)
        en = np.minimum(seq_len[s_idx], en + self.cover_extension)
        return (pid_of[p_idx], seq_univ[s_idx],
                st + seq_off[s_idx], en + seq_off[s_idx])

    def _tolerant_bp_batched(self, searcher, sequences, rc_too=True):
        """Per-searcher-probe bp covered across `sequences` (and their
        reverse complements) under the tolerant model, from one span
        scan on the device.

        Merging is per (probe, strand-sequence), on the device with
        segmented_merge: identical to summing find_probe_covers' merged
        ranges per strand.  A custom tolerant model is scanned and
        merged on the host, as catch_tpu does.  Returns
        int64[len(searcher.probes)] of total covered bp.
        """
        strands = list(sequences)
        if rc_too:
            strands += [_reverse_complement(s) for s in sequences]
        n_probes = len(searcher.probes)
        if not strands or searcher.empty:
            return np.zeros(n_probes, dtype=np.int64)
        n_strands = len(strands)
        if searcher.model.custom_fn is not None:
            p, s_idx, st, en = searcher.find_probe_covers_flat(strands)
            gk, gs, ge = set_cover._merge_by_group(p * n_strands + s_idx,
                                                   st, en)
            bp = np.zeros(n_probes, dtype=np.int64)
            np.add.at(bp, gk // n_strands, ge - gs)
            return bp
        if n_probes * n_strands >= scan_instance._PAIR_KEY_LIMIT:
            raise ValueError(
                f"{n_probes} probes x {n_strands} strands exceed the 31-bit "
                "merge key")
        p, s_idx, st, en = scan_sparse.scan_spans(searcher, strands,
                                                  self.device)
        t0 = time.time()
        gk, gs, ge = scan_instance.segmented_merge(p * n_strands + s_idx,
                                                   st, en)
        bp = torch.zeros(n_probes, dtype=torch.int64, device=self.device)
        bp.index_add_(0, gk // n_strands, ge - gs)
        out = bp.cpu().numpy()
        profiling.add_phase("span:merge_bp", time.time() - t0)
        return out

    # Avoided-genome sequences are scanned in batches of about this
    # many bases so human-scale backgrounds stream through the span
    # scan without materializing the whole FASTA.
    _AVOID_BATCH_BP = 1 << 26

    def _make_ranks(self, candidate_probes, target_genomes_grouped):
        """Integer rank per set id (reference :614-735): tuples
        (0, groupings_hit or 0) / (1, avoided_bp), densified.

        One span scan per grouping (both strands at once) for
        identification, and one per ~64 Mbp batch of avoided sequence.
        """
        need_searcher = self.identify or len(self.avoided_genomes) > 0
        searcher = None
        pid_of = None
        if need_searcher:
            searcher = ProbeSearcher(
                candidate_probes, self.tolerant_model,
                kmer_probe_map_k=self.kmer_probe_map_k, device=self.device,
                mesh=self.mesh)
            probe_row = {p: i for i, p in enumerate(searcher.probes)}
            pid_of = np.array(
                [probe_row[p] for p in candidate_probes], dtype=np.int64)

        n_cand = len(candidate_probes)
        if self.identify:
            hits = np.zeros(n_cand, dtype=np.int64)
            for i, genomes_from_group in enumerate(target_genomes_grouped):
                logger.info(
                    "Computing coverage in grouping %d (of %d) to count "
                    "number of groupings hit", i + 1,
                    len(target_genomes_grouped))
                seqs = [s for gnm in genomes_from_group for s in gnm.seqs]
                bp = self._tolerant_bp_batched(searcher, seqs)
                hits += (bp[pid_of] >= 1)
            if np.any(hits == 0):
                logger.critical(
                    "There is a probe that does not 'hit' any target "
                    "genome grouping, but every candidate probe "
                    "should hit at least one")
            rank_val = [(0, int(h)) for h in hits]
        else:
            rank_val = [(0, 0)] * n_cand

        if self.avoided_genomes:
            avoided_bp = np.zeros(n_cand, dtype=np.int64)
            for fasta_path in self.avoided_genomes:
                batch, batch_bp = [], 0
                for sequence in seq_io.iterate_fasta(fasta_path):
                    batch.append(sequence)
                    batch_bp += len(sequence)
                    if batch_bp >= self._AVOID_BATCH_BP:
                        logger.info("Computing coverage across an "
                                    "avoided-sequence batch (%d bp)",
                                    batch_bp)
                        avoided_bp += self._tolerant_bp_batched(
                            searcher, batch)[pid_of]
                        batch, batch_bp = [], 0
                if batch:
                    logger.info("Computing coverage across an "
                                "avoided-sequence batch (%d bp)", batch_bp)
                    avoided_bp += self._tolerant_bp_batched(
                        searcher, batch)[pid_of]
            for i in range(n_cand):
                if avoided_bp[i] > 0:
                    rank_val[i] = (1, int(avoided_bp[i]))

        all_rank_tuples = sorted(set(rank_val))
        tuple_rank_idx = {t: i for i, t in enumerate(all_rank_tuples)}
        return np.array([tuple_rank_idx[t] for t in rank_val],
                        dtype=np.int64)

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

    def _solve_group(self, possible_probes, target_genomes, ranks, stats):
        """Scan the group and solve it in the rank tiers of `ranks`;
        returns the chosen candidate ids in pick order.

        The default model is scanned on the device.  A custom model is
        scanned on the host and solved by the host lazy solver, as
        catch_tpu's _filter does for it (:380-402)."""
        t0 = time.time()
        prepared = self._prepare_scan(possible_probes, target_genomes)
        searcher, pid_of, sequences, seq_univ, seq_off, seq_len = prepared
        profiling.add_phase("set_cover:prepare", time.time() - t0)
        universe_p = self._make_universe_p(target_genomes)
        on_device = False
        t0 = time.time()
        if self.model.custom_fn is not None:
            set_ids, univ_ids, starts, ends = self._make_cover_arrays(
                prepared)
            inst = set_cover.build_instance_from_cover_arrays(
                set_ids, univ_ids, starts, ends,
                n_sets=len(possible_probes),
                n_universes=len(target_genomes), universe_p=universe_p,
                ranks=ranks)
        else:
            rank_vals = np.unique(ranks)
            rank_idx = np.searchsorted(rank_vals, ranks).astype(np.int32)
            costs = np.ones(len(possible_probes), dtype=np.float32)
            dev, perm = scan_instance.scan_to_boundary_instance(
                searcher, sequences, seq_univ, seq_off, seq_len,
                len(target_genomes), self.cover_extension, universe_p,
                pid_of, self.device)
            on_device = os.environ.get("CATCH_TPU_SOLVE") == "device"
            if on_device and int(dev["offsets"][-1]) >= \
                    set_cover._DEVICE_AXIS_LIMIT:
                # The device solver's coordinates are int32: catch_tpu's
                # host route, a size seen before any launch.
                logger.warning("Global position axis exceeds int32; "
                               "falling back to the host instance build")
                on_device = False
            if on_device:
                # Stage E and the greedy steps on the device; only the
                # picks come back.
                scan_instance.ensure_assembled(dev, perm, pid_of, rank_idx,
                                               len(rank_vals), costs)
            else:
                inst = scan_instance.instance_to_host(
                    dev, perm, pid_of, len(possible_probes), rank_idx,
                    len(rank_vals), costs)
        stats["scan_seconds"] += time.time() - t0
        t0 = time.time()
        if on_device:
            # solve_boundary_instance takes the host route itself where
            # K12's overlap index would not fit int32 (k12_piece_count)
            order = set_cover.solve_boundary_instance(dev, len(perm))
            chosen = pid_of[perm[order]]
        else:
            chosen = set_cover.solve_instance(inst)
        stats["solve_seconds"] += time.time() - t0
        profiling.add_phase("set_cover:solve", time.time() - t0)
        stats["set_cover_picks"] += len(chosen)
        stats["candidates_evaluated"] += searcher.stats["candidates"]
        if "launches_by_place" in searcher.stats:
            stats["launches_by_place"] = searcher.stats["launches_by_place"]
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
            t0 = time.time()
            ranks = self._make_ranks(possible_probes,
                                     target_genomes_grouped)
            profiling.add_phase("set_cover:ranks", time.time() - t0)
            chosen = self._solve_group(possible_probes, target_genomes,
                                       ranks, stats)
            n_min_rank = int(np.sum(ranks[chosen] > ranks.min())) \
                if len(chosen) else 0
            if n_min_rank:
                logger.warning(
                    "The solution for group %d chose %d probes with rank "
                    "above the minimum (e.g., probes hitting avoided "
                    "genomes or multiple groupings)", group_i, n_min_rank)
            # Deterministic output order: ascending candidate id.
            selected_probes.append(
                [possible_probes[i] for i in np.sort(chosen)])
        return selected_probes
