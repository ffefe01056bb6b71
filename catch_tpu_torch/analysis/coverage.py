# Copied from catch_tpu/analysis/coverage.py (the scan runs on an explicit device).
"""Coverage analysis (QC) of a final probe set.

Behavioral parity with the reference Analyzer
(reference catch/coverage_analysis.py:73-568): re-runs the cover
scan over every target genome and (optionally) its reverse complement
on the Analyzer's `device`, with unmerged spans and a more sensitive
seed (k defaults to 10), then computes bp covered (interval union),
average depth over all/unambiguous bases, sliding-window depth, and
per-probe counts of sequences mapped; writers for the pretty table, TSV matrix,
sliding-window TSV, and probe-map-count TSV.

The per-base depth array is built with a vectorized endpoint delta +
cumsum instead of the reference's per-endpoint Python sweep; sliding
windows are evaluated with a prefix-sum, preserving the reference's
uint16 counts and window/middle semantics.
"""

from collections import Counter
import logging

import numpy as np

from catch_tpu_torch.device import resolve_device
from catch_tpu_torch.filters.set_cover_filter import _reverse_complement
from catch_tpu_torch.ops.cover import CoverModel, ProbeSearcher
from catch_tpu_torch.utils import intervals, pretty_print

logger = logging.getLogger(__name__)

__all__ = ["Analyzer"]

class Analyzer:
    """Quality control of a probe set against target genomes."""

    def __init__(self, probes, mismatches, lcf_thres, target_genomes,
                 target_genomes_names=None, island_of_exact_match=0,
                 custom_cover_range_fn=None, cover_extension=0,
                 kmer_probe_map_k=10, rc_too=True, *, device):
        """Args follow the reference contract
        (coverage_analysis.py:77-155); `device` (a name or a
        torch.device) is where the scan runs, checked by
        device.resolve_device."""
        if custom_cover_range_fn is not None:
            raise NotImplementedError(
                "custom cover functions are not ported to catch_tpu_torch "
                "yet (ROADMAP queue 1, item 12)")
        self.device = resolve_device(device)
        self.probes = probes
        self.target_genomes = target_genomes
        if target_genomes_names:
            if len(target_genomes_names) != len(target_genomes):
                raise ValueError(
                    "Number of target genome names must be same as the "
                    "number of target genomes")
            self.target_genomes_names = target_genomes_names
        else:
            self.target_genomes_names = [
                "Group %d" % i for i in range(len(target_genomes))]

        self.model = CoverModel(mismatches, lcf_thres, island_of_exact_match)
        self.cover_extension = cover_extension
        self.kmer_probe_map_k = kmer_probe_map_k
        self.rc_too = rc_too

    def _iter_target_genomes(self):
        for i, genomes_from_group in enumerate(self.target_genomes):
            for j, gnm in enumerate(genomes_from_group):
                yield i, j, gnm, False
                if self.rc_too:
                    yield i, j, gnm, True

    def _find_covers_in_target_genomes(self):
        """Fill self.target_covers[i][j][rc] with (possibly duplicate)
        extended cover intervals in genome-global coordinates, and
        self.probe_map_counts with per-probe sequence counts.

        All strands of all genomes (forward and reverse complement) go
        through ONE span scan (find_probe_covers_flat); the
        reference loops sequences through its process pool here
        (coverage_analysis.py:183-269); per-strand results fall out of
        the flat span arrays by grouping.  Downstream consumers are
        order-insensitive, so the output is unchanged vs the
        per-sequence loop.
        """
        logger.info("Finding probe covers across target genomes")
        searcher = ProbeSearcher(self.probes, self.model,
                                 kmer_probe_map_k=self.kmer_probe_map_k,
                                 device=self.device)

        strands = []           # every scanned sequence, both strands
        strand_meta = []       # (i, j, rc, genome-global offset)
        self.target_covers = {}
        for i, j, gnm, rc in self._iter_target_genomes():
            self.target_covers.setdefault(i, {}).setdefault(
                j, {False: None, True: None})
            self.target_covers[i][j][rc] = []
            length_so_far = 0
            for sequence in gnm.seqs:
                if rc:
                    sequence = _reverse_complement(sequence)
                strands.append(sequence)
                strand_meta.append((i, j, rc, length_so_far))
                length_so_far += len(sequence)

        self.probe_map_counts = Counter()
        if not strands or searcher.empty:
            return
        p_idx, s_idx, st, en = searcher.find_probe_covers_flat(strands)
        if len(p_idx) == 0:
            return
        # Identical spans of one probe in one strand count once (the
        # per-sequence path dedupes them via sorted(set(spans)))
        o = np.lexsort((en, st, p_idx, s_idx))
        p_idx, s_idx, st, en = p_idx[o], s_idx[o], st[o], en[o]
        keep = np.concatenate([[True],
                               (p_idx[1:] != p_idx[:-1])
                               | (s_idx[1:] != s_idx[:-1])
                               | (st[1:] != st[:-1])
                               | (en[1:] != en[:-1])])
        p_idx, s_idx, st, en = (p_idx[keep], s_idx[keep], st[keep],
                                en[keep])
        seq_len = np.array([len(s) for s in strands], dtype=np.int64)
        off = np.array([m[3] for m in strand_meta], dtype=np.int64)
        cs = np.maximum(0, st - self.cover_extension) + off[s_idx]
        ce = (np.minimum(seq_len[s_idx], en + self.cover_extension)
              + off[s_idx])

        # s_idx is the lexsort's primary key above, so the arrays are
        # already grouped by strand
        bounds = np.searchsorted(s_idx, np.arange(len(strands) + 1))
        for k, (i, j, rc, _) in enumerate(strand_meta):
            sl = slice(bounds[k], bounds[k + 1])
            self.target_covers[i][j][rc].extend(
                zip(cs[sl].tolist(), ce[sl].tolist()))
            if not rc:
                # one count per probe per sequence it maps to
                for p_row in np.unique(p_idx[sl]):
                    self.probe_map_counts[searcher.probes[p_row]] += 1

    def _compute_bp_covered_in_target_genomes(self):
        logger.info("Computing bases covered across target genomes")
        self.bp_covered = {}
        for i, j, gnm, rc in self._iter_target_genomes():
            self.bp_covered.setdefault(i, {}).setdefault(
                j, {False: None, True: None})
            covers = self.target_covers[i][j][rc]
            self.bp_covered[i][j][rc] = len(intervals.IntervalSet(covers))

    def _compute_average_coverage_in_target_genomes(self):
        logger.info("Computing average coverage across target genomes")
        self.average_coverage = {}
        for i, j, gnm, rc in self._iter_target_genomes():
            self.average_coverage.setdefault(i, {}).setdefault(
                j, {False: None, True: None})
            covers = self.target_covers[i][j][rc]
            # Duplicates intentionally counted (depth, not breadth)
            total_covered = sum(c[1] - c[0] for c in covers)
            avg_all = float(total_covered) / gnm.size(False)
            avg_unambig = float(total_covered) / gnm.size(True)
            self.average_coverage[i][j][rc] = (avg_all, avg_unambig)

    def _compute_sliding_coverage_in_target_genomes(self, window_length,
                                                    window_stride):
        logger.info("Computing sliding coverage across target genomes")
        self.sliding_coverage = {}
        for i, j, gnm, rc in self._iter_target_genomes():
            self.sliding_coverage.setdefault(i, {}).setdefault(
                j, {False: None, True: None})
            covers = self.target_covers[i][j][rc]
            size = gnm.size(False)

            # Per-base depth via endpoint deltas (reference builds the
            # same uint16 array with a Python endpoint sweep,
            # coverage_analysis.py:368-399)
            delta = np.zeros(size + 1, dtype=np.int64)
            for (s, e) in covers:
                delta[s] += 1
                delta[e] -= 1
            probe_counts = np.cumsum(delta[:size]).astype("uint16")

            prefix = np.zeros(size + 1, dtype=np.int64)
            np.cumsum(probe_counts, out=prefix[1:])

            gnm_sliding_coverage = {}
            for window_start in np.arange(0, size, window_stride):
                window_end = window_start + window_length
                if window_end > size:
                    # Snap the final window to the end (clamped at 0 for
                    # genomes shorter than the window)
                    window_end = size
                    window_start = max(0, window_end - window_length)
                middle = window_start + (window_length / 2)
                avg = (prefix[window_end] - prefix[window_start]) \
                    / float(window_end - window_start)
                gnm_sliding_coverage[middle] = avg
            self.sliding_coverage[i][j][rc] = gnm_sliding_coverage

    def run(self, window_length=50, window_stride=25):
        """Run all analyses (results stored on self)."""
        self._find_covers_in_target_genomes()
        self._compute_bp_covered_in_target_genomes()
        self._compute_average_coverage_in_target_genomes()
        self._compute_sliding_coverage_in_target_genomes(
            window_length, window_stride)

    # ------------------------------------------------------------------
    # Writers
    # ------------------------------------------------------------------

    def write_data_matrix_as_tsv(self, fn):
        """TSV matrix of per-genome coverage stats
        (reference :432-470)."""
        data = [["Genome", "Num bases covered", "Frac bases covered",
                 "Frac bases covered over unambig",
                 "Average coverage/depth",
                 "Average coverage/depth over unambig"]]
        for i, j, gnm, rc in self._iter_target_genomes():
            col_header = "%s, genome %d" % (self.target_genomes_names[i], j)
            if rc:
                col_header += " (rc)"
            bp_covered = self.bp_covered[i][j][rc]
            avg_all, avg_unambig = self.average_coverage[i][j][rc]
            data.append([col_header, bp_covered,
                         float(bp_covered) / gnm.size(False),
                         float(bp_covered) / gnm.size(True),
                         avg_all, avg_unambig])
        with open(fn, "w") as f:
            for row in data:
                f.write("\t".join(str(entry) for entry in row) + "\n")

    def _make_data_matrix_string(self):
        data = [["Genome", "Num bases covered\n[over unambig]",
                 "Average coverage/depth\n[over unambig]"]]
        for i, j, gnm, rc in self._iter_target_genomes():
            col_header = "%s, genome %d" % (self.target_genomes_names[i], j)
            if rc:
                col_header += " (rc)"

            bp_covered = self.bp_covered[i][j][rc]
            frac_all = float(bp_covered) / gnm.size(False)
            frac_unambig = float(bp_covered) / gnm.size(True)
            prct_all = ("<0.01%" if frac_all < 0.0001
                        else "{0:.2%}".format(frac_all))
            prct_unambig = ("<0.01%" if frac_unambig < 0.0001
                            else "{0:.2%}".format(frac_unambig))
            bp_covered_str = "%d (%s) [%s]" % (bp_covered, prct_all,
                                               prct_unambig)

            avg_all, avg_unambig = self.average_coverage[i][j][rc]
            avg_all_str = ("<0.01" if avg_all < 0.01
                           else "{0:.2f}".format(avg_all))
            avg_unambig_str = ("<0.01" if avg_unambig < 0.01
                               else "{0:.2f}".format(avg_unambig))
            avg_str = "%s [%s]" % (avg_all_str, avg_unambig_str)

            data.append([col_header, bp_covered_str, avg_str])
        return data

    def print_analysis(self):
        """Print probe count and the analysis table (reference
        :472-533)."""
        print("NUMBER OF PROBES: %d" % len(self.probes))
        print()
        print(pretty_print.table(self._make_data_matrix_string(),
                                 ["left", "right", "right"],
                                 header_underline=True))

    def write_sliding_window_coverage(self, fn):
        """Sliding-window depth TSV (reference :535-551)."""
        with open(fn, "w") as f:
            for i, j, gnm, rc in self._iter_target_genomes():
                header = "%s, genome %d" % (self.target_genomes_names[i], j)
                if rc:
                    header += " (rc)"
                gnm_sliding_coverage = self.sliding_coverage[i][j][rc]
                for pos in sorted(gnm_sliding_coverage.keys()):
                    covg = gnm_sliding_coverage[pos]
                    f.write("\t".join(str(x) for x in [header, pos, covg])
                            + "\n")

    def write_probe_map_counts(self, fn):
        """Per-probe sequence-mapped counts TSV (reference :553-568)."""
        with open(fn, "w") as f:
            f.write("\t".join(["Probe identifier", "Probe sequence",
                               "Number sequences mapped to"]) + "\n")
            for p, count in self.probe_map_counts.items():
                f.write("\t".join(
                    str(x) for x in [p.identifier(), p.seq_str, count])
                    + "\n")
