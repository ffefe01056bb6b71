# Copied from catch_tpu/filters/naive_redundant.py.
"""Naive redundancy filters (baselines used by design_naively).

Behavioral parity with the reference
(reference catch/filter/naive_redundant_filter.py:26-216):
iterate probes and delete later probes redundant to earlier kept ones,
with shift+mismatch-count and LCS-based redundancy functions.  The
mismatch comparisons are vectorized via the Probe byte arrays.
"""

import logging

from catch_tpu_torch.filters.base import BaseFilter
from catch_tpu_torch.utils import lcs

logger = logging.getLogger(__name__)

__all__ = ["NaiveRedundantFilter", "redundant_shift_and_mismatch_count",
           "redundant_longest_common_substring"]


class NaiveRedundantFilter(BaseFilter):
    """Keeps each probe and deletes subsequent redundant probes."""

    def __init__(self, are_redundant_fn=None):
        if are_redundant_fn is None:
            are_redundant_fn = redundant_shift_and_mismatch_count(
                shift=0, mismatch_thres=0)
        self.are_redundant_fn = are_redundant_fn

    def _filter(self, input):
        # Delete by index, not by probe object: identical probes hash
        # equal, and only the later duplicate should be deleted
        # (reference :46-77)
        to_delete = set()
        for i in range(len(input)):
            if i % 100 == 0:
                logger.info("Processing candidate probe %d of %d", i + 1,
                            len(input))
            if i in to_delete:
                continue
            probe_a = input[i]
            for j in range(i + 1, len(input)):
                if j in to_delete:
                    continue
                if self.are_redundant_fn(probe_a, input[j]):
                    to_delete.add(j)
        return [p for i, p in enumerate(input) if i not in to_delete]


def redundant_shift_and_mismatch_count(shift=0, mismatch_thres=0,
                                       quick=True,
                                       quick_mismatch_cutoff=10):
    """Redundant iff min mismatches over shifts in [-shift, shift] is
    <= mismatch_thres (reference :80-143; the 'quick' early-exit path
    is subsumed by the vectorized comparison)."""
    del quick, quick_mismatch_cutoff  # vectorized path is always fast

    def are_redundant(probe_a, probe_b):
        return probe_a.min_mismatches_within_shift(
            probe_b, shift) <= mismatch_thres
    return are_redundant


def redundant_longest_common_substring(mismatches, lcf_thres,
                                       prune_with_heuristic_and_anchor=True):
    """Redundant iff the LCS with <= mismatches mismatches is >=
    lcf_thres; optional shares_some_kmers prune + anchored LCS
    (reference :146-215)."""

    def are_redundant(probe_a, probe_b):
        if prune_with_heuristic_and_anchor:
            kmer = probe_a.shares_some_kmers(probe_b, return_kmer=True)
            if not kmer:
                return False
            probe_a_str = probe_a.seq_str
            probe_b_str = probe_b.seq_str
            probe_a_pos = probe_a_str.find(kmer)
            probe_b_pos = probe_b_str.find(kmer)
            assert probe_a_pos >= 0 and probe_b_pos >= 0
            if probe_a_pos > probe_b_pos:
                probe_a_str = probe_a_str[(probe_a_pos - probe_b_pos):]
                anchor_start = probe_b_pos
            else:
                probe_b_str = probe_b_str[(probe_b_pos - probe_a_pos):]
                anchor_start = probe_a_pos
            anchor_end = anchor_start + len(kmer)
            lcf_length, _ = lcs.k_lcf_around_anchor(
                probe_a_str, probe_b_str, anchor_start, anchor_end,
                mismatches)
            return lcf_length >= lcf_thres
        lcf_length = probe_a.longest_common_substring_length(
            probe_b, mismatches)
        return lcf_length >= lcf_thres
    return are_redundant
