# Copied from catch_tpu/utils/intervals.py.
"""Sorted, non-overlapping integer interval sets (numpy event-sweep based).

Capability parity with the reference's interval structure
(reference catch/utils/interval.py:9-358): immutable sets of
half-open ``(start, end)`` intervals supporting intersection / union /
difference, element counting, overlap queries, ``merge_overlapping`` and
greedy earliest-finish interval ``schedule``.

Unlike the reference's Python two-pointer sweeps, set operations here are
vectorized numpy event sweeps: an operation over two interval sets is a
sort of +/-1 coverage deltas followed by boundary detection.  This keeps
host-side interval bookkeeping cheap even for hundreds of thousands of
intervals (e.g., per-probe coverage of large genomes).
"""

import numpy as np

__all__ = ["IntervalSet", "merge_overlapping", "schedule"]


def _normalize(arr):
    """Sort and coalesce an (n, 2) interval array; touching intervals merge."""
    if arr.shape[0] == 0:
        return arr.reshape(0, 2)
    order = np.lexsort((arr[:, 1], arr[:, 0]))
    arr = arr[order]
    # An interval starts a new merged run iff its start exceeds the running
    # max of all previous ends.
    run_end = np.maximum.accumulate(arr[:, 1])
    new_run = np.empty(arr.shape[0], dtype=bool)
    new_run[0] = True
    new_run[1:] = arr[1:, 0] > run_end[:-1]
    starts = arr[new_run, 0]
    run_idx = np.cumsum(new_run) - 1
    ends = np.maximum.reduceat(arr[:, 1], np.flatnonzero(new_run))
    del run_idx
    return np.stack([starts, ends], axis=1)


def _as_array(intervals):
    if isinstance(intervals, np.ndarray):
        arr = intervals.astype(np.int64, copy=False).reshape(-1, 2)
    else:
        intervals = list(intervals)
        if len(intervals) == 0:
            return np.empty((0, 2), dtype=np.int64)
        arr = np.asarray(intervals, dtype=np.int64).reshape(-1, 2)
    # Drop empty/inverted intervals
    return arr[arr[:, 1] > arr[:, 0]]


class IntervalSet:
    """Immutable set of sorted, non-overlapping half-open int intervals."""

    __slots__ = ("arr", "_len_cached", "_tuples_cached")

    def __init__(self, intervals, _normalized=False):
        if _normalized:
            self.arr = intervals
        else:
            self.arr = _normalize(_as_array(intervals))
        self._len_cached = None
        self._tuples_cached = None

    @property
    def intervals(self):
        """Tuple of (start, end) tuples, for display/compat."""
        if self._tuples_cached is None:
            self._tuples_cached = tuple(
                (int(s), int(e)) for s, e in self.arr)
        return self._tuples_cached

    @property
    def first_start(self):
        return int(self.arr[0, 0]) if self.arr.shape[0] else None

    @property
    def last_end(self):
        return int(self.arr[-1, 1]) if self.arr.shape[0] else None

    def _sweep(self, other, keep):
        """Event-sweep combine: keep(in_self, in_other) selects regions."""
        a, b = self.arr, other.arr
        # Events: position, delta for self (0) or other (1)
        pos = np.concatenate([a[:, 0], a[:, 1], b[:, 0], b[:, 1]])
        if pos.size == 0:
            return IntervalSet(np.empty((0, 2), dtype=np.int64),
                               _normalized=True)
        which = np.concatenate([
            np.zeros(2 * a.shape[0], dtype=np.int8),
            np.ones(2 * b.shape[0], dtype=np.int8)])
        delta = np.concatenate([
            np.ones(a.shape[0], dtype=np.int8),
            -np.ones(a.shape[0], dtype=np.int8),
            np.ones(b.shape[0], dtype=np.int8),
            -np.ones(b.shape[0], dtype=np.int8)])
        order = np.argsort(pos, kind="stable")
        pos, which, delta = pos[order], which[order], delta[order]
        in_a = np.cumsum(np.where(which == 0, delta, 0)) > 0
        in_b = np.cumsum(np.where(which == 1, delta, 0)) > 0
        # State after processing all events at each unique position:
        # compress runs of equal positions, taking the last state.
        last_of_pos = np.empty(pos.size, dtype=bool)
        last_of_pos[:-1] = pos[1:] != pos[:-1]
        last_of_pos[-1] = True
        upos = pos[last_of_pos]
        active = keep(in_a[last_of_pos], in_b[last_of_pos])
        # Regions between consecutive unique positions where 'active' holds
        # from the left position.
        starts_mask = active.copy()
        starts_mask[1:] &= ~active[:-1]
        # Region [upos[i], upos[i+1]) is kept iff active[i]; it closes at
        # upos[i+1] when active[i] & ~active[i+1].  active is always False
        # at the final event (every interval has closed by then).
        ends_mask = np.zeros_like(active)
        ends_mask[1:] = active[:-1] & ~active[1:]
        starts = upos[starts_mask]
        ends = upos[ends_mask]
        out = np.stack([starts, ends], axis=1)
        return IntervalSet(out, _normalized=True)

    def intersection(self, other):
        return self._sweep(other, lambda x, y: x & y)

    def union(self, other):
        # Concatenate and renormalize: cheaper than a sweep, and matches
        # touching-interval merge semantics.
        return IntervalSet(np.concatenate([self.arr, other.arr]))

    def difference(self, other):
        return self._sweep(other, lambda x, y: x & ~y)

    def intersection_count(self, other):
        """len(self.intersection(other)) without building the result."""
        return len(self.intersection(other))

    def overlaps_interval(self, start, end):
        if self.arr.shape[0] == 0 or end <= start:
            return False
        i = np.searchsorted(self.arr[:, 1], start, side="right")
        return i < self.arr.shape[0] and self.arr[i, 0] < end

    def __len__(self):
        if self._len_cached is None:
            self._len_cached = int(np.sum(self.arr[:, 1] - self.arr[:, 0]))
        return self._len_cached

    def __hash__(self):
        return hash(self.intervals)

    def __eq__(self, other):
        return isinstance(other, IntervalSet) and \
            self.arr.shape == other.arr.shape and \
            bool(np.all(self.arr == other.arr))

    def __str__(self):
        return str(self.intervals)

    def __repr__(self):
        return str(self.intervals)


def merge_overlapping(intervals):
    """Merge possibly-overlapping (start, end) tuples; touching merge.

    Returns a sorted list of tuples (reference parity:
    reference catch/utils/interval.py:288-316).
    """
    arr = _as_array(intervals)
    if arr.shape[0] == 0:
        return []
    return [(int(s), int(e)) for s, e in _normalize(arr)]


def schedule(intervals):
    """Greedy earliest-finish interval scheduling.

    Args:
        intervals: list of ((start, end), obj) pairs.

    Returns:
        list of objs of a maximum set of pairwise non-overlapping
        intervals, chosen by the earliest-finish greedy rule (reference
        parity: reference catch/utils/interval.py:319-358).
    """
    chosen = []
    last_end = None
    for (start, end), obj in sorted(intervals, key=lambda x: x[0][1]):
        if last_end is None or start >= last_end:
            chosen.append(obj)
            last_end = end
    return chosen
