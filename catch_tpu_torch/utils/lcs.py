# Copied from catch_tpu/utils/lcs.py.
"""Longest common substring (factor) with <= k mismatches — host oracle.

Numpy-vectorized implementations with the same contracts as the
reference's diagonal-scan algorithms
(reference catch/utils/longest_common_substring.py:11-159):

- ``k_lcf(a, b, k)``: longest common substring with at most k mismatches
  over all alignments of a and b; returns (length, start_in_a,
  start_in_b) with first-diagonal / leftmost tie-breaking.
- ``k_lcf_around_anchor(a, b, s, e, k)``: longest common substring
  constrained to contain the shared anchor a[s:e] == b[s:e]; returns
  (length, start).

These run on the host and serve three roles: (1) oracle for property
tests of the TPU cover kernel, (2) the inner comparator for host-side
filters (PolyAFilter, NaiveRedundantFilter), (3) the plug-in point where
the default hybridization model's semantics are defined exactly once.

Rather than the reference's O(k)-space deque scan per diagonal, each
diagonal's longest <=k-mismatch run is computed from the sorted mismatch
positions: with sentinel-padded mismatch positions P (P[0] = -1,
P[nm+1] = n), the maximal windows are (P[t], P[t+k+1]) exclusive and the
answer is max_t of P[t+k+1] - P[t] - 1.  The same "maximal window"
formulation is what the TPU verify kernel uses (catch_tpu/ops/cover.py),
so the oracle and the kernel share their math.
"""

import numpy as np

__all__ = ["k_lcf", "k_lcf_around_anchor", "longest_run_leq_k"]


def _as_codes(x):
    """View a sequence (str or np array) as a numpy array for comparison."""
    if isinstance(x, np.ndarray):
        return x
    return np.frombuffer(x.encode("ascii"), dtype=np.uint8)


def longest_run_leq_k(mismatch_positions, n, k):
    """Longest window with <= k mismatches given sorted mismatch positions.

    Args:
        mismatch_positions: sorted int array of mismatch indices in [0, n)
        n: total window length
        k: allowed mismatches

    Returns:
        (length, start) of the longest window containing <= k mismatches,
        earliest window on ties.
    """
    nm = len(mismatch_positions)
    if nm <= k:
        return n, 0
    # Sentinel-padded positions: P[0]=-1, P[1..nm]=positions, P[nm+1]=n
    P = np.empty(nm + 2, dtype=np.int64)
    P[0] = -1
    P[1:nm + 1] = mismatch_positions
    P[nm + 1] = n
    # Window t spans (P[t], P[t+k+1]) exclusive, t in 0..nm-k
    lengths = P[k + 1:] - P[:nm + 1 - k] - 1
    t = int(np.argmax(lengths))
    return int(lengths[t]), int(P[t] + 1)


def k_lcf(a, b, k):
    """Longest common substring of a and b with at most k mismatches.

    Returns:
        (l, s_a, s_b): length and start positions in a and b.  Ties are
        broken by the earliest diagonal d = s_a - s_b (scanning d from
        -(len(b)-1) to len(a)-1), then the earliest start.
    """
    a = _as_codes(a)
    b = _as_codes(b)
    n, m = len(a), len(b)
    best_l, best_sa, best_sb = 0, 0, 0
    for d in range(-m + 1, n):
        i = max(-d, 0) + d  # start in a
        j = max(-d, 0)      # start in b
        span = min(n - i, m - j)
        if span <= best_l:
            continue
        mism = np.flatnonzero(a[i:i + span] != b[j:j + span])
        length, start = longest_run_leq_k(mism, span, k)
        if length > best_l:
            best_l = length
            best_sa = i + start
            best_sb = j + start
    return best_l, best_sa, best_sb


def k_lcf_around_anchor(a, b, anchor_start, anchor_end, k):
    """Longest common substring containing the shared anchor a[s:e]==b[s:e].

    Extends outward from the anchor allocating i mismatches left and
    k - i right for each split i, taking the longest
    (reference contract:
    reference catch/utils/longest_common_substring.py:59-159).

    Returns:
        (l, start): length and common start index (same in a and b).

    Raises:
        ValueError if the anchors differ between a and b.
    """
    a = _as_codes(a)
    b = _as_codes(b)
    if len(a) > len(b):
        a = a[:len(b)]
    elif len(b) > len(a):
        b = b[:len(a)]
    if np.any(a[anchor_start:anchor_end] != b[anchor_start:anchor_end]):
        raise ValueError("anchors are different in a and b")

    mism = a != b
    # Distance (in matching bases) from the anchor to each successive
    # mismatch moving left of the anchor / right of the anchor.
    before = np.flatnonzero(mism[:anchor_start][::-1])
    after = np.flatnonzero(mism[anchor_end:])

    anchor_len = anchor_end - anchor_start
    i = np.arange(k + 1)
    before_len = np.where(i < len(before),
                          before[np.minimum(i, max(len(before) - 1, 0))]
                          if len(before) else 0,
                          anchor_start)
    ri = k - i
    after_len = np.where(ri < len(after),
                         after[np.minimum(ri, max(len(after) - 1, 0))]
                         if len(after) else 0,
                         len(a) - anchor_end)
    lengths = before_len + anchor_len + after_len
    best = int(np.argmax(lengths))  # earliest i wins ties
    return int(lengths[best]), int(anchor_start - before_len[best])
