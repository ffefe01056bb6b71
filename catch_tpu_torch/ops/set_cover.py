# Copied from catch_tpu/ops/set_cover.py (SetCoverInstance, _solve_host_lazy, _interval_difference, _merge_sorted_intervals).
"""Greedy weighted partial multi-universe set cover, on the host.

The instance comes from the device scan (ops/scan_instance.instance_to_
host); the greedy loop runs here in numpy.  Greedy set cover is
sequential, one pick per iteration, and the lazy solver touches only
the few sets whose stale ratios reach the front of its heap, so the
loop stays on the host while the device does the scan.
"""

import numpy as np

__all__ = ["SetCoverInstance", "solve_instance"]


class SetCoverInstance:
    """A canonicalized multi-universe set-cover instance (flat arrays).

    Attributes:
        n_sets: number of candidate sets S (ids 0..S-1)
        n_universes: number of universes
        u_size: int64[nU] universe sizes |U_u| (count of distinct
            elements in the union of all sets for that universe)
        can_uncover: int64[nU] floor(|U_u| - p_u * |U_u|)
        ivl_start, ivl_end: int64[M] global half-open interval bounds
        pair_of_ivl: int32[M] dense (set, universe)-pair id per interval
        set_of_pair, univ_of_pair: int32[PAIRS]
        cost: float32[S]
        rank_idx: int32[S] index into the sorted distinct rank values
        n_rank_vals: number of distinct ranks
        u_len: total length of the global position axis
    """

    def __init__(self, **kw):
        self.__dict__.update(kw)



def _solve_host_lazy(inst):
    """Lazy-greedy host solver: identical pick order to the full-rescan
    solver catch_tpu/ops/set_cover._solve_host.

    Greedy gains here are submodular: a set's capped score
    sum_pairs min(pair_new, need_u) is nonincreasing over time
    (coverage only grows, need_u only shrinks), so ratios = cost/score
    are nondecreasing.  A min-heap keyed (ratio, set_id) therefore
    reproduces the full per-iteration argmin exactly — including the
    lowest-set-id tie-break — because a set is only picked when either
    (a) its entry was recomputed in the current iteration, or (b) its
    recomputed ratio equals its stale key (then every other stale key
    is >= it and true ratios are >= their stale keys, so it is a true
    minimum; a lower-id true minimum would have popped first).

    The state is incremental: rem[pair] = number of still-uncovered
    positions of that (set, universe) pair, maintained exactly via
    interval algebra.  A refresh is then O(pairs of the set) and a
    pick-apply is O(intervals overlapping the newly covered region),
    instead of the O(total axis length) per refresh that position
    bitmaps force.  This replaces the reference's memoized
    intersection + last-min-ratio machinery
    (reference catch/utils/set_cover.py:268-284, :436-481).
    """
    import heapq

    U = inst.u_len
    S = inst.n_sets
    nU = inst.n_universes
    starts = inst.ivl_start.astype(np.int64, copy=False)
    ends = inst.ivl_end.astype(np.int64, copy=False)
    pair_of_ivl = inst.pair_of_ivl
    set_of_pair = inst.set_of_pair
    univ_of_pair = inst.univ_of_pair
    nP = len(set_of_pair)
    cost32 = inst.cost.astype(np.float32, copy=False)
    rank_idx = inst.rank_idx
    can_uncover = inst.can_uncover.astype(np.int64, copy=False)

    # Intervals are grouped by ascending pair id and pairs by ascending
    # set id (build_instance* emit them sorted); derive contiguous
    # slices so one set's intervals/pairs are a single slice each.
    if nP and not (np.all(pair_of_ivl[1:] >= pair_of_ivl[:-1])
                   and np.all(set_of_pair[1:] >= set_of_pair[:-1])):
        order = np.argsort(pair_of_ivl, kind="stable")
        starts, ends, pair_of_ivl = (starts[order], ends[order],
                                     pair_of_ivl[order])
    pair_ptr = np.zeros(nP + 1, dtype=np.int64)
    np.cumsum(np.bincount(pair_of_ivl, minlength=nP), out=pair_ptr[1:])
    set_ptr = np.zeros(S + 1, dtype=np.int64)
    np.cumsum(np.bincount(set_of_pair, minlength=S), out=set_ptr[1:])

    # A second view of the intervals sorted by start, for "which
    # intervals overlap this region" queries during pick-apply.
    by_start = np.argsort(starts, kind="stable")
    s_sorted = starts[by_start]
    e_sorted = ends[by_start]
    pair_sorted = pair_of_ivl[by_start]
    max_ivl_len = int((ends - starts).max()) if len(starts) else 0

    # rem[pair] = uncovered positions of the pair.  Initially the full
    # pair area: covered0 is the complement of the union of all
    # intervals, and every pair interval lies inside the union.
    rem = np.bincount(pair_of_ivl, weights=ends - starts,
                      minlength=nP).astype(np.int64)
    len_u = inst.u_size.astype(np.int64).copy()
    in_cover = np.zeros(S, dtype=bool)
    need_u = np.maximum(len_u - can_uncover, 0)

    def fresh_score(s):
        p0, p1 = set_ptr[s], set_ptr[s + 1]
        capped = np.minimum(rem[p0:p1], need_u[univ_of_pair[p0:p1]])
        return int(capped.sum()), (p0, p1)

    # Covered region as merged sorted interval arrays (grows over time)
    cov_s = np.empty(0, dtype=np.int64)
    cov_e = np.empty(0, dtype=np.int64)

    def apply_pick(p0, p1):
        """Zero the chosen set's uncovered positions: update rem for
        every interval overlapping the newly covered region, decrement
        len_u, and grow the covered list."""
        nonlocal cov_s, cov_e, len_u
        i0, i1 = pair_ptr[p0], pair_ptr[p1]
        ch_s = starts[i0:i1]
        ch_e = ends[i0:i1]
        # dec per universe = the chosen's current rem per pair
        np.subtract.at(len_u, univ_of_pair[p0:p1], rem[p0:p1])
        # Z = chosen intervals minus already-covered (disjoint pieces)
        z_s, z_e = _interval_difference(ch_s, ch_e, cov_s, cov_e)
        if len(z_s):
            # Intervals possibly overlapping any Z piece: by-start rank
            # window [searchsorted(a - max_len), searchsorted(b))
            lo = np.searchsorted(s_sorted, z_s - max_ivl_len)
            hi = np.searchsorted(s_sorted, z_e)
            for zi in range(len(z_s)):
                a, b = z_s[zi], z_e[zi]
                sl = slice(lo[zi], hi[zi])
                ov = (np.minimum(e_sorted[sl], b)
                      - np.maximum(s_sorted[sl], a))
                m = ov > 0
                if np.any(m):
                    np.subtract.at(rem, pair_sorted[sl][m], ov[m])
            # Merge Z into the covered list
            cov_s, cov_e = _merge_sorted_intervals(cov_s, cov_e, z_s, z_e)

    # Initial scores, vectorized
    score0 = np.bincount(
        set_of_pair, weights=np.minimum(rem, need_u[univ_of_pair]),
        minlength=S).astype(np.int64)

    heaps = [[] for _ in range(inst.n_rank_vals)]
    for s in range(S):
        if score0[s] > 0:
            r = np.float32(cost32[s]) / np.float32(score0[s])
            heaps[rank_idx[s]].append((float(r), s, 0))
    for h in heaps:
        heapq.heapify(h)

    order = []
    cur_rank = 0
    epoch = 0
    while np.any(need_u > 0):
        # Pop until a provably fresh minimum surfaces.
        chosen = None
        chosen_slice = None
        while cur_rank < inst.n_rank_vals:
            h = heaps[cur_rank]
            if not h:
                cur_rank += 1
                continue
            ratio, s, e = heapq.heappop(h)
            if e == epoch:
                chosen = s
                chosen_slice = (set_ptr[s], set_ptr[s + 1])
                break
            sc_val, sl = fresh_score(s)
            if sc_val > 0:
                r = float(np.float32(cost32[s]) / np.float32(sc_val))
                if r == ratio:
                    chosen = s
                    chosen_slice = sl
                    break
                heapq.heappush(h, (r, s, epoch))
            # score 0: drop permanently (scores never grow)
        if chosen is None:
            break

        apply_pick(*chosen_slice)
        need_u = np.maximum(len_u - can_uncover, 0)
        in_cover[chosen] = True
        order.append(chosen)
        epoch += 1
    return np.array(order, dtype=np.int32)


def _interval_difference(a_s, a_e, b_s, b_e):
    """Pieces of the sorted disjoint intervals (a_s, a_e) not covered by
    the sorted disjoint merged intervals (b_s, b_e)."""
    if len(b_s) == 0:
        keep = a_e > a_s
        return a_s[keep].copy(), a_e[keep].copy()
    out_s, out_e = [], []
    # For each a interval, walk the b intervals overlapping it.
    lo = np.searchsorted(b_e, a_s, side="right")
    for i in range(len(a_s)):
        cur = a_s[i]
        end = a_e[i]
        j = lo[i]
        while cur < end and j < len(b_s) and b_s[j] < end:
            if b_s[j] > cur:
                out_s.append(cur)
                out_e.append(b_s[j])
            cur = max(cur, b_e[j])
            j += 1
        if cur < end:
            out_s.append(cur)
            out_e.append(end)
    return (np.array(out_s, dtype=np.int64),
            np.array(out_e, dtype=np.int64))


def _merge_sorted_intervals(a_s, a_e, b_s, b_e):
    """Merge two sorted disjoint interval lists into one (merging
    touching/overlapping intervals)."""
    s = np.concatenate([a_s, b_s])
    e = np.concatenate([a_e, b_e])
    o = np.argsort(s, kind="stable")
    s, e = s[o], e[o]
    if len(s) == 0:
        return s, e
    run_end = np.maximum.accumulate(e)
    new_run = np.empty(len(s), dtype=bool)
    new_run[0] = True
    new_run[1:] = s[1:] > run_end[:-1]
    idx = np.flatnonzero(new_run)
    m_s = s[idx]
    m_e = np.maximum.reduceat(e, idx)
    return m_s, m_e

def solve_instance(inst):
    """Solve a canonicalized instance; returns dense set indices in pick
    order (np.int32 array).

    Runs the lazy-greedy solver.  Its pick order equals that of the
    full-rescan solver catch_tpu/ops/set_cover._solve_host (including
    the lowest-set-id tie-break among equal float32 cost/score ratios),
    which catch_tpu.ops.set_cover.solve_instance runs for tiny
    instances; so the port's picks equal catch_tpu's at every size.
    """
    if inst.n_sets == 0 or inst.u_len == 0 or len(inst.ivl_start) == 0:
        return np.empty(0, dtype=np.int32)
    if np.all(inst.can_uncover >= inst.u_size):
        return np.empty(0, dtype=np.int32)
    return _solve_host_lazy(inst)
