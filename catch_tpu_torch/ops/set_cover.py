# Copied from catch_tpu/ops/set_cover.py (SetCoverInstance, build_instance, _solve_host, _solve_host_lazy, _interval_difference, _merge_sorted_intervals, _merge_by_group, build_instance_from_cover_arrays, approx_multiuniverse, approx).
"""Greedy weighted partial multi-universe set cover, on the host and on
the device.

build_instance canonicalizes the reference's dict-of-sets input (used
by approx and approx_multiuniverse, which the dominating-set filter
calls), and build_instance_from_cover_arrays the scan's flat spans.
Two routes take an instance to its pick order.  The default reads the
merged instance back (ops/scan_instance.instance_to_host) and runs the
lazy greedy solver here in numpy; it touches only the few sets whose
stale ratios reach the front of its heap.  The device route
(CATCH_TPU_SOLVE=device in the set-cover filter) keeps the instance on
its device, where stage E (scan_instance.ensure_assembled) has built
boundary-indexed arrays, and runs every greedy step there; only the
picks come back.  Its kernels (sources in catch_tpu_torch/csrc/):

  K11 init_covered  covered0, the complement of the union of all
                    intervals (catch_tpu _init_covered_jit)
  K12 greedy_v2     greedy steps over boundary-indexed arrays, for
                    solve_boundary_instance (_steps_jit_v2)
  K13 greedy_v1     greedy steps over a host SetCoverInstance, regrouped
                    set-major once a solve (set_major_index):
                    solve_instance(force_device=True) and the
                    device-resident loop _solve_device (_steps_jit,
                    _solve_jit_padded)

A step's state is a dict: covered (bool[U]), len_u (int32[nU],
uncovered positions per universe), in_cover (bool[S]), cur_rank and
stop (0-d int32 and bool), and for the device-resident loop order
(int32[S]) and n_chosen (0-d int32).  The step functions update it in
place (catch_tpu donates the same buffers).  Every route gives the same
pick order: the first argmin of float32 cost / score in the current
rank tier, ties to the lowest set id.

Left out from catch_tpu: the power-of-two padding (dummy sets, pairs,
universes and empty intervals), and the fallback from a failed device
solve to the host; a device solve that fails, or that reaches its
dispatch bound without stopping, raises.  Kept: an instance whose
position axis does not fit int32 is solved on the host, a size checked
before any launch (_DEVICE_AXIS_LIMIT); so is one whose K12 or K13
overlap index would not (_K12_PIECE_LIMIT, a limit catch_tpu does not
have).
Every kernel wrapper runs its plain-PyTorch twin (same module, name
suffixed _plain) for CPU tensors and its kernel for CUDA tensors, and
counts its launches in an integer attribute `launches`; the wrappers
are registered in scan_instance.KERNELS.
"""

import logging

import numpy as np
import torch

from catch_tpu_torch import _build
from catch_tpu_torch.device import resolve_device
from catch_tpu_torch.ops import scan_instance as si
from catch_tpu_torch.utils import intervals as intervals_mod
from catch_tpu_torch.utils import profiling

logger = logging.getLogger(__name__)

__all__ = ["SetCoverInstance", "solve_instance", "solve_boundary_instance",
           "check_instance_axis", "build_instance", "approx_multiuniverse",
           "approx",
           "assembled_instance", "build_instance_from_cover_arrays",
           "init_covered", "greedy_steps_v2", "greedy_steps_v1",
           "initial_state"]

# The device solvers' position axis rides int32: an instance whose axis
# reaches this many positions is solved on the host (solve_instance, and
# SetCoverFilter under CATCH_TPU_SOLVE=device), as catch_tpu does.
_DEVICE_AXIS_LIMIT = np.iinfo(np.int32).max

# Greedy steps a device dispatch runs between two readbacks of its
# picks (catch_tpu's _STEPS_PER_DISPATCH).  Steps after the stop change
# nothing but cur_rank.
_STEPS_PER_DISPATCH = 64

# Positions a tile of the kernels' prefix scan holds (CT_SCAN_TILE in
# csrc/greedy.cuh); sizes its tile buffer.
_SCAN_TILE = 4096
# Positions a tile of K11's max-scan holds (IC_TILE in
# csrc/init_covered.cu).
_IC_TILE = 8192

# K12 and K13 (csrc/greedy_v2.cu, csrc/greedy_v1.cu): positions a tile
# of their overlap indexes holds (K12_TILE, K13_TILE), threads of a
# score block (CT_GROUP_THREADS in csrc/greedy.cuh), and the bits that
# select their launches (CT_RECOMPUTE and the others).
_K12_TILE = 256
_GROUP_THREADS = 256
_STAGES = dict(recompute=1, score=2, decide=4, update=8)

# K12's and K13's indexes number their pieces (an interval cut to one
# tile) with int32 offsets: an instance whose index would hold this many
# pieces or more is solved on the host (solve_boundary_instance,
# _solve_device_steps, _solve_device), as catch_tpu, whose steps build
# no index, solves it.
_K12_PIECE_LIMIT = np.iinfo(np.int32).max


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


def _runs_to_intervals(sorted_vals):
    """Convert a sorted int array to half-open intervals of consecutive runs."""
    if len(sorted_vals) == 0:
        return np.empty((0, 2), dtype=np.int64)
    breaks = np.flatnonzero(np.diff(sorted_vals) != 1)
    starts = np.concatenate(([0], breaks + 1))
    ends = np.concatenate((breaks, [len(sorted_vals) - 1]))
    return np.stack([sorted_vals[starts], sorted_vals[ends] + 1], axis=1)


def build_instance(sets, costs=None, universe_p=None, ranks=None,
                   use_intervalsets=False):
    """Canonicalize the reference-style dict inputs into flat arrays.

    Args:
        sets: dict set_id -> dict universe_id -> (set | array | list |
            IntervalSet | single (start, end) tuple)
        costs / universe_p / ranks: as in the reference API
        use_intervalsets: values are IntervalSets / single-interval
            tuples over ints; their coordinates are used directly
            (per-universe, offset to the universe's global slice)

    Returns:
        (instance, set_id_list): instance arrays + original set ids in
        dense order (sorted for determinism).
    """
    set_id_list = sorted(sets.keys(), key=_sort_key)
    universe_ids = set()
    for sbu in sets.values():
        universe_ids.update(sbu.keys())
    universe_id_list = sorted(universe_ids, key=_sort_key)
    u_index = {u: i for i, u in enumerate(universe_id_list)}
    nU = len(universe_id_list)

    if costs is None:
        cost = np.ones(len(set_id_list), dtype=np.float32)
    else:
        for c in costs.values():
            if c < 0:
                raise ValueError("All costs must be nonnegative")
        for sid in set_id_list:
            if sid not in costs:
                raise ValueError(f"costs is missing a value for set {sid}")
        cost = np.array([costs[sid] for sid in set_id_list], dtype=np.float32)

    if ranks is None:
        rank_arr = np.ones(len(set_id_list), dtype=np.int64)
    else:
        for sid in set_id_list:
            if sid not in ranks:
                raise ValueError(f"ranks is missing a value for set {sid}")
        rank_arr = np.array([ranks[sid] for sid in set_id_list],
                            dtype=np.int64)
    rank_vals = np.unique(rank_arr)
    rank_idx = np.searchsorted(rank_vals, rank_arr).astype(np.int32)

    # Per-universe interval lists in local (within-universe) coordinates.
    per_set_ivls = []  # list of (set_idx, univ_idx, (k,2) local intervals)
    if use_intervalsets:
        # Coordinates are ints used directly; per universe record min/max
        # to build a compact global slice.
        u_min = np.full(nU, np.iinfo(np.int64).max, dtype=np.int64)
        u_max = np.full(nU, np.iinfo(np.int64).min, dtype=np.int64)
        for si, sid in enumerate(set_id_list):
            for uid, s in sets[sid].items():
                ui = u_index[uid]
                if isinstance(s, tuple):
                    arr = np.array([s], dtype=np.int64)
                else:
                    arr = np.asarray(
                        [list(i) for i in s.intervals], dtype=np.int64
                    ).reshape(-1, 2)
                if arr.shape[0] == 0:
                    continue
                u_min[ui] = min(u_min[ui], int(arr[:, 0].min()))
                u_max[ui] = max(u_max[ui], int(arr[:, 1].max()))
                per_set_ivls.append((si, ui, arr))
        base = np.where(u_min > u_max, 0, u_min)
        span = np.maximum(u_max - base, 0)
        per_set_ivls = [(si, ui, a - base[ui]) for (si, ui, a) in per_set_ivls]
        u_span = span
    else:
        # Arbitrary hashable elements: densify per universe by sorted
        # element order so consecutive values form intervals.
        u_elements = [dict() for _ in range(nU)]
        collected = []
        for si, sid in enumerate(set_id_list):
            for uid, s in sets[sid].items():
                ui = u_index[uid]
                vals = list(s)
                for v in vals:
                    u_elements[ui][v] = None
                collected.append((si, ui, vals))
        u_rank = []
        for ui in range(nU):
            ordered = sorted(u_elements[ui].keys(), key=_sort_key)
            u_rank.append({v: i for i, v in enumerate(ordered)})
        u_span = np.array([len(r) for r in u_rank], dtype=np.int64)
        for si, ui, vals in collected:
            if not vals:
                continue
            dense = np.unique(
                np.array([u_rank[ui][v] for v in vals], dtype=np.int64))
            per_set_ivls.append((si, ui, _runs_to_intervals(dense)))

    offsets = np.zeros(nU + 1, dtype=np.int64)
    np.cumsum(u_span, out=offsets[1:])
    u_len = int(offsets[-1])

    # Merge intervals per (set, universe) and flatten with dense pair ids.
    pair_key = {}
    set_of_pair, univ_of_pair = [], []
    ivl_start, ivl_end, pair_of_ivl = [], [], []
    for si, ui, arr in per_set_ivls:
        if arr.shape[0] == 0:
            continue
        merged = intervals_mod.merge_overlapping(
            [(int(a), int(b)) for a, b in arr])
        key = (si, ui)
        if key not in pair_key:
            pair_key[key] = len(set_of_pair)
            set_of_pair.append(si)
            univ_of_pair.append(ui)
        pid = pair_key[key]
        for a, b in merged:
            ivl_start.append(a + offsets[ui])
            ivl_end.append(b + offsets[ui])
            pair_of_ivl.append(pid)

    ivl_start = np.array(ivl_start, dtype=np.int64)
    ivl_end = np.array(ivl_end, dtype=np.int64)
    pair_of_ivl = np.array(pair_of_ivl, dtype=np.int32)
    set_of_pair = np.array(set_of_pair, dtype=np.int32)
    univ_of_pair = np.array(univ_of_pair, dtype=np.int32)

    # Universe sizes = number of elements in the union of all intervals
    # per universe (for intervalsets mode the span may exceed the union).
    u_size = np.zeros(nU, dtype=np.int64)
    if len(ivl_start):
        in_universe = _union_indicator(ivl_start, ivl_end, u_len)
        pos_univ = np.searchsorted(offsets, np.arange(u_len), side="right") - 1
        u_size = np.bincount(pos_univ, weights=in_universe,
                             minlength=nU).astype(np.int64)

    if universe_p is None:
        p_arr = np.ones(nU, dtype=np.float64)
    else:
        for p in universe_p.values():
            if p < 0 or p > 1:
                raise ValueError(
                    "The coverage fraction (p) of each universe must be "
                    "in [0,1]")
        for uid in universe_id_list:
            if uid not in universe_p:
                raise ValueError(
                    f"universe_p is missing a value for universe {uid}")
        p_arr = np.array([universe_p[uid] for uid in universe_id_list],
                         dtype=np.float64)
    # Reference floor semantics: int(len - p*len)
    # (reference catch/utils/set_cover.py:362-373)
    can_uncover = (u_size - p_arr * u_size).astype(np.int64)

    inst = SetCoverInstance(
        n_sets=len(set_id_list), n_universes=nU, u_size=u_size,
        can_uncover=can_uncover, ivl_start=ivl_start, ivl_end=ivl_end,
        pair_of_ivl=pair_of_ivl, set_of_pair=set_of_pair,
        univ_of_pair=univ_of_pair, cost=cost, rank_idx=rank_idx,
        n_rank_vals=len(rank_vals), u_len=u_len,
        pos_univ_offsets=offsets)
    return inst, set_id_list


def _sort_key(x):
    """Deterministic ordering for possibly-mixed-type hashables."""
    return (type(x).__name__, x if isinstance(x, (int, float, str, tuple))
            else repr(x))


def _union_indicator(starts, ends, n):
    delta = np.zeros(n + 1, dtype=np.int64)
    np.add.at(delta, starts, 1)
    np.add.at(delta, ends, -1)
    return (np.cumsum(delta[:n]) > 0).astype(np.int64)


def _solve_host(inst):
    """Full-rescan greedy solver: every step rescores every set (same
    dtypes and tie-breaking as the device steps).  The reference that
    _solve_host_lazy's pick order is held to; solve_instance runs the
    lazy solver."""
    U = inst.u_len
    M = len(inst.ivl_start)
    nP = len(inst.set_of_pair)
    S = inst.n_sets
    nU = inst.n_universes
    starts = inst.ivl_start.astype(np.int64)
    ends = inst.ivl_end.astype(np.int64)
    pair_of_ivl = inst.pair_of_ivl
    set_of_pair = inst.set_of_pair
    univ_of_pair = inst.univ_of_pair
    cost = inst.cost
    rank_idx = inst.rank_idx
    can_uncover = inst.can_uncover.astype(np.int64)

    covered = ~(_union_indicator(starts, ends, U).astype(bool))
    len_u = inst.u_size.astype(np.int64).copy()
    in_cover = np.zeros(S, dtype=bool)
    order = []
    cur_rank = 0
    while True:
        need_u = np.maximum(len_u - can_uncover, 0)
        if not np.any(need_u > 0):
            break
        prefix = np.zeros(U + 1, dtype=np.int64)
        np.cumsum(~covered, out=prefix[1:])
        new_ivl = prefix[ends] - prefix[starts]
        pair_new = np.bincount(pair_of_ivl, weights=new_ivl,
                               minlength=nP).astype(np.int64)
        pair_capped = np.minimum(pair_new, need_u[univ_of_pair])
        score = np.bincount(set_of_pair, weights=pair_capped,
                            minlength=S).astype(np.int64)
        elig = (~in_cover) & (rank_idx == cur_rank) & (score > 0)
        if not np.any(elig):
            cur_rank += 1
            if cur_rank >= inst.n_rank_vals:
                break
            continue
        ratio = np.where(
            elig,
            cost.astype(np.float32)
            / np.maximum(score, 1).astype(np.float32),
            np.float32(np.inf))
        chosen = int(np.argmin(ratio))
        msk = set_of_pair[pair_of_ivl] == chosen
        if np.any(msk):
            cov = _union_indicator(starts[msk], ends[msk], U).astype(bool)
            covered |= cov
        dec = np.bincount(univ_of_pair,
                          weights=np.where(set_of_pair == chosen,
                                           pair_new, 0),
                          minlength=nU).astype(np.int64)
        len_u -= dec
        in_cover[chosen] = True
        order.append(chosen)
    return np.array(order, dtype=np.int32)


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


def _merge_by_group(group_key, starts, ends):
    """Merge overlapping/touching intervals within each group.

    Args:
        group_key: int64[M] group id per interval (need not be sorted)
        starts, ends: int64[M]

    Returns:
        (group_key, starts, ends) of the merged intervals, sorted by
        (group, start).
    """
    if len(starts) == 0:
        return group_key, starts, ends
    # Sort by (group, start): a single composite-key argsort is ~5x
    # faster than np.lexsort at millions of intervals.  End order
    # within equal (group, start) is irrelevant to the running-max
    # merge below.  Fall back to lexsort if the key would overflow.
    s_min = int(starts.min())
    s_span = int(ends.max()) - s_min + 2
    g_max = int(group_key.max())
    if (g_max + 1) * s_span < np.iinfo(np.int64).max // 2:
        key = group_key * np.int64(s_span) + (starts - s_min)
        order = np.argsort(key, kind="stable")
    else:
        order = np.lexsort((ends, starts, group_key))
    g = group_key[order]
    s = starts[order]
    e = ends[order]
    # Shift each group into a disjoint coordinate band so a single
    # global running max implements a per-group running max.
    big = np.int64(max(int(e.max()) - int(s.min()) + 2, 2))
    gi = np.cumsum(np.concatenate(([0], (np.diff(g) != 0).astype(np.int64))))
    s_off = s - s.min() + gi * big
    e_off = e - s.min() + gi * big
    run_end = np.maximum.accumulate(e_off)
    new_run = np.empty(len(s), dtype=bool)
    new_run[0] = True
    new_run[1:] = s_off[1:] > run_end[:-1]
    run_idx = np.flatnonzero(new_run)
    m_start = s[run_idx]
    m_end = np.maximum.reduceat(e_off, run_idx) - gi[run_idx] * big \
        + s.min()
    return g[run_idx], m_start, m_end


def build_instance_from_cover_arrays(set_ids, univ_ids, starts, ends,
                                     n_sets, n_universes, universe_p,
                                     ranks=None, costs=None):
    """Build a SetCoverInstance directly from flat cover arrays.

    The fast path for the probe-design pipeline: the cover engine emits
    (probe set_id, universe j, start, end) spans in genome-global
    coordinates; no per-probe Python dicts are materialized (unlike the
    reference's sets-of-IntervalSets, set_cover_filter.py:359-470).

    Args:
        set_ids, univ_ids, starts, ends: int arrays, one entry per
            cover interval (within-universe coordinates)
        n_sets: total number of candidate sets (ids 0..n_sets-1)
        n_universes: number of universes (ids 0..n_universes-1)
        universe_p: float64[n_universes] required coverage fraction
        ranks: int64[n_sets] (default all 1)
        costs: float32[n_sets] (default all 1)

    Returns:
        SetCoverInstance
    """
    set_ids = np.asarray(set_ids, dtype=np.int64)
    univ_ids = np.asarray(univ_ids, dtype=np.int64)
    starts = np.asarray(starts, dtype=np.int64)
    ends = np.asarray(ends, dtype=np.int64)
    universe_p = np.asarray(universe_p, dtype=np.float64)

    if costs is None:
        cost = np.ones(n_sets, dtype=np.float32)
    else:
        cost = np.asarray(costs, dtype=np.float32)
    if ranks is None:
        rank_arr = np.ones(n_sets, dtype=np.int64)
    else:
        rank_arr = np.asarray(ranks, dtype=np.int64)
    rank_vals = np.unique(rank_arr)
    rank_idx = np.searchsorted(rank_vals, rank_arr).astype(np.int32)

    # Universe spans = max end seen per universe (coordinates are local
    # to the universe; the global axis concatenates them).
    u_span = np.zeros(n_universes, dtype=np.int64)
    if len(starts):
        np.maximum.at(u_span, univ_ids, ends)
    offsets = np.zeros(n_universes + 1, dtype=np.int64)
    np.cumsum(u_span, out=offsets[1:])
    u_len = int(offsets[-1])

    g_start = starts + offsets[univ_ids]
    g_end = ends + offsets[univ_ids]

    # Merge per (set, universe); pair key = set * nU + univ
    pair_key = set_ids * n_universes + univ_ids
    mk, ms, me = _merge_by_group(pair_key, g_start, g_end)
    pair_ids, pair_of_ivl = np.unique(mk, return_inverse=True)
    set_of_pair = (pair_ids // n_universes).astype(np.int32)
    univ_of_pair = (pair_ids % n_universes).astype(np.int32)

    # Universe sizes: union of all intervals per universe (sweep).
    u_size = np.zeros(n_universes, dtype=np.int64)
    if len(ms):
        uk, us, ue = _merge_by_group(univ_of_pair[pair_of_ivl].astype(
            np.int64), ms, me)
        np.add.at(u_size, uk, ue - us)

    can_uncover = (u_size - universe_p * u_size).astype(np.int64)

    return SetCoverInstance(
        n_sets=n_sets, n_universes=n_universes, u_size=u_size,
        can_uncover=can_uncover, ivl_start=ms, ivl_end=me,
        pair_of_ivl=pair_of_ivl.astype(np.int32),
        set_of_pair=set_of_pair, univ_of_pair=univ_of_pair,
        cost=cost, rank_idx=rank_idx, n_rank_vals=len(rank_vals),
        u_len=u_len, pos_univ_offsets=offsets)


# ----------------------------------------------------------------------
# Device solver: the step state and its checks
# ----------------------------------------------------------------------

_STATE_TYPES = dict(covered=torch.bool, len_u=torch.int32,
                    in_cover=torch.bool, cur_rank=torch.int32,
                    stop=torch.bool, order=torch.int32,
                    n_chosen=torch.int32)
_CONST_TYPES = dict(ivl_start=torch.int32, ivl_end=torch.int32,
                    pair_bounds=torch.int32, set_bounds=torch.int32,
                    pair_of_ivl=torch.int32, set_of_pair=torch.int32,
                    univ_of_pair=torch.int32, cost=torch.float32,
                    rank_idx=torch.int32, can_uncover=torch.int32)
_V2_CONSTS = ("ivl_start", "ivl_end", "pair_bounds", "set_bounds",
              "univ_of_pair", "cost", "rank_idx", "can_uncover")
_V1_CONSTS = ("ivl_start", "ivl_end", "pair_of_ivl", "set_of_pair",
              "univ_of_pair", "cost", "rank_idx", "can_uncover")


def initial_state(covered, u_size, n_sets, keep_order=False):
    """The state before the first greedy step: nothing chosen, rank
    tier 0, len_u = u_size (copied to int32).  With keep_order, also the
    device-resident pick order (filled with -1) and its length."""
    dev = covered.device
    state = dict(covered=covered,
                 len_u=u_size.to(device=dev, dtype=torch.int32, copy=True),
                 in_cover=torch.zeros(n_sets, dtype=torch.bool, device=dev),
                 cur_rank=torch.zeros((), dtype=torch.int32, device=dev),
                 stop=torch.zeros((), dtype=torch.bool, device=dev))
    if keep_order:
        state["order"] = torch.full((n_sets,), -1, dtype=torch.int32,
                                    device=dev)
        state["n_chosen"] = torch.zeros((), dtype=torch.int32, device=dev)
    return state


def _step_tensors(state, consts, const_names, n_steps):
    """The state's and the instance's tensors, checked for type,
    contiguity and shape; returns them with (U, nU, S, M, P)."""
    if n_steps < 1:
        raise ValueError("n_steps must be at least 1")
    named = [(k, state[k]) for k in _STATE_TYPES if k in state]
    named += [(k, consts[k]) for k in const_names]
    if ("order" in state) != ("n_chosen" in state):
        raise ValueError("state holds one of order and n_chosen alone")
    for k, t in named:
        si._require(t, _STATE_TYPES.get(k, _CONST_TYPES.get(k)), k)
    U = state["covered"].numel()
    nU = state["len_u"].numel()
    S = consts["cost"].numel()
    M = consts["ivl_start"].numel()
    P = consts["univ_of_pair"].numel()
    want = dict(in_cover=S, rank_idx=S, can_uncover=nU, ivl_end=M,
                pair_of_ivl=M, set_of_pair=P, pair_bounds=P + 1,
                set_bounds=S + 1, order=S, cur_rank=1, stop=1, n_chosen=1)
    for k, t in named:
        if k in want and t.numel() != want[k]:
            raise ValueError(f"{k} holds {t.numel()} values, not {want[k]}")
    return [t for _, t in named], (U, nU, S, M, P)


# ----------------------------------------------------------------------
# K11 init_covered
# ----------------------------------------------------------------------

@_build.on_own_device
def init_covered(ivl_start, ivl_end, U):
    """bool[U]: True where no interval [ivl_start, ivl_end) lies, the
    solver's initial coverage.  ivl_start, ivl_end: int32 global
    coordinates in [0, U]; empty intervals add nothing.

    Replaces catch_tpu/ops/set_cover.py _init_covered_jit (:661-668);
    the kernel is csrc/init_covered.cu: one atomicMax a nonempty
    interval into reach[start], then a single-pass max-scan,
    covered[i] = max(reach[:i + 1]) <= i (bandwidth bound).  No host
    read.
    """
    si._require(ivl_start, torch.int32, "ivl_start")
    si._require(ivl_end, torch.int32, "ivl_end")
    if si._on_cpu(ivl_start, ivl_end):
        return _init_covered_plain(ivl_start, ivl_end, U)
    dev = ivl_start.device
    covered = torch.empty(U, dtype=torch.bool, device=dev)
    # The ticket, the look-back state of each tile (flag, aggregate,
    # inclusive prefix) and reach, 16-byte aligned, in one zeroed buffer.
    n_tiles = -(-U // _IC_TILE)
    reach_off = -(-(1 + 3 * n_tiles) // 4) * 4
    ws = torch.empty(reach_off + U, dtype=torch.int32, device=dev)
    vec = all(t.data_ptr() % 16 == 0 for t in (ivl_start, ivl_end))
    lib = _build.library()
    _build.check(lib.ct_init_covered(
        _build.ptr(ivl_start), _build.ptr(ivl_end), ivl_start.numel(),
        int(vec), U, _build.ptr(ws), ws.numel(), reach_off,
        _build.ptr(covered), _build.stream_of(ivl_start)), "init_covered")
    init_covered.launches += 1
    return covered


init_covered.launches = 0


def _init_covered_plain(ivl_start, ivl_end, U):
    """Plain-PyTorch twin of init_covered."""
    nonempty = (ivl_end > ivl_start).to(torch.int32)
    delta = torch.zeros(U + 1, dtype=torch.int32, device=ivl_start.device)
    delta.index_add_(0, ivl_start.long(), nonempty)
    delta.index_add_(0, ivl_end.long(), -nonempty)
    return torch.cumsum(delta[:U], 0) <= 0


# ----------------------------------------------------------------------
# K12 greedy_v2 and K13 greedy_v1
# ----------------------------------------------------------------------

@_build.on_own_device
def greedy_steps_v2(state, consts, n_steps):
    """Run n_steps greedy steps on a boundary-indexed instance.

    state: see the module docstring (updated in place).  consts: the
    instance as ensure_assembled leaves it in the scan's dict:
    ivl_start / ivl_end (int32[M]), pair_bounds (int32[P + 1]),
    set_bounds (int32[S + 1]), univ_of_pair (int32[P]), cost
    (float32[S]), rank_idx (int32[S]), can_uncover (int32[nU]) and the
    int n_rank_vals.  A set's intervals must be pairwise disjoint, as
    stage D's merge leaves them.  On the card, the first call also keeps
    the overlap index in consts (k12_index).

    Returns (state, chosens int32[n_steps], picks bool[n_steps]): each
    step's first-argmin set and whether it was picked; state["stop"] is
    the last step's stop flag.

    Replaces catch_tpu/ops/set_cover.py _steps_jit_v2 (:836-859) and
    _greedy_core_v2 (:765-833); the kernel is csrc/greedy_v2.cu (each
    pair's uncovered count recomputed once a call and then changed only
    where a pick covers new positions; 3 launches a step, no host
    synchronisation inside).
    """
    tensors, _ = _step_tensors(state, consts, _V2_CONSTS, n_steps)
    if "order" in state:
        raise ValueError("greedy_steps_v2 keeps no device pick order")
    if si._on_cpu(*tensors):
        return _greedy_steps_v2_plain(state, consts, n_steps)
    out = _greedy_steps_v2_cuda(state, consts, n_steps)
    greedy_steps_v2.launches += 1
    return out


greedy_steps_v2.launches = 0


def overlap_index(ivl_start, ivl_end, pair_bounds, set_bounds, univ_of_pair,
                  U, tile=_K12_TILE):
    """K12's overlap index of a boundary-indexed instance, on the
    instance's device.

    A piece is a non-empty interval cut to one tile of `tile` positions;
    interval i's pieces are piece_off[i]..piece_off[i + 1], in position
    order.  Returns a dict: ivl_rec (int32[M, 4]: each interval's start,
    end, pair and universe) and pair_of_ivl (its third column); piece_off
    (int32[M + 1]); tile_ptr (int32[ceil(U / tile) + 1]) and tile_ivl
    (int32[pieces]), the intervals that meet tile t being
    tile_ivl[tile_ptr[t]:tile_ptr[t + 1]]; max_pieces and max_pairs, the
    most pieces and pairs of one set (0 without sets).  Raises
    ValueError where two intervals of a pair overlap: the incremental
    step counts a newly covered position once a chosen interval.  On
    CUDA tensors the tile lists come from csrc/greedy_v2.cu's count and
    fill kernels (`tile` must be K12_TILE; each tile's intervals in the
    order of the fill's atomics), on CPU tensors from a stable sort
    (ascending).
    """
    dev = ivl_start.device
    M, P, S = ivl_start.numel(), pair_bounds.numel() - 1, \
        set_bounds.numel() - 1
    n_pieces = _k12_pieces(ivl_start, ivl_end, tile)
    piece_off = torch.zeros(M + 1, dtype=torch.int64, device=dev)
    piece_off[1:] = torch.cumsum(n_pieces, 0, dtype=torch.int64)
    pair_of_ivl = torch.repeat_interleave(
        torch.arange(P, dtype=torch.int32, device=dev),
        pair_bounds[1:] - pair_bounds[:-1], output_size=M)
    # a pair's intervals, in start order, must not overlap
    overlaps = ((pair_of_ivl[1:] == pair_of_ivl[:-1])
                & (ivl_start[1:] < ivl_end[:-1])
                & (ivl_end[1:] > ivl_start[1:])).any()
    ivl_bounds = pair_bounds.long()[set_bounds.long()]
    maxima = torch.stack([
        piece_off[-1],
        (piece_off[ivl_bounds[1:]] - piece_off[ivl_bounds[:-1]]).max()
        if S else piece_off[0],
        (set_bounds[1:] - set_bounds[:-1]).max().long() if S
        else piece_off[0], overlaps.long()]).tolist()
    n_total, max_pieces, max_pairs, overlapping = maxima
    if overlapping:
        raise ValueError("a pair's intervals overlap; K12's update needs "
                         "them merged (disjoint, in start order)")
    if n_total >= _K12_PIECE_LIMIT:
        raise ValueError(f"{n_total} pieces do not fit the overlap "
                         "index's int32 offsets")
    piece_off = piece_off.to(torch.int32)
    if si._on_cpu(ivl_start):
        tile_ptr, tile_ivl = _tile_lists_plain(*_pieces(
            ivl_start, piece_off, n_pieces, n_total, tile), U, tile)
    else:
        if tile != _K12_TILE:
            raise ValueError(f"the card's overlap index has tiles of "
                             f"{_K12_TILE} positions, not {tile}")
        del n_pieces
        n_tiles = -(-U // tile)
        tile_ptr = torch.empty(n_tiles + 1, dtype=torch.int32, device=dev)
        tile_ivl = torch.empty(max(n_total, 1), dtype=torch.int32,
                               device=dev)
        count = torch.empty(max(n_tiles, 1), dtype=torch.int32, device=dev)
        scan_tiles = torch.empty(max(1, -(-n_tiles // _SCAN_TILE)),
                                 dtype=torch.int32, device=dev)
        _build.check(_build.library().ct_k12_index(
            _build.ptr(ivl_start), _build.ptr(ivl_end), M, n_tiles,
            _build.ptr(count), _build.ptr(scan_tiles), _build.ptr(tile_ptr),
            _build.ptr(tile_ivl), _build.stream_of(ivl_start)), "greedy_v2")
        tile_ivl = tile_ivl[:n_total]
    ivl_rec = torch.stack([ivl_start, ivl_end, pair_of_ivl,
                           univ_of_pair[pair_of_ivl.long()]], dim=1)
    return dict(ivl_rec=ivl_rec, pair_of_ivl=ivl_rec[:, 2],
                piece_off=piece_off, tile_ptr=tile_ptr, tile_ivl=tile_ivl,
                max_pieces=max_pieces, max_pairs=max_pairs)


def _k12_pieces(ivl_start, ivl_end, tile=_K12_TILE):
    """The pieces of each interval in K12's overlap index: the tiles of
    `tile` positions it meets (0 for an empty interval)."""
    return torch.where(ivl_end > ivl_start,
                       (ivl_end - 1) // tile - ivl_start // tile + 1, 0)


def k12_piece_count(dev):
    """The pieces K12's overlap index of the assembled instance `dev`
    would hold (a Python int: one reduction on its device and one
    readback), before any greedy launch."""
    return int(_k12_pieces(dev["ivl_start"], dev["ivl_end"]).sum(
        dtype=torch.int64))


def _pieces(ivl_start, piece_off, n_pieces, n_total, tile):
    """(interval, tile) of every piece (int32[n_total] each), in interval
    order and, within an interval, in position order."""
    dev = ivl_start.device
    ivl = torch.repeat_interleave(
        torch.arange(ivl_start.numel(), dtype=torch.int32, device=dev),
        n_pieces, output_size=n_total)
    # piece g of interval i lies in tile ivl_start[i] // tile + g -
    # piece_off[i]
    tile_of = torch.index_select(
        ivl_start // tile - piece_off[:-1].to(torch.int32), 0, ivl)
    tile_of += torch.arange(n_total, dtype=torch.int32, device=dev)
    return ivl, tile_of


def _tile_lists_plain(ivl, tile_of, U, tile):
    """(tile_ptr, tile_ivl) of an overlap index by a stable sort of the
    pieces (ivl, tile_of) by tile."""
    tile_of, order = torch.sort(tile_of, stable=True)
    tile_ptr = torch.searchsorted(tile_of, torch.arange(
        -(-U // tile) + 1, dtype=torch.int32, device=ivl.device),
        out_int32=True)
    return tile_ptr, ivl[order]


def _kept_index(consts, key, U, build):
    """build() at the first call, kept in consts under `key` and built
    again if ivl_start was replaced or U changed."""
    idx = consts.get(key)
    if idx is None or idx["of"] is not consts["ivl_start"] \
            or idx["U"] != U:
        idx = build()
        idx.update(of=consts["ivl_start"], U=U)
        consts[key] = idx
    return idx


def k12_index(consts, U):
    """The overlap index of `consts` over U positions, built by
    overlap_index at the first call and kept in consts under
    "_k12_index" (built again if ivl_start was replaced)."""
    return _kept_index(consts, "_k12_index", U, lambda: overlap_index(*(
        consts[k] for k in ("ivl_start", "ivl_end", "pair_bounds",
                            "set_bounds", "univ_of_pair")), U))


def _step_scratch(dev, U, P, S, max_pairs, n_steps):
    """The per-call scratch of K12, K13 and a place of K18, with lg (log2
    of the lanes a set of the score pass, from the most pairs of a set)
    and nb (its blocks)."""
    lg = min(5, max(0, max_pairs - 1).bit_length())
    nb = -(-(S << lg) // _GROUP_THREADS)

    def ints(n):
        return torch.empty(max(n, 1), dtype=torch.int32, device=dev)

    return dict(lg=lg, nb=nb,
                chosens=torch.empty(n_steps, dtype=torch.int32, device=dev),
                picks=torch.empty(n_steps, dtype=torch.bool, device=dev),
                prefix=ints(U + 1), tiles=ints(-(-U // _SCAN_TILE)),
                pair_new=ints(P),
                blk_r=torch.empty(max(nb, 1), dtype=torch.float32,
                                  device=dev),
                blk_i=ints(nb), blk_any=ints(nb), dec=ints(2))


def _run_stages(run, n_steps, steps):
    """run(step0, n, stages) for a call of n_steps steps: at once, or,
    where `steps` is given (it has a mark(name) method), one launch a
    call, marked after it as "recompute", "score", "decide" or "update"
    (tools/k12_split.py and tools/k13_split.py time them with CUDA
    events)."""
    if steps is None:
        run(0, n_steps, sum(_STAGES.values()))
        return
    steps.mark("start")
    run(0, 0, _STAGES["recompute"])
    steps.mark("recompute")
    for t in range(n_steps):
        for name in ("score", "decide", "update"):
            run(t, 1, _STAGES[name])
            steps.mark(name)


def _greedy_steps_v2_cuda(state, consts, n_steps, steps=None):
    """greedy_steps_v2 on the card; `steps`: see _run_stages."""
    U, nU = state["covered"].numel(), state["len_u"].numel()
    S, P = consts["cost"].numel(), consts["univ_of_pair"].numel()
    idx = k12_index(consts, U)
    w = _step_scratch(state["covered"].device, U, P, S, idx["max_pairs"],
                      n_steps)
    c, p = consts, _build.ptr
    args = (p(state["covered"]), U, p(state["len_u"]), p(c["can_uncover"]),
            nU, p(state["in_cover"]), p(c["cost"]), p(c["rank_idx"]), S,
            p(c["ivl_start"]), p(c["ivl_end"]), p(c["pair_bounds"]),
            p(c["set_bounds"]), p(c["univ_of_pair"]), P,
            int(c["n_rank_vals"]), p(idx["ivl_rec"]),
            p(idx["piece_off"]), p(idx["tile_ptr"]), p(idx["tile_ivl"]),
            w["lg"], w["nb"], idx["max_pieces"], p(state["cur_rank"]),
            p(state["stop"]), p(w["chosens"]), p(w["picks"]), p(w["prefix"]),
            p(w["tiles"]), p(w["pair_new"]), p(w["blk_r"]), p(w["blk_i"]),
            p(w["blk_any"]), p(w["dec"]))
    stream = _build.stream_of(w["chosens"])
    lib = _build.library()
    _run_stages(lambda step0, n, stages: _build.check(
        lib.ct_greedy_v2_steps(*args, step0, n, stages, stream),
        "greedy_v2"), n_steps, steps)
    return state, w["chosens"], w["picks"]


@_build.on_own_device
def greedy_steps_v1(state, consts, n_steps):
    """Run n_steps greedy steps on an instance given by segment ids.

    state: see the module docstring (updated in place); with order and
    n_chosen in it, each pick is also appended there on the device.
    consts: ivl_start / ivl_end / pair_of_ivl (int32[M]), set_of_pair /
    univ_of_pair (int32[P]), cost (float32[S]), rank_idx (int32[S]),
    can_uncover (int32[nU]) and the int n_rank_vals; pairs and
    intervals in any order, intervals possibly overlapping.  On the
    card, the first call also keeps the instance regrouped set-major in
    consts (k13_index); past _K12_PIECE_LIMIT pieces that raises
    ValueError.

    Returns (state, chosens int32[n_steps], picks bool[n_steps]), as
    greedy_steps_v2.

    Replaces catch_tpu/ops/set_cover.py _steps_jit (:630-658) and
    _greedy_core (:292-347), and with the order kept on the device the
    loop of _solve_jit_padded (:917-945); the kernel is
    csrc/greedy_v1.cu (K12's incremental step on the regrouped
    instance, with an update exact for overlapping intervals; 3
    launches a step, no host synchronisation inside).
    """
    tensors, _ = _step_tensors(state, consts, _V1_CONSTS, n_steps)
    if si._on_cpu(*tensors):
        return _greedy_steps_v1_plain(state, consts, n_steps)
    out = _greedy_steps_v1_cuda(state, consts, n_steps)
    greedy_steps_v1.launches += 1
    return out


greedy_steps_v1.launches = 0


def set_major_index(ivl_start, ivl_end, pair_of_ivl, set_of_pair,
                    univ_of_pair, n_sets, U, tile=_K12_TILE):
    """K13's instance regrouped set-major, on the instance's device.

    Pair ids never leave a step, so the pairs are renumbered in set
    order and the intervals grouped by the new pair ids (stable sorts:
    the pairs of a set and the intervals of a pair keep their order);
    set ids stay the instance's.  Intervals may overlap.  A piece is a
    non-empty interval cut to one tile of `tile` positions.  Returns a
    dict:
      ivl_start, ivl_end (int32[M]), the intervals regrouped;
      pair_bounds (int32[P + 1]), set_bounds (int32[n_sets + 1]) and
        univ_of_pair (int32[P]), by the new pair ids;
      ivl_rec (int32[M, 4]): each regrouped interval's start, end, new
        pair and universe;
      tile_ptr (int32[ceil(U / tile) + 1]) and tile_ivl
        (int32[pieces]): the intervals that meet tile t are
        tile_ivl[tile_ptr[t]:tile_ptr[t + 1]], ascending;
      set_grp (int32[n_sets + 1]), grp_tile (int32[G]), grp_off
        (int32[G + 1]) and grp_ivl (int32[pieces]): set s meets the
        tiles grp_tile[set_grp[s]:set_grp[s + 1]], ascending, and the
        set's intervals that meet the tile of group g are
        grp_ivl[grp_off[g]:grp_off[g + 1]];
      max_pairs and max_groups, the most pairs and tiles of one set (0
        without sets).
    Raises ValueError before anything is built where there would be
    _K12_PIECE_LIMIT pieces or more.  Library sorts, scans and searches
    on either device.
    """
    dev = ivl_start.device
    M, P = ivl_start.numel(), set_of_pair.numel()
    n_pieces = _k12_pieces(ivl_start, ivl_end, tile)
    n_total = int(n_pieces.sum(dtype=torch.int64))
    if n_total >= _K12_PIECE_LIMIT:
        raise ValueError(f"{n_total} pieces do not fit the overlap "
                         "index's int32 offsets")
    sets, pair_order = torch.sort(set_of_pair, stable=True)
    new_pair = torch.empty_like(set_of_pair)
    new_pair[pair_order] = torch.arange(P, dtype=torch.int32, device=dev)
    pairs, ivl_order = torch.sort(new_pair[pair_of_ivl.long()], stable=True)
    starts, ends = ivl_start[ivl_order], ivl_end[ivl_order]
    univ = univ_of_pair[pair_order]
    n_pieces = n_pieces[ivl_order]
    piece_off = torch.zeros(M + 1, dtype=torch.int64, device=dev)
    piece_off[1:] = torch.cumsum(n_pieces, 0)
    ivl, tile_of = _pieces(starts, piece_off, n_pieces, n_total, tile)
    tile_ptr, tile_ivl = _tile_lists_plain(ivl, tile_of, U, tile)
    # the pieces are in set order (the intervals are): sort each set's
    # by tile, then one group a (set, tile)
    n_tiles = max(1, -(-U // tile))
    key = sets[pairs.long()].long()[ivl.long()] * n_tiles + tile_of
    key, order = torch.sort(key, stable=True)
    keys, counts = torch.unique_consecutive(key, return_counts=True)
    grp_off = torch.zeros(keys.numel() + 1, dtype=torch.int32, device=dev)
    grp_off[1:] = torch.cumsum(counts, 0)

    def bounds(ids, n):
        """The first index of each of the ids 0..n in the sorted ids."""
        return torch.searchsorted(ids, torch.arange(
            n + 1, dtype=ids.dtype, device=dev), out_int32=True)

    set_bounds, set_grp = bounds(sets, n_sets), bounds(keys // n_tiles,
                                                      n_sets)
    maxima = torch.stack([torch.diff(set_bounds).max(),
                          torch.diff(set_grp).max()]).tolist() \
        if n_sets else [0, 0]
    return dict(ivl_start=starts, ivl_end=ends,
                pair_bounds=bounds(pairs, P), set_bounds=set_bounds,
                univ_of_pair=univ,
                ivl_rec=torch.stack([starts, ends, pairs,
                                     univ[pairs.long()]], dim=1),
                tile_ptr=tile_ptr, tile_ivl=tile_ivl, set_grp=set_grp,
                grp_tile=(keys % n_tiles).to(torch.int32), grp_off=grp_off,
                grp_ivl=ivl[order], max_pairs=maxima[0],
                max_groups=maxima[1])


def k13_index(consts, U):
    """set_major_index of `consts` over U positions, built at the first
    call and kept in consts under "_k13_index" (built again if
    ivl_start was replaced)."""
    return _kept_index(consts, "_k13_index", U, lambda: set_major_index(*(
        consts[k] for k in ("ivl_start", "ivl_end", "pair_of_ivl",
                            "set_of_pair", "univ_of_pair")),
        consts["cost"].numel(), U))


def _greedy_steps_v1_cuda(state, consts, n_steps, steps=None):
    """greedy_steps_v1 on the card; `steps`: see _run_stages."""
    U, nU = state["covered"].numel(), state["len_u"].numel()
    S, P = consts["cost"].numel(), consts["univ_of_pair"].numel()
    idx = k13_index(consts, U)
    w = _step_scratch(state["covered"].device, U, P, S, idx["max_pairs"],
                      n_steps)
    c, p = consts, _build.ptr
    keep = "order" in state
    args = (p(state["covered"]), U, p(state["len_u"]), p(c["can_uncover"]),
            nU, p(state["in_cover"]), p(c["cost"]), p(c["rank_idx"]), S,
            *(p(idx[k]) for k in ("ivl_start", "ivl_end", "pair_bounds",
                                  "set_bounds", "univ_of_pair")),
            P, int(c["n_rank_vals"]),
            *(p(idx[k]) for k in ("ivl_rec", "tile_ptr", "tile_ivl",
                                  "set_grp", "grp_tile", "grp_off",
                                  "grp_ivl")),
            w["lg"], w["nb"], idx["max_groups"], p(state["cur_rank"]),
            p(state["stop"]), p(w["chosens"]), p(w["picks"]),
            p(state["order"]) if keep else None,
            p(state["n_chosen"]) if keep else None, p(w["prefix"]),
            p(w["tiles"]), p(w["pair_new"]), p(w["blk_r"]), p(w["blk_i"]),
            p(w["blk_any"]), p(w["dec"]))
    stream = _build.stream_of(w["chosens"])
    lib = _build.library()
    _run_stages(lambda step0, n, stages: _build.check(
        lib.ct_greedy_v1_steps(*args, step0, n, stages, stream),
        "greedy_v1"), n_steps, steps)
    return state, w["chosens"], w["picks"]


def _uncovered_prefix(covered):
    """int64[U + 1]: uncovered positions before each position."""
    prefix = torch.zeros(covered.numel() + 1, dtype=torch.int64,
                         device=covered.device)
    prefix[1:] = torch.cumsum(~covered, 0)
    return prefix


def _decide_plain(state, consts, score, need, t, chosens, picks):
    """The end of step t, shared by both twins: the first argmin of the
    eligible sets' float32 ratios, pick, rank advance and stop (written
    into state and chosens/picks[t]).  Returns (chosen, pick)."""
    active = (need > 0).any()
    cur_rank = state["cur_rank"]
    elig = (~state["in_cover"] & (consts["rank_idx"] == cur_rank)
            & (score > 0))
    ratio = torch.where(elig, consts["cost"] / score.to(torch.float32),
                        torch.full_like(consts["cost"], float("inf")))
    any_elig = elig.any()
    chosen = (torch.argmin(ratio) if ratio.numel() else
              torch.zeros((), dtype=torch.int64, device=score.device))
    pick = active & any_elig
    adv = active & ~any_elig
    state["stop"].copy_(~active | (adv & (cur_rank + 1
                                          >= int(consts["n_rank_vals"]))))
    cur_rank += adv.to(torch.int32)
    if ratio.numel():
        state["in_cover"][chosen] |= pick
    chosens[t] = chosen
    picks[t] = pick
    return chosen, pick


def _cover_chosen(covered, starts, ends, on_ivl):
    """covered |= the ranges of the intervals flagged in on_ivl."""
    w = on_ivl.to(torch.int32)
    delta = torch.zeros(covered.numel() + 1, dtype=torch.int32,
                        device=covered.device)
    delta.index_add_(0, starts, w)
    delta.index_add_(0, ends, -w)
    covered |= torch.cumsum(delta[:-1], 0) > 0


def _greedy_steps_v2_plain(state, consts, n_steps):
    """Plain-PyTorch twin of greedy_steps_v2: catch_tpu's
    _greedy_core_v2, with sums of pair and set slices as differences of
    int64 cumulative sums."""
    c = consts
    dev = state["covered"].device
    starts, ends = c["ivl_start"].long(), c["ivl_end"].long()
    pb, sb = c["pair_bounds"].long(), c["set_bounds"].long()
    uop = c["univ_of_pair"].long()
    S, P, M = c["cost"].numel(), uop.numel(), starts.numel()
    pairs = torch.arange(P, device=dev)
    ivls = torch.arange(M, device=dev)
    chosens = torch.empty(n_steps, dtype=torch.int32, device=dev)
    picks = torch.empty(n_steps, dtype=torch.bool, device=dev)
    for t in range(n_steps):
        need = torch.clamp(state["len_u"] - c["can_uncover"], min=0)
        prefix = _uncovered_prefix(state["covered"])
        new_ivl = torch.zeros(M + 1, dtype=torch.int64, device=dev)
        new_ivl[1:] = torch.cumsum(prefix[ends] - prefix[starts], 0)
        pair_new = new_ivl[pb[1:]] - new_ivl[pb[:-1]]
        capped = torch.zeros(P + 1, dtype=torch.int64, device=dev)
        capped[1:] = torch.cumsum(torch.minimum(pair_new, need[uop]), 0)
        score = capped[sb[1:]] - capped[sb[:-1]]
        chosen, pick = _decide_plain(state, c, score, need, t, chosens,
                                     picks)
        # the update touches the chosen set's pairs and intervals only
        p0 = sb[chosen]
        p1 = sb[torch.clamp(chosen + 1, max=S)]
        on_pair = (pairs >= p0) & (pairs < p1) & pick
        state["len_u"].index_add_(0, uop, -torch.where(
            on_pair, pair_new, 0).to(torch.int32))
        _cover_chosen(state["covered"], starts, ends,
                      (ivls >= pb[p0]) & (ivls < pb[p1]) & pick)
    return state, chosens, picks


def _greedy_steps_v1_plain(state, consts, n_steps):
    """Plain-PyTorch twin of greedy_steps_v1: catch_tpu's _greedy_core
    (and _greedy_step's pick order), with segment sums by index_add_."""
    c = consts
    dev = state["covered"].device
    starts, ends = c["ivl_start"].long(), c["ivl_end"].long()
    poi, sop = c["pair_of_ivl"].long(), c["set_of_pair"].long()
    uop = c["univ_of_pair"].long()
    S, P = c["cost"].numel(), uop.numel()
    set_of_ivl = sop[poi]
    chosens = torch.empty(n_steps, dtype=torch.int32, device=dev)
    picks = torch.empty(n_steps, dtype=torch.bool, device=dev)
    for t in range(n_steps):
        need = torch.clamp(state["len_u"] - c["can_uncover"], min=0)
        prefix = _uncovered_prefix(state["covered"])
        pair_new = torch.zeros(P, dtype=torch.int64, device=dev).index_add_(
            0, poi, prefix[ends] - prefix[starts])
        score = torch.zeros(S, dtype=torch.int64, device=dev).index_add_(
            0, sop, torch.minimum(pair_new, need[uop]))
        chosen, pick = _decide_plain(state, c, score, need, t, chosens,
                                     picks)
        _cover_chosen(state["covered"], starts, ends,
                      (set_of_ivl == chosen) & pick)
        state["len_u"].index_add_(0, uop, -torch.where(
            (sop == chosen) & pick, pair_new, 0).to(torch.int32))
        if "order" in state and S:
            at = torch.clamp(state["n_chosen"], max=S - 1).long()
            state["order"][at] = torch.where(pick, chosen.to(torch.int32),
                                             state["order"][at])
            state["n_chosen"] += pick.to(torch.int32)
    return state, chosens, picks


# ----------------------------------------------------------------------
# The device solvers
# ----------------------------------------------------------------------

def _dispatch_bound(n_sets, n_rank_vals):
    """Dispatches that always reach the stop: every step picks a set,
    advances the rank tier or stops (catch_tpu's bound)."""
    return 2 + (n_sets + n_rank_vals) // max(1, _STEPS_PER_DISPATCH // 2)


def _run_dispatches(step_fn, state, consts, bound, max_dispatches=None):
    """Dispatch step_fn _STEPS_PER_DISPATCH steps at a time until the
    stop flag; returns the picks in order (int32).  Without an order in
    the state, each dispatch reads back its step vectors; with one, only
    the stop flag comes back until the end.  Reaching `bound` without a
    stop raises; `max_dispatches` below it cuts the solve short and
    returns the picks made so far.  The loop is the set_cover_solve
    trace region (utils/profiling.maybe_trace)."""
    order = []
    cut = max_dispatches is not None and max_dispatches < bound
    with profiling.maybe_trace("set_cover_solve", state["covered"].device):
        for _ in range(max_dispatches if cut else bound):
            state, chosens, picks = step_fn(state, consts,
                                            _STEPS_PER_DISPATCH)
            if "order" not in state:
                keep = picks.cpu().numpy()
                order.extend(chosens.cpu().numpy()[keep].tolist())
            if bool(state["stop"]):
                break
        else:
            if not cut:
                raise RuntimeError(f"the device solver took {bound} "
                                   "dispatches without reaching its stop")
    if "order" in state:
        return state["order"][:int(state["n_chosen"])].cpu().numpy()
    return np.array(order, dtype=np.int32)


def solve_boundary_instance(dev, n_sets_real, max_dispatches=None):
    """Solve the assembled device instance `dev`; returns the picked
    solver set ids (0..n_sets_real - 1) in order, np.int32.

    `dev` is the scan's dict after scan_instance.ensure_assembled.  The
    state never leaves the device; each dispatch of
    _STEPS_PER_DISPATCH K12 steps reads back its step vectors and the
    stop flag.  Reaching the dispatch bound without a stop raises.
    `max_dispatches` bounds the solve for throughput measurement: at
    most that many dispatches run, and the picks made so far come back.

    Where K12's overlap index would hold _K12_PIECE_LIMIT pieces or more
    (k12_piece_count), catch_tpu's host route runs instead, with its
    warning and before any greedy launch: the merged rows are read back
    (scan_instance.instance_to_host, with solver set ids) and solved by
    the host lazy solver to the end, whatever max_dispatches says.
    catch_tpu builds no index and solves such an instance on the device;
    the picks are the same.

    Replaces catch_tpu/ops/set_cover.py solve_boundary_instance
    (:862-914).
    """
    if "ivl_start" not in dev:
        raise ValueError("the instance is not assembled; run "
                         "scan_instance.ensure_assembled first")
    if k12_piece_count(dev) >= _K12_PIECE_LIMIT:
        logger.warning("K12's overlap index exceeds int32; falling back "
                       "to the host instance build")
        S = dev["cost"].numel()
        ids = np.arange(S)
        inst = si.instance_to_host(
            dev, ids, ids, S, dev["rank_idx"].cpu().numpy(),
            dev["n_rank_vals"], dev["cost"].cpu().numpy())
        return solve_instance(inst)
    covered = init_covered(dev["ivl_start"], dev["ivl_end"], dev["u_len"])
    state = initial_state(covered, dev["u_size"], dev["cost"].numel())
    bound = _dispatch_bound(n_sets_real, int(dev["n_rank_vals"]))
    return _run_dispatches(greedy_steps_v2, state, dev, bound,
                           max_dispatches)


def assembled_instance(inst, device):
    """The device dict solve_boundary_instance takes, for a host
    SetCoverInstance (one with pos_univ_offsets): its intervals as
    merged rows keyed set * nU + universe in universe-local coordinates
    on `device`, through stage E as the scan's instance goes.  Set ids
    stay the instance's.  (catch_tpu's bench.py builds the same dict by
    hand for its solver-throughput cell.)"""
    nU = inst.n_universes
    offsets = np.asarray(inst.pos_univ_offsets, dtype=np.int64)
    univ = np.asarray(inst.univ_of_pair, dtype=np.int64)[inst.pair_of_ivl]
    key = np.asarray(inst.set_of_pair, dtype=np.int64)[inst.pair_of_ivl] \
        * nU + univ
    order = np.argsort(key, kind="stable")

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(
            x[order], dtype=np.int64)).to(device)

    dev = dict(merged=(put(key), put(inst.ivl_start - offsets[univ]),
                       put(inst.ivl_end - offsets[univ])),
               b_pos=si.pack_width(int(np.diff(offsets).max(initial=0))),
               n_merged=len(key), offsets=offsets, nU=nU,
               u_size_host=np.asarray(inst.u_size),
               can_uncover_host=np.asarray(inst.can_uncover))
    sets = np.arange(inst.n_sets)
    return si.ensure_assembled(dev, sets, sets, inst.rank_idx,
                               inst.n_rank_vals, inst.cost)


def check_instance_axis(inst):
    """Raise where the position axis of a host SetCoverInstance does not
    fit int32 or an interval leaves it (the kernels index the axis
    without a check)."""
    if inst.u_len >= np.iinfo(np.int32).max:
        raise ValueError(f"global position axis of {inst.u_len} positions "
                         "does not fit the solver's int32 coordinates")
    if len(inst.ivl_start) and (np.min(inst.ivl_start) < 0
                                or np.max(inst.ivl_end) > inst.u_len):
        raise ValueError("an interval lies outside the position axis")


def _instance_consts(inst, device):
    """The K13 instance arrays of a host SetCoverInstance on `device`,
    with u_size; check_instance_axis's conditions raise."""
    check_instance_axis(inst)

    def put(x, dtype):
        return torch.from_numpy(np.ascontiguousarray(x, dtype=dtype)).to(
            device)

    consts = {k: put(getattr(inst, k), np.int32) for k in (
        "ivl_start", "ivl_end", "pair_of_ivl", "set_of_pair",
        "univ_of_pair", "rank_idx", "can_uncover")}
    consts.update(cost=put(inst.cost, np.float32),
                  n_rank_vals=int(inst.n_rank_vals))
    return consts, put(inst.u_size, np.int32)


def _k13_fits(inst):
    """Whether K13's index of the host instance holds fewer than
    _K12_PIECE_LIMIT pieces (counted on the host); where it would not,
    logs the warning of the host route, which the caller then takes
    before any launch."""
    n = int(_k12_pieces(torch.from_numpy(np.asarray(inst.ivl_start)),
                        torch.from_numpy(np.asarray(inst.ivl_end))).sum())
    if n < _K12_PIECE_LIMIT:
        return True
    logger.warning("K13's overlap index exceeds int32; falling back to the "
                   "host solver")
    return False


def _solve_device_steps(inst, device):
    """Device solve of a host instance as a host loop of K13 dispatches,
    each reading back only its step vectors and the stop flag.  Where
    K13's index would not fit int32 (_k13_fits), the host lazy solver
    runs instead, with a warning.  The picks are the same on an
    instance in the order that every constructor gives (build_instance,
    build_instance_from_cover_arrays, scan_instance.instance_to_host):
    pairs in set-major order, one pair for each (set, universe), the
    intervals grouped by pair, and the intervals of a pair disjoint
    (tests/test_torch_instance_order.py).  On an instance out of that
    order the lazy solver's order can differ.

    Replaces catch_tpu/ops/set_cover.py _solve_device_steps (:712-748).
    """
    if not _k13_fits(inst):
        return _solve_host_lazy(inst)
    consts, u_size = _instance_consts(inst, device)
    covered = init_covered(consts["ivl_start"], consts["ivl_end"],
                           inst.u_len)
    state = initial_state(covered, u_size, inst.n_sets)
    return _run_dispatches(greedy_steps_v1, state, consts,
                           _dispatch_bound(inst.n_sets, inst.n_rank_vals))


def _solve_device(inst, device):
    """Device-resident solve of a host instance: K11, then K13 steps
    until the stop flag, with the pick order kept on the device; only
    the stop flag comes back between dispatches, and the order at the
    end.  Where K13's index would not fit int32, the host lazy solver
    runs instead, as in _solve_device_steps, with the same picks on an
    instance in the constructors' order.

    Replaces catch_tpu/ops/set_cover.py _solve_device (:948-961) and its
    while loop _solve_jit_padded (:917-945).
    """
    if not _k13_fits(inst):
        return _solve_host_lazy(inst)
    consts, u_size = _instance_consts(inst, device)
    covered = init_covered(consts["ivl_start"], consts["ivl_end"],
                           inst.u_len)
    state = initial_state(covered, u_size, inst.n_sets, keep_order=True)
    return _run_dispatches(greedy_steps_v1, state, consts,
                           _dispatch_bound(inst.n_sets, inst.n_rank_vals))


def solve_instance(inst, force_device=False, device=None, mesh=None):
    """Solve a canonicalized instance; returns dense set indices in pick
    order (np.int32 array).

    Runs the lazy-greedy solver.  Its pick order equals that of the
    full-rescan solver catch_tpu/ops/set_cover._solve_host (including
    the lowest-set-id tie-break among equal float32 cost/score ratios),
    which catch_tpu.ops.set_cover.solve_instance runs for tiny
    instances; so the port's picks equal catch_tpu's at every size.
    With force_device, the K13 step solver runs on `device` (the card
    unless the caller names the CPU) or, given a `mesh` of more than
    one place, the sharded solver on the mesh
    (parallel/set_cover.solve_instance_sharded), with the same picks; a
    failure raises.  Without a mesh, an instance whose position axis
    reaches _DEVICE_AXIS_LIMIT is solved on the host, as catch_tpu does
    (catch_tpu/ops/set_cover.py:988); the sharded solver has no such
    route and raises.  Without force_device the mesh is not used, as in
    catch_tpu.
    """
    if inst.n_sets == 0 or inst.u_len == 0 or len(inst.ivl_start) == 0:
        return np.empty(0, dtype=np.int32)
    if np.all(inst.can_uncover >= inst.u_size):
        return np.empty(0, dtype=np.int32)
    if force_device and mesh is not None and mesh.size > 1:
        from catch_tpu_torch.parallel.set_cover import solve_instance_sharded
        return solve_instance_sharded(inst, mesh=mesh)
    if force_device and inst.u_len < _DEVICE_AXIS_LIMIT:
        return _solve_device_steps(
            inst, resolve_device("cuda" if device is None else device))
    return _solve_host_lazy(inst)


si.KERNELS.update(init_covered=init_covered, greedy_v2=greedy_steps_v2,
                  greedy_v1=greedy_steps_v1)


# ----------------------------------------------------------------------
# Reference-parity host API
# ----------------------------------------------------------------------

def approx_multiuniverse(sets, costs=None, universe_p=None, ranks=None,
                         use_arrays=False, use_intervalsets=False,
                         logger_prefix=""):
    """Approximate the multi-universe weighted partial set cover.

    API parity with reference catch/utils/set_cover.py:147-615; the
    instance is solved by solve_instance (the host lazy solver).
    `use_arrays` is accepted for compatibility (arrays and sets
    canonicalize the same way here).

    Returns:
        set of chosen set identifiers
    """
    if use_arrays and use_intervalsets:
        raise ValueError("Cannot use both arrays and IntervalSets")
    inst, set_id_list = build_instance(
        sets, costs=costs, universe_p=universe_p, ranks=ranks,
        use_intervalsets=use_intervalsets)
    chosen = solve_instance(inst)
    if ranks is not None and len(chosen):
        ranks_arr = np.array([ranks[set_id_list[i]] for i in chosen])
        min_rank = min(ranks.values())
        n_high = int(np.sum(ranks_arr > min_rank))
        if n_high:
            logger.warning(
                "%sThe solution chose %d sets with rank above the minimum",
                logger_prefix, n_high)
    return {set_id_list[i] for i in chosen}


def approx(sets, costs=None, p=1.0):
    """Approximate the weighted partial set cover (single universe).

    API parity with reference catch/utils/set_cover.py:14-144.
    """
    if p < 0 or p > 1:
        raise ValueError("p must be in [0,1]")
    mu_sets = {sid: {0: s} for sid, s in sets.items()}
    return approx_multiuniverse(mu_sets, costs=costs, universe_p={0: p})
