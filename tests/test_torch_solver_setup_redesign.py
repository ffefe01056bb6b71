"""Plain models of the device solver's two set-up kernels against
catch_tpu.

csrc/assemble.cu (K10 assemble) and csrc/init_covered.cu (K11
init_covered) run only on the card, so their designs are modelled here
tile by tile, in plain Python over numpy on the CPU, and held against the
JAX programs they replace (catch_tpu/ops/scan_instance.py _assemble_jit
and catch_tpu/ops/set_cover.py _init_covered_jit; catch_tpu pads its
arrays, so the real prefix of each is compared) and against the port's
twins, on the same inputs made from numpy seeds.  Every comparison is
exact.

Both kernels are single-pass scans with a decoupled look-back
(csrc/lookback.cuh): each tile publishes its aggregate, then its
inclusive prefix, and a tile's exclusive prefix folds its predecessors'
values a window at a time (one a thread of the block in the kernels)
back to the nearest inclusive one.  The model
takes small tiles and windows, so the carry crosses many tiles, and
draws which predecessors show their inclusive prefix from a seed: the
result must not depend on it.

K10's model numbers the pair starts a chunk at a time (a warp's 64 rows
in the kernel, by two ballots; fewer here), scans the chunks of a tile,
and carries (pair starts, last set-first row, its pair number) across
tiles with the "later set start wins" operator.  A pair's first row
writes the pair arrays, a set's first row fills set_bounds back to the
previous row's set and closes the previous set's maxima, and the last
row closes the last set and fills set_bounds up to S.  K11's model takes
reach[a] = max b over the nonempty intervals (one atomicMax each), then
a max-scan of 32 positions a thread, covered[i] = prefix_max[i] <= i.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from catch_tpu.ops import scan_instance as sj
from catch_tpu.ops import set_cover as scj
from catch_tpu_torch.ops import scan_instance as si
from catch_tpu_torch.ops import set_cover as sct


# ----------------------------------------------------------------------
# The look-back
# ----------------------------------------------------------------------

def _lookback(aggs, op, identity, window, rng):
    """Each tile's exclusive prefix as csrc/lookback.cuh finds it: tile
    t folds the values of tiles t - 1, t - 2, ... a window at a time,
    nearest first, down to the nearest tile that shows its inclusive
    prefix.  Tile 0 shows it at once; another tile shows it with
    probability one half (drawn from rng), its aggregate otherwise.
    Returns (exclusive prefixes, the tiles each look-back read)."""
    excl, incl, reads = [], [], []
    for t, agg in enumerate(aggs):
        ex, hi, seen = identity, t - 1, []
        while hi >= 0:
            js = [j for j in range(hi, hi - window, -1) if j >= 0]
            shows = [j == 0 or rng.random() < 0.5 for j in js]
            last = shows.index(True) if True in shows else len(js) - 1
            x = identity
            for j, inc in reversed(list(zip(js, shows))[:last + 1]):
                x = op(x, incl[j] if inc else aggs[j])   # earlier first
                seen.append(j)
            ex = op(x, ex)
            if True in shows:
                break
            hi -= window
        excl.append(ex)
        incl.append(op(ex, agg))
        reads.append(seen)
    return excl, reads


# ----------------------------------------------------------------------
# K10 assemble
# ----------------------------------------------------------------------

SEG_ID = (0, -1, 0)


def _seg(a, b):
    """(pair starts, last set-first row, its pair number from the range's
    first row) of range a followed by range b: the later set start
    wins."""
    if b[1] >= 0:
        return (a[0] + b[0], b[1], a[0] + b[2])
    return (a[0] + b[0], a[1], a[2])


def _fill(set_bounds, lo, hi, S, p):
    """set_bounds[s] = p for every s in (lo, hi], clipped to [0, S]."""
    for s in range(max(lo + 1, 0), min(hi, S) + 1):
        set_bounds[s] = p


def _assemble_model(key, start, end, offsets, S, *, lanes=4, chunks=3,
                    window=3, seed=0):
    """csrc/assemble.cu on numpy rows: tiles of `chunks` chunks of
    2 * lanes rows (the kernel: 32 chunks of 64 rows).  Returns the
    wrapper's seven values as numpy arrays and ints."""
    n, nU = len(key), len(offsets) - 1
    rows_per_chunk = 2 * lanes
    tile = chunks * rows_per_chunk
    nt = -(-n // tile)
    gs = np.zeros(n, np.int32)
    ge = np.zeros(n, np.int32)
    pair_bounds = np.full(n + 1, -7, np.int32)
    univ_of_pair = np.full(n, -7, np.int32)
    set_bounds = np.full(S + 1, -7, np.int32)
    res = [0, 0, 0]                     # P, max pairs, max intervals
    if n == 0:
        set_bounds[:] = 0
        pair_bounds[0] = 0
        return gs, ge, pair_bounds[:1], set_bounds, univ_of_pair[:0], 0, 0

    def row(i):
        """(key, set, universe) of row i, (-1, -1, 0) past either end."""
        if 0 <= i < n:
            k = int(key[i])
            return k, k // nU, k % nU
        return -1, -1, 0

    def flags(i):
        """(pair start, set start) of row i."""
        k, q, _ = row(i)
        kp, qp, _ = row(i - 1)
        f = i < n and k != kp
        return f, f and q != qp

    # Pass one, each tile: global coordinates, the chunks' aggregates, the
    # chunks' exclusive values within the tile, the tile's aggregate.
    chunk_excl, tile_agg = [], []
    for t in range(nt):
        ex_t, run = [], SEG_ID
        for c in range(chunks):
            r0 = t * tile + c * rows_per_chunk
            rs = range(r0, r0 + rows_per_chunk)
            f = [flags(i)[0] for i in rs]
            g = [flags(i)[1] for i in rs]
            last = max((i - r0 for i in rs if g[i - r0]), default=-1)
            agg = (sum(f), r0 + last if last >= 0 else -1,
                   sum(f[:last]) if last >= 0 else 0)
            ex_t.append(run)
            run = _seg(run, agg)
        chunk_excl.append(ex_t)
        tile_agg.append(run)
    for i in range(n):
        _, _, u = row(i)
        gs[i] = start[i] + offsets[u]
        ge[i] = end[i] + offsets[u]
    carries, reads = _lookback(tile_agg, _seg, SEG_ID, window,
                               np.random.default_rng(seed))

    # Pass two, each lane of each chunk.
    mp = mi = 0
    for t in range(nt):
        for c in range(chunks):
            b = _seg(carries[t], chunk_excl[t][c])
            r_c = t * tile + c * rows_per_chunk
            packed = []                 # each lane's last set start
            for lane in range(lanes):
                r = r_c + 2 * lane
                (f0, g0), (f1, g1) = flags(r), flags(r + 1)
                ex = sum(flags(i)[0] for i in range(r_c, r))
                p0 = b[0] + ex
                p1 = p0 + f0
                _, q0, u0 = row(r)
                _, q1, u1 = row(r + 1)
                _, qp, _ = row(r - 1)
                if f0:
                    univ_of_pair[p0], pair_bounds[p0] = u0, r
                if f1:
                    univ_of_pair[p1], pair_bounds[p1] = u1, r + 1
                mine = ((2 * lane + 1) << 6 | (ex + f0)) if g1 else \
                    ((2 * lane) << 6 | ex) if g0 else -1
                prev = max(packed, default=-1)
                packed.append(mine)
                sr, sp = b[1], b[2]
                if prev >= 0:
                    sr, sp = r_c + (prev >> 6), b[0] + (prev & 63)
                if g0:
                    if r > 0:
                        mp, mi = max(mp, p0 - sp), max(mi, r - sr)
                    _fill(set_bounds, qp, q0, S, p0)
                    sr, sp = r, p0
                if g1:
                    mp, mi = max(mp, p1 - sp), max(mi, r + 1 - sr)
                    _fill(set_bounds, q0, q1, S, p1)
                    sr, sp = r + 1, p1
                if n - 1 in (r, r + 1):
                    second = r + 1 == n - 1
                    P = p1 + f1 if second else p0 + f0
                    mp, mi = max(mp, P - sp), max(mi, n - sr)
                    _fill(set_bounds, q1 if second else q0, S, S, P)
                    pair_bounds[P] = n
                    res[0] = P
    P = res[0]
    _assemble_model.reads = reads
    return (gs, ge, pair_bounds[:P + 1], set_bounds, univ_of_pair[:P], mp,
            mi)


def _rows(case, rng):
    """(key, start, end, offsets, S) of merged rows sorted by key: each
    pair (set, universe) holds disjoint intervals in its universe."""
    nU = 3
    u_len = rng.integers(100, 200, size=nU)
    offsets = np.concatenate([[0], np.cumsum(u_len)]).astype(np.int64)
    sets = {
        "random": np.unique(rng.integers(0, 40, size=30)),
        "gaps_start_middle_end": np.array([3, 4, 9, 10, 11, 17]),
        "one_row": np.array([5]),
        "no_rows": np.array([], dtype=np.int64),
        "pair_across_tiles": np.array([0, 1, 2]),
        "set_across_tiles": np.array([1, 2, 6]),
        "one_set": np.array([0]),
    }[case]
    S = {"gaps_start_middle_end": 24, "one_row": 9, "no_rows": 4,
         "one_set": 1}.get(case, int(sets.max(initial=-1)) + 1)
    key, start, end = [], [], []
    for s in sets:
        univs = np.unique(rng.integers(0, nU, size=rng.integers(1, nU + 1)))
        if case == "set_across_tiles" and s == 2:
            univs = np.arange(nU)
        for u in univs:
            if case == "one_row":
                n_ivl = 1
            elif case == "pair_across_tiles" and s == 1:
                n_ivl = 40              # longer than a model tile (24)
            elif case == "set_across_tiles" and s == 2:
                n_ivl = 15              # three universes: 45 rows
            else:
                n_ivl = int(rng.integers(1, 6))
            cuts = np.sort(rng.choice(np.arange(u_len[u] + 1), 2 * n_ivl,
                                      replace=False))
            key += [s * nU + u] * n_ivl
            start += list(cuts[0::2])
            end += list(cuts[1::2])
    as64 = [np.asarray(x, np.int64) for x in (key, start, end)]
    return as64 + [offsets, S]


def _jax_assemble(key, start, end, offsets, S):
    """_assemble_jit's arrays, cut to their real prefixes."""
    n, nU = len(key), len(offsets) - 1
    out = max(n, 1)
    k = np.full(out, sj._I32MAX, np.int32)
    s = np.zeros(out, np.int32)
    e = np.zeros(out, np.int32)
    k[:n], s[:n], e[:n] = key, start, end
    gs, ge, pb, sb, uop, n_pairs, mp, mi = sj._assemble_jit(
        jnp.asarray(k), jnp.asarray(s), jnp.asarray(e),
        jnp.asarray(offsets[:nU].astype(np.int32)), jnp.int32(n),
        jnp.int32(nU), OUT=out, P_CAP=out, S_pad=S + 2, nU_pad=nU)
    P = int(n_pairs)
    return (np.asarray(gs)[:n], np.asarray(ge)[:n], np.asarray(pb)[:P + 1],
            np.asarray(sb)[:S + 1], np.asarray(uop)[:P], int(mp), int(mi))


def _check_equal(got, want):
    for g, w in zip(got[:5], want[:5]):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape and np.array_equal(g, w)
    assert tuple(got[5:]) == tuple(want[5:])


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", ["random", "gaps_start_middle_end",
                                  "one_row", "no_rows", "pair_across_tiles",
                                  "set_across_tiles", "one_set"])
def test_assemble_model_equals_catch_tpu(case, seed):
    rng = np.random.default_rng(100 + seed)
    key, start, end, offsets, S = _rows(case, rng)
    n = len(key)
    want = _jax_assemble(key, start, end, offsets, S)
    got = _assemble_model(key, start, end, offsets, S, seed=seed)
    _check_equal(got, want)
    twin = si._assemble_plain(*(torch.from_numpy(x) for x in
                                (key, start, end, offsets)), S)
    _check_equal([t.numpy() if isinstance(t, torch.Tensor) else t
                  for t in twin], want)
    assert len(want[4]) <= n          # pairs fit the capacity n
    if case == "gaps_start_middle_end":
        sb = want[3]
        assert sb[0] == sb[3] == 0 and sb[5] == sb[9] and sb[S] == len(
            want[4]) and sb[18] == sb[S]
    if case in ("pair_across_tiles", "set_across_tiles", "random"):
        # the carry crossed tiles, and some look-back read more than one
        assert n > 2 * 24
        assert max(len(r) for r in _assemble_model.reads) > 1
    if case == "pair_across_tiles":
        assert np.diff(want[2]).max() > 24
    if case == "set_across_tiles":
        assert want[6] > 24


def test_assemble_model_windows_and_chunks():
    """Other chunk, tile and window sizes give the same arrays."""
    rng = np.random.default_rng(7)
    rows = _rows("random", rng)
    want = _jax_assemble(*rows)
    for lanes, chunks, window in ((1, 1, 1), (2, 5, 2), (32, 1, 32)):
        for seed in range(3):
            _check_equal(_assemble_model(*rows, lanes=lanes, chunks=chunks,
                                         window=window, seed=seed), want)


# ----------------------------------------------------------------------
# K11 init_covered
# ----------------------------------------------------------------------

ITEMS = 32


def _init_covered_model(s, e, U, *, threads=3, window=3, seed=0):
    """csrc/init_covered.cu on numpy intervals: reach by one atomicMax a
    nonempty interval, then tiles of `threads` x 32 positions (the
    kernel: 256 x 32), a thread's 32 positions scanned in its registers
    after the exclusive maximum of the tile's carry and the earlier
    threads."""
    reach = np.zeros(U, np.int64)
    ne = e > s
    np.maximum.at(reach, s[ne], e[ne])
    tile = threads * ITEMS
    nt = -(-U // tile)
    padded = np.zeros(nt * tile, np.int64)
    padded[:U] = reach
    per_thread = padded.reshape(nt, threads, ITEMS)
    t_max = per_thread.max(axis=2)
    carries, reads = _lookback(list(t_max.max(axis=1)), max, 0, window,
                               np.random.default_rng(seed))
    covered = np.zeros(nt * tile, bool)
    for t in range(nt):
        for th in range(threads):
            run = max([carries[t]] + list(t_max[t, :th]))
            i0 = t * tile + th * ITEMS
            for k in range(ITEMS):
                run = max(run, per_thread[t, th, k])
                covered[i0 + k] = run <= i0 + k
    _init_covered_model.reads = reads
    return covered[:U]


def _intervals(case, rng):
    U = {"below_one_tile": 37, "not_multiple_of_16": 1003,
         "many_tiles": 2000}.get(case, 600)
    M = max(1, U // 8)
    s = rng.integers(0, U, size=M)
    e = np.minimum(U, s + rng.integers(0, 40, size=M))
    if case == "nested_equal_touching":
        base = [(100, 200), (120, 150), (120, 150), (150, 180), (200, 260),
                (260, 261), (300, 400), (310, 390), (300, 400)]
        s = np.array([a for a, _ in base])
        e = np.array([b for _, b in base])
    elif case == "ending_at_U":
        s[:3], e[:3] = (U - 1, U - 30, U - 5), U
    elif case == "empty":
        e[::2] = s[::2]
        s[1], e[1] = U, U
    elif case == "deep_overlap":
        s = np.full(3000, 250)
        e = 251 + rng.integers(0, 3, size=3000)
    return s.astype(np.int64), e.astype(np.int64), U


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", ["random", "nested_equal_touching",
                                  "ending_at_U", "empty", "below_one_tile",
                                  "not_multiple_of_16", "many_tiles",
                                  "deep_overlap"])
def test_init_covered_model_equals_catch_tpu(case, seed):
    rng = np.random.default_rng(200 + seed)
    s, e, U = _intervals(case, rng)
    want = np.asarray(scj._init_covered_jit(
        jnp.asarray(s.astype(np.int32)), jnp.asarray(e.astype(np.int32)),
        u_len_pad=U))
    got = _init_covered_model(s, e, U, seed=seed)
    assert got.shape == (U,) and np.array_equal(got, want)
    twin = sct._init_covered_plain(torch.from_numpy(s.astype(np.int32)),
                                   torch.from_numpy(e.astype(np.int32)), U)
    assert np.array_equal(twin.numpy(), want)
    assert want.any() and not want.all()
    if case == "nested_equal_touching":
        assert not want[100:261].any() and want[261] and want[99]
    if case == "ending_at_U":
        assert not want[-1]
    if case in ("many_tiles", "not_multiple_of_16"):
        assert max(len(r) for r in _init_covered_model.reads) > 1


def test_init_covered_model_no_intervals_and_windows():
    """No intervals cover nothing; other tile and window sizes give the
    same coverage."""
    empty = np.zeros(0, np.int64)
    assert _init_covered_model(empty, empty, 50).all()
    rng = np.random.default_rng(9)
    s, e, U = _intervals("many_tiles", rng)
    want = np.asarray(scj._init_covered_jit(
        jnp.asarray(s.astype(np.int32)), jnp.asarray(e.astype(np.int32)),
        u_len_pad=U))
    for threads, window in ((1, 1), (2, 32), (16, 2)):
        for seed in range(3):
            assert np.array_equal(_init_covered_model(
                s, e, U, threads=threads, window=window, seed=seed), want)
