"""Plain-PyTorch models of K7's walk and K8's Mersenne fold, the designs
of csrc/minhash_caps.cu and csrc/minhash_sig.cu, against catch_tpu on
the CPU.

The kernels run only on the card; these models repeat their arithmetic
and their order of work step by step, so that the designs are held to
the JAX programs they replace here.  K7: representatives in groups of
32 lanes staged with a pad word, query tiles as launch_walk sizes them,
every lane stepping together with its loads and updates predicated, a
vote every MH_UNROLL steps, and assign's two warp reductions and 64-bit
keys across groups.  K8: the 32 x 32 -> 64-bit multiply-add, two folds
and the unsigned min(s, s - p), hash functions taken SIG_HPT a thread
over chunks of codes.  Every comparison is exact: integer counts, the
float32 distances bit for bit, signature values.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from catch_tpu.utils import cluster as jcluster
from catch_tpu.utils import lsh as jlsh
from catch_tpu_torch.ops import minhash as mh

P = mh.MERSENNE_P
LANES, WARPS, MAX_TQ, UNROLL = 32, 8, 64, 8   # csrc/minhash_caps.cu
HPT, THREADS, CHUNK, SIG_SMEM = 4, 256, 256, 48 * 1024   # minhash_sig.cu
SMEM_OPTIN, SMS = 232448, 132                 # one H100
PAD = -7                                      # never read as a value


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The models run many small tensor ops; one intra-op thread keeps
    test workers that share the host's cores from stalling."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------------------
# K7: the walk
# ----------------------------------------------------------------------

def _tiles(Q, R, N):
    """launch_walk's geometry: (tq, warps, shared bytes) and the blocks
    as (first representative, representatives, first query, queries)."""
    row = 4 * (N + 1)
    fit = SMEM_OPTIN // row - LANES
    assert fit >= 1
    tq = min(fit, MAX_TQ)
    groups = -(-R // LANES)
    while tq > 8 and groups * -(-Q // tq) < 2 * SMS:
        tq //= 2
    tq = min(tq, Q)
    smem = (LANES + tq) * row
    assert smem <= SMEM_OPTIN
    blocks = [(r0, min(LANES, R - r0), q0, min(tq, Q - q0))
              for q0 in range(0, Q, tq) for r0 in range(0, R, LANES)]
    return tq, min(tq, WARPS), smem, blocks


def _walk_block(qs, rs, N):
    """One block's walks: qs [nq, N] query rows, rs [nr, N] (nr <= 32)
    the group's lanes.  Returns (caps [nq, nr], steps [nq]: the steps
    each warp ran, votes included)."""
    nq, nr = qs.shape[0], rs.shape[0]
    A = torch.full((nq, N + 1), PAD, dtype=torch.int64)
    A[:, :N] = qs
    B = torch.full((N + 1, LANES), PAD, dtype=torch.int64)   # interleaved
    B[:N, :nr] = rs.T
    lane = torch.arange(LANES)
    p = torch.zeros((nq, LANES), dtype=torch.int64)
    j = torch.zeros_like(p)
    cap = torch.zeros_like(p)
    left = torch.where(lane < nr, N, 0).expand(nq, LANES).clone()
    a = A[:, :1].expand(nq, LANES).clone()
    b = B[0].expand(nq, LANES).clone()
    walking = torch.ones(nq, dtype=torch.bool)      # warps not yet voted out
    steps = torch.zeros(nq, dtype=torch.int64)
    while walking.any():
        for _ in range(UNROLL):
            # no test of p: where p reaches N, left = cap - j <= 0
            live = (j < N) & (left > 0) & walking[:, None]
            adv, col = live & (a < b), live & ~(a < b)
            eq = live & (a == b)
            cap += eq
            left -= (live & ~eq).long()
            p += adv
            j += col
            a = torch.where(adv, A.gather(1, p), a)
            b = torch.where(col, B[j, lane], b)
            assert (p <= N).all() and (p < N).logical_or(left <= 0).all()
        steps += UNROLL * walking
        walking &= ((j < N) & (left > 0)).any(1)
    return cap[:, :nr], steps


def _walk_caps(qs, rs):
    """[Q, R] capped counts by the walk over launch_walk's blocks, each
    pair taken exactly once; also the most steps a warp ran."""
    qs, rs = torch.as_tensor(qs).long(), torch.as_tensor(rs).long()
    (Q, N), R = qs.shape, rs.shape[0]
    caps = torch.full((Q, R), -1, dtype=torch.int64)
    most = 0
    for r0, nr, q0, nq in _tiles(Q, R, N)[3]:
        c, steps = _walk_block(qs[q0:q0 + nq], rs[r0:r0 + nr], N)
        assert (caps[q0:q0 + nq, r0:r0 + nr] == -1).all()
        caps[q0:q0 + nq, r0:r0 + nr] = c
        most = max(most, int(steps.max()))
    assert (caps >= 0).all()
    # a walk takes at most N + cap <= 2N steps; a warp stops at the first
    # vote after its last lane
    assert most <= 2 * N + UNROLL
    return caps, most


def _walk_assign(qs, rs, n_reps, cap_thr):
    """ct_minhash_assign by the model: per (query, group) the largest
    count and the first lane holding it, then, over several groups, the
    largest 64-bit key (count + 1, complement of the index)."""
    Q = qs.shape[0]
    G = -(-n_reps // LANES)
    if G == 0:
        return np.zeros(Q, dtype=np.int64), np.zeros(Q, dtype=bool)
    caps, _ = _walk_caps(qs, rs[:n_reps])
    best = np.empty(Q, dtype=np.int64)
    ok = np.empty(Q, dtype=bool)
    keys = np.zeros((G, Q), dtype=np.uint64)
    for g in range(G):
        c = np.full((Q, LANES), -1, dtype=np.int64)
        blk = caps[:, g * LANES:(g + 1) * LANES].numpy()
        c[:, :blk.shape[1]] = blk
        m = c.max(1)
        first = np.where(c == m[:, None], np.arange(LANES), LANES).min(1)
        r = g * LANES + first
        if G == 1:
            best, ok = r, m >= cap_thr
        keys[g] = ((m + 1).astype(np.uint64) << np.uint64(32)) | (
            np.uint64(0xFFFFFFFF) - r.astype(np.uint64))
    if G > 1:
        key = keys.max(0)
        best = (np.uint64(0xFFFFFFFF) - (key & np.uint64(0xFFFFFFFF))
                ).astype(np.int64)
        ok = ((key >> np.uint64(32)).astype(np.int64) - 1) >= cap_thr
    return best, ok


def _rows(seed, n, N, kind):
    """n ascending int32 rows of width N: 'wide' draws from [0, 2^31 - 1),
    'runs' repeats a few values in long runs (duplicates inside rows,
    ties between pairs), 'edges' mixes runs with the int32 extremes."""
    rng = np.random.default_rng(seed)
    if kind == "wide":
        x = rng.integers(0, P, size=(n, N))
    elif kind == "runs":
        vals = rng.integers(0, max(2, N // 8), size=(n, max(1, N // 16)))
        x = np.take_along_axis(vals, rng.integers(0, vals.shape[1],
                                                  size=(n, N)), 1)
    else:
        x = rng.integers(-3, 4, size=(n, N))
        x[x == -3] = np.iinfo(np.int32).min
        x[x == 3] = np.iinfo(np.int32).max
    return np.sort(x, axis=1).astype(np.int32)


def _shapes(N):
    """Queries and representatives not multiples of the tiles, with more
    than one group of 32; fewer at N = 1536 keep catch_tpu's scan short."""
    return (3, 40) if N > 256 else (21, 70)


@pytest.mark.parametrize("kind", ["wide", "runs", "edges"])
@pytest.mark.parametrize("N", [1, 2, 100, 255, 256, 1536])
def test_walk_equals_pair_caps_and_block_dists(N, kind):
    """The walk's counts equal _pair_caps_jit's (dtype included), and
    the float32 distances from them _block_dists_kernel's, bit for bit."""
    Q, R = _shapes(N)
    qs, rs = _rows(2 * N + 1, Q, N, kind), _rows(2 * N + 2, R, N, kind)
    rs[5] = qs[0]                              # one pair of equal rows
    caps, _ = _walk_caps(qs, rs)
    want = np.asarray(jcluster._pair_caps_jit(jnp.asarray(qs),
                                              jnp.asarray(rs), N=N))
    assert want.dtype == (np.uint8 if N <= 255 else np.int32)
    assert np.array_equal(caps.numpy(), want.astype(np.int64))
    assert caps[0, 5] == N
    both = jnp.asarray(np.concatenate([qs, rs]))
    dists = np.asarray(jcluster._block_dists_kernel(
        both, jnp.int32(0), N=N, B=Q))[:, Q:]
    got = (1.0 - caps.double() * mh._f32_reciprocal(N)).float().numpy()
    assert np.array_equal(got.view(np.uint32), dists.view(np.uint32))


@pytest.mark.parametrize("N", [1, 40, 100])
def test_walk_takes_every_cap_and_stops_at_the_vote(N):
    """Rows that give every count c in 0..N against one row: the walk's
    counts, and each warp's steps, rounded up to the next vote: N - c
    columns before the shared values, then each shared value a column
    and a pointer step, but the last, whose column ends the walk."""
    A = np.arange(N, dtype=np.int32)
    rows = np.stack([np.sort(np.concatenate([
        np.arange(N - c, N), np.arange(10**6, 10**6 + N - c)]))
        for c in range(N + 1)]).astype(np.int32)
    caps, _ = _walk_caps(A[None], rows)
    assert caps[0].tolist() == list(range(N + 1))
    # each row a warp of one lane against A
    caps, steps = _walk_block(torch.as_tensor(rows).long(),
                              torch.as_tensor(A[None]).long(), N)
    assert caps[:, 0].tolist() == list(range(N + 1))
    walked = [N + max(c - 1, 0) for c in range(N + 1)]
    assert steps.tolist() == [-(-w // UNROLL) * UNROLL for w in walked]


@pytest.mark.parametrize("case", ["one_group", "groups", "tie_across_groups",
                                  "no_reps", "N1", "N256_runs"])
def test_walk_assign_equals_assign_to_reps(case):
    """assign's reductions by the model equal _assign_to_reps_jit's: the
    first best index, across groups of 32 too, and 0 with no flag
    without a representative."""
    N = {"N1": 1, "N256_runs": 256}.get(case, 100)
    kind = "runs" if case in ("N1", "N256_runs") else "wide"
    qs, rs = _rows(11, 23, N, kind), _rows(12, 90, N, kind)
    n_reps = {"one_group": 29, "no_reps": 0}.get(case, 90)
    if case == "tie_across_groups":
        # the same row in lanes of three groups, the best of every query
        # that matches it: the first copy must win
        rs[7] = rs[40] = rs[75] = qs[3]
        qs[9] = qs[3]
    cap_thr = jcluster._min_cap(N, 0.5)
    best, ok = _walk_assign(qs, rs, n_reps, cap_thr)
    b_j, ok_j = jcluster._assign_to_reps_jit(
        jnp.asarray(qs), jnp.asarray(rs), jnp.int32(n_reps),
        jnp.int32(cap_thr), N=N)
    assert np.array_equal(best, np.asarray(b_j).astype(np.int64))
    assert np.array_equal(ok, np.asarray(ok_j))
    if case == "tie_across_groups":
        assert best[3] == best[9] == 7 and ok[3]
    if case == "no_reps":
        assert not best.any() and not ok.any()


@pytest.mark.parametrize("N", [1, 2, 100, 255, 256, 1000, 1536])
def test_tiles_fit_the_card_up_to_max_n(N):
    """launch_walk's tiles fit a block's opt-in shared memory for every
    N up to _MAX_N (the group and at least one query row), and cover
    every pair once."""
    assert N <= mh._MAX_N
    for Q, R in ((1, 1), (1, 5400), (37, 29), (2048, 94), (2048, 2048)):
        tq, warps, smem, blocks = _tiles(Q, R, N)
        assert 1 <= warps <= tq <= MAX_TQ and smem <= SMEM_OPTIN
        assert sum(nq * nr for _, nr, _, nq in blocks) == Q * R


# ----------------------------------------------------------------------
# K8: the Mersenne fold
# ----------------------------------------------------------------------

def _fold(a, x, b):
    """sig_fold and the residue, in int64 arithmetic on 32-bit words."""
    v = a * x + b
    assert (v < 2**62).all()
    lo, hi = v & 0xFFFFFFFF, v >> 32
    s1 = (((hi << 1) | (lo >> 31)) & 0xFFFFFFFF) + (lo & P)
    assert (s1 < 2**32).all()
    s = (s1 >> 31) + (s1 & P)
    assert (s <= P).all()
    return torch.minimum(s, (s - P) & 0xFFFFFFFF)


def _fold_sig(codes, ab):
    """minhash_sig by the model: hash functions SIG_HPT a thread, codes
    in chunks as the kernel stages them, one running minimum each."""
    codes, ab = torch.as_tensor(codes).long(), torch.as_tensor(ab).long()
    (U, n), H = codes.shape, ab.shape[0]
    groups = -(-H // HPT)
    per_block = min(groups, THREADS)
    rows = THREADS // per_block
    chunk = SIG_SMEM // 4 // rows - 4
    chunk = chunk & ~3 if chunk < CHUNK else CHUNK
    assert chunk >= 4 and rows * (chunk + 4) * 4 <= SIG_SMEM
    a = torch.zeros(groups * HPT, dtype=torch.int64)
    b = torch.zeros_like(a)
    a[:H], b[:H] = ab[:, 0], ab[:, 1]
    m = torch.full((U, groups * HPT), 0xFFFFFFFF, dtype=torch.int64)
    for j0 in range(0, n, chunk):
        for jj in range(min(chunk, n - j0)):
            x = codes[:, j0 + jj, None]
            m = torch.minimum(m, _fold(a[None], x, b[None]))
    return m[:, :H]


@pytest.mark.parametrize("case", ["random", "edges", "n1_h_not_x4",
                                  "many_h", "long_rows"])
def test_fold_equals_minhash_sig_kernel(case):
    """The fold's signatures equal catch_tpu's signature program (the
    16-bit limbs of _modmul_affine_u32) and the twin, with a = p, b = p,
    codes 0 and p - 1, one code a row, H not a multiple of SIG_HPT, more
    hash functions than a block's threads take, and rows longer than a
    chunk."""
    rng = np.random.default_rng({"random": 1, "edges": 2, "n1_h_not_x4": 3,
                                 "many_h": 4, "long_rows": 5}[case])
    U, n, H = {"random": (30, 91, 60), "edges": (12, 91, 16),
               "n1_h_not_x4": (9, 1, 7), "many_h": (5, 20, 1030),
               "long_rows": (4, 600, 6)}[case]
    codes = rng.integers(0, P, size=(U, n))
    ab = np.stack([rng.integers(1, P + 1, size=H),
                   rng.integers(0, P + 1, size=H)], 1)
    if case == "edges":
        codes[0], codes[1] = 0, P - 1
        codes[2, ::2] = 0
        codes[3, ::3] = P - 1
        ab[:4] = [[P, P], [P, 0], [1, P], [P, P - 1]]
        ab[4:8, 1] = P
    want = np.asarray(jlsh._minhash_sig_kernel_factory()(
        jnp.asarray(codes.astype(np.uint32)),
        jnp.asarray(ab.astype(np.uint32)))).T.astype(np.int64)
    got = _fold_sig(codes, ab).numpy()
    assert np.array_equal(got, want)
    twin = mh.minhash_sig(torch.from_numpy(codes.astype(np.int32)),
                          torch.from_numpy(ab.astype(np.int32)))
    assert np.array_equal(twin.numpy().astype(np.int64), want)
    if case == "edges":
        # a = b = p gives 0 for every code: the s = p case of the fold
        assert (got[:, 0] == 0).all()


def test_fold_takes_every_residue_path():
    """Products whose folds land on s = p (residue 0), on s1 >= 2^31
    and on the largest v: the fold's residue is v mod p."""
    x = torch.tensor([0, 1, 2, P - 1, P - 2, 2**30, 12345, P - 1],
                     dtype=torch.int64)
    a = torch.tensor([P, P, P, P, 1, 2, 3, P - 1], dtype=torch.int64)
    b = torch.tensor([P, 0, P - 1, P, P, P, 0, P], dtype=torch.int64)
    got = _fold(a, x, b)
    assert torch.equal(got, (a * x + b) % P)
