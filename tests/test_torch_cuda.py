"""catch_tpu_torch's CUDA kernels against their plain-PyTorch twins, on
the card.

Every test here needs a CUDA device and skips without one.  The card's
host has no JAX, so this file imports neither jax nor catch_tpu, and it
runs there without tests/conftest.py (which imports jax):

    python -m pytest --noconftest -o markers=cuda -q tests/test_torch_cuda.py

The inputs cover the paths the smoke run (chip_smoke.py) does not: the
window fast path, islands, several chromosomes, sequences shorter than
the probes, merge buckets of every tier (the block tier forced small),
ties, touching and nested spans, the ends of the key and position
ranges, the span scan without minimizers (w = 1) and in
many expansion slabs, and empty inputs; for the MinHash kernels, tiles
and groups of 32 left part full, one query, runs of duplicates, N from
1 to 1536, ties across groups, and K8's edge values; for verify_windows' mask
kernels, probe lengths 75 to 250, every alignment mod 16, K from 0 to
62, a corpus with no tail pad or not 16-byte aligned, and alphabets of
more than four codes with 'N' and PAD; for greedy_v2, a set of more
pairs than a block, sets with no pairs, intervals across many tiles of
its overlap index, position axes at the scan's tile edges and a stop
mid-dispatch; for greedy_v1, the same shapes, pairs and intervals in
random order, intervals that overlap within a pair and a set, and its
regrouping rebuilt; for greedy_sharded, the same instances at 1 to 8
places with empty shards, every place counted as a card of its own, its
launches a step and its piece-limit route.  Every comparison is exact.
"""

import numpy as np
import pytest
import torch

from catch_tpu_torch.filters.candidates import (
    make_candidate_probes_from_sequences)
from catch_tpu_torch.ops import scan_instance as si
from catch_tpu_torch.ops import scan_sparse as ss
from catch_tpu_torch.ops.cover import CoverModel, ProbeSearcher

BASES = np.array(list("ACGT"))

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _assert_equal(got, want):
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and w.device.type == "cuda"
        assert torch.equal(g, w)


def _genomes(seed, n_chrs, short):
    rng = np.random.default_rng(seed)
    base = rng.choice(BASES, size=1200)
    out = []
    for _ in range(5):
        seq = base.copy()
        m = rng.random(len(seq)) < 0.04
        seq[m] = rng.choice(BASES, size=int(m.sum()))
        bounds = np.linspace(0, len(seq), n_chrs + 1).astype(int)
        chrs = ["".join(seq[a:b]) for a, b in zip(bounds[:-1], bounds[1:])]
        if short:
            chrs += ["".join(seq[100:150]), "".join(seq[300:370])]
        out.append(chrs)
    return out


@pytest.mark.parametrize("model_kw,ext,n_chrs,short,k_seed", [
    (dict(mismatches=2, lcf_thres=60), 30, 1, False, None),
    (dict(mismatches=0, lcf_thres=60), 0, 1, False, None),
    (dict(mismatches=2, lcf_thres=80), 0, 1, False, None),
    (dict(mismatches=1, lcf_thres=60, island_of_exact_match=25), 10, 1,
     False, None),
    (dict(mismatches=2, lcf_thres=60), 20, 3, False, None),
    (dict(mismatches=0, lcf_thres=80), 5, 1, True, 20),
], ids=["m2_l60_e30", "m0", "fast_m2_l80", "island25", "multichrom",
        "k0_short_seqs"])
def test_kernels_equal_twins(cuda, model_kw, ext, n_chrs, short, k_seed):
    genomes = _genomes(11, n_chrs, short)
    seqs = [s for g in genomes for s in g]
    probes = list(dict.fromkeys(make_candidate_probes_from_sequences(
        [g[0] for g in genomes], probe_length=80, probe_stride=40)))
    searcher = ProbeSearcher(probes, CoverModel(**model_kw))
    if k_seed is not None:
        searcher.k_seed = k_seed
    univ, off = [], []
    for j, g in enumerate(genomes):
        pos = 0
        for s in g:
            univ.append(j)
            off.append(pos)
            pos += len(s)
    st, total, _ = si.prepare_corpus(searcher, seqs, univ, off,
                                     np.arange(len(probes)), cuda)
    kj, s = si.join_params_stride(searcher)
    n_samples = -(-total // s)

    q = si.rolling_hash(st["mega"], n_samples, s, kj, total - kj)
    _assert_equal([q], [si._rolling_hash_plain(st["mega"], n_samples, s,
                                               kj, total - kj)])
    tbl = si.build_table(st["codes"], kj)
    _assert_equal(tbl, si._build_table_plain(st["codes"], kj))

    pc, ac = si.lookup_expand(*tbl, q, s)
    _assert_equal((pc, ac), si._lookup_expand_plain(*tbl, q, s))
    assert pc.numel() > 0

    island = model_kw.get("island_of_exact_match", 0)
    args = dict(K=int(searcher.K_static), k_seed=int(searcher.k_seed),
                lcf=int(searcher.lcf_static),
                seed_req=max(int(searcher.k_seed), island),
                fast_ok=bool(searcher.fast_ok), ext=ext, nU=len(genomes))
    vt = (st["mega"], st["codes"], st["lens"], pc, ac, st["seq_starts"],
          st["seq_ends"], st["seq_lens"], st["chrom_off"], st["univ_of_seq"])
    spans = si.verify_windows(*vt, **args)
    _assert_equal(spans, si._verify_windows_plain(*vt, **args))
    assert spans[0].numel() > 0

    merged = si.segmented_merge(*spans)
    _assert_equal(merged, si._segmented_merge_plain(*spans))
    union_in = (merged[0] % len(genomes), merged[1], merged[2])
    _assert_equal(si.segmented_merge(*union_in),
                  si._segmented_merge_plain(*union_in))


@pytest.mark.parametrize("n", [1, 1023, 1024, 1025, 2049, 5000,
                               (1 << 20) + 1025])
def test_segmented_merge_block_boundaries(cuda, n):
    """Sorted groups of every size from one row up, with long spans that
    swallow their group: buckets of every tier, and (at the largest n)
    over a thousand of them."""
    rng = np.random.default_rng(n)
    k = np.sort(rng.integers(0, max(1, n // 3000), size=n))
    s = rng.integers(0, 1 << 20, size=n)
    e = s + rng.integers(1, 400, size=n)
    s[::997] = 0
    e[::997] = 1 << 20        # long spans that swallow their group
    k, s, e = (torch.from_numpy(x).to(cuda) for x in (k, s, e))
    _assert_equal(si.segmented_merge(k, s, e),
                  si._segmented_merge_plain(k, s, e))


def _merge_case(case, rng):
    """(key, start, end) numpy rows of one segmented_merge card case."""
    if case == "random_order":
        n = 200_000
        k = rng.integers(0, 5000, size=n)
        s = rng.integers(0, 1 << 20, size=n)
        e = s + rng.integers(0, 500, size=n)
    elif case == "ties_and_duplicates":
        bk = rng.integers(0, 2000, size=20_000)
        bs = rng.integers(0, 100_000, size=20_000)
        pick = rng.integers(0, 20_000, size=150_000)
        k, s = bk[pick], bs[pick]
        e = s + rng.integers(0, 300, size=pick.size)
        k, s, e = (np.concatenate([x, x[:30_000]]) for x in (k, s, e))
    elif case == "touching":
        s = np.cumsum(rng.integers(1, 40, size=100_000))
        e = np.concatenate([s[1:], [s[-1] + 7]])
        e[::1000] = s[::1000]               # a few empty spans
        k = np.repeat(np.arange(100), 1000)
    elif case == "nested":
        os_ = rng.integers(0, 1 << 24, size=50_000)
        oe = os_ + rng.integers(1000, 5000, size=50_000)
        ins = os_ + rng.integers(0, 500, size=50_000)
        ine = np.minimum(ins + rng.integers(0, 400, size=50_000), oe)
        k = np.tile(rng.integers(0, 3000, size=50_000), 2)
        s, e = np.concatenate([os_, ins]), np.concatenate([oe, ine])
    elif case == "keys_to_2^31":
        n = 100_000
        k = rng.integers(0, 2 ** 31 - 1, size=n)
        k[:1000] = 2 ** 31 - 1
        k[1000:2000] = 0
        s = rng.integers(0, 1 << 16, size=n)
        e = s + rng.integers(0, 3000, size=n)
    elif case == "starts_near_2^32":
        n = 100_000
        k = rng.integers(0, 300, size=n)
        s = rng.integers(2 ** 32 - 200_000, 2 ** 32 - 1, size=n)
        e = np.minimum(s + rng.integers(0, 500, size=n), 2 ** 32 - 1)
        s[:50] = 2 ** 32 - 1
        e[:50] = 2 ** 32 - 1
    elif case == "one_key_1m_rows":
        n = 1_000_000
        k = np.full(n, 12345)
        s = rng.integers(0, 1 << 30, size=n)
        e = s + rng.integers(0, 2000, size=n)
    elif case == "union_shape":
        k = np.tile(np.arange(175), 18_000)
        s = rng.integers(0, 18_900, size=k.size)
        e = np.minimum(s + rng.integers(0, 200, size=k.size), 18_959)
    elif case == "avoid_shape":
        p = np.repeat(np.arange(2309), 40)
        strand = rng.integers(0, 2, size=p.size)
        k = p * 2 + strand
        s = rng.integers(0, 25_000_000, size=p.size)
        e = s + rng.integers(60, 200, size=p.size)
    else:   # one row
        k, s = np.array([7]), np.array([2 ** 32 - 2])
        e = s + 1
    order = rng.permutation(len(k))
    return k[order], s[order], e[order]


@pytest.mark.parametrize("tile", [None, 64], ids=["tile_default",
                                                 "tile64"])
@pytest.mark.parametrize("case", [
    "random_order", "ties_and_duplicates", "touching", "nested",
    "keys_to_2^31", "starts_near_2^32", "one_key_1m_rows", "union_shape",
    "avoid_shape", "one_row"])
def test_segmented_merge_cases_equal_twin(cuda, case, tile):
    """The bucket route against its twin, at the default tile and with
    the block tier forced down to 64 rows (so that buckets go to the
    radix sort in device memory): one launch a call, exactly equal."""
    rng = np.random.default_rng(sum(map(ord, case)))
    k, s, e = (torch.from_numpy(x.astype(np.int64)).to(cuda)
               for x in _merge_case(case, rng))
    si.reset_launches()
    got = (si.segmented_merge(k, s, e) if tile is None
           else si._segmented_merge_cuda(k, s, e, tile))
    torch.cuda.synchronize()
    assert si.segmented_merge.launches == 1
    want = si._segmented_merge_plain(k, s, e)
    _assert_equal(got, want)
    assert all(x.dtype == torch.int64 for x in got)


@pytest.mark.parametrize("bad", ["key_2^31", "start_2^32", "end_before_start"])
def test_segmented_merge_rejects_rows_out_of_range(cuda, bad):
    k = torch.tensor([0, 5, 9], dtype=torch.int64, device=cuda)
    s = torch.tensor([10, 20, 30], dtype=torch.int64, device=cuda)
    e = torch.tensor([15, 25, 35], dtype=torch.int64, device=cuda)
    if bad == "key_2^31":
        k[1] = 1 << 31
    elif bad == "start_2^32":
        s[2], e[2] = 1 << 32, 1 << 32
    else:
        e[1] = 19
    si.reset_launches()
    with pytest.raises(ValueError, match="segmented_merge"):
        si.segmented_merge(k, s, e)
    with pytest.raises(ValueError, match="segmented_merge"):
        si._segmented_merge_cuda(k, s, e, 64)
    assert si.segmented_merge.launches == 0


def test_empty_inputs(cuda):
    e = torch.empty(0, dtype=torch.int64, device=cuda)
    assert all(x.numel() == 0 for x in si.segmented_merge(e, e, e))
    assert si.rolling_hash(torch.zeros(4, dtype=torch.uint8, device=cuda),
                           0, 1, 2, 0).numel() == 0
    q = torch.tensor([1, 2, si.HMAX], dtype=torch.int64, device=cuda)
    for P, L in ((0, 100), (3, 8)):       # no probe; probes shorter than kj
        si.reset_launches()
        tbl = si.build_table(torch.ones((P, L), dtype=torch.uint8,
                                        device=cuda), 12)
        assert tuple(tbl[0].shape) == (P, 0 if L < 12 else L - 11)
        assert si.build_table.launches == (1 if P else 0)
        _assert_equal(tbl, si._build_table_plain(
            torch.ones((P, L), dtype=torch.uint8, device=cuda), 12))
        p, a = si.lookup_expand(*tbl, q, 3)
        assert p.numel() == a.numel() == 0
        assert si.lookup_expand.launches == 0


CODE = {"A": 1, "C": 2, "G": 3, "T": 4}


def _codes(seq):
    return np.array([CODE[c] for c in seq], dtype=np.uint8)


def _k2_case(cuda, probes, corpus, kj, s, sample0=0):
    """lookup_expand against its twin on probes (strings of one length)
    and a corpus string behind a pad of L + kj codes; returns the pairs
    and the raw hit count."""
    L = len(probes[0])
    codes = torch.from_numpy(np.stack([_codes(x) for x in probes])).to(cuda)
    mega = np.concatenate([np.zeros(L + kj, np.uint8), _codes(corpus),
                           np.zeros(L + s + kj, np.uint8)])
    total = L + kj + len(corpus)
    n = -(-total // s) - sample0
    mega_t = torch.from_numpy(mega).to(cuda)
    q = si.rolling_hash(mega_t[sample0 * s:], n, s, kj,
                        total - kj - sample0 * s)
    tbl = si.build_table(codes, kj)
    si.reset_launches()
    got = si.lookup_expand(*tbl, q, s, sample0=sample0)
    torch.cuda.synchronize()
    assert si.lookup_expand.launches == 1
    _assert_equal(got, si._lookup_expand_plain(*tbl, q, s, sample0))
    qs = torch.sort(q).values
    h = si.table_entries(*tbl)[0]
    raw = int((torch.searchsorted(qs, h, right=True)
               - torch.searchsorted(qs, h)).sum())
    return got, raw


def _random_seq(rng, n):
    return "".join(rng.choice(BASES, size=n))


@pytest.mark.parametrize("sample0", [0, 1, 777])
def test_lookup_expand_sample_offset(cuda, sample0):
    """A later range of the samples (the mesh's places): alignments
    from corpus sample sample0 + g."""
    rng = np.random.default_rng(3)
    corpus = _random_seq(rng, 20_000)
    probes = [corpus[i:i + 100] for i in range(0, 19_900, 150)]
    (p, a), raw = _k2_case(cuda, probes, corpus, 12, 9, sample0=sample0)
    assert p.numel() > 0 and raw >= p.numel()


def test_lookup_expand_repeated_kmers_and_poly_a(cuda):
    """Probes that repeat a kj-mer (a tandem repeat, and poly-A) against
    a corpus with a poly-A run of over 10,000 samples: one sample run
    holds them all, and the poly-A probe has over 100,000 raw hits."""
    rng = np.random.default_rng(5)
    corpus = (_random_seq(rng, 5000) + "A" * 95_000 + _random_seq(rng, 3000)
              + "ACGT" * 200 + _random_seq(rng, 2000))
    probes = ["A" * 100, "ACGT" * 25, corpus[100:200], corpus[4950:5050],
              _random_seq(rng, 100)]
    (p, a), raw = _k2_case(cuda, probes, corpus, 12, 9)
    assert raw > 100_000
    n_poly = int((p == 0).sum())
    assert n_poly > 10_000
    assert torch.equal(a[:n_poly], torch.sort(a[:n_poly]).values)


def test_lookup_expand_no_hits_single_probe_and_sentinels(cuda):
    """Probes with no hit beside one with hits; a single probe; samples
    that are all HMAX."""
    rng = np.random.default_rng(8)
    corpus = _random_seq(rng, 8000)
    probes = [_random_seq(rng, 100) for _ in range(6)] + [corpus[500:600]]
    (p, a), _ = _k2_case(cuda, probes, corpus, 12, 9)
    assert set(p.tolist()) == {6}
    (p, a), _ = _k2_case(cuda, [corpus[2000:2100]], corpus, 12, 9)
    assert p.numel() > 0 and set(p.tolist()) == {0}
    tbl = si.build_table(torch.from_numpy(_codes(corpus[:1000]).reshape(
        10, 100)).to(cuda), 12)
    q = torch.full((5000,), si.HMAX, dtype=torch.int64, device=cuda)
    p, a = si.lookup_expand(*tbl, q, 9)
    assert p.numel() == a.numel() == 0


@pytest.mark.parametrize("L", [50, 200, 300])
def test_lookup_expand_long_probes(cuda, L):
    """Offsets a lane holds in registers: L = 50 two, L = 200 (189
    offsets a probe) eight; L = 300: 289 offsets, above the registers'
    256, merged in scratch."""
    rng = np.random.default_rng(13)
    base = rng.choice(BASES, size=12_000)
    corpus = "".join(base)
    for _ in range(3):
        m = rng.random(len(base)) < 0.02
        mut = base.copy()
        mut[m] = rng.choice(BASES, size=int(m.sum()))
        corpus += "".join(mut)
    probes = [corpus[i:i + L] for i in range(0, 11_700, 97)]
    (p, a), raw = _k2_case(cuda, probes, corpus, 12, 9)
    assert raw > p.numel() > len(probes)


@pytest.mark.parametrize("case", [
    "pad_inside", "short_probe", "one_probe", "odd_L", "long_rows",
    "many_probes"])
def test_build_table_equals_twin(cuda, case):
    """Stage T's kernel against its twin, exactly (the unused slots
    included): probes with PAD inside, probes shorter than kj and of 40
    codes, one probe, L = 83, rows of 300 codes (9 rounds of 32
    windows), and 600,000 probes (more than the grid's warps, which
    then take several probes each)."""
    rng = np.random.default_rng(len(case))
    P, L = {"one_probe": (1, 80), "odd_L": (12, 83), "long_rows": (50, 300),
            "many_probes": (600_000, 40)}.get(case, (12, 80))
    codes = rng.integers(1, 5, size=(P, L)).astype(np.uint8)
    if case in ("pad_inside", "many_probes"):
        codes[rng.random((P, L)) < 0.03] = 0
    if case == "short_probe":
        codes[3, 9:] = 0
        codes[5, 40:] = 0
    ct = torch.from_numpy(codes).to(cuda)
    si.reset_launches()
    got = si.build_table(ct, 12)
    torch.cuda.synchronize()
    assert si.build_table.launches == 1
    want = si._build_table_plain(ct, 12)
    _assert_equal(got, want)
    assert int(want[1].sum()) > 0
    if case == "short_probe":
        assert int(got[1][3]) == 0 and int(got[1][5]) == 29


@pytest.mark.parametrize("b_pos,n", [(2, 1), (2, 5000), (3, 70000),
                                     (4, 1 << 20)])
def test_pack_merged_equals_twin(cuda, b_pos, n):
    """Packed bytes and escapes, with key jumps and lengths past 16 bits
    and a start that fills every byte; the host decoder gives the rows
    back."""
    rng = np.random.default_rng(n)
    dk = rng.integers(0, 4, size=n)
    dk[::1777] = 0x12345
    k = np.cumsum(dk)
    top = min(1 << (8 * b_pos), 1 << 40)
    s = rng.integers(0, top, size=n)
    s[-1] = top - 1
    e = s + rng.integers(0, 3000, size=n)
    e[::2311] += 0x10000
    rows = [torch.from_numpy(x).to(cuda) for x in (k, s, e)]
    got = si.pack_merged(*rows, b_pos)
    _assert_equal(got, si._pack_merged_plain(*rows, b_pos))
    assert got[1].numel() >= 1
    for g, w in zip(si.unpack_merged(*(x.cpu().numpy() for x in got),
                                     b_pos), (k, s, e)):
        assert np.array_equal(g, w)
    empty = torch.empty(0, dtype=torch.int64, device=cuda)
    assert all(x.numel() == 0 for x in si.pack_merged(empty, empty, empty,
                                                       b_pos))


def _pack_rows(n, seed, escapes=()):
    """n merged rows sorted by key with small key deltas and lengths,
    starts filling 24 bits; `escapes` is a list of (row, what) with what
    'key' (a key jump past 16 bits before the row), 'len' (a length past
    16 bits) or 'both'."""
    rng = np.random.default_rng(seed)
    dk = rng.integers(0, 4, size=n)
    ln = rng.integers(0, 3000, size=n)
    for r, what in escapes:
        if what in ("key", "both"):
            dk[r] = 0x10000 + r
        if what in ("len", "both"):
            ln[r] = 0x10000 + 7 * r
    k = np.cumsum(dk)
    s = rng.integers(0, 1 << 16, size=n)
    return k, s, s + ln


def _check_pack(cuda, rows, b_pos, tile):
    """The kernel at `tile` against the twin, and the host decoder back to
    the rows."""
    t = [torch.from_numpy(np.ascontiguousarray(x)).to(cuda) for x in rows]
    got = si._pack_merged_cuda(*t, b_pos, tile)
    torch.cuda.synchronize()
    _assert_equal(got, si._pack_merged_plain(*t, b_pos))
    for g, w in zip(si.unpack_merged(*(x.cpu().numpy() for x in got),
                                     b_pos), rows):
        assert np.array_equal(g, w)
    return got


@pytest.mark.parametrize("tile", [16, 48, 2048])
@pytest.mark.parametrize("b_pos", [2, 3, 4])
@pytest.mark.parametrize("size", ["1", "tile-1", "tile", "tile+1",
                                  "3tile+5"])
def test_pack_merged_tiles_equal_twin(cuda, tile, b_pos, size):
    """K9 at every row count round its tile (forced small), each b_pos,
    with a start that fills every byte of its field and an escape in
    the last row."""
    n = {"1": 1, "tile-1": tile - 1, "tile": tile, "tile+1": tile + 1,
         "3tile+5": 3 * tile + 5}[size]
    rng = np.random.default_rng(n + b_pos)
    k = np.cumsum(rng.integers(0, 4, size=n))
    top = 1 << (8 * b_pos)
    s = rng.integers(0, top, size=n)
    s[-1] = top - 1
    e = s + rng.integers(0, 3000, size=n)
    e[-1] = s[-1] + 0x10000
    got = _check_pack(cuda, (k, s, e), b_pos, tile)
    assert got[1].tolist() == [n - 1]
    empty = torch.empty(0, dtype=torch.int64, device=cuda)
    assert all(x.numel() == 0 for x in si._pack_merged_cuda(
        empty, empty, empty, b_pos, tile))


@pytest.mark.parametrize("case", ["none", "row0", "tile_edges", "every_tile",
                                  "key_and_len"])
def test_pack_merged_escapes_equal_twin(cuda, case):
    """K9's escape lists with 64-row tiles: none; in row 0; at the rows
    either side of each tile edge; in every tile (every row of one);
    and a key-delta and a length escape in one row."""
    tile, n = 64, 5 * 64 + 9
    escapes = {
        "none": [],
        "row0": [(0, "key")],
        "tile_edges": [(r, w) for j in range(1, 6) for r, w in
                       ((j * tile - 1, "key"), (j * tile, "len"))],
        "every_tile": [(r, "len") for r in range(tile, 2 * tile)]
        + [(j * tile + 3, "key") for j in (0, 2, 3, 4, 5)],
        "key_and_len": [(70, "both"), (71, "key"), (200, "both")],
    }[case]
    rows = _pack_rows(n, 3, escapes)
    got = _check_pack(cuda, rows, 2, tile)
    assert got[1].tolist() == sorted({r for r, _ in escapes})
    assert got[2].numel() == got[3].numel() == len(got[1])


def test_pack_merged_rejects_bad_tiles(cuda):
    x = torch.zeros(4, dtype=torch.int64, device=cuda)
    for tile in (8, 24, 4096):
        with pytest.raises(ValueError, match="tile"):
            si._pack_merged_cuda(x, x, x, 2, tile)


def test_assemble_keys_past_2_31_equal_twin(cuda):
    """K10 on merged rows whose int64 keys set * nU + universe pass 2^31,
    as the probe blocks of a large scan give them."""
    rng = np.random.default_rng(13)
    nU, n_sets, n = 1 << 22, 900, 20000
    key = np.unique(rng.integers(0, n_sets, size=n) * nU
                    + rng.integers(0, nU, size=n))
    key = np.repeat(key, rng.integers(1, 4, size=len(key)))
    assert key.max() >= 1 << 31
    start = rng.integers(0, 90, size=len(key))
    end = start + rng.integers(1, 10, size=len(key))
    offsets = np.arange(nU + 1, dtype=np.int64) * 100
    rows = [torch.from_numpy(x).to(cuda) for x in (key, start, end, offsets)]
    got = si.assemble(*rows, n_sets)
    torch.cuda.synchronize()
    want = si._assemble_plain(*rows, n_sets)
    _assert_equal(got[:5], want[:5])
    assert got[5:] == want[5:]
    assert int(got[4].max()) >= nU // 2 and int(got[1].max()) > 1 << 28


def test_design_on_cuda_equals_cpu(cuda):
    """The whole slice on the card gives the CPU twins' probe set."""
    from catch_tpu_torch.filters.set_cover_filter import SetCoverFilter
    from catch_tpu_torch.genome import Genome

    genomes = [Genome.from_one_seq(g[0]) for g in _genomes(4, 1, False)]
    probes = make_candidate_probes_from_sequences(
        [g.seqs[0] for g in genomes], probe_length=80, probe_stride=40)
    out = {}
    for dev in ("cpu", "cuda"):
        f = SetCoverFilter(2, 60, cover_extension=25, device=dev)
        out[dev] = [p.seq_str for p in f.filter(
            [list(probes)], [genomes], input_is_grouped=True)[0]]
    assert out["cuda"] == out["cpu"] and out["cpu"]


def test_scan_instance_trace_holds_the_scan_kernels(cuda, monkeypatch,
                                                    tmp_path):
    """With CATCH_TPU_PROFILE_DIR set, the scan_instance region's capture
    on the card holds a kernel for every launch made inside the region,
    those of lookup_expand and verify_windows among them (by their
    __global__ names in csrc/), also after an earlier profiler session in
    the process (which can cost a capture its first kernel records:
    profiling._warm_up)."""
    import json
    import os

    from catch_tpu_torch.filters.set_cover_filter import SetCoverFilter
    from catch_tpu_torch.genome import Genome
    from catch_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "_captured", set())
    monkeypatch.setenv("CATCH_TPU_PROFILE_DIR", str(tmp_path))
    genomes = [Genome.from_one_seq(g[0]) for g in _genomes(4, 1, False)]
    probes = make_candidate_probes_from_sequences(
        [g.seqs[0] for g in genomes], probe_length=80, probe_stride=40)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]):
        torch.ones(1 << 20, device=cuda).cumsum(0)
        torch.cuda.synchronize()
    SetCoverFilter(2, 60, cover_extension=25, device="cuda").filter(
        [list(probes)], [genomes], input_is_grouped=True)
    (name,) = os.listdir(tmp_path / "scan_instance")
    with open(tmp_path / "scan_instance" / name) as f:
        events = json.load(f)["traceEvents"]
    (span,) = [e for e in events if e.get("name") == "scan_instance"
               and e.get("cat") == "user_annotation"]
    inside = {e["args"]["correlation"] for e in events
              if e.get("cat") == "cuda_runtime"
              and "LaunchKernel" in e.get("name", "")
              and span["ts"] <= e["ts"] <= span["ts"] + span["dur"]}
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"
               and e.get("args", {}).get("correlation") in inside]
    assert len(kernels) == len(inside) > 0
    for sym in ("le_merge_kernel", "vw_mask_kernel", "vw_emit_kernel"):
        assert any(sym in k for k in kernels), (sym, sorted(kernels))


def _span_corpus(seed):
    """Sequences mutated from one shared base, plus two shorter than the
    60 bp probes (one of them empty)."""
    rng = np.random.default_rng(seed)
    base = rng.choice(BASES, size=900)
    seqs = []
    for _ in range(6):
        seq = base[:int(rng.integers(150, 900))].copy()
        m = rng.random(len(seq)) < 0.025
        seq[m] = rng.choice(BASES, size=int(m.sum()))
        seqs.append("".join(seq))
    return seqs + ["ACGT", ""]


@pytest.mark.parametrize("model_kw,k", [
    (dict(mismatches=2, lcf_thres=40), 20),
    (dict(mismatches=2, lcf_thres=60), 20),
    (dict(mismatches=0, lcf_thres=30), 20),
    (dict(mismatches=2, lcf_thres=40, island_of_exact_match=25), 20),
    (dict(mismatches=2, lcf_thres=40), 10),
], ids=["mismatch", "fast_path", "exact", "island", "w1_k10"])
def test_span_kernels_equal_twins(cuda, model_kw, k):
    """expand_join and verify_spans against their twins on the card, and
    the whole span scan on the card against the CPU."""
    seqs = _span_corpus(3)
    probes = list(dict.fromkeys(make_candidate_probes_from_sequences(
        seqs[:6], probe_length=60, probe_stride=25)))
    searcher = ProbeSearcher(probes, CoverModel(**model_kw),
                             kmer_probe_map_k=k, device=cuda)
    mega, starts, ends, total = ss.corpus_codes(searcher, seqs)
    lo, cnt, pos = (torch.from_numpy(x).to(cuda)
                    for x in ss.join_runs(searcher, mega[:total]))
    assert searcher._join_kw[1] == (1 if k == 10 else 9)
    tbl = ss.join_table(searcher, cuda)
    pa = ss.expand_join(lo, cnt, pos, *tbl, searcher.Lmax)
    _assert_equal(pa, ss._expand_join_plain(lo, cnt, pos, *tbl,
                                            searcher.Lmax))
    cand = ss.keep_candidates(searcher, *pa,
                              torch.from_numpy(starts).to(cuda),
                              torch.from_numpy(ends).to(cuda))
    vt = (torch.from_numpy(mega).to(cuda),
          torch.from_numpy(searcher.probe_codes).to(cuda)) + cand
    vargs = ss.verify_args(searcher)
    spans = ss.verify_spans(*vt, **vargs)
    _assert_equal(spans, ss._verify_spans_plain(*vt, **vargs))
    assert spans[0].numel() > 0
    on_cpu = ProbeSearcher(probes, CoverModel(**model_kw),
                           kmer_probe_map_k=k, device=torch.device("cpu"))
    for g, w in zip(searcher.find_probe_covers_flat(seqs),
                    on_cpu.find_probe_covers_flat(seqs)):
        assert np.array_equal(g, w)


def test_span_scan_many_slabs(cuda, monkeypatch):
    """Expansion slabs of 256 hits on the card give the CPU's spans."""
    seqs = _span_corpus(4)
    probes = list(dict.fromkeys(make_candidate_probes_from_sequences(
        seqs[:6], probe_length=60, probe_stride=25)))
    want = ProbeSearcher(probes, CoverModel(2, 40), device=torch.device(
        "cpu")).find_probe_covers_flat(seqs)
    monkeypatch.setattr(ss, "_EXPAND_SLAB", 1 << 8)
    ss.expand_join.launches = 0
    got = ProbeSearcher(probes, CoverModel(2, 40),
                        device=cuda).find_probe_covers_flat(seqs)
    assert ss.expand_join.launches > 5
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def test_span_kernels_empty_inputs(cuda):
    e = torch.empty(0, dtype=torch.int64, device=cuda)
    p, a = ss.expand_join(e, e, e, e, e, 60)
    assert p.numel() == a.numel() == 0
    z = torch.zeros(3, dtype=torch.int64, device=cuda)
    p, a = ss.expand_join(z, z, z, z, z, 60)     # runs of no hits
    assert p.numel() == a.numel() == 0
    mega = torch.zeros(8, dtype=torch.uint8, device=cuda)
    codes = torch.zeros((1, 4), dtype=torch.uint8, device=cuda)
    out = ss.verify_spans(mega, codes, e, e, e, e, e, e, K=2, k_seed=4,
                          seed_req=4, fast_ok=False)
    assert all(x.numel() == 0 for x in out)
    with pytest.raises(ValueError, match="K=63"):
        ss.verify_spans(mega, codes, e, e, e, e, e, e, K=63, k_seed=4,
                        seed_req=4, fast_ok=False)


def _verify_inputs(seed, L, lcf, k_seed, n_probes=10, n_cand=500):
    """Probe rows of lengths L - 9 to L, a corpus of their mutated copies
    laid out as scan_sparse.corpus_codes lays it out (the first sequence
    behind mega's leading pad, the last before its tail), and candidates
    at and near the copies, at random and at both ends of the corpus,
    with the keep predicate's fields: (mega, codes, the six candidate
    arrays) as numpy."""
    rng = np.random.default_rng(seed)
    plens = rng.integers(max(1, L - 9), L + 1, size=n_probes)
    plens[0] = plens[-1] = L
    codes = np.zeros((n_probes, L), dtype=np.uint8)
    for i, n in enumerate(plens):
        codes[i, :n] = rng.integers(1, 5, size=n)
    seqs, planted = [], []
    for s in range(8):
        parts, at = [], 0
        for _ in range(6):
            p = int(rng.integers(n_probes))
            q = codes[p, :plens[p]].copy()
            m = rng.random(len(q)) < rng.choice([0.0, 0.01, 0.03, 0.1, 0.3])
            q[m] = rng.integers(1, 5, size=int(m.sum()))
            gap = rng.integers(1, 5, size=int(rng.integers(0, 25)))
            planted.append((s, p, at + len(gap)))
            parts += [gap, q]
            at += len(gap) + len(q)
        seqs.append(np.concatenate(parts))
    seqs.append(codes[1, :max(1, L // 2)].copy())     # shorter than L
    starts, pos = [], L
    for x in seqs:
        starts.append(pos)
        pos += len(x) + L
    mega = np.zeros(pos + L, dtype=np.uint8)
    for st, x in zip(starts, seqs):
        mega[st:st + len(x)] = x
    ends = [st + len(x) for st, x in zip(starts, seqs)]
    pairs = [(p, starts[s] + at + int(d)) for s, p, at in planted
             for d in [0] + rng.integers(-3, 4, size=2).tolist()]
    pairs += [(int(rng.integers(n_probes)), int(rng.integers(1, pos)))
              for _ in range(n_cand - len(pairs))]
    pairs += [(1, starts[-1]), (0, starts[0]), (n_probes - 1, ends[-2] - 1)]
    fields = []
    for p, a in pairs:
        sid = min(int(np.searchsorted(ends, a, side="right")), len(ends) - 1)
        s_lo, s_hi = starts[sid], ends[sid]
        st = max(s_lo, a)
        ov = min(s_hi, a + int(plens[p])) - st
        n_seq = s_hi - s_lo
        thres = min(min(int(plens[p]), lcf), n_seq)
        if ov >= max(thres, k_seed) and thres > 0:
            fields.append((p, st, st - a, ov, thres, n_seq))
    return mega, codes, [np.array(x, dtype=np.int64) for x in zip(*fields)]


@pytest.mark.parametrize("K,fast_ok,L,lcf,k_seed", [
    (7, False, 100, 60, 10), (7, True, 100, 60, 10),
    (8, False, 100, 60, 10), (8, True, 100, 60, 10),
    (62, False, 61, 40, 6), (3, False, 13, 12, 4)],
    ids=["K7", "K7-fast", "K8", "K8-fast", "K62-L61", "K3-L13"])
def test_verify_spans_edge_shapes(cuda, K, fast_ok, L, lcf, k_seed):
    """verify_spans on the card equals its twin where the window state
    goes from registers (K = 7) to the ring (K = 8), at K = 62, at an L
    that is no multiple of 4 or 16, and for each candidate alone."""
    mega, codes, cand = _verify_inputs(K + L, L, lcf, k_seed)
    vt = [torch.from_numpy(x).to(cuda) for x in [mega, codes] + cand]
    kw = dict(K=K, k_seed=k_seed, seed_req=k_seed, fast_ok=fast_ok)
    want = ss._verify_spans_plain(*vt, **kw)
    assert want[0].numel() > 10
    _assert_equal(ss.verify_spans(*vt, **kw), want)
    for i in (0, len(cand[0]) // 2, len(cand[0]) - 1):
        one = [x[i:i + 1].contiguous() for x in vt[2:]]
        _assert_equal(ss.verify_spans(*vt[:2], *one, **kw),
                      ss._verify_spans_plain(*vt[:2], *one, **kw))


@pytest.mark.parametrize("shift", [(1 << 31) + 16, (1 << 31) + 1005])
def test_verify_spans_past_2_31_bytes(cuda, shift):
    """On a corpus longer than 2^31 bytes, candidates planted past that
    offset give the spans of the same candidates on the small corpus,
    shifted."""
    mega, codes, cand = _verify_inputs(3, 100, 60, 10)
    kw = dict(K=2, k_seed=10, seed_req=10, fast_ok=False)
    small = [torch.from_numpy(x).to(cuda) for x in [mega, codes] + cand]
    want = ss.verify_spans(*small, **kw)
    _assert_equal(want, ss._verify_spans_plain(*small, **kw))
    assert want[0].numel() > 10
    big = torch.zeros(shift + len(mega), dtype=torch.uint8, device=cuda)
    big[shift:] = small[0]
    moved = list(small[2:])
    moved[1] = moved[1] + shift
    assert int((moved[1] - moved[2]).min()) >= 1 << 31
    got = ss.verify_spans(big, small[1], *moved, **kw)
    _assert_equal(got, (want[0], want[1] + shift, want[2] + shift))
    del big


def _hot_searcher(cuda, case):
    """A searcher and a corpus with k_seed 10 (w = 1): 'hot', 40 probes
    sharing a stretch of 20 A and sequences with stretches of hundreds of
    A; 'wide', probes of 300 bp (291 table rows a probe, more than a
    warp's register slots)."""
    rng = np.random.default_rng(7)
    base = rng.choice(BASES, size=1200)
    seqs = []
    for _ in range(6):
        seq = base[:int(rng.integers(300, 1200))].copy()
        m = rng.random(len(seq)) < 0.03
        seq[m] = rng.choice(BASES, size=int(m.sum()))
        seqs.append("".join(seq))
    pl, ps = (300, 150) if case == "wide" else (60, 25)
    if case == "hot":
        seqs = ["".join(rng.choice(BASES, size=30)) + "A" * 300 + s
                + "A" * 200 for s in seqs]
    probes = list(dict.fromkeys(s[i:i + pl] for s in seqs
                                for i in range(0, len(s) - pl + 1, ps)))
    if case == "hot":
        probes += ["".join(rng.choice(BASES, size=20)) + "A" * 20
                   + "".join(rng.choice(BASES, size=20)) for _ in range(40)]
    from catch_tpu_torch.probe import Probe
    searcher = ProbeSearcher([Probe.from_str(x) for x in probes],
                             CoverModel(2, 40), kmer_probe_map_k=10,
                             device=cuda)
    return searcher, seqs


@pytest.mark.parametrize("sorts", ["one key", "two stable"])
@pytest.mark.parametrize("case", ["hot", "wide"])
def test_expand_join_edge_shapes(cuda, case, sorts, monkeypatch):
    """expand_join on the card equals its twin with w = 1 and a hot kj-mer
    (a table run of hundreds of rows, segments of hundreds of positions)
    and with probes of more rows than a warp's register slots; with and
    without the kept index and the folded keep predicate, with runs of
    no hits mixed in, and for one run.  'two stable' orders the runs as
    a join table of 2^29 rows or more does: two stable sorts and no
    keys, the gather reading through the order."""
    if sorts == "two stable":
        monkeypatch.setattr(ss, "_PACKED_ROWS", 1)
    searcher, seqs = _hot_searcher(cuda, case)
    mega, starts, ends, total = ss.corpus_codes(searcher, seqs)
    lo, cnt, pos = ss.join_runs(searcher, mega[:total])
    assert searcher._join_kw[1] == 1
    tb = ss.device_tables(searcher, cuda)
    if case == "hot":
        assert int(cnt.max()) >= 400
    else:
        assert tb["index"]["width"] > 256
    runs = [torch.from_numpy(x).to(cuda) for x in (lo, cnt, pos)]
    want = ss._expand_join_plain(*runs, tb["join_p"], tb["join_pos"],
                                 searcher.Lmax)
    assert want[0].numel() > 100
    keep = ss.keep_args(searcher, torch.from_numpy(starts).to(cuda),
                        torch.from_numpy(ends).to(cuda))
    want_kept = ss._keep_plain(*want, **keep)
    assert 0 < want_kept[0].numel()
    for index in (None, tb["index"]):
        _assert_equal(ss.expand_join(*runs, tb["join_p"], tb["join_pos"],
                                     searcher.Lmax, index), want)
        _assert_equal(ss.expand_join(*runs, tb["join_p"], tb["join_pos"],
                                     searcher.Lmax, index, keep), want_kept)
    rng = np.random.default_rng(1)
    at = np.sort(rng.integers(0, len(lo), size=50))
    empty = [np.insert(lo, at, lo[at]), np.insert(cnt, at, 0),
             np.insert(pos, at, rng.integers(0, total, size=50))]
    runs0 = [torch.from_numpy(x).to(cuda) for x in empty]
    _assert_equal(ss.expand_join(*runs0, tb["join_p"], tb["join_pos"],
                                 searcher.Lmax, tb["index"]), want)
    i = int(np.argmax(cnt))
    one = [x[i:i + 1].contiguous() for x in runs]
    _assert_equal(ss.expand_join(*one, tb["join_p"], tb["join_pos"],
                                 searcher.Lmax, tb["index"]),
                  ss._expand_join_plain(*one, tb["join_p"], tb["join_pos"],
                                        searcher.Lmax))


def test_identify_design_on_cuda_equals_cpu(cuda):
    """Identification ranks over two groupings, on the card and on the
    CPU, give one probe set."""
    from catch_tpu_torch.designer import ProbeDesigner
    from catch_tpu_torch.filters.duplicate import DuplicateFilter
    from catch_tpu_torch.filters.set_cover_filter import SetCoverFilter
    from catch_tpu_torch.genome import Genome

    groups = [[Genome.from_one_seq(g[0]) for g in _genomes(s, 1, False)]
              for s in (5, 6)]
    out = {}
    for dev in ("cpu", "cuda"):
        scf = SetCoverFilter(2, 60, identify=True, coverage=0.3,
                             cover_extension=10, device=dev)
        d = ProbeDesigner(groups, [DuplicateFilter(), scf],
                          probe_length=80, probe_stride=40)
        d.design()
        out[dev] = [p.seq_str for p in d.final_probes]
    assert out["cuda"] == out["cpu"] and out["cpu"]


def _signatures(seed, n, N, hi):
    """n ascending int32 signature rows of width N drawn from [0, hi): a
    small hi puts duplicates inside rows and ties between pairs."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.sort(rng.integers(0, hi, size=(n, N)),
                                    axis=1).astype(np.int32))


@pytest.mark.parametrize("N,hi", [(1, 3), (40, 60), (100, 150),
                                  (100, 2**31 - 1), (300, 400),
                                  (1000, 1500)],
                         ids=["N1", "N40", "N100", "N100_wide", "N300",
                              "N1000_smem_opt_in"])
def test_minhash_caps_equal_twins(cuda, N, hi):
    from catch_tpu_torch.ops import minhash as mh

    qs_c, rs_c = _signatures(1, 37, N, hi), _signatures(2, 29, N, hi)
    qs, rs = qs_c.to(cuda), rs_c.to(cuda)
    thr, early = max(1, N // 3), max(1, N // 2)
    for kernel, twin, args in (
            (mh.minhash_dists, mh._minhash_dists_plain, ()),
            (mh.minhash_codes, mh._minhash_codes_plain, (thr, early)),
            (mh.minhash_caps, mh._minhash_caps_plain, ())):
        got = kernel(qs, rs, *args)
        torch.cuda.synchronize()
        want = twin(qs, rs, *args)
        assert got.dtype == want.dtype
        assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
        assert torch.equal(got.cpu(), twin(qs_c, rs_c, *args))
    for n_reps in (0, 1, 17, 29):
        got = mh.minhash_assign(qs, rs, n_reps, thr)
        torch.cuda.synchronize()
        _assert_equal(got, mh._minhash_assign_plain(qs, rs, n_reps, thr))
    # a query against copies of itself: every representative ties
    same = qs[:1].repeat(20, 1)
    best, ok = mh.minhash_assign(qs[:5], same, 20, thr)
    _assert_equal((best, ok), mh._minhash_assign_plain(qs[:5], same, 20,
                                                       thr))


def test_minhash_caps_raise_on_unsorted_rows(cuda):
    from catch_tpu_torch.ops import minhash as mh

    sigs = _signatures(3, 8, 40, 1000).to(cuda)
    bad = sigs.clone()
    bad[5] = torch.flip(bad[5], [0])
    for fn, args in ((mh.minhash_dists, ()), (mh.minhash_codes, (3, 5)),
                     (mh.minhash_caps, ()), (mh.minhash_assign, (8, 3))):
        with pytest.raises(ValueError, match="not ascending"):
            fn(sigs, bad, *args)
        with pytest.raises(ValueError, match="not ascending"):
            fn(bad, sigs, *args)


def test_minhash_sig_equals_twin(cuda):
    from catch_tpu_torch.ops import minhash as mh

    rng = np.random.default_rng(4)
    p = mh.MERSENNE_P
    codes = np.concatenate([rng.integers(0, p, size=(700, 91)),
                            rng.integers(p - 1000, p, size=(300, 91))])
    ab = np.stack([np.concatenate([rng.integers(1, p + 1, size=60),
                                   rng.integers(p - 100, p + 1, size=15)]),
                   rng.integers(0, p + 1, size=75)], 1)
    codes = torch.from_numpy(codes.astype(np.int32))
    ab = torch.from_numpy(ab.astype(np.int32))
    got = mh.minhash_sig(codes.to(cuda), ab.to(cuda))
    torch.cuda.synchronize()
    want = mh._minhash_sig_plain(codes.to(cuda), ab.to(cuda))
    _assert_equal((got,), (want,))
    assert torch.equal(got.cpu(), mh._minhash_sig_plain(codes, ab))


def _runs(seed, n, N):
    """n ascending int32 rows of width N made of a few values in long
    runs (duplicates inside rows, ties between pairs)."""
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, max(2, N // 8), size=(n, max(1, N // 16)))
    rows = np.take_along_axis(vals, rng.integers(0, vals.shape[1],
                                                 size=(n, N)), 1)
    return torch.from_numpy(np.sort(rows, axis=1).astype(np.int32))


@pytest.mark.parametrize("N", [1, 255, 256, 1536])
@pytest.mark.parametrize("kind", ["wide", "runs"])
@pytest.mark.parametrize("Q,R", [(1, 70), (37, 33), (65, 100), (130, 1)],
                         ids=["Q1", "Q37_R33", "Q65_R100", "Q130_R1"])
def test_minhash_walk_tiles_equal_twins(cuda, N, kind, Q, R):
    """K7's walk where the queries and representatives fill no whole
    tile or group of 32, one query, long runs of duplicates, N up to
    _MAX_N: the four entry points equal their twins exactly, a
    representative set of more than one group with a tie across groups
    included."""
    from catch_tpu_torch.ops import minhash as mh

    if kind == "wide":
        qs, rs = _signatures(5, Q, N, 2**31 - 1), _signatures(6, R, N,
                                                              2**31 - 1)
    else:
        qs, rs = _runs(5, Q, N), _runs(6, R, N)
    if R > 64:
        # the first query's row in a lane of three groups: the first wins
        rs[3] = rs[40] = rs[R - 1] = qs[0]
    qs, rs = qs.to(cuda), rs.to(cuda)
    thr, early = max(1, N // 3), max(1, N // 2)
    for kernel, twin, args in (
            (mh.minhash_dists, mh._minhash_dists_plain, ()),
            (mh.minhash_codes, mh._minhash_codes_plain, (thr, early)),
            (mh.minhash_caps, mh._minhash_caps_plain, ())):
        got = kernel(qs, rs, *args)
        torch.cuda.synchronize()
        want = twin(qs, rs, *args)
        assert got.dtype == want.dtype
        assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
    for n_reps in sorted({0, 1, min(R, 32), min(R, 33), R}):
        got = mh.minhash_assign(qs, rs, n_reps, thr)
        torch.cuda.synchronize()
        _assert_equal(got, mh._minhash_assign_plain(qs, rs, n_reps, thr))
        if R > 64 and n_reps == R:
            # the first query's row is in lanes 3, 40 and R - 1: the best
            # of the first query is one of them or an earlier equal row
            assert int(got[0][0]) <= 3 and bool(got[1][0])


def test_minhash_walk_raises_past_n_reps_and_not_at_n1(cuda):
    """The one order pass checks every row it is given: an unsorted
    representative row past n_reps raises; one column has no order."""
    from catch_tpu_torch.ops import minhash as mh

    sigs = _signatures(7, 40, 64, 10**6).to(cuda)
    bad = sigs.clone()
    bad[39] = torch.flip(bad[39], [0])
    with pytest.raises(ValueError, match="rs holds a row that is not"):
        mh.minhash_assign(sigs, bad, 5, 3)
    with pytest.raises(ValueError, match="qs holds a row that is not"):
        mh.minhash_assign(bad, bad, 5, 3)
    one = torch.tensor([[5], [3], [5]], dtype=torch.int32, device=cuda)
    _assert_equal((mh.minhash_caps(one, one),),
                  (mh._minhash_caps_plain(one, one),))


@pytest.mark.parametrize("case", ["edges", "n1_h7", "h_not_x4", "many_h",
                                  "long_rows"])
def test_minhash_sig_fold_cases_equal_twin(cuda, case):
    """K8 with a = p, b = p, codes 0 and p - 1, one code a row, H not a
    multiple of the hash functions a thread takes, more hash functions
    than a block's threads, and rows longer than a staged chunk."""
    from catch_tpu_torch.ops import minhash as mh

    rng = np.random.default_rng(9)
    p = mh.MERSENNE_P
    U, n, H = {"edges": (40, 91, 16), "n1_h7": (33, 1, 7),
               "h_not_x4": (300, 91, 75), "many_h": (9, 30, 1030),
               "long_rows": (7, 700, 6)}[case]
    codes = rng.integers(0, p, size=(U, n))
    ab = np.stack([rng.integers(1, p + 1, size=H),
                   rng.integers(0, p + 1, size=H)], 1)
    if case == "edges":
        codes[0], codes[1] = 0, p - 1
        codes[2, ::2] = 0
        codes[3, ::3] = p - 1
        ab[:4] = [[p, p], [p, 0], [1, p], [p, p - 1]]
        ab[4:8, 1] = p
    codes = torch.from_numpy(codes.astype(np.int32)).to(cuda)
    ab = torch.from_numpy(ab.astype(np.int32)).to(cuda)
    got = mh.minhash_sig(codes, ab)
    torch.cuda.synchronize()
    _assert_equal((got,), (mh._minhash_sig_plain(codes, ab),))
    if case == "edges":
        assert not got[:, 0].any()


# ----------------------------------------------------------------------
# The device set-cover solver: K10 assemble, K11 init_covered,
# K12 greedy_v2, K13 greedy_v1
# ----------------------------------------------------------------------

def _cover_instance(case):
    """A host instance from the port's build_instance_from_cover_arrays:
    sets 45-59 hold no interval, some spans are empty (start == end),
    costs 1, 2 and 10 and two rank tiers; 'ties' makes every first ratio
    equal (sets of 3 positions at cost 1 and one of 30 at cost 10), and
    'nothing' has can_uncover >= u_size everywhere (p = 0)."""
    from catch_tpu_torch.ops import set_cover as sct

    if case == "ties":
        sid = np.concatenate([np.arange(10), [10], [11]])
        st = np.concatenate([3 * np.arange(10), [30], [60]])
        en = np.concatenate([3 * np.arange(10) + 3, [60], [64]])
        ranks = np.ones(12, dtype=np.int64)
        ranks[11] = 2
        costs = np.ones(12, dtype=np.float32)
        costs[10] = 10
        return sct.build_instance_from_cover_arrays(
            sid, np.zeros(12), st, en, 12, 1, np.ones(1), ranks=ranks,
            costs=costs)
    rng = np.random.default_rng(7)
    n_sets, nU, n = 60, 5, 400
    sid = rng.integers(0, 45, size=n)
    st = rng.integers(0, 3000, size=n)
    en = st + rng.integers(0, 300, size=n)
    en[::9] = st[::9]
    p = np.zeros(nU) if case == "nothing" else np.array(
        [1.0, 0.8, 0.5, 1.0, 0.95])
    return sct.build_instance_from_cover_arrays(
        sid, rng.integers(0, nU, size=n), st, en, n_sets, nU, p,
        ranks=rng.integers(1, 3, size=n_sets),
        costs=rng.choice([1.0, 2.0, 10.0], size=n_sets))


def _merged_rows(inst, dev):
    """The instance's intervals as the scan's merged rows on dev."""
    nU = inst.n_universes
    univ = inst.univ_of_pair[inst.pair_of_ivl].astype(np.int64)
    key = inst.set_of_pair[inst.pair_of_ivl].astype(np.int64) * nU + univ
    off = inst.pos_univ_offsets
    return [torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in (
        key, inst.ivl_start - off[univ], inst.ivl_end - off[univ], off)]


def _state_tuple(state, chosens, picks):
    keys = ("covered", "len_u", "in_cover", "cur_rank", "stop", "order",
            "n_chosen")
    return tuple(state[k] for k in keys if k in state) + (chosens, picks)


@pytest.mark.parametrize("case", ["random", "ties", "no_rows"])
def test_assemble_equals_twin(cuda, case):
    from catch_tpu_torch.ops import set_cover as sct

    inst = _cover_instance("random" if case == "no_rows" else case)
    rows = _merged_rows(inst, cuda)
    if case == "no_rows":
        rows = [x[:0] for x in rows[:3]] + rows[3:]
    got = si.assemble(*rows, inst.n_sets)
    torch.cuda.synchronize()
    want = si._assemble_plain(*rows, inst.n_sets)
    _assert_equal(got[:5], want[:5])
    assert got[5:] == want[5:]
    if case == "random":
        assert got[5] > 1 and got[6] > got[5]
        dev = sct.assembled_instance(inst, cuda)
        assert dev["max_ivls_per_set"] == got[6]
        assert torch.equal(dev["set_bounds"].cpu(), torch.from_numpy(
            np.searchsorted(inst.set_of_pair, np.arange(inst.n_sets + 1))
            .astype(np.int32)))


def _tile_rows(n, seed, gaps, dev):
    """n merged rows sorted by key (pairs of 1-4 rows, 7 universes), in
    sets that skip ids where gaps is set (none at the start, runs in the
    middle, several after the last); returns the rows on dev and S."""
    rng = np.random.default_rng(seed)
    nU = 7
    per_pair = rng.integers(1, 5, size=n)
    pairs = np.repeat(np.arange(n), per_pair)[:n]
    n_pairs = int(pairs[-1]) + 1 if n else 0
    step = rng.integers(1, 3, size=max(n_pairs, 1))
    if gaps:
        step[::37] += rng.integers(1, 30, size=len(step[::37]))
    pkey = np.cumsum(step)[:n_pairs] + (11 * nU if gaps else 0)
    key = pkey[pairs] if n else np.zeros(0, dtype=np.int64)
    start = rng.integers(0, 1000, size=n)
    end = start + rng.integers(0, 50, size=n)
    offsets = np.arange(nU + 1, dtype=np.int64) * 1100
    S = int(key[-1] // nU) + 1 + (9 if gaps else 0) if n else 3
    rows = [torch.from_numpy(x.astype(np.int64)).to(dev)
            for x in (key, start, end, offsets)]
    return rows, S


@pytest.mark.parametrize("n,gaps,shift", [
    (1, False, 0), (2047, False, 0), (2048, False, 0), (2049, True, 0),
    (5 * 2048 + 17, True, 0), (300001, True, 0), (300001, False, 1),
    (4097, True, 1)])
def test_assemble_tile_edges_equal_twin(cuda, n, gaps, shift):
    """K10 at its tiles' edges (2048 rows a tile), over many tiles, with
    sets holding no pair before, between and after the others, and on
    rows that are not 16-byte aligned (shift: a view one row in)."""
    rows, S = _tile_rows(n + shift, n, gaps, cuda)
    rows = [x[shift:] for x in rows[:3]] + rows[3:]
    got = si.assemble(*rows, S)
    torch.cuda.synchronize()
    want = si._assemble_plain(*rows, S)
    _assert_equal(got[:5], want[:5])
    assert got[5:] == want[5:]
    if gaps:
        sb = want[3].cpu()
        assert (sb[:11] == 0).all() and (sb[-9:] == want[4].numel()).all()
        assert (torch.diff(sb[11:-9]) == 0).any()


def test_assemble_reads_the_host_once(cuda):
    """One synchronising call a K10 call: the read of (P, max pairs, max
    intervals)."""
    import warnings

    rows, S = _tile_rows(50000, 3, True, cuda)
    si.assemble(*rows, S)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            si.assemble(*rows, S)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught if "called a synchronizing" in str(w.message)]
    assert len(syncs) == 1, [str(w.message) for w in caught]


@pytest.mark.parametrize("U", [1, 4095, 4096, 4097, 3 * 4096 + 5,
                               (1 << 20) + 3])
def test_init_covered_equals_twin(cuda, U):
    """Every tile boundary of the scan, empty intervals, intervals ending
    at the axis' end, no intervals at all, and intervals that are not
    16-byte aligned."""
    from catch_tpu_torch.ops import set_cover as sct

    rng = np.random.default_rng(U)
    M = max(1, U // 40)
    s = rng.integers(0, U, size=M)
    e = np.minimum(U, s + rng.integers(0, 90, size=M))
    e[::4] = s[::4]
    s[0], e[0] = max(0, U - 3), U
    st, et = (torch.from_numpy(x.astype(np.int32)).to(cuda) for x in (s, e))
    got = sct.init_covered(st, et, U)
    torch.cuda.synchronize()
    _assert_equal([got], [sct._init_covered_plain(st, et, U)])
    none = sct.init_covered(st[:0], et[:0], U)
    assert bool(none.all())
    _assert_equal([sct.init_covered(st[1:], et[1:], U)],
                  [sct._init_covered_plain(st[1:], et[1:], U)])


@pytest.mark.parametrize("U", [4095, 4096, 4097, 33 * 4096 + 16])
def test_init_covered_deep_overlap_equals_twin(cuda, U):
    """10^5 intervals over one position, nested and equal ones around
    it, and a run of touching intervals across tile edges."""
    from catch_tpu_torch.ops import set_cover as sct

    rng = np.random.default_rng(U + 1)
    at = U // 2
    s = np.concatenate([np.full(100000, at), at - rng.integers(0, 50, 500),
                        np.arange(0, U - 7, 7)[::3]])
    e = np.concatenate([at + 1 + rng.integers(0, 3, 100000),
                        at + rng.integers(1, 50, 500),
                        np.arange(7, U, 7)[::3]])
    perm = rng.permutation(len(s))
    st, et = (torch.from_numpy(x[perm].astype(np.int32)).to(cuda)
              for x in (s, np.minimum(e, U)))
    got = sct.init_covered(st, et, U)
    torch.cuda.synchronize()
    want = sct._init_covered_plain(st, et, U)
    _assert_equal([got], [want])
    assert not bool(want[at]) and bool(want.any())


def test_init_covered_reads_no_host(cuda):
    """K11 makes no synchronising call."""
    from catch_tpu_torch.ops import set_cover as sct

    U = 100000
    rng = np.random.default_rng(4)
    s = rng.integers(0, U, size=5000)
    st = torch.from_numpy(s.astype(np.int32)).to(cuda)
    et = torch.from_numpy(np.minimum(U, s + 40).astype(np.int32)).to(cuda)
    sct.init_covered(st, et, U)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = sct.init_covered(st, et, U)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _assert_equal([got], [sct._init_covered_plain(st, et, U)])


def _v2_setup(case, dev):
    from catch_tpu_torch.ops import set_cover as sct

    inst = _cover_instance(case)
    d = sct.assembled_instance(inst, dev)
    covered = sct.init_covered(d["ivl_start"], d["ivl_end"], d["u_len"])
    return inst, d, sct.initial_state(covered, d["u_size"], inst.n_sets)


def _clone(state):
    return {k: v.clone() for k, v in state.items()}


@pytest.mark.parametrize("case", ["random", "ties", "nothing"])
def test_greedy_v2_equals_twin(cuda, case):
    """One 64-step dispatch on the card against the twin, state included
    (the stop latches mid-dispatch, after a rank advance in 'ties'); then
    64 single-step dispatches give the same state."""
    from catch_tpu_torch.ops import set_cover as sct

    inst, d, state0 = _v2_setup(case, cuda)
    got = sct.greedy_steps_v2(_clone(state0), d, 64)
    torch.cuda.synchronize()
    want = sct._greedy_steps_v2_plain(_clone(state0), d, 64)
    _assert_equal(_state_tuple(*got), _state_tuple(*want))
    state, chosens, picks = got
    assert bool(state["stop"])
    if case == "nothing":
        assert not picks.any()
    else:
        assert 0 < int(picks.sum()) < 64
    if case == "ties":                        # 11 ties, a rank advance
        assert chosens[:13].tolist() == list(range(11)) + [0, 11]
        assert picks[:13].tolist() == [True] * 11 + [False, True]
        assert int(state["cur_rank"]) == 1
    single = _clone(state0)
    for t in range(64):
        single, ch, pk = sct.greedy_steps_v2(single, d, 1)
        assert ch.item() == chosens[t].item() and pk.item() == picks[t].item()
    _assert_equal(_state_tuple(single, chosens, picks),
                  _state_tuple(*got))


# K12's shapes past the random cases: a set of more pairs than a warp
# and than a block, sets with no pairs, intervals across many tiles of
# the overlap index (256 positions), position axes at the scan's tile
# edges (4,096), a stop that latches mid-dispatch after a rank advance,
# and the solver instance's 4 intervals a set.
V2_SHAPES = ["wide", "empty_sets", "long", "U1", "U4095", "U4096", "U4097",
             "stop", "solver_like"]


def _v2_shape(name):
    """A port SetCoverInstance of K12 shape `name` (V2_SHAPES)."""
    from catch_tpu_torch.ops import set_cover as sct

    rng = np.random.default_rng(V2_SHAPES.index(name))
    ranks = costs = None
    if name == "wide":
        nU, n_sets = 300, 24
        sid = np.concatenate([np.zeros(nU, int), np.ones(40, int),
                              rng.integers(2, n_sets, size=600)])
        uid = np.concatenate([np.arange(nU), rng.choice(nU, 40, False),
                              rng.integers(0, nU, size=600)])
        st = rng.integers(0, 50, size=len(sid))
        en = st + rng.integers(1, 30, size=len(sid))
        p = rng.choice([0.6, 1.0], size=nU)
    elif name == "empty_sets":
        nU, n_sets = 3, 50
        sid = rng.choice([3, 17, 18, 40, 49], size=60)
        uid = rng.integers(0, nU, size=60)
        st = rng.integers(0, 900, size=60)
        en = st + rng.integers(0, 200, size=60)
        p = np.ones(nU)
    elif name == "long":
        nU, n_sets = 2, 30
        sid = rng.integers(0, n_sets, size=200)
        uid = rng.integers(0, nU, size=200)
        st = rng.integers(0, 5000, size=200)
        en = st + rng.integers(1, 700, size=200)
        sid[:3], uid[:3] = [5, 6, 7], [0, 0, 1]
        st[:3], en[:3] = [3, 250, 0], [5003, 260, 5700]
        p = np.array([1.0, 0.9])
        costs = np.where(np.isin(np.arange(n_sets), [5, 7]), 40.0, 1.0)
    elif name.startswith("U"):
        U = int(name[1:])
        nU, n_sets = (1, 3) if U == 1 else (2, 40)
        n = 3 if U == 1 else 300
        sid = np.arange(n) % n_sets
        uid = np.arange(n) % nU               # universe u ends at span[u]
        span = [U] if U == 1 else [U // 3, U - U // 3]
        lim = np.array(span)[uid]
        st = rng.integers(0, lim)
        en = np.minimum(lim, st + rng.integers(0, 600, size=n))
        st[:nU], en[:nU] = lim[:nU] - 5 if U > 1 else 0, lim[:nU]
        p = np.ones(nU)
    elif name == "stop":
        nU, n_sets = 3, 14
        sid = rng.integers(0, n_sets, size=40)
        uid = rng.integers(0, nU, size=40)
        st = rng.integers(0, 300, size=40)
        en = st + rng.integers(1, 100, size=40)
        p = np.array([0.5, 0.8, 0.9])
        ranks = np.where(np.arange(n_sets) < 10, 1, 2)
        costs = rng.choice([1.0, 2.0], size=n_sets)
    else:                                     # solver_like
        nU, n_sets, ulen = 16, 3000, 2048
        sid = np.repeat(np.arange(n_sets), 4)
        uid = rng.integers(0, nU, size=4 * n_sets)
        st = rng.integers(0, ulen - 400, size=4 * n_sets)
        en = st + rng.integers(150, 400, size=4 * n_sets)
        p = np.ones(nU)
    return sct.build_instance_from_cover_arrays(
        sid, uid, st, en, n_sets, nU, p, ranks=ranks, costs=costs)


@pytest.mark.parametrize("name", V2_SHAPES)
def test_greedy_v2_shapes_equal_twin(cuda, name):
    """K12 against its twin on one 64-step dispatch, state included; 64
    single-step dispatches give the same steps and state; the whole
    solve gives the host lazy solver's picks."""
    from catch_tpu_torch.ops import set_cover as sct

    inst = _v2_shape(name)
    d = sct.assembled_instance(inst, cuda)
    covered = sct.init_covered(d["ivl_start"], d["ivl_end"], d["u_len"])
    state0 = sct.initial_state(covered, d["u_size"], inst.n_sets)
    got = sct.greedy_steps_v2(_clone(state0), d, 64)
    torch.cuda.synchronize()
    want = sct._greedy_steps_v2_plain(_clone(state0), d, 64)
    _assert_equal(_state_tuple(*got), _state_tuple(*want))
    state, chosens, picks = got
    assert picks.any()
    idx = d["_k12_index"]
    if name == "wide":
        assert d["max_pairs_per_set"] > 256
    elif name == "empty_sets":
        assert (torch.diff(d["set_bounds"]) == 0).sum() > 40
    elif name == "long":
        assert idx["max_pieces"] > 20
    elif name.startswith("U"):
        assert d["u_len"] == int(name[1:])
    elif name == "stop":                      # latched, steps after it
        assert bool(state["stop"]) and not picks[-10:].any()
        assert int(state["cur_rank"]) > 0
    single = _clone(state0)
    for t in range(64):
        single, ch, pk = sct.greedy_steps_v2(single, d, 1)
        assert ch.item() == chosens[t].item() and pk.item() == picks[t].item()
    _assert_equal(_state_tuple(single, chosens, picks), _state_tuple(*got))
    assert np.array_equal(sct.solve_boundary_instance(d, inst.n_sets),
                          sct.solve_instance(inst))


@pytest.mark.parametrize("name", ["random"] + V2_SHAPES)
def test_overlap_index_equals_twin(cuda, name):
    """The card's overlap index (count and fill kernels) against the
    twin's stable sort: every array equal, each tile's intervals equal
    as sets (the card's order is its atomics')."""
    from catch_tpu_torch.ops import set_cover as sct

    inst = _cover_instance(name) if name == "random" else _v2_shape(name)
    d = sct.assembled_instance(inst, cuda)
    args = [d[k] for k in ("ivl_start", "ivl_end", "pair_bounds",
                           "set_bounds", "univ_of_pair")]
    got = sct.overlap_index(*args, d["u_len"])
    torch.cuda.synchronize()
    want = sct.overlap_index(*[x.cpu() for x in args], d["u_len"])
    for k in ("ivl_rec", "pair_of_ivl", "piece_off", "tile_ptr"):
        assert torch.equal(got[k].cpu(), want[k]), k
    for k in ("max_pieces", "max_pairs"):
        assert got[k] == want[k], k
    ptr = want["tile_ptr"]
    tile = torch.repeat_interleave(torch.arange(ptr.numel() - 1),
                                   torch.diff(ptr)).long()
    M = args[0].numel()
    assert torch.equal(torch.sort(tile * M + got["tile_ivl"].cpu()).values,
                       tile * M + want["tile_ivl"])


def test_greedy_v2_keeps_its_index(cuda):
    """The overlap index is built once per instance and again only when
    the instance's intervals are replaced."""
    from catch_tpu_torch.ops import set_cover as sct

    inst, d, state0 = _v2_setup("random", cuda)
    sct.greedy_steps_v2(_clone(state0), d, 4)
    idx = d["_k12_index"]
    sct.greedy_steps_v2(_clone(state0), d, 4)
    assert d["_k12_index"] is idx
    d["ivl_start"] = d["ivl_start"].clone()
    got = sct.greedy_steps_v2(_clone(state0), d, 64)
    assert d["_k12_index"] is not idx
    want = sct._greedy_steps_v2_plain(_clone(state0), d, 64)
    _assert_equal(_state_tuple(*got), _state_tuple(*want))


def shuffled_instance(inst, seed):
    """The instance (of either package's class) with its pair ids
    permuted and its intervals in a random order."""
    rng = np.random.default_rng(seed)
    P, M = len(inst.set_of_pair), len(inst.ivl_start)
    new_of_old = rng.permutation(P)
    old_of_new = np.argsort(new_of_old)
    ivl = rng.permutation(M)
    fields = dict(inst.__dict__)
    fields.update(
        ivl_start=inst.ivl_start[ivl], ivl_end=inst.ivl_end[ivl],
        pair_of_ivl=new_of_old[inst.pair_of_ivl[ivl]].astype(np.int32),
        set_of_pair=inst.set_of_pair[old_of_new],
        univ_of_pair=inst.univ_of_pair[old_of_new])
    return type(inst)(**fields)


def overlapping_instance(seed):
    """A port SetCoverInstance that no build_instance* makes: the
    intervals of a pair overlap, a set holds several pairs of one
    universe, pairs and intervals are in random order, a set holds no
    pair, and some intervals are empty.  Universe u owns positions
    [200u, 200u + 200); u_size counts the positions any interval holds,
    as build_instance does; two rank tiers and partial coverage."""
    from catch_tpu_torch.ops import set_cover as sct

    rng = np.random.default_rng(seed)
    S, nU, P, M = 18, 3, 40, 150
    set_of_pair = rng.integers(0, S - 1, size=P).astype(np.int32)
    univ_of_pair = rng.integers(0, nU, size=P).astype(np.int32)
    pair_of_ivl = rng.integers(0, P, size=M).astype(np.int32)
    base = 200 * univ_of_pair[pair_of_ivl].astype(np.int64)
    start = base + rng.integers(0, 190, size=M)
    end = np.minimum(base + 200, start + rng.integers(0, 70, size=M))
    end[::11] = start[::11]
    held = np.zeros(200 * nU, dtype=bool)
    for a, b in zip(start, end):
        held[a:b] = True
    u_size = held.reshape(nU, 200).sum(axis=1).astype(np.int64)
    p = np.array([1.0, 0.8, 0.6])
    return sct.SetCoverInstance(
        n_sets=S, n_universes=nU, u_size=u_size,
        can_uncover=np.floor(u_size - p * u_size).astype(np.int64),
        ivl_start=start, ivl_end=end, pair_of_ivl=pair_of_ivl,
        set_of_pair=set_of_pair, univ_of_pair=univ_of_pair,
        cost=rng.choice([1.0, 2.0, 10.0], size=S).astype(np.float32),
        rank_idx=(np.arange(S) % 5 == 4).astype(np.int32), n_rank_vals=2,
        u_len=200 * nU, pos_univ_offsets=200 * np.arange(nU + 1))


# greedy_v1's cases past _cover_instance's: its random instance
# shuffled, and two overlapping ones
V1_CASES = ["random", "ties", "nothing", "shuffled", "overlap1", "overlap2"]


def _v1_instance(case):
    if case == "shuffled":
        return shuffled_instance(_cover_instance("random"), 3)
    if case.startswith("overlap"):
        return overlapping_instance(int(case[-1]))
    return _cover_instance(case)


def _v1_setup(inst, dev, keep_order):
    from catch_tpu_torch.ops import set_cover as sct

    consts, u_size = sct._instance_consts(inst, dev)
    covered = sct.init_covered(consts["ivl_start"], consts["ivl_end"],
                               inst.u_len)
    return consts, sct.initial_state(covered, u_size, inst.n_sets,
                                     keep_order)


@pytest.mark.parametrize("case", V1_CASES)
@pytest.mark.parametrize("keep_order", [False, True])
def test_greedy_v1_equals_twin(cuda, case, keep_order):
    """One 64-step dispatch on the card against the twin, state included
    (the stop latches mid-dispatch); then 64 single-step dispatches give
    the same steps and state."""
    from catch_tpu_torch.ops import set_cover as sct

    inst = _v1_instance(case)
    consts, state0 = _v1_setup(inst, cuda, keep_order)
    got = sct.greedy_steps_v1(_clone(state0), consts, 64)
    torch.cuda.synchronize()
    want = sct._greedy_steps_v1_plain(_clone(state0), consts, 64)
    _assert_equal(_state_tuple(*got), _state_tuple(*want))
    state, chosens, picks = got
    assert bool(state["stop"])
    assert picks.any() == (case != "nothing")
    single = _clone(state0)
    for t in range(64):
        single, ch, pk = sct.greedy_steps_v1(single, consts, 1)
        assert ch.item() == chosens[t].item() and pk.item() == picks[t].item()
    _assert_equal(_state_tuple(single, chosens, picks), _state_tuple(*got))


@pytest.mark.parametrize("name", V2_SHAPES)
def test_greedy_v1_shapes_equal_twin(cuda, name):
    """greedy_v1 on K12's shapes (segment ids, the order kept on the
    card): two 64-step dispatches against the twin, state included; the
    step solver and the device-resident loop give the host lazy
    solver's picks."""
    from catch_tpu_torch.ops import set_cover as sct

    inst = _v2_shape(name)
    consts, state0 = _v1_setup(inst, cuda, True)
    got, want = _clone(state0), _clone(state0)
    for _ in range(2):
        g = sct.greedy_steps_v1(got, consts, 64)
        torch.cuda.synchronize()
        w = sct._greedy_steps_v1_plain(want, consts, 64)
        _assert_equal(_state_tuple(*g), _state_tuple(*w))
    assert int(got["n_chosen"]) > 0
    idx = consts["_k13_index"]
    if name == "long":
        assert idx["max_groups"] >= 20
    want = sct.solve_instance(inst)
    assert np.array_equal(sct.solve_instance(inst, force_device=True,
                                             device=cuda), want)
    assert np.array_equal(sct._solve_device(inst, cuda), want)


@pytest.mark.parametrize("name", ["random", "overlap1", "shuffled"])
def test_set_major_index_equals_twin(cuda, name):
    """The regrouping on the card equals the one on the CPU, array for
    array (both are library sorts and searches)."""
    from catch_tpu_torch.ops import set_cover as sct

    inst = _v1_instance(name)
    consts, _ = _v1_setup(inst, cuda, False)
    args = [consts[k] for k in ("ivl_start", "ivl_end", "pair_of_ivl",
                                "set_of_pair", "univ_of_pair")]
    got = sct.set_major_index(*args, inst.n_sets, inst.u_len)
    want = sct.set_major_index(*[x.cpu() for x in args], inst.n_sets,
                               inst.u_len)
    for k, v in want.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(got[k].cpu(), v), k
        else:
            assert got[k] == v, k


def test_greedy_v1_keeps_its_regrouping(cuda):
    """The regrouping is built once per instance and again only when the
    instance's intervals are replaced; after the rebuild the steps still
    equal the twin's."""
    from catch_tpu_torch.ops import set_cover as sct

    inst = _v1_instance("overlap2")
    consts, state0 = _v1_setup(inst, cuda, True)
    sct.greedy_steps_v1(_clone(state0), consts, 4)
    idx = consts["_k13_index"]
    sct.greedy_steps_v1(_clone(state0), consts, 4)
    assert consts["_k13_index"] is idx
    consts["ivl_start"] = consts["ivl_start"].clone()
    got = sct.greedy_steps_v1(_clone(state0), consts, 64)
    assert consts["_k13_index"] is not idx
    want = sct._greedy_steps_v1_plain(_clone(state0), consts, 64)
    _assert_equal(_state_tuple(*got), _state_tuple(*want))


def test_greedy_v1_reads_no_host_and_raises_past_the_limit(cuda,
                                                           monkeypatch):
    """Once the regrouping is kept, a K13 call makes no synchronising
    call; with the piece limit at the instance's count, a new
    regrouping raises before any launch."""
    from catch_tpu_torch.ops import set_cover as sct

    inst = _v1_instance("random")
    consts, state0 = _v1_setup(inst, cuda, True)
    want = sct._greedy_steps_v1_plain(_clone(state0), consts, 64)
    sct.greedy_steps_v1(_clone(state0), consts, 4)
    state = _clone(state0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = sct.greedy_steps_v1(state, consts, 64)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _assert_equal(_state_tuple(*got), _state_tuple(*want))
    monkeypatch.setattr(sct, "_K12_PIECE_LIMIT", sct.k12_piece_count(consts))
    consts["ivl_start"] = consts["ivl_start"].clone()
    n = sct.greedy_steps_v1.launches
    with pytest.raises(ValueError, match="int32"):
        sct.greedy_steps_v1(_clone(state0), consts, 4)
    assert sct.greedy_steps_v1.launches == n


@pytest.mark.parametrize("case", ["random", "ties"])
def test_device_solvers_on_cuda_equal_host(cuda, case):
    """The boundary solver, the step solver and the device-resident loop
    on the card give the host lazy solver's picks."""
    from catch_tpu_torch.ops import set_cover as sct

    inst = _cover_instance(case)
    want = sct.solve_instance(inst)
    assert len(want) > 0
    for got in (sct.solve_boundary_instance(sct.assembled_instance(
                    inst, cuda), inst.n_sets),
                sct.solve_instance(inst, force_device=True, device=cuda),
                sct._solve_device(inst, cuda)):
        assert np.array_equal(got, want)


def test_filter_device_solve_on_cuda(cuda, monkeypatch):
    """CATCH_TPU_SOLVE=device on the card gives the host solver's probe
    set, through stage E and K10-K12."""
    from catch_tpu_torch.filters.set_cover_filter import SetCoverFilter
    from catch_tpu_torch.genome import Genome

    genomes = [Genome.from_one_seq(g[0]) for g in _genomes(4, 1, False)]
    probes = make_candidate_probes_from_sequences(
        [g.seqs[0] for g in genomes], probe_length=80, probe_stride=40)
    want = [p.seq_str for p in SetCoverFilter(
        2, 60, cover_extension=25, device="cuda").filter(
        [list(probes)], [genomes], input_is_grouped=True)[0]]
    monkeypatch.setenv("CATCH_TPU_SOLVE", "device")
    si.reset_launches()
    got = [p.seq_str for p in SetCoverFilter(
        2, 60, cover_extension=25, device="cuda").filter(
        [list(probes)], [genomes], input_is_grouped=True)[0]]
    assert got == want and got
    for name in ("assemble", "init_covered", "greedy_v2"):
        assert si.KERNELS[name].launches > 0, name


# ----------------------------------------------------------------------
# The mesh: virtual places on the one card
# ----------------------------------------------------------------------

@pytest.fixture
def places8(cuda, monkeypatch):
    monkeypatch.setenv("CATCH_TPU_VIRTUAL_DEVICES", "8")
    return cuda


def _sharded_setup(inst, n, dev):
    """(placed partition, initial states) of `inst` on n places of dev."""
    from catch_tpu_torch.ops import set_cover as sct
    from catch_tpu_torch.parallel import make_mesh
    from catch_tpu_torch.parallel import set_cover as psc

    mesh = make_mesh(n, dev)
    part = psc.place_partition(psc.partition_instance(inst, n),
                               inst.can_uncover, mesh)
    consts, u_size = sct._instance_consts(inst, mesh.lead)
    covered = sct.init_covered(consts["ivl_start"], consts["ivl_end"],
                               inst.u_len)
    return part, psc.initial_states(covered, u_size, part)


def _states_equal(got, want):
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        _assert_equal([g[k] for k in g], [w[k] for k in g])
    for g in got[1:]:
        for k in ("covered", "len_u", "order", "n_chosen", "cur_rank",
                  "stop"):
            assert torch.equal(g[k], got[0][k]), k


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("case", ["random", "ties", "nothing"])
def test_greedy_sharded_equals_twin(places8, case, n):
    """One 64-step dispatch on the card against the twin, every place's
    state included and all replicas equal, past the stop; then single
    steps give the same state.  'ties' has 12 sets, so 8 places of 2
    leave two shards empty; its first 11 ratios are equal."""
    from catch_tpu_torch.parallel import set_cover as psc

    inst = _cover_instance(case)
    part, states0 = _sharded_setup(inst, n, places8)
    got = psc.greedy_steps_sharded([_clone(s) for s in states0], part, 64)
    torch.cuda.synchronize()
    want = psc._greedy_steps_sharded_plain([_clone(s) for s in states0],
                                           part, 64)
    _states_equal(got, want)
    assert bool(got[0]["stop"])
    n_chosen = int(got[0]["n_chosen"])
    assert (n_chosen == 0) == (case == "nothing")
    if case == "ties":
        assert got[0]["order"][:11].tolist() == list(range(11))
        assert sum(s["cost"].numel() == 0 for s in part["shards"]) == (
            2 if n == 8 else 0)
    single = [_clone(s) for s in states0]
    for _ in range(64):
        psc.greedy_steps_sharded(single, part, 1)
    _states_equal(single, got)


@pytest.mark.parametrize("n", [2, 8])
def test_greedy_sharded_buffers_per_card_equal_shared(places8, monkeypatch,
                                                      n):
    """The copies between distinct cards (every card its own candidate
    slots and update rows, slot d and row d copied from place d's card
    to the others between the phases), forced here by counting every
    place as a card of its own though all lie on the one card."""
    from catch_tpu_torch.parallel import set_cover as psc

    inst = _cover_instance("random")
    part, states0 = _sharded_setup(inst, n, places8)
    want = psc.greedy_steps_sharded([_clone(s) for s in states0], part, 40)
    assert psc._cards(places8 for _ in range(n)) == [0] * n
    monkeypatch.setattr(psc, "_cards", lambda places: list(range(n)))
    got = psc.greedy_steps_sharded([_clone(s) for s in states0], part, 40)
    torch.cuda.synchronize()
    _states_equal(got, want)


@pytest.mark.parametrize("per_card", [False, True],
                         ids=["shared", "per_card"])
@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("case", ["shuffled", "overlap1", "overlap2",
                                  "ties"])
def test_greedy_sharded_incremental_equals_twin(places8, monkeypatch, case,
                                                n, per_card):
    """K18's incremental step on instances whose pairs and intervals are
    in any order and whose intervals overlap, and with empty shards
    ('ties' and the overlapping ones at 8 places): a 3-step dispatch,
    then a 64-step one from its state (the pair counts recomputed from a
    replica mid-solve), each equal to the twin, every place's state
    included and all replicas equal; with per_card, every place counted
    as a card of its own, so each phase's slot and row are copied."""
    from catch_tpu_torch.parallel import set_cover as psc

    inst = _v1_instance(case)
    part, states0 = _sharded_setup(inst, n, places8)
    if per_card:
        monkeypatch.setattr(psc, "_cards", lambda places: list(range(n)))
    got = [_clone(s) for s in states0]
    want = [_clone(s) for s in states0]
    for n_steps in (3, 64):
        psc.greedy_steps_sharded(got, part, n_steps)
        torch.cuda.synchronize()
        psc._greedy_steps_sharded_plain(want, part, n_steps)
        _states_equal(got, want)
    assert bool(got[0]["stop"]) and int(got[0]["n_chosen"]) > 0
    empty = sum(s["cost"].numel() == 0 for s in part["shards"])
    assert (empty > 0) == (n == 8 and case != "shuffled")
    for shard in part["shards"]:
        assert ("_k18_index" in shard) == (shard["cost"].numel() > 0)


def test_greedy_sharded_launches_a_step(places8):
    """torch.profiler's count of one 64-step dispatch at 4 places on one
    card: the recompute's 4 kernels once, then 4 a step, and one copy of
    the place table (after 256 one-element adds, against the records a
    late capture can lose)."""
    from catch_tpu_torch.parallel import set_cover as psc

    inst = _v1_instance("random")
    part, states0 = _sharded_setup(inst, 4, places8)
    psc.greedy_steps_sharded([_clone(s) for s in states0], part, 1)
    states = [_clone(s) for s in states0]
    w = torch.zeros(1, device=places8)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(256):
            w.add_(1)
        torch.cuda.synchronize()
        psc.greedy_steps_sharded(states, part, 64)
        torch.cuda.synchronize()
    counts = {ev.key: ev.count for ev in prof.key_averages()
              if "at::native" not in ev.key
              and (getattr(ev, "device_time_total", None)
                   or getattr(ev, "cuda_time_total", 0))}
    per_step = sum(c for c in counts.values() if c >= 64)
    assert per_step == 4 * 64, counts
    assert sum(counts.values()) - per_step == 4 + 1, counts


def test_greedy_sharded_piece_limit_route(places8, monkeypatch, caplog):
    """With the piece limit at the largest shard's count, the sharded
    solver takes the host lazy solver with a warning and launches no
    K18 step; greedy_steps_sharded on a new partition raises before any
    launch.  With the limit one above, K18 runs, with the same picks.
    (The host lazy solver takes a set's intervals as build_instance
    groups them, so the instance here is build_instance's.)"""
    from catch_tpu_torch.ops import set_cover as sct
    from catch_tpu_torch.parallel import make_mesh, solve_instance_sharded
    from catch_tpu_torch.parallel import set_cover as psc

    inst = _v1_instance("random")
    want = sct.solve_instance(inst)
    mesh = make_mesh(4, places8)
    part = psc.partition_instance(inst, 4)
    most = max(int(sct._k12_pieces(torch.from_numpy(s["ivl_start"]),
                                   torch.from_numpy(s["ivl_end"])).sum())
               for s in part["shards"])
    for limit, host in ((most, True), (most + 1, False)):
        monkeypatch.setattr(sct, "_K12_PIECE_LIMIT", limit)
        caplog.clear()
        caplog.set_level("WARNING")
        n = psc.greedy_steps_sharded.launches
        assert np.array_equal(solve_instance_sharded(inst, mesh=mesh), want)
        assert ("K18's overlap index exceeds int32" in caplog.text) == host
        assert (psc.greedy_steps_sharded.launches == n) == host
    monkeypatch.setattr(sct, "_K12_PIECE_LIMIT", most)
    placed, states0 = _sharded_setup(inst, 4, places8)
    n = psc.greedy_steps_sharded.launches
    with pytest.raises(ValueError, match="int32"):
        psc.greedy_steps_sharded(states0, placed, 4)
    assert psc.greedy_steps_sharded.launches == n


@pytest.mark.parametrize("case,n", [("random", 1), ("random", 4),
                                    ("random", 8), ("ties", 8),
                                    ("ties", 16), ("nothing", 4)])
def test_sharded_solver_on_cuda_equals_host(cuda, monkeypatch, case, n):
    """solve_instance_sharded and solve_instance(force_device=True,
    mesh=) on the card give the host lazy solver's picks, with a shard
    count above the set count too ('ties' has 12 sets)."""
    from catch_tpu_torch.ops import set_cover as sct
    from catch_tpu_torch.parallel import make_mesh, solve_instance_sharded

    monkeypatch.setenv("CATCH_TPU_VIRTUAL_DEVICES", str(n))
    inst = _cover_instance(case)
    want = sct.solve_instance(inst)
    mesh = make_mesh(n, cuda)
    si.reset_launches()
    assert np.array_equal(solve_instance_sharded(inst, mesh=mesh), want)
    assert np.array_equal(
        sct.solve_instance(inst, force_device=True, mesh=mesh), want)
    if case != "nothing" and n > 1:
        assert si.KERNELS["greedy_sharded"].launches >= 2
        assert si.KERNELS["greedy_v1"].launches == 0


@pytest.mark.parametrize("n", [2, 8])
@pytest.mark.parametrize("keep", [None, 5, 0])
def test_verify_spans_sharded_equals_verify_spans(places8, n, keep):
    """Equal to verify_spans and to the twin, with fewer candidates than
    places and with none; a place with an empty block launches nothing."""
    seqs = _span_corpus(3)
    probes = list(dict.fromkeys(make_candidate_probes_from_sequences(
        seqs[:6], probe_length=60, probe_stride=25)))
    searcher = ProbeSearcher(probes, CoverModel(mismatches=2, lcf_thres=40),
                             device=places8)
    mega, starts, ends, total = ss.corpus_codes(searcher, seqs)
    lo, cnt, pos = (torch.from_numpy(x).to(places8)
                    for x in ss.join_runs(searcher, mega[:total]))
    pa = ss.expand_join(lo, cnt, pos, *ss.join_table(searcher, places8),
                        searcher.Lmax)
    cand = ss.keep_candidates(searcher, *pa,
                              torch.from_numpy(starts).to(places8),
                              torch.from_numpy(ends).to(places8))
    if keep is not None:
        cand = tuple(x[:keep].contiguous() for x in cand)
    mega_t = torch.from_numpy(mega).to(places8)
    codes_t = torch.from_numpy(searcher.probe_codes).to(places8)
    vargs = ss.verify_args(searcher)
    want = ss.verify_spans(mega_t, codes_t, *cand, **vargs)
    si.reset_launches()
    got = ss.verify_spans_sharded(
        [(mega_t.clone(), codes_t.clone()) for _ in range(n)], *cand,
        **vargs)
    torch.cuda.synchronize()
    _assert_equal(got, want)
    _assert_equal(got, ss._verify_spans_plain(mega_t, codes_t, *cand,
                                              **vargs))
    assert (want[0].numel() > 0) == (keep != 0)
    assert ss.verify_spans_sharded.launches == min(n, cand[0].numel())
    assert ss.verify_spans.launches == 0


@pytest.mark.parametrize("tile", [None, 64], ids=["tile_default",
                                                 "tile64"])
@pytest.mark.parametrize("n_pairs,n_probes,span", [(0, 5, 50), (1, 5, 50),
                                                  (200_000, 400, 300),
                                                  (50_000, 3, 2 ** 31 - 1),
                                                  (60_000, 20, 5000)])
def test_dedup_pairs_equals_twin(cuda, n_pairs, n_probes, span, tile):
    """The lead's dedup on the card against its twin and numpy: sorted
    by (probe, alignment), every pair once; an empty input launches
    nothing.  Buckets of up to 1,024 pairs are sorted by a warp, larger
    ones up to the tile by a block in shared memory (60,000 pairs in 20
    buckets), larger still by the radix sort in device memory (the tile
    forced to 64 entries, and 3 buckets of about 16,700)."""
    rng = np.random.default_rng(n_pairs)
    p = rng.integers(0, n_probes, size=n_pairs)
    a = rng.integers(max(0, span - 300), span + 1, size=n_pairs)
    pt, at = torch.from_numpy(p).to(cuda), torch.from_numpy(a).to(cuda)
    si.reset_launches()
    got = (si.dedup_pairs(pt, at) if tile is None
           else si._dedup_pairs_cuda(pt, at, tile))
    torch.cuda.synchronize()
    assert si.dedup_pairs.launches == (1 if n_pairs else 0)
    assert si.lookup_expand.launches == 0
    _assert_equal(got, si._dedup_pairs_plain(pt, at))
    want = np.unique(np.stack([p, a], axis=1), axis=0).reshape(-1, 2)
    assert n_pairs < 50_000 or len(want) < n_pairs
    assert np.array_equal(got[0].cpu().numpy(), want[:, 0])
    assert np.array_equal(got[1].cpu().numpy(), want[:, 1])


@pytest.mark.parametrize("tile", [si.DEDUP_TILE, 64])
def test_dedup_pairs_one_pair_repeated(cuda, tile):
    """One pair a million times: one bucket far above either tile, all
    of it one run."""
    pt = torch.full((1_000_000,), 7, dtype=torch.int64, device=cuda)
    at = torch.full((1_000_000,), 2 ** 31 - 2, dtype=torch.int64,
                    device=cuda)
    got = si._dedup_pairs_cuda(pt, at, tile)
    _assert_equal(got, si._dedup_pairs_plain(pt, at))
    assert got[0].tolist() == [7] and got[1].tolist() == [2 ** 31 - 2]


def test_dedup_pairs_empty_and_out_of_range(cuda):
    e = torch.empty(0, dtype=torch.int64, device=cuda)
    si.reset_launches()
    assert all(x.numel() == 0 for x in si.dedup_pairs(e, e.clone()))
    assert si.dedup_pairs.launches == 0
    one = torch.ones(3, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="2\\^31"):
        si.dedup_pairs(one, one * (2 ** 31))
    with pytest.raises(ValueError, match="power of two"):
        si._dedup_pairs_cuda(one, one, 48)


@pytest.mark.parametrize("n", [2, 4])
def test_design_on_a_cuda_mesh_equals_one_place(cuda, monkeypatch, n):
    """The filter on a mesh of virtual places on the card: the probe set,
    the candidate count and the picks equal the single-place run's on
    both solver routes, and the scan's kernels launch for every
    place."""
    from catch_tpu_torch.filters.set_cover_filter import SetCoverFilter
    from catch_tpu_torch.genome import Genome
    from catch_tpu_torch.parallel import make_mesh

    monkeypatch.setenv("CATCH_TPU_VIRTUAL_DEVICES", str(n))
    genomes = [Genome.from_one_seq(g[0]) for g in _genomes(4, 1, False)]
    probes = make_candidate_probes_from_sequences(
        [g.seqs[0] for g in genomes], probe_length=80, probe_stride=40)

    def run(mesh):
        f = SetCoverFilter(2, 60, cover_extension=25, device=cuda, mesh=mesh)
        out = f.filter([list(probes)], [genomes], input_is_grouped=True)[0]
        return [p.seq_str for p in out], f.last_run_stats

    want, stats1 = run(None)
    for solve in (None, "device"):
        if solve:
            monkeypatch.setenv("CATCH_TPU_SOLVE", solve)
        si.reset_launches()
        got, stats = run(make_mesh(n, cuda))
        assert got == want and got
        assert stats["candidates_evaluated"] == stats1["candidates_evaluated"]
        assert stats["set_cover_picks"] == stats1["set_cover_picks"]
        assert sorted(stats["launches_by_place"]) == list(range(n))
        assert all(v == {"rolling_hash": 1, "lookup_expand": 1,
                         "verify_windows": 1}
                   for v in stats["launches_by_place"].values())
        assert si.lookup_expand.launches == n
        assert si.dedup_pairs.launches == 1


# ----------------------------------------------------------------------
# K3 verify_windows: the mask kernels against the twin
# ----------------------------------------------------------------------

def _k3_inputs(device, L, *, seed=0, n_codes=4, short=False, pad_codes=False,
               n_runs=False, tail_pad=True, mega_shift=0, n_random=1500,
               only_random=False, alternate=False):
    """verify_windows' tensors for a synthetic corpus of probe length L.

    Eight mutated copies of one base sequence, each cut at both ends (by
    up to L codes) and separated by PAD gaps of 0 to L codes (0: two
    sequences touch), make the corpus; pairs of sequences form a genome
    of two chromosomes.  Probes are pieces of the sequences, mutated, a
    quarter of them shorter than L.  The pairs are each probe at its
    homologous alignment in every sequence, shifted by -2 to 3, and
    n_random pairs at random alignments (most positions mismatches),
    sorted by (probe, alignment).  Options: short (every third sequence
    shorter than L), pad_codes (1% of the corpus codes PAD, as bytes the
    probes lack read), n_runs (runs of the last code, an 'N', in the base,
    so probes and corpus share them), tail_pad (False: mega ends at the
    last pair's a + L), mega_shift (mega starts that many bytes into its
    allocation), only_random, alternate (every other code of the probes
    changed, so that windows are short and many).
    """
    rng = np.random.default_rng(seed)
    base = rng.integers(1, n_codes + 1, size=4 * L + 300).astype(np.uint8)
    if n_runs:
        for s0 in rng.integers(0, len(base) - 12, size=8):
            base[s0:s0 + 10] = n_codes
    pieces = []
    for i in range(8):
        seq = base.copy()
        m = rng.random(len(seq)) < 0.03
        seq[m] = rng.integers(1, n_codes + 1, size=int(m.sum()))
        if pad_codes:
            seq[rng.random(len(seq)) < 0.01] = 0
        lo = int(rng.integers(0, L))
        hi = len(seq) - int(rng.integers(0, L))
        if short and i % 3 == 2:
            hi = lo + int(rng.integers(L // 4, L))
        pieces.append((seq[lo:hi], lo))
    gaps = [L + 5] + [int(rng.integers(0, L + 1)) for _ in pieces]
    starts, pos = [], gaps[0]
    for (piece, _), g in zip(pieces, gaps[1:]):
        starts.append(pos)
        pos += len(piece) + g
    m_len = pos + (L if tail_pad else 0)
    mega = np.zeros(m_len, dtype=np.uint8)
    for (piece, _), s0 in zip(pieces, starts):
        mega[s0:s0 + len(piece)] = piece

    rows, lens, homolog = [], [], []
    for _ in range(30):
        i = int(rng.integers(0, 8))
        piece, lo = pieces[i]
        if len(piece) < L:
            continue
        o = int(rng.integers(0, len(piece) - L + 1))
        row = piece[o:o + L].copy()
        m = rng.random(L) < 0.02
        row[m] = rng.integers(1, n_codes + 1, size=int(m.sum()))
        if alternate:
            row[::2] = row[::2] % n_codes + 1
        ln = L if rng.random() < 0.75 else int(rng.integers(L // 2, L))
        row[ln:] = 0
        rows.append(row)
        lens.append(ln)
        homolog.append(lo + o)
    pairs = set()
    if not only_random:
        for p, b in enumerate(homolog):
            for (_, lo), s0 in zip(pieces, starts):
                for d in (-2, 0, 1, 3):
                    a = s0 + b - lo + d
                    if 0 <= a <= m_len - L:
                        pairs.add((p, a))
    for p, a in zip(rng.integers(0, len(rows), size=n_random),
                    rng.integers(0, m_len - L + 1, size=n_random)):
        pairs.add((int(p), int(a)))
    pc, ac = (np.asarray(x, dtype=np.int64) for x in zip(*sorted(pairs)))
    if not tail_pad:
        mega = mega[:int(ac.max()) + L]
    buf = np.zeros(len(mega) + mega_shift, dtype=np.uint8)
    buf[mega_shift:] = mega

    seq_lens = np.array([len(x) for x, _ in pieces], dtype=np.int64)
    univ = np.arange(8, dtype=np.int64) // 2
    chrom_off = np.where(np.arange(8) % 2, np.roll(seq_lens, 1), 0)

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    starts = np.asarray(starts, dtype=np.int64)
    return (put(buf)[mega_shift:], put(np.stack(rows)),
            put(np.asarray(lens, dtype=np.int64)), put(pc), put(ac),
            put(starts), put(starts + seq_lens), put(seq_lens),
            put(chrom_off), put(univ))


def _k3_check(vt, **args):
    """verify_windows on the card equals its twin, with one launch;
    returns the spans."""
    si.reset_launches()
    got = si.verify_windows(*vt, **args)
    torch.cuda.synchronize()
    assert si.verify_windows.launches == 1
    _assert_equal(got, si._verify_windows_plain(*vt, **args))
    return got


def _k3_args(L, K, **kw):
    args = dict(K=K, k_seed=20, lcf=min(60, L), seed_req=20, fast_ok=False,
                ext=30, nU=4)
    args.update(kw)
    return args


def _mismatches(vt):
    """The mismatch count in each pair's band (plain PyTorch)."""
    mega, codes, lens, pc, ac, seq_starts, seq_ends = vt[:7]
    L = codes.shape[1]
    sid = torch.clamp(torch.searchsorted(seq_ends, ac, side="right"), 0,
                      seq_ends.numel() - 1)
    lo = torch.maximum(seq_starts[sid], ac) - ac
    hi = torch.minimum(seq_ends[sid], ac + lens[pc]) - ac
    j = torch.arange(L, device=ac.device)
    vals = mega[ac[:, None] + j]
    band = (j >= lo[:, None]) & (j < hi[:, None])
    return (band & ((vals != codes[pc]) | (vals == 0))).sum(1)


@pytest.mark.parametrize("K", [0, 1, 2, 5, 62])
@pytest.mark.parametrize("L", [75, 100, 150, 250])
def test_verify_windows_probe_lengths_and_k(cuda, L, K):
    """Probe lengths 75 to 250 (rows of codes not 16-byte aligned at 75
    and 100) and K from 0 to 62 (registers up to 7, the shared-memory
    ring above); alignments at every residue mod 16; bands cut at a
    sequence's start and end; random pairs with more than 64
    mismatches."""
    vt = _k3_inputs(cuda, L, seed=L + K)
    ac, lens, pc = vt[4], vt[2], vt[3]
    assert len(set((ac % 16).tolist())) == 16
    sid = torch.clamp(torch.searchsorted(vt[6], ac, side="right"), 0, 7)
    assert bool((vt[5][sid] > ac).any())                 # cut at the start
    assert bool((vt[6][sid] < ac + lens[pc]).any())      # cut at the end
    if L >= 100:
        assert int(_mismatches(vt).max()) > 64
    spans = _k3_check(vt, **_k3_args(L, K))
    assert spans[0].numel() > 0


@pytest.mark.parametrize("case", [
    "no_tail_pad", "no_tail_pad_shifted", "no_window", "most_windows",
    "most_windows_k2", "fast_path", "seed_req_above_k_seed",
    "short_seqs_k0_fast", "short_seqs_windows", "alphabet_n_pad",
    "alphabet_n_pad_k62", "clamp_both_ends"])
def test_verify_windows_cases(cuda, case):
    """The band, window and alphabet cases of the mask kernels."""
    L, K, kw, args = 100, 2, {}, {}
    if case.startswith("no_tail_pad"):
        # mega ends at the last pair's a + L; shifted: it starts 5 bytes
        # into its allocation, so no load of it is 16-aligned at 0
        kw = dict(tail_pad=False,
                  mega_shift=5 if case.endswith("shifted") else 0)
        L = 75
    elif case == "no_window":
        kw = dict(only_random=True)
        K = 0
    elif case.startswith("most_windows"):
        kw = dict(alternate=True)
        K = 2 if case.endswith("k2") else 0
        args = dict(lcf=1, seed_req=0)
    elif case == "fast_path":
        args = dict(lcf=L, fast_ok=True)
    elif case == "seed_req_above_k_seed":
        args = dict(seed_req=35)
    elif case == "short_seqs_k0_fast":
        kw = dict(short=True)
        K, args = 0, dict(lcf=L, fast_ok=True)
    elif case == "short_seqs_windows":
        kw = dict(short=True)
    elif case.startswith("alphabet_n_pad"):
        kw = dict(n_codes=12, pad_codes=True, n_runs=True)
        K = 62 if case.endswith("k62") else 3
        L = 150
    elif case == "clamp_both_ends":
        args = dict(ext=500)
    vt = _k3_inputs(cuda, L, seed=len(case), **kw)
    if kw.get("tail_pad") is False:
        assert vt[0].numel() == int(vt[4].max()) + L
    spans = _k3_check(vt, **_k3_args(L, K, **args))
    n_spans = spans[0].numel()
    if case == "no_window":
        assert n_spans == 0
    else:
        assert n_spans > 0
    if case.startswith("most_windows"):
        assert n_spans > 10 * vt[3].numel()
    if case == "clamp_both_ends":
        seq_lens, chrom_off = vt[7], vt[8]
        assert bool(torch.isin(spans[1], chrom_off).any())
        assert bool(torch.isin(spans[2], chrom_off + seq_lens).any())


def test_verify_windows_empty_and_limits(cuda):
    """No pairs gives empty spans with no launch; K above 62 raises."""
    vt = _k3_inputs(cuda, 100)
    e = torch.empty(0, dtype=torch.int64, device=cuda)
    si.reset_launches()
    got = si.verify_windows(*vt[:3], e, e, *vt[5:], **_k3_args(100, 2))
    assert all(x.numel() == 0 for x in got) and len(got) == 3
    assert si.verify_windows.launches == 0
    with pytest.raises(ValueError, match="outside"):
        si.verify_windows(*vt, **_k3_args(100, 63))
