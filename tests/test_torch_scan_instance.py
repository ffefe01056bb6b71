"""The port's scan + instance_to_host + solve against catch_tpu's.

Both packages scan the same corpus with the same searcher state
(catch_tpu_torch.convert carries it across); the SetCoverInstance arrays
and the greedy pick order must be equal.  catch_tpu's shape constants
are shrunk as in tests/test_scan_instance.py so its slab, subrange and
batched-merge paths run on these CPU-sized corpora.
"""

import numpy as np
import pytest
import torch

from catch_tpu.filters.candidates import make_candidate_probes_from_sequences
from catch_tpu.filters.duplicate import DuplicateFilter
from catch_tpu.filters.set_cover_filter import SetCoverFilter
from catch_tpu.genome import Genome
from catch_tpu.ops import scan_instance as sj
from catch_tpu.ops import set_cover as scj
from catch_tpu.ops.cover import CoverModel, ProbeSearcher
from catch_tpu_torch import convert
from catch_tpu_torch.filters.set_cover_filter import (
    SetCoverFilter as TSetCoverFilter)
from catch_tpu_torch.genome import Genome as TGenome
from catch_tpu_torch.ops import scan_instance as si
from catch_tpu_torch.ops import set_cover as sct
from catch_tpu_torch.ops.cover import CoverModel as TCoverModel
from catch_tpu_torch.ops.cover import ProbeSearcher as TProbeSearcher
from catch_tpu_torch.probe import Probe as TProbe

BASES = np.array(list("ACGT"))
CPU = torch.device("cpu")
INSTANCE_FIELDS = ("n_sets", "n_universes", "u_size", "can_uncover",
                   "ivl_start", "ivl_end", "pair_of_ivl", "set_of_pair",
                   "univ_of_pair", "cost", "rank_idx", "n_rank_vals",
                   "u_len", "pos_univ_offsets")


def _corpus(rng, n_genomes, n_len, mut=0.03, n_chrs=1):
    base = rng.choice(BASES, size=n_len)
    genomes = []
    for _ in range(n_genomes):
        seq = base.copy()
        m = rng.random(n_len) < mut
        seq[m] = rng.choice(BASES, size=int(m.sum()))
        if n_chrs == 1:
            genomes.append(Genome.from_one_seq("".join(seq)))
        else:
            bounds = np.linspace(0, n_len, n_chrs + 1).astype(int)
            chrs = {f"chr{i}": "".join(seq[a:b]) for i, (a, b) in
                    enumerate(zip(bounds[:-1], bounds[1:]))}
            genomes.append(Genome.from_chrs(chrs))
    return genomes


@pytest.fixture
def small_shapes(monkeypatch):
    """catch_tpu's static shapes shrunk so its slab, subrange and batch
    paths run (as in tests/test_scan_instance.py)."""
    monkeypatch.setattr(sj, "_SLAB_SAMPLES", 1 << 11)
    monkeypatch.setattr(sj, "_T_SLAB", 1 << 15)
    monkeypatch.setattr(sj, "_C_CHUNK", 1 << 10)
    monkeypatch.setattr(sj, "_SPAN_CAP", 1 << 12)
    monkeypatch.setattr(sj, "_BATCH_CHUNKS", 4)
    monkeypatch.setattr(sj, "_UNION_CAP", 1 << 10)


def _scan_inputs(genomes, model_kw, universe_p=None, ranks=None):
    """catch_tpu's searcher and the scan's inputs for `genomes`, as
    SetCoverFilter builds them."""
    seqs = [s for g in genomes for s in g.seqs]
    probes = DuplicateFilter()._filter(
        make_candidate_probes_from_sequences(seqs, probe_length=80,
                                             probe_stride=40))
    searcher = ProbeSearcher(probes, CoverModel(**model_kw))
    pid = np.arange(len(searcher.probes), dtype=np.int64)
    sequences, seq_univ, seq_off, seq_len = [], [], [], []
    for j, g in enumerate(genomes):
        off = 0
        for s in g.seqs:
            sequences.append(s)
            seq_univ.append(j)
            seq_off.append(off)
            seq_len.append(len(s))
            off += len(s)
    seq_univ, seq_off, seq_len = (np.array(x, dtype=np.int64) for x in (
        seq_univ, seq_off, seq_len))
    nU = len(genomes)
    universe_p = np.ones(nU) if universe_p is None else universe_p
    if ranks is None:
        ranks = np.zeros(len(probes), dtype=np.int64)
    rank_vals = np.unique(ranks)
    rank_idx = np.searchsorted(rank_vals, ranks).astype(np.int32)
    costs = np.ones(len(probes), dtype=np.float32)
    return dict(searcher=searcher, pid=pid, n_probes=len(probes),
                scan=(sequences, seq_univ, seq_off, seq_len, nU),
                universe_p=universe_p, rank_idx=rank_idx,
                n_rank_vals=len(rank_vals), costs=costs)


def _reference_instance(x, ext):
    """catch_tpu's device-pipeline instance of _scan_inputs' x."""
    r = sj.scan_to_boundary_instance(
        x["searcher"], *x["scan"], ext, x["universe_p"], x["rank_idx"],
        x["n_rank_vals"], x["costs"], x["pid"])
    assert r is not None
    return sj.instance_to_host(r[0], r[1], x["pid"], x["n_probes"],
                               x["rank_idx"], x["n_rank_vals"], x["costs"])


def _port_scan(x, ext, mesh=None):
    """The port's scan of _scan_inputs' x on the CPU: (dev, perm,
    searcher stats)."""
    tsearcher = convert.searcher_from_reference(
        convert.reference_arrays(x["searcher"]), mesh=mesh)
    dev, perm = si.scan_to_boundary_instance(
        tsearcher, *x["scan"], ext, x["universe_p"], x["pid"], CPU)
    return dev, perm, tsearcher.stats


def _port_instance(x, dev, perm):
    return si.instance_to_host(dev, perm, x["pid"], x["n_probes"],
                               x["rank_idx"], x["n_rank_vals"], x["costs"])


def _both_instances(genomes, model_kw, ext, universe_p=None, ranks=None):
    """(catch_tpu instance, port instance) of the same scan."""
    x = _scan_inputs(genomes, model_kw, universe_p, ranks)
    dev, perm, _ = _port_scan(x, ext)
    return _reference_instance(x, ext), _port_instance(x, dev, perm)


def _assert_same(inst_j, inst_t):
    assert len(inst_t.ivl_start) > 0
    for f in INSTANCE_FIELDS:
        a, b = getattr(inst_j, f), getattr(inst_t, f)
        assert np.array_equal(np.asarray(a), np.asarray(b)), f
        assert np.asarray(a).dtype == np.asarray(b).dtype, f
    order_j = scj.solve_instance(inst_j)
    order_t = sct.solve_instance(inst_t)
    assert len(order_t) > 0
    assert np.array_equal(order_j, order_t)


@pytest.mark.parametrize("model_kw,ext", [
    (dict(mismatches=2, lcf_thres=60), 30),
    (dict(mismatches=0, lcf_thres=60), 0),
    (dict(mismatches=2, lcf_thres=80), 0),   # fast path (lcf >= plen)
    (dict(mismatches=1, lcf_thres=60, island_of_exact_match=25), 10),
])
def test_instance_parity(small_shapes, model_kw, ext):
    rng = np.random.default_rng(17)
    _assert_same(*_both_instances(_corpus(rng, 6, 1500), model_kw, ext))


def test_instance_parity_multichrom_partial_coverage(small_shapes):
    rng = np.random.default_rng(5)
    universe_p = np.array([0.5, 1.0, 0.8, 0.65, 1.0])
    _assert_same(*_both_instances(
        _corpus(rng, 5, 2000, n_chrs=3), dict(mismatches=2, lcf_thres=60),
        20, universe_p=universe_p))


def test_instance_parity_with_ranks(small_shapes):
    rng = np.random.default_rng(23)
    genomes = _corpus(rng, 4, 1200)
    n_probes = len(DuplicateFilter()._filter(
        make_candidate_probes_from_sequences(
            [s for g in genomes for s in g.seqs], probe_length=80,
            probe_stride=40)))
    ranks = rng.integers(0, 3, size=n_probes).astype(np.int64)
    _assert_same(*_both_instances(genomes, dict(mismatches=2, lcf_thres=60),
                                  0, ranks=ranks))


def test_duplicate_candidates_last_wins(small_shapes, monkeypatch):
    """Duplicate candidate sequences map to the last candidate id, and
    ties break by candidate id: the port's filter picks what
    catch_tpu's device route picks."""
    rng = np.random.default_rng(3)
    genomes = _corpus(rng, 4, 1000)
    seqs = [s for g in genomes for s in g.seqs]
    probes = make_candidate_probes_from_sequences(
        seqs, probe_length=80, probe_stride=40)  # with duplicates
    monkeypatch.setenv("CATCH_TPU_INSTANCE", "force")
    out_j = SetCoverFilter(mismatches=2, lcf_thres=60).filter(
        [probes], [genomes], input_is_grouped=True)
    f = TSetCoverFilter(mismatches=2, lcf_thres=60, device="cpu")
    out_t = f.filter([[TProbe(p.seq_str) for p in probes]],
                     [[TGenome(list(g.seqs), g.chrs) for g in genomes]],
                     input_is_grouped=True)
    assert [p.seq_str for p in out_t[0]] == [p.seq_str for p in out_j[0]]
    assert f.last_run_stats["set_cover_picks"] == len(out_t[0]) > 0


@pytest.mark.parametrize("model_kw", [
    dict(mismatches=0, lcf_thres=100),
    dict(mismatches=2, lcf_thres=60),
    dict(mismatches=2, lcf_thres=100),
    dict(mismatches=1, lcf_thres=60, island_of_exact_match=25),
], ids=["m0", "m2_l60", "m2_l100_pigeonhole", "island"])
def test_searcher_state_matches_reference(model_kw):
    """The port's own ProbeSearcher holds catch_tpu's scan state, and
    searcher_from_reference reproduces it field for field."""
    rng = np.random.default_rng(8)
    seqs = ["".join(rng.choice(BASES, size=700)) for _ in range(3)]
    seqs.append(seqs[0][:350] + "N" * 3 + seqs[1][350:])
    probes = make_candidate_probes_from_sequences(
        seqs, probe_length=100, probe_stride=50)
    ref = convert.reference_arrays(
        ProbeSearcher(probes, CoverModel(**model_kw)))
    own = convert.reference_arrays(TProbeSearcher(
        [TProbe(p.seq_str) for p in probes], TCoverModel(**model_kw)))
    back = convert.reference_arrays(convert.searcher_from_reference(ref))
    assert set(ref) == set(convert.REFERENCE_FIELDS)
    for f in convert.REFERENCE_FIELDS:
        for other in (own, back):
            if isinstance(ref[f], np.ndarray):
                assert np.array_equal(ref[f], other[f]), f
                assert ref[f].dtype == other[f].dtype, f
            else:
                assert ref[f] == other[f], f


def test_searcher_from_reference_requires_every_field():
    with pytest.raises(KeyError):
        convert.searcher_from_reference({"probe_codes": np.zeros((1, 4))})


def test_pair_key_overflow_raises(monkeypatch):
    """P * n_universes beyond the probe blocks' key range no longer
    raises (catch_tpu returned None and took a host route): the same
    searcher, with _BLOCK_PAIR_KEYS patched low, scans in probe blocks
    and gives the unsplit instance."""
    rng = np.random.default_rng(7)
    seqs = ["".join(rng.choice(BASES, size=600)) for _ in range(2)]
    probes = [TProbe(p.seq_str) for p in make_candidate_probes_from_sequences(
        seqs, probe_length=80, probe_stride=40)]
    searcher = TProbeSearcher(probes, TCoverModel(2, 60))
    P, nU = len(searcher.probes), 2

    def scan():
        searcher.stats["candidates"] = 0
        dev, perm = si.scan_to_boundary_instance(
            searcher, seqs, np.arange(2), np.zeros(2, np.int64),
            np.array([600, 600]), nU, 0, np.ones(nU), np.arange(P), CPU)
        return dev, perm, dict(searcher.stats)

    want, perm1, stats1 = scan()
    monkeypatch.setattr(si, "_BLOCK_PAIR_KEYS", P * nU // 3)
    got, perm, stats = scan()
    assert stats1["blocks"] == (1, 1) and stats["blocks"][0] > 3
    assert stats["candidates"] == stats1["candidates"] > 0
    assert np.array_equal(perm, perm1)
    assert got["n_merged"] == want["n_merged"] > 0
    for g, w in zip(got["merged"], want["merged"]):
        assert torch.equal(g, w)
    for k in ("offsets", "u_size_host", "can_uncover_host"):
        assert np.array_equal(got[k], want[k]), k
    monkeypatch.setattr(si, "_BLOCK_PAIR_KEYS", nU)
    with pytest.raises(ValueError, match="pair key"):
        scan()


# ----------------------------------------------------------------------
# The scan in blocks, past the kernels' 31-bit keys and positions
# ----------------------------------------------------------------------

def _patch_blocks(monkeypatch, x, split, ext=0):
    """Patch the block constants so that `split` ('probes', 'corpus',
    'both' or 'pieces') cuts the scan of _scan_inputs' x: probe blocks
    of about a quarter of the rows, corpus blocks of two sequences, or
    each longest sequence in 2 pieces (at cover extension ext).  Returns
    the port's searcher."""
    sequences, _, _, _, nU = x["scan"]
    t = convert.searcher_from_reference(convert.reference_arrays(
        x["searcher"]))
    if split in ("probes", "both"):
        rows = -(-len(x["searcher"].probes) // 4)
        monkeypatch.setattr(si, "_BLOCK_PAIR_KEYS", rows * nU + 1)
    if split in ("corpus", "both"):
        # Two sequences, their L pads, the leading pad L + kj with the
        # base rounded down by up to s - 1, and the tail pad L + s + kj.
        kj, s = si.join_params_stride(t)
        two = max(len(a) + len(b) for a, b in zip(sequences, sequences[1:]))
        monkeypatch.setattr(si, "_BLOCK_POSITIONS",
                            two + 4 * t.Lmax + 2 * kj + 2 * s)
    if split == "pieces":
        monkeypatch.setattr(si, "_BLOCK_POSITIONS", _piece_limit(
            t, max(len(a) for a in sequences), 2, ext))
    return t


def _assert_split_equal(x, ext, got, want, inst_j):
    """The split scan (dev, perm, stats) against the unsplit one and
    catch_tpu's instance: merged rows, instance fields and pick order
    exactly equal, and the candidate count equal."""
    dev, perm, stats = got
    dev1, perm1, stats1 = want
    assert stats["candidates"] == stats1["candidates"] > 0
    assert np.array_equal(perm, perm1)
    for g, w in zip(dev["merged"], dev1["merged"]):
        assert torch.equal(g, w)
    inst = _port_instance(x, dev, perm)
    for f in INSTANCE_FIELDS:
        assert np.array_equal(np.asarray(getattr(inst, f)),
                              np.asarray(getattr(inst_j, f))), f
    _assert_same(inst_j, inst)


@pytest.mark.parametrize("split,n_chrs", [
    ("probes", 1), ("corpus", 1), ("both", 1), ("both", 3)],
    ids=["probe_blocks", "corpus_blocks", "both", "both_multichrom"])
def test_split_scan_equals_unsplit_and_catch_tpu(small_shapes, monkeypatch,
                                                 split, n_chrs):
    """Probe blocks, corpus blocks of whole sequences, or both (with
    genomes whose chromosomes fall in different corpus blocks): the
    instance, the pick order and the candidate count equal the unsplit
    run's and catch_tpu's."""
    rng = np.random.default_rng(29)
    genomes = _corpus(rng, 4, 1500, n_chrs=n_chrs)
    x = _scan_inputs(genomes, dict(mismatches=2, lcf_thres=60))
    inst_j = _reference_instance(x, 20)
    want = _port_scan(x, 20)
    assert want[2]["blocks"] == (1, 1)
    t = _patch_blocks(monkeypatch, x, split)
    got = _port_scan(x, 20)
    n_p, n_c = got[2]["blocks"]
    assert (n_p > 1) == (split != "corpus") and (n_c > 1) == (
        split != "probes")
    if n_chrs > 1:
        # some genome's chromosomes lie in two corpus blocks
        seq_lens = np.asarray(x["scan"][3])
        starts = si.corpus_layout(t, seq_lens)
        plan = si.plan_corpus_blocks(t, seq_lens, starts, 20)
        block_of = np.repeat(np.arange(len(plan)),
                             [i1 - i0 for i0, i1, _, _ in plan])
        assert len(plan) == n_c and any(
            len(set(block_of[x["scan"][1] == j])) > 1
            for j in range(len(genomes)))
    _assert_split_equal(x, 20, got, want, inst_j)


def _counting(fn):
    """fn, with each call counted in `launches`."""
    def wrapped(*args, **kwargs):
        wrapped.launches += 1
        return fn(*args, **kwargs)
    wrapped.launches = 0
    wrapped.__name__ = fn.__name__
    return wrapped


@pytest.mark.parametrize("split", ["probes", "both", "pieces"])
def test_split_scan_on_four_places(small_shapes, monkeypatch, split):
    """The blocks on a mesh of 4 virtual CPU places: every (probe block,
    corpus block) pair runs the per-place split, the launches by place
    add up to the totals, and the instance equals the unsplit
    single-place run's and catch_tpu's."""
    from catch_tpu_torch.parallel import make_mesh

    monkeypatch.setenv("CATCH_TPU_VIRTUAL_DEVICES", "4")
    rng = np.random.default_rng(31)
    genomes = _corpus(rng, 4, 1500)
    x = _scan_inputs(genomes, dict(mismatches=2, lcf_thres=60))
    inst_j = _reference_instance(x, 20)
    want = _port_scan(x, 20)
    _patch_blocks(monkeypatch, x, split, 20)
    # The twins launch nothing: count the wrappers' calls as launches.
    calls = {}
    for name in ("build_table", "rolling_hash", "lookup_expand",
                 "verify_windows", "dedup_pairs"):
        monkeypatch.setattr(si, name, _counting(getattr(si, name)))
        calls[name] = getattr(si, name)
    got = _port_scan(x, 20, mesh=make_mesh(4, "cpu"))
    n_p, n_c = got[2]["blocks"]
    assert (n_p > 1) == (split != "pieces")
    assert (n_c > 1) == (split != "probes")
    by_place = got[2]["launches_by_place"]
    assert sorted(by_place) == [0, 1, 2, 3]
    for name in ("rolling_hash", "lookup_expand", "verify_windows"):
        assert all(v[name] == n_p * n_c for v in by_place.values()), name
        assert calls[name].launches == 4 * n_p * n_c, name
    assert calls["build_table"].launches == n_p   # on the lead, reused
    assert calls["dedup_pairs"].launches == n_p * n_c
    _assert_split_equal(x, 20, got, want, inst_j)


def _piece_limit(t, n, pieces, ext, last=None):
    """_BLOCK_POSITIONS that cuts a sequence of n bp into `pieces`
    pieces (cores of n + L alignments), or with `last` given into full
    cores and a last core of at most `last` alignments."""
    span = n + t.Lmax
    core = -(-(span if last is None else span - last) // (
        pieces if last is None else pieces - 1))
    return core + si.piece_room(t, ext)


def _pieces_of(t, x, ext):
    """{sequence: number of pieces} of the patched plan of x's scan, and
    the edges of every core (in alignments from the sequence start)."""
    seq_lens = np.asarray(x["scan"][3])
    starts = si.corpus_layout(t, seq_lens)
    plan = si.plan_corpus_blocks(t, seq_lens, starts, ext)
    pieces, edges = {}, []
    for i0, _, _, core in plan:
        if core is not None:
            pieces[i0] = pieces.get(i0, 0) + 1
            edges.append((i0, core[0] - int(starts[i0]),
                          core[1] - int(starts[i0])))
    return pieces, edges


def test_sequence_longer_than_a_corpus_block_raises(small_shapes,
                                                     monkeypatch):
    """A single sequence that no corpus block holds no longer raises
    (catch_tpu designs it on the host): with _BLOCK_POSITIONS patched
    low, it is scanned in pieces beside blocks of whole sequences, and
    the instance, pick order and candidate count equal the unsplit
    run's and catch_tpu's."""
    rng = np.random.default_rng(9)
    genomes = [Genome.from_one_seq("".join(rng.choice(BASES, size=n)))
               for n in (500, 2000, 600)]
    x = _scan_inputs(genomes, dict(mismatches=2, lcf_thres=60))
    inst_j = _reference_instance(x, 0)
    want = _port_scan(x, 0)
    monkeypatch.setattr(si, "_BLOCK_POSITIONS", 1500)
    t = convert.searcher_from_reference(convert.reference_arrays(
        x["searcher"]))
    pieces, _ = _pieces_of(t, x, 0)
    assert pieces == {1: 2}
    _assert_split_equal(x, 0, _port_scan(x, 0), want, inst_j)


def _ragged_genomes(rng, n_genomes, n_len):
    """One-sequence genomes cut from a common base at ragged starts and
    ends: probes of the longer ones hang over the shorter ones' ends."""
    base = rng.choice(BASES, size=n_len)
    genomes = []
    for j in range(n_genomes):
        seq = base[11 * j:n_len - 23 * j].copy()
        m = rng.random(len(seq)) < 0.03
        seq[m] = rng.choice(BASES, size=int(m.sum()))
        genomes.append(Genome.from_one_seq("".join(seq)))
    return genomes


@pytest.mark.parametrize("ext", [0, 50])
@pytest.mark.parametrize("case", [
    "two_pieces", "three_pieces", "beside_short", "edge_near_the_end"])
def test_long_sequence_in_pieces_equals_unsplit_and_catch_tpu(
        small_shapes, monkeypatch, case, ext):
    """Sequences cut into pieces: each sequence into 2 or 3; a genome
    whose long chromosome is cut while its short ones go in blocks of
    whole sequences; and a last core shorter than a probe, so that
    probes hanging over a true sequence end lie on both sides of a
    piece edge.  The instance, the pick order and the candidate count
    equal the unsplit run's and catch_tpu's."""
    rng = np.random.default_rng(37)
    if case == "beside_short":
        genomes = _corpus(rng, 3, 1500, n_chrs=1)
        genomes = [Genome.from_chrs({"a": g.seqs[0][:200],
                                     "b": g.seqs[0][200:1300],
                                     "c": g.seqs[0][1300:]})
                   for g in genomes] + _corpus(rng, 1, 300)
    elif case == "edge_near_the_end":
        genomes = _ragged_genomes(rng, 4, 1500)
    else:
        genomes = _corpus(rng, 4, 1500)
    x = _scan_inputs(genomes, dict(mismatches=2, lcf_thres=60))
    inst_j = _reference_instance(x, ext)
    want = _port_scan(x, ext)
    t = convert.searcher_from_reference(convert.reference_arrays(
        x["searcher"]))
    seq_lens = np.asarray(x["scan"][3])
    n = int(seq_lens.max())
    if case == "edge_near_the_end":
        limit = _piece_limit(t, n, 3, ext, last=t.Lmax // 2)
    else:
        limit = _piece_limit(t, n, 3 if case == "three_pieces" else 2, ext)
    monkeypatch.setattr(si, "_BLOCK_POSITIONS", limit)
    pieces, edges = _pieces_of(t, x, ext)
    long = np.flatnonzero(seq_lens == n)
    if case in ("three_pieces", "edge_near_the_end"):
        assert all(pieces[i] == 3 for i in long)
    else:
        assert all(pieces[i] == 2 for i in long)
    if case == "beside_short":
        # the short chromosomes stay whole, beside the cut ones
        assert set(pieces) == set(long) and len(seq_lens) > len(long)
    if case == "edge_near_the_end":
        # an edge within a probe length of its sequence's true end
        assert any(seq_lens[i] - t.Lmax < lo < seq_lens[i]
                   for i, lo, _ in edges)
    got = _port_scan(x, ext)
    assert got[2]["blocks"][1] == len(si.plan_corpus_blocks(
        t, seq_lens, si.corpus_layout(t, seq_lens), ext))
    _assert_split_equal(x, ext, got, want, inst_j)


def test_long_position_axis_takes_the_host_solver(small_shapes, monkeypatch,
                                                   caplog):
    """Under CATCH_TPU_SOLVE=device, a group whose position axis reaches
    the device solver's limit (patched low here) takes the host route,
    as catch_tpu does: the host route's picks, catch_tpu's warning, and
    no stage E.  solve_instance(force_device=True) gives the host lazy
    solver's picks there."""
    rng = np.random.default_rng(41)
    genomes = _corpus(rng, 4, 1500)
    probes = DuplicateFilter()._filter(make_candidate_probes_from_sequences(
        [s for g in genomes for s in g.seqs], probe_length=80,
        probe_stride=40))
    tprobes = [TProbe(p.seq_str) for p in probes]
    tgenomes = [TGenome(list(g.seqs), g.chrs) for g in genomes]

    def design():
        f = TSetCoverFilter(mismatches=2, lcf_thres=60, cover_extension=25,
                            device="cpu")
        return [p.seq_str for p in f.filter([tprobes], [tgenomes],
                                            input_is_grouped=True)[0]]

    host = design()
    monkeypatch.setenv("CATCH_TPU_SOLVE", "device")
    assert design() == host
    monkeypatch.setattr(sct, "_DEVICE_AXIS_LIMIT", 1000)

    def no_stage_e(*args, **kwargs):
        raise AssertionError("ensure_assembled was called")

    monkeypatch.setattr(si, "ensure_assembled", no_stage_e)
    caplog.set_level("WARNING")
    assert design() == host and len(host) > 0
    assert "Global position axis exceeds int32" in caplog.text

    x = _scan_inputs(genomes, dict(mismatches=2, lcf_thres=60))
    dev, perm, _ = _port_scan(x, 25)
    inst = _port_instance(x, dev, perm)
    assert inst.u_len >= 1000
    order = sct.solve_instance(inst, force_device=True, device="cpu")
    assert np.array_equal(order, sct._solve_host_lazy(inst))
    assert np.array_equal(order, scj.solve_instance(_reference_instance(
        x, 25)))
