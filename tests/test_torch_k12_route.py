"""K12's piece limit: the host route where its overlap index would not
fit int32, on the CPU.

K12 (greedy_v2) numbers the pieces of its overlap index (an interval
cut to one tile of 256 positions) with int32 offsets; catch_tpu's
_steps_jit_v2 builds no index.  Where the index would hold
set_cover._K12_PIECE_LIMIT pieces or more, solve_boundary_instance (and
so the set-cover filter's device route, CATCH_TPU_SOLVE=device) reads
the instance back and solves it on the host, with a warning and before
any greedy launch.  The limit is patched to the piece count of small
instances here: at the count and below it the host route runs, one
above it the device route; every pick order must equal catch_tpu's.
The tolerance is exact equality.
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
from catch_tpu_torch.probe import Probe as TProbe

BASES = np.array(list("ACGT"))
CPU = torch.device("cpu")
WARNING = "K12's overlap index exceeds int32"

# where the patched limit lies against the instance's piece count, and
# whether the host route must run there
LIMITS = [(-1, True), (0, True), (1, False)]
LIMIT_IDS = ["below_the_count", "at_the_count", "above_the_count"]


def _corpus(rng, n_genomes, n_len, mut=0.03):
    base = rng.choice(BASES, size=n_len)
    genomes = []
    for _ in range(n_genomes):
        seq = base.copy()
        m = rng.random(n_len) < mut
        seq[m] = rng.choice(BASES, size=int(m.sum()))
        genomes.append(Genome.from_one_seq("".join(seq)))
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


def _guard_routes(monkeypatch, host):
    """Make the route that must not run raise: any greedy step on the
    host route, the host instance build on the device route.  Returns
    the list that records each greedy_steps_v2 call."""
    steps = []
    greedy_steps_v2 = sct.greedy_steps_v2

    def step(*args, **kwargs):
        if host:
            raise AssertionError("a greedy step ran")
        steps.append(args[2])
        return greedy_steps_v2(*args, **kwargs)

    def no_readback(*args, **kwargs):
        raise AssertionError("the instance was read back to the host")

    monkeypatch.setattr(sct, "greedy_steps_v2", step)
    if not host:
        monkeypatch.setattr(si, "instance_to_host", no_readback)
    return steps


def _both_devs(genomes, model_kw, ext, rank_seed=None):
    """The scan's assembled device instance of both packages."""
    seqs = [s for g in genomes for s in g.seqs]
    probes = DuplicateFilter()._filter(make_candidate_probes_from_sequences(
        seqs, probe_length=80, probe_stride=40))
    searcher = ProbeSearcher(probes, CoverModel(**model_kw))
    pid = np.arange(len(searcher.probes), dtype=np.int64)
    nU = len(genomes)
    seq_univ = np.arange(nU, dtype=np.int64)
    seq_off = np.zeros(nU, dtype=np.int64)
    seq_len = np.array([len(s) for s in seqs], dtype=np.int64)
    ranks = np.zeros(len(probes), dtype=np.int64) if rank_seed is None \
        else np.random.default_rng(rank_seed).integers(0, 3, len(probes))
    rank_vals = np.unique(ranks)
    rank_idx = np.searchsorted(rank_vals, ranks).astype(np.int32)
    costs = np.ones(len(probes), dtype=np.float32)
    universe_p = np.ones(nU)
    dev_j, perm_j = sj.scan_to_boundary_instance(
        searcher, seqs, seq_univ, seq_off, seq_len, nU, ext, universe_p,
        rank_idx, len(rank_vals), costs, pid)
    sj.ensure_assembled(dev_j)
    tsearcher = convert.searcher_from_reference(
        convert.reference_arrays(searcher))
    dev_t, perm_t = si.scan_to_boundary_instance(
        tsearcher, seqs, seq_univ, seq_off, seq_len, nU, ext, universe_p,
        pid, CPU)
    assert np.array_equal(perm_j, perm_t)
    si.ensure_assembled(dev_t, perm_t, pid, rank_idx, len(rank_vals), costs)
    return dev_j, dev_t, len(perm_t)


@pytest.mark.parametrize("shift,host", LIMITS, ids=LIMIT_IDS)
@pytest.mark.parametrize("model_kw,ext,rank_seed", [
    (dict(mismatches=2, lcf_thres=60), 30, None),
    (dict(mismatches=0, lcf_thres=60), 0, None),
    (dict(mismatches=2, lcf_thres=60), 0, 23),
], ids=["m2_e30", "m0", "ranks"])
def test_boundary_solve_at_the_piece_limit_equals_catch_tpu(
        small_shapes, monkeypatch, caplog, model_kw, ext, rank_seed, shift,
        host):
    """solve_boundary_instance on an assembled scan instance, with the
    piece limit patched around its piece count: catch_tpu's pick order
    on both routes, the warning only on the host route, and on it no
    greedy step."""
    genomes = _corpus(np.random.default_rng(17), 6, 1500)
    dev_j, dev_t, S = _both_devs(genomes, model_kw, ext, rank_seed)
    want = scj.solve_boundary_instance(dev_j, S)
    n = sct.k12_piece_count(dev_t)
    idx = sct.overlap_index(*(dev_t[k] for k in (
        "ivl_start", "ivl_end", "pair_bounds", "set_bounds",
        "univ_of_pair")), dev_t["u_len"])
    assert n == idx["tile_ivl"].numel() > 0
    monkeypatch.setattr(sct, "_K12_PIECE_LIMIT", n + shift)
    steps = _guard_routes(monkeypatch, host)
    caplog.set_level("WARNING")
    got = sct.solve_boundary_instance(dev_t, S)
    assert got.dtype == np.int32 and len(got) > 0
    assert np.array_equal(got, want)
    assert (WARNING in caplog.text) == host
    assert bool(steps) != host


@pytest.mark.parametrize("shift,host", LIMITS, ids=LIMIT_IDS)
@pytest.mark.parametrize("dedup", [True, False],
                         ids=["unique", "duplicate_candidates"])
def test_filter_device_route_at_the_piece_limit_equals_catch_tpu(
        small_shapes, monkeypatch, caplog, dedup, shift, host):
    """The set-cover filter under CATCH_TPU_SOLVE=device with the piece
    limit patched around its group's piece count: catch_tpu's probes
    (its device route), the warning only where the host route runs, and
    no raise."""
    genomes = _corpus(np.random.default_rng(41), 5, 1600)
    probes = make_candidate_probes_from_sequences(
        [s for g in genomes for s in g.seqs], probe_length=80,
        probe_stride=40)
    if dedup:
        probes = DuplicateFilter()._filter(probes)
    else:
        assert len(set(probes)) < len(probes)
    tprobes = [TProbe(p.seq_str) for p in probes]
    tgenomes = [TGenome(list(g.seqs), g.chrs) for g in genomes]
    monkeypatch.setenv("CATCH_TPU_INSTANCE", "force")
    monkeypatch.setenv("CATCH_TPU_SOLVE", "device")
    want = [p.seq_str for p in SetCoverFilter(
        mismatches=2, lcf_thres=60, cover_extension=25).filter(
            [probes], [genomes], input_is_grouped=True)[0]]

    def design():
        f = TSetCoverFilter(mismatches=2, lcf_thres=60, cover_extension=25,
                            device="cpu")
        return [p.seq_str for p in f.filter([tprobes], [tgenomes],
                                            input_is_grouped=True)[0]]

    devs = []
    ensure_assembled = si.ensure_assembled
    monkeypatch.setattr(si, "ensure_assembled",
                        lambda *a, **k: devs.append(ensure_assembled(*a, **k))
                        or devs[-1])
    assert design() == want and want
    n = sct.k12_piece_count(devs[-1])
    monkeypatch.setattr(sct, "_K12_PIECE_LIMIT", n + shift)
    steps = _guard_routes(monkeypatch, host)
    caplog.set_level("WARNING")
    assert design() == want
    assert (WARNING in caplog.text) == host
    assert bool(steps) != host


@pytest.mark.parametrize("shift,host", LIMITS, ids=LIMIT_IDS)
def test_assembled_host_instance_at_the_piece_limit(monkeypatch, caplog,
                                                    shift, host):
    """A host SetCoverInstance through assembled_instance (bench.py's
    solver cell builds its device dict so): the host lazy solver's picks
    on both sides of the limit, and catch_tpu's."""
    rng = np.random.default_rng(7)
    S, nU, U = 60, 3, 1200
    set_ids, univ_ids, starts, ends = [], [], [], []
    for s in range(S):
        for _ in range(rng.integers(1, 4)):
            a = int(rng.integers(0, U - 40))
            set_ids.append(s)
            univ_ids.append(int(rng.integers(0, nU)))
            starts.append(a)
            ends.append(a + int(rng.integers(1, 300)))
    arrays = [np.asarray(x, dtype=np.int64) for x in (
        set_ids, univ_ids, starts, ends)]
    kw = dict(n_sets=S, n_universes=nU, universe_p=np.full(nU, 0.9),
              ranks=rng.integers(0, 2, S))
    inst = sct.build_instance_from_cover_arrays(*arrays, **kw)
    want = scj.solve_instance(scj.build_instance_from_cover_arrays(
        *arrays, **kw))
    assert np.array_equal(sct._solve_host_lazy(inst), want) and len(want)
    dev = sct.assembled_instance(inst, CPU)
    monkeypatch.setattr(sct, "_K12_PIECE_LIMIT",
                        sct.k12_piece_count(dev) + shift)
    steps = _guard_routes(monkeypatch, host)
    caplog.set_level("WARNING")
    assert np.array_equal(sct.solve_boundary_instance(dev, S), want)
    assert (WARNING in caplog.text) == host
    assert bool(steps) != host


def test_piece_count_is_the_index_length_and_empty_intervals_count_none():
    """k12_piece_count is the length of the overlap index's tile lists:
    an interval meets ceil-aligned tiles of 256 positions, an empty one
    none."""
    start = torch.tensor([0, 0, 255, 256, 300, 10, 700], dtype=torch.int32)
    end = torch.tensor([1, 256, 257, 512, 1100, 10, 700],
                       dtype=torch.int32)
    dev = dict(ivl_start=start, ivl_end=end)
    assert sct.k12_piece_count(dev) == 1 + 1 + 2 + 1 + 4 + 0 + 0
    pair_bounds = torch.arange(8, dtype=torch.int32)
    set_bounds = torch.tensor([0, 7], dtype=torch.int32)
    idx = sct.overlap_index(start, end, pair_bounds, set_bounds,
                            torch.zeros(7, dtype=torch.int32), 1100)
    assert idx["tile_ivl"].numel() == sct.k12_piece_count(dev)
