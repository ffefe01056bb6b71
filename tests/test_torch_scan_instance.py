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


def _both_instances(genomes, model_kw, ext, universe_p=None, ranks=None):
    """(catch_tpu instance, port instance) of the same scan."""
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

    r = sj.scan_to_boundary_instance(
        searcher, sequences, seq_univ, seq_off, seq_len, nU, ext,
        universe_p, rank_idx, len(rank_vals), costs, pid)
    assert r is not None
    inst_j = sj.instance_to_host(r[0], r[1], pid, len(probes), rank_idx,
                                 len(rank_vals), costs)

    tsearcher = convert.searcher_from_reference(
        convert.reference_arrays(searcher))
    dev, perm = si.scan_to_boundary_instance(
        tsearcher, sequences, seq_univ, seq_off, seq_len, nU, ext,
        universe_p, pid, CPU)
    inst_t = si.instance_to_host(dev, perm, pid, len(probes), rank_idx,
                                 len(rank_vals), costs)
    return inst_j, inst_t


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


def test_pair_key_overflow_raises():
    """P * n_universes beyond the 31-bit pair key raises (catch_tpu
    returned None and took a host route)."""
    rng = np.random.default_rng(7)
    seqs = ["".join(rng.choice(BASES, size=600)) for _ in range(2)]
    probes = [TProbe(p.seq_str) for p in make_candidate_probes_from_sequences(
        seqs, probe_length=80, probe_stride=40)]
    searcher = TProbeSearcher(probes, TCoverModel(2, 60))
    P = len(searcher.probes)
    nU = (1 << 31) // P + 1
    with pytest.raises(ValueError, match="pair key"):
        si.scan_to_boundary_instance(
            searcher, seqs, np.zeros(2, np.int64), np.zeros(2, np.int64),
            np.array([600, 600]), nU, 0, np.ones(nU), np.arange(P), CPU)
