"""The port's device mesh (catch_tpu_torch/parallel/, and the mesh paths
of the scans, the filter and the CLI) against catch_tpu on the CPU.

catch_tpu runs on the suite's 8 virtual CPU devices, as
tests/test_parallel.py does; the port runs its plain-PyTorch twins over
8 virtual CPU places (CATCH_TPU_VIRTUAL_DEVICES=8).  Both packages get
the same arrays, made from numpy seeds.  Everything compared is an
integer or a bit-exact float32 decision, so the tolerance is zero
throughout.
"""

import gzip
import os
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from catch_tpu.designer import ProbeDesigner as JDesigner
from catch_tpu.filters.candidates import (
    make_candidate_probes_from_sequences as jcandidates)
from catch_tpu.filters.duplicate import DuplicateFilter as JDuplicate
from catch_tpu.filters.set_cover_filter import SetCoverFilter as JFilter
from catch_tpu.genome import Genome as JGenome
from catch_tpu.ops import scan_instance as sj
from catch_tpu.ops import scan_sparse as jss
from catch_tpu.ops import set_cover as jsc
from catch_tpu.parallel import make_mesh as jmake_mesh
from catch_tpu.parallel import set_cover as jpsc
from catch_tpu.parallel import solve_instance_sharded as jsolve_sharded
from catch_tpu.utils import seq_io as jseq_io
from catch_tpu_torch import convert
from catch_tpu_torch.cli import design as tdesign
from catch_tpu_torch.designer import ProbeDesigner as TDesigner
from catch_tpu_torch.filters.candidates import (
    make_candidate_probes_from_sequences as tcandidates)
from catch_tpu_torch.filters.duplicate import DuplicateFilter as TDuplicate
from catch_tpu_torch.filters.set_cover_filter import SetCoverFilter as TFilter
from catch_tpu_torch.genome import Genome as TGenome
from catch_tpu_torch.ops import scan_instance as si
from catch_tpu_torch.ops import scan_sparse as tss
from catch_tpu_torch.ops import set_cover as tsc
from catch_tpu_torch.parallel import make_mesh, solve_instance_sharded
from catch_tpu_torch.parallel import set_cover as tpsc
from catch_tpu_torch.utils import seq_io as tseq_io

from test_torch_span_scan import _join, _pad32, _pow2, _searchers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
FIXTURE = os.path.join(DATA, "zaire_ebolavirus.fasta.gz")
CPU = torch.device("cpu")
BASES = np.array(list("ACGT"))
INT32_MAX = np.iinfo(np.int32).max


@pytest.fixture(autouse=True)
def virtual_places(monkeypatch):
    """8 virtual CPU places, the counterpart of the suite's 8 virtual
    XLA devices."""
    monkeypatch.setenv("CATCH_TPU_VIRTUAL_DEVICES", "8")


def _random_instance(rng, n_sets=40, n_universes=4, u_size=200):
    """tests/test_parallel.py's instances: costs from {1, 2, 3} and small
    universes make ties common."""
    sets = {}
    for sid in range(n_sets):
        per_u = {}
        for u in range(n_universes):
            if rng.random() < 0.3:
                continue
            k = rng.randint(1, u_size // 2)
            per_u[u] = set(rng.sample(range(u_size), k))
        if per_u:
            sets[sid] = per_u
    costs = {sid: rng.choice([1.0, 2.0, 3.0]) for sid in sets}
    ranks = {sid: rng.choice([1, 1, 1, 2, 5]) for sid in sets}
    universe_p = {u: rng.choice([0.5, 0.9, 1.0]) for u in range(n_universes)}
    return sets, costs, ranks, universe_p


def _random_instances(n_trials=3):
    rng = random.Random(101)
    out = []
    for _ in range(n_trials):
        sets, costs, ranks, universe_p = _random_instance(rng)
        out.append(jsc.build_instance(sets, costs=costs,
                                      universe_p=universe_p, ranks=ranks)[0])
    return out


def _single_universe_instance():
    sets = {0: {0: {1, 2}, 1: {1}}, 1: {0: {1, 2, 4}},
            2: {1: {2, 3}}, 3: {0: {4, 5}, 1: {4}}}
    return jsc.build_instance(sets)[0]


def _rank_tier_instance():
    sets = {0: {0: {0, 1}}, 1: {0: {2, 3}}, 2: {0: {0, 1, 2, 3}}}
    return jsc.build_instance(sets, ranks={0: 0, 1: 0, 2: 1})[0]


SOLVE_CASES = {
    "random0": lambda: _random_instances()[0],
    "random1": lambda: _random_instances()[1],
    "random2": lambda: _random_instances()[2],
    "single_universe": _single_universe_instance,
    "rank_tiers": _rank_tier_instance,
}


# ----------------------------------------------------------------------
# The mesh
# ----------------------------------------------------------------------

def test_make_mesh_virtual_places_and_too_many(monkeypatch):
    mesh = make_mesh(device="cpu")
    assert mesh.size == 8 and mesh.lead == CPU
    assert all(p == CPU for p in mesh.places)
    assert make_mesh(3, "cpu").size == 3
    with pytest.raises(ValueError, match="only 8 available"):
        make_mesh(9, "cpu")
    monkeypatch.delenv("CATCH_TPU_VIRTUAL_DEVICES")
    assert make_mesh(device="cpu").size == 1
    with pytest.raises(ValueError, match="only 1 available"):
        make_mesh(2, "cpu")
    with pytest.raises(RuntimeError, match="not available"):
        make_mesh(1, "cuda")


def test_mesh_is_led_by_the_requested_card(monkeypatch):
    """--device cuda:2 on a machine of four cards: the mesh starts at
    card 2 and wraps round, so the filter's device leads it."""
    from catch_tpu_torch.parallel import mesh as tmesh

    monkeypatch.delenv("CATCH_TPU_VIRTUAL_DEVICES")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(tmesh, "resolve_device", torch.device)
    assert [p.index for p in make_mesh(device="cuda:2").places] == [2, 3, 0, 1]
    assert make_mesh(2, "cuda:3").places == (torch.device("cuda", 3),
                                             torch.device("cuda", 0))
    monkeypatch.setenv("CATCH_TPU_VIRTUAL_DEVICES", "6")
    assert [p.index for p in make_mesh(device="cuda:1").places] == [
        1, 2, 3, 0, 1, 2]
    with pytest.raises(ValueError, match="only 6 available"):
        make_mesh(7, "cuda:1")


# ----------------------------------------------------------------------
# The partition
# ----------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 8])
def test_partition_matches_catch_tpu(n):
    """Every per-shard array equals the real prefix of catch_tpu's, and
    catch_tpu's pads are inert: empty intervals on the dummy pair, whose
    set id no set holds, and sets of a rank no step reaches."""
    for inst_j in _random_instances() + [_rank_tier_instance()]:
        inst_t = convert.instance_from_reference(inst_j)
        ref = jpsc._partition_instance(inst_j, n)
        want = convert.partition_from_reference(ref, inst_j)
        got = tpsc.partition_instance(inst_t, n)
        assert got.keys() == want.keys()
        for k in got:
            if k != "shards":
                assert got[k] == want[k], k
        assert len(got["shards"]) == n
        nP_loc = ref["set_of_pair"].shape[1]
        for d, (g, w) in enumerate(zip(got["shards"], want["shards"])):
            assert g.keys() == w.keys()
            for k in g:
                assert np.array_equal(g[k], w[k]), (d, k)
                assert np.asarray(g[k]).dtype == np.asarray(w[k]).dtype, k
            m, p, s = len(g["ivl_start"]), len(g["set_of_pair"]), len(
                g["cost"])
            assert not ref["ivl_start"][d, m:].any()
            assert not ref["ivl_end"][d, m:].any()
            assert (ref["pair_of_ivl"][d, m:] == nP_loc - 1).all()
            assert (ref["set_of_pair"][d, p:] == INT32_MAX).all()
            assert (ref["rank_loc"][d, s:] == inst_j.n_rank_vals).all()
        assert sum(len(g["cost"]) for g in got["shards"]) == inst_j.n_sets
        assert sum(len(g["ivl_start"]) for g in got["shards"]) == len(
            inst_j.ivl_start)


# ----------------------------------------------------------------------
# One step at a time
# ----------------------------------------------------------------------

def _jax_stepper(ref, mesh):
    """catch_tpu's greedy_step_sharded under a shard_map, every state
    element stacked over the shards, so each shard's replica comes
    back."""
    n_rank_vals = int(ref["n_rank_vals"])

    def body(ivl_start, ivl_end, pair_of_ivl, set_of_pair, univ_of_pair,
             cost_loc, rank_loc, can_uncover, *state):
        const = dict(
            ivl_start=ivl_start[0], ivl_end=ivl_end[0],
            pair_of_ivl=pair_of_ivl[0], set_of_pair=set_of_pair[0],
            univ_of_pair=univ_of_pair[0], cost_loc=cost_loc[0],
            rank_loc=rank_loc[0], can_uncover=can_uncover,
            n_pairs=set_of_pair.shape[1],
            n_universes=can_uncover.shape[0], n_rank_vals=n_rank_vals)
        out = jpsc.greedy_step_sharded(tuple(x[0] for x in state), const,
                                       "d")
        return tuple(x[None] for x in out)

    sh, repl = P("d"), P()
    step = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(sh,) * 7 + (repl,) + (sh,) * 7,
        out_specs=(sh,) * 7, check_vma=False))
    consts = [jnp.asarray(ref[k]) for k in (
        "ivl_start", "ivl_end", "pair_of_ivl", "set_of_pair",
        "univ_of_pair", "cost_loc", "rank_loc", "can_uncover")]
    return lambda state: step(*consts, *state)


def _jax_state0(ref, n):
    """The state before the first step, as _solve_sharded_jit makes it,
    stacked over n shards."""
    U_pad = ref["U_pad"]
    delta = np.zeros(U_pad + 1, dtype=np.int64)
    nonempty = ref["ivl_end"] > ref["ivl_start"]
    np.add.at(delta, ref["ivl_start"][nonempty], 1)
    np.add.at(delta, ref["ivl_end"][nonempty], -1)
    covered0 = ~(np.cumsum(delta[:U_pad]) > 0)
    one = (covered0, ref["u_size"].astype(np.int32),
           np.zeros(ref["S_loc"], dtype=bool),
           np.full(ref["S_pad"], -1, dtype=np.int32), np.int32(0),
           np.int32(0), np.bool_(False))
    return tuple(jnp.asarray(np.stack([x] * n)) for x in one)


def _assert_states_equal(got, want, what):
    for d, (g, w) in enumerate(zip(got, want)):
        assert g.keys() == w.keys()
        for k in g:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            assert torch.equal(g[k], w[k]), (what, d, k)
    for g in got[1:]:
        for k in ("covered", "len_u", "order", "n_chosen", "cur_rank",
                  "stop"):
            assert torch.equal(g[k], got[0][k]), (what, "replica", k)


@pytest.mark.parametrize("n", [1, 2, 8])
def test_sharded_steps_match_catch_tpu(n):
    """Every step up to four past the stop: the whole state of every
    place equals catch_tpu's, and all replicas are equal."""
    jmesh = jmake_mesh(n)
    places = make_mesh(n, "cpu").places
    for trial, inst_j in enumerate(_random_instances()):
        ref = jpsc._partition_instance(inst_j, n)
        part = convert.partition_from_reference(ref, inst_j)
        mesh = make_mesh(n, "cpu")
        placed = tpsc.place_partition(part, inst_j.can_uncover, mesh)
        step_j = _jax_stepper(ref, jmesh)
        state_j = _jax_state0(ref, n)
        states = convert.sharded_states_from_reference(state_j, part, places)
        # the port's own start equals catch_tpu's
        inst_t = convert.instance_from_reference(inst_j)
        covered0 = tsc.init_covered(
            torch.from_numpy(inst_t.ivl_start.astype(np.int32)),
            torch.from_numpy(inst_t.ivl_end.astype(np.int32)), inst_t.u_len)
        own = tpsc.initial_states(
            covered0, torch.from_numpy(inst_t.u_size.astype(np.int32)),
            placed)
        _assert_states_equal(own, states, (trial, "start"))
        past, n_steps = 0, 0
        while past < 4:
            state_j = step_j(state_j)
            tpsc.greedy_steps_sharded(states, placed, 1)
            want = convert.sharded_states_from_reference(state_j, part,
                                                         places)
            _assert_states_equal(states, want, (trial, n_steps))
            n_steps += 1
            if bool(states[0]["stop"]):
                past += 1
            assert n_steps < 200
        n_chosen = int(states[0]["n_chosen"])
        assert n_chosen > 3
        assert states[0]["order"][:n_chosen].tolist() == \
            jsc.solve_instance(inst_j, force_device=False).tolist()
        # one dispatch of many steps equals the same steps one at a time
        again = tpsc.greedy_steps_sharded(own, placed, n_steps)
        _assert_states_equal(again, states, (trial, "dispatch"))


# ----------------------------------------------------------------------
# The solver
# ----------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("case", list(SOLVE_CASES))
def test_solve_instance_sharded_matches_catch_tpu(case, n):
    inst_j = SOLVE_CASES[case]()
    inst_t = convert.instance_from_reference(inst_j)
    got = solve_instance_sharded(inst_t, mesh=make_mesh(n, "cpu"))
    assert got.dtype == np.int32
    host_j = jsc.solve_instance(inst_j, force_device=False)
    assert len(host_j) > 0
    assert got.tolist() == host_j.tolist()
    assert got.tolist() == tsc.solve_instance(inst_t).tolist()
    assert got.tolist() == jsolve_sharded(inst_j,
                                          mesh=jmake_mesh(n)).tolist()


def test_solve_instance_sharded_builds_its_mesh_and_exits_early():
    inst_t = convert.instance_from_reference(_single_universe_instance())
    want = tsc.solve_instance(inst_t).tolist()
    assert solve_instance_sharded(inst_t, n_devices=3,
                                  device="cpu").tolist() == want
    assert solve_instance_sharded(inst_t, device="cpu").tolist() == want
    with pytest.raises(ValueError, match="only 8 available"):
        solve_instance_sharded(inst_t, n_devices=9, device="cpu")
    done = convert.instance_from_reference(_single_universe_instance())
    done.can_uncover = done.u_size.copy()
    assert len(solve_instance_sharded(done, device="cpu")) == 0
    big = convert.instance_from_reference(_single_universe_instance())
    big.u_len = 1 << 31
    with pytest.raises(ValueError, match="int32"):
        solve_instance_sharded(big, device="cpu")


def test_solve_instance_reaches_the_sharded_solver_only_when_forced(
        monkeypatch):
    inst_t = convert.instance_from_reference(_random_instances(1)[0])
    want = tsc.solve_instance(inst_t).tolist()
    calls = []
    real = tpsc.solve_instance_sharded

    def spy(inst, mesh=None, **kw):
        calls.append(mesh.size)
        return real(inst, mesh=mesh, **kw)

    monkeypatch.setattr(tpsc, "solve_instance_sharded", spy)
    mesh = make_mesh(4, "cpu")
    assert tsc.solve_instance(inst_t, mesh=mesh).tolist() == want
    assert calls == []
    assert tsc.solve_instance(inst_t, force_device=True, device="cpu",
                              mesh=make_mesh(1, "cpu")).tolist() == want
    assert calls == []
    assert tsc.solve_instance(inst_t, force_device=True,
                              mesh=mesh).tolist() == want
    assert calls == [4]


# ----------------------------------------------------------------------
# The sharded span verification
# ----------------------------------------------------------------------

def _span_candidates(case):
    seqs, _, t = _searchers(case)
    mega, starts, ends, lo, cnt, pos = _join(t, seqs)
    p, a = tss._device_join(t, lo, cnt, pos, CPU)
    cand = tss.keep_candidates(t, p, a, torch.from_numpy(starts),
                               torch.from_numpy(ends))
    return t, mega, cand


@pytest.mark.parametrize("n", [2, 8])
@pytest.mark.parametrize("case,keep", [("mismatch", None),
                                       ("fast_path", None),
                                       ("island", None), ("mismatch", 5)])
def test_verify_spans_sharded_matches_catch_tpu(case, keep, n):
    """Equal to the unsharded verify_spans and to _verify_chunk_sharded's
    valid prefixes joined in shard order; `keep` cuts the candidates
    below the number of places."""
    t, mega, cand = _span_candidates(case)
    if keep is not None:
        cand = tuple(x[:keep].contiguous() for x in cand)
        assert keep < 8
    vargs = tss.verify_args(t)
    mega_t, codes_t = torch.from_numpy(mega), torch.from_numpy(t.probe_codes)
    want = tss.verify_spans(mega_t, codes_t, *cand, **vargs)
    assert want[0].numel() > 0
    got = tss.verify_spans_sharded(
        [(mega_t.clone(), codes_t.clone()) for _ in range(n)], *cand,
        **vargs)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    # catch_tpu's blocks are C_loc wide, so its shards cut the candidates
    # elsewhere; joined in shard order the spans are the same
    C_loc = max(1 << 10, _pow2(-(-cand[0].numel() // n)))
    out = jss._verify_chunk_sharded(
        jnp.asarray(mega), jnp.asarray(t.probe_codes),
        *[_pad32(x.numpy(), C_loc * n) for x in cand],
        jnp.int32(vargs["k_seed"]), mesh=jmake_mesh(n), L=t.Lmax,
        K=vargs["K"], C_loc=C_loc, cap_loc=2 * C_loc,
        seed_req=vargs["seed_req"], fast_ok=vargs["fast_ok"])
    sp, nq = [np.asarray(x) for x in out[:3]], np.asarray(out[4]).reshape(-1)
    assert nq.max() <= 2 * C_loc
    for g, x in zip(got, sp):
        joined = np.concatenate([x[d, :nq[d]] for d in range(n)])
        assert np.array_equal(g.numpy(), joined)


def test_scan_spans_takes_the_sharded_verify(monkeypatch):
    """With a mesh on the searcher the span scan verifies through
    verify_spans_sharded, and its spans and candidate count equal the
    unsharded scan's."""
    seqs, _, t = _searchers("mismatch")
    want = t.find_probe_covers_flat(seqs)
    calls = []
    real = tss.verify_spans_sharded
    monkeypatch.setattr(tss, "verify_spans_sharded", lambda reps, *a, **k: (
        calls.append(len(reps)), real(reps, *a, **k))[1])
    for n in (2, 8):
        t2 = convert.searcher_from_reference(
            convert.reference_arrays(t), device=CPU,
            mesh=make_mesh(n, "cpu"))
        got = t2.find_probe_covers_flat(seqs)
        for g, w in zip(got, want):
            assert np.array_equal(g, w)
        assert t2.stats["candidates"] == t.stats["candidates"]
    assert calls == [2, 8]


# ----------------------------------------------------------------------
# The mesh-split design scan
# ----------------------------------------------------------------------

def _corpus(rng, n_genomes, n_len, mut=0.03):
    base = rng.choice(BASES, size=n_len)
    seqs = []
    for _ in range(n_genomes):
        seq = base.copy()
        m = rng.random(n_len) < mut
        seq[m] = rng.choice(BASES, size=int(m.sum()))
        seqs.append("".join(seq))
    return seqs


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


def _port_scan(seqs, probes, mesh):
    f = TFilter(mismatches=2, lcf_thres=60, cover_extension=25, device="cpu",
                mesh=mesh)
    genomes = [TGenome.from_one_seq(s) for s in seqs]
    searcher, pid_of, sequences, seq_univ, seq_off, seq_len = \
        f._prepare_scan(probes, genomes)
    dev, perm = si.scan_to_boundary_instance(
        searcher, sequences, seq_univ, seq_off, seq_len, len(genomes), 25,
        np.ones(len(genomes)), pid_of, CPU)
    return dev, perm, searcher.stats


@pytest.mark.parametrize("n", [1, 2, 8])
def test_mesh_split_scan_matches_single_place_and_catch_tpu(
        small_shapes, monkeypatch, n):
    """tests/test_scan_instance.py's mesh case: the instance and the
    candidate count do not depend on the mesh size, and the probe set
    equals catch_tpu's device pipeline on a mesh of the same size."""
    seqs = _corpus(np.random.default_rng(77), 6, 2200)
    probes = TDuplicate()._filter(tcandidates(seqs, probe_length=80,
                                              probe_stride=40))
    dev1, perm1, stats1 = _port_scan(seqs, probes, None)
    dev, perm, stats = _port_scan(seqs, probes, make_mesh(n, "cpu"))
    assert dev1["n_merged"] > 1000 and stats1["candidates"] > 1000
    assert stats["candidates"] == stats1["candidates"]
    assert np.array_equal(perm, perm1)
    for g, w in zip(dev["merged"], dev1["merged"]):
        assert torch.equal(g, w)
    for k in ("offsets", "u_size_host", "can_uncover_host"):
        assert np.array_equal(dev[k], dev1[k]), k
    if n > 1:
        by_place = stats["launches_by_place"]
        assert sorted(by_place) == list(range(n))
        assert all(set(v) == {"rolling_hash", "lookup_expand",
                              "verify_windows"} for v in by_place.values())

    f_t = TFilter(mismatches=2, lcf_thres=60, cover_extension=25,
                  device="cpu", mesh=make_mesh(n, "cpu"))
    out_t = f_t.filter([probes], [[TGenome.from_one_seq(s) for s in seqs]],
                       input_is_grouped=True)
    assert f_t.last_run_stats["candidates_evaluated"] == stats1["candidates"]
    monkeypatch.setenv("CATCH_TPU_INSTANCE", "force")
    jprobes = JDuplicate()._filter(jcandidates(seqs, probe_length=80,
                                               probe_stride=40))
    f_j = JFilter(mismatches=2, lcf_thres=60, cover_extension=25,
                  mesh=jmake_mesh(n) if n > 1 else None)
    out_j = f_j.filter([jprobes], [[JGenome.from_one_seq(s) for s in seqs]],
                       input_is_grouped=True)
    assert f_j.last_run_stats["set_cover_picks"] > 0
    assert [p.seq_str for p in out_t[0]] == [p.seq_str for p in out_j[0]]
    assert f_t.last_run_stats["set_cover_picks"] == \
        f_j.last_run_stats["set_cover_picks"]


@pytest.mark.parametrize("n_pairs,n_probes,span", [(0, 5, 50), (1, 5, 50),
                                                  (3000, 40, 60),
                                                  (5000, 3, 2 ** 31 - 1)])
def test_dedup_pairs_matches_catch_tpu(n_pairs, n_probes, span):
    """The lead's dedup over the places' joined pairs against
    _dedup_pairs_jit on the same pairs (its sentinel pads left out):
    sorted by (probe, alignment), every pair once.  Tolerance zero."""
    rng = np.random.default_rng(n_pairs)
    p = rng.integers(0, n_probes, size=n_pairs)
    a = rng.integers(max(0, span - 60), span + 1, size=n_pairs)
    got = si.dedup_pairs(torch.from_numpy(p), torch.from_numpy(a))
    cap = _pow2(n_pairs + 1)
    pad = np.full(cap - n_pairs, sj._I32MAX)
    jp, ja, jn = sj._dedup_pairs_jit(
        jnp.asarray(np.concatenate([p, pad]), dtype=jnp.int32),
        _pad32(a, cap), CAP=cap)
    jn = int(jn)
    assert jn == len(set(zip(p.tolist(), a.tolist())))
    assert n_pairs < 3000 or jn < n_pairs
    assert np.array_equal(got[0].numpy(), np.asarray(jp)[:jn])
    assert np.array_equal(got[1].numpy(), np.asarray(ja)[:jn])
    assert got[0].dtype == got[1].dtype == torch.int64
    assert si.dedup_pairs.launches == 0


def test_scan_refuses_a_mesh_led_elsewhere():
    class Elsewhere:
        size, lead, places = 2, torch.device("meta"), (CPU, CPU)
    with pytest.raises(ValueError, match="led by"):
        TFilter(2, 60, device="cpu", mesh=Elsewhere())


# ----------------------------------------------------------------------
# The filter end to end
# ----------------------------------------------------------------------

def _ebola3_design(designer, dup, scf, genomes):
    d = designer([genomes], [dup(), scf], probe_length=80, probe_stride=40)
    d.design()
    return sorted(p.seq_str for p in d.final_probes)


def _port_ebola3(mesh, solve=None, monkeypatch=None):
    if solve:
        monkeypatch.setenv("CATCH_TPU_SOLVE", solve)
    try:
        genomes = tseq_io.read_genomes_from_fasta(FIXTURE)[:3]
        scf = TFilter(mismatches=1, lcf_thres=80, cover_extension=20,
                      device="cpu", mesh=mesh)
        d = TDesigner([genomes], [TDuplicate(), scf], probe_length=80,
                      probe_stride=40, device="cpu")
        d.design()
        return sorted(p.seq_str for p in d.final_probes), scf.last_run_stats
    finally:
        if solve:
            monkeypatch.delenv("CATCH_TPU_SOLVE")


def test_set_cover_filter_mesh_invariance():
    """tests/test_parallel.py's TestShardedPipeline: the probe set at
    mesh None, 2 and 8, equal to each other and to catch_tpu's."""
    want, stats = _port_ebola3(None)
    assert len(want) > 0
    for n in (2, 8):
        got, stats_n = _port_ebola3(make_mesh(n, "cpu"))
        assert got == want
        assert stats_n["candidates_evaluated"] == \
            stats["candidates_evaluated"]
        assert stats_n["set_cover_picks"] == stats["set_cover_picks"]
    genomes = jseq_io.read_genomes_from_fasta(FIXTURE)[:3]
    ref = _ebola3_design(JDesigner, JDuplicate, JFilter(
        mismatches=1, lcf_thres=80, cover_extension=20), genomes)
    assert want == ref


def test_dryrun_multichip_mirror(monkeypatch):
    """The mirror of catch_tpu's multi-chip dry run: the design on a
    mesh of 8 equals the single-place design on both solver routes, and
    the sharded solve of its 12-set instance equals the host's."""
    mesh = make_mesh(8, "cpu")
    host, _ = _port_ebola3(None)
    assert len(host) > 0
    assert _port_ebola3(mesh)[0] == host
    assert _port_ebola3(None, "device", monkeypatch)[0] == host
    assert _port_ebola3(mesh, "device", monkeypatch)[0] == host

    pyrng = np.random.RandomState(7)
    sets = {}
    for sid in range(12):
        sets[sid] = {u: set(pyrng.choice(40, size=pyrng.randint(1, 20),
                                         replace=False).tolist())
                     for u in range(2)}
    inst_j = jsc.build_instance(
        sets, universe_p={0: 1.0, 1: 0.8},
        ranks={sid: (1 if sid < 10 else 2) for sid in sets})[0]
    inst_t = convert.instance_from_reference(inst_j)
    want = jsc.solve_instance(inst_j, force_device=False).tolist()
    assert solve_instance_sharded(inst_t, mesh=mesh).tolist() == want
    assert tsc.solve_instance(inst_t).tolist() == want


# ----------------------------------------------------------------------
# The CLI
# ----------------------------------------------------------------------

def _subset(tmp_path, n):
    """The first n records of the Ebola fixture as a FASTA file."""
    path = tmp_path / f"ebola{n}.fasta"
    recs = []
    with gzip.open(FIXTURE, "rt") as f:
        for line in f:
            if line.startswith(">"):
                if len(recs) == n:
                    break
                recs.append([line])
            else:
                recs[-1].append(line)
    with open(path, "w") as out:
        for r in recs:
            out.writelines(r)
    return str(path)


def _records(path):
    recs, header = set(), None
    for line in open(path):
        line = line.strip()
        if line.startswith(">"):
            header = line
        else:
            recs.add((header, line))
    return recs


def _cli(argv):
    return tdesign.main(tdesign.init_and_parse_args(argv))


def test_cli_num_devices_gives_the_golden(tmp_path, monkeypatch):
    monkeypatch.setenv("CATCH_TPU_VIRTUAL_DEVICES", "2")
    out = str(tmp_path / "probes.fasta")
    pb = _cli([_subset(tmp_path, 5), "-o", out, "-pl", "100", "-m", "0",
               "-e", "0", "--device", "cpu", "--num-devices", "2"])
    scf = pb.filters[-1]
    assert scf.mesh.size == 2
    assert sorted(scf.last_run_stats["launches_by_place"]) == [0, 1]
    golden = _records(os.path.join(DATA, "golden", "ref_ebola5_m0.fasta"))
    assert len(golden) == 426
    assert _records(out) == golden


@pytest.mark.parametrize("flags,virtual,want", [
    (["--num-devices", "5"], "2", 2),
    ([], "3", 3),
    (["--num-devices", "2"], "8", 2),
    (["--num-devices", "4", "--max-num-processes", "3"], "8", 3),
    (["--num-devices", "1"], "8", None),
    (["--num-devices", "2"], None, None),
], ids=["clamped_to_visible", "all_visible", "as_asked", "max_processes",
        "one_is_no_mesh", "one_visible"])
def test_cli_mesh_size_follows_catch_tpu(tmp_path, monkeypatch, flags,
                                         virtual, want):
    """min(visible, --num-devices or visible, --max-num-processes), and a
    mesh only above one, as catch_tpu/cli/design.py."""
    if virtual is None:
        monkeypatch.delenv("CATCH_TPU_VIRTUAL_DEVICES")
    else:
        monkeypatch.setenv("CATCH_TPU_VIRTUAL_DEVICES", virtual)
    pb = _cli([_subset(tmp_path, 1), "-o", str(tmp_path / "o.fasta"), "-pl",
               "100", "-m", "0", "--device", "cpu"] + flags)
    mesh = pb.filters[-1].mesh
    assert (mesh.size if mesh is not None else None) == want


@pytest.mark.parametrize("var", ["CATCH_TPU_COORDINATOR",
                                 "CATCH_TPU_MULTIHOST"])
def test_cli_refuses_a_mesh_across_processes(tmp_path, monkeypatch, var):
    monkeypatch.setenv(var, "localhost:1234")
    with pytest.raises(NotImplementedError, match="item 10b"):
        _cli([_subset(tmp_path, 1), "-o", str(tmp_path / "o.fasta"),
              "--device", "cpu"])
