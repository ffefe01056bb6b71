"""The port's device set-cover solver against catch_tpu's, on the CPU.

Stage E (assemble), the initial coverage (init_covered), the boundary-sum
greedy steps (greedy_v2) and the segment-sum steps (greedy_v1) run their
plain-PyTorch twins here; each is held against the catch_tpu program it
replaces on the same inputs, made from numpy seeds.  The tolerance is
exact equality throughout: the state is integers, and the float32 ratio
is rounded once by IEEE division on both sides.  catch_tpu pads its
arrays to powers of two and the port does not, so the real prefix of
each catch_tpu array is compared and its padding checked to be inert.
"""

import os

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
from catch_tpu_torch.cli import design as tdesign
from catch_tpu_torch.filters.set_cover_filter import (
    SetCoverFilter as TSetCoverFilter)
from catch_tpu_torch.genome import Genome as TGenome
from catch_tpu_torch.ops import scan_instance as si
from catch_tpu_torch.ops import set_cover as sct
from catch_tpu_torch.probe import Probe as TProbe

BASES = np.array(list("ACGT"))
CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _next_pow2(x):
    return 1 if x <= 1 else 1 << int(x - 1).bit_length()


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


# ----------------------------------------------------------------------
# Stage E and the boundary solver on scanned instances
# ----------------------------------------------------------------------

def _both_devs(genomes, model_kw, ext, universe_p=None, rank_seed=None):
    """The scan's device instance of both packages (catch_tpu's assembled
    by its own ensure_assembled, the port's by K10's twin)."""
    seqs = [s for g in genomes for s in g.seqs]
    probes = DuplicateFilter()._filter(make_candidate_probes_from_sequences(
        seqs, probe_length=80, probe_stride=40))
    searcher = ProbeSearcher(probes, CoverModel(**model_kw))
    pid = np.arange(len(searcher.probes), dtype=np.int64)
    seq_univ, seq_off, seq_len = [], [], []
    for j, g in enumerate(genomes):
        off = 0
        for s in g.seqs:
            seq_univ.append(j)
            seq_off.append(off)
            seq_len.append(len(s))
            off += len(s)
    seq_univ, seq_off, seq_len = (np.array(x, dtype=np.int64) for x in (
        seq_univ, seq_off, seq_len))
    nU = len(genomes)
    universe_p = np.ones(nU) if universe_p is None else universe_p
    ranks = np.zeros(len(probes), dtype=np.int64) if rank_seed is None \
        else np.random.default_rng(rank_seed).integers(0, 3, len(probes))
    rank_vals = np.unique(ranks)
    rank_idx = np.searchsorted(rank_vals, ranks).astype(np.int32)
    costs = np.ones(len(probes), dtype=np.float32)
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
    return dev_j, dev_t, pid[perm_t]


@pytest.mark.parametrize("model_kw,ext,n_chrs,universe_p,rank_seed", [
    (dict(mismatches=2, lcf_thres=60), 30, 1, None, None),
    (dict(mismatches=0, lcf_thres=60), 0, 1, None, None),
    (dict(mismatches=2, lcf_thres=80), 0, 1, None, None),
    (dict(mismatches=1, lcf_thres=60, island_of_exact_match=25), 10, 1,
     None, None),
    (dict(mismatches=2, lcf_thres=60), 20, 3,
     np.array([0.5, 1.0, 0.8, 0.65, 1.0]), None),
    (dict(mismatches=2, lcf_thres=60), 0, 1, None, 23),
], ids=["m2_l60_e30", "m0", "fast_m2_l80", "island25",
        "multichrom_partial", "ranks"])
def test_stage_e_init_and_boundary_solve(small_shapes, model_kw, ext, n_chrs,
                                         universe_p, rank_seed):
    """K10's twin gives _assemble_jit's arrays (real prefixes), K11's
    twin _init_covered_jit's coverage, and solve_boundary_instance
    catch_tpu's pick order."""
    rng = np.random.default_rng(5 if n_chrs > 1 else 17)
    genomes = _corpus(rng, 5 if n_chrs > 1 else 6, 2000 if n_chrs > 1
                      else 1500, n_chrs=n_chrs)
    dev_j, dev_t, cand_of_set = _both_devs(genomes, model_kw, ext,
                                           universe_p, rank_seed)
    M, S, nU = dev_t["n_merged"], len(cand_of_set), len(genomes)
    P = dev_t["univ_of_pair"].numel()
    assert M > 0 and P > 0
    for k, n in (("ivl_start", M), ("ivl_end", M), ("pair_bounds", P + 1),
                 ("set_bounds", S + 1), ("univ_of_pair", P),
                 ("u_size", nU), ("can_uncover", nU), ("cost", S),
                 ("rank_idx", S)):
        got, want = np.asarray(dev_t[k]), np.asarray(dev_j[k])
        assert got.dtype == want.dtype and got.shape == (n,), k
        assert np.array_equal(got, want[:n]), k
    # catch_tpu's padding is inert: empty pairs and sets after the real
    # ones, ineligible padded sets
    assert (np.asarray(dev_j["pair_bounds"])[P + 1:] == M).all()
    assert (np.asarray(dev_j["set_bounds"])[S + 1:-1] == P).all()
    assert (np.asarray(dev_j["rank_idx"])[S:] == dev_j["n_rank_vals"]).all()
    for k in ("max_pairs_per_set", "max_ivls_per_set"):
        assert 0 < dev_t[k] <= dev_j[k] == _next_pow2(dev_t[k]), k
    assert dev_t["max_pairs_per_set"] == int(np.diff(
        np.asarray(dev_t["set_bounds"])).max())
    assert dev_t["u_len"] == int(dev_t["offsets"][-1])

    U = dev_t["u_len"]
    covered = sct._init_covered_plain(dev_t["ivl_start"], dev_t["ivl_end"], U)
    want = np.asarray(scj._init_covered_jit(dev_j["ivl_start"], dev_j["ivl_end"],
                                     u_len_pad=dev_j["U_pad"]))
    assert np.array_equal(covered.numpy(), want[:U]) and want[U:].all()
    assert not covered.all()

    order_j = scj.solve_boundary_instance(dev_j, S)
    order_t = sct.solve_boundary_instance(dev_t, S)
    assert order_t.dtype == np.int32 and len(order_t) > 0
    assert np.array_equal(order_t, order_j)


def test_each_route_keeps_only_what_it_reads():
    """The scan leaves the merged rows and no packed ones: stage E reads
    the merged rows and packs nothing, and instance_to_host packs them,
    drops them, and gives the same instance when called again."""
    genomes = _corpus(np.random.default_rng(3), 3, 1200)
    seqs = [g.seqs[0] for g in genomes]
    probes = DuplicateFilter()._filter(make_candidate_probes_from_sequences(
        seqs, probe_length=80, probe_stride=40))
    tsearcher = convert.searcher_from_reference(convert.reference_arrays(
        ProbeSearcher(probes, CoverModel(mismatches=2, lcf_thres=60))))
    pid = np.arange(len(probes), dtype=np.int64)
    one = np.ones(len(probes), dtype=np.float32)
    zero = np.zeros(len(probes), dtype=np.int32)
    zeros3 = np.zeros(3, dtype=np.int64)

    def scan():
        return si.scan_to_boundary_instance(
            tsearcher, seqs, np.arange(3), zeros3, np.full(3, 1200), 3, 0,
            np.ones(3), pid, CPU)

    dev, perm = scan()
    assert "merged" in dev and "packed" not in dev
    si.ensure_assembled(dev, perm, pid, zero, 1, one)
    assert "merged" in dev and "packed" not in dev
    dev, perm = scan()
    first = si.instance_to_host(dev, perm, pid, len(probes), zero, 1, one)
    assert "merged" not in dev and "packed" in dev
    again = si.instance_to_host(dev, perm, pid, len(probes), zero, 1, one)
    for f in convert.INSTANCE_FIELDS:
        assert np.array_equal(np.asarray(getattr(first, f)),
                              np.asarray(getattr(again, f))), f
    assert len(first.ivl_start) == dev["n_merged"] > 0


def test_init_covered_with_empty_intervals():
    """Empty intervals (start == end) add nothing, and intervals that end
    at the axis' end are held."""
    rng = np.random.default_rng(2)
    U, M = 5000, 700
    s = rng.integers(0, U, size=M)
    e = np.minimum(U, s + rng.integers(0, 60, size=M))
    e[::5] = s[::5]
    s[3], e[3] = U - 40, U
    s[4] = e[4] = U
    st, et = (torch.from_numpy(x.astype(np.int32)) for x in (s, e))
    got = sct.init_covered(st, et, U)
    assert torch.equal(got, sct._init_covered_plain(st, et, U))
    want = np.asarray(scj._init_covered_jit(s.astype(np.int32), e.astype(np.int32),
                                     u_len_pad=8192))
    assert np.array_equal(got.numpy(), want[:U]) and want[U:].all()
    assert got.any() and not got.all()


# ----------------------------------------------------------------------
# The greedy steps against catch_tpu's, state included
# ----------------------------------------------------------------------

def _dict_instance(seed, contiguous):
    """catch_tpu's build_instance on random dict sets: costs 1, 2 and 10,
    ranks 1-3, partial coverage (as tests/test_set_cover.py makes them)."""
    rng = np.random.default_rng(seed)
    sets = {}
    for sid in range(int(rng.integers(12, 30))):
        sbu = {}
        for uid in range(3):
            if rng.random() < 0.3:
                continue
            if contiguous:
                a = int(rng.integers(0, 300))
                sbu[uid] = set(range(a, a + int(rng.integers(1, 60))))
            else:
                sbu[uid] = {int(x) for x in rng.integers(
                    0, 500, size=int(rng.integers(1, 40)))}
        if sbu:
            sets[sid] = sbu
    seen = {u for sbu in sets.values() for u in sbu}
    universe_p = {u: float(rng.choice([0.5, 0.8, 1.0])) for u in seen}
    ranks = {s: int(rng.choice([1, 1, 1, 2, 3])) for s in sets}
    costs = {s: float(rng.choice([1.0, 1.0, 2.0, 10.0])) for s in sets}
    return scj.build_instance(sets, costs=costs, universe_p=universe_p,
                              ranks=ranks)[0]


def _array_instance(seed):
    """catch_tpu's build_instance_from_cover_arrays with sets that hold
    no interval, duplicate and touching spans and one universe that
    needs nothing (p = 0)."""
    rng = np.random.default_rng(seed)
    n_sets, nU, n = 40, 4, 120
    sid = rng.integers(0, 30, size=n)
    uid = rng.integers(0, nU, size=n)
    st = rng.integers(0, 400, size=n)
    en = st + rng.integers(1, 80, size=n)
    return scj.build_instance_from_cover_arrays(
        sid, uid, st, en, n_sets, nU, np.array([1.0, 0.7, 0.0, 0.9]),
        ranks=rng.integers(1, 3, size=n_sets),
        costs=rng.choice([1.0, 2.0, 10.0], size=n_sets))


def _tied_instance():
    """Every ratio ties at first: ten sets of score 3 and cost 1 and one
    of score 30 and cost 10 (float32 10/30 == 1/3), one universe; then a
    rank-2 set that only the next tier can take."""
    sets = {s: {0: set(range(3 * s, 3 * s + 3))} for s in range(10)}
    sets[10] = {0: set(range(30, 60))}
    sets[11] = {0: set(range(60, 64))}
    costs = {s: 1.0 for s in sets}
    costs[10] = 10.0
    ranks = {s: 1 for s in sets}
    ranks[11] = 2
    return scj.build_instance(sets, costs=costs, universe_p={0: 1.0},
                              ranks=ranks)[0]


def _instance(case):
    if case == "ties":
        return _tied_instance()
    if case.startswith("arrays"):
        return _array_instance(int(case[-1]))
    return _dict_instance(int(case[-1]), case.startswith("contig"))


INSTANCE_CASES = ["contig1", "scatter2", "contig3", "arrays4", "ties"]


def _v2_arrays(inst):
    """(catch_tpu's padded step arguments, the port's consts) of a host
    instance whose intervals are grouped by pair and pairs by set."""
    M, P, S = len(inst.ivl_start), len(inst.set_of_pair), inst.n_sets
    pad = scj._pad_instance(inst)
    pb = np.full(len(pad["set_of_pair"]) + 1, M, dtype=np.int32)
    pb[:P + 1] = np.searchsorted(inst.pair_of_ivl, np.arange(P + 1))
    sb = np.searchsorted(pad["set_of_pair"],
                         np.arange(pad["S_pad"] + 1)).astype(np.int32)
    n_pairs = np.diff(sb[:S + 1])
    n_ivls = pb[sb[1:S + 1]] - pb[sb[:S]]
    jax_args = [pad[k] for k in ("ivl_start", "ivl_end")] + [pb, sb] + [
        pad[k] for k in ("univ_of_pair", "cost", "rank_idx", "can_uncover")]
    jax_static = dict(n_rank_vals=inst.n_rank_vals, U_pad=pad["U_pad"],
                      max_pairs_per_set=_next_pow2(int(n_pairs.max())),
                      max_ivls_per_set=_next_pow2(int(n_ivls.max())))

    def t(x, dtype=torch.int32):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dtype)

    consts = dict(ivl_start=t(inst.ivl_start), ivl_end=t(inst.ivl_end),
                  pair_bounds=t(pb[:P + 1]), set_bounds=t(sb[:S + 1]),
                  univ_of_pair=t(inst.univ_of_pair),
                  cost=t(inst.cost, torch.float32),
                  rank_idx=t(inst.rank_idx),
                  can_uncover=t(inst.can_uncover),
                  n_rank_vals=inst.n_rank_vals,
                  max_ivls_per_set=int(n_ivls.max()))
    return pad, jax_args, jax_static, consts


def _assert_state(inst, jax_out, state, chosens, picks):
    """The port's state after a dispatch equals catch_tpu's on the real
    prefix; catch_tpu's padding stays inert."""
    covered, len_u, in_cover, cur_rank, stop, ch, pk = (
        np.asarray(x) for x in jax_out)
    U, nU, S = inst.u_len, inst.n_universes, inst.n_sets
    assert np.array_equal(state["covered"].numpy(), covered[:U])
    assert covered[U:].all()
    assert np.array_equal(state["len_u"].numpy(), len_u[:nU])
    assert (len_u[nU:] == 0).all()
    assert np.array_equal(state["in_cover"].numpy(), in_cover[:S])
    assert not in_cover[S:].any()
    assert int(state["cur_rank"]) == int(cur_rank)
    assert bool(state["stop"]) == bool(stop)
    assert np.array_equal(chosens.numpy(), ch)
    assert np.array_equal(picks.numpy(), pk)
    assert state["len_u"].dtype == torch.int32
    assert chosens.dtype == torch.int32 and picks.dtype == torch.bool


def _start(inst, consts, pad, keep_order=False):
    """Both packages' initial states."""
    covered = sct.init_covered(consts["ivl_start"], consts["ivl_end"],
                               inst.u_len)
    state = sct.initial_state(covered, torch.from_numpy(inst.u_size),
                              inst.n_sets, keep_order)
    jax_state = (scj._init_covered_jit(pad["ivl_start"], pad["ivl_end"],
                                       u_len_pad=pad["U_pad"]),
                 np.array(pad["u_size"]), np.zeros(pad["S_pad"], bool),
                 np.int32(0))
    return state, jax_state


def _run_both(inst, step_t, step_j, consts, jax_args, jax_static, pad):
    """Single steps to the stop and four past it, then one dispatch of
    as many steps from the start: every state equal.  Returns the
    number of steps to the stop."""
    state, jstate = _start(inst, consts, pad)
    steps = 0
    after = 0
    while after < 4:
        state, ch, pk = step_t(state, consts, 1)
        out = step_j(*jstate, *jax_args, n_steps=1, **jax_static)
        _assert_state(inst, out, state, ch, pk)
        jstate = out[:4]
        steps += 1
        after += bool(state["stop"])
        assert steps < 4 * inst.n_sets + 10
    state, jstate = _start(inst, consts, pad)
    state, ch, pk = step_t(state, consts, steps)
    out = step_j(*jstate, *jax_args, n_steps=steps, **jax_static)
    _assert_state(inst, out, state, ch, pk)
    assert bool(state["stop"]) and pk.any()
    return steps


@pytest.mark.parametrize("case", INSTANCE_CASES)
def test_greedy_v2_twin_equals_steps_jit_v2(case):
    inst = _instance(case)
    pad, jax_args, jax_static, consts = _v2_arrays(inst)
    steps = _run_both(inst, sct._greedy_steps_v2_plain, scj._steps_jit_v2,
                      consts, jax_args, jax_static, pad)
    assert steps > inst.n_rank_vals
    # the wrapper takes the twin for CPU tensors
    state, _ = _start(inst, consts, pad)
    sct.greedy_steps_v2(state, consts, steps)
    assert bool(state["stop"]) and sct.greedy_steps_v2.launches == 0


@pytest.mark.parametrize("case", INSTANCE_CASES)
def test_greedy_v1_twin_equals_steps_jit(case):
    inst = _instance(case)
    pad, _, _, _ = _v2_arrays(inst)
    jax_args = [pad[k] for k in ("ivl_start", "ivl_end", "pair_of_ivl",
                                 "set_of_pair", "univ_of_pair", "cost",
                                 "rank_idx", "can_uncover")]
    consts, _ = sct._instance_consts(convert.instance_from_reference(inst),
                                     CPU)
    _run_both(inst, sct._greedy_steps_v1_plain, scj._steps_jit, consts,
              jax_args, dict(n_rank_vals=inst.n_rank_vals), pad)


def test_tied_ratios_pick_the_lowest_id():
    inst = convert.instance_from_reference(_tied_instance())
    want = list(range(11)) + [11]
    assert list(sct._solve_host_lazy(inst)) == want
    assert list(sct._solve_device(inst, CPU)) == want
    assert list(sct.solve_instance(inst, force_device=True,
                                   device="cpu")) == want


@pytest.mark.parametrize("case", INSTANCE_CASES)
def test_device_solvers_equal_catch_tpu(case):
    """solve_instance(force_device=True), _solve_device and the boundary
    solver on the instance's assembled rows give catch_tpu's pick orders
    on the CPU (its host mirror, its step solver and its while-loop
    solver)."""
    inst_j = _instance(case)
    inst = convert.instance_from_reference(inst_j)
    want = scj.solve_instance(inst_j, force_device=True)
    assert len(want) > 0
    assert np.array_equal(want, scj._solve_device(inst_j))
    assert np.array_equal(want, scj._solve_host(inst_j))
    dev = sct.assembled_instance(inst, CPU)
    for got in (sct.solve_instance(inst, force_device=True, device="cpu"),
                sct._solve_device(inst, CPU), sct.solve_instance(inst),
                sct.solve_boundary_instance(dev, inst.n_sets)):
        assert got.dtype == np.int32
        assert np.array_equal(got, want)


def test_device_order_state_equals_solve_jit_padded():
    """The device-resident loop keeps catch_tpu's order array: the picks
    then -1, and in_cover as its while loop leaves them."""
    inst_j = _array_instance(7)
    inst = convert.instance_from_reference(inst_j)
    pad = scj._pad_instance(inst_j)
    in_cover, order, n_chosen = (np.asarray(x) for x in scj._solve_jit_padded(
        *[pad[k] for k in ("ivl_start", "ivl_end", "pair_of_ivl",
                           "set_of_pair", "univ_of_pair", "cost", "rank_idx",
                           "can_uncover", "u_size")],
        u_len_pad=pad["U_pad"], n_rank_vals=inst.n_rank_vals))
    consts, u_size = sct._instance_consts(inst, CPU)
    covered = sct.init_covered(consts["ivl_start"], consts["ivl_end"],
                               inst.u_len)
    state = sct.initial_state(covered, u_size, inst.n_sets, keep_order=True)
    while not bool(state["stop"]):
        sct.greedy_steps_v1(state, consts, 3)
    S = inst.n_sets
    assert int(state["n_chosen"]) == int(n_chosen) > 0
    assert np.array_equal(state["order"].numpy(), order[:S])
    assert np.array_equal(state["in_cover"].numpy(), in_cover[:S])


def test_nothing_to_cover_stops_at_once():
    """can_uncover >= u_size everywhere: the first step stops without a
    pick, in both twins."""
    inst_j = _array_instance(4)
    inst_j.can_uncover = inst_j.u_size.copy()
    inst = convert.instance_from_reference(inst_j)
    pad, _, _, consts = _v2_arrays(inst_j)
    for step, c in ((sct._greedy_steps_v2_plain, consts),
                    (sct._greedy_steps_v1_plain,
                     sct._instance_consts(inst, CPU)[0])):
        state, _ = _start(inst, consts, pad)
        state, ch, pk = step(state, c, 3)
        assert bool(state["stop"]) and not pk.any()
        assert int(state["cur_rank"]) == 0
        assert ch.tolist() == [0, 0, 0]
    assert len(sct.solve_instance(inst, force_device=True,
                                  device="cpu")) == 0


def test_step_arguments_are_checked():
    inst = _instance("contig1")
    pad, _, _, consts = _v2_arrays(inst)
    state, _ = _start(inst, consts, pad)
    with pytest.raises(ValueError, match="n_steps"):
        sct.greedy_steps_v2(state, consts, 0)
    bad = dict(state, len_u=state["len_u"].long())
    with pytest.raises(TypeError, match="len_u"):
        sct.greedy_steps_v2(bad, consts, 1)
    bad = dict(consts, set_bounds=consts["set_bounds"][:-1])
    with pytest.raises(ValueError, match="set_bounds"):
        sct.greedy_steps_v2(state, bad, 1)
    with pytest.raises(ValueError, match="order"):
        sct.greedy_steps_v2(dict(state, order=torch.zeros(
            inst.n_sets, dtype=torch.int32)), consts, 1)


def test_unassembled_or_too_long_instances_raise():
    with pytest.raises(ValueError, match="ensure_assembled"):
        sct.solve_boundary_instance({"merged": None}, 3)
    inst = convert.instance_from_reference(_instance("contig1"))
    inst.ivl_end[-1] = inst.u_len + 1
    with pytest.raises(ValueError, match="outside the position axis"):
        sct.solve_instance(inst, force_device=True, device="cpu")
    inst.ivl_end[-1] -= 1
    inst.u_len = 1 << 31
    with pytest.raises(ValueError, match="int32"):
        sct.check_instance_axis(inst)
    with pytest.raises(ValueError, match="int32"):
        sct._solve_device_steps(inst, torch.device("cpu"))
    # solve_instance(force_device=True) takes the host lazy solver on
    # such an axis, as catch_tpu does
    assert np.array_equal(
        sct.solve_instance(inst, force_device=True, device="cpu"),
        sct._solve_host_lazy(inst))
    dev = dict(offsets=np.array([0, 1 << 31]), merged=None)
    with pytest.raises(ValueError, match="int32"):
        si.ensure_assembled(dev, np.arange(2), np.arange(2),
                            np.zeros(2, np.int32), 1,
                            np.ones(2, np.float32))


def test_dispatch_bound_raises_without_a_stop(monkeypatch):
    """A solve that reaches its dispatch bound without stopping raises
    (catch_tpu logs a warning and returns the truncated picks), on each
    of the three device routes."""
    inst = convert.instance_from_reference(_instance("scatter2"))
    monkeypatch.setattr(sct, "_STEPS_PER_DISPATCH", 1)
    monkeypatch.setattr(sct, "_dispatch_bound", lambda n, r: 2)
    with pytest.raises(RuntimeError, match="without reaching its stop"):
        sct.solve_instance(inst, force_device=True, device="cpu")
    with pytest.raises(RuntimeError, match="without reaching its stop"):
        sct._solve_device(inst, CPU)
    dev = sct.assembled_instance(inst, CPU)
    with pytest.raises(RuntimeError, match="without reaching its stop"):
        sct.solve_boundary_instance(dev, inst.n_sets)


@pytest.mark.parametrize("max_dispatches", [1, 2, None])
def test_boundary_solve_max_dispatches_equals_catch_tpu(
        small_shapes, monkeypatch, max_dispatches):
    """solve_boundary_instance(..., max_dispatches=k) runs k dispatches
    and returns catch_tpu's picks so far, in its order; None solves to
    the stop.  Three steps a dispatch in both packages, so that the
    instance takes more than two."""
    monkeypatch.setattr(scj, "_STEPS_PER_DISPATCH", 3)
    monkeypatch.setattr(sct, "_STEPS_PER_DISPATCH", 3)
    genomes = _corpus(np.random.default_rng(17), 6, 1500)
    dev_j, dev_t, cand_of_set = _both_devs(
        genomes, dict(mismatches=2, lcf_thres=60), 30)
    S = len(cand_of_set)
    full = scj.solve_boundary_instance(dev_j, S)
    want = scj.solve_boundary_instance(dev_j, S,
                                       max_dispatches=max_dispatches)
    got = sct.solve_boundary_instance(dev_t, S,
                                      max_dispatches=max_dispatches)
    assert got.dtype == np.int32
    assert np.array_equal(got, want)
    if max_dispatches is None:
        assert np.array_equal(got, full)
    else:
        assert 0 < len(got) <= 3 * max_dispatches < len(full)
        assert np.array_equal(got, full[:len(got)])


def test_max_dispatches_cuts_without_raising(monkeypatch):
    """A solve cut short by max_dispatches returns its picks; one that
    reaches the dispatch bound itself still raises."""
    inst = convert.instance_from_reference(_instance("scatter2"))
    dev = sct.assembled_instance(inst, CPU)
    full = sct.solve_boundary_instance(dev, inst.n_sets)
    monkeypatch.setattr(sct, "_STEPS_PER_DISPATCH", 1)
    monkeypatch.setattr(sct, "_dispatch_bound", lambda n, r: 2)
    assert np.array_equal(sct.solve_boundary_instance(
        dev, inst.n_sets, max_dispatches=1), full[:1])
    for k in (2, 5):
        with pytest.raises(RuntimeError, match="without reaching its stop"):
            sct.solve_boundary_instance(dev, inst.n_sets, max_dispatches=k)


def test_instance_from_reference_copies_every_field():
    inst_j = _instance("arrays4")
    inst = convert.instance_from_reference(inst_j)
    for f in convert.INSTANCE_FIELDS:
        a, b = getattr(inst_j, f), getattr(inst, f)
        assert np.array_equal(np.asarray(a), np.asarray(b)), f
        assert np.asarray(a).dtype == np.asarray(b).dtype or \
            isinstance(a, (int, np.integer)), f
    inst.ivl_start[0] += 1
    assert inst.ivl_start[0] != inst_j.ivl_start[0]
    with pytest.raises(KeyError):
        convert.instance_from_reference(object())


# ----------------------------------------------------------------------
# The filter and the CLI with CATCH_TPU_SOLVE=device
# ----------------------------------------------------------------------

def test_filter_device_solve_matches_host_solve(small_shapes, monkeypatch):
    """test_filter_device_path_matches_host_path's corpus: both packages,
    with and without the device solver, give one probe set."""
    rng = np.random.default_rng(41)
    genomes = _corpus(rng, 8, 1800)
    probes = DuplicateFilter()._filter(make_candidate_probes_from_sequences(
        [s for g in genomes for s in g.seqs], probe_length=80,
        probe_stride=40))
    tprobes = [TProbe(p.seq_str) for p in probes]
    tgenomes = [TGenome(list(g.seqs), g.chrs) for g in genomes]
    monkeypatch.setenv("CATCH_TPU_INSTANCE", "force")
    out = {}
    for solve in ("host", "device"):
        if solve == "device":
            monkeypatch.setenv("CATCH_TPU_SOLVE", "device")
        fj = SetCoverFilter(mismatches=2, lcf_thres=60, cover_extension=25)
        out["jax", solve] = [p.seq_str for p in fj.filter(
            [probes], [genomes], input_is_grouped=True)[0]]
        si.reset_launches()
        ft = TSetCoverFilter(mismatches=2, lcf_thres=60, cover_extension=25,
                             device="cpu")
        out["torch", solve] = [p.seq_str for p in ft.filter(
            [tprobes], [tgenomes], input_is_grouped=True)[0]]
        assert ft.last_run_stats["set_cover_picks"] == len(
            out["torch", solve]) > 0
    assert len(set(map(tuple, out.values()))) == 1


def test_duplicate_candidates_device_solve(small_shapes, monkeypatch):
    """Duplicate candidates: solver sets are probe rows, and
    pid_of[perm[order]] gives catch_tpu's picks."""
    rng = np.random.default_rng(3)
    genomes = _corpus(rng, 4, 1000)
    probes = make_candidate_probes_from_sequences(
        [s for g in genomes for s in g.seqs], probe_length=80,
        probe_stride=40)
    assert len(set(probes)) < len(probes)
    monkeypatch.setenv("CATCH_TPU_INSTANCE", "force")
    monkeypatch.setenv("CATCH_TPU_SOLVE", "device")
    out_j = SetCoverFilter(mismatches=2, lcf_thres=60).filter(
        [probes], [genomes], input_is_grouped=True)
    out_t = TSetCoverFilter(mismatches=2, lcf_thres=60, device="cpu").filter(
        [[TProbe(p.seq_str) for p in probes]],
        [[TGenome(list(g.seqs), g.chrs) for g in genomes]],
        input_is_grouped=True)
    assert [p.seq_str for p in out_t[0]] == [p.seq_str for p in out_j[0]]
    assert out_t[0]


def _records(path):
    recs, header, seq = set(), None, []
    for line in open(path):
        line = line.strip()
        if line.startswith(">"):
            if header is not None:
                recs.add((header, "".join(seq)))
            header, seq = line, []
        else:
            seq.append(line)
    if header is not None:
        recs.add((header, "".join(seq)))
    return recs


def test_cli_ebola5_m0_device_solve_equals_golden(tmp_path, monkeypatch):
    import gzip

    path = tmp_path / "ebola5.fasta"
    recs = []
    with gzip.open(os.path.join(REPO, "tests", "data",
                                "zaire_ebolavirus.fasta.gz"), "rt") as f:
        for line in f:
            if line.startswith(">"):
                if len(recs) == 5:
                    break
                recs.append([line])
            else:
                recs[-1].append(line)
    path.write_text("".join("".join(r) for r in recs))
    monkeypatch.setenv("CATCH_TPU_SOLVE", "device")
    out = tmp_path / "probes.fasta"
    pb = tdesign.main(tdesign.init_and_parse_args(
        [str(path), "-o", str(out), "-pl", "100", "-m", "0", "-e", "0",
         "--device", "cpu"]))
    golden = os.path.join(REPO, "tests", "data", "golden",
                          "ref_ebola5_m0.fasta")
    assert _records(out) == _records(golden)
    assert pb.filters[-1].last_run_stats["set_cover_picks"] == 426
