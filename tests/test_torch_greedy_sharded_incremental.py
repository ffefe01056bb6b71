"""K18's incremental sharded greedy step, modelled in plain PyTorch,
against catch_tpu's greedy_step_sharded under shard_map, on the CPU.

csrc/greedy_sharded.cu takes each shard regrouped set-major
(set_cover.set_major_index on the shard's local set ids) and keeps each
place's pair counts (pair_new) on the card through a call: computed in
full from the place's replica at the start, then changed only where a
pick covers.  A step: each place scores its sets from its pair_new and
offers its first minimum (ratio, global id); every replica decides over
the offers; the owner of the chosen set writes its row (the tiles the
set meets, with the set's intervals there, and each of its pairs'
universe and pair_new); every replica applies the row: a tile at a
time it ORs the row's intervals, marks the positions still uncovered,
covers them and subtracts their count inside each of its own intervals
of the tile from that interval's pair_new, and it subtracts the row's
pair_new from len_u.  The kernel runs only on the card; _model_steps
here repeats its arithmetic tile by tile, and the tests hold it step by
step against catch_tpu (every place's state, all replicas equal) and
each place's pair_new against a full recompute from its replica, on
instances whose pairs and intervals are in any order and whose intervals
overlap, with empty shards.  Every comparison is exact: the state is
integers and the float32 ratio is rounded once on both sides.
"""

import numpy as np
import pytest
import torch

from catch_tpu.ops import set_cover as jsc
from catch_tpu.parallel import make_mesh as jmake_mesh
from catch_tpu.parallel import set_cover as jpsc
from catch_tpu_torch import convert
from catch_tpu_torch.ops import set_cover as sct
from catch_tpu_torch.parallel import make_mesh, solve_instance_sharded
from catch_tpu_torch.parallel import set_cover as psc
from test_torch_cuda import (
    _cover_instance, overlapping_instance, shuffled_instance)
from test_torch_greedy_v1_incremental import _full_pair_new
from test_torch_parallel import (
    _assert_states_equal, _jax_state0, _jax_stepper, _random_instances)

WARNING = "K18's overlap index exceeds int32"
CASES = ["random", "shuffled", "overlap1", "overlap2", "ties", "nothing"]


@pytest.fixture(autouse=True)
def virtual_places(monkeypatch):
    monkeypatch.setenv("CATCH_TPU_VIRTUAL_DEVICES", "8")


def _case(case):
    """catch_tpu's random instance, shuffled or not, an overlapping one,
    or one of the card tests' ('ties': 12 sets, so 8 places leave two
    shards empty; 'nothing': no universe needs a position)."""
    if case == "random":
        return _random_instances(1)[0]
    if case == "shuffled":
        return shuffled_instance(_random_instances(1)[0], 5)
    if case.startswith("overlap"):
        return overlapping_instance(int(case[-1]))
    return _cover_instance(case)


def _setup(inst_j, n):
    """(catch_tpu's stepper and start, the placed partition, the port's
    start) of `inst_j` at n places."""
    ref = jpsc._partition_instance(inst_j, n)
    part = convert.partition_from_reference(ref, inst_j)
    mesh = make_mesh(n, "cpu")
    placed = psc.place_partition(part, inst_j.can_uncover, mesh)
    state_j = _jax_state0(ref, n)
    states = convert.sharded_states_from_reference(state_j, part,
                                                   mesh.places)
    return _jax_stepper(ref, jmake_mesh(n)), state_j, part, placed, states


def _index(shard, U, tile):
    """The shard regrouped as shard_index regroups it, at `tile`."""
    if shard["cost"].numel() == 0:
        return None
    return sct.set_major_index(
        shard["ivl_start"], shard["ivl_end"], shard["pair_of_ivl"],
        shard["set_of_pair"] - shard["base"], shard["univ_of_pair"],
        shard["cost"].numel(), U, tile)


def _offer(state, shard, idx, pair_new):
    """The place's (ratio, global id, any eligible): its first minimum."""
    base = shard["base"]
    if idx is None:
        return float("inf"), base, False
    need = torch.clamp(state["len_u"] - shard["can_uncover"], min=0)
    uop, sb = idx["univ_of_pair"].long(), idx["set_bounds"].long()
    capped = torch.zeros(uop.numel() + 1, dtype=torch.int64)
    capped[1:] = torch.cumsum(torch.minimum(pair_new, need[uop]), 0)
    score = capped[sb[1:]] - capped[sb[:-1]]
    elig = (~state["in_cover"] & (shard["rank_idx"] == state["cur_rank"])
            & (score > 0))
    ratio = torch.where(elig, shard["cost"] / score.to(torch.float32),
                        torch.full_like(shard["cost"], float("inf")))
    arg = int(torch.argmin(ratio))
    return float(ratio[arg]), base + arg, bool(elig.any())


def _decide(state, offers, n_rank_vals, can_uncover):
    """The decide step on one replica; returns (chosen, pick)."""
    r = min(o[0] for o in offers)
    chosen = min(o[1] for o in offers if o[0] == r)
    any_elig = any(o[2] for o in offers)
    active = bool((state["len_u"] - can_uncover > 0).any())
    pick, adv = active and any_elig, active and not any_elig
    cur = int(state["cur_rank"])
    state["stop"].fill_(not active or (adv and cur + 1 >= n_rank_vals))
    state["cur_rank"] += int(adv)
    if pick:
        state["order"][int(state["n_chosen"])] = chosen
        state["n_chosen"] += 1
    return chosen, pick


def _row(state, shard, idx, pair_new, chosen):
    """The owner's row of the chosen set: [(tile, [(start, end)])] and
    [(universe, pair_new)]; flags the set in the owner's in_cover."""
    s = chosen - shard["base"]
    state["in_cover"][s] = True
    rec = idx["ivl_rec"].tolist()
    sg, go = idx["set_grp"].tolist(), idx["grp_off"].tolist()
    gi = idx["grp_ivl"].tolist()
    tiles = [(int(idx["grp_tile"][g]), [rec[i][:2] for i in
                                        gi[go[g]:go[g + 1]]])
             for g in range(sg[s], sg[s + 1])]
    q0, q1 = int(idx["set_bounds"][s]), int(idx["set_bounds"][s + 1])
    pairs = list(zip(idx["univ_of_pair"][q0:q1].tolist(),
                     pair_new[q0:q1].tolist()))
    return tiles, pairs


def _apply(state, idx, pair_new, row, U, tile):
    """The row applied to one replica, a tile at a time."""
    tiles, pairs = row
    for u, n in pairs:
        state["len_u"][u] -= n
    covered = state["covered"]
    for k, ivls in tiles:
        r0, r1 = k * tile, min((k + 1) * tile, U)
        x = torch.arange(r0, r1)
        held = torch.zeros(r1 - r0, dtype=torch.bool)
        for a, b in ivls:
            held |= (x >= a) & (x < b)
        fresh = held & ~covered[r0:r1]
        fresh_before = torch.zeros(r1 - r0 + 1, dtype=torch.int64)
        fresh_before[1:] = torch.cumsum(fresh, 0)
        if int(fresh_before[-1]) == 0:
            continue
        covered[r0:r1] |= fresh
        if idx is None:
            continue
        ptr = idx["tile_ptr"]
        js = idx["tile_ivl"][ptr[k]:ptr[k + 1]].long()
        a = torch.clamp(idx["ivl_start"][js].long(), min=r0, max=r1) - r0
        b = torch.clamp(idx["ivl_end"][js].long(), min=r0, max=r1) - r0
        n = torch.where(a < b, fresh_before[b] - fresh_before[a], 0)
        pair_new.index_add_(0, idx["ivl_rec"][js, 2].long(), -n)


def _model_steps(states, part, n_steps, tile, after_step=None):
    """n_steps steps as csrc/greedy_sharded.cu takes them: the pair
    counts recomputed once from each replica, then offer, decide on
    every replica, the owner's row and the apply on every replica;
    after_step(t, states, pair_news, idxs) sees each step's result."""
    shards, U, S_loc = part["shards"], part["u_len"], part["S_loc"]
    n_rank_vals = int(part["n_rank_vals"])
    idxs = [_index(sh, U, tile) for sh in shards]
    pair_news = [None if idx is None else _full_pair_new(st["covered"], idx)
                 for st, idx in zip(states, idxs)]
    for t in range(n_steps):
        offers = [_offer(st, sh, idx, pn) for st, sh, idx, pn
                  in zip(states, shards, idxs, pair_news)]
        decided = [_decide(st, offers, n_rank_vals, sh["can_uncover"])
                   for st, sh in zip(states, shards)]
        rows = [None] * len(shards)
        for d, (chosen, pick) in enumerate(decided):
            if pick and d == chosen // S_loc:
                rows[d] = _row(states[d], shards[d], idxs[d], pair_news[d],
                               chosen)
        for st, idx, pn, (chosen, pick) in zip(states, idxs, pair_news,
                                               decided):
            if pick:
                _apply(st, idx, pn, rows[chosen // S_loc], U, tile)
        if after_step is not None:
            after_step(t, states, pair_news, idxs)
    return states


def _check_pair_news(t, states, pair_news, idxs):
    for d, (st, pn, idx) in enumerate(zip(states, pair_news, idxs)):
        if idx is not None:
            assert torch.equal(pn, _full_pair_new(st["covered"], idx)), (t, d)


def _clone(states):
    return [{k: v.clone() for k, v in s.items()} for s in states]


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("case", CASES)
def test_model_steps_equal_greedy_step_sharded(case, n):
    """One call of the model through catch_tpu's stop and four steps
    past it, at tiles of 256 positions (the kernel's) and of 16: after
    every step every place's state equals catch_tpu's, all replicas are
    equal, and each place's pair_new equals a full recompute from its
    replica."""
    inst_j = _case(case)
    step_j, state_j, part, placed, states0 = _setup(inst_j, n)
    wants, past = [], 0
    while past < 4:
        state_j = step_j(state_j)
        wants.append(convert.sharded_states_from_reference(
            state_j, part, [s["cost"].device for s in placed["shards"]]))
        past += bool(wants[-1][0]["stop"])
        assert len(wants) < 4 * inst_j.n_sets + 10
    for tile in (256, 16):
        def check(t, states, pair_news, idxs):
            _assert_states_equal(states, wants[t], (tile, t))
            _check_pair_news(t, states, pair_news, idxs)

        states = _model_steps(_clone(states0), placed, len(wants), tile,
                              check)
    n_chosen = int(states[0]["n_chosen"])
    assert (n_chosen == 0) == (case == "nothing")
    if n == 8 and case in ("ties", "overlap1", "overlap2"):
        assert any(s["cost"].numel() == 0 for s in placed["shards"])


@pytest.mark.parametrize("n", [2, 8])
@pytest.mark.parametrize("case", ["shuffled", "overlap2", "ties"])
def test_model_calls_equal_twin(case, n):
    """Calls of 3, 5 and 64 steps, each recomputing the pair counts from
    the replicas it is handed mid-solve, against the twin's calls."""
    inst = convert.instance_from_reference(_case(case))
    _, _, part, placed, states0 = _setup(inst, n)
    got, want = _clone(states0), _clone(states0)
    for n_steps in (3, 5, 64):
        _model_steps(got, placed, n_steps, 256, _check_pair_news)
        psc._greedy_steps_sharded_plain(want, placed, n_steps)
        _assert_states_equal(got, want, n_steps)
    assert bool(got[0]["stop"]) and int(got[0]["n_chosen"]) > 0


def test_shard_index_is_kept_and_none_for_an_empty_shard():
    """shard_index regroups a shard on its local set ids, with the most
    interval entries of a set; it builds nothing for a shard without
    sets, keeps what it built, and builds again when the intervals are
    replaced."""
    inst = convert.instance_from_reference(_case("ties"))
    _, _, part, placed, _ = _setup(inst, 8)
    U = part["u_len"]
    for shard in placed["shards"]:
        idx = psc.shard_index(shard, U)
        if shard["cost"].numel() == 0:
            assert idx is None and "_k18_index" not in shard
            continue
        want = _index(shard, U, 256)
        for k, v in want.items():
            assert (torch.equal(idx[k], v) if isinstance(v, torch.Tensor)
                    else idx[k] == v), k
        ends = want["grp_off"][want["set_grp"].long()]
        assert idx["max_pieces"] == int(torch.diff(ends).max())
        assert psc.shard_index(shard, U) is idx
        shard["ivl_start"] = shard["ivl_start"].clone()
        assert psc.shard_index(shard, U) is not idx


@pytest.mark.parametrize("shift,host", [(-1, True), (0, True), (1, False)],
                         ids=["below_the_count", "at_the_count",
                              "above_the_count"])
@pytest.mark.parametrize("case", ["random", "ties"])
def test_solve_instance_sharded_at_the_piece_limit(monkeypatch, caplog,
                                                   case, shift, host):
    """solve_instance_sharded at 4 places with the piece limit patched
    around the largest shard's piece count: catch_tpu's picks on both
    routes, and on the host route the warning and no K18 step.  (The
    host lazy solvers of both packages take a set's intervals as
    build_instance groups them, and part from the sharded solver on
    shuffled or overlapping instances, so the instances here are
    build_instance's.)"""
    inst_j = _case(case)
    want = jsc.solve_instance(inst_j, force_device=False)
    inst = convert.instance_from_reference(inst_j)
    part = psc.partition_instance(inst, 4)
    most = max(int(sct._k12_pieces(torch.from_numpy(s["ivl_start"]),
                                   torch.from_numpy(s["ivl_end"])).sum())
               for s in part["shards"])
    assert 0 < most < sct.k12_piece_count(
        sct._instance_consts(inst, torch.device("cpu"))[0])
    monkeypatch.setattr(sct, "_K12_PIECE_LIMIT", most + shift)
    steps = []
    real = psc.greedy_steps_sharded

    def spy(*args, **kwargs):
        steps.append(args[2])
        return real(*args, **kwargs)

    monkeypatch.setattr(psc, "greedy_steps_sharded", spy)
    caplog.set_level("WARNING")
    for got in (solve_instance_sharded(inst, mesh=make_mesh(4, "cpu")),
                sct.solve_instance(inst, force_device=True,
                                   mesh=make_mesh(4, "cpu"))):
        assert got.dtype == np.int32 and np.array_equal(got, want)
    assert (WARNING in caplog.text) == host
    assert bool(steps) != host
    assert real.launches == 0
