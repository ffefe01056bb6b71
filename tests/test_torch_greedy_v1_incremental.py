"""K13's incremental greedy step, modelled in plain PyTorch, against
catch_tpu's _steps_jit and _solve_jit_padded and the port's twin, on the
CPU.

csrc/greedy_v1.cu takes its instance regrouped set-major
(set_cover.set_major_index: pairs renumbered in set order, intervals
grouped by the new pair ids, the intervals that meet each tile, and
each set's tiles with the set's intervals there).  It keeps each pair's
uncovered count (pair_new) on the card through a call: computed in full
from `covered` at the start, then, at each pick, a block per tile that
the chosen set meets ORs the set's intervals there, marks the positions
still uncovered, covers them and subtracts their count inside each
interval of the tile from that interval's pair, and from len_u where the
pair is the chosen set's.  The kernel runs only on the card; _model_steps
here repeats its arithmetic tile by tile, and the tests hold it step by
step against catch_tpu (every state, the picks) and against a full
recompute of pair_new after every step, on instances whose pairs and
intervals are in any order and whose intervals overlap.  Every comparison
is exact: the state is integers and the float32 ratio is rounded once on
both sides.
"""

import numpy as np
import pytest
import torch

from catch_tpu.ops import set_cover as scj
from catch_tpu_torch import convert
from catch_tpu_torch.ops import set_cover as sct
from test_torch_cuda import (
    V2_SHAPES, _v2_shape, overlapping_instance, shuffled_instance)
from test_torch_set_cover_device import (
    INSTANCE_CASES, _assert_state, _instance, _start)

CPU = torch.device("cpu")
WARNING = "K13's overlap index exceeds int32"
JAX_ARGS = ("ivl_start", "ivl_end", "pair_of_ivl", "set_of_pair",
            "univ_of_pair", "cost", "rank_idx", "can_uncover")


CASES = INSTANCE_CASES + ["shuffled1", "shuffled4", "overlap1", "overlap2"]


def _case(case):
    """The instance of `case` (CASES): catch_tpu's, shuffled or not, or
    an overlapping one of the port's class (catch_tpu's solvers read its
    fields alike)."""
    if case.startswith("shuffled"):
        return shuffled_instance(_instance(INSTANCE_CASES[int(case[-1])]),
                                 int(case[-1]))
    if case.startswith("overlap"):
        return overlapping_instance(int(case[-1]))
    return _instance(case)


def _consts(inst_j):
    return sct._instance_consts(convert.instance_from_reference(inst_j),
                                CPU)[0]


def _full_pair_new(covered, idx):
    """int64[P]: each regrouped pair's uncovered positions, counted once
    for each of its intervals that holds them (catch_tpu's segment sum),
    from a prefix over all of `covered`."""
    prefix = sct._uncovered_prefix(covered)
    ivl = torch.zeros(idx["ivl_start"].numel() + 1, dtype=torch.int64)
    ivl[1:] = torch.cumsum(prefix[idx["ivl_end"].long()]
                           - prefix[idx["ivl_start"].long()], 0)
    pb = idx["pair_bounds"].long()
    return ivl[pb[1:]] - ivl[pb[:-1]]


def _model_steps(state, consts, n_steps, tile, after_step=None):
    """n_steps greedy steps as csrc/greedy_v1.cu takes them, one tile of
    the chosen set at a time; after_step(t, state, pair_new, idx,
    chosens, picks) sees each step's result.  Returns (state, chosens,
    picks)."""
    c = consts
    U, S = state["covered"].numel(), c["cost"].numel()
    idx = sct.set_major_index(c["ivl_start"], c["ivl_end"],
                              c["pair_of_ivl"], c["set_of_pair"],
                              c["univ_of_pair"], S, U, tile)
    starts, ends = idx["ivl_start"].long(), idx["ivl_end"].long()
    sb, uop = idx["set_bounds"].long(), idx["univ_of_pair"].long()
    pair_of = idx["ivl_rec"][:, 2].long()
    ptr, tile_ivl = idx["tile_ptr"].long(), idx["tile_ivl"].long()
    set_grp, grp_off = idx["set_grp"].tolist(), idx["grp_off"].tolist()
    grp_tile, grp_ivl = idx["grp_tile"].tolist(), idx["grp_ivl"].tolist()
    covered, len_u = state["covered"], state["len_u"]
    pair_new = _full_pair_new(covered, idx)
    chosens = torch.empty(n_steps, dtype=torch.int32)
    picks = torch.empty(n_steps, dtype=torch.bool)
    for t in range(n_steps):
        need = torch.clamp(len_u - c["can_uncover"], min=0)
        capped = torch.zeros(uop.numel() + 1, dtype=torch.int64)
        capped[1:] = torch.cumsum(torch.minimum(pair_new, need[uop]), 0)
        score = capped[sb[1:]] - capped[sb[:-1]]
        chosen, pick = sct._decide_plain(state, c, score, need, t, chosens,
                                         picks)
        ch = int(chosen)
        if "order" in state and bool(pick):
            state["order"][int(state["n_chosen"])] = ch
            state["n_chosen"] += 1
        for g in (range(set_grp[ch], set_grp[ch + 1]) if bool(pick)
                  else ()):
            k = grp_tile[g]
            r0, r1 = k * tile, min((k + 1) * tile, U)
            x = torch.arange(r0, r1)
            held = torch.zeros(r1 - r0, dtype=torch.bool)
            for i in grp_ivl[grp_off[g]:grp_off[g + 1]]:
                held |= (x >= starts[i]) & (x < ends[i])
            fresh = held & ~covered[r0:r1]
            fresh_before = torch.zeros(r1 - r0 + 1, dtype=torch.int64)
            fresh_before[1:] = torch.cumsum(fresh, 0)
            if int(fresh_before[-1]) == 0:
                continue
            covered[r0:r1] |= fresh
            js = tile_ivl[ptr[k]:ptr[k + 1]]
            a = torch.clamp(starts[js], min=r0, max=r1) - r0
            b = torch.clamp(ends[js], min=r0, max=r1) - r0
            n = torch.where(a < b, fresh_before[b] - fresh_before[a], 0)
            pair_new.index_add_(0, pair_of[js], -n)
            mine = (pair_of[js] >= sb[ch]) & (pair_of[js] < sb[ch + 1])
            len_u.index_add_(0, uop[pair_of[js]],
                             -torch.where(mine, n, 0).to(torch.int32))
        if after_step is not None:
            after_step(t, state, pair_new, idx, chosens, picks)
    return state, chosens, picks


def _check_pair_new(t, state, pair_new, idx, *_):
    assert torch.equal(pair_new, _full_pair_new(state["covered"], idx)), t


@pytest.mark.parametrize("tile", [4, 256])
@pytest.mark.parametrize("case", CASES)
def test_incremental_steps_equal_steps_jit(case, tile):
    """One call of the model through catch_tpu's stop and four steps
    past it: after every step the state and the step's pick equal those
    of catch_tpu's _steps_jit taken one step at a time, and pair_new
    equals a full recompute."""
    inst = _case(case)
    pad = scj._pad_instance(inst)
    consts = _consts(inst)
    state, jstate = _start(inst, consts, pad)
    outs, after = [], 0
    while after < 4:
        out = scj._steps_jit(*jstate, *[pad[k] for k in JAX_ARGS],
                             n_rank_vals=inst.n_rank_vals, n_steps=1)
        outs.append([np.array(x) for x in out])   # the next step donates
        jstate = out[:4]
        after += bool(out[4])
        assert len(outs) < 4 * inst.n_sets + 10

    def check(t, st, pair_new, idx, chosens, picks):
        _assert_state(inst, outs[t], st, chosens[t:t + 1], picks[t:t + 1])
        _check_pair_new(t, st, pair_new, idx)

    _, _, picks = _model_steps(state, consts, len(outs), tile, check)
    assert picks.any() and bool(state["stop"])


@pytest.mark.parametrize("case", CASES)
def test_model_keeps_solve_jit_padded_order(case):
    """With the order kept on the device, the model's loop to the stop
    leaves catch_tpu's while-loop solver's order, n_chosen and in_cover;
    so does the twin."""
    inst = _case(case)
    pad = scj._pad_instance(inst)
    in_cover, order, n_chosen = (np.asarray(x) for x in scj._solve_jit_padded(
        *[pad[k] for k in JAX_ARGS + ("u_size",)], u_len_pad=pad["U_pad"],
        n_rank_vals=inst.n_rank_vals))
    consts = _consts(inst)
    S = inst.n_sets
    for step in (lambda st, n: _model_steps(st, consts, n, 16),
                 lambda st, n: sct._greedy_steps_v1_plain(st, consts, n)):
        state, _ = _start(inst, consts, pad, keep_order=True)
        while not bool(state["stop"]):
            step(state, 5)
        assert int(state["n_chosen"]) == int(n_chosen) > 0
        assert np.array_equal(state["order"].numpy(), order[:S])
        assert np.array_equal(state["in_cover"].numpy(), in_cover[:S])


@pytest.mark.parametrize("case", CASES[5:])
def test_twin_equals_steps_jit_on_shuffled_and_overlapping(case):
    """The twin of greedy_steps_v1 against catch_tpu's _steps_jit on the
    shuffled and overlapping instances: one call through the stop and
    four steps past it, every state equal."""
    inst = _case(case)
    pad = scj._pad_instance(inst)
    consts = _consts(inst)
    state, jstate = _start(inst, consts, pad)
    n = 4 * inst.n_sets + 10
    state, ch, pk = sct._greedy_steps_v1_plain(state, consts, n)
    out = scj._steps_jit(*jstate, *[pad[k] for k in JAX_ARGS],
                         n_rank_vals=inst.n_rank_vals, n_steps=n)
    _assert_state(inst, out, state, ch, pk)
    assert bool(state["stop"]) and pk.any() and not pk[-4:].any()


def _clone(state):
    return {k: v.clone() for k, v in state.items()}


def _run_against_twin(consts, state0, n_steps, tile):
    """The model's call of n_steps against the twin's, state included,
    with pair_new checked after every step."""
    got = _model_steps(_clone(state0), consts, n_steps, tile,
                       _check_pair_new)
    want = sct._greedy_steps_v1_plain(_clone(state0), consts, n_steps)
    for k in want[0]:
        assert torch.equal(got[0][k], want[0][k]), k
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    return got


@pytest.mark.parametrize("tile", [16, 256])
@pytest.mark.parametrize("name", V2_SHAPES)
def test_incremental_steps_equal_twin_on_card_shapes(name, tile):
    """The card tests' solver shapes as K13 takes them (segment ids, the
    order kept on the device): one 64-step call of the model equals the
    twin's, and pair_new a full recompute after every step; a second
    call from the first's state too."""
    inst = _v2_shape(name)
    consts, u_size = sct._instance_consts(inst, CPU)
    covered = sct.init_covered(consts["ivl_start"], consts["ivl_end"],
                               inst.u_len)
    state0 = sct.initial_state(covered, u_size, inst.n_sets,
                               keep_order=True)
    state, _, picks = _run_against_twin(consts, state0, 64, tile)
    assert picks.any()
    _run_against_twin(consts, state, 64, tile)


def _brute_groups(s, e, set_of_ivl, n_sets, U, tile):
    """[per set: [(tile, sorted intervals meeting it)]] by a scan."""
    out = []
    for k in range(n_sets):
        groups = []
        for t in range(-(-U // tile)):
            a, b = t * tile, (t + 1) * tile
            hit = np.flatnonzero((set_of_ivl == k) & (e > s) & (s < b)
                                 & (e > a))
            if len(hit):
                groups.append((t, hit.tolist()))
        out.append(groups)
    return out


@pytest.mark.parametrize("U,tile", [(1, 256), (257, 256), (4097, 256),
                                    (1000, 7), (1000, 1)])
def test_set_major_index_equals_brute_force(U, tile):
    """Pairs in set order, intervals grouped by pair, the tile lists and
    each set's tile groups, with overlapping intervals, an interval
    across the whole axis, zero-length intervals, intervals ending at U,
    sets without pairs and pairs without intervals."""
    rng = np.random.default_rng(U + tile)
    M, P, S = 70, 30, 9
    s = rng.integers(0, U, size=M)
    e = np.minimum(U, s + rng.integers(0, 3 * tile + 5, size=M))
    e[::6] = s[::6]
    s[1], e[1] = 0, U
    s[2], e[2] = max(0, U - 1), U
    s[3] = e[3] = U
    set_of_pair = rng.choice([0, 2, 3, 5, 8], size=P)
    univ = rng.integers(0, 4, size=P)
    pair_of_ivl = rng.integers(0, P - 3, size=M)

    def t(x):
        return torch.from_numpy(np.asarray(x, dtype=np.int32))

    idx = sct.set_major_index(t(s), t(e), t(pair_of_ivl), t(set_of_pair),
                              t(univ), S, U, tile)
    for k in ("ivl_start", "ivl_end", "pair_bounds", "set_bounds",
              "univ_of_pair", "ivl_rec", "tile_ptr", "tile_ivl", "set_grp",
              "grp_tile", "grp_off", "grp_ivl"):
        assert idx[k].dtype == torch.int32, k
    pair_order = np.argsort(set_of_pair, kind="stable")
    new_pair = np.argsort(pair_order)[pair_of_ivl]
    ivl_order = np.argsort(new_pair, kind="stable")
    s2, e2 = s[ivl_order], e[ivl_order]
    rec = np.stack([s2, e2, new_pair[ivl_order],
                    univ[pair_order][new_pair[ivl_order]]], axis=1)
    assert np.array_equal(idx["ivl_rec"].numpy(), rec)
    assert np.array_equal(idx["ivl_start"].numpy(), s2)
    assert np.array_equal(idx["univ_of_pair"].numpy(), univ[pair_order])
    assert np.array_equal(idx["pair_bounds"].numpy(), np.searchsorted(
        new_pair[ivl_order], np.arange(P + 1)))
    assert np.array_equal(idx["set_bounds"].numpy(), np.searchsorted(
        set_of_pair[pair_order], np.arange(S + 1)))
    ptr = idx["tile_ptr"].numpy()
    tiles = [idx["tile_ivl"][ptr[k]:ptr[k + 1]].tolist()
             for k in range(len(ptr) - 1)]
    assert tiles == [np.flatnonzero((e2 > s2) & (s2 < (k + 1) * tile)
                                    & (e2 > k * tile)).tolist()
                     for k in range(-(-U // tile))]
    sg, go = idx["set_grp"].numpy(), idx["grp_off"].numpy()
    got = [[(int(idx["grp_tile"][g]),
             sorted(idx["grp_ivl"][go[g]:go[g + 1]].tolist()))
            for g in range(sg[k], sg[k + 1])] for k in range(S)]
    set_of_ivl = set_of_pair[pair_order][new_pair[ivl_order]]
    assert got == _brute_groups(s2, e2, set_of_ivl, S, U, tile)
    assert idx["max_pairs"] == np.bincount(set_of_pair).max()
    assert idx["max_groups"] == max(len(x) for x in got) > 0
    assert go[-1] == ptr[-1] == idx["grp_ivl"].numel()


def test_set_major_index_without_intervals_or_sets():
    none = torch.zeros(0, dtype=torch.int32)
    idx = sct.set_major_index(none, none, none, none, none, 0, 300)
    assert idx["tile_ptr"].tolist() == [0, 0, 0]
    assert idx["set_grp"].tolist() == [0] and idx["grp_off"].tolist() == [0]
    assert idx["max_pairs"] == idx["max_groups"] == 0
    idx = sct.set_major_index(none, none, none, torch.tensor(
        [1, 1], dtype=torch.int32), torch.zeros(2, dtype=torch.int32), 3, 5)
    assert idx["set_bounds"].tolist() == [0, 0, 2, 2]
    assert idx["set_grp"].tolist() == [0, 0, 0, 0]
    assert idx["max_pairs"] == 2 and idx["max_groups"] == 0


def test_k13_index_is_kept_until_the_intervals_change():
    consts = _consts(_case("overlap1"))
    idx = sct.k13_index(consts, 600)
    assert sct.k13_index(consts, 600) is idx
    consts["ivl_start"] = consts["ivl_start"].clone()
    assert sct.k13_index(consts, 600) is not idx


@pytest.mark.parametrize("shift,host", [(-1, True), (0, True), (1, False)],
                         ids=["below_the_count", "at_the_count",
                              "above_the_count"])
@pytest.mark.parametrize("case", ["arrays4", "shuffled4"])
def test_device_solvers_at_the_piece_limit(monkeypatch, caplog, case, shift,
                                           host):
    """solve_instance(force_device=True) and _solve_device with the
    piece limit patched around the instance's piece count: catch_tpu's
    picks on both routes, the warning and no greedy step on the host
    route; past the limit the index raises.  (On overlapping intervals
    catch_tpu's own host and device solvers part, so the instances here
    are build_instance's.)"""
    inst_j = _case(case)
    want = scj._solve_device(inst_j)
    assert np.array_equal(want, scj._solve_host_lazy(inst_j))
    inst = convert.instance_from_reference(inst_j)
    consts = _consts(inst_j)
    n = sct.k12_piece_count(consts)
    idx = sct.k13_index(consts, inst.u_len)
    assert n == idx["tile_ivl"].numel() == idx["grp_ivl"].numel() > 0
    monkeypatch.setattr(sct, "_K12_PIECE_LIMIT", n + shift)
    steps = []
    greedy_steps_v1 = sct.greedy_steps_v1

    def step(*args, **kwargs):
        steps.append(args[2])
        return greedy_steps_v1(*args, **kwargs)

    monkeypatch.setattr(sct, "greedy_steps_v1", step)
    caplog.set_level("WARNING")
    for got in (sct.solve_instance(inst, force_device=True, device="cpu"),
                sct._solve_device(inst, CPU)):
        assert got.dtype == np.int32 and np.array_equal(got, want)
    assert (WARNING in caplog.text) == host
    assert bool(steps) != host
    if host:
        with pytest.raises(ValueError, match="int32"):
            sct.k13_index(_consts(inst_j), inst.u_len)
