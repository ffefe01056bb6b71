"""K12's incremental greedy step, modelled in plain PyTorch, against
catch_tpu's _steps_jit_v2 and the port's twin, on the CPU.

csrc/greedy_v2.cu keeps each pair's uncovered count (pair_new) on the
card through a call: it is computed in full from `covered` at the start
of the call, and each pick then subtracts, through the overlap index
(set_cover.overlap_index), the newly covered positions of every interval
that meets the chosen set's pieces.  The kernel runs only on the card;
_model_steps here repeats its arithmetic piece by piece, and the tests
hold it step by step against catch_tpu (every state, the picks) and
against a full recompute of pair_new after every step.  The update is
exact only where each set's intervals are pairwise disjoint, which the
last tests check on every instance the tests assemble.  Every
comparison is exact: the state is integers and the float32 ratio is
rounded once on both sides.
"""

import numpy as np
import pytest
import torch

from catch_tpu.ops import set_cover as scj
from catch_tpu_torch.ops import set_cover as sct
from test_torch_cuda import V2_SHAPES, _v2_shape
from test_torch_set_cover_device import (  # noqa: F401 (a fixture)
    INSTANCE_CASES, _assert_state, _both_devs, _corpus, _instance, _start,
    _v2_arrays, small_shapes)

CPU = torch.device("cpu")


def _full_pair_new(covered, consts):
    """int64[P]: each pair's uncovered positions, from a prefix over all
    of `covered` (the start of a call, and catch_tpu's every step)."""
    prefix = sct._uncovered_prefix(covered)
    ivl = torch.zeros(consts["ivl_start"].numel() + 1, dtype=torch.int64)
    ivl[1:] = torch.cumsum(prefix[consts["ivl_end"].long()]
                           - prefix[consts["ivl_start"].long()], 0)
    pb = consts["pair_bounds"].long()
    return ivl[pb[1:]] - ivl[pb[:-1]]


def _model_steps(state, consts, n_steps, tile, after_step=None):
    """n_steps greedy steps as csrc/greedy_v2.cu takes them, one piece
    of the chosen set at a time; after_step(t, state, pair_new, chosens,
    picks) sees each step's result.  Returns (state, chosens, picks)."""
    c = consts
    U = state["covered"].numel()
    idx = sct.overlap_index(c["ivl_start"], c["ivl_end"], c["pair_bounds"],
                            c["set_bounds"], c["univ_of_pair"], U, tile)
    starts, ends = c["ivl_start"].long(), c["ivl_end"].long()
    pb, sb = c["pair_bounds"].long(), c["set_bounds"].long()
    uop, poi = c["univ_of_pair"].long(), idx["pair_of_ivl"].long()
    off, ptr = idx["piece_off"].long(), idx["tile_ptr"].long()
    tile_ivl = idx["tile_ivl"].long()
    covered, len_u = state["covered"], state["len_u"]
    pair_new = _full_pair_new(covered, c)
    chosens = torch.empty(n_steps, dtype=torch.int32)
    picks = torch.empty(n_steps, dtype=torch.bool)
    for t in range(n_steps):
        need = torch.clamp(len_u - c["can_uncover"], min=0)
        capped = torch.zeros(uop.numel() + 1, dtype=torch.int64)
        capped[1:] = torch.cumsum(torch.minimum(pair_new, need[uop]), 0)
        score = capped[sb[1:]] - capped[sb[:-1]]
        chosen, pick = sct._decide_plain(state, c, score, need, t, chosens,
                                         picks)
        i0, i1 = (int(pb[sb[chosen]]), int(pb[sb[chosen + 1]])) \
            if bool(pick) else (0, 0)
        for i in range(i0, i1):
            for g in range(int(off[i]), int(off[i + 1])):
                k = int(starts[i]) // tile + g - int(off[i])
                r0 = max(int(starts[i]), k * tile)
                r1 = min(int(ends[i]), (k + 1) * tile)
                fresh_before = torch.zeros(r1 - r0 + 1, dtype=torch.int64)
                fresh_before[1:] = torch.cumsum(~covered[r0:r1], 0)
                total = int(fresh_before[-1])
                if total == 0:
                    continue
                covered[r0:r1] = True
                len_u[uop[poi[i]]] -= total
                js = tile_ivl[ptr[k]:ptr[k + 1]]
                a = torch.clamp(starts[js], min=r0, max=r1) - r0
                b = torch.clamp(ends[js], min=r0, max=r1) - r0
                n = torch.where(a < b, fresh_before[b] - fresh_before[a], 0)
                pair_new.index_add_(0, poi[js], -n)
        if after_step is not None:
            after_step(t, state, pair_new, chosens, picks)
    return state, chosens, picks


def _check_pair_new(t, state, pair_new, consts):
    assert torch.equal(pair_new, _full_pair_new(state["covered"], consts)), t


@pytest.mark.parametrize("tile", [4, 256])
@pytest.mark.parametrize("case", INSTANCE_CASES)
def test_incremental_steps_equal_steps_jit_v2(case, tile):
    """One call of the model through catch_tpu's stop and four steps
    past it: after every step the state and the step's pick equal those
    of catch_tpu's _steps_jit_v2 taken one step at a time, and pair_new
    equals a full recompute."""
    inst = _instance(case)
    pad, jax_args, jax_static, consts = _v2_arrays(inst)
    state, jstate = _start(inst, consts, pad)
    outs, after = [], 0
    while after < 4:
        out = scj._steps_jit_v2(*jstate, *jax_args, n_steps=1, **jax_static)
        outs.append([np.array(x) for x in out])   # the next step donates
        jstate = out[:4]
        after += bool(out[4])
        assert len(outs) < 4 * inst.n_sets + 10

    def check(t, st, pair_new, chosens, picks):
        _assert_state(inst, outs[t], st, chosens[t:t + 1], picks[t:t + 1])
        _check_pair_new(t, st, pair_new, consts)

    _, _, picks = _model_steps(state, consts, len(outs), tile, check)
    assert picks.any() and bool(state["stop"])


def _assembled(name):
    inst = _v2_shape(name)
    d = sct.assembled_instance(inst, CPU)
    covered = sct.init_covered(d["ivl_start"], d["ivl_end"], d["u_len"])
    return inst, d, sct.initial_state(covered, d["u_size"], inst.n_sets)


def _clone(state):
    return {k: v.clone() for k, v in state.items()}


def _run_against_twin(d, state0, n_steps, tile):
    """The model's call of n_steps against the twin's, state included,
    with pair_new checked after every step."""
    got = _model_steps(_clone(state0), d, n_steps, tile,
                       lambda t, st, pn, ch, pk: _check_pair_new(t, st, pn, d))
    want = sct._greedy_steps_v2_plain(_clone(state0), d, n_steps)
    for k in want[0]:
        assert torch.equal(got[0][k], want[0][k]), k
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    return got


@pytest.mark.parametrize("tile", [16, 256])
@pytest.mark.parametrize("name", V2_SHAPES)
def test_incremental_steps_equal_twin_on_card_shapes(name, tile):
    """The card tests' K12 shapes: one 64-step call of the model equals
    the twin's, and pair_new a full recompute after every step."""
    _, d, state0 = _assembled(name)
    _, _, picks = _run_against_twin(d, state0, 64, tile)
    assert picks.any()


def test_incremental_steps_equal_twin_on_scanned_instance(small_shapes):
    """A scanned instance (stage D's merged rows through stage E), from
    its initial state and from the middle of its solve."""
    genomes = _corpus(np.random.default_rng(17), 6, 1500)
    _, dev, _ = _both_devs(genomes, dict(mismatches=2, lcf_thres=60), 30)
    covered = sct.init_covered(dev["ivl_start"], dev["ivl_end"],
                               dev["u_len"])
    state0 = sct.initial_state(covered, dev["u_size"], dev["cost"].numel())
    state, _, picks = _run_against_twin(dev, state0, 24, 256)
    assert picks.any()
    _run_against_twin(dev, state, 24, 64)


def _brute_index(s, e, U, tile):
    """{tile: intervals meeting it} by a scan of every tile."""
    out = []
    for k in range(-(-U // tile)):
        a, b = k * tile, (k + 1) * tile
        out.append(np.flatnonzero((e > s) & (s < b) & (e > a)).tolist())
    return out


@pytest.mark.parametrize("U,tile", [(1, 256), (255, 256), (256, 256),
                                    (257, 256), (4097, 256), (1000, 7),
                                    (1000, 1)])
def test_overlap_index_equals_brute_force(U, tile):
    """Every tile's intervals and every interval's pieces, with an
    interval across many tiles, zero-length intervals, intervals ending
    at U and at tile edges."""
    rng = np.random.default_rng(U + tile)
    M = 60
    s = rng.integers(0, U, size=M)
    e = np.minimum(U, s + rng.integers(0, 3 * tile + 5, size=M))
    e[::6] = s[::6]                                  # zero length
    s[1], e[1] = 0, U                                # the whole axis
    s[2], e[2] = max(0, U - 1), U                    # ends at U
    s[3] = e[3] = U                                  # empty, at U
    s[4], e[4] = min(tile, U - 1), min(2 * tile, U)  # tile to tile
    pb = np.arange(M + 1)                            # a pair each
    sb = np.array([0, 20, 20, M])                    # 3 sets, one empty
    univ = np.arange(M) % 3

    def t(x):
        return torch.from_numpy(np.asarray(x, dtype=np.int32))

    idx = sct.overlap_index(t(s), t(e), t(pb), t(sb), t(univ), U, tile)
    ptr = idx["tile_ptr"].numpy()
    got = [idx["tile_ivl"][ptr[k]:ptr[k + 1]].tolist()
           for k in range(len(ptr) - 1)]
    assert got == _brute_index(s, e, U, tile)
    off = idx["piece_off"].numpy()
    pieces = np.where(e > s, (e - 1) // tile - s // tile + 1, 0)
    assert np.array_equal(np.diff(off), pieces) and off[0] == 0
    assert ptr[-1] == off[-1] == sum(len(x) for x in got)
    pair = np.arange(M)
    assert np.array_equal(idx["ivl_rec"].numpy(),
                          np.stack([s, e, pair, univ], axis=1))
    assert idx["pair_of_ivl"].tolist() == pair.tolist()
    per_set = [off[pb[sb[k + 1]]] - off[pb[sb[k]]] for k in range(3)]
    assert idx["max_pieces"] == max(per_set) and idx["max_pairs"] == 40
    for x in ("ivl_rec", "pair_of_ivl", "piece_off", "tile_ptr", "tile_ivl"):
        assert idx[x].dtype == torch.int32, x


def test_overlap_index_without_intervals_or_sets():
    none = torch.zeros(0, dtype=torch.int32)
    idx = sct.overlap_index(none, none, torch.zeros(1, dtype=torch.int32),
                            torch.zeros(1, dtype=torch.int32), none, 300)
    assert idx["tile_ptr"].tolist() == [0, 0, 0]
    assert idx["tile_ivl"].numel() == 0
    assert idx["max_pieces"] == idx["max_pairs"] == 0


def test_overlap_index_refuses_overlapping_pair_intervals():
    """Two intervals of one pair that overlap (not merged) raise; ones
    that touch, and an empty one, do not."""
    def t(x):
        return torch.tensor(x, dtype=torch.int32)

    pb, sb, univ = t([0, 3]), t([0, 1]), t([0])
    sct.overlap_index(t([0, 5, 5]), t([5, 5, 9]), pb, sb, univ, 10)
    with pytest.raises(ValueError, match="overlap"):
        sct.overlap_index(t([0, 4, 6]), t([5, 5, 9]), pb, sb, univ, 10)


def _disjoint_sets(consts):
    """True when every set's intervals are pairwise disjoint."""
    s, e = consts["ivl_start"].long(), consts["ivl_end"].long()
    pb, sb = consts["pair_bounds"].long(), consts["set_bounds"].long()
    for k in range(sb.numel() - 1):
        a, b = int(pb[sb[k]]), int(pb[sb[k + 1]])
        order = torch.argsort(s[a:b])
        ss, ee = s[a:b][order], e[a:b][order]
        keep = ee > ss
        ss, ee = ss[keep], ee[keep]
        if (ss[1:] < ee[:-1]).any():
            return False
    return True


@pytest.mark.parametrize("case", INSTANCE_CASES + V2_SHAPES)
def test_every_set_is_disjoint(case):
    """The update's premise, on every instance the K12 tests assemble:
    catch_tpu's and the port's build_instance* merge a pair's intervals,
    and a set's pairs lie in distinct universes."""
    if case in INSTANCE_CASES:
        consts = _v2_arrays(_instance(case))[3]
    else:
        consts = _assembled(case)[1]
    assert _disjoint_sets(consts)


@pytest.mark.parametrize("model_kw,ext,n_chrs", [
    (dict(mismatches=2, lcf_thres=60), 30, 1),
    (dict(mismatches=0, lcf_thres=60), 0, 1),
    (dict(mismatches=2, lcf_thres=60), 20, 3)])
def test_every_scanned_set_is_disjoint(small_shapes, model_kw, ext, n_chrs):
    """The same on stage E's arrays of scanned instances (stage D's
    merged rows); a set's intervals across several chromosomes of one
    genome lie in one universe's range."""
    rng = np.random.default_rng(5 if n_chrs > 1 else 17)
    genomes = _corpus(rng, 5, 1500, n_chrs=n_chrs)
    _, dev, _ = _both_devs(genomes, model_kw, ext)
    assert _disjoint_sets(dev)
