"""Sharded greedy multi-universe set cover over a mesh of places.

Port of catch_tpu/parallel/set_cover.py.  The candidate sets, with
their pairs and intervals, are partitioned into contiguous blocks of
S_loc = ceil(S / n) sets, one block per place; the coverage state
(covered, len_u, order, n_chosen, cur_rank, stop) is replicated, one
replica per place.  Every greedy step, each place scores its block
against its replica and offers its first minimum of float32
cost / score as (ratio, global set id); the least ratio wins, and among
equal ratios the lowest set id, so the pick order equals the
single-device and host solvers' at any number of places.  The place
that owns the chosen set lists its intervals and its pairs' uncovered
counts, and every replica applies that list.

The kernel is K18 greedy_sharded (csrc/greedy_sharded.cu), which shares
its scan, candidate and decide code with K12 and K13 (csrc/greedy.cuh).
A step is four phases, each one launch sequence per place; the wrapper
queues a whole dispatch of steps with no host synchronisation.  Places
of one card share their candidate slots and update rows; between
distinct cards the wrapper copies each place's slot and row to the
other cards after the phase that writes them.  Those copies were run
only with all places on one card (the card tests force them there).

Left out from catch_tpu: the power-of-two pads, the dummy pair, set and
universe slots (a shard may hold no set at all; it then offers
(+inf, its base id) and launches nothing over its empty arrays), and
the (U + 1)-long coverage delta summed over the mesh every step.  The
wrapper runs its plain-PyTorch twin (_greedy_steps_sharded_plain) for
CPU tensors and the kernel for CUDA tensors, counts its launches in
`launches`, and is registered in scan_instance.KERNELS.
"""

import ctypes
import time

import numpy as np
import torch

from catch_tpu_torch import _build
from catch_tpu_torch.ops import scan_instance as si
from catch_tpu_torch.ops import set_cover as sc
from catch_tpu_torch.parallel.mesh import make_mesh

__all__ = ["solve_instance_sharded", "partition_instance", "place_partition",
           "initial_states", "greedy_steps_sharded"]

_SHARD_ARRAYS = dict(ivl_start=np.int32, ivl_end=np.int32,
                     pair_of_ivl=np.int32, set_of_pair=np.int32,
                     univ_of_pair=np.int32, cost=np.float32,
                     rank_idx=np.int32)
_REPLICA_TYPES = dict(covered=torch.bool, len_u=torch.int32,
                      in_cover=torch.bool, order=torch.int32,
                      n_chosen=torch.int32, cur_rank=torch.int32,
                      stop=torch.bool)
_INT32_MAX = np.iinfo(np.int32).max


def partition_instance(inst, n_shards):
    """Partition an instance's sets into contiguous per-shard blocks.

    Shard d owns the sets [d * S_loc, min((d + 1) * S_loc, S)) with
    S_loc = max(1, ceil(S / n_shards)), their pairs and their intervals,
    each in the instance's order; a trailing shard may own nothing.

    Returns a dict: `shards`, a list of n_shards dicts of numpy arrays
    (ivl_start, ivl_end int32[M_d]; pair_of_ivl int32[M_d], the pair's
    index within the shard; set_of_pair int32[P_d], global set ids;
    univ_of_pair int32[P_d]; cost float32[S_d]; rank_idx int32[S_d];
    and the int `base` = d * S_loc), and the ints S_loc, n_sets,
    n_universes, u_len, n_rank_vals, max_ivls_per_set and
    max_pairs_per_set (the widths of the solver's update rows).

    Replaces catch_tpu/parallel/set_cover.py _partition_instance
    (:47-111), without its pads and dummy slots.
    """
    if n_shards < 1:
        raise ValueError("n_shards must be at least 1")
    sc.check_instance_axis(inst)
    S = int(inst.n_sets)
    S_loc = max(1, -(-S // n_shards))
    set_of_pair = np.asarray(inst.set_of_pair)
    pair_of_ivl = np.asarray(inst.pair_of_ivl)
    pair_shard = set_of_pair // S_loc
    ivl_shard = pair_shard[pair_of_ivl]
    # the index of each pair within its shard
    local_pair = np.zeros(len(set_of_pair), dtype=np.int64)
    shards = []
    for d in range(n_shards):
        pids = np.flatnonzero(pair_shard == d)
        local_pair[pids] = np.arange(len(pids))
        ivls = np.flatnonzero(ivl_shard == d)
        lo, hi = min(d * S_loc, S), min((d + 1) * S_loc, S)
        arrays = dict(
            ivl_start=np.asarray(inst.ivl_start)[ivls],
            ivl_end=np.asarray(inst.ivl_end)[ivls],
            pair_of_ivl=local_pair[pair_of_ivl[ivls]],
            set_of_pair=set_of_pair[pids],
            univ_of_pair=np.asarray(inst.univ_of_pair)[pids],
            cost=np.asarray(inst.cost)[lo:hi],
            rank_idx=np.asarray(inst.rank_idx)[lo:hi])
        shard = {k: np.ascontiguousarray(arrays[k], dtype=t)
                 for k, t in _SHARD_ARRAYS.items()}
        shard["base"] = d * S_loc
        shards.append(shard)
    pairs_per_set = np.bincount(set_of_pair, minlength=max(S, 1))
    ivls_per_set = np.bincount(set_of_pair[pair_of_ivl],
                               minlength=max(S, 1))
    return dict(shards=shards, S_loc=S_loc, n_sets=S,
                n_universes=int(inst.n_universes), u_len=int(inst.u_len),
                n_rank_vals=int(inst.n_rank_vals),
                max_ivls_per_set=int(ivls_per_set.max()),
                max_pairs_per_set=int(pairs_per_set.max()))


def place_partition(part, can_uncover, mesh):
    """The partition on the mesh: shard d's arrays as tensors on place d,
    each with a replica of can_uncover (int32[nU]).  Returns a copy of
    `part` whose `shards` hold tensors."""
    if len(part["shards"]) != mesh.size:
        raise ValueError(f"{len(part['shards'])} shards for a mesh of "
                         f"{mesh.size} places")
    cu = np.ascontiguousarray(can_uncover, dtype=np.int32)
    shards = []
    for shard, place in zip(part["shards"], mesh.places):
        placed = {k: torch.from_numpy(shard[k]).to(place)
                  for k in _SHARD_ARRAYS}
        placed["can_uncover"] = torch.from_numpy(cu).to(place, copy=True)
        placed["base"] = int(shard["base"])
        shards.append(placed)
    return dict(part, shards=shards)


def initial_states(covered, u_size, part):
    """One replica of the state before the first greedy step per placed
    shard of `part`: covered (copied to each place), len_u = u_size,
    the shard's in_cover, order (-1), n_chosen, cur_rank, stop."""
    states = []
    for shard in part["shards"]:
        place = shard["cost"].device
        state = sc.initial_state(
            covered.to(place, copy=True), u_size, shard["cost"].numel())
        state["order"] = torch.full((part["n_sets"],), -1,
                                    dtype=torch.int32, device=place)
        state["n_chosen"] = torch.zeros((), dtype=torch.int32, device=place)
        states.append(state)
    return states


def _checked(states, part, n_steps):
    """Every place's tensors, checked for type, contiguity, shape and
    device; returns the places' devices."""
    if n_steps < 1:
        raise ValueError("n_steps must be at least 1")
    shards = part["shards"]
    if len(states) != len(shards) or not shards:
        raise ValueError("one state per shard, and at least one shard")
    U, nU, S = part["u_len"], part["n_universes"], part["n_sets"]
    places = []
    for d, (state, shard) in enumerate(zip(states, shards)):
        named = [(k, state[k], t) for k, t in _REPLICA_TYPES.items()]
        named += [(k, shard[k], sc._CONST_TYPES[k])
                  for k in list(_SHARD_ARRAYS) + ["can_uncover"]]
        for k, t, dtype in named:
            si._require(t, dtype, f"{k} of place {d}")
        if len({t.device for _, t, _ in named}) != 1:
            raise ValueError(f"tensors of place {d} on more than one device")
        S_d, M_d = shard["cost"].numel(), shard["ivl_start"].numel()
        P_d = shard["set_of_pair"].numel()
        want = dict(covered=U, len_u=nU, can_uncover=nU, order=S,
                    in_cover=S_d, rank_idx=S_d, ivl_end=M_d,
                    pair_of_ivl=M_d, univ_of_pair=P_d, n_chosen=1,
                    cur_rank=1, stop=1)
        for k, t, _ in named:
            if k in want and t.numel() != want[k]:
                raise ValueError(f"{k} of place {d} holds {t.numel()} "
                                 f"values, not {want[k]}")
        places.append(named[0][1].device)
    return places


class _GsPlace(ctypes.Structure):
    """struct GsPlace of csrc/greedy_sharded.cu."""
    _POINTERS = ("covered", "len_u", "can_uncover", "in_cover", "cost",
                 "rank_idx", "ivl_start", "ivl_end", "pair_of_ivl",
                 "set_of_pair", "univ_of_pair", "cur_rank", "stop", "order",
                 "n_chosen", "prefix", "tiles", "pair_new", "score", "blk_r",
                 "blk_i", "blk_any", "dec")
    _fields_ = ([(k, ctypes.c_void_p) for k in _POINTERS]
                + [(k, ctypes.c_int64) for k in ("S", "M", "P", "base")])


class _GsUpdate(ctypes.Structure):
    """struct GsUpdate of csrc/greedy_sharded.cu."""
    _POINTERS = ("cnt", "ivl_start", "ivl_end", "univ", "pair_new")
    _fields_ = ([(k, ctypes.c_void_p) for k in _POINTERS]
                + [(k, ctypes.c_int64) for k in ("cap_i", "cap_p")])


def _place_struct(state, shard, U):
    """(struct, tensors it points at) of one place, scratch included."""
    S, P = shard["cost"].numel(), shard["set_of_pair"].numel()
    w = sc._scratch(state["covered"].device, U, P, S)
    fields = dict(state, **shard, prefix=w["prefix"], tiles=w["tiles"],
                  pair_new=w["pair_new"], score=w["pair_aux"],
                  blk_r=w["blk_r"], blk_i=w["blk_i"], blk_any=w["blk_any"],
                  dec=w["dec"])
    struct = _GsPlace(**{k: fields[k].data_ptr()
                         for k in _GsPlace._POINTERS},
                      S=S, M=shard["ivl_start"].numel(), P=P,
                      base=shard["base"])
    return struct, fields


def _update_buffers(part, n, device):
    """(struct, tensors) of the update rows of n places on `device`, and
    the candidate slots (ratio, id, any)."""
    cap_i, cap_p = part["max_ivls_per_set"], part["max_pairs_per_set"]

    def ints(*shape):
        return torch.empty(shape, dtype=torch.int32, device=device)

    t = dict(cnt=ints(n, 2), ivl_start=ints(n, max(cap_i, 1)),
             ivl_end=ints(n, max(cap_i, 1)), univ=ints(n, max(cap_p, 1)),
             pair_new=ints(n, max(cap_p, 1)),
             cand_r=torch.empty(n, dtype=torch.float32, device=device),
             cand_i=ints(n), cand_any=ints(n))
    struct = _GsUpdate(**{k: t[k].data_ptr() for k in _GsUpdate._POINTERS},
                       cap_i=max(cap_i, 1), cap_p=max(cap_p, 1))
    return struct, t


def _cards(places):
    """For each place the index of its card among the distinct cards of
    `places`, in order of first appearance.  Places of one card share
    their candidate slots and update rows."""
    seen = {}
    return [seen.setdefault(p, len(seen)) for p in places]


def greedy_steps_sharded(states, part, n_steps):
    """Run n_steps sharded greedy steps.

    states: one dict per place (see initial_states), updated in place;
    every tensor of place d lies on that place.  part: the placed
    partition (place_partition).  Returns states.  Steps after the stop
    run in full and change nothing but cur_rank.  No step waits for the
    host.

    Replaces catch_tpu/parallel/set_cover.py greedy_step_sharded
    (:114-181) and the loop of _solve_sharded_jit (:184-236); the kernel
    is csrc/greedy_sharded.cu.
    """
    places = _checked(states, part, n_steps)
    if places[0].type == "cpu":
        if any(p.type != "cpu" for p in places):
            raise ValueError(f"places of more than one type: {places}")
        return _greedy_steps_sharded_plain(states, part, n_steps)
    if any(p.type != "cuda" for p in places):
        raise ValueError(f"unsupported places {places}")
    n = len(places)
    U, nU = part["u_len"], part["n_universes"]
    n_rank_vals = int(part["n_rank_vals"])
    lib = _build.library()
    # the structs hold raw pointers: `alive` keeps the scratch they point
    # at until every launch is queued
    structs, alive = [], []
    for state, shard in zip(states, part["shards"]):
        struct, tensors = _place_struct(state, shard, U)
        structs.append(ctypes.byref(struct))
        alive.append((struct, tensors))
    # One set of candidate slots and update rows per card.  Place d writes
    # slot d and row d of its card's set; between the phases they are
    # copied to the other cards' sets (torch's copies order the two
    # cards' streams).  Places of one card need no copy: their stream
    # orders the writes before the reads.
    card_of = _cards(places)
    bufs = [_update_buffers(part, n, places[card_of.index(c)])
            for c in range(max(card_of) + 1)]
    streams = [_build.stream_of(bufs[c][1]["cnt"]) for c in card_of]

    def share(names):
        for d in range(n):
            for c, (_, t) in enumerate(bufs):
                if c != card_of[d]:
                    for k in names:
                        t[k][d].copy_(bufs[card_of[d]][1][k][d])

    def each(call, what):
        for d in range(n):
            upd, t = bufs[card_of[d]]
            with torch.cuda.device(places[d]):
                _build.check(call(d, structs[d], upd, t, streams[d]), what)

    for _ in range(n_steps):
        each(lambda d, p, upd, t, st: lib.ct_gs_candidate(
            p, U, _build.ptr(t["cand_r"]), _build.ptr(t["cand_i"]),
            _build.ptr(t["cand_any"]), d, st), "greedy_sharded candidate")
        share(("cand_r", "cand_i", "cand_any"))
        each(lambda d, p, upd, t, st: lib.ct_gs_decide(
            p, n, _build.ptr(t["cand_r"]), _build.ptr(t["cand_i"]),
            _build.ptr(t["cand_any"]), nU, n_rank_vals, st),
            "greedy_sharded decide")
        each(lambda d, p, upd, t, st: lib.ct_gs_collect(
            p, ctypes.byref(upd), d, st), "greedy_sharded collect")
        share(("cnt", "ivl_start", "ivl_end", "univ", "pair_new"))
        each(lambda d, p, upd, t, st: lib.ct_gs_apply(
            p, ctypes.byref(upd), n, st), "greedy_sharded apply")
    greedy_steps_sharded.launches += 1
    return states


greedy_steps_sharded.launches = 0


def _greedy_steps_sharded_plain(states, part, n_steps):
    """Plain-PyTorch twin of greedy_steps_sharded: catch_tpu's
    greedy_step_sharded shard by shard, its pmin and psum as reductions
    over the stacked per-shard results (gathered on the first place)."""
    shards = part["shards"]
    lead = states[0]["covered"].device
    U, nU = part["u_len"], part["n_universes"]
    n_rank_vals = int(part["n_rank_vals"])
    for _ in range(n_steps):
        offers, pair_news = [], []
        for state, c in zip(states, shards):
            dev = state["covered"].device
            need = torch.clamp(state["len_u"] - c["can_uncover"], min=0)
            prefix = sc._uncovered_prefix(state["covered"])
            S_d, P_d = c["cost"].numel(), c["set_of_pair"].numel()
            pair_new = torch.zeros(P_d, dtype=torch.int64, device=dev)
            pair_new.index_add_(0, c["pair_of_ivl"].long(),
                                prefix[c["ivl_end"].long()]
                                - prefix[c["ivl_start"].long()])
            score = torch.zeros(S_d, dtype=torch.int64, device=dev)
            score.index_add_(0, c["set_of_pair"].long() - c["base"],
                             torch.minimum(pair_new,
                                           need[c["univ_of_pair"].long()]))
            elig = (~state["in_cover"] & (c["rank_idx"] == state["cur_rank"])
                    & (score > 0))
            ratio = torch.where(elig, c["cost"] / score.to(torch.float32),
                                torch.full_like(c["cost"], float("inf")))
            if S_d:
                arg = torch.argmin(ratio)
                offer = (ratio[arg], arg + c["base"])
            else:
                offer = (torch.tensor(float("inf"), device=dev),
                         torch.tensor(c["base"], device=dev))
            offers.append(tuple(x.to(lead) for x in offer))
            pair_news.append(pair_new)
        loc_min = torch.stack([r for r, _ in offers])
        ids = torch.stack([i for _, i in offers])
        gmin = loc_min.min()
        chosen = torch.where(loc_min == gmin, ids,
                             torch.full_like(ids, _INT32_MAX)).min()
        any_elig = gmin < float("inf")

        # the chosen set's coverage delta and per-universe decrement,
        # summed over the shards (only the owner's are nonzero)
        delta = torch.zeros(U + 1, dtype=torch.int32, device=lead)
        dec = torch.zeros(nU, dtype=torch.int32, device=lead)
        for c, pair_new in zip(shards, pair_news):
            sop = c["set_of_pair"].long()
            ch = chosen.to(sop.device)
            w = (sop[c["pair_of_ivl"].long()] == ch).to(torch.int32)
            part_delta = torch.zeros(U + 1, dtype=torch.int32,
                                     device=sop.device)
            part_delta.index_add_(0, c["ivl_start"].long(), w)
            part_delta.index_add_(0, c["ivl_end"].long(), -w)
            part_dec = torch.zeros(nU, dtype=torch.int32, device=sop.device)
            part_dec.index_add_(0, c["univ_of_pair"].long(), torch.where(
                sop == ch, pair_new, 0).to(torch.int32))
            delta += part_delta.to(lead)
            dec += part_dec.to(lead)
        newly = torch.cumsum(delta[:U], 0) > 0

        for state, c in zip(states, shards):
            dev = state["covered"].device
            need = torch.clamp(state["len_u"] - c["can_uncover"], min=0)
            active = (need > 0).any()
            pick = active & any_elig.to(dev)
            adv = active & ~any_elig.to(dev)
            cur_rank = state["cur_rank"]
            state["stop"].copy_(~active
                                | (adv & (cur_rank + 1 >= n_rank_vals)))
            cur_rank += adv.to(torch.int32)
            state["covered"] |= newly.to(dev) & pick
            state["len_u"] -= torch.where(pick, dec.to(dev), 0)
            local = int(chosen) - c["base"]
            if 0 <= local < c["cost"].numel():
                state["in_cover"][local] |= pick
            if part["n_sets"]:
                at = torch.clamp(state["n_chosen"],
                                 max=part["n_sets"] - 1).long()
                state["order"][at] = torch.where(
                    pick, chosen.to(dev).to(torch.int32), state["order"][at])
            state["n_chosen"] += pick.to(torch.int32)
    return states


si.KERNELS.update(greedy_sharded=greedy_steps_sharded)


def solve_instance_sharded(inst, mesh=None, n_devices=None, device=None):
    """Solve a SetCoverInstance on a mesh of places.

    Returns dense set indices in pick order (np.int32), identical to
    ops.set_cover.solve_instance's at any number of places.

    Args:
        inst: catch_tpu_torch.ops.set_cover.SetCoverInstance
        mesh: parallel.mesh.Mesh; built from n_devices if None
        n_devices: places when mesh is None (default: all visible)
        device: the type of the mesh built here, 'cuda' (the default)
            or 'cpu'

    K11 init_covered runs once on the lead over all intervals, and its
    result is replicated; then dispatches of K18 steps until the stop
    flag, reading back only that flag, and the order at the end.
    Reaching the dispatch bound without a stop raises.  Books the wall
    time of the partition and its placement, and of the steps, as the
    phases solve_sharded:partition and solve_sharded:steps.

    Replaces catch_tpu/parallel/set_cover.py solve_instance_sharded
    (:239-270).
    """
    if inst.n_sets == 0 or inst.u_len == 0 or len(inst.ivl_start) == 0:
        return np.empty(0, dtype=np.int32)
    if np.all(inst.can_uncover >= inst.u_size):
        return np.empty(0, dtype=np.int32)
    if mesh is None:
        mesh = make_mesh(n_devices, "cuda" if device is None else device)
    t0 = time.time()
    part = place_partition(partition_instance(inst, mesh.size),
                           inst.can_uncover, mesh)

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32)).to(
            mesh.lead)

    covered = sc.init_covered(put(inst.ivl_start), put(inst.ivl_end),
                              int(inst.u_len))
    states = initial_states(covered, put(inst.u_size), part)
    t0 = si._mark_places(mesh.places, "solve_sharded:partition", t0)
    for _ in range(sc._dispatch_bound(inst.n_sets, inst.n_rank_vals)):
        greedy_steps_sharded(states, part, sc._STEPS_PER_DISPATCH)
        if bool(states[0]["stop"]):
            break
    else:
        raise RuntimeError("the sharded solver reached its dispatch bound "
                           "without reaching its stop")
    order = states[0]["order"][:int(states[0]["n_chosen"])].cpu().numpy()
    si._mark_places(mesh.places, "solve_sharded:steps", t0)
    return order
