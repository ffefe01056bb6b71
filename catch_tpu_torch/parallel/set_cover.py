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

The kernel is K18 greedy_sharded (csrc/greedy_sharded.cu), K13's
incremental step on each shard: each shard is regrouped set-major once a
solve (shard_index), each place keeps its pairs' uncovered counts on the
card through a call, and a pick updates only the chosen set's tiles.  It
shares its scan, score pass and decide step with K12 and K13
(csrc/greedy.cuh).  Each phase is one launch sequence for all places of
a card; the wrapper queues a whole dispatch of steps with no host
synchronisation.  Places of one card share their candidate slots and
update rows; between distinct cards the wrapper copies each place's slot
and row to the other cards after the phase that writes them.  Those
copies were run only with all places on one card (the card tests force
them there).  On a mesh across processes each rank places only its own
shards, and the slots and rows are exchanged between the ranks instead,
through parallel/distributed.py's host-staged collectives: two host
synchronisations a step.

Left out from catch_tpu: the power-of-two pads, the dummy pair, set and
universe slots (a shard may hold no set at all; it then offers
(+inf, its base id) and launches nothing over its empty arrays), and
the (U + 1)-long coverage delta summed over the mesh every step.  The
wrapper runs its plain-PyTorch twin (_greedy_steps_sharded_plain) for
CPU tensors and the kernel for CUDA tensors, counts its launches in
`launches`, and is registered in scan_instance.KERNELS.
"""

import ctypes
import logging
import time

import numpy as np
import torch

from catch_tpu_torch import _build
from catch_tpu_torch.ops import scan_instance as si
from catch_tpu_torch.ops import set_cover as sc
from catch_tpu_torch.parallel import distributed
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

logger = logging.getLogger(__name__)


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
    n_universes, u_len and n_rank_vals.

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
    return dict(shards=shards, S_loc=S_loc, n_sets=S,
                n_universes=int(inst.n_universes), u_len=int(inst.u_len),
                n_rank_vals=int(inst.n_rank_vals))


def place_partition(part, can_uncover, mesh):
    """The partition on the mesh: shard d's arrays as tensors on place d,
    each with a replica of can_uncover (int32[nU]), for this process's
    places only (all of them without a process group).  Returns a copy
    of `part` whose `shards` hold the placed shards, in mesh order, and
    whose `mesh` is `mesh`."""
    if len(part["shards"]) != mesh.size:
        raise ValueError(f"{len(part['shards'])} shards for a mesh of "
                         f"{mesh.size} places")
    cu = np.ascontiguousarray(can_uncover, dtype=np.int32)
    shards = []
    for d in mesh.own:
        shard, place = part["shards"][d], mesh.places[d]
        placed = {k: torch.from_numpy(shard[k]).to(place)
                  for k in _SHARD_ARRAYS}
        placed["can_uncover"] = torch.from_numpy(cu).to(place, copy=True)
        placed["base"] = int(shard["base"])
        shards.append(placed)
    return dict(part, shards=shards, mesh=mesh)


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


# struct GsPlace of csrc/greedy_sharded.cu, field by field: each a device
# pointer (0 for null) or an int64.
_PLACE_FIELDS = (
    "covered", "len_u", "in_cover", "cur_rank", "stop", "order", "n_chosen",
    "can_uncover", "cost", "rank_idx", "ivl_start", "ivl_end", "pair_bounds",
    "set_bounds", "univ_of_pair", "ivl_rec", "tile_ptr", "tile_ivl",
    "set_grp", "grp_tile", "grp_off", "grp_ivl", "prefix", "pair_new",
    "blk_r", "blk_i", "blk_any", "dec", "S", "P", "nb", "lg", "base", "slot")
# The shard's regrouped arrays in the record (the rest of set_major_index
# is its tile index and set tiles); can_uncover, cost and rank_idx are
# the shard's own.
_REGROUPED = ("ivl_start", "ivl_end", "pair_bounds", "set_bounds",
              "univ_of_pair", "ivl_rec", "tile_ptr", "tile_ivl", "set_grp",
              "grp_tile", "grp_off", "grp_ivl")
# What a place writes for the others: its candidate slot, its update row.
_SLOT = ("cand_r", "cand_i", "cand_any")
_ROW = ("cnt", "tile", "off", "ivl", "univ", "pnew")


class _GsCard(ctypes.Structure):
    """struct GsCard of csrc/greedy_sharded.cu."""
    _POINTERS = _SLOT + _ROW
    _fields_ = ([(k, ctypes.c_void_p) for k in _POINTERS]
                + [(k, ctypes.c_int64) for k in ("cap_g", "cap_e", "cap_p")])


def shard_index(shard, U):
    """K18's regrouping of a placed shard over U positions:
    set_cover.set_major_index of its arrays on local set ids
    (set_of_pair - base), with max_pieces, the most interval entries of
    one set over its tiles.  Built at the first call and kept in the
    shard under "_k18_index" (built again if ivl_start was replaced);
    None for a shard without sets, which builds nothing."""
    S = shard["cost"].numel()
    if S == 0:
        return None

    def build():
        idx = sc.set_major_index(
            shard["ivl_start"], shard["ivl_end"], shard["pair_of_ivl"],
            shard["set_of_pair"] - shard["base"], shard["univ_of_pair"], S, U)
        idx["max_pieces"] = int(torch.diff(
            idx["grp_off"][idx["set_grp"].long()]).max())
        return idx

    return sc._kept_index(shard, "_k18_index", U, build)


def _place_record(state, shard, idx, w, slot):
    """The int64 fields of place `slot`'s GsPlace."""
    fields = dict(state, can_uncover=shard["can_uncover"],
                  cost=shard["cost"], rank_idx=shard["rank_idx"],
                  prefix=w["prefix"], pair_new=w["pair_new"],
                  blk_r=w["blk_r"], blk_i=w["blk_i"], blk_any=w["blk_any"],
                  dec=w["dec"])
    if idx is not None:
        fields.update({k: idx[k] for k in _REGROUPED})
    fields.update(S=shard["cost"].numel(), P=shard["set_of_pair"].numel(),
                  nb=w["nb"], lg=w["lg"], base=shard["base"], slot=slot)
    values = [fields.get(k, 0) for k in _PLACE_FIELDS]
    return [v if isinstance(v, int) else v.data_ptr() for v in values]


def _card_buffers(n, caps, device):
    """(struct, tensors) of one card's candidate slots and update rows
    for a mesh of n places; caps: the most tiles, interval entries and
    pairs of one set (at least 1 each)."""
    cap_g, cap_e, cap_p = caps

    def ints(*shape):
        return torch.empty(shape, dtype=torch.int32, device=device)

    t = dict(cand_r=torch.empty(n, dtype=torch.float32, device=device),
             cand_i=ints(n), cand_any=ints(n), cnt=ints(n, 3),
             tile=ints(n, cap_g), off=ints(n, cap_g + 1),
             ivl=ints(n, cap_e, 2), univ=ints(n, cap_p), pnew=ints(n, cap_p))
    struct = _GsCard(**{k: t[k].data_ptr() for k in _GsCard._POINTERS},
                     cap_g=cap_g, cap_e=cap_e, cap_p=cap_p)
    return struct, t


def _cards(places):
    """For each place the index of its card among the distinct cards of
    `places`, in order of first appearance.  Places of one card share
    their candidate slots and update rows."""
    seen = {}
    return [seen.setdefault(p, len(seen)) for p in places]


def _pack(t, names, d):
    """Slot or row d of a card's buffers `t` (the fields `names`), as one
    int32 row."""
    return torch.cat([t[k][d].reshape(-1).view(torch.int32) for k in names])


def _unpack(t, names, rows):
    """Write every slot or row of `rows` (int32[n, width], _pack's rows of
    all places) into a card's buffers `t`."""
    o = 0
    for k in names:
        width = t[k][0].numel()
        t[k].copy_(rows[:, o:o + width].contiguous().view(t[k].dtype)
                   .reshape(t[k].shape))
        o += width


def greedy_steps_sharded(states, part, n_steps):
    """Run n_steps sharded greedy steps.

    states: one dict per place of this process (see initial_states),
    updated in place; every tensor of place d lies on that place.  part:
    the placed partition (place_partition).  Returns states.  Steps
    after the stop run in full and change nothing but cur_rank.  On the
    card, the first call also keeps each shard regrouped in the shard
    (shard_index); past set_cover._K12_PIECE_LIMIT pieces that raises
    ValueError before any launch.

    On one process no step waits for the host.  Where part's mesh spans
    ranks, each step makes two exchanges between the ranks, each a host
    synchronisation (parallel/distributed.py): after the offer phase the
    ranks all-gather their places' candidate slots, and after the pick
    the update rows, so every rank holds the chosen set's owner row; the
    card's path makes one more a call, which agrees on the rows' sizes.
    They are counted in `exchanges`; a process without ranks makes none.

    Replaces catch_tpu/parallel/set_cover.py greedy_step_sharded
    (:114-181) and the loop of _solve_sharded_jit (:184-236); the kernel
    is csrc/greedy_sharded.cu (K13's incremental step on each shard: each
    place's pair counts recomputed once a call from its replica, then 4
    launches a step a card whatever the number of places on it).
    """
    places = _checked(states, part, n_steps)
    if places[0].type == "cpu":
        if any(p.type != "cpu" for p in places):
            raise ValueError(f"places of more than one type: {places}")
        return _greedy_steps_sharded_plain(states, part, n_steps)
    if any(p.type != "cuda" for p in places):
        raise ValueError(f"unsupported places {places}")
    mesh = _ranks_mesh(part)
    n_loc = len(places)
    # every place's global index: its candidate slot and update row
    slots = list(mesh.own) if mesh else list(range(n_loc))
    n = mesh.size if mesh else n_loc
    U = part["u_len"]
    shards = part["shards"]
    idxs = [shard_index(shard, U) for shard in shards]
    caps = [max([1] + [i[k] for i in idxs if i is not None])
            for k in ("max_groups", "max_pieces", "max_pairs")]
    if mesh:
        # the rows are exchanged whole, so every rank sizes them alike
        caps = distributed.all_reduce_max(
            torch.tensor(caps, dtype=torch.int64)).tolist()
        greedy_steps_sharded.exchanges += 1
    lib = _build.library()
    # One GsCard per card.  Place d writes slot d and row d of its card's;
    # between the phases they are copied to the other cards' (torch's
    # copies order the two cards' streams), or exchanged between the
    # ranks.  Places of one card need no copy: their stream orders the
    # writes before the reads.
    card_of = _cards(places)
    n_cards = max(card_of) + 1
    bufs = [_card_buffers(n, caps, places[card_of.index(c)])
            for c in range(n_cards)]
    # `calls` holds raw pointers: `alive` keeps the tensors they point at
    # until every launch is queued
    calls, alive = [], []
    for c in range(n_cards):
        dev = places[card_of.index(c)]
        mine = [i for i in range(n_loc) if card_of[i] == c]
        records, max_nb, max_P = [], 0, 0
        for i in mine:
            shard, idx = shards[i], idxs[i]
            S, P = shard["cost"].numel(), shard["set_of_pair"].numel()
            w = sc._step_scratch(dev, U, P, S,
                                 idx["max_pairs"] if idx else 0, 1)
            records.append(_place_record(states[i], shard, idx, w, slots[i]))
            max_nb, max_P = max(max_nb, w["nb"]), max(max_P, P)
            alive.append(w)
        with torch.cuda.device(dev):
            table = torch.tensor(records, dtype=torch.int64).pin_memory().to(
                dev, non_blocking=True)
            tiles = torch.empty(max(1, len(mine) * -(-U // sc._SCAN_TILE)),
                                dtype=torch.int32, device=dev)
        alive.append((table, tiles))
        calls.append((dev, (_build.ptr(table), len(mine),
                            ctypes.byref(bufs[c][0]), n, U,
                            part["n_universes"], int(part["n_rank_vals"]),
                            part["S_loc"], max_nb, max_P,
                            _build.ptr(tiles)), _build.stream_of(tiles)))

    def share(names):
        for i, d in enumerate(slots):
            for c, (_, t) in enumerate(bufs):
                if c != card_of[i]:
                    for k in names:
                        t[k][d].copy_(bufs[card_of[i]][1][k][d])

    def exchange(names):
        own = torch.stack([_pack(bufs[card_of[i]][1], names, d).to(places[0])
                           for i, d in enumerate(slots)])
        rows = distributed.all_gather_rows(own, mesh.counts())
        for _, t in bufs:
            _unpack(t, names, rows)
        greedy_steps_sharded.exchanges += 1

    def run(stages):
        for dev, args, stream in calls:
            with torch.cuda.device(dev):
                _build.check(lib.ct_gs_steps(*args, stages, stream),
                             "greedy_sharded")

    st = sc._STAGES
    run(st["recompute"])
    # with one card and one rank there is nothing to copy between the
    # phases
    phases = ([(st["score"] | st["decide"] | st["update"], ())]
              if n_cards == 1 and not mesh else
              [(st["score"], _SLOT), (st["decide"], _ROW),
               (st["update"], ())])
    move = exchange if mesh else share
    for _ in range(n_steps):
        for stages, names in phases:
            run(stages)
            if names:
                move(names)
    greedy_steps_sharded.launches += 1
    return states


greedy_steps_sharded.launches = 0
greedy_steps_sharded.exchanges = 0


def _ranks_mesh(part):
    """part's mesh where it spans ranks, else None."""
    mesh = part.get("mesh")
    return mesh if mesh is not None and mesh.spans_ranks else None


def _greedy_steps_sharded_plain(states, part, n_steps):
    """Plain-PyTorch twin of greedy_steps_sharded: catch_tpu's
    greedy_step_sharded shard by shard, its pmin and psum as reductions
    over the stacked per-shard results (gathered on the first place).
    Across ranks the offers are all-gathered and the coverage delta and
    per-universe decrement summed over the ranks, two exchanges a step
    (catch_tpu's pmin and psum between processes)."""
    shards = part["shards"]
    mesh = _ranks_mesh(part)
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
        if mesh:
            rows = distributed.all_gather_rows(torch.stack(
                [loc_min.view(torch.int32).long(), ids.long()], 1),
                mesh.counts())
            loc_min = rows[:, 0].int().view(torch.float32)
            ids = rows[:, 1]
            greedy_steps_sharded.exchanges += 1
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
        if mesh:
            both = distributed.all_reduce_sum(torch.cat([delta, dec]))
            delta, dec = both[:U + 1], both[U + 1:]
            greedy_steps_sharded.exchanges += 1
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


def _k18_fits(part):
    """Whether every shard's regrouping (shard_index) of the host
    partition `part` holds fewer than set_cover._K12_PIECE_LIMIT pieces;
    where one would not, logs the warning of the host route, which the
    caller then takes before any launch."""
    for shard in part["shards"]:
        n = int(sc._k12_pieces(torch.from_numpy(shard["ivl_start"]),
                               torch.from_numpy(shard["ivl_end"])).sum(
            dtype=torch.int64))
        if n >= sc._K12_PIECE_LIMIT:
            logger.warning("K18's overlap index exceeds int32; falling back "
                           "to the host solver")
            return False
    return True


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

    On a mesh across processes every rank calls it alike: each
    partitions the whole instance, places only its own shards, runs K11
    on its own lead, and reads the stop flag and the order from its own
    replica (the replicas are equal); the steps exchange across ranks
    (greedy_steps_sharded).  Every route below is decided from the
    whole instance, so the same on every rank.

    Where any shard's regrouping would hold set_cover._K12_PIECE_LIMIT
    pieces or more (_k18_fits, counted on the host on any device), the
    host lazy solver runs instead, with a warning and before any launch:
    catch_tpu's sharded solver builds no index and solves such an
    instance.  The picks are the same on an instance in the order that
    every constructor gives (set_cover.build_instance,
    build_instance_from_cover_arrays, scan_instance.instance_to_host):
    pairs in set-major order, one pair for each (set, universe), the
    intervals grouped by pair, and the intervals of a pair disjoint
    (tests/test_torch_instance_order.py).  On an instance out of that
    order the lazy solver's order can differ.

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
    part = partition_instance(inst, mesh.size)
    if not _k18_fits(part):
        return sc._solve_host_lazy(inst)
    part = place_partition(part, inst.can_uncover, mesh)

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32)).to(
            mesh.lead)

    covered = sc.init_covered(put(inst.ivl_start), put(inst.ivl_end),
                              int(inst.u_len))
    states = initial_states(covered, put(inst.u_size), part)
    t0 = si._mark_places(mesh.local_places, "solve_sharded:partition", t0)
    for _ in range(sc._dispatch_bound(inst.n_sets, inst.n_rank_vals)):
        greedy_steps_sharded(states, part, sc._STEPS_PER_DISPATCH)
        if bool(states[0]["stop"]):
            break
    else:
        raise RuntimeError("the sharded solver reached its dispatch bound "
                           "without reaching its stop")
    order = states[0]["order"][:int(states[0]["n_chosen"])].cpu().numpy()
    si._mark_places(mesh.local_places, "solve_sharded:steps", t0)
    return order
