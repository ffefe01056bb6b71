"""Carry searcher state across packages.

This system has no weights.  The state a scan reads is the encoded
probe set, its seed parameters and the span scan's minimizer join table;
`searcher_from_reference` builds the port's ProbeSearcher from those
fields as catch_tpu's ProbeSearcher holds them (numpy arrays and ints),
so both packages scan and join with exactly the same state.  The
set-cover solvers read an instance: `instance_from_reference` copies
one from catch_tpu's fields into the port's SetCoverInstance.  The
sharded solver reads a partition and a state per place:
`partition_from_reference` strips the pads from catch_tpu's
`_partition_instance` output, and `sharded_states_from_reference` turns
the state tuple of its `greedy_step_sharded`, stacked over the shards,
into the port's per-place states, so both packages step from the same
state.  The clustering and the near-duplicate filter read MinHash
state instead:
`signature_matrix` turns either package's signatures into the tensor
the clustering holds, and `minhash_params` draws the near-duplicate
filter's hash parameters from either package's MinHashFamily.  The
module reads plain fields and imports nothing of catch_tpu.
"""

import numpy as np
import torch

from catch_tpu_torch.ops import encode
from catch_tpu_torch.ops.cover import CoverModel, ProbeSearcher
from catch_tpu_torch.ops.minhash import MERSENNE_P
from catch_tpu_torch.ops.set_cover import SetCoverInstance

__all__ = ["REFERENCE_FIELDS", "reference_arrays", "searcher_from_reference",
           "INSTANCE_FIELDS", "instance_from_reference",
           "partition_from_reference", "sharded_states_from_reference",
           "signature_matrix", "minhash_params"]

# The fields of catch_tpu.ops.cover.ProbeSearcher that the scan reads.
REFERENCE_FIELDS = ("probe_codes", "probe_lens", "alphabet_lut", "k_seed",
                    "seed_mode", "Lmax", "lcf_static", "K_static", "fast_ok",
                    "island_of_exact_match", "join_h", "join_p", "join_pos",
                    "join_params")

# The fields of a set-cover instance (catch_tpu.ops.set_cover.
# SetCoverInstance); the others are ints.
INSTANCE_FIELDS = ("n_sets", "n_universes", "u_size", "can_uncover",
                   "ivl_start", "ivl_end", "pair_of_ivl", "set_of_pair",
                   "univ_of_pair", "cost", "rank_idx", "n_rank_vals",
                   "u_len", "pos_univ_offsets")
_INSTANCE_ARRAYS = ("u_size", "can_uncover", "ivl_start", "ivl_end",
                    "pair_of_ivl", "set_of_pair", "univ_of_pair", "cost",
                    "rank_idx", "pos_univ_offsets")


def reference_arrays(searcher):
    """The scan state of a ProbeSearcher (of either package) as a dict
    of numpy arrays and Python scalars keyed by REFERENCE_FIELDS.  The
    join table is built first where the searcher has not built it."""
    if getattr(searcher, "_join_h", None) is None:
        searcher._build_join_table()
    return dict(
        probe_codes=np.asarray(searcher.probe_codes, dtype=np.uint8),
        probe_lens=np.asarray(searcher.probe_lens, dtype=np.int32),
        alphabet_lut=np.asarray(searcher.alphabet.lut, dtype=np.uint8),
        k_seed=int(searcher.k_seed), seed_mode=str(searcher.seed_mode),
        Lmax=int(searcher.Lmax), lcf_static=int(searcher.lcf_static),
        K_static=(None if searcher.K_static is None
                  else int(searcher.K_static)),
        fast_ok=bool(searcher.fast_ok),
        island_of_exact_match=int(
            searcher.model.island_of_exact_match or 0),
        join_h=np.asarray(searcher._join_h, dtype=np.uint64),
        join_p=np.asarray(searcher._join_p, dtype=np.int64),
        join_pos=np.asarray(searcher._join_pos, dtype=np.int64),
        join_params=tuple(int(x) for x in searcher._join_params()))


def searcher_from_reference(arrays, device=None, mesh=None):
    """A catch_tpu_torch ProbeSearcher holding the given scan state.

    `arrays` maps REFERENCE_FIELDS to values (see reference_arrays);
    `device` is where its span scan runs, `mesh` the mesh its scans
    spread over.  The searcher has no Probe
    objects; `probes` is None, and the scans read the probe count from
    probe_codes.
    """
    missing = [f for f in REFERENCE_FIELDS if f not in arrays]
    if missing:
        raise KeyError(f"searcher state lacks fields {missing}")
    s = ProbeSearcher.__new__(ProbeSearcher)
    lut = np.asarray(arrays["alphabet_lut"], dtype=np.uint8)
    s.model = CoverModel(mismatches=arrays["K_static"],
                         lcf_thres=arrays["lcf_static"],
                         island_of_exact_match=arrays[
                             "island_of_exact_match"])
    s.stats = {"candidates": 0}
    s.device = device
    s.mesh = mesh
    s.probes = None
    s.probe_codes = np.ascontiguousarray(arrays["probe_codes"],
                                         dtype=np.uint8)
    s.probe_lens = np.asarray(arrays["probe_lens"], dtype=np.int32)
    s.empty = s.probe_codes.shape[0] == 0
    s.alphabet = encode.Alphabet(lut, int(np.count_nonzero(lut)))
    for f in ("k_seed", "seed_mode", "Lmax", "lcf_static", "K_static",
              "fast_ok"):
        setattr(s, f, arrays[f])
    s._join_h = np.asarray(arrays["join_h"], dtype=np.uint64)
    s._join_p = np.asarray(arrays["join_p"], dtype=np.int64)
    s._join_pos = np.asarray(arrays["join_pos"], dtype=np.int64)
    s._join_kw = tuple(arrays["join_params"])
    return s


def instance_from_reference(inst):
    """The port's SetCoverInstance with the fields of a set-cover
    instance of either package (numpy arrays and ints, as
    catch_tpu.ops.set_cover.build_instance makes them), copied, so both
    packages solve the same instance."""
    missing = [f for f in INSTANCE_FIELDS if not hasattr(inst, f)]
    if missing:
        raise KeyError(f"set-cover instance lacks fields {missing}")
    return SetCoverInstance(**{
        f: (np.array(getattr(inst, f)) if f in _INSTANCE_ARRAYS
            else int(getattr(inst, f))) for f in INSTANCE_FIELDS})


def partition_from_reference(ref, inst):
    """The port's partition (parallel.set_cover.partition_instance's
    dict, numpy arrays) of the instance `inst`, from the output `ref` of
    catch_tpu's _partition_instance: per shard the real prefix of every
    padded array.  A padded pair holds the set id 2^31 - 1, a padded
    interval points at the shard's last (dummy) pair slot, and the sets
    past the instance's last hold the never-eligible rank n_rank_vals."""
    n_shards, nP_loc = ref["set_of_pair"].shape
    S, S_loc = int(inst.n_sets), int(ref["S_loc"])
    int32_max = np.iinfo(np.int32).max
    shards = []
    for d in range(n_shards):
        n_pairs = int(np.sum(ref["set_of_pair"][d] != int32_max))
        n_ivls = int(np.sum(ref["pair_of_ivl"][d] != nP_loc - 1))
        n_sets = max(0, min(S_loc, S - d * S_loc))
        shard = {k: np.ascontiguousarray(ref[k][d][:n_ivls])
                 for k in ("ivl_start", "ivl_end", "pair_of_ivl")}
        shard.update({k: np.ascontiguousarray(ref[k][d][:n_pairs])
                      for k in ("set_of_pair", "univ_of_pair")})
        shard.update(cost=np.ascontiguousarray(ref["cost_loc"][d][:n_sets]),
                     rank_idx=np.ascontiguousarray(
                         ref["rank_loc"][d][:n_sets]),
                     base=d * S_loc)
        shards.append(shard)
    return dict(
        shards=shards, S_loc=S_loc, n_sets=S,
        n_universes=int(inst.n_universes), u_len=int(inst.u_len),
        n_rank_vals=int(ref["n_rank_vals"]))


def sharded_states_from_reference(state, part, places):
    """The port's per-place states from the state of catch_tpu's
    greedy_step_sharded, every element stacked over the shards (leading
    axis n): (covered [n, U_pad], len_u [n, nU_pad], in_cover_loc
    [n, S_loc], order [n, S_pad], n_chosen [n], cur_rank [n], stop [n]).
    Place d takes row d, cut to the instance's real sizes (`part`: the
    port's partition), as tensors on places[d]."""
    covered, len_u, in_cover, order, n_chosen, cur_rank, stop = (
        np.asarray(x) for x in state)
    states = []
    for d, (shard, place) in enumerate(zip(part["shards"], places)):
        def put(x, dtype):
            return torch.from_numpy(np.array(x, dtype=dtype)).to(place)
        states.append(dict(
            covered=put(covered[d][:part["u_len"]], np.bool_),
            len_u=put(len_u[d][:part["n_universes"]], np.int32),
            in_cover=put(in_cover[d][:len(shard["cost"])], np.bool_),
            order=put(order[d][:part["n_sets"]], np.int32),
            n_chosen=put(n_chosen[d], np.int32),
            cur_rank=put(cur_rank[d], np.int32),
            stop=put(stop[d], np.bool_)))
    return states


def signature_matrix(signatures, device):
    """int32 [n, N] tensor on `device` of a list of n MinHash signature
    tuples of length N, as make_signatures_with_minhash of either
    package gives them.  Raises where a value lies outside
    [0, 2^31 - 1), which int32 could not hold or no hash gives."""
    mat = np.asarray(signatures, dtype=np.int64)
    if mat.size == 0:
        mat = mat.reshape(len(signatures), 0)
    if mat.ndim != 2:
        raise ValueError("signatures must be n tuples of one length")
    if mat.size and (mat.min() < 0 or mat.max() >= MERSENNE_P):
        raise ValueError("signature values must lie in [0, 2^31 - 1)")
    return torch.from_numpy(mat.astype(np.int32)).to(device)


def minhash_params(family, H):
    """int64 [H, 2] table of (a, b) for H hash functions, drawn from
    `family`'s generator (a MinHashFamily of either package) in the order
    of BatchedNearNeighbor._build_minhash: for each function in turn, a
    in [1, 2^31 - 1] and then b in [0, 2^31 - 1]."""
    ab = np.empty((H, 2), dtype=np.int64)
    for t in range(H):
        ab[t, 0] = int(family._rng.integers(1, MERSENNE_P + 1))
        ab[t, 1] = int(family._rng.integers(0, MERSENNE_P + 1))
    return ab
