"""Carry searcher state across packages.

This system has no weights.  The state a scan reads is the encoded
probe set, its seed parameters and the span scan's minimizer join table;
`searcher_from_reference` builds the port's ProbeSearcher from those
fields as catch_tpu's ProbeSearcher holds them (numpy arrays and ints),
so both packages scan and join with exactly the same state.  The
clustering and the near-duplicate filter read MinHash state instead:
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

__all__ = ["REFERENCE_FIELDS", "reference_arrays", "searcher_from_reference",
           "signature_matrix", "minhash_params"]

# The fields of catch_tpu.ops.cover.ProbeSearcher that the scan reads.
REFERENCE_FIELDS = ("probe_codes", "probe_lens", "alphabet_lut", "k_seed",
                    "seed_mode", "Lmax", "lcf_static", "K_static", "fast_ok",
                    "island_of_exact_match", "join_h", "join_p", "join_pos",
                    "join_params")


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


def searcher_from_reference(arrays, device=None):
    """A catch_tpu_torch ProbeSearcher holding the given scan state.

    `arrays` maps REFERENCE_FIELDS to values (see reference_arrays);
    `device` is where its span scan runs.  The searcher has no Probe
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
