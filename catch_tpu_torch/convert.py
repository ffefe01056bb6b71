"""Carry searcher state across packages.

This system has no weights.  The state a scan reads is the encoded
probe set and its seed parameters; `searcher_from_reference` builds the
port's ProbeSearcher from those fields as catch_tpu's ProbeSearcher
holds them (numpy arrays and ints), so both packages can scan with
exactly the same state.  It reads plain fields and imports nothing of
catch_tpu.
"""

import numpy as np

from catch_tpu_torch.ops import encode
from catch_tpu_torch.ops.cover import CoverModel, ProbeSearcher

__all__ = ["REFERENCE_FIELDS", "reference_arrays", "searcher_from_reference"]

# The fields of catch_tpu.ops.cover.ProbeSearcher that the scan reads.
REFERENCE_FIELDS = ("probe_codes", "probe_lens", "alphabet_lut", "k_seed",
                    "seed_mode", "Lmax", "lcf_static", "K_static", "fast_ok",
                    "island_of_exact_match")


def reference_arrays(searcher):
    """The scan state of a ProbeSearcher (of either package) as a dict
    of numpy arrays and Python scalars keyed by REFERENCE_FIELDS."""
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
            searcher.model.island_of_exact_match or 0))


def searcher_from_reference(arrays):
    """A catch_tpu_torch ProbeSearcher holding the given scan state.

    `arrays` maps REFERENCE_FIELDS to values (see reference_arrays).
    The searcher has no Probe objects; `probes` is None, and the scan
    reads the probe count from probe_codes.
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
    s.probes = None
    s.probe_codes = np.ascontiguousarray(arrays["probe_codes"],
                                         dtype=np.uint8)
    s.probe_lens = np.asarray(arrays["probe_lens"], dtype=np.int32)
    s.empty = s.probe_codes.shape[0] == 0
    s.alphabet = encode.Alphabet(lut, int(np.count_nonzero(lut)))
    for f in ("k_seed", "seed_mode", "Lmax", "lcf_static", "K_static",
              "fast_ok"):
        setattr(s, f, arrays[f])
    return s
