# Copied from catch_tpu/ops/cover.py (CoverModel, choose_seed_length and the ProbeSearcher constructor state).
"""Probe cover model and the searcher state that the device scan reads.

The hybridization model follows catch_tpu/ops/cover.py: a probe covers a
target window when they share a substring of length >= lcf_thres with
at most `mismatches` mismatches that contains an exact run of at least
max(k_seed, island_of_exact_match) matches.  Only the state the scan
(ops/scan_instance.py) reads is kept here; the host scan paths and
find_probe_covers_flat are not ported.
"""

import numpy as np

from catch_tpu_torch.ops import encode

__all__ = ["CoverModel", "ProbeSearcher", "choose_seed_length"]


class CoverModel:
    """Hybridization model parameters (the default LCS model).

    mismatches/lcf_thres/island_of_exact_match follow the reference
    contract.  custom_fn, if given, is a host callable with the
    reference's 6-argument signature; the port does not run it yet.
    """

    def __init__(self, mismatches=None, lcf_thres=None,
                 island_of_exact_match=0, custom_fn=None):
        self.mismatches = mismatches
        self.lcf_thres = lcf_thres
        self.island_of_exact_match = island_of_exact_match
        self.custom_fn = custom_fn

    def __repr__(self):
        if self.custom_fn is not None:
            return f"CoverModel(custom={self.custom_fn})"
        return (f"CoverModel(m={self.mismatches}, lcf={self.lcf_thres}, "
                f"island={self.island_of_exact_match})")


def choose_seed_length(probe_lens, mismatches, lcf_thres, min_k=20, k=20):
    """Choose the seed (k-mer) length, mirroring the reference dispatcher.

    Returns (k_seed, mode) where mode is 'pigeonhole' or 'random'.
    """
    lens = set(probe_lens)
    if not lens:
        return k, "random"
    L = next(iter(lens))
    if (mismatches is None or lcf_thres is None or len(lens) > 1
            or lcf_thres < L):
        return k, "random"
    if mismatches == 0:
        kp = L
    else:
        kp = int(L / mismatches)
        if kp == float(L) / mismatches:
            kp -= 1
        while L % kp != 0:
            kp -= 1
    if kp < min_k:
        return k, "random"
    return kp, "pigeonhole"


class ProbeSearcher:
    """A fixed probe set, encoded for the device scan.

    Fields read by ops/scan_instance.py: probes, probe_lens, k_seed,
    seed_mode, alphabet, probe_codes, Lmax, lcf_static, K_static,
    fast_ok and stats.
    """

    def __init__(self, probes, model, kmer_probe_map_k=20):
        """
        Args:
            probes: list of catch_tpu_torch.probe.Probe
            model: CoverModel
            kmer_probe_map_k: min_k and k for seed-length selection
                (reference SetCoverFilter's kmer_probe_map_k)
        """
        self.model = model
        # Candidate pairs admitted to verification, for run statistics.
        self.stats = {"candidates": 0}
        # Dedup by sequence, preserving first-occurrence order (the
        # reference's map keys by Probe which hashes by sequence).
        seen = {}
        for p in probes:
            if p.seq_str not in seen:
                seen[p.seq_str] = p
        self.probes = list(seen.values())
        self.probe_lens = np.array([len(p) for p in self.probes],
                                   dtype=np.int32)
        if len(self.probes) == 0:
            self.empty = True
            return
        self.empty = False

        m = None if model.custom_fn is not None else model.mismatches
        lcf = None if model.custom_fn is not None else model.lcf_thres
        self.k_seed, self.seed_mode = choose_seed_length(
            self.probe_lens.tolist(), m, lcf,
            min_k=kmer_probe_map_k, k=kmer_probe_map_k)
        if self.seed_mode == "random" and self.k_seed > self.probe_lens.min():
            raise ValueError("k is larger than the length of a probe")

        self.alphabet = encode.make_alphabet(
            [p.seq_bytes for p in self.probes])
        probe_codes = [self.alphabet.encode(p.seq_bytes)
                       for p in self.probes]
        self.Lmax = int(self.probe_lens.max())
        self.probe_codes = encode.pad_and_stack(probe_codes, self.Lmax)

        # Effective lcf threshold for the scan (None -> unbounded)
        self.lcf_static = (int(lcf) if lcf is not None
                           else int(self.Lmax) + 1)
        self.K_static = int(m) if m is not None else None

        # Fast path validity (the exact-match count alone decides
        # covers when lcf >= the probe length and seeding is
        # guaranteed); checked per sequence against its length.
        lens_equal = len(set(self.probe_lens.tolist())) == 1
        self.fast_ok = (
            model.custom_fn is None
            and model.island_of_exact_match == 0
            and lcf is not None and lens_equal and lcf >= self.Lmax
            and (self.seed_mode == "pigeonhole"
                 or (m is not None and m == 0)))
