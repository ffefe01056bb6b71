# Copied from catch_tpu/filters/near_duplicate.py.
"""Removes near-duplicate probes using LSH.

Probes sorted by multiplicity (descending, stable by first occurrence) so the
highest-coverage representative of each near-duplicate cluster is kept;
greedy include/exclude sweep over LSH near-neighbor lookups with an
exact distance re-check; Hamming and MinHash variants.  Must run
before/instead of DuplicateFilter (multiplicity matters).

Output order is deterministic (inclusion order), and hashing
randomness is seeded per filter instance.  Each filter takes the
`device` of its LSH engine: the MinHash variant computes its signatures
there (the minhash_sig kernel on CUDA, its twin on the CPU); the
Hamming variant runs on the host.
"""

import numpy as np

from catch_tpu_torch.device import resolve_device
from catch_tpu_torch.filters.base import BaseFilter
from catch_tpu_torch.utils import lsh

__all__ = ["NearDuplicateFilter", "NearDuplicateFilterWithHammingDistance",
           "NearDuplicateFilterWithMinHash"]


class NearDuplicateFilter(BaseFilter):
    """Removes near-duplicates using LSH (abstract; see subclasses)."""

    # True where the filter launches kernels on a CUDA device: the
    # designer's group pipeline then serializes it on the one device
    # lock with the set-cover scan.
    device_bound = False

    def __init__(self, k, reporting_prob=0.80, *, device):
        self.k = k
        self.reporting_prob = reporting_prob
        self.device = resolve_device(device)

    def _filter(self, input):
        # Multiplicity sort: stable descending by count, ties keep
        # first-occurrence order (dict insertion order + stable sort)
        occurrences = {}
        for p in input:
            occurrences[p] = occurrences.get(p, 0) + 1
        input_sorted = [p for p, _ in
                        sorted(occurrences.items(), key=lambda t: t[1],
                               reverse=True)]
        unique = list(occurrences.keys())

        # A fresh identically-seeded family per call: every group draws
        # the same hash functions (as forked workers inheriting one RNG
        # state would), and concurrent grouped calls never share
        # mutable RNG state.
        family = self._make_family()

        # Batched LSH engine: identical hash functions, buckets, and
        # exact re-check as the generic lookup, computed as matrix ops
        # (the generic per-probe path is ~L*k Python hash calls per
        # probe and dominated multi-Mbp designs).  Falls back to the
        # generic path for point sets it does not support.
        batched = lsh.BatchedNearNeighbor(
            family, self.k, self.dist_thres,
            self.reporting_prob, [p.seq_str for p in unique],
            device=self.device)
        if batched.supported():
            return self._sweep_batched(input_sorted, unique, batched)
        return self._sweep_generic(input_sorted, unique, family)

    def _sweep_batched(self, input_sorted, unique, batched):
        """Greedy include/exclude over the batched neighbor engine:
        only still-included probes are queried (excluded ones never
        are), exactly as the generic sweep."""
        row_of = {p: i for i, p in enumerate(unique)}
        excluded = np.zeros(len(unique), dtype=bool)
        included = np.zeros(len(unique), dtype=bool)
        # Rows whose fate is still open: the only rows a query can
        # act on (it excludes not-yet-included neighbors), so the
        # lookup skips distance checks for everything else — without
        # this, dense groups re-evaluate every already-excluded
        # near-duplicate on every query (superlinear).
        active = np.ones(len(unique), dtype=bool)
        to_include = []
        for p in input_sorted:
            i = row_of[p]
            assert not included[i]
            if excluded[i]:
                continue
            to_include.append(p)
            included[i] = True
            active[i] = False
            nbr = batched.neighbors_of(i, keep=active)
            excluded[nbr] = True
            active[nbr] = False

        assert int(included.sum() + excluded.sum()) == len(input_sorted)
        assert not np.any(included & excluded)
        return to_include

    def _sweep_generic(self, input_sorted, unique, family=None):
        nnl = lsh.NearNeighborLookup(
            family if family is not None else self._make_family(),
            self.k, self.dist_thres, self.dist_fn,
            self.reporting_prob)
        nnl.add([p.seq_str for p in unique])
        by_seq = {p.seq_str: p for p in unique}

        to_include = []
        included = set()
        excluded = set()
        for p in input_sorted:
            assert p not in included
            if p in excluded:
                continue
            to_include.append(p)
            included.add(p)
            for near_dup_seq in nnl.query(p.seq_str):
                near_dup = by_seq[near_dup_seq]
                if near_dup not in included:
                    excluded.add(near_dup)

        assert len(included | excluded) == len(input_sorted)
        assert len(included & excluded) == 0
        return to_include


def hamming_dist(a, b):
    """Hamming distance between two equal-length sequences (strings)."""
    arr_a = np.frombuffer(a.encode("ascii"), dtype=np.uint8)
    arr_b = np.frombuffer(b.encode("ascii"), dtype=np.uint8)
    return int(np.sum(arr_a != arr_b))


class NearDuplicateFilterWithHammingDistance(NearDuplicateFilter):
    """Near-duplicate removal by Hamming distance (k=20 concatenation)."""

    def __init__(self, dist_thres, probe_length, seed=0, *, device):
        super().__init__(k=20, device=device)
        self._make_family = lambda: lsh.HammingDistanceFamily(
            probe_length, rng=np.random.default_rng(seed))
        self.dist_thres = dist_thres
        self.dist_fn = hamming_dist


class jaccard_dist_fn:
    """Exact k-mer Jaccard distance between two sequences."""

    def __init__(self, kmer_size):
        self.kmer_size = kmer_size

    def __call__(self, a, b):
        k = self.kmer_size
        a_kmers = {a[i:i + k] for i in range(len(a) - k + 1)}
        b_kmers = {b[i:i + k] for i in range(len(b) - k + 1)}
        jaccard_sim = float(len(a_kmers & b_kmers)) / len(a_kmers | b_kmers)
        return 1.0 - jaccard_sim


class NearDuplicateFilterWithMinHash(NearDuplicateFilter):
    """Near-duplicate removal by MinHash k-mer Jaccard (k=3)."""

    def __init__(self, dist_thres, kmer_size=10, seed=0, *, device):
        super().__init__(k=3, device=device)
        self.device_bound = self.device.type == "cuda"
        self._make_family = lambda: lsh.MinHashFamily(
            kmer_size, rng=np.random.default_rng(seed))
        self.dist_thres = dist_thres
        self.dist_fn = jaccard_dist_fn(kmer_size)
