# Copied from catch_tpu/utils/cluster.py.
"""Clustering input sequences by MinHash similarity (Mash-style).

MinHash signatures with one shared hash function, Mash-distance -> Jaccard-distance conversion,
average-linkage hierarchical clustering (scipy) and 'simple' connected
components with an early-stop heuristic; the
``cluster_with_minhash_signatures`` facade.

All pairwise distances are computed on the device: the signatures live
as an (n, N) int32 tensor, and the CUDA kernel minhash_caps
(catch_tpu_torch/ops/minhash.py; its plain-PyTorch twin on the CPU)
evaluates the capped-union MinHash estimator for every pair of a query
block and a representative block, as distances, threshold codes, counts
or each query's best representative.  The DFS, the linkage and the
greedy leader pass stay on the host.  Left out from catch_tpu, as TPU
workarounds: the power-of-two padding of waves and representative lists
and the copy of row 0 used as row padding; neither changes a result.
"""

from collections import defaultdict
import logging

import numpy as np
import torch

from catch_tpu_torch.convert import signature_matrix
from catch_tpu_torch.ops.minhash import (minhash_assign, minhash_caps,
                                         minhash_codes, minhash_dists)
from catch_tpu_torch.utils import lsh

logger = logging.getLogger(__name__)

__all__ = ["make_signatures_with_minhash", "cluster_with_minhash_signatures",
           "find_connected_components",
           "cluster_hierarchically_from_dist_matrix",
           "cluster_greedy_from_signatures"]


def make_signatures_with_minhash(family, seqs):
    """Signature per sequence using one shared MinHash function.

    Args:
        family: lsh.MinHashFamily
        seqs: dict mapping sequence header to sequence

    Returns:
        dict mapping header to signature tuple
    """
    h = family.make_h()
    return {name: h(seq) for name, seq in seqs.items()}


def _jaccard_dist_from_mash_dist(mash_dist, k):
    """Mash distance (≈1-ANI) -> Jaccard distance (from Eq. 4 of Ondov
    et al. 2016)."""
    return 1.0 - 1.0 / (2.0 * np.exp(k * mash_dist) - 1)


def _min_cap(N, thr):
    """Smallest capped-intersection count whose float32 distance
    1 - cap/N is <= thr (catch_tpu's integer form of the threshold)."""
    d32 = (np.float32(1.0)
           - np.arange(N + 1, dtype=np.float32) / np.float32(N))
    ok = np.flatnonzero(d32.astype(np.float64) <= thr)
    return int(ok[0]) if len(ok) else N + 1


class _DeviceDistances:
    """Device-resident signature matrix with batched distances."""

    # Query rows per kernel call of the all-pairs matrices: each call
    # holds a (_BLOCK, n) output on the device.
    _BLOCK = 1024

    def __init__(self, signatures, device):
        self.n = len(signatures)
        self.N = len(signatures[0]) if self.n else 0
        self.sigs = signature_matrix(signatures, device)

    def row(self, j):
        """Distances of signature j to all signatures (np.float32[n])."""
        return minhash_dists(self.sigs[j:j + 1], self.sigs)[0].cpu().numpy()

    def _blocks(self, fn, dtype):
        out = np.empty((self.n, self.n), dtype=dtype)
        for j0 in range(0, self.n, self._BLOCK):
            out[j0:j0 + self._BLOCK] = fn(
                self.sigs[j0:j0 + self._BLOCK]).cpu().numpy()
        return out

    def full_matrix(self):
        """The full (n, n) distance matrix, computed in row blocks."""
        return self._blocks(lambda q: minhash_dists(q, self.sigs),
                            np.float32)

    def code_matrix(self, threshold, early_stop):
        """(n, n) uint8 adjacency codes — the 1-byte readback form the
        connected-components DFS needs: 0 = farther than the clustering
        threshold, 1 = within it but beyond the early-stop threshold
        (explored by the DFS), 2 = within both (absorbed without
        exploration).  The thresholds become minimum capped counts, so
        the comparisons are exact integer ones."""
        cap_thr = _min_cap(self.N, threshold)
        cap_early = _min_cap(self.N, early_stop)
        return self._blocks(
            lambda q: minhash_codes(q, self.sigs, cap_thr, cap_early),
            np.uint8)


# Above this many sequences the all-pairs methods are replaced by the
# greedy leader pass: the dense adjacency is O(n^2) in device compute
# AND readback (6.4e9 pairs at 80k sequences — hours), while the
# leader pass is O(n x n_clusters).
_ALL_PAIRS_MAX = 8192

# Queries per greedy wave.  Semantic, not a tuning knob: a borderline
# query's cluster depends on the wave width (see below).
_WAVE = 2048


def cluster_greedy_from_signatures(signatures, threshold_jaccard, N, *,
                                   device):
    """Leader clustering (Mash-screen / UCLUST style) over MinHash
    signatures: sequences are processed in input order in device-sized
    waves; each query joins the nearest cluster representative (ties
    to the earliest) among those that existed at the START of its wave,
    else — if no such representative is within the Jaccard threshold —
    it is matched against leaders created earlier in its OWN wave, and
    failing that becomes a new representative.

    Semantics vs the connected-components method: single-link chains
    through intermediate genomes do NOT merge clusters here (each
    member is within the threshold of its representative directly).
    For clade-structured inputs the outputs coincide; when they differ,
    this method over-splits, which is the safe direction for design
    (every cluster is still designed in full — at worst more probes).
    A BORDERLINE query — within the threshold of a pre-wave
    representative but nearer to a leader created in its own wave —
    takes the pre-wave representative, so its cluster membership can
    depend on the wave width; every assignment is still within the
    threshold of its representative, which is the property design
    correctness rests on.  O(n x n_clusters) total distance
    evaluations.  The pairs are evaluated on `device`.

    Returns a list of index lists, descending size order (stable).
    """
    n = len(signatures)
    if n == 0:
        return []
    sigs = signature_matrix(signatures, device)
    cap_thr = _min_cap(N, threshold_jaccard)

    rep_rows = []                      # global index of each leader
    assign = np.full(n, -1, dtype=np.int64)
    for w0 in range(0, n, _WAVE):
        wave = sigs[w0:w0 + _WAVE]
        Q = wave.shape[0]
        unassigned = np.arange(Q, dtype=np.int64)
        if rep_rows:
            reps = sigs[torch.tensor(rep_rows, device=sigs.device)]
            best, ok = minhash_assign(wave, reps, len(rep_rows), cap_thr)
            best = best.cpu().numpy()
            ok = ok.cpu().numpy()
            assign[w0:w0 + Q][ok] = best[ok]
            unassigned = np.flatnonzero(~ok)
        if len(unassigned):
            # Leader scan within the chunk's leftovers (only sequences
            # no existing representative claimed — usually a handful,
            # the whole chunk only while clusters are first being
            # discovered): one (L, L) capped-count block, then a serial
            # host pass so a leftover can join a leader created earlier
            # in the SAME chunk (otherwise the first chunk would make
            # every sequence its own cluster).
            L = len(unassigned)
            blk = wave[torch.from_numpy(unassigned).to(sigs.device)]
            caps = minhash_caps(blk, blk).cpu().numpy().astype(np.int32)
            local_leaders = []         # positions within `unassigned`
            for ii in range(L):
                gi = w0 + unassigned[ii]
                if local_leaders:
                    row = caps[ii, local_leaders]
                    jj = int(np.argmax(row))
                    if row[jj] >= cap_thr:
                        assign[gi] = assign[w0 + unassigned[
                            local_leaders[jj]]]
                        continue
                local_leaders.append(ii)
                assign[gi] = len(rep_rows)
                rep_rows.append(gi)

    clusters = defaultdict(list)
    for i, c in enumerate(assign):
        clusters[int(c)].append(i)
    out = sorted(clusters.values(), key=len, reverse=True)
    return out


def cluster_hierarchically_from_dist_matrix(dist_matrix, threshold):
    """Average-linkage clustering of a condensed distance matrix."""
    from scipy.cluster import hierarchy

    if len(dist_matrix) == 0:
        return [[0]]

    linkage = hierarchy.linkage(dist_matrix, method="average")
    clusters = hierarchy.fcluster(linkage, threshold, criterion="distance")

    first_clust_num = min(clusters)
    num_clusters = max(clusters) + 1 - first_clust_num
    elements_in_cluster = defaultdict(list)
    for i, clust_num in enumerate(clusters):
        elements_in_cluster[clust_num].append(i)
    cluster_sizes = {c: len(elements_in_cluster[c])
                     for c in range(first_clust_num,
                                    num_clusters + first_clust_num)}
    out = []
    for clust_num, _ in sorted(cluster_sizes.items(),
                               key=lambda t: t[1], reverse=True):
        out.append(elements_in_cluster[clust_num])
    return out


def find_connected_components(n, row_dist_fn, threshold,
                              early_stop_threshold=None):
    """Connected components by thresholded distances, with per-row
    batched distance evaluation.

    Args:
        n: number of elements
        row_dist_fn: function j -> np.array of distances from j to all
            elements (only entries for unvisited candidates are used)
        threshold: adjacency threshold (Jaccard distance)
        early_stop_threshold: if d(i, j) <= this, j is marked visited
            without exploring its neighborhood (default: jaccard dist of
            mash 0.02 at k=12)

    Returns:
        list of sorted index lists, in decreasing size order
    """
    if early_stop_threshold is None:
        early_stop_threshold = _jaccard_dist_from_mash_dist(0.02, 12)

    indices_to_consider = set(range(n))

    def dfs(i):
        visited = set()
        to_visit = [i]
        seen = {i}
        while to_visit:
            j = to_visit.pop()
            if j in visited:
                continue
            visited.add(j)
            candidates = [k for k in indices_to_consider if k not in seen]
            if not candidates:
                continue
            dists = row_dist_fn(j)
            for k in candidates:
                dist = dists[k]
                if dist <= threshold:
                    if dist <= early_stop_threshold:
                        visited.add(k)
                        seen.add(k)
                    else:
                        to_visit.append(k)
                        seen.add(k)
        return visited

    previously_visited = set()
    components = []
    for i in range(n):
        if i in previously_visited:
            continue
        cc = dfs(i)
        previously_visited.update(cc)
        indices_to_consider -= cc
        components.append(sorted(cc))
    components.sort(key=len, reverse=True)
    return components


def create_condensed_dist_matrix(n, row_dist_fn):
    """Condensed (scipy-form) distance matrix from batched row evals."""
    if n <= 1:
        return np.empty(0, dtype=np.float64)
    out = np.empty(n * (n - 1) // 2, dtype=np.float64)
    for i in range(n - 1):
        row = row_dist_fn(i)
        start = i * n - i * (i + 1) // 2 - i - 1
        out[start + i + 1:start + n] = row[i + 1:n]
    return out


def cluster_with_minhash_signatures(seqs, k=12, N=100, threshold=0.1,
                                    cluster_method="simple", *, device):
    """Cluster sequences by MinHash signatures, with the pairwise work on
    `device`.

    Args:
        seqs: dict mapping sequence header to sequence
        k: k-mer size for hashing
        N: signature size
        threshold: clustering threshold in average nucleotide
            dissimilarity (1-ANI); converted internally to Jaccard
        cluster_method: 'simple' (connected components) or
            'hierarchical' (average linkage)

    Returns:
        list of collections of sequence headers, descending size order
    """
    num_seqs = len(seqs)
    logger.info("Producing signatures of %d sequences", num_seqs)
    family = lsh.MinHashFamily(k, N=N)
    signatures_map = make_signatures_with_minhash(family, seqs)

    seq_headers = list(seqs.keys())
    signatures = [signatures_map[name] for name in seq_headers]
    jaccard_dist_threshold = _jaccard_dist_from_mash_dist(threshold, k)

    if cluster_method in ("simple", "hierarchical") \
            and num_seqs > _ALL_PAIRS_MAX:
        logger.warning(
            "Input has %d sequences; the '%s' clustering method is "
            "all-pairs (quadratic) and does not complete at this scale, "
            "so the greedy leader method is used instead (see "
            "cluster_greedy_from_signatures)", num_seqs, cluster_method)
        cluster_method = "greedy"

    if cluster_method == "greedy":
        logger.info(
            "Clustering %d sequences at Jaccard distance threshold of "
            "%f with the greedy leader method", num_seqs,
            jaccard_dist_threshold)
        clusters = cluster_greedy_from_signatures(
            signatures, jaccard_dist_threshold, N, device=device)
        return [[seq_headers[i] for i in cluster_idxs]
                for cluster_idxs in clusters]

    dd = _DeviceDistances(signatures, device)

    if cluster_method == "simple":
        logger.info(
            "Clustering %d sequences at Jaccard distance threshold of %f "
            "based on connected components", num_seqs,
            jaccard_dist_threshold)
        # Precompute all pairwise adjacency codes in a few block
        # dispatches; the DFS then runs entirely on host pseudo-
        # distances that reproduce its two threshold comparisons
        # exactly (identical traversal, no per-row device roundtrips,
        # 1-byte readback per pair).
        early = _jaccard_dist_from_mash_dist(0.02, 12)
        if num_seqs > 1:
            codes = dd.code_matrix(jaccard_dist_threshold, early)
            # Translate one row at a time (the full float matrix would
            # be 8x the uint8 codes).  Code 1 exists only when the
            # threshold exceeds the early-stop value, where pseudo =
            # threshold reproduces "within threshold, beyond early".
            lut = np.array([2.0, jaccard_dist_threshold, 0.0],
                           dtype=np.float64)
            row_fn = lambda j: lut[codes[j]]  # noqa: E731
        else:
            row_fn = dd.row
        clusters = find_connected_components(
            num_seqs, row_fn, jaccard_dist_threshold,
            early_stop_threshold=early)
    elif cluster_method == "hierarchical":
        logger.info(
            "Clustering %d sequences at Jaccard distance threshold of %f "
            "using hierarchical method", num_seqs, jaccard_dist_threshold)
        dmat = dd.full_matrix()
        dist_matrix = create_condensed_dist_matrix(
            num_seqs, lambda j: dmat[j])
        clusters = cluster_hierarchically_from_dist_matrix(
            dist_matrix, jaccard_dist_threshold)
    else:
        raise ValueError(f"Unknown cluster_method '{cluster_method}'")

    return [[seq_headers[i] for i in cluster_idxs]
            for cluster_idxs in clusters]
