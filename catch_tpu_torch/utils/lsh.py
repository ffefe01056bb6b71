# Copied from catch_tpu/utils/lsh.py.
"""Locality-sensitive hashing machinery.

HammingDistanceFamily (random coordinate sampling), MinHashFamily
(universal hash over k-mers, signature = N smallest values sorted,
Jaccard estimation by merging sorted signatures), HashConcatenation (AND
construction), and NearNeighborLookup (OR construction with L tables
chosen from the desired reporting probability, exact distance re-check
on query).

Hash functions operate on plain strings (callers pass probe
sequences); k-mer hashing is vectorized with numpy, and randomness comes
from an explicit ``rng`` (numpy Generator) so that probe-set outputs are
reproducible.

BatchedNearNeighbor computes the MinHash signature matrix with the CUDA
kernel minhash_sig (catch_tpu_torch/ops/minhash.py) on the device it is
given, and with the kernel's plain-PyTorch twin on the CPU.  catch_tpu's
opt-in for that device path (CATCH_TPU_LSH_DEVICE_MIN_CELLS) and its
quiet numpy fallback are left out: the signatures are the same bit for
bit, and a failing kernel raises.
"""

from collections import defaultdict
import math

import numpy as np
import torch

from catch_tpu_torch.convert import minhash_params
from catch_tpu_torch.ops.minhash import minhash_sig

__all__ = ["HammingDistanceFamily", "MinHashFamily", "HashConcatenation",
           "NearNeighborLookup", "BatchedNearNeighbor", "batch_kmer_codes"]

_MERSENNE_P = 2**31 - 1


class HammingDistanceFamily:
    """LSH family for Hamming distance: hash = random coordinate."""

    def __init__(self, dim, rng=None):
        self.dim = dim
        self._rng = rng if rng is not None else np.random.default_rng(0)

    def make_h(self):
        i = int(self._rng.integers(0, self.dim))

        def h(x):
            assert len(x) == self.dim
            return x[i]
        return h

    def P1(self, dist):
        """Lower bound on collision probability within ``dist``."""
        return 1.0 - float(dist) / float(self.dim)


def _kmer_int_codes(s, k):
    """All k-mers of s as integers (base-256 polynomial mod 2^61-1).

    Deterministic and vectorized: a stable integer per k-mer.
    """
    b = np.frombuffer(s.encode("ascii"), dtype=np.uint8).astype(np.uint64)
    n = len(b) - k + 1
    if n <= 0:
        return np.empty(0, dtype=np.uint64)
    P = np.uint64(1000003)
    MOD = np.uint64(_MERSENNE_P)
    # Rolling polynomial over a window of k bytes; intermediate values
    # stay below 2^51 so uint64 arithmetic never overflows
    acc = np.zeros(n, dtype=np.uint64)
    for j in range(k):
        acc = (acc * P + b[j:j + n]) % MOD
    return acc


class MinHashFamily:
    """MinHash family over k-mers: signature = N smallest hash values."""

    def __init__(self, kmer_size, N=1, use_fast_str_hash=False, rng=None):
        self.kmer_size = kmer_size
        self.N = N
        # use_fast_str_hash accepted for API parity; hashing here is
        # always deterministic and vectorized
        self._rng = rng if rng is not None else np.random.default_rng(0)

    def make_h(self):
        p = _MERSENNE_P
        a = int(self._rng.integers(1, p + 1))
        b = int(self._rng.integers(0, p + 1))

        def h(s):
            assert self.kmer_size <= len(s)
            codes = _kmer_int_codes(s, self.kmer_size)
            vals = ((np.uint64(a) * (codes % np.uint64(p))
                     + np.uint64(b)) % np.uint64(p))
            num_kmers = len(vals)
            if num_kmers < self.N:
                # Repeat k-mers until at least N hashes exist
                reps = -(-self.N // num_kmers)
                vals = np.tile(vals, reps)[:max(self.N, num_kmers)]
            if self.N == 1:
                return (int(vals.min()),)
            smallest = np.sort(np.partition(vals, self.N - 1)[:self.N])
            return tuple(int(v) for v in smallest)
        return h

    def P1(self, dist):
        """Collision probability = Jaccard similarity = 1 - dist."""
        return 1.0 - dist

    def estimate_jaccard_dist(self, sig_a, sig_b):
        """Estimate Jaccard distance from two sorted signatures.

        The estimator walks the merged multiset of the two signatures
        in value order, pairing equal values (intersection) and
        counting everything once (union), stopping after N union
        elements or when either signature is exhausted; the estimate is
        1 - |intersection|/|union| over the walked prefix.  Here the
        walk is evaluated in closed form over value blocks: per
        distinct value, min(count_a, count_b) paired elements come
        first, the |count_a - count_b| unpaired ones count only while
        the other signature still has larger values left, and the
        N-truncation slices block-wise with pairs consumed first.
        """
        a = np.asarray(sig_a, dtype=np.int64)
        b = np.asarray(sig_b, dtype=np.int64)
        va, ca = np.unique(a, return_counts=True)
        vb, cb = np.unique(b, return_counts=True)
        vals = np.union1d(va, vb)
        fa = np.zeros(len(vals), dtype=np.int64)
        fb = np.zeros(len(vals), dtype=np.int64)
        fa[np.searchsorted(vals, va)] = ca
        fb[np.searchsorted(vals, vb)] = cb
        pairs = np.minimum(fa, fb)
        singles = np.maximum(fa, fb) - pairs
        # The walk covers value blocks up to the smaller signature
        # maximum; unpaired elements of one signature count only while
        # the other side has larger values remaining.
        lim = min(int(va[-1]), int(vb[-1]))
        walked = vals <= lim
        other_max = np.where(fa > fb, int(vb[-1]), int(va[-1]))
        singles_eff = np.where(walked & (vals < other_max), singles, 0)
        pairs_eff = np.where(walked, pairs, 0)
        block = pairs_eff + singles_eff
        before = np.concatenate(([0], np.cumsum(block)[:-1]))
        room = np.clip(self.N - before, 0, None)
        intersect_count = int(np.minimum(pairs_eff, room).sum())
        union_count = int(np.minimum(block, room).sum())
        return 1.0 - float(intersect_count) / union_count


class HashConcatenation:
    """Concatenated hash functions (AND construction)."""

    def __init__(self, family, k):
        self.family = family
        self.k = k
        self.hs = [family.make_h() for _ in range(k)]

    def g(self, x):
        return tuple(h(x) for h in self.hs)


def _mod_mersenne(y, tmp=None):
    """Exact y % (2^31 - 1) for uint64 y < 2^62, without division.

    Two shift-add folds bring y below 2^31 + 1; one conditional
    subtract finishes.  Equal to numpy's ``%`` but several times
    faster on the signature matrices below.  Mutates ``y`` in place
    (callers pass a fresh product); ``tmp`` is an optional scratch
    buffer of the same shape to avoid reallocation in hot loops.
    """
    M = np.uint64(_MERSENNE_P)
    s = np.uint64(31)
    if tmp is None:
        tmp = np.empty_like(y)
    for _ in range(2):
        np.right_shift(y, s, out=tmp)
        np.bitwise_and(y, M, out=y)
        np.add(y, tmp, out=y)
    # y < 2^31 + 1 here; subtract M where y >= M
    np.subtract(y, M, out=y, where=y >= M)
    return y


def batch_kmer_codes(seqs_b, k):
    """k-mer integer codes for a batch of equal-length sequences.

    seqs_b: uint8[U, Ls] ASCII bytes.  Returns uint64[U, Ls-k+1] with
    row u equal to _kmer_int_codes of sequence u (same polynomial, same
    modulus) — the batched form of the per-sequence hash.
    """
    U, Ls = seqs_b.shape
    n = Ls - k + 1
    if n <= 0:
        return np.empty((U, 0), dtype=np.uint64)
    P = np.uint64(1000003)
    b = seqs_b.astype(np.uint64)
    acc = np.zeros((U, n), dtype=np.uint64)
    tmp = np.empty((U, n), dtype=np.uint64)
    for j in range(k):
        np.multiply(acc, P, out=acc)
        np.add(acc, b[:, j:j + n], out=acc)
        _mod_mersenne(acc, tmp)
    return acc


class BatchedNearNeighbor:
    """Vectorized equivalent of NearNeighborLookup over a fixed point
    set: same hash functions (identical RNG draw order), same bucket
    partition per table, same exact-distance re-check — so
    ``neighbors_of`` returns exactly the set ``query`` would, but the
    whole signature matrix is computed with a few hundred numpy matrix
    ops instead of ~L*k Python-level hash calls per point.

    Supports the two families the near-duplicate filters use with
    batched signatures (MinHashFamily with N=1, HammingDistanceFamily
    on equal-length points); ``supported()`` reports False otherwise
    and callers fall back to the generic lookup.  `device` is where
    the MinHash signatures are computed.
    """

    def __init__(self, family, k, dist_thres, reporting_prob, seqs, *,
                 device):
        self.device = device
        self.family = family
        self.k = k
        self.dist_thres = dist_thres
        P1 = family.P1(dist_thres)
        if P1 == 1.0:
            self.num_tables = 1
        else:
            self.num_tables = int(math.ceil(
                math.log(1.0 - reporting_prob, 1.0 - math.pow(P1, k))))
        self.seqs = seqs
        self.U = len(seqs)
        self._ok = self.U > 0
        self._sig = None
        if not self._ok:
            return
        if isinstance(family, MinHashFamily) and family.N == 1:
            self._ok = min(len(s) for s in seqs) >= family.kmer_size
            if self._ok:
                self._build_minhash()
        elif isinstance(family, HammingDistanceFamily):
            self._ok = all(len(s) == family.dim for s in seqs)
            if self._ok:
                self._build_hamming()
        else:
            self._ok = False
        if self._ok:
            self._build_tables()
            self._build_dist()

    def supported(self):
        return self._ok

    # -- signatures ----------------------------------------------------

    def _byte_matrix_groups(self):
        """Group point indices by sequence length -> (idx, bytes)."""
        by_len = {}
        for i, s in enumerate(self.seqs):
            by_len.setdefault(len(s), []).append(i)
        for ln, idxs in sorted(by_len.items()):
            b = np.frombuffer(
                "".join(self.seqs[i] for i in idxs).encode("ascii"),
                dtype=np.uint8).reshape(len(idxs), ln)
            yield np.asarray(idxs, dtype=np.int64), b

    def _build_minhash(self):
        """Signature matrix: column t = min over k-mers of the t-th
        universal hash (a*code + b) % p — the batched form of
        MinHashFamily.make_h's closure, with the SAME rng draw order
        (table-major, then concatenation position).  The minima come
        from the minhash_sig kernel on self.device (k-mer codes and
        hash values lie below 2^31 - 1, so int32 holds them)."""
        fam = self.family
        H = self.num_tables * self.k
        ab = torch.from_numpy(minhash_params(fam, H).astype(np.int32)).to(
            self.device)
        sig = np.empty((self.U, H), dtype=np.uint64)
        for idxs, b in self._byte_matrix_groups():
            codes = torch.from_numpy(batch_kmer_codes(
                b, fam.kmer_size).astype(np.int32)).to(self.device)
            sig[idxs] = minhash_sig(codes, ab).cpu().numpy()
        self._sig = sig

    def _build_hamming(self):
        """Signature matrix = sampled coordinates (one rng draw per
        hash function, table-major order, as in make_h)."""
        fam = self.family
        H = self.num_tables * self.k
        coords = np.array([int(fam._rng.integers(0, fam.dim))
                           for _ in range(H)], dtype=np.int64)
        b = np.frombuffer("".join(self.seqs).encode("ascii"),
                          dtype=np.uint8).reshape(self.U, fam.dim)
        self._bytes = b
        self._sig = b[:, coords].astype(np.uint64)

    # -- bucket tables -------------------------------------------------

    def _build_tables(self):
        """Per table: group rows by their k signature columns (the
        dict-key partition of the generic lookup, via lexsort)."""
        self._tables = []
        for j in range(self.num_tables):
            cols = self._sig[:, j * self.k:(j + 1) * self.k]
            order = np.lexsort(cols.T[::-1])
            sc = cols[order]
            newgrp = np.concatenate(
                [[True], (sc[1:] != sc[:-1]).any(axis=1)])
            grp_of_sorted = np.cumsum(newgrp) - 1
            grp_of_row = np.empty(self.U, dtype=np.int64)
            grp_of_row[order] = grp_of_sorted
            bounds = np.concatenate(
                [np.flatnonzero(newgrp), [self.U]]).astype(np.int64)
            self._tables.append((order, grp_of_row, bounds))

    # -- exact distances -----------------------------------------------

    def _build_dist(self):
        fam = self.family
        if isinstance(fam, HammingDistanceFamily):
            self._dist_batch = self._hamming_batch
            return
        # Exact k-mer sets per point for Jaccard: pack each k-mer
        # bijectively into uint64 when the observed alphabet allows
        # (size^k < 2^63), else keep per-pair string sets.
        k = fam.kmer_size
        seen = np.zeros(256, dtype=bool)
        for _, b in self._byte_matrix_groups():
            seen[np.unique(b)] = True
        size = int(seen.sum())
        if size == 0 or size ** k >= 2 ** 63:
            self._dist_batch = self._jaccard_batch_strings
            return
        lut = np.zeros(256, dtype=np.uint64)
        lut[np.flatnonzero(seen)] = np.arange(size, dtype=np.uint64)
        vals_parts = [None] * self.U
        for idxs, b in self._byte_matrix_groups():
            n = b.shape[1] - k + 1
            acc = np.zeros((len(idxs), n), dtype=np.uint64)
            c = lut[b]
            for j in range(k):
                acc = acc * np.uint64(size) + c[:, j:j + n]
            # Per-row unique, vectorized (a per-row np.unique loop was
            # ~5 s per 280k-probe group): sort rows, mask repeats,
            # slice the row-major compaction per row
            sa = np.sort(acc, axis=1)
            keepm = np.ones(sa.shape, dtype=bool)
            keepm[:, 1:] = sa[:, 1:] != sa[:, :-1]
            counts = keepm.sum(axis=1)
            flat = sa[keepm]
            ends = np.cumsum(counts)
            starts_r = ends - counts
            for row, i in enumerate(idxs):
                vals_parts[i] = flat[starts_r[row]:ends[row]]
        offs = np.zeros(self.U + 1, dtype=np.int64)
        for i, v in enumerate(vals_parts):
            offs[i + 1] = offs[i] + len(v)
        self._kset_vals = np.concatenate(vals_parts) if self.U else \
            np.empty(0, dtype=np.uint64)
        self._kset_offs = offs
        self._dist_batch = self._jaccard_batch_packed

    def _hamming_batch(self, qi, cand):
        return (self._bytes[cand] != self._bytes[qi]).sum(axis=1)

    def _jaccard_batch_packed(self, qi, cand):
        v, o = self._kset_vals, self._kset_offs
        q = v[o[qi]:o[qi + 1]]
        sizes = o[cand + 1] - o[cand]
        # Gather all candidates' k-mer values with one fancy index
        # (a per-candidate Python slice loop dominated dense-group
        # sweeps)
        starts = o[cand]
        total = int(sizes.sum())
        idx = np.repeat(
            starts - np.concatenate(([0], np.cumsum(sizes)[:-1])),
            sizes) + np.arange(total, dtype=np.int64)
        flat = v[idx]
        pos = np.searchsorted(q, flat)
        hit = (pos < len(q)) & (q[np.minimum(pos, len(q) - 1)] == flat)
        bounds = np.concatenate([[0], np.cumsum(sizes)])
        # (cast before reduceat: np.add on bools is logical-or)
        inter = np.add.reduceat(hit.astype(np.int64), bounds[:-1]) \
            if len(cand) else np.empty(0, dtype=np.int64)
        inter = np.where(sizes > 0, inter, 0)
        union = len(q) + sizes - inter
        return 1.0 - inter / union

    def _jaccard_batch_strings(self, qi, cand):
        k = self.family.kmer_size
        q = self.seqs[qi]
        q_kmers = {q[i:i + k] for i in range(len(q) - k + 1)}
        out = np.empty(len(cand), dtype=np.float64)
        for t, c in enumerate(cand):
            s = self.seqs[c]
            s_kmers = {s[i:i + k] for i in range(len(s) - k + 1)}
            out[t] = 1.0 - (len(q_kmers & s_kmers)
                            / len(q_kmers | s_kmers))
        return out

    # -- query ---------------------------------------------------------

    def neighbors_of(self, qi, keep=None):
        """Indices of stored points within dist_thres of point qi
        (excluding qi itself) — the batched ``query``.

        `keep` (optional bool[U]) pre-filters candidates before the
        exact distance evaluation; rows with keep=False are never
        reported.  Callers that only act on a known subset (the
        near-duplicate sweep only excludes still-active rows) pass it
        so dense buckets don't re-pay distance checks for rows whose
        fate is already decided — that re-checking made the sweep
        superlinear in dense groups.
        """
        parts = []
        for order, grp_of_row, bounds in self._tables:
            g = grp_of_row[qi]
            parts.append(order[bounds[g]:bounds[g + 1]])
        cand = np.unique(np.concatenate(parts))
        cand = cand[cand != qi]
        if keep is not None and len(cand):
            cand = cand[keep[cand]]
        if len(cand) == 0:
            return cand
        d = self._dist_batch(qi, cand)
        return cand[d <= self.dist_thres]


class NearNeighborLookup:
    """R-near neighbor reporting (OR construction over L tables)."""

    def __init__(self, family, k, dist_thres, dist_fn, reporting_prob):
        """L = ceil(log_{1-P1^k}(1 - reporting_prob)) tables."""
        self.family = family
        self.k = k
        self.dist_thres = dist_thres
        self.dist_fn = dist_fn

        P1 = self.family.P1(dist_thres)
        if P1 == 1.0:
            self.num_tables = 1
        else:
            self.num_tables = int(math.ceil(
                math.log(1.0 - reporting_prob, 1.0 - math.pow(P1, k))))

        self.hashtables = []
        self.hashtables_g = []
        for _ in range(self.num_tables):
            g = HashConcatenation(self.family, self.k)
            self.hashtables.append(defaultdict(list))
            self.hashtables_g.append(g)

    def add(self, pts):
        for j in range(self.num_tables):
            ht = self.hashtables[j]
            g = self.hashtables_g[j].g
            for p in pts:
                ht[g(p)].append(p)

    def query(self, q):
        """Return stored points within dist_thres of q (validated by
        dist_fn; may miss some, never reports a non-neighbor)."""
        neighbors = set()
        for j in range(self.num_tables):
            ht = self.hashtables[j]
            g = self.hashtables_g[j].g
            for p in ht[g(q)]:
                if self.dist_fn(q, p) <= self.dist_thres:
                    neighbors.add(p)
        return neighbors
