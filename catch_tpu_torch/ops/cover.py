# Copied from catch_tpu/ops/cover.py (CoverModel, choose_seed_length, probe_covers_sequence_by_longest_common_substring, the ProbeSearcher state, its seed join table, span API and the host scan of a custom cover function).
"""Probe cover model, the searcher state the device scans read, and the
unmerged span API.

The hybridization model follows catch_tpu/ops/cover.py: a probe covers a
target window when they share a substring of length >= lcf_thres with
at most `mismatches` mismatches that contains an exact run of at least
max(k_seed, island_of_exact_match) matches.  The design scan
(ops/scan_instance.py) reads the encoded probes; the span scan
(ops/scan_sparse.py) also reads the minimizer join table built here.
find_probe_covers_flat and find_probe_covers run the span scan on the
searcher's `device` for the default model.  A model with a custom cover
function (a Python callable run once per seed anchor of a candidate)
takes catch_tpu's per-sequence host scan instead, copied here in the
part such a model uses; that route is chosen by the model alone, never
by size or after a failure.  catch_tpu's size-based routing of the
default model to its host scan, and its fallback, are not ported.
"""

import numpy as np

from catch_tpu_torch.ops import encode
from catch_tpu_torch.utils import intervals, lcs

__all__ = ["CoverModel", "ProbeSearcher", "choose_seed_length",
           "probe_covers_sequence_by_longest_common_substring"]

# Rolling-hash multiplier for k-mer seed codes (odd 64-bit; golden
# ratio).  Collisions only add verification work, never wrong output.
_JOIN_MULT = np.uint64(0x9E3779B97F4A7C15)


class CoverModel:
    """Hybridization model parameters (the default LCS model).

    mismatches/lcf_thres/island_of_exact_match follow the reference
    contract.  custom_fn, if given, is a host callable with the
    reference's 6-argument signature; it replaces the default model and
    mismatches/lcf_thres are ignored.
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


def probe_covers_sequence_by_longest_common_substring(
        mismatches, lcf_thres, island_of_exact_match=0):
    """Host closure with the reference cover-model contract.

    The 6-argument function of a custom hybridization model that gives
    the default model's cover range around a seed anchor, from the
    host oracle utils/lcs.py; the device scans encode the same model
    directly.  Kept for API parity and for oracle tests.
    """

    def lcf(probe_seq, sequence, kmer_start, kmer_end,
            full_probe_len, full_sequence_len):
        l, start = lcs.k_lcf_around_anchor(
            probe_seq, sequence, kmer_start, kmer_end, mismatches)
        if l < min(lcf_thres, full_probe_len, full_sequence_len):
            return None
        if island_of_exact_match > 0:
            if mismatches == 0:
                exact_l = l
            else:
                exact_l, _ = lcs.k_lcf_around_anchor(
                    probe_seq, sequence, kmer_start, kmer_end, 0)
            if exact_l < island_of_exact_match:
                return None
        return (start, start + l)

    return lcf


class ProbeSearcher:
    """A fixed probe set, encoded for the device scans.

    Fields read by ops/scan_instance.py: probes, probe_lens, k_seed,
    seed_mode, alphabet, probe_codes, Lmax, lcf_static, K_static,
    fast_ok and stats; ops/scan_sparse.py also reads the join table
    (_join_h, _join_p, _join_pos, _join_kw) and device; both read mesh.
    A model with custom_fn is scanned on the host here, and no device
    scan takes it.
    """

    def __init__(self, probes, model, kmer_probe_map_k=20, *, device=None,
                 mesh=None):
        """
        Args:
            probes: list of catch_tpu_torch.probe.Probe
            model: CoverModel
            kmer_probe_map_k: min_k and k for seed-length selection
                (reference SetCoverFilter's kmer_probe_map_k)
            device: torch.device where find_probe_covers_flat and
                find_probe_covers scan the default model; they raise
                while it is None (a custom model is scanned on the host)
            mesh: optional parallel.mesh.Mesh led by `device`; with more
                than one place, the scans spread their verification
                (and the design scan its hashing and lookup) over the
                places
        """
        self.model = model
        self.device = device
        self.mesh = mesh
        self._join_h = None
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

    # ------------------------------------------------------------------
    # The seed join table (minimizer sampling)
    # ------------------------------------------------------------------
    #
    # Every qualifying cover carries a run of >= k_seed consecutive
    # exact matches: verification requires seedmax >= k_seed, and the
    # fast path admits only full-overlap candidates, where the
    # pigeonhole k-selection (> K disjoint k_seed-mers, <= K
    # mismatches) guarantees an intact k_seed run.  A (w, kj)-minimizer
    # scheme with kj + w - 1 <= k_seed therefore keeps seeding
    # exhaustive: any window of w consecutive kj-mers inside the shared
    # run selects the same minimal-hash kj-mer on the probe and the
    # sequence side (the leftmost tie-break is alignment-invariant
    # within the run), while only ~2/(w+1) of the positions on EACH side
    # are hashed into the join.

    _MINIMIZER_MIN_KJ = 12   # kj floor: 4^12 >> viral genome sizes
    _MINIMIZER_MAX_W = 20    # density floor 2/(w+1) ~ 10%

    def _rolling_hashes(self, codes_2d, k=None):
        """Rolling k-mer hashes along the last axis (default k_seed).

        Returns (hashes, valid): hashes[..., i] covers codes[..., i:i+k];
        valid marks windows free of PAD (code 0).
        """
        k = self.k_seed if k is None else k
        W = codes_2d.shape[-1] - k + 1
        if W <= 0:
            shape = codes_2d.shape[:-1] + (0,)
            return (np.zeros(shape, np.uint64), np.zeros(shape, bool))
        c = codes_2d.astype(np.uint64)
        h = np.zeros(codes_2d.shape[:-1] + (W,), dtype=np.uint64)
        ok = np.ones(h.shape, dtype=bool)
        for j in range(k):
            cj = c[..., j:j + W]
            h *= _JOIN_MULT
            h += cj
            ok &= cj > 0
        return h, ok

    def _join_params(self):
        """(kj, w) for the seed join; w == 1 disables minimizers."""
        k = self.k_seed
        if k <= self._MINIMIZER_MIN_KJ:
            return k, 1
        kj = max(self._MINIMIZER_MIN_KJ, k - self._MINIMIZER_MAX_W + 1)
        return kj, k - kj + 1

    @staticmethod
    def _minimizer_select(h, ok, w):
        """Union-of-window-minima positions for rows of hashes.

        h, ok: (..., W) hashes and validity.  Returns a boolean mask of
        selected positions (subset of ok).  Rows shorter than w select
        nothing: they cannot hold a complete window, and the k_seed-run
        requirement already excludes them.
        """
        if w <= 1:
            return ok
        W = h.shape[-1]
        if W < w:
            return np.zeros_like(ok)
        x = np.where(ok, h, np.uint64(np.iinfo(np.uint64).max))
        sw = np.lib.stride_tricks.sliding_window_view(x, w, axis=-1)
        am = sw.argmin(axis=-1) + np.arange(W - w + 1)
        sel = np.zeros_like(ok)
        np.put_along_axis(sel.reshape(-1, W),
                          am.reshape(-1, W - w + 1), True, axis=-1)
        return sel & ok

    def _build_join_table(self):
        """The probe side of the join: hashes of the selected kj-mers of
        every probe row, sorted, with their probe and offset."""
        kj, w = self._join_params()
        h, ok = self._rolling_hashes(self.probe_codes, k=kj)
        sel = self._minimizer_select(h, ok, w)
        pi, pos = np.nonzero(sel)
        hv = h[pi, pos]
        order = np.argsort(hv, kind="stable")
        self._join_h = hv[order]
        self._join_p = pi[order].astype(np.int64)
        self._join_pos = pos[order].astype(np.int64)
        self._join_kw = (kj, w)

    # ------------------------------------------------------------------
    # The host scan of a custom cover function
    # ------------------------------------------------------------------
    #
    # catch_tpu sends a model with custom_fn down its per-sequence host
    # scan (catch_tpu/ops/cover.py:680-681): phase 1 finds candidate
    # (probe, alignment) pairs, by a dense scan of every alignment for
    # small workloads or by the exact k-mer join, and phase 2 calls the
    # function once per anchor of k_seed consecutive matches.  Copied
    # here as a custom model uses it: such a model has no mismatch
    # count, so the fast path and its match-count predicate never apply.

    # Workloads below this many (alignment x probe x position) cells
    # take the dense phase 1 (the same candidates as the join).
    _HOST_PHASE1_MAX_CELLS = 1 << 22

    def _candidates_host(self, seq_codes):
        """Phase 1 by a dense scan of every alignment of every probe."""
        n = len(seq_codes)
        L = self.Lmax
        padded = np.zeros(n + 2 * L, dtype=np.uint8)
        padded[L:L + n] = seq_codes
        # Row r corresponds to alignment a = r - (L-1); window (r, j)
        # reads padded[L + a + j] = padded[r + j + 1]
        num_align = n + L - 1
        idx = (np.arange(num_align)[:, None] + np.arange(L)[None, :])
        win = padded[idx + 1]
        probes = self.probe_codes  # (P, L)
        match = (win[:, None, :] == probes[None, :, :]) & (win[:, None, :] > 0)
        counts = match.sum(axis=2, dtype=np.int32)  # (num_align, P)

        a = np.arange(num_align) - (L - 1)
        lens = self.probe_lens[None, :]
        ov = np.minimum(n, a[:, None] + lens) - np.maximum(0, a[:, None])
        ov = np.maximum(ov, 0)
        thres = np.minimum(np.minimum(self.lcf_static, lens), n)
        # a custom model has no mismatch count: k_seed matches are needed
        cand = ((ov >= np.maximum(thres, self.k_seed))
                & (counts >= self.k_seed) & (lens > 0) & (thres > 0))
        w_idx, p_idx = np.nonzero(cand)
        return (p_idx.astype(np.int64),
                (w_idx - (L - 1)).astype(np.int64))

    def _join_pairs(self, codes):
        """Raw k-mer join of a 1-D code array against the probe table.

        Returns deduplicated candidate (probe_idx, alignment) int64
        arrays, alignments in the coordinates of `codes`.
        """
        if self._join_h is None:
            self._build_join_table()
        kj, w = self._join_params()
        empty = (np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64))
        h, ok = self._rolling_hashes(codes[None, :], k=kj)
        sel = self._minimizer_select(h, ok, w)
        pos_seq = np.flatnonzero(sel[0])
        if len(pos_seq) == 0 or len(self._join_h) == 0:
            return empty
        hs = h[0][pos_seq]
        lo = np.searchsorted(self._join_h, hs, side="left")
        hi = np.searchsorted(self._join_h, hs, side="right")
        cnt = hi - lo
        nz = cnt > 0
        lo, cnt, pos_seq = lo[nz], cnt[nz], pos_seq[nz]
        total = int(cnt.sum())
        if total == 0:
            return empty
        if len(codes) + self.Lmax >= (1 << 34):
            raise ValueError("corpus too large for the join key encoding")
        # Expand hits to (table index, seq position) with two cumsums and
        # dedup on a composite (probe, alignment) key built with a single
        # gather: key = (p << 34) + (seq_pos - probe_pos + Lmax - 1),
        # nonnegative since alignments reach back at most Lmax - 1.
        pkey = ((self._join_p << np.int64(34)) - self._join_pos
                + (self.Lmax - 1))
        csum = np.cumsum(cnt)
        step = np.ones(total, dtype=np.int64)
        step[0] = lo[0]
        step[csum[:-1]] = lo[1:] - lo[:-1] - cnt[:-1] + 1
        idx = np.cumsum(step)
        step[0] = pos_seq[0]
        step[1:] = 0
        step[csum[:-1]] = np.diff(pos_seq)
        pos_rep = np.cumsum(step)
        key = np.unique(pkey[idx] + pos_rep)
        p = key >> np.int64(34)
        a = (key & np.int64((1 << 34) - 1)) - (self.Lmax - 1)
        return p, a

    def _candidates_join(self, seq_codes):
        """Phase 1 by k-mer join; returns predicate-passing (p, a)."""
        n = len(seq_codes)
        p, a = self._join_pairs(seq_codes)
        lens = self.probe_lens[p].astype(np.int64)
        ov = np.minimum(n, a + lens) - np.maximum(0, a)
        thres = np.minimum(np.minimum(self.lcf_static, lens), n)
        keep = (ov >= np.maximum(thres, self.k_seed)) & (thres > 0)
        return p[keep], a[keep]

    def _candidates_for_sequence(self, seq_codes):
        """(probe_idx, alignment) candidate arrays for a sequence."""
        n = len(seq_codes)
        if (n + self.Lmax - 1) * len(self.probes) * self.Lmax \
                <= self._HOST_PHASE1_MAX_CELLS:
            return self._candidates_host(seq_codes)
        return self._candidates_join(seq_codes)

    def _verify_custom(self, sequence, seq_codes, cand_p, cand_a):
        """Call the custom cover function per candidate anchor.

        Mirrors the reference's per-(position, probe) invocation of
        dynamically loaded models (reference catch/probe.py:1095-1098):
        for every maximal run of >= k_seed consecutive matches, the
        function is called once per k-mer anchor position within the
        run, with the probe and `sequence` clipped to their overlap.
        Returns flat (probe_idx, start, end) int64 arrays.
        """
        n = len(seq_codes)
        L = self.Lmax
        start = np.maximum(0, cand_a)
        lens = self.probe_lens[cand_p]
        ov = np.minimum(n, cand_a + lens) - start
        j = np.arange(L)
        seq_idx = start[:, None] + j[None, :]
        seq_vals = np.where(seq_idx < n, seq_codes[np.minimum(seq_idx, n - 1)],
                            0)
        probe_idx = (start - cand_a)[:, None] + j[None, :]
        probe_vals = np.take_along_axis(
            self.probe_codes[cand_p], np.minimum(probe_idx, L - 1), axis=1)
        valid = j[None, :] < ov[:, None]
        match = (seq_vals == probe_vals) & (seq_vals > 0) & valid

        fn = self.model.custom_fn
        k = self.k_seed
        out_p, out_s, out_e = [], [], []
        for c in range(len(cand_p)):
            p_i = int(cand_p[c])
            probe = self.probes[p_i]
            a = int(cand_a[c])
            st = int(start[c])
            o = int(ov[c])
            if o < k:
                continue
            probe_clip_start = st - a
            probe_seq = probe.seq_str[probe_clip_start:probe_clip_start + o]
            m = match[c, :o]
            # anchors: positions i where m[i:i+k] all True
            run_ok = np.convolve(m.astype(np.int64),
                                 np.ones(k, dtype=np.int64),
                                 mode="valid") == k
            anchor_positions = np.flatnonzero(run_ok)
            if len(anchor_positions) == 0:
                continue
            subseq = sequence[st:st + o]
            for i in anchor_positions:
                r = fn(probe_seq, subseq, int(i), int(i) + k,
                       int(lens[c]), n)
                if r is None:
                    continue
                out_p.append(p_i)
                out_s.append(r[0] + st)
                out_e.append(r[1] + st)
        return (np.array(out_p, dtype=np.int64),
                np.array(out_s, dtype=np.int64),
                np.array(out_e, dtype=np.int64))

    def _scan_one_sequence(self, sequence):
        """The custom model's spans in one sequence: flat (probe_idx,
        start, end) int64 arrays."""
        if len(sequence) < self.k_seed:
            return tuple(np.empty(0, dtype=np.int64) for _ in range(3))
        seq_codes = self.alphabet.encode(encode.encode_bytes(sequence))
        cand_p, cand_a = self._candidates_for_sequence(seq_codes)
        self.stats["candidates"] += len(cand_p)
        return self._verify_custom(sequence, seq_codes, cand_p, cand_a)

    def _scan_custom(self, sequences):
        """find_probe_covers_flat's arrays from the host scan, one
        sequence at a time."""
        out = [[], [], [], []]
        for i, sequence in enumerate(sequences):
            p_idx, s, e = self._scan_one_sequence(sequence)
            for part, x in zip(out, (p_idx, np.full(len(p_idx), i), s, e)):
                part.append(x.astype(np.int64))
        return tuple(np.concatenate(x) for x in out)

    # ------------------------------------------------------------------
    # Public API
    # ------------------------------------------------------------------

    def find_probe_covers(self, sequence, merge_overlapping=True):
        """Find cover ranges of every probe in `sequence`.

        Args:
            sequence: target sequence as a string
            merge_overlapping: merge overlapping ranges per probe (the
                reference's contract; False keeps distinct ranges for
                depth analysis)

        Returns:
            dict mapping Probe -> sorted list of (start, end) ranges
        """
        if self.empty:
            return {}
        p_idx, _, span_start, span_end = self.find_probe_covers_flat(
            [sequence])
        return self._group_spans(p_idx, span_start, span_end,
                                 merge_overlapping)

    def find_probe_covers_flat(self, sequences):
        """Unmerged cover spans of every probe across many sequences.

        One corpus-wide scan on the searcher's device
        (ops/scan_sparse.scan_corpus_sparse), or for a model with
        custom_fn the host scan, one sequence at a time.  Returns flat
        int64 numpy arrays (probe_idx, seq_idx, start, end) in
        per-sequence local coordinates; spans are NOT merged (consumers
        merge per (probe, universe), which commutes with cover
        extension).  probe_idx indexes self.probes (the deduplicated
        probe list).
        """
        from catch_tpu_torch.ops import scan_sparse

        custom = self.model.custom_fn is not None
        if self.device is None and not custom:
            raise ValueError("the span scan needs the searcher's device: "
                             "construct ProbeSearcher(..., device=...)")
        if self.empty or not sequences:
            return tuple(np.empty(0, dtype=np.int64) for _ in range(4))
        if custom:
            return self._scan_custom(sequences)
        return scan_sparse.scan_corpus_sparse(self, sequences, self.device)

    def _group_spans(self, p_idx, span_start, span_end, merge_overlapping):
        if len(p_idx) == 0:
            return {}
        order = np.lexsort((span_end, span_start, p_idx))
        p_idx = p_idx[order]
        s = span_start[order]
        e = span_end[order]
        out = {}
        boundaries = np.flatnonzero(np.diff(p_idx)) + 1
        groups = np.split(np.arange(len(p_idx)), boundaries)
        for g in groups:
            pi = int(p_idx[g[0]])
            spans = list(zip(s[g].tolist(), e[g].tolist()))
            if merge_overlapping:
                spans = intervals.merge_overlapping(spans)
            else:
                spans = sorted(set(spans))
            out[self.probes[pi]] = spans
        return out
