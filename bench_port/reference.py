"""The plain reference of a probe design, in plain PyTorch.

It imports numpy and torch and nothing of the program under test.  From
the genomes alone it works out, on any torch device:

- the candidate probes: tiles of ``probe_length`` every ``probe_stride``
  bp, a right-aligned tail tile where the stride does not divide the
  length, tiles that hold a run of two or more N left out and the tiles
  flanking each such run added (CATCH's candidate_probes.py), then
  exact duplicates removed in first-occurrence order;
- each probe's cover spans in each sequence under the hybridization
  model: a probe covers the target window of every maximal alignment
  window of length >= min(lcf_thres, probe length, sequence length)
  with at most ``mismatches`` mismatches that holds an exact run of at
  least the seed length, extended by ``cover_extension`` on each side
  and clipped to the sequence; where lcf_thres reaches the probe length
  and the seed length is the pigeonhole one (or mismatches is 0), a
  whole-probe alignment with at most ``mismatches`` mismatches covers
  its whole band instead (CATCH's fast path);
- the greedy partial set cover over (genome, position) elements: every
  step picks the unpicked probe of the least cost / capped new coverage
  in float32 (all costs 1), ties to the lowest candidate id, until each
  genome has at most floor(u - coverage * u) of its coverable positions
  u left uncovered; the design is the picked probes in candidate order.

Candidate alignments come from exact k-mer hits at probe offsets
sampled every ``seed - k + 1``, so that every exact run of ``seed``
bases holds a sampled k-mer: the seeding is exhaustive.  Matching is
byte equality of the normalised sequences (upper case, IUPAC
ambiguity codes as N, gaps removed, as CATCH reads a FASTA).
"""

import gzip
import re

import numpy as np
import torch

__all__ = ["read_fasta", "tiles", "candidates", "seed_length", "spans",
           "design", "covered", "coverage_gap", "Model"]

_DEGENERATE = re.compile("[YRWSMKBDHV]")
# k of the sampled exact hits (4-bit codes, 48-bit keys).
_HIT_K = 12
_BIG = 1 << 30


class Model:
    """The design parameters a configuration states."""

    def __init__(self, probe_length, probe_stride, mismatches, lcf_thres,
                 cover_extension, coverage=1.0, island_of_exact_match=0,
                 kmer_probe_map_k=20):
        self.probe_length = int(probe_length)
        self.probe_stride = int(probe_stride)
        self.mismatches = int(mismatches)
        self.lcf_thres = int(lcf_thres)
        self.cover_extension = int(cover_extension)
        self.coverage = float(coverage)
        self.island = int(island_of_exact_match)
        self.kmer_probe_map_k = int(kmer_probe_map_k)


def read_fasta(path):
    """[(name, sequence)] of a FASTA file (gzip where it ends in .gz),
    normalised as CATCH reads it."""
    opener = gzip.open if path.endswith(".gz") else open
    records, name, parts = [], None, []
    with opener(path, "rt") as f:
        for line in f:
            line = line.rstrip()
            if not line:
                continue
            if line.startswith(">"):
                if name is not None:
                    records.append((name, "".join(parts)))
                name, parts = line[1:], []
            else:
                parts.append(_DEGENERATE.sub("N", line.upper())
                             .replace("-", ""))
    if name is not None:
        records.append((name, "".join(parts)))
    return records


def tiles(seq, length, stride, min_n=2):
    """The candidate probes of one sequence, in CATCH's order."""
    if len(seq) < length:
        raise ValueError("a sequence is shorter than the probe length")
    runs = [(m.start(), m.end())
            for m in re.finditer("N{%d,}" % min_n, seq)]

    def ok(a, b):
        return all(min(e, b) - max(s, a) < min_n for s, e in runs)

    n = len(seq)
    out = [seq[a:a + length] for a in range(0, n - length + 1, stride)
           if ok(a, a + length)]
    if n % stride and ok(n - length, n):
        out.append(seq[n - length:])
    for s, e in runs:
        if s - length >= 0 and ok(s - length, s):
            out.append(seq[s - length:s])
        if e + length <= n and ok(e, e + length):
            out.append(seq[e:e + length])
    return out


def candidates(seqs, model):
    """Unique candidate probes of the sequences, first occurrence first."""
    out = []
    for s in seqs:
        out += tiles(s, model.probe_length, model.probe_stride)
    return list(dict.fromkeys(out))


def seed_length(model):
    """(seed length, whole-probe fast path) of the model, for probes of
    one length: the pigeonhole length where lcf_thres reaches the probe
    length and it is at least kmer_probe_map_k, else kmer_probe_map_k."""
    L, m, k = model.probe_length, model.mismatches, model.kmer_probe_map_k
    pigeon = False
    if model.lcf_thres >= L:
        kp = L
        if m > 0:
            kp = int(L / m)
            if kp == float(L) / m:
                kp -= 1
            while L % kp:
                kp -= 1
        if kp >= k:
            k, pigeon = kp, True
    fast = (model.island == 0 and model.lcf_thres >= L
            and (pigeon or m == 0))
    return k, fast


def _codes(probes, seqs):
    """(lut, corpus codes, sequence starts, probe codes) as int64 numpy."""
    corpus = np.frombuffer("".join(seqs).encode("ascii"), dtype=np.uint8)
    pbytes = np.frombuffer("".join(probes).encode("ascii"), dtype=np.uint8)
    present = np.zeros(256, dtype=bool)
    present[np.unique(corpus)] = True
    present[np.unique(pbytes)] = True
    syms = np.flatnonzero(present)
    if len(syms) > 15:
        raise ValueError("more than 15 distinct sequence letters")
    lut = np.zeros(256, dtype=np.int64)
    lut[syms] = np.arange(1, len(syms) + 1)
    starts = np.zeros(len(seqs) + 1, dtype=np.int64)
    np.cumsum([len(s) for s in seqs], out=starts[1:])
    L = len(probes[0]) if probes else 0
    return lut[corpus], starts, lut[pbytes].reshape(len(probes), L)


def _kmer_keys(codes, k):
    """Keys of the k-mers starting at each position that has k codes."""
    n = codes.numel() - k + 1
    key = torch.zeros(max(n, 0), dtype=torch.int64, device=codes.device)
    for i in range(k):
        key = (key << 4) | codes[i:i + n]
    return key


def _candidate_alignments(corpus, starts, pcodes, seed, device, budget):
    """Unique (probe, sequence, alignment) of exact k-mer hits at the
    sampled probe offsets, as one int64 key each."""
    N, L, P = corpus.numel(), pcodes.shape[1], pcodes.shape[0]
    k = min(_HIT_K, seed)
    step = seed - k + 1
    n_seq = starts.numel() - 1
    seq_of = torch.repeat_interleave(
        torch.arange(n_seq, device=device), starts[1:] - starts[:-1])
    keys = _kmer_keys(corpus, k)
    pos = torch.arange(keys.numel(), device=device)
    inside = pos + k <= starts[1:][seq_of[:keys.numel()]]
    keys, pos = keys[inside], pos[inside]
    keys, order = torch.sort(keys)
    pos = pos[order]
    del order, inside
    offs = torch.arange(0, L - k + 1, step, device=device)
    qkey = torch.zeros((P, offs.numel()), dtype=torch.int64, device=device)
    for i in range(k):
        qkey = (qkey << 4) | pcodes[:, offs + i]
    qkey = qkey.reshape(-1)
    lo = torch.searchsorted(keys, qkey)
    cnt = torch.searchsorted(keys, qkey, right=True) - lo
    span = int(starts[1:].sub(starts[:-1]).max()) + L
    ends = torch.cumsum(cnt, 0)
    total = int(ends[-1]) if ends.numel() else 0
    out, q0, done = [], 0, 0
    while done < total:
        q1 = int(torch.searchsorted(ends, done + budget, right=True))
        q1 = max(q1, q0 + 1)
        c = cnt[q0:q1]
        rep = torch.repeat_interleave(torch.arange(q0, q1, device=device), c)
        first = torch.cumsum(c, 0) - c
        within = torch.arange(rep.numel(), device=device) - \
            torch.repeat_interleave(first, c)
        hit = pos[lo[rep] + within]
        sid = seq_of[hit]
        a = hit - starts[sid] - offs[rep % offs.numel()]
        p = rep // offs.numel()
        out.append(torch.unique((p * n_seq + sid) * span + a + L))
        done = int(ends[q1 - 1])
        q0 = q1
    if not out:
        return torch.empty(0, dtype=torch.int64, device=device), span
    return torch.unique(torch.cat(out)), span


def spans(probes, seqs, model, device="cpu", chunk=None, budget=None):
    """Cover spans of the probes (strings of one length) in the
    sequences, as int64 tensors (probe, sequence, start, end) in
    sequence coordinates, extended and clipped."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    chunk = chunk or (1 << 19 if cuda else 1 << 15)
    budget = budget or (1 << 26 if cuda else 1 << 22)
    empty = torch.empty(0, dtype=torch.int64, device=device)
    if not probes or not seqs:
        return empty, empty, empty, empty
    L = model.probe_length
    if any(len(p) != L for p in probes):
        raise ValueError("every probe must have the probe length")
    seed, fast = seed_length(model)
    seed_req = max(seed, model.island)
    K = model.mismatches
    corpus, starts, pcodes = (torch.from_numpy(x).to(device)
                              for x in _codes(probes, seqs))
    cand, span = _candidate_alignments(corpus, starts, pcodes, seed, device,
                                       budget)
    n_seq = starts.numel() - 1
    seq_len = starts[1:] - starts[:-1]
    j = torch.arange(L, device=device)
    tq = torch.arange(L + 1, device=device)
    outs = []
    for c0 in range(0, cand.numel(), chunk):
        key = cand[c0:c0 + chunk]
        a = key % span - L
        ps = key // span
        p, sid = ps // n_seq, ps % n_seq
        n = seq_len[sid]
        at = a[:, None] + j[None, :]
        valid = (at >= 0) & (at < n[:, None])
        idx = torch.clamp(starts[sid][:, None] + at, 0, corpus.numel() - 1)
        match = valid & (corpus[idx] == pcodes[p])
        mism = valid & ~match
        del at, idx
        i_lo = torch.clamp(-a, min=0)
        i_hi = torch.clamp(n - a, max=L)
        nm = mism.sum(1)
        sv = torch.sort(torch.where(mism, j[None, :], _BIG), dim=1).values
        body = torch.cat([sv, torch.full((key.numel(), K + 1), _BIG,
                                         device=device)], 1)
        body = torch.where(body >= _BIG, i_hi[:, None], body)
        Pm = torch.cat([(i_lo - 1)[:, None], body], 1)
        del sv, body
        lenW = Pm[:, K + 1:K + 2 + L] - Pm[:, :L + 1] - 1
        runs = Pm[:, 1:] - Pm[:, :-1] - 1
        seedmax = runs[:, :L + 1]
        for sft in range(1, K + 1):
            seedmax = torch.maximum(seedmax, runs[:, sft:sft + L + 1])
        thres = torch.clamp(n, max=min(L, model.lcf_thres))
        qual = ((tq[None, :] <= nm[:, None]) & (lenW >= thres[:, None])
                & (seedmax >= seed_req) & (thres[:, None] > 0))
        if fast:
            is_fast = (n >= L) | ((K == 0) & (n >= seed))
            need = torch.clamp(thres - K, min=seed)
            ok = (match.sum(1) >= need) & (thres > 0)
            qual = torch.where(is_fast[:, None],
                               (tq[None, :] == 0) & ok[:, None], qual)
        rows, ts = torch.nonzero(qual, as_tuple=True)
        s = Pm[rows, ts] + 1 + a[rows]
        e = Pm[rows, ts + K + 1] + a[rows]
        if fast:
            fr = is_fast[rows]
            s = torch.where(fr, torch.clamp(a[rows], min=0), s)
            e = torch.where(fr, a[rows] + i_hi[rows], e)
        ext = model.cover_extension
        outs.append((p[rows], sid[rows], torch.clamp(s - ext, min=0),
                     torch.minimum(e + ext, n[rows])))
    if not outs:
        return empty, empty, empty, empty
    return tuple(torch.cat(x) for x in zip(*outs))


def _merge(group, s, e, axis):
    """Union of the intervals [s, e) within each group (int64 ids):
    (group, start, end) of the merged intervals, sorted."""
    off = group * (axis + 1)
    s2, order = torch.sort(s + off)
    e2 = (e + off)[order]
    g = group[order]
    reach = torch.cummax(e2, 0).values
    new = torch.ones_like(s2, dtype=torch.bool)
    new[1:] = s2[1:] > reach[:-1]
    gid = torch.cumsum(new.to(torch.int64), 0) - 1
    ends = torch.full((int(gid[-1]) + 1 if gid.numel() else 0,),
                      -1, dtype=torch.int64, device=s.device)
    ends.scatter_reduce_(0, gid, e2, reduce="amax")
    gs = g[new]
    return gs, s2[new] - gs * (axis + 1), ends - gs * (axis + 1)


def _global(sid, s, e, genome_of, seq_off):
    """Spans in sequence coordinates to genome ids and positions on one
    axis of all genomes laid end to end."""
    return genome_of[sid], s + seq_off[sid], e + seq_off[sid]


def _layout(genomes, device):
    """(genome of each sequence, each sequence's start on the axis, each
    genome's start on the axis, axis length)."""
    lens = [len(s) for g in genomes for s in g]
    genome_of = torch.tensor([i for i, g in enumerate(genomes) for _ in g],
                             dtype=torch.int64, device=device)
    seq_off = torch.zeros(len(lens) + 1, dtype=torch.int64, device=device)
    seq_off[1:] = torch.cumsum(torch.tensor(lens, dtype=torch.int64,
                                            device=device), 0)
    g_off = seq_off[torch.tensor(
        np.cumsum([0] + [len(g) for g in genomes]), device=device)]
    return genome_of, seq_off[:-1], g_off, int(seq_off[-1])


def _indicator(s, e, axis):
    d = torch.zeros(axis + 1, dtype=torch.int64, device=s.device)
    d.index_add_(0, s, torch.ones_like(s))
    d.index_add_(0, e, -torch.ones_like(e))
    return torch.cumsum(d[:axis], 0) > 0


def _per_genome(flags, g_off):
    c = torch.zeros(flags.numel() + 1, dtype=torch.int64, device=flags.device)
    c[1:] = torch.cumsum(flags.to(torch.int64), 0)
    return c[g_off[1:]] - c[g_off[:-1]]


def design(genomes, model, device="cpu"):
    """The reference design of `genomes` (a list of genomes, each a list
    of sequence strings): the picked candidate probes in candidate
    order, and the universe (a bool tensor over the axis of all
    genomes) that coverage is measured on."""
    device = torch.device(device)
    seqs = [s for g in genomes for s in g]
    cands = candidates(seqs, model)
    pid, sid, s, e = spans(cands, seqs, model, device)
    genome_of, seq_off, g_off, axis = _layout(genomes, device)
    nU = len(genomes)
    u, gs, ge = _global(sid, s, e, genome_of, seq_off)
    del sid, s, e
    univ = _indicator(gs, ge, axis)
    u_size = _per_genome(univ, g_off)
    can_uncover = torch.from_numpy(
        (u_size.cpu().numpy() - model.coverage * u_size.cpu().numpy())
        .astype(np.int64)).to(device)
    pair, ivs, ive = _merge(pid * nU + u, gs, ge, axis)
    del pid, u, gs, ge
    pair_key, pair_of_ivl = torch.unique(pair, return_inverse=True)
    set_of_pair, univ_of_pair = pair_key // nU, pair_key % nU
    S, nP = len(cands), pair_key.numel()
    covered = ~univ
    len_u = u_size.clone()
    in_cover = torch.zeros(S, dtype=torch.bool, device=device)
    one = torch.tensor(1.0, dtype=torch.float32, device=device)
    prefix = torch.zeros(axis + 1, dtype=torch.int64, device=device)
    picks = []
    while True:
        need = torch.clamp(len_u - can_uncover, min=0)
        if not bool((need > 0).any()):
            break
        prefix[1:] = torch.cumsum((~covered).to(torch.int64), 0)
        new = prefix[ive] - prefix[ivs]
        pair_new = torch.zeros(nP, dtype=torch.int64, device=device)
        pair_new.index_add_(0, pair_of_ivl, new)
        capped = torch.minimum(pair_new, need[univ_of_pair])
        score = torch.zeros(S, dtype=torch.int64, device=device)
        score.index_add_(0, set_of_pair, capped)
        elig = ~in_cover & (score > 0)
        if not bool(elig.any()):
            break
        ratio = torch.where(
            elig, one / torch.clamp(score, min=1).to(torch.float32),
            torch.tensor(float("inf"), device=device))
        chosen = int(torch.argmin(ratio))
        mine = set_of_pair[pair_of_ivl] == chosen
        covered |= _indicator(ivs[mine], ive[mine], axis)
        taken = set_of_pair == chosen
        len_u.index_add_(0, univ_of_pair[taken], -pair_new[taken])
        in_cover[chosen] = True
        picks.append(chosen)
    return [cands[i] for i in sorted(picks)], univ


def covered(probes, genomes, model, device="cpu"):
    """A bool tensor over the axis of all genomes laid end to end: the
    positions that the probes cover under the model."""
    device = torch.device(device)
    seqs = [s for g in genomes for s in g]
    genome_of, seq_off, _, axis = _layout(genomes, device)
    pid, sid, s, e = spans(list(dict.fromkeys(probes)), seqs, model, device)
    _, gs, ge = _global(sid, s, e, genome_of, seq_off)
    return _indicator(gs, ge, axis) if gs.numel() else \
        torch.zeros(axis, dtype=torch.bool, device=device)


def coverage_gap(probes, genomes, model, device="cpu", universe=None,
                 per_genome=False):
    """Positions of each genome's universe that the probes leave
    uncovered beyond what the coverage allows, summed over the genomes,
    and the universe's size; with per_genome, the int64 tensor of those
    positions in each genome instead.  Without `universe` (from design()), it is
    each whole genome, which is right where every position lies in a
    tile of its own sequence (no run of N)."""
    device = torch.device(device)
    seqs = [s for g in genomes for s in g]
    _, _, g_off, axis = _layout(genomes, device)
    if universe is None:
        if any("NN" in s for s in seqs):
            raise ValueError("genomes with runs of N need design()'s "
                             "universe")
        universe = torch.ones(axis, dtype=torch.bool, device=device)
    cov = covered(probes, genomes, model, device)
    u_size = _per_genome(universe, g_off)
    left = _per_genome(universe & ~cov, g_off)
    allowed = torch.from_numpy(
        (u_size.cpu().numpy() - model.coverage * u_size.cpu().numpy())
        .astype(np.int64)).to(device)
    gap = torch.clamp(left - allowed, min=0)
    if per_genome:
        return gap
    return int(gap.sum()), int(u_size.sum())
