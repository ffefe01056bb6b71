#!/usr/bin/env python3
"""Smoke run of catch_tpu_torch's design, span and design_large paths on one
NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. the card (nvidia-smi name and power limit), torch, CUDA, nvcc and
     triton versions;
  2. the build of the nine CUDA kernels from catch_tpu_torch/csrc/;
  3. the five design-scan kernels (pack_merged, the readback, among them)
     against their plain-PyTorch twins on the card, on the inputs the
     ebola175 design gives them: outputs
     must be exactly equal; the median, min and max times of both from
     CUDA events;
  4. ebola5 (-pl 100 -m 0 -e 0) through catch_tpu_torch.cli.design on
     cuda; the probe set must equal tests/data/golden/ref_ebola5_m0.fasta;
  5. ebola175 (-pl 100 -m 2 -l 60 -e 50), the first 175 genomes of
     tests/data/zaire_ebolavirus.fasta.gz, through the same CLI on cuda,
     with every kernel's launch count set to 0 just before; the output
     must equal tests/data/golden/torch_ebola175_m2.fasta byte for byte,
     and the five design kernels must have launched;
  6. the two span-scan kernels, expand_join and verify_spans, against
     their twins on the inputs the first batch (75 Mbp, both strands) of
     phase 8's avoid scan gives them: exactly equal; CUDA-event medians;
  7. the identify and avoid goldens through catch_tpu_torch.cli.design
     on cuda (ref_identify_m0.fasta, ref_avoid_m0.fasta);
  8. the avoid scan at real size (bench.py's avoid configuration): the
     ranks of the candidates of the first 8 ebola genomes (-pl 100
     -ps 50) against a 100 Mbp background with planted ebola pieces,
     under SetCoverFilter(mismatches=2, lcf_thres=60,
     cover_extension=50), counting launches; the ranks must equal
     tests/data/golden/avoid100m_ranks.tsv;
  9. catch_tpu_torch.cli.analyze_probe_coverage on ebola175 with the
     probes of torch_ebola175_m2.fasta (-m 2 -l 60 -e 50) on cuda,
     counting launches; both TSVs must equal their goldens;
 10. design_large through catch_tpu_torch.cli.design_large on cuda, with
     its defaults, on the 2,000-genome influenza-like corpus
     (influenza_like_segments(n_genomes=2000, seed=0), 8 segment FASTAs,
     27,176,000 bp; greedy clustering), counting launches: the probe
     FASTA must equal tests/data/golden/flu2000_design_large.fasta byte
     for byte, and minhash_assign, minhash_caps, minhash_sig and the
     five design-scan kernels must have launched;
 11. the same on the 10,000-genome corpus of bench.py:107-127 (80,000
     sequences, 135,880,000 bp): the clusters must equal
     flu10k_clusters.tsv.gz and the FASTA flu10k_design_large.fasta; the
     run goes under torch.profiler (CUDA activity only), which gives the
     card's busy share, and keeps the inputs of the largest
     near-duplicate group's minhash_sig call, of the last full greedy
     wave, of the largest minhash_caps call and of the largest cluster's
     pack_merged call;
 12. the clustering step of design_large's defaults on the 51 Mbp scale
     corpus of bench.py:130-158 (2,700 mutated ebola genomes): 'choose'
     gives 'simple' (minhash_codes), and with fragments of 10,000 nt
     'hierarchical' (minhash_dists); both must equal their goldens;
 13. minhash_caps' four entry points, minhash_sig and pack_merged against
     their twins at those shapes (phase 11's group, wave, caps call and
     cluster, phase 12's fragments and the first 8,192 flu10k
     sequences): exactly equal, the float32 distances bit for bit;
     CUDA-event medians, min and max.

Each phase prints its wall seconds as it ends.  The line before the
last is the card's name and power limit; the one before it a JSON
object with one entry per kernel entry point (times, launches on its
path, and the bound: bytes over 3.35 TB/s or operations over 67 T/s,
the H100's non-tensor 32-bit rate, whichever is larger); the last line
is {"ok": true, "device": {...}}.  Scratch files go under
build/chip_smoke/.
"""

import contextlib
import gzip
import json
import os
import statistics
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "tests", "data", "zaire_ebolavirus.fasta.gz")
GOLDEN = os.path.join(ROOT, "tests", "data", "golden")
WORK = os.path.join(ROOT, "build", "chip_smoke")
REPLACES = {
    "rolling_hash": "catch_tpu/ops/scan_instance.py:129",
    "lookup_expand": "catch_tpu/ops/scan_instance.py:217",
    "verify_windows": "catch_tpu/ops/scan_instance.py:382",
    "segmented_merge": "catch_tpu/ops/scan_instance.py:537",
    "pack_merged": "catch_tpu/ops/scan_instance.py:611",
    "expand_join": "catch_tpu/ops/scan_sparse.py:192",
    "verify_spans": "catch_tpu/ops/scan_sparse.py:65",
    "minhash_dists": "catch_tpu/utils/cluster.py:85",
    "minhash_codes": "catch_tpu/utils/cluster.py:120",
    "minhash_caps": "catch_tpu/utils/cluster.py:238",
    "minhash_assign": "catch_tpu/utils/cluster.py:205",
    "minhash_sig": "catch_tpu/utils/lsh.py:257",
}
SOURCES = {name: f"catch_tpu_torch/csrc/{name}.cu" for name in REPLACES}
SOURCES["verify_spans"] = "catch_tpu_torch/csrc/verify_windows.cu"
for _name in ("minhash_dists", "minhash_codes", "minhash_assign"):
    SOURCES[_name] = "catch_tpu_torch/csrc/minhash_caps.cu"
DESIGN_KERNELS = ["rolling_hash", "lookup_expand", "verify_windows",
                  "segmented_merge", "pack_merged"]

# The H100's published rates (SXM, 700 W): device memory 3.35 TB/s, and
# 67 T operations/s outside the tensor cores, the rate used for these
# integer and compare kernels.
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12


def fail(msg):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def run(cmd):
    p = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    if p.returncode != 0:
        fail(f"{' '.join(cmd)} exited {p.returncode}: {p.stderr}")
    return p.stdout.strip()


def write_subset(n):
    """The first n records of the fixture as a FASTA file."""
    path = os.path.join(WORK, f"ebola{n}.fasta")
    recs = []
    with gzip.open(FIXTURE, "rt") as f:
        for line in f:
            if line.startswith(">"):
                if len(recs) == n:
                    break
                recs.append([line])
            else:
                recs[-1].append(line)
    with open(path, "w") as out:
        for r in recs:
            out.writelines(r)
    return path


AVOID_BG_BP = 100_000_000
AVOID_BG_CHROMS = 4


def write_background(path, frag_src):
    """The avoid benchmark's background FASTA (bench.py:292-312): 4 random
    chromosomes of 25 Mbp from numpy.random.default_rng(11), each with
    five 500 bp fragments of `frag_src` (the first ebola genome) planted
    at random places.  Written once; an existing file is kept."""
    import numpy as np

    if os.path.exists(path):
        return path
    rng = np.random.default_rng(11)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    per = AVOID_BG_BP // AVOID_BG_CHROMS
    with open(path + ".tmp", "w") as f:
        for c in range(AVOID_BG_CHROMS):
            chrom = bases[rng.integers(0, 4, size=per)]
            for _ in range(5):
                fs = int(rng.integers(0, len(frag_src) - 500))
                frag = np.frombuffer(frag_src[fs:fs + 500].encode(),
                                     dtype=np.uint8)
                at = int(rng.integers(0, per - 500))
                chrom[at:at + 500] = frag
            f.write(">bgchrom%d\n" % c)
            f.write(chrom.tobytes().decode())
            f.write("\n")
    os.replace(path + ".tmp", path)
    return path


def write_flu(n_genomes):
    """The influenza-like corpus of bench.py:107-127 at n_genomes: 8
    segment FASTAs from influenza_like_segments(seed=0), one dataset
    each.  Returns (paths, total bp)."""
    from catch_tpu_torch.utils.synthetic import (influenza_like_segments,
                                                 write_segment_fastas)

    segs, subtype_of = influenza_like_segments(n_genomes=n_genomes, seed=0)
    paths = write_segment_fastas(segs, subtype_of,
                                 os.path.join(WORK, f"flu{n_genomes}"))
    return paths, sum(s.size for s in segs)


SCALE_STRAINS, SCALE_COPIES_PER = 30, 90
SCALE_STRAIN_MUT, SCALE_COPY_MUT = 0.12, 0.005


def scale_seqs():
    """The 51 Mbp scale corpus of bench.py:130-158: 30 strains mutated
    12% from the first ebola genome, 90 copies of each mutated 0.5%
    further, from numpy.random.default_rng(0)."""
    import numpy as np

    from catch_tpu_torch.utils import seq_io

    base = np.frombuffer(seq_io.read_genomes_from_fasta(FIXTURE)[0]
                         .seqs[0].encode(), dtype=np.uint8)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    rng = np.random.default_rng(0)

    def mutate(seq, rate):
        out = seq.copy()
        m = np.flatnonzero(rng.random(len(out)) < rate)
        out[m] = bases[rng.integers(0, 4, size=len(m))]
        return out

    seqs = []
    for _ in range(SCALE_STRAINS):
        strain = mutate(base, SCALE_STRAIN_MUT)
        for _ in range(SCALE_COPIES_PER):
            seqs.append(mutate(strain, SCALE_COPY_MUT).tobytes().decode())
    return seqs


def read_cluster_ranks(path):
    """A cluster golden: one cluster rank per sequence."""
    with gzip.open(path, "rt") as f:
        return [int(line) for line in f]


def cluster_ranks(clusters, n):
    """Each sequence's cluster rank, clusters in the order given."""
    rank = [-1] * n
    for r, members in enumerate(clusters):
        for i in members:
            rank[i] = r
    return rank


def fasta_records(path):
    recs, header, seq = set(), None, []
    for line in open(path):
        line = line.strip()
        if line.startswith(">"):
            if header is not None:
                recs.add((header, "".join(seq)))
            header, seq = line, []
        else:
            seq.append(line)
    if header is not None:
        recs.add((header, "".join(seq)))
    return recs


def cuda_ms(torch, fn, reps, warm=True):
    """(median, min, max) milliseconds of fn() from CUDA events, after a
    warm-up call unless the caller has just made one."""
    if warm:
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times), min(times), max(times)


def max_abs_err(torch, got, want):
    """Max |got - want| over tuples of tensors of equal shapes and types.
    A float32 pair that differs in any bit counts at least 1."""
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            fail(f"{g.dtype} {tuple(g.shape)} != {w.dtype} {tuple(w.shape)}")
        if not g.numel():
            continue
        if g.is_floating_point():
            err = max(err, float((g - w).abs().max()))
            if not torch.equal(g.view(torch.int32), w.view(torch.int32)):
                err = max(err, 1)
        else:
            err = max(err, int((g.to(torch.int64)
                                - w.to(torch.int64)).abs().max()))
    return err


def bound(work):
    """(bound ms, what bounds it) of (bytes moved, operations)."""
    nbytes, ops = work
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / OPS_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def kernel_inputs(torch, device):
    """The inputs each kernel gets in the ebola175 design."""
    from catch_tpu_torch.filters.candidates import (
        make_candidate_probes_from_sequences)
    from catch_tpu_torch.filters.duplicate import DuplicateFilter
    from catch_tpu_torch.ops import scan_instance as si
    from catch_tpu_torch.ops.cover import CoverModel, ProbeSearcher
    from catch_tpu_torch.utils import seq_io

    genomes = seq_io.read_genomes_from_fasta(write_subset(175))
    seqs = [s for g in genomes for s in g.seqs]
    probes = DuplicateFilter()._filter(make_candidate_probes_from_sequences(
        seqs, probe_length=100, probe_stride=50))
    searcher = ProbeSearcher(probes, CoverModel(2, 60))
    pid_of = {p: i for i, p in enumerate(probes)}
    pid = [pid_of[p] for p in searcher.probes]
    univ, off = [], []
    for j, g in enumerate(genomes):
        pos = 0
        for x in g.seqs:
            univ.append(j)
            off.append(pos)
            pos += len(x)
    st, total, _ = si.prepare_corpus(searcher, seqs, univ, off, pid, device)
    kj, s = si.join_params_stride(searcher)
    K, k_seed = int(searcher.K_static), int(searcher.k_seed)
    return dict(searcher=searcher, st=st, total=total, kj=kj, s=s, K=K,
                k_seed=k_seed, nU=len(genomes), n_probes=len(probes),
                corpus_bp=sum(len(x) for x in seqs))


def check_kernels(torch, device):
    """Phase 3: every kernel against its twin; returns the JSON rows."""
    from catch_tpu_torch.ops import scan_instance as si

    x = kernel_inputs(torch, device)
    st, kj, s, K, nU = x["st"], x["kj"], x["s"], x["K"], x["nU"]
    P, L = st["codes"].shape
    row = L + kj
    flat = torch.zeros(P * row + kj - 1, dtype=torch.uint8, device=device)
    flat[:P * row].view(P, row)[:, :L] = st["codes"]
    n_samples = -(-x["total"] // s)
    print(f"ebola175 shapes: {x['n_probes']} candidate probes, {P} unique, "
          f"L={L}, corpus {x['corpus_bp']} bp in {x['total']} positions, "
          f"{n_samples} samples, kj={kj}, s={s}, K={K}", flush=True)

    def k1(hash_fn):
        return (hash_fn(flat, P * row, 1, kj, P * row - 1),
                hash_fn(st["mega"], n_samples, s, kj, x["total"] - kj))

    tbl_h, tbl_p, tbl_pos = si.build_table(st["codes"], kj)
    q = k1(si.rolling_hash)[1]

    def k2(fn):
        return fn(tbl_h, tbl_p, tbl_pos, q, s)

    pc, ac = k2(si.lookup_expand)
    vargs = dict(K=K, k_seed=x["k_seed"], lcf=int(x["searcher"].lcf_static),
                 seed_req=x["k_seed"], fast_ok=bool(x["searcher"].fast_ok),
                 ext=50, nU=nU)
    vt = (st["mega"], st["codes"], st["lens"], pc, ac, st["seq_starts"],
          st["seq_ends"], st["seq_lens"], st["chrom_off"], st["univ_of_seq"])

    def k3(fn):
        return fn(*vt, **vargs)

    key, us, ue = k3(si.verify_windows)

    def k4(fn):
        mk, ms, me = fn(key, us, ue)
        return (mk, ms, me) + tuple(fn(mk % nU, ms, me))

    print(f"ebola175 shapes: {int(q.numel())} sample hashes, "
          f"{int(pc.numel())} candidate pairs, {int(key.numel())} spans",
          flush=True)
    # Bytes (each input read once, each output written once) and
    # operations each function needs on these inputs: K1 two multiply-
    # adds per code of each window; K2 a binary search per sample and a
    # store per pair; K3 a compare per aligned probe position; K4 a
    # pass over each merge's input.
    n_hash = P * row + n_samples
    n_tbl, n_q, n_pairs = tbl_h.numel(), q.numel(), pc.numel()
    merged = k4(si.segmented_merge)
    n_in, n_mid, n_out = key.numel(), merged[0].numel(), merged[3].numel()
    b_pos = si.pack_width(int((st["chrom_off"] + st["seq_lens"]).max()))
    return compare(torch, [
        ("rolling_hash", k1, si._rolling_hash_plain, si.rolling_hash, 20,
         (flat.numel() + x["total"] + 8 * n_hash, 2 * kj * n_hash)),
        ("lookup_expand", k2, si._lookup_expand_plain, si.lookup_expand, 10,
         (8 * (3 * n_tbl + n_q) + 16 * n_pairs,
          n_q * max(1, (n_tbl - 1).bit_length()) + n_pairs)),
        ("verify_windows", k3, si._verify_windows_plain, si.verify_windows,
         5, (x["total"] + st["codes"].numel() + 16 * n_pairs
             + 24 * key.numel(), n_pairs * L)),
        ("segmented_merge", k4, si._segmented_merge_plain,
         si.segmented_merge, 10,
         (24 * (n_in + 2 * n_mid + n_out), n_in + n_mid)),
        pack_case(si, merged[:3], b_pos, "ebola175"),
    ])


def pack_case(si, rows, b_pos, what):
    """The compare case of pack_merged on merged rows: K9 reads each row
    once (24 bytes) and writes 4 + b_pos bytes of it and 24 bytes per
    escape, with an operation per byte it writes."""
    n = rows[0].numel()
    n_esc = si._pack_merged_plain(*rows, b_pos)[1].numel()
    print(f"pack_merged shapes ({what}): {n} merged rows, b_pos={b_pos}, "
          f"{n_esc} escapes", flush=True)
    out_bytes = (4 + b_pos) * n + 24 * n_esc
    return ("pack_merged", lambda f: f(*rows, b_pos), si._pack_merged_plain,
            si.pack_merged, 20, (24 * n + out_bytes, out_bytes))


def compare(torch, cases, twin_reps=None):
    """Each kernel against its twin on the same inputs: exactly equal,
    then CUDA-event medians, min and max of both (the twin over
    twin_reps calls, by default half the kernel's and at least 2),
    beside the bound of the case's (bytes, operations); returns the
    JSON rows.  No single PyTorch call computes any of these functions,
    so library_ms is null."""
    rows = []
    for name, call, twin, kernel, reps, work in cases:
        got, want = call(kernel), call(twin)
        torch.cuda.synchronize()
        err = max_abs_err(torch, got, want)
        if err != 0:
            fail(f"{name}: kernel differs from its twin (max abs err {err})")
        ms_k, lo_k, hi_k = cuda_ms(torch, lambda: call(kernel), reps)
        # the equality check just called the twin: with twin_reps given
        # that call is its warm-up
        ms_t, lo_t, hi_t = cuda_ms(torch, lambda: call(twin),
                                   twin_reps or max(2, reps // 2),
                                   warm=twin_reps is None)
        bound_ms, bound_by = bound(work)
        print(f"{name}: equal to twin; kernel {ms_k:.3f} ms "
              f"[{lo_k:.3f}, {hi_k:.3f}], twin {ms_t:.3f} ms "
              f"[{lo_t:.3f}, {hi_t:.3f}]; bound {bound_ms:.4f} ms "
              f"({bound_by}: {work[0]} bytes, {work[1]} operations)",
              flush=True)
        rows.append(dict(name=name, route="cuda",
                         source=SOURCES[name],
                         replaces=REPLACES[name], launches=None,
                         max_abs_err=err, ms=ms_k, ms_min=lo_k, ms_max=hi_k,
                         plain_ms=ms_t, plain_ms_min=lo_t, plain_ms_max=hi_t,
                         bound_ms=bound_ms, bound_by=bound_by,
                         library_ms=None))
    return rows


def check_span_kernels(torch, device, scf, cands, bg):
    """Phase 6: expand_join and verify_spans against their twins on the
    inputs of the avoid scan's first batch; returns the JSON rows."""
    import numpy as np

    from catch_tpu_torch.filters.set_cover_filter import _reverse_complement
    from catch_tpu_torch.ops import scan_sparse as ss
    from catch_tpu_torch.ops.cover import ProbeSearcher
    from catch_tpu_torch.utils import seq_io

    batch, batch_bp = [], 0
    for seq in seq_io.iterate_fasta(bg):
        batch.append(seq)
        batch_bp += len(seq)
        if batch_bp >= scf._AVOID_BATCH_BP:
            break
    strands = batch + [_reverse_complement(x) for x in batch]
    searcher = ProbeSearcher(cands, scf.tolerant_model,
                             kmer_probe_map_k=scf.kmer_probe_map_k,
                             device=device)
    t0 = time.time()
    mega, starts, ends, total = ss.corpus_codes(searcher, strands)
    lo, cnt, pos = ss.join_runs(searcher, mega[:total])
    host_s = time.time() - t0
    if int(cnt.sum()) > ss._EXPAND_SLAB:
        fail("the first avoid batch needs more than one expansion slab")

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    lo_t, cnt_t, pos_t = put(lo), put(cnt), put(pos)
    join_p, join_pos = ss.join_table(searcher, device)
    lmax = int(searcher.Lmax)

    def k5(fn):
        return fn(lo_t, cnt_t, pos_t, join_p, join_pos, lmax)

    p, a = k5(ss.expand_join)
    cand = ss.keep_candidates(searcher, p, a, put(starts), put(ends))
    mega_t, codes_t = put(mega), put(searcher.probe_codes)
    vargs = ss.verify_args(searcher)

    def k6(fn):
        return fn(mega_t, codes_t, *cand, **vargs)

    print(f"avoid batch 1 shapes: {len(batch)} chromosomes, {batch_bp} bp, "
          f"{len(strands)} strands, {len(cands)} candidate probes, "
          f"{searcher.probe_codes.shape[0]} unique, join (kj, w) = "
          f"{searcher._join_kw}, {len(searcher._join_h)} table rows; "
          f"{len(lo)} runs, {int(cnt.sum())} hits, {int(p.numel())} pairs, "
          f"{int(cand[0].numel())} kept, {int(k6(ss.verify_spans)[0].numel())}"
          f" spans; host join {host_s:.2f} s", flush=True)
    # K5: a store per hit; K6: a compare per aligned probe position.
    n_cand, n_spans = cand[0].numel(), k6(ss.verify_spans)[0].numel()
    return compare(torch, [
        ("expand_join", k5, ss._expand_join_plain, ss.expand_join, 10,
         (24 * len(lo) + 16 * join_p.numel() + 16 * p.numel(),
          int(cnt.sum()))),
        ("verify_spans", k6, ss._verify_spans_plain, ss.verify_spans, 10,
         (mega_t.numel() + codes_t.numel() + 48 * n_cand + 24 * n_spans,
          n_cand * codes_t.shape[1])),
    ])


def avoid_setup(device):
    """The avoid configuration of bench.py:266-331: the candidates of
    the first 8 ebola genomes, the filter, and the background FASTA."""
    from catch_tpu_torch.filters.candidates import (
        make_candidate_probes_from_sequences)
    from catch_tpu_torch.filters.duplicate import DuplicateFilter
    from catch_tpu_torch.filters.set_cover_filter import SetCoverFilter
    from catch_tpu_torch.utils import seq_io

    genomes = seq_io.read_genomes_from_fasta(write_subset(8))
    t0 = time.time()
    bg = write_background(os.path.join(WORK, "background_100mbp.fasta"),
                          genomes[0].seqs[0])
    print(f"background: {AVOID_BG_BP} bp in {AVOID_BG_CHROMS} chromosomes "
          f"({time.time() - t0:.1f} s to write)", flush=True)
    cands = DuplicateFilter()._filter(make_candidate_probes_from_sequences(
        [s for g in genomes for s in g.seqs], probe_length=100,
        probe_stride=50))
    scf = SetCoverFilter(mismatches=2, lcf_thres=60, cover_extension=50,
                         avoided_genomes=[bg], device=device)
    return genomes, cands, scf, bg


def expected_ranks(n_cands):
    """The ranks of avoid100m_ranks.tsv (made by catch_tpu on the CPU):
    (1, avoided bp) for each listed candidate, (0, 0) for the others,
    densified as SetCoverFilter._make_ranks does."""
    import numpy as np

    path = os.path.join(GOLDEN, "avoid100m_ranks.tsv")
    with open(path) as f:
        head = f.readline()
        if int(head.split()[1]) != n_cands:
            fail(f"{path} is for another candidate set: {head.strip()}")
        flagged = dict(tuple(map(int, line.split())) for line in f)
    vals = [(1, flagged[i]) if i in flagged else (0, 0)
            for i in range(n_cands)]
    idx = {t: i for i, t in enumerate(sorted(set(vals)))}
    return np.array([idx[t] for t in vals], dtype=np.int64), len(flagged)


def counted(torch, si, profiling, fn):
    """Run fn with every launch count and phase set to 0 just before;
    returns (fn's result, wall seconds, launches, peak device bytes)."""
    profiling.reset_phases()
    si.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {name: f.launches for name, f in si.KERNELS.items()}
    return out, wall, launches, torch.cuda.max_memory_allocated()


def print_phases(profiling, prefixes):
    for k, v in sorted(profiling.phase_seconds.items()):
        if k.startswith(prefixes):
            print(f"  phase {k}: {v:.4f} s", flush=True)


def require_launched(launches, names, what):
    for name in names:
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched by {what}")


class PhaseClock:
    """Prints each chip_smoke phase's wall seconds as it ends."""

    def __init__(self):
        self.t0 = time.time()

    def done(self, n):
        now = time.time()
        print(f"chip_smoke phase {n}: {now - self.t0:.1f} s", flush=True)
        self.t0 = now


def design(args, args_type="basic"):
    from catch_tpu_torch.cli import design as cli
    return cli.main(cli.init_and_parse_args(args, args_type=args_type))


def same_bytes(a, b):
    with open(a, "rb") as x, open(b, "rb") as y:
        return x.read() == y.read()


@contextlib.contextmanager
def recording(module, name, keep):
    """module.name wrapped so that keep(args, kwargs, result) sees every
    call; the function itself still runs (and counts its launches)."""
    fn = getattr(module, name)

    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        keep(args, kwargs, out)
        return out

    setattr(module, name, wrapped)
    try:
        yield
    finally:
        setattr(module, name, fn)


def device_busy(path):
    """(device events, busy seconds, seconds by kind) of a chrome trace:
    the union of the card's kernel, copy and set intervals."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ivs, by_kind = [], {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy",
                                                   "gpu_memset"):
            ivs.append((e["ts"], e["ts"] + e["dur"]))
            by_kind[e["cat"]] = by_kind.get(e["cat"], 0.0) + e["dur"] / 1e6
    busy, reach = 0.0, float("-inf")
    for a, b in sorted(ivs):
        if b > reach:
            busy += b - max(a, reach)
            reach = b
    return len(ivs), busy / 1e6, by_kind


def run_design_large(torch, si, profiling, n_genomes, name, profile=False):
    """Phases 10 and 11: design_large through the CLI on cuda, counting
    launches; the clusters (where a golden exists) and the FASTA must
    equal their goldens.  With `profile`, the run goes under
    torch.profiler (CUDA activity) and the card's busy share is printed.
    Returns the launches and what phase 13 keeps: the arguments of the
    largest minhash_sig and minhash_caps calls, of the last full greedy
    wave's minhash_assign call and of the largest cluster's readback
    (its packed rows), and the clustering's signature matrix."""
    from catch_tpu_torch.utils import cluster, lsh

    paths, bp = write_flu(n_genomes)
    out = os.path.join(WORK, f"{name}_design_large.fasta")
    kept, calls, lock = {}, [], threading.Lock()

    def keeper(what, size):
        def keep(args, kwargs, res):
            with lock:
                if what not in kept or size(args) > size(kept[what]):
                    kept[what] = args
        return keep

    def keep_wave(args, kwargs, res):
        # the last full wave (the final one may be short)
        if "assign" not in kept or \
                args[0].shape[0] >= kept["assign"][0].shape[0]:
            kept["assign"] = args

    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA]) if profile \
        else contextlib.nullcontext()
    with recording(cluster, "cluster_with_minhash_signatures",
                   lambda a, k, r: calls.append(
                       (len(a[0]), k["cluster_method"], r))), \
            recording(cluster, "signature_matrix",
                      lambda a, k, r: kept.__setitem__("sigs", r)), \
            recording(cluster, "minhash_assign", keep_wave), \
            recording(cluster, "minhash_caps", keeper(
                "caps", lambda a: a[0].shape[0] * a[1].shape[0])), \
            recording(si, "instance_to_host", keeper(
                "pack", lambda a: a[0]["packed"][0].numel())), \
            recording(lsh, "minhash_sig", keeper(
                "sig", lambda a: a[0].shape[0])), prof:
        pb, wall, launches, peak = counted(
            torch, si, profiling, lambda: design(
                paths + ["-o", out, "--device", "cuda"], "large"))
    (n_seqs, method, clusters), = calls
    print(f"{name} design_large: {len(pb.final_probes)} probes from "
          f"{len(pb.candidate_probes)} candidates; {n_seqs} sequences, "
          f"{bp} bp, {len(clusters)} clusters ({method}) of "
          f"{len(clusters[-1])}-{len(clusters[0])}; wall {wall:.3f} s; "
          f"peak allocated device memory {peak / 2**20:.1f} MiB", flush=True)
    print_phases(profiling, ("cluster", "candidate", "filter", "set_cover",
                             "scan"))
    print(f"launches in the {name} design_large: {launches}", flush=True)
    if profile:
        trace = os.path.join(WORK, f"{name}_design_large_trace.json")
        prof.export_chrome_trace(trace)
        n_ev, busy, by_kind = device_busy(trace)
        kinds = ", ".join(f"{k} {v:.4f} s" for k, v in sorted(by_kind.items()))
        print(f"{name} design_large under torch.profiler (CUDA activity): "
              f"{n_ev} device events; the card busy {busy:.4f} s of the "
              f"{wall:.3f} s wall, {100 * busy / wall:.4f}% ({kinds})",
              flush=True)
    golden = os.path.join(GOLDEN, f"{name}_clusters.tsv.gz")
    if os.path.exists(golden):
        if cluster_ranks(clusters, n_seqs) != read_cluster_ranks(golden):
            fail(f"{name} clusters differ from {golden}")
        print(f"{name} clusters equal to golden", flush=True)
    if not same_bytes(out, os.path.join(GOLDEN,
                                        f"{name}_design_large.fasta")):
        fail(f"{name} design_large output differs from its golden")
    print(f"{name} design_large FASTA equal to golden", flush=True)
    require_launched(launches, DESIGN_KERNELS + [
        "minhash_assign", "minhash_caps", "minhash_sig"],
        f"the {name} design_large")
    return launches, kept


def cluster_scale(torch, si, profiling, device):
    """Phase 12: the clustering step of design_large's defaults on the
    51 Mbp scale corpus, as ProbeDesigner._cluster_genomes runs it, with
    fragments of 50,000 nt ('choose' gives 'simple') and of 10,000 nt
    ('hierarchical'); both must equal their goldens.  Returns per kernel
    its launches and the signature matrix it got."""
    from catch_tpu_torch.designer import ProbeDesigner
    from catch_tpu_torch.genome import Genome
    from catch_tpu_torch.utils import cluster

    t0 = time.time()
    genomes = [Genome.from_one_seq(x) for x in scale_seqs()]
    print(f"scale corpus: {len(genomes)} genomes, "
          f"{sum(g.size() for g in genomes)} bp ({time.time() - t0:.1f} s "
          "to make)", flush=True)
    out = {}
    for frag, method, name, kernel in (
            (50000, "simple", "scale51m_clusters_simple", "minhash_codes"),
            (10000, "hierarchical",
             "scale51m_frag10k_clusters_hierarchical", "minhash_dists")):
        pb = ProbeDesigner([genomes], [], probe_length=100, probe_stride=50,
                           cluster_threshold=0.15, cluster_method="choose",
                           cluster_fragment_length=frag, device=device)
        calls, sigs = [], []
        with recording(cluster, "cluster_with_minhash_signatures",
                       lambda a, k, r: calls.append(
                           (len(a[0]), k["cluster_method"], r))), \
                recording(cluster, "signature_matrix",
                          lambda a, k, r: sigs.append(r)):
            _, wall, launches, peak = counted(torch, si, profiling,
                                              pb._cluster_genomes)
        (n, got, clusters), = calls
        if got != method:
            fail(f"fragments of {frag}: 'choose' gave {got}, not {method}")
        if cluster_ranks(clusters, n) != read_cluster_ranks(
                os.path.join(GOLDEN, f"{name}.tsv.gz")):
            fail(f"scale corpus clusters ({method}) differ from {name}")
        print(f"scale corpus, fragments of {frag}: {n} sequences, "
              f"{len(clusters)} clusters ({method}), equal to golden; wall "
              f"{wall:.3f} s; peak allocated device memory "
              f"{peak / 2**20:.1f} MiB; launches {launches}", flush=True)
        print_phases(profiling, ("cluster",))
        require_launched(launches, [kernel], f"the {method} clustering")
        out[kernel] = (launches[kernel], sigs[-1])
    return out


def check_minhash_kernels(torch, si, kept, frag_sigs, flu_sigs):
    """Phase 13: minhash_caps' four entry points and minhash_sig against
    their twins at the shapes phases 11 and 12 gave them, and
    pack_merged at flu10k's largest cluster.  Returns the JSON rows of
    the MinHash kernels (the all-pairs entries at phase 12's fragment
    shapes)."""
    from catch_tpu_torch.ops import minhash as mh
    from catch_tpu_torch.utils import cluster

    codes, ab = kept["sig"]
    (U, n), H = codes.shape, ab.shape[0]
    wave, reps, n_reps, cap_thr = kept["assign"]
    (Q, N), R = wave.shape, reps.shape[0]
    blk, blk_r = kept["caps"]
    C, C_r = blk.shape[0], blk_r.shape[0]
    print(f"minhash_sig shapes: the largest near-duplicate group, U={U} "
          f"unique candidate probes, n={n} k-mers, H={H} hash functions; "
          f"greedy wave: Q={Q} queries, R={R} representatives, N={N}; "
          f"largest minhash_caps call: {C} x {C_r} leftovers of a wave",
          flush=True)

    def pairs(q, r, out_bytes):
        # bytes: both signature blocks and the output; operations: four
        # (two compares, two adds) per (pair, column) of the walk
        return 4 * (q + r) * N + out_bytes * q * r, 4 * q * r * N

    rows = compare(torch, [
        ("minhash_sig", lambda f: (f(codes, ab),), mh._minhash_sig_plain,
         mh.minhash_sig, 10, (4 * U * n + 8 * H + 4 * U * H, 4 * U * n * H)),
        ("minhash_assign", lambda f: f(wave, reps, n_reps, cap_thr),
         mh._minhash_assign_plain, mh.minhash_assign, 10,
         (4 * (Q + R) * N + 9 * Q, 4 * Q * R * N)),
        ("minhash_caps", lambda f: (f(blk, blk_r),), mh._minhash_caps_plain,
         mh.minhash_caps, 10, pairs(C, C_r, 1)),
    ])
    # the rows pack_merged got, decoded from what it gave; packing them
    # again must give the same bytes
    dev = kept["pack"][0]
    packed, b_pos = dev["packed"], dev["b_pos"]
    merged = tuple(torch.from_numpy(x).to(wave.device) for x in
                   si.unpack_merged(*(x.cpu().numpy() for x in packed),
                                    b_pos))
    if max_abs_err(torch, si.pack_merged(*merged, b_pos), packed):
        fail("pack_merged of the decoded flu10k rows differs from the run's")
    compare(torch, [pack_case(si, merged, b_pos,
                              "flu10k's largest cluster")])
    cap_t = cluster._min_cap(N, cluster._jaccard_dist_from_mash_dist(0.15,
                                                                     12))
    cap_e = cluster._min_cap(N, cluster._jaccard_dist_from_mash_dist(0.02,
                                                                     12))
    for sigs, what in ((frag_sigs, "phase 12's fragments"),
                       (flu_sigs, "the first flu10k sequences")):
        m = sigs.shape[0]
        print(f"all-pairs shapes: {m} signatures of {what}, N={N}",
              flush=True)
        # the twin takes seconds here: one timed call
        got = compare(torch, [
            ("minhash_dists", lambda f, x=sigs: (f(x, x),),
             mh._minhash_dists_plain, mh.minhash_dists, 5, pairs(m, m, 4)),
            ("minhash_codes", lambda f, x=sigs: (f(x, x, cap_t, cap_e),),
             mh._minhash_codes_plain, mh.minhash_codes, 5, pairs(m, m, 1)),
        ], twin_reps=1)
        print(f"row shapes: one of the {m} signatures against all",
              flush=True)
        compare(torch, [("minhash_dists", lambda f, x=sigs: (
            f(x[m // 2:m // 2 + 1], x),), mh._minhash_dists_plain,
            mh.minhash_dists, 20, pairs(1, m, 4))])
        if sigs is frag_sigs:
            rows += got
    return rows


def main():
    if not os.path.isdir(os.path.join(ROOT, "catch_tpu_torch")):
        fail("catch_tpu_torch/ is not beside chip_smoke.py; run it from the "
             "root of a checkout")
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda is not available")
    os.makedirs(WORK, exist_ok=True)
    device = torch.device("cuda", 0)
    clock = PhaseClock()

    # Phase 1: the card and the toolchain.
    card = run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}", flush=True)
    from catch_tpu_torch import _build
    print(run([_build._nvcc(), "--version"]).splitlines()[-1], flush=True)
    try:
        import triton
        print(f"triton {triton.__version__}", flush=True)
    except ImportError:
        print("triton: not installed", flush=True)
    clock.done(1)

    # Phase 2: build.
    t0 = time.time()
    _build.library()
    print(f"kernel build: {time.time() - t0:.1f} s "
          f"(nvcc {_build.build_seconds:.1f} s)", flush=True)
    clock.done(2)

    # Phase 3: the design kernels against their twins.
    rows = check_kernels(torch, device)
    clock.done(3)

    from catch_tpu_torch.ops import scan_instance as si
    # Importing scan_sparse registers its kernels in si.KERNELS.
    from catch_tpu_torch.ops import scan_sparse  # noqa: F401
    from catch_tpu_torch.utils import profiling

    # Phase 4: ebola5 m0 (the verify fast path).
    out5 = os.path.join(WORK, "ebola5_m0.fasta")
    design([write_subset(5), "-o", out5, "-pl", "100", "-m", "0", "-e", "0",
            "--device", "cuda"])
    if fasta_records(out5) != fasta_records(
            os.path.join(GOLDEN, "ref_ebola5_m0.fasta")):
        fail("ebola5 m0 probe set differs from ref_ebola5_m0.fasta")
    print(f"ebola5 m0: {len(fasta_records(out5))} probes, equal to golden",
          flush=True)
    clock.done(4)

    # Phase 5: ebola175 m2 through the CLI, counting launches.
    design_kernels = [r["name"] for r in rows]
    out175 = os.path.join(WORK, "ebola175_m2.fasta")
    in175 = write_subset(175)
    pb, wall, launches, _ = counted(torch, si, profiling, lambda: design(
        [in175, "-o", out175, "-pl", "100", "-m", "2", "-l", "60", "-e",
         "50", "--device", "cuda"]))
    with open(out175, "rb") as a, open(
            os.path.join(GOLDEN, "torch_ebola175_m2.fasta"), "rb") as b:
        if a.read() != b.read():
            fail("ebola175 m2 output differs from torch_ebola175_m2.fasta")
    stats = pb.filters[-1].last_run_stats
    print(f"ebola175 m2: {len(pb.final_probes)} probes, equal to golden; "
          f"wall {wall:.3f} s; {stats['candidates_evaluated']} candidates; "
          f"{stats['set_cover_picks']} picks", flush=True)
    print_phases(profiling, ("candidate", "filter", "set_cover", "scan"))
    print(f"launches in the ebola175 run: {launches}", flush=True)
    require_launched(launches, design_kernels, "the ebola175 design")
    for r in rows:
        r["launches"] = launches[r["name"]]
    clock.done(5)

    # Phase 6: the span kernels against their twins at the avoid shapes.
    genomes8, cands, scf, bg = avoid_setup(device)
    span_rows = check_span_kernels(torch, device, scf, cands, bg)
    clock.done(6)

    # Phase 7: the identify and avoid goldens through the CLI.
    for name, argv in (
            ("identify", ["identify_a.fasta", "identify_b.fasta", "-i",
                          "-c", "0.5"]),
            ("avoid", ["avoid_target.fasta", "--avoid-genomes",
                       "avoid_bg.fasta"])):
        out = os.path.join(WORK, f"{name}_m0.fasta")
        argv = [os.path.join(GOLDEN, a) if a.endswith(".fasta") else a
                for a in argv]
        design(argv + ["-o", out, "-pl", "60", "-ps", "30", "-m", "0",
                       "-e", "0", "--device", "cuda"])
        golden = os.path.join(GOLDEN, f"ref_{name}_m0.fasta")
        if fasta_records(out) != fasta_records(golden):
            fail(f"{name} m0 probe set differs from {golden}")
        print(f"{name} m0: {len(fasta_records(out))} probes, equal to "
              "golden", flush=True)
    clock.done(7)

    # Phase 8: the avoid scan at real size, counting launches.
    want, n_flagged = expected_ranks(len(cands))
    ranks, wall, launches, peak = counted(
        torch, si, profiling, lambda: scf._make_ranks(cands, [genomes8]))
    if not (ranks == want).all():
        fail("avoid ranks differ from avoid100m_ranks.tsv")
    print(f"avoid 100 Mbp: ranks equal to golden ({len(cands)} candidates, "
          f"{n_flagged} flagged); wall {wall:.3f} s; "
          f"{2 * AVOID_BG_BP / wall:.0f} bp/s over both strands; peak "
          f"allocated device memory {peak / 2**20:.1f} MiB", flush=True)
    print_phases(profiling, ("span",))
    print(f"launches in the avoid scan: {launches}", flush=True)
    require_launched(launches, ["expand_join", "verify_spans",
                                "segmented_merge"], "the avoid scan")
    for r in span_rows:
        r["launches"] = launches[r["name"]]
    clock.done(8)

    # Phase 9: coverage analysis of ebola175 through the CLI.
    from catch_tpu_torch.cli import analyze_probe_coverage as analyze
    tsv = {k: os.path.join(WORK, f"ebola175_m2_{k}.tsv")
           for k in ("analysis", "probe_map_counts")}
    _, wall, launches, peak = counted(torch, si, profiling, lambda: (
        analyze.main(analyze.init_and_parse_args([
            "-d", in175, "-f", os.path.join(GOLDEN,
                                            "torch_ebola175_m2.fasta"),
            "-m", "2", "-l", "60", "-e", "50",
            "--write-analysis-to-tsv", tsv["analysis"],
            "--write-probe-map-counts-to-tsv", tsv["probe_map_counts"],
            "--device", "cuda"]))))
    for k, path in tsv.items():
        with open(path, "rb") as a, open(
                os.path.join(GOLDEN, f"ebola175_m2_{k}.tsv"), "rb") as b:
            if a.read() != b.read():
                fail(f"ebola175 {k} TSV differs from its golden")
    print(f"ebola175 analysis: both TSVs equal to goldens; wall {wall:.3f} s;"
          f" peak allocated device memory {peak / 2**20:.1f} MiB",
          flush=True)
    print_phases(profiling, ("span",))
    print(f"launches in the analysis: {launches}", flush=True)
    require_launched(launches, ["expand_join", "verify_spans"],
                     "the analysis")
    clock.done(9)
    rows += span_rows

    # Importing the clustering registers the MinHash kernels.
    from catch_tpu_torch.utils import cluster  # noqa: F401

    # Phase 10: design_large on flu2000.
    run_design_large(torch, si, profiling, 2000, "flu2000")
    clock.done(10)

    # Phase 11: design_large on flu10k, keeping kernel inputs.
    launches, kept = run_design_large(torch, si, profiling, 10000, "flu10k",
                                      profile=True)
    clock.done(11)

    # Phase 12: the all-pairs methods on the 51 Mbp scale corpus.
    scale = cluster_scale(torch, si, profiling, device)
    clock.done(12)

    # Phase 13: the MinHash kernels against their twins.
    mh_rows = check_minhash_kernels(torch, si, kept,
                                    scale["minhash_dists"][1],
                                    kept["sigs"][:8192])
    for r in mh_rows:
        r["launches"] = (scale[r["name"]][0] if r["name"] in scale
                         else launches[r["name"]])
    rows += mh_rows
    clock.done(13)

    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
