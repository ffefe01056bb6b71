#!/usr/bin/env python3
"""Smoke run of catch_tpu_torch's design and span paths on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. the card (nvidia-smi name and power limit), torch, CUDA, nvcc and
     triton versions;
  2. the build of the six CUDA kernels from catch_tpu_torch/csrc/;
  3. the four design-scan kernels against their plain-PyTorch twins on
     the card, on the inputs the ebola175 design gives them: outputs
     must be exactly equal; median times of both from CUDA events;
  4. ebola5 (-pl 100 -m 0 -e 0) through catch_tpu_torch.cli.design on
     cuda; the probe set must equal tests/data/golden/ref_ebola5_m0.fasta;
  5. ebola175 (-pl 100 -m 2 -l 60 -e 50), the first 175 genomes of
     tests/data/zaire_ebolavirus.fasta.gz, through the same CLI on cuda,
     with every kernel's launch count set to 0 just before; the output
     must equal tests/data/golden/torch_ebola175_m2.fasta byte for byte,
     and the four design kernels must have launched;
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
     counting launches; both TSVs must equal their goldens.

Each phase prints its wall seconds as it ends.  The line before the
last is the card's name and power limit; the one before it a JSON
object with one entry per kernel; the last line is
{"ok": true, "device": {...}}.  Scratch files go under build/chip_smoke/.
"""

import gzip
import json
import os
import statistics
import subprocess
import sys
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
    "expand_join": "catch_tpu/ops/scan_sparse.py:192",
    "verify_spans": "catch_tpu/ops/scan_sparse.py:65",
}
SOURCES = {name: f"catch_tpu_torch/csrc/{name}.cu" for name in REPLACES}
SOURCES["verify_spans"] = "catch_tpu_torch/csrc/verify_windows.cu"


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


def cuda_ms(torch, fn, reps):
    """Median milliseconds of fn() from CUDA events, after a warm-up."""
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
    return statistics.median(times)


def max_abs_err(torch, got, want):
    """Max |got - want| over tuples of int64 tensors of equal shapes."""
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            fail(f"shape {tuple(g.shape)} != {tuple(w.shape)}")
        if g.numel():
            err = max(err, int((g - w).abs().max()))
    return err


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
    return compare(torch, [
        ("rolling_hash", k1, si._rolling_hash_plain, si.rolling_hash, 20),
        ("lookup_expand", k2, si._lookup_expand_plain, si.lookup_expand, 10),
        ("verify_windows", k3, si._verify_windows_plain, si.verify_windows,
         5),
        ("segmented_merge", k4, si._segmented_merge_plain,
         si.segmented_merge, 10),
    ])


def compare(torch, cases):
    """Each kernel against its twin on the same inputs: exactly equal,
    then CUDA-event medians of both; returns the JSON rows."""
    rows = []
    for name, call, twin, kernel, reps in cases:
        got, want = call(kernel), call(twin)
        torch.cuda.synchronize()
        err = max_abs_err(torch, got, want)
        if err != 0:
            fail(f"{name}: kernel differs from its twin (max abs err {err})")
        ms_k = cuda_ms(torch, lambda: call(kernel), reps)
        ms_t = cuda_ms(torch, lambda: call(twin), max(2, reps // 2))
        print(f"{name}: equal to twin; kernel {ms_k:.3f} ms, "
              f"twin {ms_t:.3f} ms", flush=True)
        rows.append(dict(name=name, route="cuda",
                         source=SOURCES[name],
                         replaces=REPLACES[name], launches=None,
                         max_abs_err=err, ms=ms_k, plain_ms=ms_t))
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
    return compare(torch, [
        ("expand_join", k5, ss._expand_join_plain, ss.expand_join, 10),
        ("verify_spans", k6, ss._verify_spans_plain, ss.verify_spans, 10),
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


def design(args):
    from catch_tpu_torch.cli import design as cli
    return cli.main(cli.init_and_parse_args(args))


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

    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
