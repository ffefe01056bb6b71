#!/usr/bin/env python3
"""Smoke run of catch_tpu_torch's design path on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. the card (nvidia-smi name and power limit), torch, CUDA, nvcc and
     triton versions;
  2. the build of the four CUDA kernels from catch_tpu_torch/csrc/;
  3. each kernel against its plain-PyTorch twin on the card, on the
     inputs the ebola175 design gives it: outputs must be exactly equal;
     median times of both from CUDA events;
  4. ebola5 (-pl 100 -m 0 -e 0) through catch_tpu_torch.cli.design on
     cuda; the probe set must equal tests/data/golden/ref_ebola5_m0.fasta;
  5. ebola175 (-pl 100 -m 2 -l 60 -e 50), the first 175 genomes of
     tests/data/zaire_ebolavirus.fasta.gz, through the same CLI on cuda,
     with every kernel's launch count set to 0 just before; the output
     must equal tests/data/golden/torch_ebola175_m2.fasta byte for byte,
     and every kernel must have launched.

The line before the last is the card's name and power limit; the one
before it a JSON object with one entry per kernel; the last line is
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
}


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
    cases = [
        ("rolling_hash", k1, si._rolling_hash_plain, si.rolling_hash, 20),
        ("lookup_expand", k2, si._lookup_expand_plain, si.lookup_expand, 10),
        ("verify_windows", k3, si._verify_windows_plain, si.verify_windows,
         5),
        ("segmented_merge", k4, si._segmented_merge_plain,
         si.segmented_merge, 10),
    ]
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
                         source=f"catch_tpu_torch/csrc/{name}.cu",
                         replaces=REPLACES[name], launches=None,
                         max_abs_err=err, ms=ms_k, plain_ms=ms_t))
    return rows


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

    # Phase 2: build.
    t0 = time.time()
    _build.library()
    print(f"kernel build: {time.time() - t0:.1f} s "
          f"(nvcc {_build.build_seconds:.1f} s)", flush=True)

    # Phase 3: kernels against their twins.
    rows = check_kernels(torch, device)

    from catch_tpu_torch.ops import scan_instance as si
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

    # Phase 5: ebola175 m2 through the CLI, counting launches.
    out175 = os.path.join(WORK, "ebola175_m2.fasta")
    in175 = write_subset(175)
    profiling.reset_phases()
    si.reset_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    pb = design([in175, "-o", out175, "-pl", "100", "-m", "2", "-l", "60",
                 "-e", "50", "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {name: fn.launches for name, fn in si.KERNELS.items()}
    with open(out175, "rb") as a, open(
            os.path.join(GOLDEN, "torch_ebola175_m2.fasta"), "rb") as b:
        if a.read() != b.read():
            fail("ebola175 m2 output differs from torch_ebola175_m2.fasta")
    stats = pb.filters[-1].last_run_stats
    print(f"ebola175 m2: {len(pb.final_probes)} probes, equal to golden; "
          f"wall {wall:.3f} s; {stats['candidates_evaluated']} candidates; "
          f"{stats['set_cover_picks']} picks", flush=True)
    for k, v in sorted(profiling.phase_seconds.items()):
        print(f"  phase {k}: {v:.4f} s", flush=True)
    print(f"launches in the ebola175 run: {launches}", flush=True)
    torch.cuda.synchronize()
    t0 = time.time()
    design([in175, "-o", out175, "-pl", "100", "-m", "2", "-l", "60",
            "-e", "50", "--device", "cuda"])
    torch.cuda.synchronize()
    print(f"ebola175 m2 again: wall {time.time() - t0:.3f} s", flush=True)
    for r in rows:
        r["launches"] = launches[r["name"]]
        if r["launches"] <= 0:
            fail(f"kernel {r['name']} was not launched by the design")

    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
