#!/usr/bin/env python3
"""Step-by-step CUDA-event split of K4 (segmented_merge) on the inputs of
its three callers, on one NVIDIA GPU.

Run from the root of a checkout:  python3 tools/k4_split.py [--root DIR]

--root names the checkout whose catch_tpu_torch is timed (default: the
one holding this script), so that one call can time two trees.  The
inputs:
  pair   ebola175's pair merge: the spans that verify_windows gives on
         chip_smoke.kernel_inputs' design (keys probe * nU + universe);
  union  its per-universe union: the merged rows keyed by universe;
  avoid  the avoid scan's per-(probe, strand) merge in
         SetCoverFilter._tolerant_bp_batched, recorded over the 100 Mbp
         avoid scan of chip_smoke's phase 8 (the largest of its calls).
Each step is bracketed by CUDA events over 10 calls after a warm-up; the
medians are printed, with the wrapper's whole time, its peak device
memory above what was allocated before the call, the largest key
group, the tiers the buckets took (where the library has them), and the
device time of each kernel a call launches (torch.profiler, CUDA
activity).  Last, one ebola175 design (-pl 100 -m 2 -l 60 -e 50, host
solver) runs with the peak reset around each stage-D call, which tells
whether stage D sets the design's peak.

The script knows two implementations of K4 and times the one the
library holds: the sort route (torch.sort of the packed keys, a block
scan, a carry pass, a fix-up, torch.cumsum and the emit) and the bucket
route (csrc/segmented_merge.cu: buckets of whole keys sorted and merged
in shared memory).
"""

import argparse
import contextlib
import importlib.util
import json
import os
import statistics
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 10


def sort_route(torch, si, _build, key, start, end, st):
    """The parent's segmented_merge, step by step."""
    lib, stream, dev = _build.library(), _build.stream_of(key), key.device
    n = key.numel()
    st.mark("start")
    sp, order = torch.sort((key << 32) | start, stable=True)
    st.mark("torch.sort")
    nb = -(-n // 1024)
    local = torch.empty(n, dtype=torch.int64, device=dev)
    agg_head = torch.empty(nb, dtype=torch.int32, device=dev)
    agg_v = torch.empty(nb, dtype=torch.int64, device=dev)
    carry = torch.empty(nb, dtype=torch.int64, device=dev)
    rmax = torch.empty(n, dtype=torch.int64, device=dev)
    flags = torch.empty(n, dtype=torch.int64, device=dev)
    _build.check(lib.ct_merge_block_scan(
        _build.ptr(sp), _build.ptr(order), n, _build.ptr(end),
        _build.ptr(local), _build.ptr(agg_head), _build.ptr(agg_v), stream),
        "merge_block_scan")
    st.mark("block scan")
    _build.check(lib.ct_merge_carry(_build.ptr(agg_head), _build.ptr(agg_v),
                                    nb, _build.ptr(carry), stream),
                 "merge_carry")
    st.mark("carry")
    _build.check(lib.ct_merge_fixup(
        _build.ptr(sp), _build.ptr(local), _build.ptr(carry), n,
        _build.ptr(rmax), _build.ptr(flags), stream), "merge_fixup")
    st.mark("fix-up")
    pos = torch.cumsum(flags, 0)
    n_runs = int(pos[-1])
    st.mark("cumsum+read")
    out = [torch.empty(n_runs, dtype=torch.int64, device=dev)
           for _ in range(3)]
    _build.check(lib.ct_merge_emit(
        _build.ptr(sp), _build.ptr(rmax), _build.ptr(flags), _build.ptr(pos),
        n, *[_build.ptr(x) for x in out], stream), "merge_emit")
    st.mark("emit")
    return tuple(out)


def bucket_route(torch, si, _build, key, start, end, st):
    return si._segmented_merge_cuda(key, start, end, si.MERGE_TILE, steps=st)


def timed(torch, Steps, fn):
    """Median step times, whole-call median, min and max, and peak bytes
    above the allocation before the call, of fn(st)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn(Steps(torch))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    splits, whole = [], []
    for _ in range(REPS):
        st = Steps(torch)
        fn(st)
        sp = st.split()
        splits.append(sp)
        whole.append(sum(sp.values()))
    med = {k: statistics.median(sp[k] for sp in splits) for k in splits[0]}
    return med, (statistics.median(whole), min(whole), max(whole)), peak


def kernel_times(torch, fn, reps=5):
    """Device microseconds a call by kernel name, from torch.profiler
    (CUDA activity) over reps calls."""
    act = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0)
        if us:
            out[ev.key[:60]] = round(us / reps, 1)
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


@contextlib.contextmanager
def wrapping(si, make):
    """si.segmented_merge replaced by make(the function) for a while.
    The wrapper has a launches count of its own: the wrapped function
    counts its launches on whatever the module's name holds."""
    fn = si.segmented_merge
    si.segmented_merge = make(fn)
    si.segmented_merge.launches = 0
    try:
        yield
    finally:
        si.segmented_merge = fn


def avoid_input(torch, chip_smoke, si, device):
    """The largest segmented_merge call of the 100 Mbp avoid scan, and
    the number of its calls."""
    genomes8, cands, scf, _ = chip_smoke.avoid_setup(device)
    kept = {"calls": 0}

    def make(fn):
        def wrapped(*args):
            kept["calls"] += 1
            if args[0].numel() > kept.get("n", -1):
                kept["n"] = args[0].numel()
                kept["args"] = tuple(x.clone() for x in args)
            return fn(*args)
        return wrapped

    with wrapping(si, make):
        scf._make_ranks(cands, [genomes8])
    return kept["args"], kept["calls"]


def design_peaks(torch, chip_smoke, si):
    """ebola175 m2 (host solver) with the peak reset around each stage-D
    call: the peaks before, during each call and after, in MiB."""
    marks = []

    def stage_d(fn):
        def wrapped(*args):
            torch.cuda.synchronize()
            marks.append(("before", torch.cuda.max_memory_allocated()))
            torch.cuda.reset_peak_memory_stats()
            out = fn(*args)
            torch.cuda.synchronize()
            marks.append(("merge", torch.cuda.max_memory_allocated()))
            torch.cuda.reset_peak_memory_stats()
            return out
        return wrapped

    with wrapping(si, stage_d):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        chip_smoke.design([chip_smoke.write_subset(175), "-o",
                           os.path.join(chip_smoke.WORK, "k4_split.fasta"),
                           "-pl", "100", "-m", "2", "-l", "60", "-e", "50",
                           "--device", "cuda"])
        torch.cuda.synchronize()
        marks.append(("after", torch.cuda.max_memory_allocated()))
    return [(k, round(v / 2**20, 1)) for k, v in marks]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    root = os.path.abspath(ap.parse_args().root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        sys.exit("k4_split: torch.cuda is not available")
    # this checkout's chip_smoke (its inputs and Steps), whatever --root
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    os.makedirs(chip_smoke.WORK, exist_ok=True)
    from catch_tpu_torch import _build
    from catch_tpu_torch.ops import scan_instance as si
    if not os.path.abspath(si.__file__).startswith(root):
        sys.exit(f"k4_split: imported {si.__file__}, not from {root}")
    lib = _build.library()
    old = hasattr(lib, "ct_merge_block_scan")
    route, split = ("sort", sort_route) if old else ("bucket", bucket_route)
    device = torch.device("cuda", 0)
    card = chip_smoke.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"]).splitlines()[0]

    x = chip_smoke.kernel_inputs(torch, device)
    st_, kj, s, nU = x["st"], x["kj"], x["s"], x["nU"]
    tbl = si.build_table(st_["codes"], kj)
    q = si.rolling_hash(st_["mega"], -(-x["total"] // s), s, kj,
                        x["total"] - kj)
    pc, ac = si.lookup_expand(*tbl, q, s)
    spans = si.verify_windows(
        st_["mega"], st_["codes"], st_["lens"], pc, ac, st_["seq_starts"],
        st_["seq_ends"], st_["seq_lens"], st_["chrom_off"],
        st_["univ_of_seq"], K=x["K"], k_seed=x["k_seed"],
        lcf=int(x["searcher"].lcf_static), seed_req=x["k_seed"],
        fast_ok=bool(x["searcher"].fast_ok), ext=50, nU=nU)
    del tbl, q, pc, ac, x
    merged = si._segmented_merge_plain(*spans)
    cases = [("pair", spans), ("union", (merged[0] % nU,) + merged[1:])]
    del merged
    avoid, calls = avoid_input(torch, chip_smoke, si, device)
    cases.append(("avoid", avoid))
    print(json.dumps(dict(card=card, route=route, root=root,
                          avoid_calls=calls)), flush=True)

    for what, (key, start, end) in cases:
        want = si._segmented_merge_plain(key, start, end)
        holder = {}

        def run_one(st, key=key, start=start, end=end):
            holder["out"] = split(torch, si, _build, key, start, end, st)

        med, whole, peak = timed(torch, chip_smoke.Steps, run_one)
        for g, w in zip(holder["out"], want):
            if not torch.equal(g, w):
                sys.exit(f"k4_split: segmented_merge differs from its twin "
                         f"on {what}")
        row = dict(
            card=card, route=route, what=what, rows_in=int(key.numel()),
            rows_out=int(want[0].numel()), keys=int(key.max()) + 1,
            distinct_keys=int(torch.unique(key).numel()),
            largest_group=int(torch.bincount(key).max()),
            max_start=int(start.max()), max_end=int(end.max()),
            steps_ms=med, whole_ms=whole, peak_mib=peak / 2**20,
            twin_ms=chip_smoke.cuda_ms(
                torch, lambda: si._segmented_merge_plain(key, start, end),
                3)[0],
            kernel_us=kernel_times(torch, lambda: run_one(
                chip_smoke.Steps(torch))))
        if hasattr(si, "merge_tiers"):
            row["tiers"] = si.merge_tiers(key, start, end, si.MERGE_TILE)
        print(json.dumps(row), flush=True)
    del cases, avoid, spans
    print(json.dumps(dict(card=card, route=route, what="ebola175 design "
                          "peaks (MiB)", peaks=design_peaks(torch, chip_smoke,
                                                            si))), flush=True)


if __name__ == "__main__":
    main()
