#!/usr/bin/env python3
"""Step-by-step CUDA-event split of K2 (lookup_expand and dedup_pairs) on
the ebola175 inputs, on one NVIDIA GPU.

Run from the root of a checkout:  python3 tools/k2_split.py [--root DIR]

--root names the checkout whose catch_tpu_torch is timed (default: the
one holding this script), so that one call can time two trees.  The
inputs are chip_smoke.kernel_inputs' (the ebola175 design: the probe
table, the 369,010 sample hashes) and, for dedup_pairs, the pairs that
the four places of the mesh-split scan hand to the lead
(chip_smoke.dedup_case).  Each step is bracketed by CUDA events over 10
calls after a warm-up; the medians are printed, with the wrapper's
whole time, its peak device memory above what was allocated before the
call, the raw hit count, and the device time of each kernel a call
launches (torch.profiler, CUDA activity).

The script times the probe-major merge join and the probe-bucketed
dedup of csrc/lookup_expand.cu and csrc/dedup_pairs.cu, on the tree's
own seed table: the probe-major one of build_table, or an older tree's
hash-sorted (hash, probe, offset) arrays.
"""

import argparse
import importlib.util
import json
import os
import statistics
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 10


def timed(torch, Steps, fn):
    """Median step times, whole-call median and peak bytes of fn(st)."""
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
    return med, statistics.median(whole), peak


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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    root = os.path.abspath(ap.parse_args().root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        sys.exit("k2_split: torch.cuda is not available")
    # this checkout's chip_smoke (its inputs and Steps), whatever --root
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    os.makedirs(chip_smoke.WORK, exist_ok=True)
    from catch_tpu_torch.ops import scan_instance as si
    if not os.path.abspath(si.__file__).startswith(root):
        sys.exit(f"k2_split: imported {si.__file__}, not from {root}")
    device = torch.device("cuda", 0)
    card = chip_smoke.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"]).splitlines()[0]

    x = chip_smoke.kernel_inputs(torch, device)
    st_, kj, s, total = x["st"], x["kj"], x["s"], x["total"]
    tbl = si.build_table(st_["codes"], kj)
    q = si.rolling_hash(st_["mega"], -(-total // s), s, kj, total - kj)
    want = si._lookup_expand_plain(*tbl, q, s)
    holder = {}

    def run_lookup(st):
        holder["out"] = si._lookup_expand_cuda(*tbl, q, s, 0, steps=st)

    med, whole, peak = timed(torch, chip_smoke.Steps, run_lookup)
    for g, w in zip(holder["out"], want):
        if not torch.equal(g, w):
            sys.exit("k2_split: lookup_expand differs from its twin")
    h = (si.table_entries(*tbl)[0] if len(tbl) == 2
         else tbl[0][tbl[0] != si.HMAX])
    qs = torch.sort(q).values
    raw = int((torch.searchsorted(qs, h, right=True)
               - torch.searchsorted(qs, h)).sum())
    print(json.dumps(dict(
        card=card, root=root, what="lookup_expand",
        probes=int(st_["codes"].shape[0]), table_entries=int(h.numel()),
        samples=int(q.numel()), raw_hits=raw, pairs=int(want[0].numel()),
        steps_ms=med, whole_ms=whole, peak_mib=peak / 2**20,
        kernel_us=kernel_times(torch, lambda: run_lookup(
            chip_smoke.Steps(torch))))), flush=True)
    del want, holder

    n = chip_smoke.MESH_PLACES
    ranges = si.split_range(-(-total // s), n)
    pairs = [si._lookup_expand_plain(
        *tbl, si.rolling_hash(st_["mega"][g0 * s:], g1 - g0, s, kj,
                              total - kj - g0 * s), s, g0)
             for g0, g1 in zip(ranges, ranges[1:])]
    p, a = si.join_on(device, pairs)
    del pairs
    want = si._dedup_pairs_plain(p, a)

    def run_dedup(st):
        holder["out"] = si._dedup_pairs_cuda(p, a, si.DEDUP_TILE, steps=st)

    holder = {}
    med, whole, peak = timed(torch, chip_smoke.Steps, run_dedup)
    for g, w in zip(holder["out"], want):
        if not torch.equal(g, w):
            sys.exit("k2_split: dedup_pairs differs from its twin")
    keys = (p << 32) | a
    lib_ms = chip_smoke.cuda_ms(torch, lambda: torch.unique(keys), REPS)[0]
    print(json.dumps(dict(
        card=card, root=root, what="dedup_pairs",
        pairs_in=int(p.numel()), pairs_out=int(want[0].numel()),
        steps_ms=med, whole_ms=whole, peak_mib=peak / 2**20,
        torch_unique_packed_ms=lib_ms,
        kernel_us=kernel_times(torch, lambda: run_dedup(
            chip_smoke.Steps(torch))))), flush=True)


if __name__ == "__main__":
    main()
