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

The script knows two implementations of K2 and times the one the
library holds: the sort route (ct_lookup, ct_expand, torch.sort of the
raw hits, then the compaction) and the merge route (the probe-major
merge join and the probe-bucketed dedup of csrc/lookup_expand.cu and
csrc/dedup_pairs.cu).
"""

import argparse
import importlib.util
import json
import os
import statistics
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 10


def sort_route_lookup(torch, si, _build, tbl_h, tbl_p, tbl_pos, q, s, st):
    lib, stream, dev = _build.library(), _build.stream_of(q), q.device
    n_q, n_tbl = q.numel(), tbl_h.numel()
    st.mark("start")
    lo = torch.empty(n_q, dtype=torch.int64, device=dev)
    cnt = torch.empty(n_q, dtype=torch.int64, device=dev)
    _build.check(lib.ct_lookup(_build.ptr(tbl_h), n_tbl, _build.ptr(q), n_q,
                               _build.ptr(lo), _build.ptr(cnt), stream),
                 "lookup")
    st.mark("ct_lookup")
    off = torch.cumsum(cnt, 0)
    total = int(off[-1])
    st.mark("cumsum+read")
    keys = torch.empty(total, dtype=torch.int64, device=dev)
    _build.check(lib.ct_expand(
        _build.ptr(lo), _build.ptr(cnt), _build.ptr(off), n_q,
        _build.ptr(tbl_p), _build.ptr(tbl_pos), s, 0, _build.ptr(keys),
        stream), "expand")
    st.mark("ct_expand")
    return sort_route_unique(torch, _build, keys, st), total


def sort_route_unique(torch, _build, keys, st):
    lib, stream, dev = _build.library(), _build.stream_of(keys), keys.device
    total = keys.numel()
    keys = torch.sort(keys, stable=True).values
    st.mark("torch.sort")
    flags = torch.empty(total, dtype=torch.int64, device=dev)
    _build.check(lib.ct_unique_flags(_build.ptr(keys), total,
                                     _build.ptr(flags), stream), "flags")
    pos = torch.cumsum(flags, 0)
    n = int(pos[-1])
    p = torch.empty(n, dtype=torch.int64, device=dev)
    a = torch.empty(n, dtype=torch.int64, device=dev)
    _build.check(lib.ct_unique_emit(
        _build.ptr(keys), _build.ptr(flags), _build.ptr(pos), total,
        _build.ptr(p), _build.ptr(a), stream), "emit")
    st.mark("flags+cumsum+read+emit")
    return p, a


def sort_route_dedup(torch, si, _build, p, a, st):
    st.mark("start")
    keys = (p << 32) | a
    st.mark("pack keys")
    return sort_route_unique(torch, _build, keys, st)


def merge_route_lookup(torch, si, _build, tbl_h, tbl_p, tbl_pos, q, s, st):
    out = si._lookup_expand_cuda(tbl_h, tbl_p, tbl_pos, q, s, 0, steps=st)
    return out, None


def merge_route_dedup(torch, si, _build, p, a, st):
    return si._dedup_pairs_cuda(p, a, si.DEDUP_TILE, steps=st)


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
    from catch_tpu_torch import _build
    from catch_tpu_torch.ops import scan_instance as si
    if not os.path.abspath(si.__file__).startswith(root):
        sys.exit(f"k2_split: imported {si.__file__}, not from {root}")
    lib = _build.library()
    sort_route = hasattr(lib, "ct_lookup")
    route = "sort" if sort_route else "merge"
    device = torch.device("cuda", 0)
    card = chip_smoke.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"]).splitlines()[0]

    x = chip_smoke.kernel_inputs(torch, device)
    st_, kj, s, total = x["st"], x["kj"], x["s"], x["total"]
    tbl = si.build_table(st_["codes"], kj)
    q = si.rolling_hash(st_["mega"], -(-total // s), s, kj, total - kj)
    want = si._lookup_expand_plain(*tbl, q, s)
    look = sort_route_lookup if sort_route else merge_route_lookup
    holder = {}

    def run_lookup(st):
        holder["out"], holder["raw"] = look(torch, si, _build, *tbl, q, s, st)

    med, whole, peak = timed(torch, chip_smoke.Steps, run_lookup)
    for g, w in zip(holder["out"], want):
        if not torch.equal(g, w):
            sys.exit("k2_split: lookup_expand differs from its twin")
    qs, h = torch.sort(q).values, tbl[0][tbl[0] != si.HMAX]
    raw = int((torch.searchsorted(qs, h, right=True)
               - torch.searchsorted(qs, h)).sum())
    print(json.dumps(dict(
        card=card, route=route, root=root, what="lookup_expand",
        probes=int(st_["codes"].shape[0]), table_rows=int(tbl[0].numel()),
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
    dd = sort_route_dedup if sort_route else merge_route_dedup

    def run_dedup(st):
        holder["out"] = dd(torch, si, _build, p, a, st)

    holder = {}
    med, whole, peak = timed(torch, chip_smoke.Steps, run_dedup)
    for g, w in zip(holder["out"], want):
        if not torch.equal(g, w):
            sys.exit("k2_split: dedup_pairs differs from its twin")
    keys = (p << 32) | a
    lib_ms = chip_smoke.cuda_ms(torch, lambda: torch.unique(keys), REPS)[0]
    print(json.dumps(dict(
        card=card, route=route, root=root, what="dedup_pairs",
        pairs_in=int(p.numel()), pairs_out=int(want[0].numel()),
        steps_ms=med, whole_ms=whole, peak_mib=peak / 2**20,
        torch_unique_packed_ms=lib_ms,
        kernel_us=kernel_times(torch, lambda: run_dedup(
            chip_smoke.Steps(torch))))), flush=True)


if __name__ == "__main__":
    main()
