#!/usr/bin/env python3
"""CUDA-event timing of K9 (pack_merged) on the ebola175 merged rows, on
one NVIDIA GPU.

Run from the root of a checkout:  python3 tools/k9_split.py [--root DIR]

--root names the checkout whose catch_tpu_torch is timed (default: the
one holding this script), so that one call can time two trees.  The
rows are the merged rows of chip_smoke.kernel_inputs' design (ebola175,
-pl 100 -m 2 -l 60 -e 50), b_pos 2.  Three inputs: all of them; the
first 346,051 (the row count of flu10k's largest cluster); all of them
with a key jump past 16 bits every 1,000 rows (the escape path).  For
each, one JSON line: the wrapper's whole time (CUDA events, median, min
and max of 20 calls after a warm-up), the device time of each kernel a
call launches (torch.profiler, CUDA activity, over 5 calls), and the
wall time of a call on the host clock with the card idle before it
(median of 20) with the host time of its costliest operations
(torch.profiler, CPU activity), beside the bound (each row read once,
its bytes and the escapes written once, over 3.35 TB/s).  Every result
is held against the twin first.
"""

import argparse
import importlib.util
import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 20
FLU10K_ROWS = 346051


def kernel_us(torch, fn, reps=5):
    """Device microseconds a call, by kernel name (torch.profiler)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0)
        if us:
            out[ev.key[:60]] = round(us / reps, 2)
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def host_ops(torch, fn, reps=5):
    """Host microseconds a call in each of the 8 costliest operations
    (self CPU time; torch.profiler, CPU activity)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(reps):
            fn()
    evs = sorted(prof.key_averages(), key=lambda ev: -ev.self_cpu_time_total)
    return {ev.key[:40]: round(ev.self_cpu_time_total / reps, 2)
            for ev in evs[:8]}


def host_ms(torch, fn):
    """Median wall ms of fn() on the host clock, the card idle before
    each call (the call ends with its host read)."""
    times = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    root = os.path.abspath(ap.parse_args().root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        sys.exit("k9_split: torch.cuda is not available")
    # this checkout's chip_smoke (its inputs and timers), whatever --root
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    os.makedirs(chip_smoke.WORK, exist_ok=True)
    from catch_tpu_torch.ops import scan_instance as si
    if not os.path.abspath(si.__file__).startswith(root):
        sys.exit(f"k9_split: imported {si.__file__}, not from {root}")
    device = torch.device("cuda", 0)
    card = chip_smoke.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"]).splitlines()[0]

    x = chip_smoke.kernel_inputs(torch, device)
    st, kj, s = x["st"], x["kj"], x["s"]
    tbl = si.build_table(st["codes"], kj)
    q = si.rolling_hash(st["mega"], -(-x["total"] // s), s, kj,
                        x["total"] - kj)
    pc, ac = si.lookup_expand(*tbl, q, s)
    spans = si.verify_windows(
        st["mega"], st["codes"], st["lens"], pc, ac, st["seq_starts"],
        st["seq_ends"], st["seq_lens"], st["chrom_off"], st["univ_of_seq"],
        K=x["K"], k_seed=x["k_seed"], lcf=int(x["searcher"].lcf_static),
        seed_req=x["k_seed"], fast_ok=bool(x["searcher"].fast_ok), ext=50,
        nU=x["nU"])
    mk, ms, me = si.segmented_merge(*spans)
    del tbl, q, pc, ac, spans
    b_pos = si.pack_width(int((st["chrom_off"] + st["seq_lens"]).max()))
    jumps = torch.arange(mk.numel(), device=device) // 1000 * 0x10000
    for what, rows in (
            ("ebola175", (mk, ms, me)),
            (f"first {FLU10K_ROWS} rows", (mk[:FLU10K_ROWS].clone(),
                                            ms[:FLU10K_ROWS].clone(),
                                            me[:FLU10K_ROWS].clone())),
            ("ebola175, a key jump every 1,000 rows", (mk + jumps, ms, me))):
        got = si.pack_merged(*rows, b_pos)
        want = si._pack_merged_plain(*rows, b_pos)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            sys.exit(f"k9_split: pack_merged differs from its twin ({what})")
        n, n_esc = rows[0].numel(), int(got[1].numel())
        out_bytes = (4 + b_pos) * n + 24 * n_esc
        call = lambda: si.pack_merged(*rows, b_pos)  # noqa: E731
        print(json.dumps(dict(
            card=card, root=root, rows=what, n=n, b_pos=b_pos,
            escapes=n_esc,
            whole_ms=chip_smoke.cuda_ms(torch, call, REPS),
            kernel_us=kernel_us(torch, call),
            host_ms=host_ms(torch, call), host_us=host_ops(torch, call),
            bound_ms=chip_smoke.bound((24 * n + out_bytes, out_bytes))[0])),
            flush=True)


if __name__ == "__main__":
    main()
