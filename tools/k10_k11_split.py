#!/usr/bin/env python3
"""CUDA-event and profiler split of K10 assemble and K11 init_covered on
one NVIDIA GPU, on the ebola175 device route's instance and on the
solver instance.

Run from the root of a checkout:  python3 tools/k10_k11_split.py [--root DIR]

--root names the checkout whose catch_tpu_torch is timed (default: the
one holding this script), so that one call can time two trees.  The
ebola175 instance is the one stage E assembles in the design of
chip_smoke.py phase 14 (ebola175 m2 with CATCH_TPU_SOLVE=device); that
design runs twice, and each run prints its wall time, its scan:stage_e
phase and the peak allocated device memory before stage E (stage D's)
beside the peak after it.  The solver instance is bench.py's
(chip_smoke.solver_instance: 100,000 sets, 4 intervals a set, 1,048,576
positions) through set_cover.assembled_instance.  On each instance and
for each kernel, after a warm-up call, 10 calls give the wrapper's
CUDA-event median [min, max]; torch.profiler (CUDA activity) over 3
calls gives the device time and the count of each launch a call by name
(kernels, memsets and copies); torch.cuda.set_sync_debug_mode("warn")
counts the host reads of one call.
"""

import argparse
import importlib.util
import json
import os
import statistics
import sys
import time
import warnings

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 10
PROFILED = 3


def event_ms(torch, fn):
    """(median, min, max) CUDA-event ms of fn() over REPS calls after a
    warm-up call."""
    fn()
    times = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times), min(times), max(times)


def launches(torch, fn):
    """{name: [launches a call, device us a call]} of fn() from
    torch.profiler (CUDA activity) over PROFILED calls."""
    act = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        for _ in range(PROFILED):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0)
        if us:
            out[ev.key[:60]] = [ev.count / PROFILED,
                                round(us / PROFILED, 2)]
    return dict(sorted(out.items(), key=lambda kv: -kv[1][1]))


def host_reads(torch, fn):
    """Synchronising calls of one fn() call."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum("called a synchronizing" in str(w.message) for w in caught)


def split(torch, si, sct, what, dev, card, root):
    """One JSON line a kernel on the assembled instance dev."""
    mk, ms, me = dev["merged"]
    off = torch.from_numpy(dev["offsets"]).to(mk.device)
    S, U = dev["cost"].numel(), dev["u_len"]
    calls = {
        "assemble": lambda: si.assemble(mk, ms, me, off, S),
        "init_covered": lambda: sct.init_covered(dev["ivl_start"],
                                                 dev["ivl_end"], U)}
    for name, fn in calls.items():
        print(json.dumps(dict(
            card=card, root=root, what=what, kernel=name, rows=mk.numel(),
            pairs=dev["univ_of_pair"].numel(), sets=S, positions=U,
            call_ms=event_ms(torch, fn), host_reads=host_reads(torch, fn),
            launches_and_device_us=launches(torch, fn))), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    root = os.path.abspath(ap.parse_args().root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        sys.exit("k10_k11_split: torch.cuda is not available")
    # this checkout's chip_smoke (its inputs and helpers), whatever --root
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    os.makedirs(chip_smoke.WORK, exist_ok=True)
    from catch_tpu_torch.ops import scan_instance as si
    from catch_tpu_torch.ops import set_cover as sct
    from catch_tpu_torch.utils import profiling
    if not os.path.abspath(sct.__file__).startswith(root):
        sys.exit(f"k10_k11_split: imported {sct.__file__}, not from {root}")
    device = torch.device("cuda", 0)
    card = chip_smoke.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"]).splitlines()[0]

    in175 = chip_smoke.write_subset(175)
    out = os.path.join(chip_smoke.WORK, "k10_k11_split_ebola175.fasta")
    for run in (1, 2):
        kept, peaks = [], []
        profiling.reset_phases()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        with chip_smoke.solve_on_device(), chip_smoke.recording(
                si, "ensure_assembled", lambda a, k, r: kept.append(r)), \
                chip_smoke.peak_around(torch, si, "ensure_assembled", peaks):
            chip_smoke.design([in175, "-o", out, "-pl", "100", "-m", "2",
                               "-l", "60", "-e", "50", "--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.time() - t0
        if not chip_smoke.same_bytes(out, os.path.join(
                chip_smoke.GOLDEN, "torch_ebola175_m2.fasta")):
            sys.exit("k10_k11_split: the ebola175 design differs from its "
                     "golden")
        (before_e, after_e), = peaks
        print(json.dumps(dict(
            card=card, root=root, what="ebola175 m2 device route", run=run,
            wall_s=wall,
            stage_e_s=profiling.phase_seconds.get("scan:stage_e"),
            peak_before_stage_e_mib=before_e / 2**20,
            peak_after_stage_e_mib=after_e / 2**20)), flush=True)
    dev175, = kept
    split(torch, si, sct, "ebola175", dev175, card, root)
    del dev175, kept
    inst = chip_smoke.solver_instance(sct)
    split(torch, si, sct, "solver instance",
          sct.assembled_instance(inst, device), card, root)


if __name__ == "__main__":
    main()
