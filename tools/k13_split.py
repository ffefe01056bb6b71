#!/usr/bin/env python3
"""CUDA-event and profiler split of K13 greedy_v1 on one NVIDIA GPU, on
the solver instance.

Run from the root of a checkout:  python3 tools/k13_split.py [--root DIR]

--root names the checkout whose catch_tpu_torch is timed (default: the
one holding this script), so that one call can time two trees.  The
instance is bench.py's solver instance (chip_smoke.solver_instance:
100,000 sets, 128 universes, 4 intervals a set, 1,048,576 positions) as
K13 takes it (set_cover._instance_consts).  One JSON line: after a
warm-up dispatch (which, in a tree that regroups the instance, builds
and keeps the regrouping), 10 calls of one 64-step dispatch from the
initial state give the call's CUDA-event median [min, max] and its peak
device memory above what was allocated before it; torch.profiler (CUDA
activity) over 3 dispatches gives each launch's count and device time a
dispatch by name, and from them the launches a step (those made 64 times
or more a dispatch, over 64) and the device time a dispatch; the
dispatch's picks and a checksum of its chosen sets, which two trees must
share; and the wall seconds of two whole solves,
solve_instance(force_device=True) and _solve_device, each equal to the
host lazy solver's picks.  Where the tree regroups (set_major_index),
also: the regrouping's CUDA-event median over 10 builds, its peak above
its inputs and its bytes, and the CUDA-event time of each launch, one
call at a time: the dispatch-start recompute, and each step's score,
decide and update, summed over the 64 steps (medians over the 10
calls); a launch made as a call of its own waits for the host between
launches, so the split's sum exceeds the whole call by those gaps.
"""

import argparse
import importlib.util
import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 10
PROFILED = 3
N_STEPS = 64


def event_ms(torch, fn, prepare):
    """(median, min, max) CUDA-event ms of fn(prepare()) over REPS calls
    (prepare runs outside the events)."""
    times = []
    for _ in range(REPS):
        arg = prepare()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn(arg)
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times), min(times), max(times)


def peak_above(torch, fn):
    """Peak device bytes of fn() above what was allocated before it."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def launches(torch, fn, prepare):
    """{name: [launches a call, device us a call]} of fn(prepare()) from
    torch.profiler (CUDA activity) over PROFILED calls; prepare runs
    before the capture."""
    args = [prepare() for _ in range(PROFILED)]
    torch.cuda.synchronize()
    act = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        for arg in args:
            fn(arg)
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0)
        if us:
            out[ev.key[:60]] = [ev.count / PROFILED, round(us / PROFILED, 2)]
    return dict(sorted(out.items(), key=lambda kv: -kv[1][1]))


class Sums:
    """CUDA events at each mark(name); split() sums the time from the
    previous mark to each mark by name."""

    def __init__(self, torch):
        self.torch, self.marks = torch, []

    def mark(self, name):
        e = self.torch.cuda.Event(enable_timing=True)
        e.record()
        self.marks.append((name, e))

    def split(self):
        self.torch.cuda.synchronize()
        out = {}
        for (_, a), (name, b) in zip(self.marks, self.marks[1:]):
            out[name] = out.get(name, 0.0) + a.elapsed_time(b)
        return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    root = os.path.abspath(ap.parse_args().root)
    sys.path.insert(0, root)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("k13_split: torch.cuda is not available")
    # this checkout's chip_smoke (its instance and helpers), whatever
    # --root
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    from catch_tpu_torch.ops import set_cover as sct
    if not os.path.abspath(sct.__file__).startswith(root):
        sys.exit(f"k13_split: imported {sct.__file__}, not from {root}")
    device = torch.device("cuda", 0)
    card = chip_smoke.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"]).splitlines()[0]

    inst = chip_smoke.solver_instance(sct)
    consts, u_size = sct._instance_consts(inst, device)
    covered = sct.init_covered(consts["ivl_start"], consts["ivl_end"],
                               inst.u_len)
    state0 = sct.initial_state(covered, u_size, inst.n_sets)

    def fresh():
        return {k: v.clone() for k, v in state0.items()}

    def dispatch(state):
        return sct.greedy_steps_v1(state, consts, N_STEPS)

    out = dict(card=card, root=root, what="solver instance",
               positions=inst.u_len, sets=inst.n_sets,
               pairs=len(inst.set_of_pair), intervals=len(inst.ivl_start),
               steps=N_STEPS)
    regroups = hasattr(sct, "set_major_index")
    if regroups:
        args = [consts[k] for k in ("ivl_start", "ivl_end", "pair_of_ivl",
                                    "set_of_pair", "univ_of_pair")]

        def regroup(_):
            return sct.set_major_index(*args, inst.n_sets, inst.u_len)

        idx = regroup(None)
        storages = {v.untyped_storage().data_ptr(): v.untyped_storage()
                    for v in idx.values() if isinstance(v, torch.Tensor)}
        out.update(
            regroup_pieces=idx["tile_ivl"].numel(),
            regroup_set_tiles=idx["grp_tile"].numel(),
            regroup_max_tiles_per_set=idx["max_groups"],
            regroup_bytes=sum(st.nbytes() for st in storages.values()),
            regroup_ms=event_ms(torch, regroup, lambda: None),
            regroup_peak_mib=peak_above(torch, lambda: regroup(None))
            / 2**20)
        del idx
    _, chosens, picks = dispatch(fresh())   # warm-up; keeps the regrouping
    ch = chosens.cpu().numpy().astype(np.int64)
    out["picks"] = int(picks.sum())
    out["chosen_checksum"] = int(((ch * 0x9E3779B1) % (1 << 32)
                                  * np.arange(1, len(ch) + 1)).sum())
    out["dispatch_ms"] = event_ms(torch, dispatch, fresh)
    out["dispatch_peak_mib"] = peak_above(
        torch, lambda: dispatch(fresh())) / 2**20
    counts = launches(torch, dispatch, fresh)
    out["launches_and_device_us_per_dispatch"] = counts
    out["device_us_per_dispatch"] = round(
        sum(us for _, us in counts.values()), 2)
    out["launches_per_step"] = sum(
        n for n, _ in counts.values() if n >= N_STEPS) / N_STEPS
    if regroups:
        splits = []
        for _ in range(REPS):
            st, marks = fresh(), Sums(torch)
            sct._greedy_steps_v1_cuda(st, consts, N_STEPS, steps=marks)
            splits.append(marks.split())
        out["launch_ms_summed_over_steps"] = {
            k: statistics.median(sp[k] for sp in splits) for k in splits[0]}
    want = sct._solve_host_lazy(inst)
    for name, solve in (
            ("solve_instance_force_device",
             lambda: sct.solve_instance(inst, force_device=True,
                                        device=device)),
            ("solve_device", lambda: sct._solve_device(inst, device))):
        walls = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.time()
            got = solve()
            torch.cuda.synchronize()
            walls.append(time.time() - t0)
            if not np.array_equal(got, want):
                sys.exit(f"k13_split: {name} differs from the host lazy "
                         "solver's picks")
        out[f"{name}_s"] = walls
    out["solve_picks"] = len(want)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
