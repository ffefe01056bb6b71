#!/usr/bin/env python3
"""Launch-by-launch CUDA-event split of K12 greedy_v2 on one NVIDIA GPU,
on the ebola175 device route's assembled instance and on the solver
instance.

Run from the root of a checkout:  python3 tools/k12_split.py [--root DIR]

--root names the checkout whose catch_tpu_torch is timed (default: the
one holding this script), so that one call can time two trees.  The
ebola175 instance is the one stage E assembles in the design of
chip_smoke.py phase 14 (ebola175 m2 with CATCH_TPU_SOLVE=device, whose
peak device memory is printed); the solver instance is bench.py's
(chip_smoke.solver_instance: 100,000 sets, 4 intervals a set, 1,048,576
positions) through set_cover.assembled_instance.  On each, after a
warm-up, 10 calls of one 64-step dispatch from the initial state give:
the whole call's CUDA-event median, its peak device memory above what
was allocated before it, and the device time of each kernel by name
(torch.profiler, CUDA activity).  Where the tree has them (the
incremental design, csrc/greedy_v2.cu), also: the overlap index's build
(CUDA-event median over 10 builds, its peak above its inputs and its
bytes), and the CUDA-event time of each launch, one call at a time:
the dispatch-start recompute, and each step's score, decide and update,
summed over the 64 steps (medians over the 10 calls).  A launch made
as a call of its own waits for the host between launches, so the sum
of the split exceeds the whole call by those gaps.
"""

import argparse
import importlib.util
import json
import os
import statistics
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 10
N_STEPS = 64


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


def kernel_times(torch, fn, reps=3):
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


def event_ms(torch, fn, prepare):
    """Median CUDA-event ms of fn(prepare()) over REPS calls (prepare
    runs outside the events)."""
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


def split(torch, sct, what, dev, card, root):
    """Print one JSON line of the split on the assembled instance dev."""
    U, S = dev["u_len"], dev["cost"].numel()
    covered = sct.init_covered(dev["ivl_start"], dev["ivl_end"], U)
    state0 = sct.initial_state(covered, dev["u_size"], S)

    def fresh():
        return {k: v.clone() for k, v in state0.items()}

    def dispatch(state):
        return sct.greedy_steps_v2(state, dev, N_STEPS)

    out = dict(card=card, root=root, what=what, positions=U, sets=S,
               pairs=dev["univ_of_pair"].numel(),
               intervals=dev["ivl_start"].numel(),
               max_pairs_per_set=dev["max_pairs_per_set"],
               max_ivls_per_set=dev["max_ivls_per_set"], steps=N_STEPS)
    incremental = hasattr(sct, "overlap_index")
    if incremental:
        args = [dev[k] for k in ("ivl_start", "ivl_end", "pair_bounds",
                                 "set_bounds", "univ_of_pair")] + [U]
        idx = sct.overlap_index(*args)
        storages = {v.untyped_storage().data_ptr(): v.untyped_storage()
                    for v in idx.values() if isinstance(v, torch.Tensor)}
        out.update(
            index_pieces=idx["tile_ivl"].numel(),
            index_max_pieces_per_set=idx["max_pieces"],
            index_bytes=sum(st.nbytes() for st in storages.values()),
            index_build_ms=event_ms(torch, lambda _: sct.overlap_index(*args),
                                    lambda: None),
            index_build_peak_mib=peak_above(
                torch, lambda: sct.overlap_index(*args)) / 2**20)
        del idx
    state, _, picks = dispatch(fresh())   # warm-up; builds the index
    out["picks"] = int(picks.sum())
    out["dispatch_ms"] = event_ms(torch, dispatch, fresh)
    out["dispatch_peak_mib"] = peak_above(
        torch, lambda: dispatch(fresh())) / 2**20
    if incremental:
        splits = []
        for _ in range(REPS):
            st, marks = fresh(), Sums(torch)
            sct._greedy_steps_v2_cuda(st, dev, N_STEPS, steps=marks)
            splits.append(marks.split())
        out["launch_ms_summed_over_steps"] = {
            k: statistics.median(sp[k] for sp in splits) for k in splits[0]}
    out["kernel_us_per_dispatch"] = kernel_times(
        torch, lambda: dispatch(fresh()))
    print(json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    root = os.path.abspath(ap.parse_args().root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        sys.exit("k12_split: torch.cuda is not available")
    # this checkout's chip_smoke (its inputs and helpers), whatever --root
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    os.makedirs(chip_smoke.WORK, exist_ok=True)
    from catch_tpu_torch.ops import scan_instance as si
    from catch_tpu_torch.ops import set_cover as sct
    if not os.path.abspath(sct.__file__).startswith(root):
        sys.exit(f"k12_split: imported {sct.__file__}, not from {root}")
    device = torch.device("cuda", 0)
    card = chip_smoke.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"]).splitlines()[0]

    in175 = chip_smoke.write_subset(175)
    out = os.path.join(chip_smoke.WORK, "k12_split_ebola175.fasta")
    kept = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with chip_smoke.solve_on_device(), chip_smoke.recording(
            si, "ensure_assembled", lambda a, k, r: kept.append(r)):
        chip_smoke.design([in175, "-o", out, "-pl", "100", "-m", "2", "-l",
                           "60", "-e", "50", "--device", "cuda"])
    torch.cuda.synchronize()
    route_peak = torch.cuda.max_memory_allocated()
    if not chip_smoke.same_bytes(out, os.path.join(
            chip_smoke.GOLDEN, "torch_ebola175_m2.fasta")):
        sys.exit("k12_split: the ebola175 design differs from its golden")
    print(json.dumps(dict(card=card, root=root,
                          what="ebola175 m2 device route",
                          peak_mib=route_peak / 2**20)), flush=True)
    dev175, = kept
    for key in [k for k in dev175 if k.startswith("_k12")]:
        del dev175[key]                   # the split builds its own
    split(torch, sct, "ebola175", dev175, card, root)
    del dev175, kept
    inst = chip_smoke.solver_instance(sct)
    split(torch, sct, "solver instance",
          sct.assembled_instance(inst, device), card, root)


if __name__ == "__main__":
    main()
