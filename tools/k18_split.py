#!/usr/bin/env python3
"""CUDA-event and profiler split of K18 greedy_sharded on one NVIDIA GPU,
at virtual places of the one card.

Run from the root of a checkout:  python3 tools/k18_split.py [--root DIR]

--root names the checkout whose catch_tpu_torch is timed (default: the
one holding this script), so that one call can time two trees.  The
instances are bench.py's solver instance (chip_smoke.solver_instance:
100,000 sets, 128 universes, 4 intervals a set) at 1 and 4 places, and
ebola175's host instance (-pl 100 -m 2 -l 60 -e 50) at 4 places, read
back as chip_smoke.py phase 17 reads it: instance_to_host's result in a
design with --num-devices 4 on the host-solver route.  One JSON line an
instance: after a warm-up dispatch (which, in a tree that regroups the
shards, builds and keeps the regrouping), 10 calls of one 64-step
dispatch from the initial states give the call's CUDA-event median
[min, max] (the states' copy outside the events); torch.profiler (CUDA
activity, after 256 one-element adds) over 3 dispatches gives each
launch's count and device time a dispatch by name, and from them the
launches a step (those made 64 times or more a dispatch, over 64) and
the device time a dispatch; the dispatch's picks and a checksum of its
pick order, which two trees must share; and the wall seconds of two
whole solves through solve_instance_sharded, each equal to the host lazy
solver's picks.  Where the tree regroups (parallel/set_cover.py
shard_index), also the regrouping's CUDA-event median over 10 builds of
every shard's and the bytes it keeps.
"""

import argparse
import contextlib
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
WARM_UP = 256


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


def launches(torch, fn, prepare):
    """{name: [launches a call, device us a call]} of fn(prepare()) from
    torch.profiler (CUDA activity) over PROFILED calls, after WARM_UP
    one-element adds (left out of the count); prepare runs before the
    capture."""
    args = [prepare() for _ in range(PROFILED)]
    w = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    act = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        for _ in range(WARM_UP):
            w.add_(1)
        torch.cuda.synchronize()
        for arg in args:
            fn(arg)
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0)
        if us and "at::native" not in ev.key:
            out[ev.key[:60]] = [ev.count / PROFILED, round(us / PROFILED, 2)]
    return dict(sorted(out.items(), key=lambda kv: -kv[1][1]))


def checksum(order):
    import numpy as np

    ch = np.asarray(order, dtype=np.int64)
    return int(((ch * 0x9E3779B1) % (1 << 32)
                * np.arange(1, len(ch) + 1)).sum())


def ebola175_instance(chip_smoke):
    """ebola175's host instance as chip_smoke.py phase 17 reads it."""
    from catch_tpu_torch.ops import scan_instance as si

    kept = []
    out = os.path.join(chip_smoke.WORK, "k18_split_ebola175.fasta")
    with chip_smoke.virtual_places(chip_smoke.MESH_PLACES), \
            chip_smoke.recording(si, "instance_to_host",
                                 lambda a, k, r: kept.append(r)):
        chip_smoke.design([chip_smoke.write_subset(175), "-o", out, "-pl",
                           "100", "-m", "2", "-l", "60", "-e", "50",
                           "--device", "cuda", "--num-devices",
                           str(chip_smoke.MESH_PLACES)])
    inst, = kept
    return inst


def split(torch, chip_smoke, name, inst, n, device):
    """The JSON dict of one instance at n places."""
    import numpy as np

    from catch_tpu_torch.ops import set_cover as sct
    from catch_tpu_torch.parallel import make_mesh, solve_instance_sharded
    from catch_tpu_torch.parallel import set_cover as psc

    with chip_smoke.virtual_places(n):
        mesh = make_mesh(n, device)
    part = psc.place_partition(psc.partition_instance(inst, n),
                               inst.can_uncover, mesh)
    consts, u_size = sct._instance_consts(inst, device)
    states0 = psc.initial_states(sct.init_covered(
        consts["ivl_start"], consts["ivl_end"], inst.u_len), u_size, part)
    del consts

    def fresh():
        return [{k: v.clone() for k, v in s.items()} for s in states0]

    def dispatch(states):
        return psc.greedy_steps_sharded(states, part, N_STEPS)

    out = dict(what=name, places=n, positions=inst.u_len, sets=inst.n_sets,
               pairs=len(inst.set_of_pair), intervals=len(inst.ivl_start),
               steps=N_STEPS)
    if hasattr(psc, "shard_index"):
        def regroup(_):
            return [psc.shard_index(dict(s), inst.u_len)
                    for s in part["shards"]]

        idxs = regroup(None)
        storages = {v.untyped_storage().data_ptr(): v.untyped_storage()
                    for idx in idxs if idx is not None
                    for v in idx.values() if isinstance(v, torch.Tensor)}
        out.update(
            regroup_bytes=sum(st.nbytes() for st in storages.values()),
            regroup_pieces=sum(idx["tile_ivl"].numel() for idx in idxs
                               if idx is not None),
            regroup_max_tiles_per_set=max(
                [0] + [idx["max_groups"] for idx in idxs if idx is not None]),
            regroup_ms=event_ms(torch, regroup, lambda: None))
        del idxs, storages
    states = dispatch(fresh())   # warm-up; keeps the regrouping
    order = states[0]["order"][:int(states[0]["n_chosen"])].cpu().numpy()
    out["picks"] = len(order)
    out["order_checksum"] = checksum(order)
    out["dispatch_ms"] = event_ms(torch, dispatch, fresh)
    counts = launches(torch, dispatch, fresh)
    out["launches_and_device_us_per_dispatch"] = counts
    out["device_us_per_dispatch"] = round(
        sum(us for _, us in counts.values()), 2)
    out["launches_per_step"] = sum(
        c for c, _ in counts.values() if c >= N_STEPS) / N_STEPS
    want = sct._solve_host_lazy(inst)
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.time()
        got = solve_instance_sharded(inst, mesh=mesh)
        torch.cuda.synchronize()
        walls.append(time.time() - t0)
        if not np.array_equal(got, want):
            sys.exit(f"k18_split: {name} at {n} places differs from the "
                     "host lazy solver's picks")
    out["solve_s"] = walls
    out["solve_picks"] = len(want)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    root = os.path.abspath(ap.parse_args().root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        sys.exit("k18_split: torch.cuda is not available")
    # this checkout's chip_smoke (its instances and helpers), whatever
    # --root
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    from catch_tpu_torch.ops import set_cover as sct
    if not os.path.abspath(sct.__file__).startswith(root):
        sys.exit(f"k18_split: imported {sct.__file__}, not from {root}")
    os.makedirs(chip_smoke.WORK, exist_ok=True)
    device = torch.device("cuda", 0)
    card = chip_smoke.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"]).splitlines()[0]
    solver = chip_smoke.solver_instance(sct)
    with contextlib.redirect_stdout(sys.stderr):
        ebola = ebola175_instance(chip_smoke)
    for name, inst, n in (("solver instance", solver, 1),
                          ("solver instance", solver, 4),
                          ("ebola175 instance", ebola, 4)):
        out = split(torch, chip_smoke, name, inst, n, device)
        print(json.dumps(dict(card=card, root=root, **out)), flush=True)


if __name__ == "__main__":
    main()
