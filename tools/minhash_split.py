#!/usr/bin/env python3
"""Split of the MinHash kernels (K7 minhash_caps' four entry points and
K8 minhash_sig) on one NVIDIA GPU, at the shapes of chip_smoke.py
phase 13.

Run from the root of a checkout:
    python3 tools/minhash_split.py [--root DIR] [--phases]

--root names the checkout whose catch_tpu_torch is timed (default: the
one holding this script), so that one call can time two trees.  The
inputs are those chip_smoke.py phases 11 and 12 keep: the largest
near-duplicate group's minhash_sig call, flu10k's last full greedy wave
(minhash_assign) and its largest minhash_caps call, the 5,400 fragment
signatures of the 51 Mbp scale corpus and the first 4,096 flu10k
signatures.  They are read from build/chip_smoke/minhash_inputs.pt of
this checkout (chip_smoke.py phase 13 writes it); where it is missing,
the tool runs those two phases itself (design_large on flu10k and the
scale corpus's clustering, with the --root tree's package, a few
minutes) and writes it; --phases runs them in any case, which prints
each MinHash entry point's real totals on both paths (chip_smoke.py's
minhash_totals: flu10k's from a torch.profiler trace, the scale
corpus's from CUDA events).  For each case, after a warm-up, 10 calls give
the CUDA-event median [min, max] of: the whole wrapper call; the
kernel's C entry point alone, on outputs allocated before (in this
design, with no order check: 0 flag blocks); and the wrapper's
row-order check alone (the parent's two passes, each ending in a host
read, or this design's ct_minhash_order: one pass and its read).  Then the
device microseconds a call of each kernel and copy by name
(torch.profiler, CUDA activity, over 3 calls), and the bound as
chip_smoke.py computes it.  One JSON line a case.
"""

import argparse
import importlib.util
import json
import os
import statistics
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 10


def event_ms(torch, fn):
    """Median, min and max CUDA-event ms of fn() over REPS calls after a
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


def kernel_times(torch, fn, reps=3):
    """Device microseconds a call by kernel (or copy) name, from
    torch.profiler (CUDA activity) over reps calls."""
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


def inputs(torch, chip_smoke, device, phases):
    """Phase 13's inputs on the card, from MINHASH_INPUTS, made by
    phases 11 and 12 where it is missing or where `phases` asks (phase
    11 then runs under torch.profiler, and both print their MinHash
    totals)."""
    if phases or not os.path.exists(chip_smoke.MINHASH_INPUTS):
        from catch_tpu_torch.ops import scan_instance as si
        from catch_tpu_torch.utils import profiling
        from catch_tpu_torch.utils import cluster  # noqa: F401
        _, kept = chip_smoke.run_design_large(torch, si, profiling, 10000,
                                              "flu10k", profile=True)
        scale = chip_smoke.cluster_scale(torch, si, profiling, device)
        chip_smoke.save_minhash_inputs(
            torch, kept, scale["minhash_dists"][1],
            kept["sigs"][:chip_smoke.FLU_ALL_PAIRS])
    saved = torch.load(chip_smoke.MINHASH_INPUTS)
    return {k: tuple(x.to(device) if hasattr(x, "to") else x for x in v)
            for k, v in saved.items()}


def cases(torch, mh, cluster, x):
    """(name, what, wrapper call, C call on outputs made before, order
    check alone or None, (bytes, operations)) of every case."""
    from catch_tpu_torch import _build

    lib, ptr = _build.library(), _build.ptr
    codes, ab = x["sig"]
    wave, reps, n_reps, cap_thr = x["assign"]
    blk, blk_r = x["caps"]
    frag, = x["frag_sigs"]
    N = wave.shape[1]
    cap_t = cluster._min_cap(N, cluster._jaccard_dist_from_mash_dist(0.15,
                                                                     12))
    cap_e = cluster._min_cap(N, cluster._jaccard_dist_from_mash_dist(0.02,
                                                                     12))

    # this design's entry points take the order check's flags and check
    # in the same call; with 0 blocks they launch their kernels alone
    fused = "ct_minhash_order" in _build._SIGNATURES
    alone = (None, 0) if fused else ()

    def check(q, r):
        if not fused:
            return lambda: mh._check_pair(q, r)
        words = (q.shape[0] + r.shape[0]) * N
        blocks = min(mh._ORDER_BLOCKS, -(-words // 1024)) if N > 1 else 0
        flags = torch.empty(max(blocks, 1), dtype=torch.uint8,
                            device=q.device)
        return lambda: _build.check(lib.ct_minhash_order(
            ptr(q), q.shape[0], ptr(r), r.shape[0], N, ptr(flags), blocks,
            _build.stream_of(q)), "ct_minhash_order")

    def pairs(q, r, out_bytes):
        # as chip_smoke.check_minhash_kernels counts them
        Q, R = q.shape[0], r.shape[0]
        return 4 * (Q + R) * N + out_bytes * Q * R, 4 * Q * R * N

    def pair_case(name, what, q, r, dtype, entry, extra=()):
        out = torch.empty((q.shape[0], r.shape[0]), dtype=dtype,
                          device=q.device)
        stream = _build.stream_of(q)

        def c_call():
            _build.check(getattr(lib, entry)(
                ptr(q), q.shape[0], ptr(r), r.shape[0], N, *extra, ptr(out),
                *alone, stream), entry)
        args = {"minhash_codes": (cap_t, cap_e)}.get(name, ())
        return (name, what, lambda: getattr(mh, name)(q, r, *args), c_call,
                check(q, r), pairs(q, r, out.element_size()))

    sig_out = torch.empty((codes.shape[0], ab.shape[0]), dtype=torch.int32,
                          device=codes.device)

    def sig_c():
        _build.check(lib.ct_minhash_sig(
            ptr(codes), codes.shape[0], codes.shape[1], ptr(ab),
            ab.shape[0], ptr(sig_out), _build.stream_of(codes)), "sig")

    Q = wave.shape[0]
    best = torch.empty(Q, dtype=torch.int64, device=wave.device)
    ok = torch.empty(Q, dtype=torch.bool, device=wave.device)
    groups = -(-int(n_reps) // 32)
    part = torch.empty(Q * groups, dtype=torch.int64, device=wave.device)

    def assign_c():
        if fused:
            args = (ptr(wave), Q, ptr(reps), reps.shape[0], int(n_reps), N,
                    int(cap_thr), ptr(best), ptr(ok), ptr(part), *alone)
        else:
            args = (ptr(wave), Q, ptr(reps), int(n_reps), N, int(cap_thr),
                    ptr(best), ptr(ok))
        _build.check(lib.ct_minhash_assign(*args, _build.stream_of(wave)),
                     "assign")

    U, n = codes.shape
    H = ab.shape[0]
    m = frag.shape[0]
    row = frag[m // 2:m // 2 + 1]
    return [
        ("minhash_sig", f"the largest near-duplicate group, U={U} n={n} "
         f"H={H}", lambda: mh.minhash_sig(codes, ab), sig_c, None,
         (4 * U * n + 8 * H + 4 * U * H, 4 * U * n * H)),
        ("minhash_assign", f"flu10k's last full wave, Q={Q} "
         f"n_reps={n_reps} N={N}",
         lambda: mh.minhash_assign(wave, reps, n_reps, cap_thr), assign_c,
         check(wave, reps), (4 * (Q + int(n_reps)) * N + 9 * Q,
                             4 * Q * int(n_reps) * N)),
        pair_case("minhash_caps", f"flu10k's largest caps call, "
                  f"{blk.shape[0]} x {blk_r.shape[0]}", blk, blk_r,
                  torch.int32 if N > 255 else torch.uint8,
                  "ct_minhash_caps", (int(N > 255),)),
        pair_case("minhash_dists", f"{m} fragments all pairs", frag, frag,
                  torch.float32, "ct_minhash_dists"),
        pair_case("minhash_dists", f"1,024 of {m} fragments (one of "
                  "cluster.py's blocks)", frag[:1024], frag, torch.float32,
                  "ct_minhash_dists"),
        pair_case("minhash_dists", f"one of {m} fragments (a row)", row,
                  frag, torch.float32, "ct_minhash_dists"),
        pair_case("minhash_codes", f"{m} fragments all pairs", frag, frag,
                  torch.uint8, "ct_minhash_codes", (cap_t, cap_e)),
    ]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--phases", action="store_true",
                    help="run chip_smoke.py phases 11 and 12 first (their "
                    "MinHash totals), even where the inputs are saved")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        sys.exit("minhash_split: torch.cuda is not available")
    # this checkout's chip_smoke (its inputs and helpers), whatever --root
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    os.makedirs(chip_smoke.WORK, exist_ok=True)
    from catch_tpu_torch.ops import minhash as mh
    from catch_tpu_torch.utils import cluster
    if not os.path.abspath(mh.__file__).startswith(root):
        sys.exit(f"minhash_split: imported {mh.__file__}, not from {root}")
    device = torch.device("cuda", 0)
    card = chip_smoke.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"]).splitlines()[0]
    x = inputs(torch, chip_smoke, device, args.phases)
    for name, what, call, c_call, order, work in cases(torch, mh, cluster, x):
        bound_ms, bound_by = chip_smoke.bound(work)
        out = dict(card=card, root=root, kernel=name, what=what,
                   call_ms=event_ms(torch, call),
                   kernel_alone_ms=event_ms(torch, c_call),
                   order_check_ms=event_ms(torch, order) if order else None,
                   bound_ms=bound_ms, bound_by=bound_by,
                   device_us_per_call=kernel_times(torch, call))
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
