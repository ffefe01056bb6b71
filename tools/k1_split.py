#!/usr/bin/env python3
"""CUDA-event timing of stage T (K1, build_table) and of the K2 call that
reads its table, on the ebola175 inputs, on one NVIDIA GPU.

Run from the root of a checkout:  python3 tools/k1_split.py [--root DIR]

--root names the checkout whose catch_tpu_torch is timed (default: the
one holding this script), so that one call can time two trees, e.g. a
`git archive` of the parent beside this one.  The inputs are
chip_smoke.kernel_inputs' (the ebola175 design, -pl 100 -m 2 -l 60).
One JSON line: for the whole table build (whatever the tree's
build_table does: this tree's one kernel, or an older tree's hash, sort
and divmod), for stage A's sample hash and for the lookup_expand call
on that table, the median, min and max of 20 calls (CUDA events, after
a warm-up) and the device time of each kernel a call launches
(torch.profiler, CUDA activity, over 5 calls); the peak device memory
of stage T above its inputs; the table's bytes; the pair count and a
checksum of the pairs, which two trees must share.  Every result is
held against the tree's twin first.
"""

import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 20


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


def equal(torch, got, want):
    return len(got) == len(want) and all(
        torch.equal(g, w) for g, w in zip(got, want))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    root = os.path.abspath(ap.parse_args().root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        sys.exit("k1_split: torch.cuda is not available")
    # this checkout's chip_smoke (its inputs and timers), whatever --root
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    os.makedirs(chip_smoke.WORK, exist_ok=True)
    from catch_tpu_torch.ops import scan_instance as si
    if not os.path.abspath(si.__file__).startswith(root):
        sys.exit(f"k1_split: imported {si.__file__}, not from {root}")
    device = torch.device("cuda", 0)
    card = chip_smoke.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"]).splitlines()[0]

    x = chip_smoke.kernel_inputs(torch, device)
    st, kj, s, total = x["st"], x["kj"], x["s"], x["total"]
    codes = st["codes"]
    n_samples = -(-total // s)

    def table():
        return si.build_table(codes, kj)

    def samples():
        return si.rolling_hash(st["mega"], n_samples, s, kj, total - kj)

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    tbl = table()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    if hasattr(si, "_build_table_plain"):
        twin = si._build_table_plain(codes, kj)
    else:
        # an older tree: its table was K1's hash of the staged rows and
        # a stable torch.sort, whose twin is the same on plain hashes
        row = codes.shape[1] + kj
        flat = torch.zeros(codes.shape[0] * row + kj - 1, dtype=torch.uint8,
                           device=device)
        flat[:codes.shape[0] * row].view(-1, row)[:, :codes.shape[1]] = codes
        h, f = torch.sort(si._rolling_hash_plain(
            flat, codes.shape[0] * row, 1, kj, codes.shape[0] * row - 1),
            stable=True)
        twin = (h, f // row, f % row)
    if not equal(torch, tbl, twin):
        sys.exit("k1_split: the table differs from its twin")
    q = samples()
    if not equal(torch, [q], [si._rolling_hash_plain(
            st["mega"], n_samples, s, kj, total - kj)]):
        sys.exit("k1_split: the sample hashes differ from their twin")

    def k2():
        return si.lookup_expand(*tbl, q, s)

    pc, ac = k2()
    if not equal(torch, (pc, ac), si._lookup_expand_plain(*tbl, q, s)):
        sys.exit("k1_split: lookup_expand differs from its twin")
    keys = (pc << 32) | ac
    checksum = int(((keys * 0x9E3779B1) & 0xFFFFFFFF).sum())
    print(json.dumps(dict(
        card=card, root=root, probes=int(codes.shape[0]),
        L=int(codes.shape[1]), kj=kj, samples=int(q.numel()),
        table_bytes=sum(t.numel() * t.element_size() for t in tbl),
        table_ms=chip_smoke.cuda_ms(torch, table, REPS),
        table_kernel_us=kernel_us(torch, table),
        table_peak_mib=peak / 2**20,
        samples_ms=chip_smoke.cuda_ms(torch, samples, REPS),
        samples_kernel_us=kernel_us(torch, samples),
        k2_ms=chip_smoke.cuda_ms(torch, k2, REPS),
        k2_kernel_us=kernel_us(torch, k2),
        pairs=int(pc.numel()), pair_checksum=checksum)), flush=True)


if __name__ == "__main__":
    main()
