#!/usr/bin/env python3
"""Step-by-step CUDA-event split of K3 (verify_windows) on the ebola175
inputs, on one NVIDIA GPU.

Run from the root of a checkout:  python3 tools/k3_split.py [--root DIR]

--root names the checkout whose catch_tpu_torch is timed (default: the
one holding this script), so that one call can time two trees.  The
inputs are the candidate pairs that lookup_expand gives on
chip_smoke.kernel_inputs' design (ebola175, -pl 100 -m 2 -l 60 -e 50).
Each step is bracketed by CUDA events over 10 calls after a warm-up;
the medians are printed, with the wrapper's whole time (median, min,
max), its peak device memory above what was allocated before the call,
and the device time of each kernel a call launches (torch.profiler,
CUDA activity).  Then the candidates' shape, from plain PyTorch on the
card: the mismatch count in each candidate's band (histogram, and the
mean of its largest value in each run of 32 candidates, which a warp
walks together), the windows each candidate emits, the share with
none, the fast-path share, the band widths (i_hi - i_lo) and the
distinct probe rows among each 128 candidates.  Last, one ebola175
design on each solver route (the host lazy solver, then
CATCH_TPU_SOLVE=device) with the peak reset around stage C: what was
allocated at its start, the design's peak, and the peaks before, during
and after stage C.

The script knows two implementations of K3 and times the one the
library holds: the two-walk route (ct_verify_count, torch.cumsum and
its host read, ct_verify_emit; each kernel walks the corpus byte by
byte) and the mask route (csrc/verify_windows.cu: one walk builds each
candidate's mismatch mask, 32 positions a word, the emit reads the
masks).
"""

import argparse
import contextlib
import importlib.util
import json
import os
import statistics
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 10


def two_walk_route(torch, si, _build, tensors, args, st):
    """The parent's verify_windows, step by step."""
    lib, stream = _build.library(), _build.stream_of(tensors[3])
    pc = tensors[3]
    dev, n = pc.device, pc.numel()
    L = tensors[1].shape[1]
    st.mark("start")
    common = [_build.ptr(t) for t in tensors[:5]] + [n] + [
        _build.ptr(t) for t in tensors[5:]] + [
        tensors[5].numel(), L, args["K"], args["k_seed"], args["lcf"],
        args["seed_req"], int(bool(args["fast_ok"])), args["ext"],
        args["nU"]]
    counts = torch.empty(n, dtype=torch.int64, device=dev)
    _build.check(lib.ct_verify_count(*common, _build.ptr(counts), stream),
                 "verify_count")
    st.mark("count kernel")
    off = torch.cumsum(counts, 0)
    total = int(off[-1])
    st.mark("cumsum+read")
    out = [torch.empty(total, dtype=torch.int64, device=dev)
           for _ in range(3)]
    _build.check(lib.ct_verify_emit(*common, _build.ptr(off),
                                    *[_build.ptr(x) for x in out], stream),
                 "verify_emit")
    st.mark("emit kernel")
    return tuple(out)


def mask_route(torch, si, _build, tensors, args, st):
    return si._verify_windows_cuda(*tensors, steps=st, **args)


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


def histogram(values, edges):
    """Counts of values in [edges[i], edges[i+1]) keyed by the range,
    the last open above."""
    out = {}
    for lo, hi in zip(edges, edges[1:] + [None]):
        sel = values >= lo if hi is None else (values >= lo) & (values < hi)
        name = (f"{lo}+" if hi is None else
                str(lo) if hi == lo + 1 else f"{lo}-{hi - 1}")
        out[name] = int(sel.sum())
    return out


def candidate_shape(torch, si, tensors, args):
    """The candidates' shape (see the module docstring), from plain
    PyTorch on the card over chunks of candidates."""
    mega, codes, lens, pc, ac, seq_starts, seq_ends = tensors[:7]
    L = codes.shape[1]
    K, k_seed, lcf = args["K"], args["k_seed"], args["lcf"]
    nm_all, win_all, band_all, fast_all = [], [], [], []
    chunk = 1 << 17
    j = torch.arange(L, dtype=torch.int64, device=pc.device)
    for c0 in range(0, pc.numel(), chunk):
        p, a = pc[c0:c0 + chunk], ac[c0:c0 + chunk]
        sid = torch.clamp(torch.searchsorted(seq_ends, a, side="right"), 0,
                          seq_ends.numel() - 1)
        s_lo, s_hi, plen = seq_starts[sid], seq_ends[sid], lens[p]
        start = torch.maximum(s_lo, a)
        ov = torch.clamp(torch.minimum(s_hi, a + plen) - start, min=0)
        n_seq = s_hi - s_lo
        thres = torch.minimum(torch.clamp(plen, max=lcf), n_seq)
        i_lo = start - a
        vals = mega[a[:, None] + j[None, :]]
        band = (j[None, :] >= i_lo[:, None]) & (j[None, :]
                                                < (i_lo + ov)[:, None])
        match = (vals == codes[p]) & (vals > 0) & band
        nm_all.append((band & ~match).sum(1))
        band_all.append(ov)
        fast = torch.zeros_like(ov, dtype=torch.bool)
        if args["fast_ok"]:
            fast = (n_seq >= L) | ((K == 0) & (n_seq >= k_seed))
        fast_all.append(fast & (thres > 0))
        rows, _, _ = si.windows_plain(
            mega, codes, p, a, start, ov, thres, n_seq, K=K, k_seed=k_seed,
            seed_req=args["seed_req"], fast_ok=args["fast_ok"])
        win_all.append(torch.bincount(rows, minlength=p.numel()))
    nm = torch.cat(nm_all).cpu().numpy()
    win = torch.cat(win_all).cpu().numpy()
    band = torch.cat(band_all).cpu().numpy()
    fast = torch.cat(fast_all).cpu().numpy()
    n = len(nm)
    pcn = pc.cpu().numpy()
    new_row = np.ones(n, dtype=np.int64)
    new_row[1:] = pcn[1:] != pcn[:-1]
    new_row[::128] = 1
    rows128 = np.add.reduceat(new_row, np.arange(0, n, 128))
    warp_max = np.maximum.reduceat(nm, np.arange(0, n, 32))
    return dict(
        candidates=n, L=L, spans=int(win.sum()),
        mismatches_hist=histogram(nm, [0, 1, 2, 3, 4, 5, 9, 17, 33, 65]),
        mismatches_mean=float(nm.mean()),
        mismatches_warp_max_mean=float(warp_max.mean()),
        windows_hist=histogram(win, [0, 1, 2, 3, 4, 9]),
        no_window_share=float((win == 0).mean()),
        fast_share=float(fast.mean()),
        band_hist=histogram(band, [0, 1, L // 2, L - 1, L]),
        band_mean=float(band.mean()),
        probe_rows_per_128_hist=histogram(rows128, [1, 2, 3, 4, 5, 9]),
        probe_rows_per_128_mean=float(rows128.mean()),
        probe_rows_per_128_max=int(rows128.max()))


@contextlib.contextmanager
def wrapping(si, make):
    """si.verify_windows replaced by make(the function) for a while.
    The wrapper has a launches count of its own: the wrapped function
    counts its launches on whatever the module's name holds."""
    fn = si.verify_windows
    si.verify_windows = make(fn)
    si.verify_windows.launches = 0
    try:
        yield
    finally:
        si.verify_windows = fn


def design_peaks(torch, chip_smoke, si, device_route):
    """ebola175 m2 on one solver route with the peak reset around each
    stage-C call: the design's peak, and the peaks before, during each
    call and after, in MiB."""
    marks = []

    def stage_c(fn):
        def wrapped(*args, **kwargs):
            torch.cuda.synchronize()
            marks.append(("before", torch.cuda.max_memory_allocated()))
            torch.cuda.reset_peak_memory_stats()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            marks.append(("verify", torch.cuda.max_memory_allocated()))
            torch.cuda.reset_peak_memory_stats()
            return out
        return wrapped

    route = (chip_smoke.solve_on_device() if device_route
             else contextlib.nullcontext())
    with route, wrapping(si, stage_c):
        torch.cuda.synchronize()
        marks.append(("start", torch.cuda.memory_allocated()))
        torch.cuda.reset_peak_memory_stats()
        chip_smoke.design([chip_smoke.write_subset(175), "-o",
                           os.path.join(chip_smoke.WORK, "k3_split.fasta"),
                           "-pl", "100", "-m", "2", "-l", "60", "-e", "50",
                           "--device", "cuda"])
        torch.cuda.synchronize()
        marks.append(("after", torch.cuda.max_memory_allocated()))
    with open(os.path.join(chip_smoke.WORK, "k3_split.fasta"), "rb") as a, \
            open(os.path.join(chip_smoke.GOLDEN, "torch_ebola175_m2.fasta"),
                 "rb") as b:
        if a.read() != b.read():
            sys.exit("k3_split: the ebola175 design differs from "
                     "torch_ebola175_m2.fasta")
    return dict(design=round(max(v for _, v in marks[1:]) / 2**20, 1),
                marks=[(k, round(v / 2**20, 1)) for k, v in marks])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    root = os.path.abspath(ap.parse_args().root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        sys.exit("k3_split: torch.cuda is not available")
    # this checkout's chip_smoke (its inputs and Steps), whatever --root
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    os.makedirs(chip_smoke.WORK, exist_ok=True)
    from catch_tpu_torch import _build
    from catch_tpu_torch.ops import scan_instance as si
    if not os.path.abspath(si.__file__).startswith(root):
        sys.exit(f"k3_split: imported {si.__file__}, not from {root}")
    lib = _build.library()
    old = hasattr(lib, "ct_verify_count")
    route, split = ("two-walk", two_walk_route) if old else ("mask",
                                                             mask_route)
    device = torch.device("cuda", 0)
    card = chip_smoke.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"]).splitlines()[0]

    x = chip_smoke.kernel_inputs(torch, device)
    st_, kj, s = x["st"], x["kj"], x["s"]
    tbl = si.build_table(st_["codes"], kj)
    q = si.rolling_hash(st_["mega"], -(-x["total"] // s), s, kj,
                        x["total"] - kj)
    pc, ac = si.lookup_expand(*tbl, q, s)
    del tbl, q
    tensors = (st_["mega"], st_["codes"], st_["lens"], pc, ac,
               st_["seq_starts"], st_["seq_ends"], st_["seq_lens"],
               st_["chrom_off"], st_["univ_of_seq"])
    args = dict(K=x["K"], k_seed=x["k_seed"],
                lcf=int(x["searcher"].lcf_static), seed_req=x["k_seed"],
                fast_ok=bool(x["searcher"].fast_ok), ext=50, nU=x["nU"])
    print(json.dumps(dict(card=card, route=route, root=root,
                          pairs=int(pc.numel()), args=args)), flush=True)

    want = si._verify_windows_plain(*tensors, **args)
    holder = {}

    def run_one(st):
        holder["out"] = split(torch, si, _build, tensors, args, st)

    med, whole, peak = timed(torch, chip_smoke.Steps, run_one)
    if not all(torch.equal(g, w) for g, w in zip(holder["out"], want)):
        sys.exit("k3_split: verify_windows differs from its twin")
    print(json.dumps(dict(
        card=card, route=route, spans=int(want[0].numel()), steps_ms=med,
        whole_ms=whole, peak_above_inputs_mib=peak / 2**20,
        twin_ms=chip_smoke.cuda_ms(
            torch, lambda: si._verify_windows_plain(*tensors, **args), 3)[0],
        kernel_us=kernel_times(torch, lambda: run_one(
            chip_smoke.Steps(torch))))), flush=True)
    print(json.dumps(dict(card=card, what="candidate shape",
                          **candidate_shape(torch, si, tensors, args))),
          flush=True)
    del want, holder, tensors, pc, ac, x, st_
    for device_route in (False, True):
        print(json.dumps(dict(
            card=card, route=route,
            what="ebola175 design peaks (MiB), "
                 + ("device" if device_route else "host") + " solver",
            **design_peaks(torch, chip_smoke, si, device_route))),
            flush=True)


if __name__ == "__main__":
    main()
