#!/usr/bin/env python3
"""Step-by-step split of the span scan (K5 expand_join, K6 verify_spans
and the host work between them) on one NVIDIA GPU, at the shapes of its
three callers.

Run from the root of a checkout:
    python3 tools/span_split.py [--root DIR] [--totals]

--root names the checkout whose catch_tpu_torch is timed (default: the
one holding this script), so that one call can time two trees that
share these wrappers; a tree with other wrappers is timed with its own
copy of the script.  The shapes are chip_smoke.span_shapes' (phase 6):
  avoid batch 1  the first 75 Mbp of the 100 Mbp background, both
                 strands, against the candidates of 8 ebola genomes (-m 2
                 -l 60, kmer_probe_map_k 20: w = 9);
  analysis       phase 9's ebola175 analysis: the 175 genomes, both
                 strands, against torch_ebola175_m2.fasta's 159 probes
                 (kmer_probe_map_k 10: w = 1);
  adapter vote   one adapter vote of phase 24 (i): the first ebola175
                 genome (one strand) against the same 159 probes
                 (kmer_probe_map_k 20).
For each shape the host join (corpus codes and minimizer join) runs
once, timed on the host clock; then scan_spans' device part, from the
join's runs to the spans, runs step by step, each host-to-card copy and
each host read a step of its own, bracketed by CUDA events over 10
calls after a warm-up (medians printed).  Then the CUDA-event median
[min, max] of each kernel wrapper's call over 10 calls after a warm-up
(expand_join as the scan calls it, the keep predicate folded in), and
the device microseconds a call of each kernel by its symbol (torch.profiler, CUDA activity, over
3 calls).  It prints the shape:
the runs and raw hits of the join, the distinct pairs, the kept
candidates and the spans.  The spans are held to the twins'.  One JSON
line a shape.  --totals then runs phases 8, 9 and 24 (i)'s paths
(the avoid scan's ranks, the ebola175 analysis and the adapter design,
each held to its golden) and prints chip_smoke.span_totals of each:
the span kernels' calls, launches, summed CUDA-event ms and shapes.
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


def split_shape(torch, chip_smoke, ss, name, searcher, strands, device,
                card):
    t0 = time.time()
    mega, starts, ends, total = ss.corpus_codes(searcher, strands)
    lo, cnt, pos = ss.join_runs(searcher, mega[:total])
    host_s = time.time() - t0
    if int(cnt.sum()) > ss._EXPAND_SLAB:
        sys.exit(f"span_split: {name} needs more than one expansion slab")
    vargs = ss.verify_args(searcher)
    lmax = int(searcher.Lmax)
    keep = {}

    def device_part(st):
        st.mark("start")
        lo_t, cnt_t, pos_t = (ss._put(x, device) for x in (lo, cnt, pos))
        st.mark("runs to card")
        tb = ss.device_tables(searcher, device)
        st.mark("searcher's tables (kept on the card)")
        starts_t, ends_t = ss._put(starts, device), ss._put(ends, device)
        st.mark("sequence bounds to card")
        cand = ss._expand_join_cuda(
            lo_t, cnt_t, pos_t, tb["join_p"], tb["join_pos"], lmax,
            tb["index"], ss.keep_args(searcher, starts_t, ends_t), steps=st)
        mega_t = ss._put(mega, device)
        st.mark("corpus to card")
        codes_t = tb["codes"]
        out = ss._verify_spans_cuda(mega_t, codes_t, cand, steps=st,
                                    **vargs)
        sidx = torch.clamp(torch.searchsorted(ends_t, out[1], side="right"),
                           max=ends_t.numel() - 1)
        base = starts_t[sidx]
        spans = (out[0], sidx, out[1] - base, out[2] - base)
        st.mark("sequence of each span")
        keep.update(lo=lo_t, cnt=cnt_t, pos=pos_t, tb=tb, starts=starts_t,
                    ends=ends_t, cand=cand, mega=mega_t, codes=codes_t,
                    out=out, spans=spans)

    device_part(chip_smoke.Steps(torch))
    splits, whole = [], []
    for _ in range(REPS):
        st = chip_smoke.Steps(torch)
        device_part(st)
        sp = st.split()
        splits.append(sp)
        whole.append(sum(sp.values()))
    med = {k: round(statistics.median(sp[k] for sp in splits), 4)
           for k in splits[0]}

    x = keep
    want_pa = ss._expand_join_plain(x["lo"], x["cnt"], x["pos"],
                                    x["tb"]["join_p"], x["tb"]["join_pos"],
                                    lmax)
    want_cand = ss.keep_candidates(searcher, *want_pa, x["starts"],
                                   x["ends"])
    want = ss._verify_spans_plain(x["mega"], x["codes"], *x["cand"],
                                  **vargs)
    torch.cuda.synchronize()
    for g, w in list(zip(x["cand"], want_cand)) + list(zip(x["out"], want)):
        if not torch.equal(g, w):
            sys.exit(f"span_split: {name}: a kernel differs from its twin")

    def k5():
        return ss.expand_join(x["lo"], x["cnt"], x["pos"], x["tb"]["join_p"],
                              x["tb"]["join_pos"], lmax, x["tb"]["index"],
                              ss.keep_args(searcher, x["starts"], x["ends"]))

    def k6():
        return ss.verify_spans(x["mega"], x["codes"], *x["cand"], **vargs)

    wrap = {}
    for what, fn in (("expand_join and keep", k5), ("verify_spans", k6)):
        ms = chip_smoke.cuda_ms(torch, fn, REPS)
        wrap[what] = dict(call_ms=[round(v, 4) for v in ms],
                          kernel_us=kernel_times(torch, fn))
    return dict(
        card=card, shape=name,
        strands=len(strands), corpus_positions=int(total),
        probes=int(searcher.probe_codes.shape[0]),
        join_kw=list(searcher._join_kw),
        table_rows=int(len(searcher._join_h)), runs=int(len(lo)),
        raw_hits=int(cnt.sum()), pairs=int(want_pa[0].numel()),
        kept=int(x["cand"][0].numel()), spans=int(x["out"][0].numel()),
        host_join_s=round(host_s, 3), steps_ms=med,
        device_part_ms=[round(statistics.median(whole), 4),
                        round(min(whole), 4), round(max(whole), 4)],
        wrappers=wrap)


def real_totals(torch, chip_smoke, scf, cands, genomes8, card):
    """chip_smoke.py's span totals of phases 8, 9 and 24 (i), from this
    tree's runs of those paths (each output held to its golden)."""
    from catch_tpu_torch.ops import scan_instance as si
    from catch_tpu_torch.utils import profiling

    in175 = chip_smoke.write_subset(175)
    out = os.path.join(chip_smoke.WORK, "span_split_adapters.fasta")
    want, _ = chip_smoke.expected_ranks(len(cands))
    runs = [
        ("phase 8 avoid scan", lambda: scf._make_ranks(cands, [genomes8]),
         lambda r: (r == want).all()),
        ("phase 9 analysis", lambda: chip_smoke.ebola175_analysis(in175),
         lambda r: True),
        ("phase 24 (i) adapter votes", lambda: chip_smoke.design(
            [in175, "-o", out] + chip_smoke.ADAPTER_FLAGS),
         lambda r: chip_smoke.same_bytes(out, os.path.join(
             chip_smoke.GOLDEN, "ebola175_m2_adapters_rc.fasta")))]
    for what, fn, ok in runs:
        log = []
        with chip_smoke.span_calls(torch, log):
            res, wall, launches, _ = chip_smoke.counted(torch, si, profiling,
                                                        fn)
        if not ok(res):
            sys.exit(f"span_split: {what} differs from its golden")
        print(json.dumps(dict(card=card, what=what,
                              wall_s=round(wall, 3), totals={
                                  k: [v[0], v[1], round(v[2], 4)]
                                  for k, v in chip_smoke.span_totals(
                                      what, log, launches).items()})),
              flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--totals", action="store_true")
    opts = ap.parse_args()
    root, totals = os.path.abspath(opts.root), opts.totals
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        sys.exit("span_split: torch.cuda is not available")
    # this checkout's chip_smoke (its inputs and Steps), whatever --root
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    os.makedirs(chip_smoke.WORK, exist_ok=True)
    from catch_tpu_torch import _build
    from catch_tpu_torch.ops import scan_sparse as ss
    if not os.path.abspath(ss.__file__).startswith(root):
        sys.exit(f"span_split: imported {ss.__file__}, not from {root}")
    _build.library()
    device = torch.device("cuda", 0)
    card = chip_smoke.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"]).splitlines()[0]
    print(json.dumps(dict(card=card, root=root)), flush=True)
    genomes8, cands, scf, bg = chip_smoke.avoid_setup(device)
    for name, searcher, strands in chip_smoke.span_shapes(device, scf,
                                                          cands, bg):
        print(json.dumps(split_shape(torch, chip_smoke, ss, name, searcher,
                                     strands, device, card)),
              flush=True)
    if totals:
        real_totals(torch, chip_smoke, scf, cands, genomes8, card)


if __name__ == "__main__":
    main()
