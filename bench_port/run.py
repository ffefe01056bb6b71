#!/usr/bin/env python3
"""The benchmark of catch_tpu_torch on one NVIDIA H100.

    python3 bench_port/run.py --workload NAME --seed N --seconds S \
        --trace 0|1 [--control]

Run from the root of a checkout, with PYTHONHASHSEED fixed (the
command in BENCHMARK.json sets it).  The cell NAME of BENCHMARK.json
names a configuration (its file under bench_port/configs/) and a
traffic mix (bench_port/traffic/<traffic>.json); what belongs to one
name (an entry, a generator, a check, a metric's reader) is a file of
its own that plugins.py finds.  The run:

1. set-up: imports the program, loads its kernel library (built into
   build/catch_tpu_torch/ inside the checkout on the first run), writes
   the cell's jobs from the seed under TMPDIR by the traffic's
   generator, and runs one more job of the same shape to warm up;
2. the window: calls the configuration's entry (for a design,
   catch_tpu_torch.cli.design.main) on one job after another, in this
   process, until --seconds have passed (a closed loop of one user);
   the window ends when the last job started ends;
3. with --trace 1, the same window under torch.profiler, with the
   benchmark's spans and kernel calls marked (trace.py);
4. after the window: the peak device memory is read, the program's
   state freed, and a sample of the jobs compared with the plain
   reference (check.py), which runs on the card.

It prints the compared numbers beside their limits as its last lines
on standard error, and one JSON line last on standard output: correct,
attempted, failed, metrics (the cell's end-to-end metrics, or with
--trace 1 its per-layer metrics, each read by bench_port/metrics/<name>.py),
device, and with --trace 1 breakdown; the compared numbers come last,
under "checks".  --control runs every job with the configuration's
control_args added (a model that breaks a stated guarantee), whose
checks must fail.  There is no CPU fallback: without enough CUDA cards
the run exits with 2 and prints no result.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
import types  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "bench_port")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from bench_port import plugins  # noqa: E402

# Top-level module names that no run may load: JAX and the JAX package
# the port was made from (catch_tpu_torch is another name).
FORBIDDEN = ("jax", "jaxlib", "flax", "catch_tpu")


def set_cache_dirs():
    """Every build and kernel cache at a fixed path inside the checkout
    (the program's own kernel library builds into build/catch_tpu_torch/
    beside its package)."""
    base = os.path.join(ROOT, "build", "bench_port")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")


def forbidden_loaded():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_cell(name, bench_path=None):
    """(cell, configuration, traffic, end-to-end metrics, per-layer
    metrics) of the cell `name` in BENCHMARK.json; each metric list
    holds the metrics that this cell reports."""
    with open(bench_path or os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cfg = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(os.path.join(ROOT, cfg["file"])) as f:
        config = json.load(f)
    with open(os.path.join(HERE, "traffic", cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    moves = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in moves)]
    return cell, config, traffic, e2e, layer


def reader(name):
    """The read(ctx) function of bench_port/metrics/<name>.py."""
    return plugins.load("metrics", name).read


def power_limit_w():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def run_job(config, job, device, extra):
    """One job through the configuration's entry
    (bench_port/entries/<entry>.py), in this process."""
    plugins.load("entries", config["entry"]).run(config, job, extra, device)


def run_cell(config, traffic, e2e, layer, *, seed, seconds, trace, device,
             control=False, t_start=None):
    """Set-up, the window and the comparison of one run; returns the
    result's dict (without `device` where `device` is not a card)."""
    import torch

    from bench_port import check, traffic as traffic_mod
    from bench_port import trace as trace_mod
    from bench_port import roofline
    from catch_tpu_torch import _build
    from catch_tpu_torch.utils import profiling

    t_start = T_START if t_start is None else t_start
    cuda = torch.device(device).type == "cuda"
    if cuda:
        _build.library()
    extra = config["control_args"] if control else []
    saved_env = {k: os.environ.get(k) for k in traffic["env"]}
    os.environ.update(traffic["env"])
    work = tempfile.mkdtemp(prefix="bench_port.", dir=os.environ.get(
        "TMPDIR"))
    try:
        t0 = time.time()
        jobs = traffic_mod.make_jobs(ROOT, config, traffic, seed, work,
                                     traffic["jobs"] + 1)
        warm, jobs = jobs[-1], jobs[:-1]
        t1 = time.time()
        run_job(config, warm, device, extra)
        print(f"bench_port: set-up: import and library "
              f"{t0 - t_start:.3f} s, {len(jobs) + 1} jobs written "
              f"{t1 - t0:.3f} s, warm job {time.time() - t1:.3f} s",
              file=sys.stderr)
        if cuda:
            torch.cuda.synchronize()
            setup_peak = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        trace_path = os.path.join(work, "trace.json")
        profiling.reset_phases()
        with contextlib.ExitStack() as stack:
            if trace:
                stack.enter_context(trace_mod.capture(torch, device,
                                                      trace_path))
                inst = stack.enter_context(trace_mod.Instrument(
                    torch, trace_mod.load_span_table(
                        os.path.join(HERE, "spans.json")), roofline.WORK))
                stack.enter_context(torch.profiler.record_function(
                    trace_mod.WINDOW))
            t_win = time.time()
            deadline = t_win + seconds
            attempted = 0
            for job in jobs:
                if time.time() >= deadline:
                    break
                attempted += 1
                t0 = time.time()
                try:
                    run_job(config, job, device, extra)
                except Exception as exc:  # a failed job is counted
                    job.error = exc
                    traceback.print_exc()
                if cuda:
                    torch.cuda.synchronize()
                job.seconds = time.time() - t0
            t_end = time.time()
        if attempted == len(jobs) and t_end < deadline:
            print(f"bench_port: the traffic ran out of jobs after "
                  f"{t_end - t_win:.3f} s of {seconds} s", file=sys.stderr)
        with profiling._phase_lock:
            phases = dict(profiling.phase_seconds)
        peak_window = torch.cuda.max_memory_allocated() if cuda else None
        tr = None
        if trace:
            works = inst.works()
            tr = trace_mod.reduce(trace_mod.read_events(trace_path), works)
        done = [j for j in jobs if j.seconds is not None and j.error is None]
        ctx = types.SimpleNamespace(
            phases=phases, completed=len(done), window_s=t_end - t_win,
            setup_s=t_win - t_start, trace=tr, peak_window_bytes=peak_window)
        metrics = {}
        for m in (layer if trace else e2e):
            v = reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        t0 = time.time()
        sample = check.sample(jobs, traffic["check_jobs"], seed)
        checks, rejected = check.compare(config, sample, device)
        print(f"bench_port: window {t_end - t_win:.3f} s, "
              f"{len(done)} of {attempted} jobs completed, job seconds "
              f"{[round(j.seconds, 3) for j in jobs if j.seconds]}; "
              f"reference {time.time() - t0:.3f} s", file=sys.stderr)
        failed = sum(j.error is not None for j in jobs) + rejected
        correct = bool(done) and failed == 0
        result = {"correct": correct, "attempted": attempted,
                  "failed": failed, "metrics": metrics}
        if cuda:
            dev = {"platform": "gpu",
                   "kind": torch.cuda.get_device_name(0), "count": 1,
                   "memory_peak_bytes": max(setup_peak, peak_window),
                   "power_limit_w": power_limit_w()}
            if tr is not None:
                dev["busy_s"] = tr["busy_s"]
                dev["window_s"] = tr["window_s"]
            result["device"] = dev
        if tr is not None:
            result["breakdown"] = {"device_ops": tr["device_ops"],
                                   "idle_gaps": tr["idle_gaps"]}
        print(f"bench_port: {len(sample)} of {len(done)} completed jobs "
              f"compared with the reference", file=sys.stderr)
        result["checks"] = checks
        return result
    finally:
        shutil.rmtree(work, ignore_errors=True)
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="run the configuration's control (must fail)")
    args = ap.parse_args(argv)
    set_cache_dirs()
    cell, config, traffic, e2e, layer = load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"bench_port: the cell needs {cell['chips']} CUDA card(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(config, traffic, e2e, layer, seed=args.seed,
                      seconds=args.seconds, trace=bool(args.trace),
                      device="cuda", control=args.control)
    bad = forbidden_loaded()
    if bad:
        print(f"bench_port: the run loaded {bad}", file=sys.stderr)
        return 3
    for k, v in result["checks"].items():
        print(f"check {k}: {v['value']} (limit {v['limit']})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
