# device_busy and the capture warm-up copied from chip_smoke.py (device_busy) and catch_tpu_torch/utils/profiling.py (_WARM_UP_LAUNCHES, _warm_up).
"""The traced window: spans and kernel calls marked from the
benchmark's side, one torch.profiler capture, and its reduction.

In a traced run the benchmark wraps, for the window only, each layer
entry that `spans.json` names in a record_function range
``bench_port.span:<layer>``, and each kernel wrapper that roofline.WORK
names in a range ``bench_port.kernel:<name>#<call>``, noting the
call's work from its shapes.  The capture holds both, the runtime's
launches and the card's kernels, copies and sets.  reduce() then gives
the card's busy time (the union of its intervals) over the window, the
device operations that took most time, the idle gaps by the innermost
span open on the host, and each kernel call's device time: the card's
work that its launches made, correlated with the launches inside its
range, so a wrapper's library sorts count as its own.
"""

import bisect
import contextlib
import functools
import importlib
import json
import os

# On an H100, a capture made after an earlier profiler session in the
# process lost kernel records: the first ones were missing.  A capture
# first launches this many one-element adds and waits for them, so that
# such a loss falls on them and not on the window.
_WARM_UP_LAUNCHES = 256
# Device work of these categories makes the card busy.
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
SPAN = "bench_port.span:"
KERNEL = "bench_port.kernel:"
WINDOW = "bench_port.window"
# Idle gaps shorter than this are summed under one name, not labelled.
_SHORT_GAP_US = 20.0


def warm_up(torch, device):
    w = torch.zeros(1, device=device)
    for _ in range(_WARM_UP_LAUNCHES):
        w.add_(1)
    torch.cuda.synchronize(device)


def device_busy(events, t0, t1):
    """(busy seconds, merged busy intervals in us) of the card's kernel,
    copy and set intervals clipped to [t0, t1] (trace microseconds)."""
    ivs = sorted((max(e["ts"], t0), min(e["ts"] + e["dur"], t1))
                 for e in events if e.get("ph") == "X"
                 and e.get("cat") in _DEVICE_CATS
                 and e["ts"] + e["dur"] > t0 and e["ts"] < t1)
    merged = []
    for a, b in ivs:
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1][1] = b
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged) / 1e6, merged


def _resolve(path):
    """(owner, attribute) of 'module:attr' or 'module:Class.attr'."""
    mod, _, attr = path.partition(":")
    owner = importlib.import_module(mod)
    *outer, name = attr.split(".")
    for part in outer:
        owner = getattr(owner, part)
    return owner, name


class Instrument:
    """Wraps the program's layer entries and kernel wrappers for one
    traced window; restores them on exit."""

    def __init__(self, torch, span_table, work_table):
        self.torch = torch
        self.span_table = span_table
        self.work_table = work_table
        self.calls = []
        self._saved = []

    def _span(self, name, fn):
        record = self.torch.profiler.record_function

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with record(SPAN + name):
                return fn(*args, **kwargs)
        return wrapped

    def _kernel(self, name, fn, work):
        record = self.torch.profiler.record_function
        calls = self.calls

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            i = len(calls)
            calls.append([name, None])
            with record(f"{KERNEL}{name}#{i}"):
                out = fn(*args, **kwargs)
            calls[i][1] = work(args, kwargs, out)
            return out
        # the wrapper counts its launches on its module's name
        wrapped.launches = getattr(fn, "launches", 0)
        return wrapped

    def __enter__(self):
        for path, name in self.span_table:
            owner, attr = _resolve(path)
            fn = getattr(owner, attr)
            self._saved.append((owner, attr, fn))
            setattr(owner, attr, self._span(name, fn))
        for (mod, attr), work in self.work_table.items():
            owner = importlib.import_module(mod)
            fn = getattr(owner, attr)
            self._saved.append((owner, attr, fn))
            setattr(owner, attr, self._kernel(attr, fn, work))
        return self

    def __exit__(self, *exc):
        for owner, attr, fn in reversed(self._saved):
            wrapped = getattr(owner, attr)
            if hasattr(fn, "launches"):
                fn.launches = getattr(wrapped, "launches", fn.launches)
            setattr(owner, attr, fn)
        self._saved.clear()
        return False

    def works(self):
        """Each call's (name, (bytes, operations)), read once the window
        has closed."""
        return [(n, w() if callable(w) else w) for n, w in self.calls]


def load_span_table(path):
    with open(path) as f:
        return [tuple(x) for x in json.load(f)["spans"]]


def _short(name):
    """A device operation's name without its return type, template and
    argument lists."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return name.split("(")[0].split("<")[0].strip() or name


def _host_timeline(spans, t0, t1):
    """[t0, t1) cut into pieces, each labelled with the innermost span
    open on the host there (the latest started of those open, on any
    thread), or "host outside the spans"."""
    import heapq
    cuts = sorted({t0, t1} | {x for s, e, _ in spans for x in (s, e)
                              if t0 < x < t1})
    by_start = sorted(spans)
    open_, j, out = [], 0, []
    for a, b in zip(cuts, cuts[1:]):
        while j < len(by_start) and by_start[j][0] <= a:
            s, e, name = by_start[j]
            heapq.heappush(open_, (-s, e, name))
            j += 1
        # spans that ended are dropped as they surface
        label = "host outside the spans"
        while open_:
            s, e, name = open_[0]
            if e > a:
                label = name
                break
            heapq.heappop(open_)
        out.append((a, b, label))
    return out


def reduce(events, works, top=10):
    """The traced window's numbers from the chrome trace's events and
    Instrument.works(): busy_s, window_s, device_ops and idle_gaps (at
    most `top` of each, seconds, largest first) and kernels: for each
    kernel wrapper, [calls, device seconds, least seconds]."""
    from bench_port import roofline

    win = [e for e in events if e.get("ph") == "X"
           and e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if len(win) != 1:
        raise RuntimeError(f"the trace holds {len(win)} window ranges")
    t0, t1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    busy, merged = device_busy(events, t0, t1)

    ops = {}
    dev_by_corr = {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in _DEVICE_CATS:
            continue
        corr = e.get("args", {}).get("correlation")
        if corr is not None:
            dev_by_corr[corr] = dev_by_corr.get(corr, 0.0) + e["dur"]
        if e["ts"] >= t0 and e["ts"] < t1:
            n = _short(e["name"])
            ops[n] = ops.get(n, 0.0) + e["dur"] / 1e6

    # kernel ranges per host thread, and each launch inside one
    ranges = {}
    spans = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") != "user_annotation":
            continue
        if e["name"].startswith(KERNEL):
            ranges.setdefault((e["pid"], e["tid"]), []).append(
                (e["ts"], e["ts"] + e["dur"], e["name"]))
        elif e["name"].startswith(SPAN):
            spans.append((e["ts"], e["ts"] + e["dur"],
                          e["name"][len(SPAN):]))
    for v in ranges.values():
        v.sort()
    starts = {k: [r[0] for r in v] for k, v in ranges.items()}
    dev_us = {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in _LAUNCH_CATS:
            continue
        corr = e.get("args", {}).get("correlation")
        if corr not in dev_by_corr:
            continue
        key = (e["pid"], e["tid"])
        if key not in ranges:
            continue
        # a thread's kernel ranges do not overlap: only the last one
        # started before the launch can hold it
        i = bisect.bisect_right(starts[key], e["ts"]) - 1
        if i >= 0 and e["ts"] <= ranges[key][i][1]:
            name = ranges[key][i][2]
            dev_us[name] = dev_us.get(name, 0.0) + dev_by_corr[corr]
    kernels = {}
    for i, (name, work) in enumerate(works):
        k = kernels.setdefault(name, [0, 0.0, 0.0])
        k[0] += 1
        k[1] += dev_us.get(f"{KERNEL}{name}#{i}", 0.0) / 1e6
        k[2] += roofline.bound_s(work)

    gaps = {}
    short = f"gaps under {_SHORT_GAP_US:g} us"
    idle = []
    edges = [t0] + [x for iv in merged for x in iv] + [t1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b - a >= _SHORT_GAP_US:
            idle.append((a, b))
        elif b > a:
            gaps[short] = gaps.get(short, 0.0) + (b - a) / 1e6
    for a, b, label in _host_timeline(spans, t0, t1):
        # the idle time within [a, b), gaps sorted and disjoint
        i = bisect.bisect_right(idle, (a, float("inf"))) - 1
        i = max(i, 0)
        while i < len(idle) and idle[i][0] < b:
            lo, hi = max(a, idle[i][0]), min(b, idle[i][1])
            if hi > lo:
                gaps[label] = gaps.get(label, 0.0) + (hi - lo) / 1e6
            i += 1

    def top_of(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda x: -x[1])
                [:top]]
    return dict(busy_s=busy, window_s=(t1 - t0) / 1e6,
                device_ops=top_of(ops), idle_gaps=top_of(gaps),
                kernels=kernels)


@contextlib.contextmanager
def capture(torch, device, path):
    """torch.profiler over the block (host and CUDA activity), after the
    warm-up; the chrome trace is written to `path`."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.device(device).type == "cuda"
    kw = {}
    try:
        # the designer's group threads launch and mark spans too
        kw["experimental_config"] = \
            torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except (AttributeError, TypeError):
        pass
    prof = profile(activities=[ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if cuda else []), **kw)
    prof.start()
    try:
        if cuda:
            warm_up(torch, device)
        yield
    finally:
        prof.stop()
    prof.export_chrome_trace(path)


def read_events(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    return events
