"""The metric arithmetic on fixed shapes and a small chrome trace."""
import types

import pytest
import torch

from bench_port import roofline, run, trace


def test_bound_is_the_larger_time():
    assert roofline.bound_s((3.35e12, 0)) == pytest.approx(1.0)
    assert roofline.bound_s((0, 67e12)) == pytest.approx(1.0)
    assert roofline.bound_s((3.35e12, 2 * 67e12)) == pytest.approx(2.0)


def test_work_of_fixed_shapes():
    codes = torch.zeros((4, 100), dtype=torch.uint8)
    W = 100 - 12 + 1
    assert roofline._build_table((codes, 12), {}, None) == (
        400 + 8 * 4 * W + 16, 2 * 12 * 4 * W)
    corpus = torch.zeros(1000, dtype=torch.uint8)
    assert roofline._rolling_hash((corpus, 50, 16, 12, 999), {}, None) == (
        49 * 16 + 12 + 8 * 50, 2 * 12 * 50)
    ent = torch.zeros((4, W), dtype=torch.int64)
    cnt = torch.tensor([3, 0, 5, 2], dtype=torch.int32)
    q = torch.zeros(9, dtype=torch.int64)
    pairs = (torch.zeros(7), torch.zeros(7))
    later = roofline._lookup_expand((ent, cnt, q, 16), {}, pairs)
    assert later() == (8 * 4 * W + 16 + 72 + 16 * 7, 10 * 4 + 7)
    key = torch.zeros(11, dtype=torch.int64)
    assert roofline._segmented_merge((key, key, key), {}, (key[:5],)) == (
        24 * 16, 11)
    assert roofline._init_covered((key, key, 1000), {}, None) == (
        88 + 1000, 1011)


def test_greedy_work_takes_the_smaller_bound():
    state = {"covered": torch.zeros(1000, dtype=torch.bool)}
    consts = {"ivl_start": torch.zeros(300), "univ_of_pair": torch.zeros(200),
              "cost": torch.zeros(50), "can_uncover": torch.zeros(3)}
    picks = torch.tensor([True] * 4 + [False] * 60)
    w = roofline._greedy_steps_v2((state, consts, 64), {},
                                  (state, None, picks))()
    full = roofline.step_work(1000, 300, 200, 50, 3, 8, 8)
    incr = (1000 + 4 * 1001 + 8 * 300 + 8 * 200 + 4
            + 4 * (8 * 200 + 13 * 50 + 8 * 3), 1000 + 300 + 200 + 4 * 250)
    assert w == min((4 * full[0], 4 * full[1]), incr, key=roofline.bound_s)


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 7, "tid": tid, "args": args}


def small_trace():
    return [
        _x(trace.WINDOW, "user_annotation", 1000, 1000),
        _x(trace.SPAN + "CLI", "user_annotation", 1000, 1000),
        _x(trace.SPAN + "tiling", "user_annotation", 1300, 200),
        _x(trace.KERNEL + "build_table#0", "user_annotation", 1040, 30),
        _x("cudaLaunchKernel", "cuda_runtime", 1050, 2, correlation=1),
        _x("cudaLaunchKernel", "cuda_runtime", 1060, 2, correlation=2),
        _x("cudaMemcpyAsync", "cuda_runtime", 1490, 2, correlation=3),
        _x("void foo_kernel<int>(int*)", "kernel", 1100, 100, tid=9,
           correlation=1),
        _x("void (anonymous namespace)::bar_kernel(int)", "kernel", 1150,
           150, tid=9, correlation=2),
        _x("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 1500, 100,
           tid=9, correlation=3),
        _x("void foo_kernel<int>(int*)", "kernel", 2500, 100, tid=9,
           correlation=4),
    ]


def test_device_busy_is_the_union_in_the_window():
    busy, merged = trace.device_busy(small_trace(), 1000, 2000)
    assert busy == pytest.approx(300e-6)
    assert merged == [[1100, 1300], [1500, 1600]]


def test_reduce_names_gaps_and_kernels():
    work = (3.35e6, 0)   # one microsecond at the bandwidth
    r = trace.reduce(small_trace(), [("build_table", work)])
    assert r["busy_s"] == pytest.approx(300e-6)
    assert r["window_s"] == pytest.approx(1000e-6)
    assert dict(r["idle_gaps"]) == pytest.approx(
        {"CLI": 500e-6, "tiling": 200e-6})
    assert dict(r["device_ops"]) == pytest.approx(
        {"foo_kernel": 100e-6, "bar_kernel": 150e-6, "Memcpy DtoH": 100e-6})
    calls, dev, least = r["kernels"]["build_table"]
    assert calls == 1
    assert dev == pytest.approx(250e-6)
    assert least == pytest.approx(1e-6)


def _ctx(**kw):
    base = dict(phases={}, completed=2, window_s=10.0, setup_s=3.0,
                trace=None, peak_window_bytes=None)
    base.update(kw)
    return types.SimpleNamespace(**base)


def test_readers():
    ctx = _ctx(phases={"candidate_probes": 1.0, "filter:DuplicateFilter": 0.5,
                       "scan:verify": 0.25, "scan:merge": 0.75,
                       "set_cover:solve": 3.0},
               trace={"busy_s": 2.5, "window_s": 10.0,
                      "kernels": {"verify_windows": [3, 0.5, 0.05],
                                  "assemble": [1, 0.1, 0.05]}},
               peak_window_bytes=3 * 2**20)
    assert run.reader("design_s")(ctx) == 5.0
    assert run.reader("setup_s")(ctx) == 3.0
    assert run.reader("tiling_s.design")(ctx) == 0.75
    assert run.reader("scan_s.design")(ctx) == 0.5
    assert run.reader("solve_s.design")(ctx) == 1.5
    assert run.reader("prepare_s.design")(ctx) is None
    assert run.reader("device_idle_pct.design")(ctx) == 75.0
    assert run.reader("peak_device_MiB.design")(ctx) == 3.0
    assert run.reader("scan_kernels_roofline_pct.design")(ctx) == \
        pytest.approx(10.0)
    assert run.reader("solver_kernels_roofline_pct.design")(ctx) == \
        pytest.approx(50.0)
    quiet = _ctx()
    for name in ("device_idle_pct.design", "peak_device_MiB.design",
                 "scan_kernels_roofline_pct.design", "prepare_s.design"):
        assert run.reader(name)(quiet) is None


def test_a_long_gap_is_split_by_the_spans_open_in_it():
    events = [e for e in small_trace()
              if e["cat"] != "gpu_memcpy" and e["args"].get("correlation")
              != 2]
    events.append(_x(trace.SPAN + "solver", "user_annotation", 1700, 100,
                     tid=2))
    r = trace.reduce(events, [])
    assert dict(r["idle_gaps"]) == pytest.approx(
        {"CLI": 600e-6, "tiling": 200e-6, "solver": 100e-6})
    assert r["kernels"] == {}
