# Copied from catch_tpu/utils/profiling.py (with maybe_trace on torch.profiler).
"""Profiling hooks: the process-wide phase accumulator and the traces of
the hot regions.

Set CATCH_TPU_PROFILE_DIR=/path to capture one torch.profiler trace per
hot region (the design scan, the span scan's join and verify, the device
set-cover solve) into /path/<region>/ on the region's first execution,
as a chrome trace (view it in chrome://tracing or Perfetto).  Unset (the
default) the hooks are free.  catch_tpu's enable_compilation_cache has
no counterpart: the kernels' build (catch_tpu_torch/_build.py) is
already keyed by a hash of their sources and kept on disk.
"""

import contextlib
import logging
import os
import threading

logger = logging.getLogger(__name__)

# Regions captured in this process, and whether a capture is running:
# torch.profiler is process-wide, so one capture runs at a time.  A
# region that finds another capture running runs untraced and stays
# uncaptured.
_captured = set()
_capturing = False
_capture_lock = threading.Lock()

# On an H100, a capture made after an earlier profiler session in the
# process lost kernel records: chip_smoke.py phase 25's design-scan trace
# held 30 kernels of its 42 launches, the first ones missing.  A capture
# with CUDA activity first launches this many one-element adds and waits
# for them, so that such a loss falls on them and not on the region.
_WARM_UP_LAUNCHES = 256

# Process-wide phase accumulator: hot-path components (the scan
# pipeline, the designer's filter loop) report wall-clock here in
# addition to any per-object stats, so an end-to-end CLI run can be
# broken down without threading a stats object through every layer.
# Benchmarks reset it around a run and snapshot afterwards.  Lock-
# protected: the designer's group pipeline reports from worker
# threads, and an unlocked read-modify-write would drop updates.
phase_seconds = {}
_phase_lock = threading.Lock()


def add_phase(key, seconds):
    with _phase_lock:
        phase_seconds[key] = phase_seconds.get(key, 0.0) + seconds


def reset_phases():
    with _phase_lock:
        phase_seconds.clear()


def snapshot_phases():
    with _phase_lock:
        return {k: round(v, 2) for k, v in phase_seconds.items()}


def _claim(region):
    """True when this call is to capture `region`: it was not captured
    yet and no other capture runs.  Marks it captured and running."""
    global _capturing
    with _capture_lock:
        if region in _captured or _capturing:
            return False
        _captured.add(region)
        _capturing = True
        return True


def _release():
    global _capturing
    with _capture_lock:
        _capturing = False


def _warm_up(torch, device):
    w = torch.zeros(1, device=device)
    for _ in range(_WARM_UP_LAUNCHES):
        w.add_(1)
    torch.cuda.synchronize(device)


@contextlib.contextmanager
def maybe_trace(region, device=None):
    """Trace the wrapped block with torch.profiler on first execution.

    One capture per region name per process, so steady-state loops pay
    nothing and the trace directory stays small.  CPU activity always,
    CUDA activity when `device` is a CUDA device (after _warm_up); the
    block runs inside record_function(region).  A profiler that fails to start or stop is
    logged, and the block runs on.
    """
    trace_dir = os.environ.get("CATCH_TPU_PROFILE_DIR")
    if not trace_dir or not _claim(region):
        yield
        return
    try:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        path = os.path.join(trace_dir, region)
        os.makedirs(path, exist_ok=True)
        logger.info("Capturing torch.profiler trace for region %r to %s",
                    region, path)
        cuda = device is not None and torch.device(device).type == "cuda"
        activities = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cuda else [])
        try:
            prof = profile(activities=activities)
            prof.start()
        except Exception:
            logger.exception("Could not start profiler trace for %r; "
                             "continuing without it", region)
            prof = None
        try:
            if prof is not None and cuda:
                _warm_up(torch, device)
            with record_function(region):
                yield
        finally:
            if prof is not None:
                try:
                    prof.stop()
                    prof.export_chrome_trace(os.path.join(
                        path, f"{os.getpid()}.pt.trace.json"))
                except Exception:
                    logger.exception("Profiler trace for %r failed to "
                                     "finalize", region)
    finally:
        _release()
