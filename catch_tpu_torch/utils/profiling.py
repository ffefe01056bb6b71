# Copied from catch_tpu/utils/profiling.py (the phase accumulator only).
"""Process-wide phase accumulator.

Hot-path components (the scan pipeline, the designer's filter loop)
report wall-clock here in addition to any per-object stats, so an
end-to-end CLI run can be broken down without threading a stats object
through every layer.  Lock-protected: the designer's group pipeline
reports from worker threads, and an unlocked read-modify-write would
drop updates.
"""

import threading

phase_seconds = {}
_phase_lock = threading.Lock()


def add_phase(key, seconds):
    with _phase_lock:
        phase_seconds[key] = phase_seconds.get(key, 0.0) + seconds


def reset_phases():
    with _phase_lock:
        phase_seconds.clear()
