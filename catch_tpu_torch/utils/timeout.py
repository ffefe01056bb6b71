# Copied from catch_tpu/utils/timeout.py.
"""Time limits on blocking host-side calls.

Capability parity with the reference's SIGALRM-based time_limit
contextmanager (reference catch/utils/timeout.py:16-45).  The
reference used it to survive multiprocessing pool-open/teardown hangs;
this engine has no process pools, but the utility remains useful for
bounding external blocking calls (e.g. NCBI downloads).
"""

from contextlib import contextmanager
import signal

__all__ = ["TimeoutException", "time_limit"]


class TimeoutException(Exception):
    """Raised inside the guarded block when the time limit elapses."""
    pass


@contextmanager
def time_limit(seconds):
    """Limit the runtime of the guarded block to `seconds` (SIGALRM).

    Only usable from the main thread (signal semantics).  A limit of 0
    disables the alarm.
    """

    def signal_handler(signum, frame):
        raise TimeoutException("Timed out")

    old_handler = signal.signal(signal.SIGALRM, signal_handler)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old_handler)
