"""device_idle_pct.design: the share of the traced window in which the
card ran nothing, %."""
from bench_port.metrics._common import idle_pct


def read(ctx):
    return idle_pct(ctx)
