"""scan_s.design: the design scan's phases (scan:*), seconds a design."""
from bench_port.metrics._common import per_design


def read(ctx):
    return per_design(ctx, prefixes=("scan:",))
