"""scan_kernels_roofline_pct.design: the design scan's six kernels'
summed least time over their summed device time, %."""
from bench_port.metrics._common import roofline_pct


def read(ctx):
    return roofline_pct(ctx, ("build_table", "rolling_hash", "lookup_expand",
                              "verify_windows", "segmented_merge",
                              "pack_merged"))
