"""solver_kernels_roofline_pct.design: the device solver's kernels
(stage E, K11, K12) summed least time over their summed device time, %."""
from bench_port.metrics._common import roofline_pct


def read(ctx):
    return roofline_pct(ctx, ("assemble", "init_covered", "greedy_steps_v2"))
