"""solve_s.design: the set-cover solve, seconds a design."""
from bench_port.metrics._common import per_design


def read(ctx):
    return per_design(ctx, keys=("set_cover:solve",))
