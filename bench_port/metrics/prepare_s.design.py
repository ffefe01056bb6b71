"""prepare_s.design: the set-cover filter's scan set-up, seconds a design."""
from bench_port.metrics._common import per_design


def read(ctx):
    return per_design(ctx, keys=("set_cover:prepare",))
