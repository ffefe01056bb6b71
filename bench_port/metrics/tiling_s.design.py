"""tiling_s.design: tiling and the duplicate filter, seconds a design."""
from bench_port.metrics._common import per_design


def read(ctx):
    return per_design(ctx, keys=("candidate_probes", "filter:DuplicateFilter"))
