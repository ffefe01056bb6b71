"""peak_device_MiB.design: the peak of allocated device memory in the
window."""
from bench_port.metrics._common import peak_mib


def read(ctx):
    return peak_mib(ctx)
