"""What the metric readers share."""


def per_design(ctx, keys=(), prefixes=()):
    """Seconds of the program's phases (utils/profiling.phase_seconds,
    summed over the window) named in keys or starting with a prefix,
    per design completed; None where none of them was recorded."""
    hit = [v for k, v in ctx.phases.items()
           if k in keys or k.startswith(tuple(prefixes))]
    if not hit or not ctx.completed:
        return None
    return sum(hit) / ctx.completed


def roofline_pct(ctx, names):
    """The kernels' summed least time over their summed device time in
    the traced window, %; None where they did not run on the card."""
    if ctx.trace is None:
        return None
    rows = [ctx.trace["kernels"][n] for n in names
            if n in ctx.trace["kernels"]]
    dev = sum(r[1] for r in rows)
    if not rows or dev <= 0:
        return None
    return 100.0 * sum(r[2] for r in rows) / dev


def idle_pct(ctx):
    t = ctx.trace
    if t is None or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def peak_mib(ctx):
    if ctx.peak_window_bytes is None:
        return None
    return ctx.peak_window_bytes / 2**20
