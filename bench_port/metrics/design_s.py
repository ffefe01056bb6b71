"""design_s: the window's seconds over the design jobs it completed."""


def read(ctx):
    return ctx.window_s / ctx.completed if ctx.completed else None
