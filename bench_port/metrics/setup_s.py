"""setup_s: process start to the window's start."""


def read(ctx):
    return ctx.setup_s
