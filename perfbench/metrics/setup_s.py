"""setup_s: process start to the first timed call, in seconds."""


def read(ctx):
    return ctx.setup_s
