"""Trainer and loader: host ms per step spent waiting for the loader's
next batch, over the window."""


def read(ctx):
    c = ctx.counters
    return 1e3 * c["loader_wait_s"] / c["steps"] if c.get("steps") else None
