"""Trainer and loader: kernel launches per step in the traced stretch."""


def read(ctx):
    steps = ctx.bounds.get("steps")
    if ctx.trace is None or not steps or not ctx.trace.kernel_count():
        return None
    return ctx.trace.kernel_count() / steps
