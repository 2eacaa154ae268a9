"""Device: share of the traced stretch with nothing running on the card, in %."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.window_s or not t.busy_s:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
