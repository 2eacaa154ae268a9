"""Service and micro-batcher: requests per ``synthesize_requests`` call
over the window."""


def read(ctx):
    c = ctx.counters
    return c["dispatched"] / c["engine_calls"] if c.get("engine_calls") else None
