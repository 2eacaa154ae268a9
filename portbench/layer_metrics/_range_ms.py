"""Device time of the kernels launched inside one of the benchmark's
ranges, per engine call of the traced stretch, in ms."""


def per_call(ctx, name):
    t, calls = ctx.trace, ctx.bounds.get("engine_calls")
    if t is None or not calls or not t.ranges(name):
        return None
    seconds = t.in_range(name)
    return 1e3 * seconds / calls if seconds else None
