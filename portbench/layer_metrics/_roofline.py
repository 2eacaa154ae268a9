"""A kernel's share of its roofline: the bounds of its calls in the traced
stretch (``roofline/``) over the device time of the kernels whose names
hold ``needles``, in %.  Nothing to read where no such kernel ran."""


def share(ctx, bound_key, *needles):
    if ctx.trace is None:
        return None
    seconds = ctx.trace.kernel_seconds(*needles)
    bound = ctx.bounds.get(bound_key)
    if not seconds or not bound:
        return None
    return 100.0 * bound / seconds
