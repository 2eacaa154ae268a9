"""Device, the whole step: the least time the chip could take for the
window's delivered work (``roofline/model_flops.py`` on content frames
over the peaks of ``roofline/peaks.py``) over the window's wall time, in %;
the traced stretch, its work and its profiler's overhead left out."""


def read(ctx):
    least, wall = ctx.counters.get("least_time_s"), ctx.window.get("untraced_s")
    if not least or not wall:
        return None
    return 100.0 * least / wall
