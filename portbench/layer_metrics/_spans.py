"""The program's own spans in the traced stretch (``emotts_torch``'s
``utils/trace.py`` names each phase ``emotts_torch.<phase>``): the host
time inside given spans, and the card's idle time between two busy
intervals that falls inside them, per engine call.  A trace with none of
the spans (a program that opens none) reads None."""

from harness.trace import _union

PREFIX = "emotts_torch."


def _inside(trace, names):
    """The union of the host intervals of the spans ``names``."""
    want = {PREFIX + n for n in names}
    return _union([(s, t) for s, t, n in trace._host_ops if n in want])


def _calls(ctx):
    calls = ctx.bounds.get("engine_calls")
    return calls if ctx.trace is not None and calls else None


def host_ms(ctx, *names):
    """Host ms per engine call inside the spans ``names``."""
    calls = _calls(ctx)
    spans = _inside(ctx.trace, names) if calls else []
    if not spans:
        return None
    return 1e3 * sum(t - s for s, t in spans) / calls


def idle_ms(ctx, *names):
    """Card-idle ms per engine call that falls inside the spans ``names``:
    each gap between consecutive busy intervals, cut to those spans."""
    calls = _calls(ctx)
    spans = _inside(ctx.trace, names) if calls else []
    if not spans:
        return None
    busy = ctx.trace._busy
    idle, i = 0.0, 0
    for (_, a), (b, _) in zip(busy, busy[1:]):
        while i < len(spans) and spans[i][1] <= a:
            i += 1
        j = i
        while j < len(spans) and spans[j][0] < b:
            idle += min(b, spans[j][1]) - max(a, spans[j][0])
            j += 1
    return 1e3 * idle / calls
