"""Synthesis engine: content mel frames (the lengths FastSpeech2 returned)
over the frames handed to the generator (its input shapes), in %."""


def read(ctx):
    c = ctx.counters
    if not c.get("vocoded_frames"):
        return None
    return 100.0 * c["content_frames"] / c["vocoded_frames"]
