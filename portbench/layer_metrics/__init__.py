"""One reader per per-layer metric, found by the metric's name without its
group (``mfu.train`` → ``mfu.py``).  ``read(ctx)`` returns the number, or
None where the run holds nothing to read: the harness then leaves the
metric out of the line.  ``ctx`` holds ``trace`` (``harness.trace.Trace``
of the traced stretch), ``counters`` (the window's counts), ``bounds``
(the traced stretch's kernel calls as ``roofline/`` counts them) and
``window`` (the window's wall time and the traced stretch's)."""
