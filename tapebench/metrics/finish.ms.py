"""nrzi_finish or pe_finish per capture (inside dispatch), median over
captures, ms."""

from tapebench.spans import median_ms


def read(ctx):
    return median_ms(ctx.spans, "finish")
