"""TapeDecoder.dispatch_segment_batch per capture (window gather,
_prep_volts, the kernels, the finish), median over captures, ms."""

from tapebench.spans import median_ms


def read(ctx):
    return median_ms(ctx.spans, "dispatch")
