"""TapeDecoder.__init__'s resident tape per capture (the host activity
scan and the upload, pipeline._resident_tape), median over captures, ms."""

from tapebench.spans import median_ms


def read(ctx):
    return median_ms(ctx.spans, "resident")
