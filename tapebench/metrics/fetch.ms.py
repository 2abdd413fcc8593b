"""pipeline._fetch per capture (the results' one device-to-host round
trip per batch), median over captures, ms."""

from tapebench.spans import median_ms


def read(ctx):
    return median_ms(ctx.spans, "fetch")
