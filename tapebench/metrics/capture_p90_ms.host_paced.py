"""The 90th percentile of every capture's wall in the traced run's
untraced half (host clock), in ms: the capture tail where the card idles
most of the window, so the host sets it."""

import statistics


def read(ctx):
    if len(ctx.walls) < 2:
        return None
    return statistics.quantiles(ctx.walls, n=10, method="inclusive")[8] * 1e3
