"""Kernel launches per capture: the wrappers' .launches counters over the
spanned captures."""


def read(ctx):
    return ctx.launches_per_capture
