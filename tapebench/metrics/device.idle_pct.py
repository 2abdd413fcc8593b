"""The share of the profiled round not covered by the union of the card's
kernel and copy intervals, in %."""


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.window_s <= 0 or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
