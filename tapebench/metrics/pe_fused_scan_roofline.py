"""B2 pe_fused_scan's share of its roofline over the profiled round, in %
(tapebench/roofline.py counts its work from the launch shapes)."""

from tapebench import roofline


def read(ctx):
    return None if ctx.trace is None else roofline.share_pct(
        ctx.trace, "pe_fused_scan")
