"""decode_tape's own time per capture (segments, the staged retry's
bookkeeping, pick_best, block emission): the capture's wall less what the
resident-tape, dispatch and fetch spans cover; the median over captures,
in ms."""

import statistics


def read(ctx):
    vals = [c["wall"] - sum(c.get(k, 0.0) for k in
                            ("resident", "dispatch", "fetch"))
            for c in ctx.spans if "dispatch" in c]
    return statistics.median(vals) * 1e3 if vals else None
