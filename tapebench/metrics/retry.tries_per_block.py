"""Parmset tries per block emitted: sum(stats["tried"]) / stats["nblocks"]
over the traced run's captures, the program's own counters (attempts to
outcomes: 1 where parmset 0 decodes every block, up to 8 where every
segment retries)."""


def read(ctx):
    tried = sum(int(s["tried"].sum()) for s in ctx.stats)
    blocks = sum(int(s["nblocks"]) for s in ctx.stats)
    return tried / blocks if blocks else None
