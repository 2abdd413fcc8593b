"""How many of the mesh's cards work at once: the sum over cards of each
card's busy time in the per-card phase's profiled window, over the union
of all cards' busy time there. 1.0 where the shards take turns, 4.0
where four cards work at once."""

from tapebench import cards_phase


def read(ctx):
    return cards_phase.overlap(cards_phase.of(ctx))
