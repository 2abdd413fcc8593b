"""The mean over the cell's cards of each card's own idle share of the
per-card phase's profiled window, in %: on one card device.idle_pct's
arithmetic; under a mesh one busy card does not hide idle ones, as the
union over every card would."""

from tapebench import cards_phase


def read(ctx):
    return cards_phase.card_idle_pct(cards_phase.of(ctx))
