"""Lanes the dispatches add to reach a multiple of the mesh's data axis
(the program's dispatch.pad_lanes counter), per capture, mean over the
per-card phase's captures. Nothing where the program has no such
counter."""

import statistics

from tapebench import cards_phase


def read(ctx):
    cards = cards_phase.of(ctx)
    if cards is None or not cards.pad_lanes:
        return None
    return statistics.mean(cards.pad_lanes)
