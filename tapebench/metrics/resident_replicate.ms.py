"""The resident tape's copies to the mesh's other cards, as the cards
run them: the union of the per-card phase's card-to-card copies
(Memcpy PtoP in its profiled window; after the tape's, only the
parmsets' few hundred bytes a card), per capture, ms. Nothing where the
window holds no such copy."""

from tapebench import cards_phase


def read(ctx):
    return cards_phase.peer_ms(cards_phase.of(ctx))
