"""test_torch_slot's port-vs-JAX slot-machine comparison on two more of
tests/test_pallas_slot.py's cases: three blocks behind short gaps (the
machine ends the first block at its postamble) and a 7-track segment (a
file of its own so that xdist runs it beside the others)."""

import pytest
import torch

from test_torch_slot import check_slot

torch.set_num_threads(2)


@pytest.mark.parametrize("name", ["3blk", "7trk"])
def test_slot_matches_jax_xla(name):
    check_slot(name)
