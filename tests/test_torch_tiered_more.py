"""test_torch_tiered's port-vs-JAX comparison of the tiered NRZI path on
a 7-track tape and under -correct (a file of its own so that xdist runs
it beside the others)."""

import numpy as np
import torch

from readtape_tpu.formats import tbin as tb
from readtape_tpu.synth import default_spec, synthesize_tape

from test_torch_pipeline import opts_for
from test_torch_tiered import tiered

torch.set_num_threads(2)


def test_seven_track_tape(monkeypatch):
    rng = np.random.default_rng(12)
    blocks = [bytes(rng.integers(0, 64, 200, dtype=np.uint8))
              for _ in range(2)]
    spec = default_spec(tb.MODE_NRZI, ntrks=7, bpi=556, ibg_secs=0.004,
                        start_gap_secs=0.004)
    hdr, samples = synthesize_tape(
        spec, [("block", b) for b in blocks] + [("tapemark",)])
    kw = dict(opts_for(hdr), bpi=556)
    out, stats, capped, _ = tiered(samples, kw, monkeypatch)
    assert [b.data for b in out if b.kind == "data"] == blocks
    assert stats["ntapemarks"] == 1 and not capped


def test_correct_option(monkeypatch):
    """-correct on test_torch_pipeline's noisy -correct tape."""
    rng = np.random.default_rng(11)
    blocks = [bytes(rng.integers(0, 256, 420, dtype=np.uint8))
              for _ in range(2)]
    spec = default_spec(tb.MODE_NRZI, noise_rms=0.08, amp_jitter=0.1,
                        ibg_secs=0.004, start_gap_secs=0.004, seed=11)
    hdr, samples = synthesize_tape(spec, [("block", b) for b in blocks])
    _, _, capped, _ = tiered(samples, opts_for(hdr, do_correct=True),
                             monkeypatch)
    assert not capped
