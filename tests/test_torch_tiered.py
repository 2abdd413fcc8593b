"""The port's tiered NRZI path -- decode_tape(kernel_path="tiered"):
admission alone (decode/scan.py, B5b on the one-parmset first pass, B5a
on the 8-parmset retry with its three window widths), then the slot
machine alone (decode/slot.py, B6), plain versions on the CPU -- against
the JAX package's decode_tape (its XLA scans on the CPU), block for block
and statistic for statistic (test_torch_pipeline.compare_decodes).

The tiered path has no admission step budget, as the TPU kernels have
none; the XLA scans stop each lane after ~3.2 steps per bit. On these
tapes the budget does not bind (asserted): the JAX decode is unchanged.
test_torch_tiered_more.py holds the 7-track and -correct tapes and a tape
where the budget binds.

Tolerance: none, as in test_torch_pipeline.py.
"""

import numpy as np
import torch

from readtape_tpu.formats import tbin as tb
from readtape_tpu.synth import default_spec, synthesize_tape
from readtape_tpu_torch.decode import fused as tfu
from readtape_tpu_torch.decode import scan as tsc
from readtape_tpu_torch.decode import slot as tsl

from test_torch_pipeline import compare_decodes, opts_for

torch.set_num_threads(2)


def tiered(samples, opt_kw, monkeypatch, lift_budget=False):
    """compare_decodes through the tiered path; returns (blocks, stats,
    capped, {plain version: calls}). B1's plain version never runs."""
    plains = (tsc.nrzi_track_scan_plain, tsc.nrzi_track_scan_tracks_plain,
              tsl.nrzi_slot_scan_plain, tfu.nrzi_fused_scan_plain)
    before = [f.calls for f in plains]
    out, stats, capped = compare_decodes(samples, opt_kw, monkeypatch,
                                         kernel_path="tiered",
                                         lift_budget=lift_budget)
    calls = {f.__name__: f.calls - c for f, c in zip(plains, before)}
    assert calls["nrzi_fused_scan_plain"] == 0
    assert calls["nrzi_slot_scan_plain"] == (
        calls["nrzi_track_scan_plain"]
        + calls["nrzi_track_scan_tracks_plain"])
    return out, stats, capped, calls


def test_clean_tape(monkeypatch):
    """Three blocks and a tapemark: one pass with parmset 0 (B5b)."""
    rng = np.random.default_rng(7)
    blocks = [bytes(rng.integers(0, 256, 420, dtype=np.uint8))
              for _ in range(3)]
    spec = default_spec(tb.MODE_NRZI, ibg_secs=0.004, start_gap_secs=0.004)
    hdr, samples = synthesize_tape(
        spec, [("block", b) for b in blocks] + [("tapemark",)])
    out, stats, capped, calls = tiered(samples, opts_for(hdr), monkeypatch)
    assert [b.data for b in out if b.kind == "data"] == blocks
    assert stats["ntapemarks"] == 1 and stats["nerrblocks"] == 0
    assert not capped
    assert calls["nrzi_track_scan_tracks_plain"] >= 1
    assert calls["nrzi_track_scan_plain"] == 0


def test_noisy_tape_reaches_the_retry(monkeypatch):
    """Amplitude and timing jitter: every block fails with parmset 0, so
    the 8-parmset retry (three window widths: B5a) decodes them."""
    rng = np.random.default_rng(1)
    blocks = [bytes(rng.integers(0, 256, 420, dtype=np.uint8))
              for _ in range(3)]
    spec = default_spec(tb.MODE_NRZI, noise_rms=0.03, amp_jitter=0.3,
                        time_jitter_bits=0.1, ibg_secs=0.004,
                        start_gap_secs=0.004, seed=1)
    hdr, samples = synthesize_tape(spec, [("block", b) for b in blocks])
    out, stats, capped, calls = tiered(samples, opts_for(hdr), monkeypatch)
    assert stats["chosen"][0] == 0 and stats["chosen"][1:].sum() == 3
    assert not capped
    assert calls["nrzi_track_scan_tracks_plain"] >= 1
    assert calls["nrzi_track_scan_plain"] >= 1
