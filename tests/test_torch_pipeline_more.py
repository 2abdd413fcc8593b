"""test_torch_pipeline's port-vs-JAX decode_tape comparison for a skewed
tape decoded with -deskew and for test_fused_bail_rescue's noise-burst
tape (a file of its own so xdist runs it beside the others)."""

import numpy as np
import torch

from readtape_tpu.formats import tbin as tb
from readtape_tpu.synth import default_spec, synthesize_tape

from test_torch_pipeline import compare_decodes, opts_for

torch.set_num_threads(2)


def burst_tape():
    """One 320-byte block with a dense square-wave burst (2 V, period 4
    samples) on every track across bit cells 100..260."""
    rng = np.random.default_rng(3)
    spec = default_spec(tb.MODE_NRZI, ibg_secs=0.004, start_gap_secs=0.004)
    payload = bytes(rng.integers(0, 256, 320, dtype=np.uint8))
    hdr, samples = synthesize_tape(spec, [("block", payload)])
    samples = np.asarray(samples).copy()
    deltat = hdr.tdelta_ns * 1e-9
    spb = 1.0 / (800 * 50 * deltat)
    a = int(0.004 / deltat + 100 * spb)
    b = int(0.004 / deltat + 260 * spb)
    amp = np.int16(2.0 / hdr.maxvolts * 32767)
    tt = np.arange(b - a)
    sq = np.where((tt // 2) % 2 == 0, amp, -amp).astype(np.int16)
    samples[a:b, :] = sq[:, None]
    return hdr, samples


def test_deskew(monkeypatch):
    rng = np.random.default_rng(4)
    blocks = [bytes(rng.integers(0, 256, 420, dtype=np.uint8))
              for _ in range(2)]
    spec = default_spec(tb.MODE_NRZI, noise_rms=0.04, amp_jitter=0.08,
                        skew_samples=(0, 2, 1, 0, 3, 0, 1, 2, 0))
    hdr, samples = synthesize_tape(spec, [("block", b) for b in blocks])
    out, stats, capped = compare_decodes(samples, opts_for(hdr, deskew=True),
                                         monkeypatch)
    assert [b.data for b in out if b.kind == "data"] == blocks
    assert any(stats["skew"]) and not capped


def test_noise_burst_tape(monkeypatch):
    """test_fused_bail_rescue's tape: a dense square-wave burst across bit
    cells 100..260 admits transitions faster than the slot machine
    consumes them. The TPU kernel's 256-entry ring bails there and the
    JAX pipeline re-decodes through its XLA scans, whose admission runs
    out of its step budget; the port keeps every transition in its [T, K]
    buffers, stops at the same budget and must give the same bytes."""
    hdr, samples = burst_tape()
    out, stats, capped = compare_decodes(samples, opts_for(hdr), monkeypatch)
    assert out and stats["nblocks"] + stats["nunusable"] >= 1
    assert capped
