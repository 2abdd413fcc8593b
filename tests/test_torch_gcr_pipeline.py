"""The port's GCR decode_tape (readtape_tpu_torch, plain versions on the
CPU) against the JAX package's decode_tape (its XLA scans on the CPU),
tape by tape: every BlockResult (kind, data, parmset, tries, errcount,
warncount, t_start, t_end, detail) and the run statistics (peak
histogram, tried, chosen and the block counters).

Tolerance: none; the f32 detail fields (avg_bit_spacing, the AGC extrema)
are exact too.

Tapes: test_gcr_decode.py's basic recipe (seed 30: two blocks and a
tapemark), test_multiblock.py's short-gap recipe (seed 91: three blocks
behind 0.5 ms gaps), chip_smoke.py's merged tape (those blocks with a
flat 0.5 V level on track 0 across the first gap: one segment holds two
blocks, the all-idle point ends the first, a multi-block round decodes
the second), and
chip_smoke.py's noisy short-gap tape (the same layout under 0.07 V of
numpy noise, seed 7) decoded with -correct, where the 5-parmset retry
runs.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from readtape_tpu.decode import pipeline as jpl
from readtape_tpu.formats import tbin as tb
from readtape_tpu.synth import default_spec, synthesize_tape
from readtape_tpu_torch.decode import fused as tfu
from readtape_tpu_torch.decode import pipeline as tpl

torch.set_num_threads(2)

COUNTERS = ("nblocks", "ntapemarks", "nerrblocks", "nwarnblocks",
            "nunusable", "nmismatched", "nmidbiterr", "ncorrected",
            "ngoodmultiple")


def _tape(name):
    """(header, samples, option overrides, expected data blocks or None)."""
    if name == "basic":
        rng = np.random.default_rng(30)
        blocks = [bytes(rng.integers(0, 256, n, dtype=np.uint8))
                  for n in (154, 100)]
        hdr, samples = synthesize_tape(
            default_spec(tb.MODE_GCR),
            [("block", b) for b in blocks] + [("tapemark",)])
        return hdr, samples, {}, blocks
    if name == "short_gap":
        rng = np.random.default_rng(91)
        blocks = [bytes(rng.integers(0, 256, 80, dtype=np.uint8))
                  for _ in range(3)]
        spec = default_spec(tb.MODE_GCR, ibg_secs=0.0005,
                            start_gap_secs=0.003)
        hdr, samples = synthesize_tape(spec, [("block", b) for b in blocks])
        return hdr, samples, {}, blocks
    if name == "merged":
        hdr, samples = chip_smoke.gcr_merged_tape()
        return hdr, samples, {}, None
    hdr, samples = chip_smoke.gcr_short_gap_tape()
    return hdr, samples, dict(do_correct=True), None


@pytest.mark.parametrize("name", ["basic", "short_gap", "merged",
                                  "short_gap_noise"])
def test_gcr_decode_matches_jax(name, monkeypatch):
    hdr, samples, extra, blocks = _tape(name)
    kw = dict(mode=tb.MODE_GCR, ntrks=9, bpi=9042, ips=25,
              deltat=hdr.tdelta_ns * 1e-9, maxvolts=hdr.maxvolts, **extra)
    jout, jst = jpl.decode_tape(samples, jpl.DecodeOptions(**kw))

    spans, widths = [], []
    orig = tpl.TapeDecoder.dispatch_segment_batch

    def spy(self, s, *a, **k):
        spans.extend(s)
        widths.append(k.get("nparms"))
        return orig(self, s, *a, **k)
    monkeypatch.setattr(tpl.TapeDecoder, "dispatch_segment_batch", spy)
    calls = tfu.gcr_fused_scan_plain.calls
    dec = tpl.TapeDecoder(samples, tpl.DecodeOptions(**kw), device="cpu")
    tout, tst = tpl.decode_tape(samples, dec.opts, device="cpu",
                                decoder=dec)
    assert tfu.gcr_fused_scan_plain.calls > calls

    assert len(tout) == len(jout), ([b.kind for b in tout],
                                    [b.kind for b in jout])
    for i, (t, j) in enumerate(zip(tout, jout)):
        msg = f"{name} block {i}"
        assert (t.kind, t.data, t.parmset, t.tries, t.errcount,
                t.warncount) == (j.kind, j.data, j.parmset, j.tries,
                                 j.errcount, j.warncount), msg
        assert (t.t_start, t.t_end) == (j.t_start, j.t_end), msg
        assert t.detail == j.detail, msg
    for k in ("peak_hist", "peak_trksums", "tried", "chosen"):
        np.testing.assert_array_equal(tst[k], jst[k], err_msg=k)
    for k in COUNTERS + ("skew", "peak_bins"):
        assert tst[k] == jst[k], k
    if blocks is not None:
        assert [b.data for b in tout if b.kind == "data"] == blocks
    if name == "merged":
        assert set(spans) - set(dec.segments()), "no multi-block round"
    if name == "short_gap_noise":
        assert 5 in widths, "no 5-parmset retry"
