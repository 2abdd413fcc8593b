"""The port's PE decode_tape (readtape_tpu_torch, plain versions on the
CPU) against the JAX package's decode_tape (its XLA scans on the CPU),
tape by tape: every BlockResult (kind, data, parmset, tries, errcount,
warncount, t_start, t_end, detail) and the run statistics (peak
histogram, tried, chosen and the block counters).

Tolerance: none; the f32 detail fields (avg_bit_spacing, the AGC extrema)
are exact too.

Tapes: test_pe_decode.py's basic, reverse-polarity, dropout and noise
recipes, and the short-gap recipe of test_multiblock.py (seed 89) under
0.06 V of numpy noise, where the all-idle point, the block walk and the
8-parmset retry all run.
"""

import numpy as np
import pytest
import torch

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
        rng = np.random.default_rng(20)
        blocks = [bytes(rng.integers(0, 256, n, dtype=np.uint8))
                  for n in (64, 120)]
        hdr, samples = synthesize_tape(
            default_spec(tb.MODE_PE),
            [("block", b) for b in blocks] + [("tapemark",)])
        return hdr, samples, {}, blocks
    if name == "reverse":
        rng = np.random.default_rng(21)
        blocks = [bytes(rng.integers(0, 256, 80, dtype=np.uint8))]
        hdr, samples = synthesize_tape(default_spec(tb.MODE_PE),
                                       [("block", blocks[0])])
        return hdr, samples, dict(invert=True), blocks
    if name == "dropout":
        rng = np.random.default_rng(22)
        block = bytes(rng.integers(0, 256, 120, dtype=np.uint8))
        spec = default_spec(tb.MODE_PE)
        hdr, samples = synthesize_tape(spec, [("block", block)])
        samples = np.array(samples)
        st = int(spec.start_gap_secs / spec.deltat)
        samples[st + 3000:st + 3800, 4] = 0        # ~20 bits dead on track 4
        return hdr, samples, {}, None
    if name == "noise":
        rng = np.random.default_rng(23)
        blocks = [bytes(rng.integers(0, 256, 100, dtype=np.uint8))]
        hdr, samples = synthesize_tape(
            default_spec(tb.MODE_PE, noise_rms=0.03, amp_jitter=0.04),
            [("block", blocks[0])])
        return hdr, samples, {}, blocks
    rng = np.random.default_rng(89)
    blocks = [bytes(rng.integers(0, 256, 90, dtype=np.uint8))
              for _ in range(3)]
    spec = default_spec(tb.MODE_PE, ibg_secs=0.0006, start_gap_secs=0.003)
    hdr, samples = synthesize_tape(spec, [("block", b) for b in blocks])
    x = samples + rng.normal(0.0, 0.06 / hdr.maxvolts * 32767, samples.shape)
    return hdr, np.clip(np.rint(x), -32767, 32767).astype(np.int16), {}, None


@pytest.mark.parametrize("name", ["basic", "reverse", "dropout", "noise",
                                  "short_gap_noise"])
def test_pe_decode_matches_jax(name, monkeypatch):
    hdr, samples, extra, blocks = _tape(name)
    kw = dict(mode=tb.MODE_PE, ntrks=9, bpi=1600, ips=50,
              deltat=hdr.tdelta_ns * 1e-9, maxvolts=hdr.maxvolts, **extra)
    jout, jst = jpl.decode_tape(samples, jpl.DecodeOptions(**kw))

    # record the port's decode batches: the walk's hops are the spans
    # that are not the tape's own segments
    spans, widths = [], []
    orig = tpl.TapeDecoder.dispatch_segment_batch

    def spy(self, s, *a, **k):
        spans.extend(s)
        widths.append(k.get("nparms"))
        return orig(self, s, *a, **k)
    monkeypatch.setattr(tpl.TapeDecoder, "dispatch_segment_batch", spy)
    calls = tfu.pe_fused_scan_plain.calls
    dec = tpl.TapeDecoder(samples, tpl.DecodeOptions(**kw), device="cpu")
    tout, tst = tpl.decode_tape(samples, dec.opts, device="cpu",
                                decoder=dec)
    assert tfu.pe_fused_scan_plain.calls > calls

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
    if name == "short_gap_noise":
        hops = set(spans) - set(dec.segments())
        assert hops, "the PE walk took no hop"
        assert 8 in widths, "no 8-parmset retry"
