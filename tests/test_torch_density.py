"""Density detection in the port (TapeDecoder.detect_density, for tapes
decoded with bpi <= 0) against the JAX package's
TapeDecoder.detect_density, on short synthesized tapes: 9-track NRZI at
800 bpi, 7-track NRZI at 556 and 200 bpi, 9-track PE at 1600 bpi. Both
segment with the provisional 1600 bpi, run NRZI admission with window 8
and the XLA scan's step budget over the leading segments (the port's
plain B5b on the CPU), and histogram the transition spacings on the host
with the same numpy expressions: the standard density and the raw
estimate must be equal, the raw one to the last bit. Then decode_tape
with bpi=0 must give what decode_tape with the true density gives, and
report the detection in stats["density"].
"""

import numpy as np
import pytest
import torch

from readtape_tpu.decode import pipeline as jpl
from readtape_tpu_torch.decode import pipeline as tpl
from readtape_tpu_torch.decode import scan as tsc
from readtape_tpu_torch.formats import tbin as tb
from readtape_tpu_torch.synth import default_spec, synthesize_tape

torch.set_num_threads(2)

# name: (mode, ntrks, bpi, values per byte, block sizes)
TAPES = {"nrzi9_800": (tb.MODE_NRZI, 9, 800, 256, (300, 120)),
         "nrzi7_556": (tb.MODE_NRZI, 7, 556, 64, (200, 90)),
         "nrzi7_200": (tb.MODE_NRZI, 7, 200, 64, (120,)),
         "pe9_1600": (tb.MODE_PE, 9, 1600, 256, (80, 48))}


def tape(name):
    """(true bpi, samples, the decode options' fields with bpi 0)."""
    mode, ntrks, bpi, hi, sizes = TAPES[name]
    rng = np.random.default_rng(31)
    # NRZI pulses as wide in time as the 800 bpi tape's (a head's pulse
    # width does not grow with the bit cell): at the synthesizer's default
    # of 0.3 bit a 556 or 200 bpi pulse is too broad for the detector's
    # 8-sample window, and the JAX package finds no density either
    pulse = dict(pulse_width_bits=0.3 * bpi / 800) if mode == tb.MODE_NRZI \
        else {}
    spec = default_spec(mode, ntrks=ntrks, bpi=bpi, ibg_secs=0.004,
                        start_gap_secs=0.004, **pulse)
    items = [("block", bytes(rng.integers(0, hi, n, dtype=np.uint8)))
             for n in sizes] + [("tapemark",)]
    hdr, samples = synthesize_tape(spec, items)
    kw = dict(mode=mode, ntrks=ntrks, bpi=0.0, ips=50.0,
              deltat=hdr.tdelta_ns * 1e-9, maxvolts=hdr.maxvolts)
    return bpi, samples, kw


@pytest.mark.parametrize("name", list(TAPES))
def test_detect_density_matches_jax(name):
    bpi, samples, kw = tape(name)
    jdec = jpl.TapeDecoder(samples, jpl.DecodeOptions(**kw))
    want = jdec.detect_density(jdec.segments())
    calls = tsc.nrzi_track_scan_tracks_plain.calls
    tdec = tpl.TapeDecoder(samples, tpl.DecodeOptions(**kw), device="cpu")
    got = tdec.detect_density(tdec.segments())
    assert tsc.nrzi_track_scan_tracks_plain.calls > calls
    assert got[0] == want[0] == bpi
    assert got[1] == want[1], (got, want)


@pytest.mark.parametrize("name", ["nrzi9_800", "pe9_1600"])
def test_decode_with_unknown_density(name):
    bpi, samples, kw = tape(name)
    out, stats = tpl.decode_tape(samples, tpl.DecodeOptions(**kw),
                                 device="cpu")
    std, raw = stats.pop("density")
    assert std == bpi and abs(raw - bpi) < 0.2 * bpi
    want, wstats = tpl.decode_tape(
        samples, tpl.DecodeOptions(**dict(kw, bpi=float(bpi))),
        device="cpu")
    assert out == want and out
    assert "density" not in wstats
    for k, v in wstats.items():
        np.testing.assert_equal(stats[k], v, err_msg=k)
