"""The port's decode_tape under -zeros (readtape_tpu_torch, plain versions
on the CPU: Z1, then Z2 for GCR or B6 for NRZI's chain) against the JAX
package's decode_tape (its XLA path on the CPU), tape by tape: every
BlockResult (kind, data, parmset, tries, errcount, warncount, t_start,
t_end, detail) and the run statistics.

Tolerance: none.

Tapes: short 9-track GCR tapes with -zeros -correct (as
9trk_GCR/example2) and with -differentiate -zeros (pulses 0.45 bits wide
and no noise, as 9trk_GCR/example3), and short 9- and 7-track NRZI tapes
with -zeros (the chain of one window per block). On these synthesized
pulse tapes plain -zeros recovers no block in either package (PERF.md).
"""

import numpy as np
import pytest
import torch

from readtape_tpu.decode import pipeline as jpl
from readtape_tpu.formats import tbin as tb
from readtape_tpu.synth import default_spec, synthesize_tape
from readtape_tpu_torch.decode import slot as tsl
from readtape_tpu_torch.decode import zeros as tz
from readtape_tpu_torch.decode import pipeline as tpl

torch.set_num_threads(2)

COUNTERS = ("nblocks", "ntapemarks", "nerrblocks", "nwarnblocks",
            "nunusable", "nmismatched", "nmidbiterr", "ncorrected",
            "ngoodmultiple")

CASES = {
    "gcr -correct": (tb.MODE_GCR, {}, 109, (80, 60),
                     dict(bpi=9042, ips=25, do_correct=True)),
    "gcr -differentiate": (tb.MODE_GCR, dict(pulse_width_bits=0.45,
                                             noise_rms=0.0), 110, (90, 64),
                           dict(bpi=9042, ips=25, differentiate=True)),
    "nrzi 9trk": (tb.MODE_NRZI, {}, 5, (100, 80), dict(bpi=800, ips=50)),
    "nrzi 7trk": (tb.MODE_NRZI, dict(ntrks=7, bpi=556), 6, (60, 50),
                  dict(bpi=556, ips=50)),
}


def _tape(name):
    mode, spec_kw, seed, sizes, _ = CASES[name]
    rng = np.random.default_rng(seed)
    hi = 64 if spec_kw.get("ntrks") == 7 else 256
    items = []
    for n in sizes:
        items += [("block", bytes(rng.integers(0, hi, n, dtype=np.uint8))),
                  ("tapemark",)]
    return synthesize_tape(default_spec(mode, ibg_secs=0.003,
                                        start_gap_secs=0.003, **spec_kw),
                           items)


@pytest.mark.parametrize("name", list(CASES))
def test_zeros_decode_matches_jax(name):
    mode, _, _, _, extra = CASES[name]
    hdr, samples = _tape(name)
    kw = dict(mode=mode, ntrks=hdr.ntrks, deltat=hdr.tdelta_ns * 1e-9,
              maxvolts=hdr.maxvolts, find_zeros=True, **extra)
    jout, jst = jpl.decode_tape(samples, jpl.DecodeOptions(**kw))
    calls = (tz.zerocross_transitions_plain.calls,
             tz.gcr_zeros_scan_plain.calls, tsl.nrzi_slot_scan_plain.calls)
    tout, tst = tpl.decode_tape(samples, tpl.DecodeOptions(**kw),
                                device="cpu")
    assert tz.zerocross_transitions_plain.calls > calls[0]
    if mode == tb.MODE_GCR:
        assert tz.gcr_zeros_scan_plain.calls > calls[1]
    else:
        assert tsl.nrzi_slot_scan_plain.calls > calls[2]

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
    assert len(tout) >= 2
