"""Float (CSV) tapes in the port against the JAX package, on the CPU:

- the port's read_csv and write_csv (readtape_tpu_torch.formats.csvfmt;
  read_csv through the native scanner where g++ built it, its numpy
  reader is held in tests/test_torch_csvtbin.py) against
  readtape_tpu.formats.csvfmt: the same (first time, deltat, volts) bit
  for bit from one file, and the same file from one array;
- segment.device_activity against the JAX TapeDecoder's device pass
  (segment.tape_activity, jitted): the height estimate and the per-chunk
  activity mask, exact;
- decode_tape of float32 volts (an NRZI, a PE, a GCR and a Whirlwind
  tape as the float volts of a CSV capture, maxvolts 32767) against the
  JAX decode_tape, block for block.

Tolerance: none.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from readtape_tpu.decode import pipeline as jpl
from readtape_tpu.decode import segment as jseg
from readtape_tpu.formats import csvfmt as jcsv
from readtape_tpu.formats import tbin as tb
from readtape_tpu.synth import default_spec, synthesize_tape
from readtape_tpu_torch.decode import pipeline as tpl
from readtape_tpu_torch.decode import segment as tseg
from readtape_tpu_torch.formats import csvfmt as tcsv

torch.set_num_threads(2)

HAND = ("title\nTime [s], a, b, c\n"
        "1.5e-3, -2.25E+1, +3, 0.1234567\n"
        "0.0015004,.5, -0.0, 12.75e-2\r\n"
        "0.0015008, 7, 1e2, -3.3333333, 99\n")


def _tape_volts():
    rng = np.random.default_rng(110)
    spec = default_spec(tb.MODE_GCR, pulse_width_bits=0.45, noise_rms=0.0)
    hdr, samples = synthesize_tape(spec, [("block", bytes(
        rng.integers(0, 256, 40, dtype=np.uint8))), ("tapemark",)])
    return hdr, samples.astype(np.float64) * (hdr.maxvolts / 32767.0)


@pytest.mark.parametrize("case", ["synthesized", "hand-written"])
def test_read_csv_matches_jax(case, tmp_path):
    path = str(tmp_path / "t.csv")
    if case == "synthesized":
        hdr, volts = _tape_volts()
        jcsv.write_csv(path, 0.25, hdr.tdelta_ns * 1e-9, volts)
    else:
        with open(path, "w") as f:
            f.write(HAND)
    t0, dt, v = tcsv.read_csv(path)
    j0, jdt, jv = jcsv.read_csv(path)
    assert (t0, dt) == (j0, jdt)
    assert v.dtype == jv.dtype == np.float32 and v.shape == jv.shape
    np.testing.assert_array_equal(v.view(np.int32), jv.view(np.int32))


def test_write_csv_matches_jax(tmp_path):
    hdr, volts = _tape_volts()
    for mod, name in ((tcsv, "port.csv"), (jcsv, "jax.csv")):
        mod.write_csv(str(tmp_path / name), 0.0, hdr.tdelta_ns * 1e-9, volts)
    assert ((tmp_path / "port.csv").read_bytes()
            == (tmp_path / "jax.csv").read_bytes())


@pytest.mark.parametrize("seed,maxvolts,step", [
    (0, 32767.0, 1), (1, 6.0, 3), (2, 1.248032, 2), (3, 5.0, 7)])
def test_device_activity_matches_jax(seed, maxvolts, step):
    """Random samples (volts * 32767 / maxvolts) with quiet stretches, so
    the mask has both values; maxvolts 1.248032 is one where f32 maxvolts
    / 32767 and maxvolts times the f32 reciprocal of 32767 differ."""
    rng = np.random.default_rng(seed)
    n, t = int(rng.integers(20000, 60000)), 9
    x = rng.normal(0.0, 0.01, (n, t))
    for a in rng.integers(0, n - 2000, 6):
        x[a:a + 1500] += rng.normal(0.0, rng.uniform(0.2, 3.0), (1500, t))
    x = (x * (32767.0 / maxvolts)).astype(np.float32)
    _, h, act = jseg.tape_activity(jnp.asarray(x), jnp.float32(maxvolts),
                                   step=step)
    th, tact = tseg.device_activity(torch.from_numpy(x.T.copy()), maxvolts,
                                    step)
    assert th == float(h)
    np.testing.assert_array_equal(tact, np.asarray(act))
    assert 0 < tact.sum() < len(tact)


def _float_tape(mode):
    """(header, float32 volts, option overrides): a short tape as the
    float volts of a CSV capture."""
    rng = np.random.default_rng({tb.MODE_NRZI: 21, tb.MODE_PE: 22,
                                 tb.MODE_GCR: 23, tb.MODE_WW: 24}[mode])
    spec = default_spec(mode, ibg_secs=0.003, start_gap_secs=0.003)
    if mode == tb.MODE_WW:
        items = [("block", [int(w) for w in rng.integers(0, 65536, 8)]),
                 ("tapemark",)]
        extra = dict(bpi=100, ips=30, ntrks=6, fluxdir="neg",
                     multiple_tries=False)
    else:
        items = [("block", bytes(rng.integers(0, 256, n, dtype=np.uint8)))
                 for n in ((48,) if mode == tb.MODE_PE else (120, 70))]
        items.insert(1, ("tapemark",))
        extra = dict(ntrks=9, bpi={tb.MODE_NRZI: 800, tb.MODE_PE: 1600,
                                   tb.MODE_GCR: 9042}[mode],
                     ips=25 if mode == tb.MODE_GCR else 50)
    hdr, samples = synthesize_tape(spec, items)
    volts, maxvolts = chip_smoke.as_volts(hdr, samples)
    return hdr, volts, dict(extra, maxvolts=maxvolts)


@pytest.mark.parametrize("mode", [tb.MODE_NRZI, tb.MODE_PE, tb.MODE_GCR,
                                  tb.MODE_WW])
def test_float_decode_matches_jax(mode):
    hdr, volts, extra = _float_tape(mode)
    kw = dict(mode=mode, deltat=hdr.tdelta_ns * 1e-9, **extra)
    jout, jst = jpl.decode_tape(volts, jpl.DecodeOptions(**kw))
    tout, tst = tpl.decode_tape(volts, tpl.DecodeOptions(**kw), device="cpu")
    assert [(b.kind, b.data, b.parmset, b.tries, b.errcount, b.warncount,
             b.t_start, b.t_end, b.detail) for b in tout] == [
        (b.kind, b.data, b.parmset, b.tries, b.errcount, b.warncount,
         b.t_start, b.t_end, b.detail) for b in jout]
    for k in ("peak_hist", "tried", "chosen"):
        np.testing.assert_array_equal(tst[k], jst[k], err_msg=k)
    assert [b.kind for b in tout].count("data") >= 1
    assert "tapemark" in [b.kind for b in tout]
