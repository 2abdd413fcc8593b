"""The port's Whirlwind decode_tape (readtape_tpu_torch, plain versions on
the CPU) against the JAX package's decode_tape (its XLA scans on the CPU:
run_pass_single), tape by tape: every BlockResult (kind, data, parmset,
tries, errcount, warncount, t_start, t_end, detail) and the run
statistics (peak histogram and sums, flux direction and changes, skew,
block counters).

Tolerance: none; the f32 detail field avg_bit_spacing is exact too.

The port's scan has no admission step budget (as the TPU kernel); the
JAX XLA scan has one of 3.2 steps per bit of the tape. Where that budget
does not bind (the port's tracks take no more steps than it allows, as
asserted), the port is held to the JAX package as it stands. Where it
binds -- the noisy tape's weak track, and a dense tape -- the port is held
to the JAX decode with its ww_track_scan given S + 1 steps (every step
moves a cursor forward, so that never binds); the dense tape also shows
that the unchanged XLA path loses the end of its block there.

Tapes: tests/test_ww_decode.py's five decode recipes -- basic (seed 40,
-fluxdir=neg), fluxdir auto (seed 41), -reverse (seed 42), abutting
blockmarks (seed 43) and twelve blocks with a tapemark after the sixth
(seed 77; 60 words each here, 120 there, for time) -- plus a skewed tape
decoded with -deskew (the calibration pass carries its skew and pulse
heights into the second pass) and a noisy tape (0.05 V rms numpy noise,
one weak track, -fluxdir=auto).
"""

import dataclasses

import numpy as np
import pytest
import torch

from readtape_tpu.decode import pipeline as jpl
from readtape_tpu.decode import ww as jww
from readtape_tpu.formats import tbin as tb
from readtape_tpu.synth import default_spec, synthesize_tape
from readtape_tpu_torch.decode import fused as tfu
from readtape_tpu_torch.decode import pipeline as tpl

torch.set_num_threads(2)

COUNTERS = ("nblocks", "ntapemarks", "nerrblocks", "nwarnblocks",
            "nunusable", "nmismatched", "nmidbiterr", "ncorrected",
            "ngoodmultiple", "num_flux_changes", "flux_dir_final", "skew",
            "peak_bins", "deskew_percent")


def _words(seed, n):
    rng = np.random.default_rng(seed)
    return rng, [int(w) for w in rng.integers(0, 65536, n)]


def _words_bytes(words):
    return b"".join(bytes([w >> 8, w & 0xFF]) for w in words)


def _tape(name):
    """(header, samples, option overrides, expected data blocks or None)."""
    spec = default_spec(tb.MODE_WW)
    if name == "basic":
        _, w = _words(40, 40)
        items = [("block", w), ("tapemark",), ("block", w[:8])]
        return (*synthesize_tape(spec, items), dict(fluxdir="neg"),
                [_words_bytes(w), _words_bytes(w[:8])])
    if name == "fluxdir_auto":
        _, w = _words(41, 24)
        return (*synthesize_tape(spec, [("block", w)]),
                dict(fluxdir="auto"), [_words_bytes(w)])
    if name == "reverse":
        _, w = _words(42, 16)
        return (*synthesize_tape(spec, [("block", w)]),
                dict(fluxdir="neg", reverse=True), None)
    if name == "abutting":
        _, w = _words(43, 8)
        spec = default_spec(tb.MODE_WW, ibg_secs=0.004)
        items = [("block", w), ("tapemark",), ("tapemark",), ("block", w)]
        return (*synthesize_tape(spec, items), dict(fluxdir="neg"),
                [_words_bytes(w)] * 2)
    if name == "twelve_blocks":
        rng = np.random.default_rng(77)
        items, blocks = [], []
        for i in range(12):
            w = [int(x) for x in rng.integers(0, 65536, 60)]
            items.append(("block", w))
            blocks.append(_words_bytes(w))
            if i == 5:
                items.append(("tapemark",))
        return (*synthesize_tape(spec, items), dict(fluxdir="neg"), blocks)
    if name == "deskew":
        _, w = _words(44, 32)
        spec = default_spec(tb.MODE_WW, skew_samples=(0, 4, 2, 7, 1, 3))
        items = [("block", w), ("tapemark",), ("block", w[:16])]
        return (*synthesize_tape(spec, items),
                dict(fluxdir="neg", deskew=True), None)
    # noisy: 0.05 V rms numpy noise and track 2 at x0.4
    rng, w = _words(45, 48)
    hdr, samples = synthesize_tape(spec, [("block", w), ("tapemark",),
                                          ("block", w[:24])])
    x = samples.astype(np.float64)
    x[:, 2] *= 0.4
    x += rng.normal(0.0, 0.05 / hdr.maxvolts * 32767, x.shape)
    return (hdr, np.clip(np.rint(x), -32767, 32767).astype(np.int16),
            dict(fluxdir="auto"), None)


def _options(hdr, extra):
    return dict(mode=tb.MODE_WW, ntrks=6, bpi=100, ips=30,
                deltat=hdr.tdelta_ns * 1e-9, maxvolts=hdr.maxvolts,
                ww_order="CMLcml", multiple_tries=False, **extra)


def _jax_decode(samples, kw, monkeypatch, lift_budget=False):
    """The JAX package's decode_tape; with lift_budget its XLA admission
    scan runs S + 1 steps instead of its budget, as the port's does."""
    if lift_budget:
        scan = jww.ww_track_scan

        def lifted(v, nxt, W, S, nsteps, *a, **k):
            return scan(v, nxt, W, S, S + 1, *a, **k)
        monkeypatch.setattr(jww, "ww_track_scan", lifted)
    try:
        return jpl.decode_tape(samples, jpl.DecodeOptions(**kw))
    finally:
        monkeypatch.undo()


def _port_decode(samples, kw, monkeypatch):
    """The port's decode on the CPU, and for each ww_fused_scan_plain call
    the most admission steps a track took and the XLA scan's budget."""
    steps = []
    plain = tfu.ww_fused_scan_plain

    def record(volts, **k):
        out = plain(volts, **k)
        S = volts.shape[-1]
        steps.append((int(out["trk_i"][:, tfu.WT_STEPS].max()),
                      tfu.scan_step_budget(int(S / k["spb"] * 3.2) + 64)))
        return out
    record.calls = plain.calls
    monkeypatch.setattr(tfu, "ww_fused_scan_plain", record)
    out = tpl.decode_tape(samples, tpl.DecodeOptions(**kw), device="cpu")
    monkeypatch.undo()
    return out, steps


def _assert_same(name, tout, tst, jout, jst):
    assert len(tout) == len(jout), ([b.kind for b in tout],
                                    [b.kind for b in jout])
    for i, (t, j) in enumerate(zip(tout, jout)):
        assert dataclasses.asdict(t) == dataclasses.asdict(j), \
            f"{name} block {i}"
    for k in ("peak_hist", "peak_trksums", "tried", "chosen"):
        np.testing.assert_array_equal(tst[k], jst[k], err_msg=k)
    for k in COUNTERS:
        assert tst[k] == jst[k], k


@pytest.mark.parametrize("name", ["basic", "fluxdir_auto", "reverse",
                                  "abutting", "twelve_blocks", "deskew",
                                  "noisy"])
def test_ww_decode_matches_jax(name, monkeypatch):
    hdr, samples, extra, blocks = _tape(name)
    kw = _options(hdr, extra)
    (tout, tst), steps = _port_decode(samples, kw, monkeypatch)
    # -deskew runs the calibration pass first
    assert len(steps) == (2 if extra.get("deskew") else 1)
    # the XLA scan's budget binds only on the noisy tape's weak track
    binds = name == "noisy"
    assert all((took > budget) == binds for took, budget in steps), steps
    jout, jst = _jax_decode(samples, kw, monkeypatch, lift_budget=binds)

    _assert_same(name, tout, tst, jout, jst)
    if blocks is not None:
        assert [b.data for b in tout if b.kind == "data"] == blocks
    if name == "deskew":
        assert any(tst["skew"]), "the calibration found no skew"
    if name == "noisy":
        assert any(b.errcount or b.warncount for b in tout), \
            "the noisy tape decoded without a warning"


def test_ww_dense_tape_beyond_the_xla_step_budget(monkeypatch):
    """One 152-word block filling its bucket: a clock track needs more
    steps than the XLA scan's budget. The port equals the JAX decode with
    that budget lifted and decodes the block; the unchanged JAX XLA path
    loses its end."""
    _, w = _words(46, 152)
    spec = default_spec(tb.MODE_WW, ibg_secs=0.0005, start_gap_secs=0.0005)
    hdr, samples = synthesize_tape(spec, [("block", w)])
    kw = _options(hdr, dict(fluxdir="neg"))
    (tout, tst), steps = _port_decode(samples, kw, monkeypatch)
    assert steps[0][0] > steps[0][1], steps
    _assert_same("dense", tout, tst,
                 *_jax_decode(samples, kw, monkeypatch, lift_budget=True))
    assert [(b.kind, b.data, b.errcount) for b in tout] == [
        ("data", _words_bytes(w), 0)]
    jout, _ = _jax_decode(samples, kw, monkeypatch)
    assert [b.data for b in jout if b.kind == "data"] != [_words_bytes(w)]
