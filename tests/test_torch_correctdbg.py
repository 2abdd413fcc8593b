"""NRZI -correctdbg in the port (readtape_tpu_torch, plain versions on the
CPU) against the JAX package, bit for bit. -correctdbg is -correct as the
reference's DEBUG build computes it: the parity check reads the column
of the last complete byte at slot time, not column 0. The JAX package
streams per-slot write records out of its XLA scan and replays the
parity and flip chain on the host (nrzi.correct_debug_replay); the port
runs the chain inside the slot machine (B6), where it writes its bit
buffers in place.

- the slot machine: B6's plain version with correct_debug against the
  JAX XLA scan's stream_writes records replayed by correct_debug_replay,
  on tests/test_torch_slot.py's one-block buffers, on its -correct
  buffers (a first-frame transition dropped: the release check flips it
  back, the DEBUG one does not) and on the one-block buffers with a
  transition dropped mid-block and its track's gain raised (the DEBUG
  check flips it back, the release one does not);
- decode_tape on tests/test_cli_oracle.py's -correctdbg recipe (0.04 V
  noise, 8% amplitude jitter, three 150-byte blocks, seed 67), and on a
  tape where -correctdbg and -correct differ: the same recipe without
  amplitude jitter, one data bit of track 4 flipped in frame 90 of every
  block (the CRC and LRC written for the true data), and from a fifth of
  each block on track 4 at 0.4 and the other tracks at 1.3 times their
  amplitude, so that track 4's AGC gain reaches twice the others': the
  DEBUG check corrects the bit, so each block decodes to its data, while
  the release check never reads that column. Every block, parmset, try
  count, correction count and faked-track mask, and the run statistics;
- every parmset's results on every segment of both tapes, not only the
  winners: the JAX package's _nrzi_correctdbg_segment against the port's
  segment batch. On the recipe one lane's avg_bit_spacing shows which
  fused multiply-add XLA forms for the exponential clock in these 8-
  parmset programs: fma(a, delta, (1 - a) * avg), as in the peak path
  (scripts/probe_adjskew_contraction.py);
- both command lines on the second tape: every output file, the "wrote
  block ... parmset" lines of the .log included;
- the precedence: under -zeros, and on GCR tapes, -correctdbg is
  -correct.

The JAX reference decodes run once per module (a fixture). Tolerance:
none.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import readtape_tpu.synth.synthesize as jsyn
from readtape_tpu.decode import nrzi as jnrzi
from readtape_tpu.decode import pipeline as jpl
from readtape_tpu.formats import tbin as tb
from readtape_tpu.synth import default_spec, synthesize_tape
from readtape_tpu_torch.decode import fused as tfu
from readtape_tpu_torch.decode import pipeline as tpl
from readtape_tpu_torch.decode import slot as tsl

from test_torch_adjskew import _gcr_tape, _zeros_tape
from test_torch_cli import _run_both, _same_outputs
from test_torch_pipeline import COUNTERS, opts_for
from test_torch_slot import STATE, slot_case

torch.set_num_threads(2)

DBG = dict(do_correct=True, do_correct_debug=True)


def _restack(fin, trans):
    def stack(k, dt):
        return torch.from_numpy(np.stack([tr[k] for tr in trans])[None]
                                .astype(dt))
    return dict(fin, tr_s=stack("tr_s", np.int32),
                tr_t=stack("tr_t", np.float32),
                tr_agc=stack("tr_agc", np.float32),
                n_admitted=stack("counts", np.int32))


def drop_mid_bit(fin, trans, spb, frame=40):
    """slot_case's buffers with, for every parmset, one track's transition
    in the block's frame `frame` removed and that track's AGC gain at 5.0,
    more than twice the AGC's cap of 2 that bounds the others'."""
    trans = [{k: v.copy() for k, v in tr.items()} for tr in trans]
    for tr in trans:
        s, t, agc, n = tr["tr_s"], tr["tr_t"], tr["tr_agc"], tr["counts"]
        t0 = t[np.argmin(s[:, 0]), 0]
        want = t0 + frame * spb
        k, j = next((k, j) for k in range(len(n)) for j in range(n[k])
                    if abs(t[k, j] - want) < spb / 2)
        for buf, fill in ((s, 2 ** 30), (t, 0.0), (agc, 1.0)):
            buf[k, j:-1] = buf[k, j + 1:].copy()
            buf[k, -1] = fill
        n[k] -= 1
        agc[k, :n[k]] = 5.0
    return _restack(fin, trans), trans


@functools.lru_cache(maxsize=None)
def _jax_slot(S, maxb, max_slots):
    """nrzi.nrzi_slot_scan streaming its write records (do_correct off),
    jitted once for every parmset of a case (the knobs are traced)."""
    def run(ts, tt, ta, cnt, spb, cw, ca, padj, mb):
        return jnrzi.nrzi_slot_scan(
            ts, tt, ta, cnt, S, spb, cw, ca, padj, mb, jnp.int32(1), False,
            maxb, max_slots, jnp.float32(0.0), jnp.float32(1.0),
            stream_writes=True)
    return jax.jit(run)


def jax_debug_slot(tr, p, kw):
    """The JAX package's DEBUG -correct on one lane: the XLA scan with
    stream_writes, then the host replay."""
    T = tr["tr_s"].shape[0]
    st = _jax_slot(kw["S"], kw["maxb"], kw["max_slots"])(
        *(jnp.asarray(tr[k]) for k in ("tr_s", "tr_t", "tr_agc", "counts")),
        jnp.float32(kw["spb"]), jnp.int32(p.clk_window),
        jnp.float32(p.clk_alpha), jnp.float32(p.pulse_adj),
        jnp.float32(p.midbit))
    st = jax.tree.map(np.asarray, st)
    st["bits"], st["corrected_bits"], st["faked_tracks"] = \
        jnrzi.correct_debug_replay(st["rec_wr"].astype(np.int32),
                                   st["rec_lcb"], st["rec_agc"],
                                   st["rec_have"], T, kw["maxb"], 1)
    return st


@pytest.mark.parametrize("name", ["1blk", "correct", "middrop"])
def test_slot_debug_correct_matches_jax_replay(name):
    fin, pa, kw, trans, sets = slot_case("1blk" if name == "middrop"
                                         else name)
    if name == "middrop":
        fin, trans = drop_mid_bit(fin, trans, kw["spb"])
    out = tsl.nrzi_slot_scan(fin, pa, **dict(kw, do_correct=False,
                                             correct_debug=True))
    st = {k: x.numpy() for k, x in tfu.fused_state(out).items()}
    for pi, (p, tr) in enumerate(zip(sets, trans)):
        r = jax_debug_slot(tr, p, kw)
        for k in STATE:
            np.testing.assert_array_equal(st[k][0, pi], r[k],
                                          err_msg=f"{name} parmset {pi} {k}")
    release = tfu.fused_state(tsl.nrzi_slot_scan(
        fin, pa, **dict(kw, do_correct=True)))["corrected_bits"].numpy()
    corr = st["corrected_bits"]
    if name == "middrop":     # the DEBUG check flips it, the release not
        assert (corr > 0).all() and (release == 0).all()
        assert (st["faked_tracks"] > 0).all()
    if name == "correct":     # the release check flips it, the DEBUG not
        assert (corr == 0).all() and (release > 0).all()


def oracle_tape():
    """tests/test_cli_oracle.py's -correctdbg recipe: (truth, hdr,
    samples)."""
    rng = np.random.default_rng(67)
    truth = [bytes(rng.integers(0, 256, 150, dtype=np.uint8))
             for _ in range(3)]
    spec = default_spec(tb.MODE_NRZI, noise_rms=0.04, amp_jitter=0.08)
    hdr, samples = synthesize_tape(spec, [("block", b) for b in truth])
    return truth, hdr, samples


def flipped_bit_tape(flip=90, trk=4, weak=0.4, strong=1.3):
    """The tape where -correctdbg and -correct differ (module docstring):
    (truth, hdr, samples)."""
    rng = np.random.default_rng(67)
    truth = [bytes(rng.integers(0, 256, 150, dtype=np.uint8))
             for _ in range(3)]
    frames = jsyn.nrzi_block_frames

    def flipped(data, spec):
        fr = list(frames(data, spec))
        fr[flip] ^= 1 << (spec.ntrks - 1 - trk)
        return fr
    jsyn.nrzi_block_frames = flipped
    try:
        hdr, samples = synthesize_tape(
            default_spec(tb.MODE_NRZI, noise_rms=0.01, seed=67),
            [("block", b) for b in truth])
    finally:
        jsyn.nrzi_block_frames = frames
    x = samples.astype(np.float64)
    active = np.nonzero(np.abs(x).max(axis=1) > 0.3 * np.abs(x).max())[0]
    for blk in np.split(active, np.nonzero(np.diff(active) > 1000)[0] + 1):
        a, b = int(blk[0] + (blk[-1] - blk[0]) * 0.2), int(blk[-1]) + 40
        x[a:b] *= strong
        x[a:b, trk] *= weak / strong
    return truth, hdr, np.clip(np.rint(x), -32767, 32767).astype(np.int16)


@pytest.fixture(scope="module")
def jax_decodes():
    out = {}
    for name, make in (("oracle", oracle_tape), ("flipped", flipped_bit_tape)):
        truth, hdr, samples = make()
        kw = opts_for(hdr, **DBG)
        out[name] = (truth, hdr, samples, kw,
                     jpl.decode_tape(samples, jpl.DecodeOptions(**kw)))
    return out


def compare(tout, tst, jout, jst):
    assert [(b.kind, b.data, b.parmset, b.tries, b.errcount, b.warncount,
             b.t_start, b.t_end) for b in tout] == \
        [(b.kind, b.data, b.parmset, b.tries, b.errcount, b.warncount,
          b.t_start, b.t_end) for b in jout]
    for i, (t, j) in enumerate(zip(tout, jout)):
        assert t.detail == j.detail, f"block {i}"
    for k in ("peak_hist", "peak_trksums", "tried", "chosen"):
        np.testing.assert_array_equal(tst[k], jst[k], err_msg=k)
    for k in COUNTERS + ("skew", "deskew_percent", "peak_bins"):
        assert tst[k] == jst[k], k


@pytest.mark.parametrize("name", ["oracle", "flipped"])
def test_decode_tape_correctdbg(jax_decodes, name, monkeypatch):
    truth, hdr, samples, kw, (jout, jst) = jax_decodes[name]
    seen = []
    orig = tsl.nrzi_slot_scan_plain

    def spy(fin, pa, **k):
        seen.append((fin["tr_s"].shape[:2], k["correct_debug"]))
        return orig(fin, pa, **k)
    spy.calls = 0
    monkeypatch.setattr(tsl, "nrzi_slot_scan_plain", spy)
    tout, tst = tpl.decode_tape(samples, tpl.DecodeOptions(**kw),
                                device="cpu")
    monkeypatch.undo()
    # every segment with all 8 parmsets, B6 in the DEBUG mode
    assert seen and all(P == 8 and dbg for (_, P), dbg in seen)
    compare(tout, tst, jout, jst)
    assert [b.data for b in tout] == truth
    if name == "flipped":
        assert all(b.detail["corrected_bits"] == 1 and
                   b.detail["faked_tracks"] == 1 << (8 - 4) for b in tout)
        release, _ = tpl.decode_tape(
            samples, tpl.DecodeOptions(**dict(kw, do_correct_debug=False)),
            device="cpu")
        assert all(b.detail["corrected_bits"] == 0 and b.errcount > 0
                   for b in release)


LANE_FIELDS = ("blktype", "minbits", "maxbits", "errcount", "warncount",
               "corrected_bits", "faked_tracks", "avg_bit_spacing", "hist",
               "trksums", "end_s", "unconsumed", "alltrk_max_agc",
               "alltrk_min_agc", "frames")


@pytest.mark.parametrize("name", ["oracle", "flipped"])
def test_segment_lanes_correctdbg(jax_decodes, name):
    _, hdr, samples, kw, _ = jax_decodes[name]
    jdec = jpl.TapeDecoder(samples, jpl.DecodeOptions(**kw))
    tdec = tpl.TapeDecoder(samples, tpl.DecodeOptions(**kw), device="cpu")
    segs = tdec.segments()
    assert segs == jdec.segments()
    S = max(tpl.seg.bucket_length(b - max(a - tpl.SEG_WARMUP, 0))
            for a, b in segs)
    for a, b in segs:
        want = jpl._nrzi_correctdbg_segment(jdec, a, b, S)
        got = tdec.decode_segment_batch([(a, b)], bucket=S, correctdbg=True)
        for k in LANE_FIELDS:
            np.testing.assert_array_equal(got[k][0], np.asarray(want[k]),
                                          err_msg=f"segment {a} {k}")


def test_cli_correctdbg(jax_decodes, tmp_path, monkeypatch, capsys):
    _, hdr, samples, _, _ = jax_decodes["flipped"]
    rcs = _run_both(tmp_path, monkeypatch, (hdr, samples),
                    [["-v", "-m", "-nrzi", "-correctdbg", "-tap", "t"]])
    assert rcs == [[0], [0]]
    names = _same_outputs(tmp_path, inputs=["t.tbin"])
    assert {"t.tap", "t.log"} <= set(names)
    log = (tmp_path / "t" / "t.log").read_text().splitlines()
    wrote = [ln for ln in log if "wrote block" in ln]
    assert len(wrote) == 3 and all("parmset" in ln for ln in wrote)


@pytest.mark.parametrize("case", ["nrzi -zeros", "gcr"])
def test_correctdbg_is_correct(case):
    """The JAX package's precedence (pipeline.py:2712-2713): the DEBUG
    check is NRZI's and not -zeros'; elsewhere -correctdbg decodes as
    -correct."""
    if case == "gcr":
        hdr, samples = _gcr_tape()
        kw = dict(mode=tb.MODE_GCR, ntrks=9, bpi=9042, ips=25,
                  deltat=hdr.tdelta_ns * 1e-9, maxvolts=hdr.maxvolts,
                  do_correct=True)
    else:
        hdr, samples = _zeros_tape()
        kw = opts_for(hdr, find_zeros=True, do_correct=True)
    opts = tpl.DecodeOptions(**kw)
    want = tpl.decode_tape(samples, opts, device="cpu")
    got = tpl.decode_tape(samples, dataclasses.replace(
        opts, do_correct_debug=True), device="cpu")
    assert got[0] == want[0] and got[1]["tried"].tolist() == \
        want[1]["tried"].tolist()
