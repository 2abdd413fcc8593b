"""The port's decode_tape (readtape_tpu_torch, plain versions on the CPU)
against the JAX package's decode_tape (its XLA scans on the CPU), tape by
tape: every BlockResult (kind, data, parmset, tries, errcount, warncount,
t_start, t_end, detail) and the run statistics (peak histogram, tried,
chosen, skew and the block counters).

Tolerance: none; the f32 detail fields (avg_bit_spacing, the AGC
extrema) are exact too. Both packages also agree on whether an admission
scan ran out of its step budget (the JAX XLA scan's cap, which the port
keeps): only the noise-burst tape reaches it.

The tapes here share one bucket (16384 samples) so JAX compiles little;
test_torch_pipeline_more.py holds the rest.
"""

import numpy as np
import torch

from readtape_tpu.decode import pipeline as jpl
from readtape_tpu.decode import trackscan as jts
from readtape_tpu.formats import tbin as tb
from readtape_tpu.synth import default_spec, synthesize_tape
from readtape_tpu_torch.decode import fused as tfu
from readtape_tpu_torch.decode import pipeline as tpl
from readtape_tpu_torch.decode import slot as tsl

torch.set_num_threads(2)

COUNTERS = ("nblocks", "ntapemarks", "nerrblocks", "nwarnblocks",
            "nunusable", "nmismatched", "nmidbiterr", "ncorrected",
            "ngoodmultiple")


def opts_for(hdr, **kw):
    return dict(mode=tb.MODE_NRZI, ntrks=hdr.ntrks, bpi=800, ips=50,
                deltat=hdr.tdelta_ns * 1e-9, maxvolts=hdr.maxvolts, **kw)


def _spy_budget(monkeypatch):
    """Record, per decode batch of either package, whether an admission
    scan stopped at its step budget (event_overflow)."""
    seen = {"jax": [], "port": []}
    jorig = jpl.TapeDecoder.decode_segment_batch
    torig = tpl.TapeDecoder.dispatch_segment_batch

    def jrecord(res):
        seen["jax"].append(bool(np.any(np.asarray(res["event_overflow"]))))
        return res

    def jspy(self, *a, **kw):
        r = jorig(self, *a, **kw)
        return (lambda: jrecord(r())) if callable(r) else jrecord(r)

    def tspy(self, *a, **kw):
        r = torig(self, *a, **kw)
        seen["port"].append(bool(r["event_overflow"].any()))
        return r

    monkeypatch.setattr(jpl.TapeDecoder, "decode_segment_batch", jspy)
    monkeypatch.setattr(tpl.TapeDecoder, "dispatch_segment_batch", tspy)
    return seen


def compare_decodes(samples, opt_kw, monkeypatch, kernel_path="fused",
                    lift_budget=False):
    """Decode with both packages and assert they agree; returns the
    port's (blocks, stats) and whether a scan reached its step budget.
    kernel_path: the port's NRZI kernel path. lift_budget: the JAX
    package's XLA admission scans run S + 1 steps instead of their
    budget, as the port's tiered path does."""
    seen = _spy_budget(monkeypatch)
    scan, lifted_calls = jts.nrzi_track_scan_pre, []

    def lifted(ft, nx, W, S, nsteps, *a, **k):
        lifted_calls.append(nsteps)
        return scan(ft, nx, W, S, S + 1, *a, **k)
    if lift_budget:
        # the batch functions are cached per configuration: trace anew
        # with the lifted scan, and drop those traces afterwards
        monkeypatch.setattr(jts, "nrzi_track_scan_pre", lifted)
        jpl._batched_fn.cache_clear()
    try:
        jout, jst = jpl.decode_tape(samples, jpl.DecodeOptions(**opt_kw))
    finally:
        if lift_budget:
            monkeypatch.setattr(jts, "nrzi_track_scan_pre", scan)
            jpl._batched_fn.cache_clear()
    assert bool(lifted_calls) == lift_budget
    plain = (tfu.nrzi_fused_scan_plain if kernel_path == "fused"
             else tsl.nrzi_slot_scan_plain)
    calls = plain.calls
    tout, tst = tpl.decode_tape(samples, tpl.DecodeOptions(**opt_kw),
                                device="cpu", kernel_path=kernel_path)
    assert plain.calls > calls
    assert len(tout) == len(jout), ([b.kind for b in tout],
                                    [b.kind for b in jout])
    for i, (t, j) in enumerate(zip(tout, jout)):
        msg = f"block {i}"
        assert (t.kind, t.data, t.parmset, t.tries, t.errcount,
                t.warncount) == (j.kind, j.data, j.parmset, j.tries,
                                 j.errcount, j.warncount), msg
        assert (t.t_start, t.t_end) == (j.t_start, j.t_end), msg
        assert t.detail == j.detail, msg
    for k in ("peak_hist", "peak_trksums", "tried", "chosen"):
        np.testing.assert_array_equal(tst[k], jst[k], err_msg=k)
    for k in COUNTERS + ("skew", "deskew_percent", "peak_bins"):
        assert tst[k] == jst[k], k
    assert seen["jax"] and seen["port"]
    assert any(seen["port"]) == any(seen["jax"])
    return tout, tst, any(seen["port"])


def test_three_blocks_and_tapemark(monkeypatch):
    rng = np.random.default_rng(7)
    blocks = [bytes(rng.integers(0, 256, 420, dtype=np.uint8))
              for _ in range(3)]
    spec = default_spec(tb.MODE_NRZI, ibg_secs=0.004, start_gap_secs=0.004)
    hdr, samples = synthesize_tape(
        spec, [("block", b) for b in blocks] + [("tapemark",)])
    out, stats, capped = compare_decodes(samples, opts_for(hdr), monkeypatch)
    assert [b.data for b in out if b.kind == "data"] == blocks
    assert stats["ntapemarks"] == 1 and stats["nerrblocks"] == 0
    assert not capped


def test_merged_segment_remainder_loop(monkeypatch):
    """0.8 ms gaps, shorter than the segmenter's 1.5 ms minimum: four
    blocks share one segment, and the remainder loop carves them out one
    after another."""
    rng = np.random.default_rng(83)
    blocks = [bytes(rng.integers(0, 256, 100, dtype=np.uint8))
              for _ in range(4)]
    spec = default_spec(tb.MODE_NRZI, ibg_secs=0.0008, start_gap_secs=0.004)
    hdr, samples = synthesize_tape(spec, [("block", b) for b in blocks])
    dec = tpl.TapeDecoder(samples, tpl.DecodeOptions(**opts_for(hdr)),
                          device="cpu")
    assert len(dec.segments()) == 1
    out, stats, capped = compare_decodes(samples, opts_for(hdr), monkeypatch)
    assert [b.data for b in out if b.kind == "data"] == blocks
    assert not capped


def test_noisy_tape_picks_a_later_parmset(monkeypatch):
    """Amplitude and timing jitter: blocks fail with parmset 0, the staged
    retry decodes them with all eight, and the best pick lands on other
    parmsets."""
    rng = np.random.default_rng(1)
    blocks = [bytes(rng.integers(0, 256, 420, dtype=np.uint8))
              for _ in range(3)]
    spec = default_spec(tb.MODE_NRZI, noise_rms=0.03, amp_jitter=0.3,
                        time_jitter_bits=0.1, ibg_secs=0.004,
                        start_gap_secs=0.004, seed=1)
    hdr, samples = synthesize_tape(spec, [("block", b) for b in blocks])
    out, stats, capped = compare_decodes(samples, opts_for(hdr), monkeypatch)
    assert stats["chosen"][0] == 0 and stats["chosen"][1:].sum() == 3
    assert all(b.parmset != 0 for b in out)
    assert not capped


def test_correct_option(monkeypatch):
    """-correct on a noisy tape (the release binary's column-0 flip)."""
    rng = np.random.default_rng(11)
    blocks = [bytes(rng.integers(0, 256, 420, dtype=np.uint8))
              for _ in range(2)]
    spec = default_spec(tb.MODE_NRZI, noise_rms=0.08, amp_jitter=0.1,
                        ibg_secs=0.004, start_gap_secs=0.004, seed=11)
    hdr, samples = synthesize_tape(spec, [("block", b) for b in blocks])
    _, _, capped = compare_decodes(samples, opts_for(hdr, do_correct=True),
                                   monkeypatch)
    assert not capped
