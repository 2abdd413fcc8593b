"""Tests that need an NVIDIA card (marker `cuda`; they skip elsewhere).
Each CUDA kernel must equal its plain version on the card (the -zeros
kernels Z1 and Z2 too, and B6 in the modes of -adjskew and -correctdbg),
an NRZI (fused and tiered, and under -adjskew and -correctdbg), PE, GCR
or Whirlwind decode on the card must equal the plain decode on the CPU
block for block, the Whirlwind bench tape must decode on the card to
its ground truth, and -trace's lanes from the kernels' record modes on
the card must equal the plain versions' on the CPU; the int16 activity
scan on the card must equal its plain version, and the height estimate
and mask of a capture the host scan's. Imports no JAX and nothing of
the JAX package (the port carries its own synthesizer and formats), so
the card's machine runs it without the JAX package's test
configuration:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import chip_smoke
from readtape_tpu_torch import kernels
from readtape_tpu_torch.decode import fused as tfu
from readtape_tpu_torch.decode import pipeline as tpl
from readtape_tpu_torch import telemetry
from readtape_tpu_torch.decode import scan as tsc
from readtape_tpu_torch.decode import segment as tseg
from readtape_tpu_torch.decode import slot as tsl
from readtape_tpu_torch.decode import zeros as tz
from readtape_tpu_torch.formats import tbin as tb
from readtape_tpu_torch.synth import default_spec, synthesize_tape

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("T,correct", [(9, False), (9, True), (7, False)])
def test_kernel_equals_plain(card, T, correct):
    volts, seg_lens, leads, pa, kw = chip_smoke.kernel_inputs(
        T, 8192, correct, seed=11)
    launches = tfu.nrzi_fused_scan.launches
    got = tfu.nrzi_fused_scan(volts, seg_lens, leads, pa, **kw)
    assert tfu.nrzi_fused_scan.launches == launches + 1
    want = tfu.nrzi_fused_scan_plain(volts, seg_lens, leads, pa, **kw)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_decode_on_card_equals_cpu(card):
    rng = np.random.default_rng(9)
    blocks = [bytes(rng.integers(0, 256, 300, dtype=np.uint8))
              for _ in range(3)]
    spec = default_spec(tb.MODE_NRZI, noise_rms=0.03, amp_jitter=0.3,
                        time_jitter_bits=0.1, ibg_secs=0.004,
                        start_gap_secs=0.004, seed=9)
    hdr, samples = synthesize_tape(
        spec, [("block", b) for b in blocks] + [("tapemark",)])
    opts = tpl.DecodeOptions(mode=tb.MODE_NRZI, ntrks=9, bpi=800, ips=50,
                             deltat=hdr.tdelta_ns * 1e-9,
                             maxvolts=hdr.maxvolts)
    plain = tfu.nrzi_fused_scan_plain.calls
    out_gpu, st_gpu = tpl.decode_tape(samples, opts, device="cuda")
    assert tfu.nrzi_fused_scan_plain.calls == plain
    out_cpu, st_cpu = tpl.decode_tape(samples, opts, device="cpu")
    assert out_gpu == out_cpu
    for k in ("peak_hist", "tried", "chosen"):
        np.testing.assert_array_equal(st_gpu[k], st_cpu[k])


@pytest.mark.parametrize("T,correct", [(9, False), (9, True), (7, False)])
def test_tiered_kernels_equal_plain(card, T, correct):
    """B5a (8 parmsets, three widths), B5b (parmset 0) and B6 over B5a's
    buffers, each against its plain version."""
    volts, seg_lens, leads, pa, kw = chip_smoke.kernel_inputs(
        T, 8192, False, seed=11)
    for nparms, fn, plain in ((8, tsc.nrzi_track_scan,
                               tsc.nrzi_track_scan_plain),
                              (1, tsc.nrzi_track_scan_tracks,
                               tsc.nrzi_track_scan_tracks_plain)):
        feat, nxt, pa_n, skw = chip_smoke.tiered_inputs(
            volts, seg_lens, leads, pa, kw, nparms)
        launches = fn.launches
        got = fn(feat, nxt, pa_n, **skw)
        assert fn.launches == launches + 1
        want = plain(feat, nxt, pa_n, **skw)
        for k in want:
            assert torch.equal(got[k], want[k]), k
        if nparms == 8:
            fin, pa8 = got, pa_n
    skw = chip_smoke.slot_kwargs(kw, volts.shape[-1], correct)
    launches = tsl.nrzi_slot_scan.launches
    got = tsl.nrzi_slot_scan(fin, pa8, **skw)
    assert tsl.nrzi_slot_scan.launches == launches + 1
    want = tsl.nrzi_slot_scan_plain(fin, pa8, **skw)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("mode", ["adjskew", "correctdbg"])
def test_slot_option_modes_equal_plain(card, mode):
    """B6 over B5a's buffers (8 parmsets) with -adjskew's accumulators
    seeded non-zero, or with the DEBUG build's -correct and a mid-block
    transition dropped per lane (chip_smoke.drop_mid_bits), so that every
    such lane corrects; against its plain version."""
    volts, seg_lens, leads, pa, kw = chip_smoke.kernel_inputs(
        9, 8192, False, seed=11)
    feat, nxt, pa8, skw = chip_smoke.tiered_inputs(volts, seg_lens, leads,
                                                   pa, kw, 8)
    fin = tsc.nrzi_track_scan(feat, nxt, pa8, **skw)
    skw = chip_smoke.slot_kwargs(kw, volts.shape[-1], False)
    B, P, T, _ = fin["tr_s"].shape
    rng = np.random.default_rng(13)
    if mode == "adjskew":
        skw.update(clk_avg_fma=True, adj_init=tuple(
            torch.as_tensor(x, device="cuda") for x in (
                rng.integers(1, 60, (B, P, T)).astype(np.float32),
                rng.uniform(-3, 3, (B, P, T)).astype(np.float32))))
    else:
        fin, dropped = chip_smoke.drop_mid_bits(fin, kw["spb"])
        skw.update(correct_debug=True)
    launches = tsl.nrzi_slot_scan.launches
    got = tsl.nrzi_slot_scan(fin, pa8, **skw)
    assert tsl.nrzi_slot_scan.launches == launches + 1
    want = tsl.nrzi_slot_scan_plain(fin, pa8, **skw)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    if mode == "correctdbg":
        corrected = want["lane_i"][..., tfu.LI_CORR].cpu() > 0
        assert dropped.any() and corrected[dropped].all()


@pytest.mark.parametrize("option", ["-adjskew", "-correctdbg"])
def test_option_decode_on_card_equals_cpu(card, option):
    """-adjskew on its oracle recipe, -correctdbg on the tape where it
    corrects a bit that -correct does not: blocks, reports and final skew
    equal on the card and on the CPU, and the ground truth."""
    if option == "-adjskew":
        blocks, hdr, samples = chip_smoke.adjskew_tape()
    else:
        blocks, hdr, samples = chip_smoke.flipped_bit_tape()
    over = {o: kw for o, kw, _ in chip_smoke.OPTION_PATHS}[option]
    opts = chip_smoke.tape_options(hdr, tb.MODE_NRZI, 800, **over)
    launches = tsl.nrzi_slot_scan.launches
    out_gpu, st_gpu = tpl.decode_tape(samples, opts)
    assert tsl.nrzi_slot_scan.launches > launches
    out_cpu, st_cpu = tpl.decode_tape(samples, opts, device="cpu")
    assert out_gpu == out_cpu and st_gpu["skew"] == st_cpu["skew"]
    assert [b.data for b in out_gpu if b.kind == "data"] == blocks
    for k in ("peak_hist", "tried", "chosen"):
        np.testing.assert_array_equal(st_gpu[k], st_cpu[k])


def test_tiered_decode_on_card_equals_cpu(card):
    """The noisy tape of the 8-parmset retry through kernel_path="tiered"."""
    hdr, samples = chip_smoke.nrzi_noisy_tape()
    opts = chip_smoke.tape_options(hdr, tb.MODE_NRZI, 800)
    launches = tsc.nrzi_track_scan.launches
    out_gpu, st_gpu = tpl.decode_tape(samples, opts, kernel_path="tiered")
    assert tsc.nrzi_track_scan.launches > launches
    out_cpu, st_cpu = tpl.decode_tape(samples, opts, device="cpu",
                                      kernel_path="tiered")
    assert out_gpu == out_cpu
    for k in ("peak_hist", "tried", "chosen"):
        np.testing.assert_array_equal(st_gpu[k], st_cpu[k])


@pytest.mark.parametrize("nparms", [1, 8])
def test_pe_kernel_equals_plain(card, nparms):
    volts, seg_lens, leads, pa, kw = chip_smoke.pe_kernel_inputs(
        16384, seed=11, nparms=nparms)
    launches = tfu.pe_fused_scan.launches
    got = tfu.pe_fused_scan(volts, seg_lens, leads, pa, **kw)
    assert tfu.pe_fused_scan.launches == launches + 1
    want = tfu.pe_fused_scan_plain(volts, seg_lens, leads, pa, **kw)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_pe_decode_on_card_equals_cpu(card):
    hdr, samples = chip_smoke.pe_short_gap_tape()
    opts = chip_smoke.tape_options(hdr, tb.MODE_PE, 1600)
    plain = tfu.pe_fused_scan_plain.calls
    out_gpu, st_gpu = tpl.decode_tape(samples, opts, device="cuda")
    assert tfu.pe_fused_scan_plain.calls == plain
    out_cpu, st_cpu = tpl.decode_tape(samples, opts, device="cpu")
    assert out_gpu == out_cpu
    for k in ("peak_hist", "tried", "chosen"):
        np.testing.assert_array_equal(st_gpu[k], st_cpu[k])


def test_gcr_kernel_equals_plain(card):
    volts, seg_lens, leads, pa, kw = chip_smoke.gcr_kernel_inputs(
        16384, seed=11)
    launches = tfu.gcr_fused_scan.launches
    got = tfu.gcr_fused_scan(volts, seg_lens, leads, pa, **kw)
    assert tfu.gcr_fused_scan.launches == launches + 1
    want = tfu.gcr_fused_scan_plain(volts, seg_lens, leads, pa, **kw)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_gcr_decode_on_card_equals_cpu(card):
    hdr, samples = chip_smoke.gcr_short_gap_tape()
    opts = chip_smoke.tape_options(hdr, tb.MODE_GCR, 9042, 25)
    opts.do_correct = True
    plain = tfu.gcr_fused_scan_plain.calls
    out_gpu, st_gpu = tpl.decode_tape(samples, opts, device="cuda")
    assert tfu.gcr_fused_scan_plain.calls == plain
    out_cpu, st_cpu = tpl.decode_tape(samples, opts, device="cpu")
    assert out_gpu == out_cpu
    for k in ("peak_hist", "tried", "chosen"):
        np.testing.assert_array_equal(st_gpu[k], st_cpu[k])


@pytest.mark.parametrize("span", [None, 1 << 14])
def test_ww_kernel_equals_plain(card, span):
    _, hdr, samples = chip_smoke.ww_tape(sizes=(24, 40, 16))
    (volts,), kw = chip_smoke.first_call(
        kernels, "ww_fused", samples,
        chip_smoke.ww_options(hdr, "auto"))
    if span is not None:
        kw = dict(kw, span=span)
    launches = tfu.ww_fused_scan.launches
    got = tfu.ww_fused_scan(volts, **kw)
    assert tfu.ww_fused_scan.launches == launches + 1
    want = tfu.ww_fused_scan_plain(volts, **kw)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_ww_bench_tape_on_card(card):
    blocks, hdr, samples = chip_smoke.ww_bench_tape()
    plain = tfu.ww_fused_scan_plain.calls
    launches = tfu.ww_fused_scan.launches
    out, stats = tpl.decode_tape(samples, chip_smoke.ww_options(hdr))
    assert tfu.ww_fused_scan_plain.calls == plain
    assert tfu.ww_fused_scan.launches == launches + 1
    assert [b.data for b in out if b.kind == "data"] == blocks
    assert stats["nerrblocks"] == 0 and stats["ntapemarks"] == 0


@pytest.mark.parametrize("differentiated,cap", [(False, None), (True, None),
                                                (False, 150)])
def test_zerocross_kernel_equals_plain(card, differentiated, cap):
    """Z1, plain and differentiated, and with a list short enough that
    every segment overflows it."""
    volts, seg_lens, leads, _, kw, _ = chip_smoke.zeros_inputs(
        8192, 11, differentiated)
    if cap is not None:
        kw = dict(kw, cap=cap)
    launches = tz.zerocross_transitions.launches
    got = tz.zerocross_transitions(volts, seg_lens, leads, **kw)
    assert tz.zerocross_transitions.launches == launches + 1
    want = tz.zerocross_transitions_plain(volts, seg_lens, leads, **kw)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert bool(want["overflow"].all()) == (cap is not None)


def test_gcr_zeros_kernel_equals_plain(card):
    """Z2 over Z1's lists, the 5 GCR parmsets."""
    volts, seg_lens, leads, pa, zkw, kw = chip_smoke.zeros_inputs(
        8192, 11, False)
    trans = tz.zerocross_transitions_plain(volts, seg_lens, leads, **zkw)
    launches = tz.gcr_zeros_scan.launches
    got = tz.gcr_zeros_scan(trans, pa, **kw)
    assert tz.gcr_zeros_scan.launches == launches + 1
    want = tz.gcr_zeros_scan_plain(trans, pa, **kw)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("mode", ["nrzi", "pe", "gcr", "ww"])
def test_trace_on_card_equals_cpu(card, mode):
    """-trace's lanes from the kernels' record modes on the card (B5b and
    B6, B2, B3, B4) equal the plain versions' on the CPU, and the card's
    run launched each kernel once and no plain version."""
    m = {"nrzi": tb.MODE_NRZI, "pe": tb.MODE_PE, "gcr": tb.MODE_GCR,
         "ww": tb.MODE_WW}[mode]
    rng = np.random.default_rng(15)
    if m == tb.MODE_WW:
        data = [int(w) for w in rng.integers(0, 65536, 24)]
    else:
        data = rng.integers(0, 256, 60, dtype=np.uint8).tobytes()
    hdr, samples = synthesize_tape(default_spec(m), [("block", data)])
    bpi = {tb.MODE_NRZI: 800, tb.MODE_PE: 1600, tb.MODE_GCR: 9042,
           tb.MODE_WW: 100}[m]
    opts = chip_smoke.tape_options(hdr, m, bpi, ips=hdr.ips)
    dt = hdr.tdelta_ns * 1e-9
    a, b = ((int(0.0035 / dt), int(0.0095 / dt)) if m != tb.MODE_NRZI
            else (0, 10000))
    b = min(b, len(samples))
    kern = {"nrzi": ("nrzi_track_scan_tracks", "nrzi_slot_scan"),
            "pe": ("pe_fused_scan",), "gcr": ("gcr_fused_scan",),
            "ww": ("ww_fused_scan",)}[mode]
    got = {}
    for dev in ("cuda", "cpu"):
        chip_smoke.reset_counts()
        if m == tb.MODE_WW:
            got[dev] = tpl.ww_trace_lanes(samples, opts, a, b, device=dev)
        else:
            got[dev] = tpl.TapeDecoder(samples, opts,
                                       device=dev).trace_lanes(a, b)
        if dev == "cuda":
            c = chip_smoke.counts()
            assert all(c[k] == (1, 0) for k in kern), c
            assert not any(n for _, n in c.values()), c
    np.testing.assert_array_equal(got["cuda"][0], got["cpu"][0])
    assert got["cuda"][1] == got["cpu"][1]
    assert sum(len(x) for x in got["cpu"][1]["peak"]) > 100


@pytest.mark.parametrize("n,t,step", [(16 * 4099 + 7, 9, 1),
                                      (16 * 2000 + 15, 7, 3),
                                      (16 * 3000, 6, 20), (5, 9, 1),
                                      (300_001, 9, 2)])
def test_activity_scan_equals_plain(card, n, t, step):
    x = chip_smoke.activity_capture(n, t, seed=n)
    launches = tseg.activity_scan.launches
    got = tseg.activity_scan(torch.from_numpy(x).to(card), step)
    assert tseg.activity_scan.launches == launches + 1
    want = tseg.activity_scan_plain(torch.from_numpy(x), step)
    assert torch.equal(got.cpu(), want)


def test_tape_activity_on_card_equals_host(card):
    """One synthesized capture: the decoder's activity scan on the card
    (one launch, no plain version, counted activity.card) gives
    host_activity's height estimate and mask."""
    rng = np.random.default_rng(21)
    blocks = [bytes(rng.integers(0, 256, 400, dtype=np.uint8))
              for _ in range(4)]
    spec = default_spec(tb.MODE_NRZI, noise_rms=0.02, seed=21)
    hdr, samples = synthesize_tape(
        spec, [("block", b) for b in blocks] + [("tapemark",)])
    opts = tpl.DecodeOptions(mode=tb.MODE_NRZI, ntrks=9, bpi=800, ips=50,
                             deltat=hdr.tdelta_ns * 1e-9,
                             maxvolts=hdr.maxvolts)
    plain = tseg.activity_scan_plain.calls
    with telemetry.recording() as rec:
        dec = tpl.TapeDecoder(samples, opts, device="cuda")
    assert tseg.activity_scan_plain.calls == plain
    assert rec.counters["activity.card"] == 1
    assert rec.counters["launches.activity_scan"] == 1
    assert rec.counters["host_waits.activity"] == 1
    h_est, act = tseg.host_activity(samples, hdr.maxvolts)
    assert dec.h_est == h_est
    np.testing.assert_array_equal(dec._act, act)
