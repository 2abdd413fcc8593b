"""The PE kernel's state machine (readtape_tpu_torch/csrc/pe_core.h),
compiled for the host with g++ and driven lane by lane in the kernel's
phase order, must equal the plain PyTorch version
(fused.pe_fused_scan_plain) exactly: every integer field, every bit and
every float. This is the kernel's logic checked without a GPU; the CUDA
build itself runs only on the card (chip_smoke.py). Nothing at run time
uses this host build.

The host driver walks each track chunk by chunk, as the kernel's phase A
does, over window features it computes for each chunk with a plain loop
(the rows it did not compute hold NaN), with the kernel's chunk of 256
samples at 9 tracks and with one of 64."""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

import chip_smoke
from readtape_tpu_torch import kernels
from readtape_tpu_torch.decode import fused as tfu
from readtape_tpu_torch.decode import pipeline as tpl
from readtape_tpu_torch.formats import tbin as tb

torch.set_num_threads(2)

_DRIVER = r"""
#include <math.h>
#include <vector>
#include "pe_core.h"

// track t's walk chunk by chunk, over feature rows computed per chunk
template <class Walk>
static void walk_track(const PeArgs* a, int lane, int t, const float* v,
                       const uint32_t* tw, int W, int C, std::vector<NrziFeat>& rows,
                       const NrziFeat& poison, float* heights, float* ring) {
  const int S = a->S;
  Walk w;
  pe_walk_init(w, *a, lane, t, heights, ring);
  for (int c0 = 0; c0 < S; c0 += C) {
    const int c1 = c0 + C < S ? c0 + C : S;
    for (int i = 0; i < C; ++i) rows[i] = poison;
    nrzi_feature_rows(v, 0, S, W, tw + (c0 >> 5), c0, c1, rows.data(), 0, 1);
    if (!nrzi_walk_chunk(w, tw + (c0 >> 5), rows.data(), c0, c1, S, a->max_steps))
      break;
  }
  pe_walk_finish(w, *a, lane, t);
}

// the kernel's phase order, phase A in chunks of C samples
template <bool REC>
static void host_run(const PeArgs* a, int C) {
  const int nw = pe_nwords(*a), S = a->S;
  std::vector<NrziFeat> rows(C);
  NrziFeat poison;
  poison.wmax = poison.wmin = poison.vleft = poison.vright = NAN;
  poison.prevmax = poison.nextmax = poison.prevmin = poison.nextmin = NAN;
  poison.ltop = poison.lbot = -1000000;
  float heights[NRZI_MAX_AGC_RING], ring[NRZI_MAX_CLK_RING];
  for (int lane = 0; lane < a->B * a->P; ++lane) {
    const int b = lane / a->P, W = a->p_w[lane % a->P];
    pe_zero_lane(*a, lane, 0, 1);
    // the kernel's candidate words: one bit per lane of a warp
    uint32_t* cw = a->cand + (int64_t)lane * a->T * nw;
    for (int i = 0; i < a->T * nw; ++i) {
      uint32_t word = 0;
      for (int l = 0; l < 32; ++l)
        if (pe_cand_bit<REC>(*a, lane, i / nw, ((i % nw) << 5) + l)) word |= 1u << l;
      cw[i] = word;
    }
    for (int t = 0; t < a->T; ++t) {
      const float* v = a->volts + ((int64_t)b * a->T + t) * S;
      const uint32_t* tw = cw + (int64_t)t * nw;
      walk_track<PeWalkT<REC>>(a, lane, t, v, tw, W, C, rows, poison, heights, ring);
    }
    bool overflow, deep;
    pe_lane_flags(*a, lane, overflow, deep);
    const int tau = overflow ? PE_BIG_TAU : pe_tau_part(*a, lane, 0, 1);
    int after = a->S, race = a->S;
    for (int t = 0; t < a->T; ++t) {
      int x, y;
      pe_apply_track<REC>(*a, lane, t, tau, x, y);
      after = pe_imin(after, x);
      race = pe_imin(race, y);
    }
    pe_write_lane(*a, lane, tau, overflow, deep, after, race);
  }
}

// the record mode's instantiation, or the decode's (as the kernel picks)
extern "C" void pe_host_run(const PeArgs* a, int C) {
  if (a->dbg_f) host_run<true>(a, C); else host_run<false>(a, C);
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not available")
    d = tmp_path_factory.mktemp("pe_host")
    src = d / "driver.cpp"
    src.write_text(_DRIVER)
    so = d / "libpe_host.so"
    subprocess.run([gxx, "-O2", "-ffp-contract=off", "-std=c++17", "-shared",
                    "-fPIC", "-I", kernels.CSRC, "-o", str(so), str(src)],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    lib.pe_host_run.argtypes = [ctypes.POINTER(kernels.PeArgs), ctypes.c_int]
    lib.pe_host_run.restype = None
    return lib


def _pulse_trains(S=65536, spb=19.53125):
    """Two synthetic lanes whose tracks never all go idle. Track 0 pulses
    every 4 bits (idle between pulses), track 1 every bit; the others are
    silent. Lane 0: both run the whole window, so track 0 has more idle
    intervals than IDLE_CAP (overflow). Lane 1: track 1 stops half a bit
    before a pulse of track 0, whose ~380 intervals leave its last ones
    beyond the IDLE_ECAP candidates (tau unknown: gave up)."""
    v = np.zeros((2, 9, S), np.float32)
    x = np.arange(S, dtype=np.float64)

    def train(b, t, every, stop):
        for k, c in enumerate(np.arange(100.0, stop, every * spb)):
            v[b, t] += (2.0 if k % 2 else -2.0) * np.exp(
                -0.5 * ((x - c) / 3.0) ** 2).astype(np.float32)
    train(0, 0, 4, S - 100)
    train(0, 1, 1, S - 100)
    train(1, 0, 4, 30000)
    train(1, 1, 1, 101 + 1482 * spb)
    return torch.from_numpy(v)


def _batches(case, monkeypatch):
    """[(args, kwargs, plain outputs)] of pe_fused_scan_plain calls."""
    if case == "idle_caps":
        volts = _pulse_trains()
        _, _, _, pa, kw = chip_smoke.pe_kernel_inputs(8192, seed=5,
                                                      nparms=1, device="cpu")
        S = volts.shape[-1]
        spb = kw["spb"]
        steps = tfu.scan_step_budget(int(S / spb * 3.2) + 64)
        kw.update(maxb=int(S / spb * 1.3) + 64, K=steps, max_steps=steps)
        args = (volts, torch.full((2,), S, dtype=torch.int32),
                torch.full((2,), 64, dtype=torch.int32), pa)
        out = tfu.pe_fused_scan_plain(*args, **kw)
        lane = out["lane_i"][:, 0]
        assert (lane[:, tfu.PL_TAU] == 2 ** 30).all()
        assert (lane[:, tfu.PL_GAVEUP] == 1).all()
        return [(args, kw, out)]
    if case == "segments":
        # clean, noisy + weak track, dropout, two blocks behind a short gap
        volts, seg_lens, leads, pa, kw = chip_smoke.pe_kernel_inputs(
            16384, seed=5, nparms=3, device="cpu")
        out = tfu.pe_fused_scan_plain(volts, seg_lens, leads, pa, **kw)
        return [((volts, seg_lens, leads, pa), kw, out)]
    # every batch of a noisy short-gap decode: walk hops with their own
    # leads and lengths, and the 8-parmset retry
    seen = []
    orig = tfu.pe_fused_scan_plain

    def record(*a, **k):
        out = orig(*a, **k)
        seen.append((a, k, out))
        return out
    record.calls = orig.calls
    monkeypatch.setattr(tfu, "pe_fused_scan_plain", record)
    hdr, samples = chip_smoke.pe_short_gap_tape()
    tpl.decode_tape(samples, chip_smoke.tape_options(hdr, tb.MODE_PE, 1600),
                    device="cpu")
    assert any(len(k["Ws"]) == 8 for _, k, _ in seen)
    return seen


_PLAIN = {}


def _plain_batches(case, monkeypatch):
    """_batches, once per case for the module (the plain decode is slow)."""
    if case not in _PLAIN:
        _PLAIN[case] = _batches(case, monkeypatch)
    return _PLAIN[case]


@pytest.mark.parametrize("chunk", [256, 64])
@pytest.mark.parametrize("case", ["segments", "short_gap_tape",
                                  "idle_caps"])
def test_host_state_machine_matches_plain(host_lib, case, chunk,
                                          monkeypatch):
    batches = _plain_batches(case, monkeypatch)
    fired = 0
    for a, kw, want in batches:
        args, got, keep = kernels.pe_prepare(*a, **kw)
        host_lib.pe_host_run(ctypes.byref(args), chunk)
        del keep
        for k in ("bits", "faked", "hist", "trk_i", "lane_i"):
            np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(),
                                          err_msg=k)
        # floats are bit-equal: same operations in the same order
        np.testing.assert_array_equal(got["trk_f"].numpy(),
                                      want["trk_f"].numpy())
        S = a[0].shape[-1]
        fired += int((want["lane_i"][..., tfu.PL_TAU] < S).sum())
    if case == "idle_caps":
        return
    assert fired > 0, "no lane reached its all-idle point"
    if case == "segments":
        assert int(want["faked"].sum()) > 0, "no fake bits"


@pytest.mark.parametrize("chunk", [256, 64])
def test_host_record_mode_matches_plain(host_lib, chunk):
    """The record mode (-trace's scan: every track's candidates from 0,
    t_lastpeak 0 before the first peak, the other contraction of the
    exponential clock) on the segments at one parmset: its per-admission
    rows (rec_f, rec_i, rec_n) and every other output equal the plain
    version's with trace_scan=True."""
    volts, seg_lens, leads, pa, kw = chip_smoke.pe_kernel_inputs(
        16384, seed=5, nparms=1, device="cpu")
    kw = dict(kw, trace_scan=True)
    want = tfu.pe_fused_scan_plain(volts, seg_lens, leads, pa, **kw)
    args, got, keep = kernels.pe_prepare(volts, seg_lens, leads, pa, **kw)
    host_lib.pe_host_run(ctypes.byref(args), chunk)
    del keep
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(),
                                      err_msg=k)
    n = want["rec_n"]
    assert int(n.sum()) > 1000
    flags = want["rec_i"][..., 1]
    assert (flags & 1).any() and (flags & 2).any()
    assert (want["rec_f"][..., 1] != 0).any()
