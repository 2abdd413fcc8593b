"""The GCR kernel's state machine (readtape_tpu_torch/csrc/gcr_core.h, with
phases 0 and B from pe_core.h and the admission test and AGC policy from
nrzi_core.h), compiled for the host with g++ and driven lane by lane in
the kernel's phase order, must equal the plain PyTorch version
(fused.gcr_fused_scan_plain) exactly: every integer field, every bit and
every float. This is the kernel's logic checked without a GPU; the CUDA
build itself runs only on the card (chip_smoke.py). Nothing at run time
uses this host build.

The host build walks each track chunk by chunk, as the kernel's phase A
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

_HOST_SRC = r"""
#include <math.h>
#include <vector>
#include "gcr_core.h"

// track t's walk chunk by chunk, over feature rows computed per chunk
template <class Walk>
static void walk_track(const GcrArgs* a, int lane, int t, const float* v,
                       const uint32_t* tw, int W, int C, std::vector<NrziFeat>& rows,
                       const NrziFeat& poison, float* heights, float* ring) {
  const int S = a->S;
  Walk w;
  gcr_walk_init(w, *a, lane, t, heights, ring);
  for (int c0 = 0; c0 < S; c0 += C) {
    const int c1 = c0 + C < S ? c0 + C : S;
    for (int i = 0; i < C; ++i) rows[i] = poison;
    nrzi_feature_rows(v, 0, S, W, tw + (c0 >> 5), c0, c1, rows.data(), 0, 1);
    if (!nrzi_walk_chunk(w, tw + (c0 >> 5), rows.data(), c0, c1, S, a->max_steps))
      break;
  }
  gcr_walk_finish(w, *a, lane, t);
}

// the kernel's phase order, phase A in chunks of C samples
template <bool REC>
static void host_run(const GcrArgs* a, int C) {
  const int nw = pe_nwords(*a), S = a->S;
  std::vector<NrziFeat> rows(C);
  NrziFeat poison;
  poison.wmax = poison.wmin = poison.vleft = poison.vright = NAN;
  poison.prevmax = poison.nextmax = poison.prevmin = poison.nextmin = NAN;
  poison.ltop = poison.lbot = -1000000;
  float heights[NRZI_MAX_AGC_RING], ring[NRZI_MAX_CLK_RING];
  for (int lane = 0; lane < a->B * a->P; ++lane) {
    const int b = lane / a->P, W = a->p_w[lane % a->P];
    gcr_zero_lane(*a, lane, 0, 1);
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
      walk_track<GcrWalkT<REC>>(a, lane, t, v, tw, W, C, rows, poison, heights, ring);
    }
    bool overflow, deep;
    pe_lane_flags(*a, lane, overflow, deep);
    const int tau = overflow ? PE_BIG_TAU : pe_tau_part(*a, lane, 0, 1);
    int after = a->S;
    for (int t = 0; t < a->T; ++t)
      after = pe_imin(after, gcr_apply_track<REC>(*a, lane, t, tau));
    gcr_write_lane(*a, lane, tau, overflow, after);
  }
}

// the record mode's instantiation, or the decode's (as the kernel picks)
extern "C" void gcr_host_run(const GcrArgs* a, int C) {
  if (a->dbg_f) host_run<true>(a, C); else host_run<false>(a, C);
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not available")
    d = tmp_path_factory.mktemp("gcr_host")
    src = d / "host_run.cpp"
    src.write_text(_HOST_SRC)
    so = d / "libgcr_host.so"
    subprocess.run([gxx, "-O2", "-ffp-contract=off", "-std=c++17", "-shared",
                    "-fPIC", "-I", kernels.CSRC, "-o", str(so), str(src)],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    lib.gcr_host_run.argtypes = [ctypes.POINTER(kernels.GcrArgs),
                                 ctypes.c_int]
    lib.gcr_host_run.restype = None
    return lib


def _batches(case, monkeypatch):
    """[(args, kwargs, plain outputs)] of gcr_fused_scan_plain calls."""
    if case == "segments":
        # clean, noisy, weak track, two blocks behind a short gap
        volts, seg_lens, leads, pa, kw = chip_smoke.gcr_kernel_inputs(
            16384, seed=5, device="cpu")
        out = tfu.gcr_fused_scan_plain(volts, seg_lens, leads, pa, **kw)
        return [((volts, seg_lens, leads, pa), kw, out)]
    # every batch of the noisy short-gap decode, the 5-parmset retry
    # included
    seen = []
    orig = tfu.gcr_fused_scan_plain

    def record(*a, **k):
        out = orig(*a, **k)
        seen.append((a, k, out))
        return out
    record.calls = orig.calls
    monkeypatch.setattr(tfu, "gcr_fused_scan_plain", record)
    hdr, samples = chip_smoke.gcr_short_gap_tape()
    tpl.decode_tape(samples, chip_smoke.tape_options(hdr, tb.MODE_GCR, 9042,
                                                     25), device="cpu")
    assert any(len(k["Ws"]) == 5 for _, k, _ in seen)
    return seen


_PLAIN = {}


def _plain_batches(case, monkeypatch):
    """_batches, once per case for the module (the plain decode is slow)."""
    if case not in _PLAIN:
        _PLAIN[case] = _batches(case, monkeypatch)
    return _PLAIN[case]


def _check_host_run(host_lib, case, chunk, monkeypatch):
    fired = 0
    for a, kw, want in _plain_batches(case, monkeypatch):
        args, got, keep = kernels.gcr_prepare(*a, **kw)
        host_lib.gcr_host_run(ctypes.byref(args), chunk)
        del keep
        for k in ("bits", "hist", "trk_i", "lane_i"):
            np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(),
                                          err_msg=k)
        # floats are bit-equal: same operations in the same order
        np.testing.assert_array_equal(got["trk_f"].numpy(),
                                      want["trk_f"].numpy())
        S = a[0].shape[-1]
        fired += int((want["lane_i"][..., tfu.GL_TAU] < S).sum())
    assert fired > 0, "no lane reached its all-idle point"


@pytest.mark.parametrize("case", ["segments", "short_gap_tape"])
def test_host_state_machine_matches_plain(host_lib, case, monkeypatch):
    """At the kernel's chunk of 256 samples."""
    _check_host_run(host_lib, case, 256, monkeypatch)


@pytest.mark.parametrize("case", ["segments", "short_gap_tape"])
def test_host_walk_in_small_chunks_matches_plain(host_lib, case,
                                                 monkeypatch):
    """At a chunk of 64 samples: more walks cross a chunk's edge."""
    _check_host_run(host_lib, case, 64, monkeypatch)


@pytest.mark.parametrize("chunk", [256, 64])
def test_host_record_mode_matches_plain(host_lib, chunk):
    """The record mode (-trace's scan: every track's candidates from 0,
    no mid-scan idle) on the segments at one parmset: its per-admission
    rows (rec_f, rec_i, rec_n) and every other output equal the plain
    version's with trace_scan=True."""
    volts, seg_lens, leads, pa, kw = chip_smoke.gcr_kernel_inputs(
        16384, seed=5, nparms=1, device="cpu")
    kw = dict(kw, trace_scan=True)
    want = tfu.gcr_fused_scan_plain(volts, seg_lens, leads, pa, **kw)
    args, got, keep = kernels.gcr_prepare(volts, seg_lens, leads, pa, **kw)
    host_lib.gcr_host_run(ctypes.byref(args), chunk)
    del keep
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(),
                                      err_msg=k)
    assert int(want["rec_n"].sum()) > 1000
    assert (want["rec_i"][..., 1] > 0).any()
    assert (want["rec_f"][..., 1] != 0).any()
