"""The GCR kernel's state machine (readtape_tpu_torch/csrc/gcr_core.h, with
phases 0 and B from pe_core.h), compiled for the host with g++ and driven
lane by lane in the kernel's phase order, must equal the plain PyTorch
version (fused.gcr_fused_scan_plain) exactly: every integer field, every
bit and every float. This is the kernel's logic checked without a GPU;
the CUDA build itself runs only on the card (chip_smoke.py). Nothing at
run time uses this host build."""

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
#include "gcr_core.h"
extern "C" void gcr_host_run(const GcrArgs* a) {
  const int nw = pe_nwords(*a);
  for (int lane = 0; lane < a->B * a->P; ++lane) {
    gcr_zero_lane(*a, lane, 0, 1);
    uint32_t* cw = a->cand + (int64_t)lane * a->T * nw;
    for (int i = 0; i < a->T * nw; ++i)
      cw[i] = pe_cand_word(*a, lane, i / nw, i % nw);
    for (int t = 0; t < a->T; ++t) gcr_admit_track(*a, lane, t);
    bool overflow, deep;
    pe_lane_flags(*a, lane, overflow, deep);
    const int tau = overflow ? PE_BIG_TAU : pe_tau_part(*a, lane, 0, 1);
    int after = a->S;
    for (int t = 0; t < a->T; ++t)
      after = pe_imin(after, gcr_apply_track(*a, lane, t, tau));
    gcr_write_lane(*a, lane, tau, overflow, after);
  }
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
    lib.gcr_host_run.argtypes = [ctypes.POINTER(kernels.GcrArgs)]
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


@pytest.mark.parametrize("case", ["segments", "short_gap_tape"])
def test_host_state_machine_matches_plain(host_lib, case, monkeypatch):
    fired = 0
    for a, kw, want in _batches(case, monkeypatch):
        args, got, keep = kernels.gcr_prepare(*a, **kw)
        host_lib.gcr_host_run(ctypes.byref(args))
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
