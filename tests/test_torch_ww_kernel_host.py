"""The Whirlwind kernel's logic (readtape_tpu_torch/csrc/ww_core.h: the
candidacy words, each track's admission, the merge and the machine with
its flush), compiled for the host with g++ and run in the kernel's phase
order, must equal the plain PyTorch version (fused.ww_fused_scan_plain)
exactly: every character, block record, histogram entry, count and
float. This is the kernel's logic checked without a GPU; the CUDA build
itself runs only on the card (chip_smoke.py). Nothing at run time uses
this host build.

Cases: the calls decode_tape makes on a noisy tape (chip_smoke.ww_tape
with shorter blocks, -fluxdir=auto); the same inputs with a rolling-base
span of 2^12 samples; with a moving-window clock, a min-of-window AGC
and character and block records too small for the tape; and both passes
of a -deskew decode."""

import ctypes
import dataclasses
import shutil
import subprocess

import numpy as np
import pytest
import torch

import chip_smoke
from readtape_tpu_torch import kernels
from readtape_tpu_torch.decode import fused as tfu
from readtape_tpu_torch.decode import pipeline as tpl

torch.set_num_threads(2)

_HOST_SRC = r"""
#include "ww_core.h"
extern "C" void ww_host_run(const WwArgs* a) {
  const int nw = ww_nwords(*a);
  for (int i = 0; i < a->T * nw; ++i)
    a->cand[i] = ww_cand_word(*a, i / nw, i % nw);
  for (int t = 0; t < a->T; ++t) ww_admit_track(*a, t);
  ww_machine(*a);
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not available")
    d = tmp_path_factory.mktemp("ww_host")
    src = d / "host_run.cpp"
    src.write_text(_HOST_SRC)
    so = d / "libww_host.so"
    subprocess.run([gxx, "-O2", "-ffp-contract=off", "-std=c++17", "-shared",
                    "-fPIC", "-I", kernels.CSRC, "-o", str(so), str(src)],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    lib.ww_host_run.argtypes = [ctypes.POINTER(kernels.WwArgs)]
    lib.ww_host_run.restype = None
    return lib


def _calls(case, monkeypatch):
    """[(args, kwargs, plain outputs)] of ww_fused_scan_plain calls."""
    if case == "deskew":
        hdr, samples = chip_smoke.ww_deskew_tape()
        opts = chip_smoke.ww_options(hdr, deskew=True)
    else:
        _, hdr, samples = chip_smoke.ww_tape(sizes=(24, 40, 16))
        opts = chip_smoke.ww_options(hdr, "auto")
    seen = []
    plain = tfu.ww_fused_scan_plain

    def record(*a, **k):
        out = plain(*a, **k)
        seen.append((a, k, out))
        return out
    record.calls = plain.calls
    monkeypatch.setattr(tfu, "ww_fused_scan_plain", record)
    tpl.decode_tape(samples, opts, device="cpu")
    if case == "rebase":
        return [(a, dict(k, span=1 << 12), plain(*a, **dict(k, span=1 << 12)))
                for a, k, _ in seen]
    if case == "windows":
        out = []
        for a, k, _ in seen:
            p = dataclasses.replace(k["parms"], clk_window=7, clk_alpha=0.0,
                                    agc_window=4, agc_alpha=0.0)
            k = dict(k, parms=p, maxchars=100, maxblocks=2)
            out.append((a, k, plain(*a, **k)))
        return out
    return seen


@pytest.mark.parametrize("case", ["noisy_auto", "rebase", "windows",
                                  "deskew"])
def test_host_machine_matches_plain(host_lib, case, monkeypatch):
    calls = _calls(case, monkeypatch)
    assert len(calls) == (2 if case == "deskew" else 1)
    for a, kw, want in calls:
        args, got, keep = kernels.ww_prepare(*a, **kw)
        host_lib.ww_host_run(ctypes.byref(args))
        del keep
        for k in want:
            # floats are bit-equal: same operations in the same order
            np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(),
                                          err_msg=k)
        sc = want["scal"]
        assert int(sc[tfu.WS_NBLOCKS]) >= 2 and int(sc[tfu.WS_NEVENTS]) > 1000
    if case == "rebase":
        assert int(sc[tfu.WS_BASE]) > 0
    if case == "windows":
        assert int(sc[tfu.WS_NBLOCKS]) > 2 and int(sc[tfu.WS_DATACOUNT]) == 100
