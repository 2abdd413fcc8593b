"""The CUDA kernel's state machine (readtape_tpu_torch/csrc/nrzi_core.h),
compiled for the host with g++ and driven lane by lane in the kernel's
phase order, must equal the plain PyTorch version
(fused.nrzi_fused_scan_plain) exactly: every integer field, every bit and
every float. This is the kernel's logic checked without a GPU; the CUDA
build itself runs only on the card (chip_smoke.py). Nothing at run time
uses this host build.

The host build walks each track's admission chunk by chunk, as the
kernel's phase A does (nrzi_walk_chunk), over window features it computes
for each chunk (nrzi_feature_rows; the rows it did not compute hold NaN),
with the kernel's chunk of 256 samples and with one of 64; then the slot
machine's per-track steps and per-lane combines, track by track
(nrzi_slot_machine: the drive the card runs one track per thread)."""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from readtape_tpu_torch import kernels
from readtape_tpu_torch.decode import fused as tfu

from test_torch_fused import CASES, _inputs

torch.set_num_threads(2)

_DRIVER = r"""
#include <math.h>
#include <vector>
#include "nrzi_core.h"

// the kernel's phase order, phase A in chunks of C samples
extern "C" void nrzi_host_run(const NrziArgs* a, int C) {
  const int nw = nrzi_nwords(*a), S = a->S;
  std::vector<NrziFeat> rows(C);
  NrziFeat poison;
  poison.wmax = poison.wmin = poison.vleft = poison.vright = NAN;
  poison.prevmax = poison.nextmax = poison.prevmin = poison.nextmin = NAN;
  poison.ltop = poison.lbot = -1000000;
  float heights[NRZI_MAX_AGC_RING];
  for (int lane = 0; lane < a->B * a->P; ++lane) {
    const int b = lane / a->P, W = a->p_w[lane % a->P];
    nrzi_zero_lane(*a, lane, 0, 1);
    // the kernel's candidate words: one bit per lane of a warp
    uint32_t* cw = a->cand + (int64_t)lane * a->T * nw;
    for (int i = 0; i < a->T * nw; ++i) {
      uint32_t word = 0;
      for (int l = 0; l < 32; ++l)
        if (nrzi_cand_bit(*a, lane, i / nw, ((i % nw) << 5) + l)) word |= 1u << l;
      cw[i] = word;
    }
    for (int t = 0; t < a->T; ++t) {
      const float* v = a->volts + ((int64_t)b * a->T + t) * S;
      const uint32_t* tw = cw + (int64_t)t * nw;
      NrziWalk w;
      nrzi_fused_walk_init(w, *a, lane, t, heights);
      for (int c0 = 0; c0 < S; c0 += C) {
        const int c1 = c0 + C < S ? c0 + C : S;
        for (int i = 0; i < C; ++i) rows[i] = poison;
        nrzi_feature_rows(v, 0, S, W, tw + (c0 >> 5), c0, c1, rows.data(), 0, 1);
        if (!nrzi_walk_chunk(w, tw + (c0 >> 5), rows.data(), c0, c1, S, a->max_steps))
          break;
      }
      nrzi_fused_walk_finish(w, *a, lane, t);
    }
    nrzi_slot_machine(*a, lane);
  }
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not available")
    d = tmp_path_factory.mktemp("nrzi_host")
    src = d / "driver.cpp"
    src.write_text(_DRIVER)
    so = d / "libnrzi_host.so"
    subprocess.run([gxx, "-O2", "-ffp-contract=off", "-std=c++17", "-shared",
                    "-fPIC", "-I", kernels.CSRC, "-o", str(so), str(src)],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    lib.nrzi_host_run.argtypes = [ctypes.POINTER(kernels.NrziArgs),
                                  ctypes.c_int]
    lib.nrzi_host_run.restype = None
    return lib


@pytest.mark.parametrize("case", list(CASES))
def test_host_state_machine_matches_plain(host_lib, case):
    volts, seg_lens, leads, pa, kw, _ = _inputs(case)
    want = tfu.nrzi_fused_scan_plain(volts, seg_lens, leads, pa, **kw)
    for chunk in (256, 64):
        args, got, keep = kernels.nrzi_prepare(volts, seg_lens, leads, pa,
                                               **kw)
        host_lib.nrzi_host_run(ctypes.byref(args), chunk)
        del keep
        for k in ("bits", "hist", "trk_i", "lane_i"):
            np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(),
                                          err_msg=f"{k}, chunk {chunk}")
        # floats are bit-equal: same operations in the same order, no FMA
        np.testing.assert_array_equal(got["trk_f"].numpy(),
                                      want["trk_f"].numpy(),
                                      err_msg=f"chunk {chunk}")
