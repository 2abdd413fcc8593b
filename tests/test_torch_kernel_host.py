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
(nrzi_slot_machine: the drive the card runs one track per thread).

Last, B6's lane (nrzi_slot_lane, tests/test_torch_scan.py's host build)
in the slot machine's two modes that B1 never runs: -adjskew's
accumulators, seeded non-zero, and the DEBUG build's -correct (on
buffers where it flips a bit mid-block, on buffers where only the
release check flips one, and on tests/test_torch_slot.py's tied gains,
where every slot flips the first of the two highest), each against the
plain version, and both at once."""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from readtape_tpu_torch import kernels
from readtape_tpu_torch.decode import fused as tfu
from readtape_tpu_torch.decode import slot as tsl

from test_torch_adjskew import seeds
from test_torch_correctdbg import drop_mid_bit
from test_torch_fused import CASES, _inputs
from test_torch_scan import tiered_host_lib  # noqa: F401
from test_torch_slot import slot_case

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


@pytest.mark.parametrize("mode,name", [
    ("adjskew", "1blk"), ("correctdbg", "middrop"), ("correctdbg", "correct"),
    ("correctdbg", "tie"), ("both", "correct")])
def test_host_slot_lane_new_modes_match_plain(tiered_host_lib,  # noqa: F811
                                              mode, name):
    fin, pa, kw, trans, _ = slot_case("1blk" if name == "middrop" else name)
    if name == "middrop":
        fin, _ = drop_mid_bit(fin, trans, kw["spb"])
    B, P, T, _ = fin["tr_s"].shape
    if mode in ("adjskew", "both"):
        kw = dict(kw, clk_avg_fma=True, adj_init=seeds(B, P, T, seed=13))
    if mode in ("correctdbg", "both"):
        kw = dict(kw, do_correct=False, correct_debug=True)
    want = tsl.nrzi_slot_scan_plain(fin, pa, **kw)
    args, got, keep = kernels.nrzi_slot_prepare(fin["tr_s"], fin, pa, **kw)
    assert args.do_correct == (kernels.NRZI_CORRECT_DEBUG
                               if mode != "adjskew" else int(kw["do_correct"]))
    tiered_host_lib.slot_host_run(ctypes.byref(args))
    del keep
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(),
                                      err_msg=k)
    corrected = want["lane_i"][0, :, tsl.LI_CORR]
    if mode != "adjskew":
        # the DEBUG check flips mid-block or at every tied slot, never
        # the first frame's bit the release check flips
        assert ((corrected > 0) == (name != "correct")).all()


@pytest.mark.parametrize("name", ["1blk", "middrop", "tie"])
def test_host_slot_lane_records_match_plain(tiered_host_lib,  # noqa: F811
                                            name):
    """B6's record mode (-trace's, -correct off): each live slot's
    boundary and adjusted clock position, and the slot of the last write
    to each (track, column), equal the plain version's, and so does
    every other output."""
    fin, pa, kw, trans, _ = slot_case("1blk" if name == "middrop" else name)
    if name == "middrop":
        fin, _ = drop_mid_bit(fin, trans, kw["spb"])
    kw = dict(kw, do_correct=False, records=True)
    want = tsl.nrzi_slot_scan_plain(fin, pa, **kw)
    args, got, keep = kernels.nrzi_slot_prepare(fin["tr_s"], fin, pa, **kw)
    tiered_host_lib.slot_host_run(ctypes.byref(args))
    del keep
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(),
                                      err_msg=k)
    nslot = want["lane_i"][..., tsl.LI_NSLOT]
    assert int(nslot.min()) > 50
    assert (want["slot_f"][..., tsl.SL_AVGPOS] > 0).any()
    # every track's last column write is the lane's last live slot's
    col_slot = want["col_slot"]
    assert (col_slot >= 0).any()
    assert (col_slot.amax(dim=-1) == nslot.unsqueeze(-1) - 1).all()
