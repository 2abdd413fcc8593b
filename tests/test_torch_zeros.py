"""The -zeros front end: the plain versions of kernels Z1 and Z2
(readtape_tpu_torch.decode.gcr zerocross_transitions and
gcr_zeros_track_scan, reached through decode.zeros on the CPU) against the
JAX package's readtape_tpu.decode.gcr functions on the CPU, and a g++
host build of the kernels' machines (csrc/zeros_core.h) against the plain
versions. The CUDA build runs only on the card (tests/test_torch_cuda.py,
chip_smoke.py).

Tolerance: none. Every list entry, bit, count and f32 field is exact.

Inputs: four 9-track GCR segments (chip_smoke.gcr_segments: clean, noisy,
a weak track, two blocks behind a short gap) as volts, with 0.05 V of
numpy noise and quantized to 0.02 V so that exact-zero runs occur, two
stretches forced to 0, and eligible windows [lead, seg_len) of several
lengths; the differentiated variant reads their -differentiate volts.
A list of 150 entries is short enough that every segment overflows it.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from readtape_tpu.decode.common import ParmArrays as JParmArrays
from readtape_tpu.decode import gcr as jgcr
from readtape_tpu.formats.parms import builtin_parmsets as jbuiltin
from readtape_tpu_torch import kernels
from readtape_tpu_torch.decode import common as cm
from readtape_tpu_torch.decode import zeros as tz
from readtape_tpu_torch.formats import tbin as tb
from readtape_tpu_torch.formats.parms import builtin_parmsets

torch.set_num_threads(2)

S = 8192
SEG_LENS = np.array([S, 7000, S, 6000], np.int32)
LEADS = np.array([64, 100, 0, 64], np.int32)


def _inputs(differentiated):
    """(volts [4, 9, S] f32, spb, maxb)."""
    raw, _, deltat, maxvolts = chip_smoke.gcr_segments(S, seed=5)
    v = raw.astype(np.float32).transpose(0, 2, 1) * np.float32(
        maxvolts / 32767.0)
    rng = np.random.default_rng(3)
    v = v + rng.normal(0.0, 0.05, v.shape).astype(np.float32)
    v[1, 2, 3000:3400] = 0.0
    v[2, :, 5000:5100] = 0.0
    v = (np.round(v * 50) / 50).astype(np.float32)
    spb = 1.0 / (9042 * 25 * deltat)
    if differentiated:
        d = v - np.concatenate([np.zeros_like(v[..., :1]), v[..., :-1]], -1)
        d = np.where((d < 0.05) & (d > -0.05), 0.0, d)
        v = (d * np.float32(0.4 * int(spb))).astype(np.float32)
    return v, spb, int(S / spb * 1.3) + 64


def _cap(spb, cap):
    return int(S / spb * 3.2) + 64 if cap is None else cap


def _port_lists(v, spb, differentiated, cap):
    return tz.zerocross_transitions(
        torch.from_numpy(v), torch.from_numpy(SEG_LENS),
        torch.from_numpy(LEADS), cap=_cap(spb, cap),
        differentiated=differentiated)


@pytest.mark.parametrize("differentiated,cap", [
    (False, None), (True, None), (False, 150), (True, 150)])
def test_zerocross_matches_jax(differentiated, cap):
    v, spb, _ = _inputs(differentiated)
    calls = tz.zerocross_transitions_plain.calls
    got = _port_lists(v, spb, differentiated, cap)
    assert tz.zerocross_transitions_plain.calls == calls + 1
    for b in range(len(v)):
        want = jgcr.zerocross_transitions(
            jnp.asarray(v[b]), jnp.float32(spb), _cap(spb, cap),
            differentiated, jnp.int32(SEG_LENS[b]), jnp.int32(LEADS[b]))
        for k in ("t", "ok", "dt", "det", "is_top", "valid", "overflow"):
            np.testing.assert_array_equal(got[k][b].numpy(),
                                          np.asarray(want[k]),
                                          err_msg=f"segment {b} {k}")
    assert bool(got["overflow"].all()) == (cap is not None)
    assert int(got["ok"].sum(dim=-1).max()) >= 100


@pytest.mark.parametrize("differentiated", [False, True])
def test_gcr_zeros_scan_matches_jax(differentiated):
    """Z2's plain version over the 5 GCR parmsets against
    gcr_zeros_track_scan, vmapped over tracks and parmsets as the JAX
    package's _gcr_segment_device runs it."""
    v, spb, maxb = _inputs(differentiated)
    cap = _cap(spb, None)
    trans = _port_lists(v, spb, differentiated, None)
    pa = cm.ParmArrays.from_parmsets(builtin_parmsets(tb.MODE_GCR),
                                     torch.device("cpu"))
    got = tz.gcr_zeros_scan(trans, pa, spb=spb, maxb=maxb)
    jpa = JParmArrays.from_parmsets(jbuiltin(tb.MODE_GCR))
    lane = jax.vmap(lambda tt, ok, dtc, *p: jgcr.gcr_zeros_track_scan(
        tt, ok, dtc, cap, *p, jnp.float32(spb), maxb),
        in_axes=(0, 0, 0) + (None,) * 5)
    for b in range(len(v)):
        args = [jnp.asarray(x[b].numpy()) for x in (
            trans["t"], trans["ok"] & trans["valid"], trans["dt"])]
        want = jax.vmap(lambda *p: lane(*args, *p))(
            jpa.clk_window, jpa.clk_alpha, jpa.z1pt, jpa.z2pt,
            jpa.pulse_adj)
        for k in ("bits", "datacount", "peakcount", "t_firstbit",
                  "t_lastbit", "max_agc_gain", "min_agc_gain",
                  "incomplete", "hist", "trksum"):
            np.testing.assert_array_equal(got[k][b].numpy(),
                                          np.asarray(want[k]),
                                          err_msg=f"segment {b} {k}")
    assert int(got["datacount"].max()) > 500


_HOST_SRC = r"""
#include <vector>
#include "zeros_core.h"

// Z1's order: each lane's samples staged chunk by chunk, walked one by
// one, the unused slots filled after the walk
template <class Walk>
static void zc_host_lane(const ZcArgs& a, int lane, int C, float* buf) {
  const int b = lane / a.T, S = a.S, lo = a.lead[b], hi = a.seg_len[b];
  const float* v = a.volts + (int64_t)lane * S;
  Walk w;
  w.init();
  for (int c0 = 0; c0 < S; c0 += C) {
    const int c1 = c0 + C < S ? c0 + C : S;
    for (int s = c0; s < c1; ++s) buf[s - c0] = v[s];
    for (int s = c0; s < c1; ++s) w.step(a, lane, s, zc_elig(lo, hi, s, buf[s - c0]));
  }
  const int n = w.finish(a, lane);
  a.n_found[lane] = n;
  float t;
  bool top;
  w.fill_value(a, t, top);
  zc_fill(a, lane, n, t, top, 0, 1);
}

extern "C" void zc_host_run(const ZcArgs* a, int C) {
  std::vector<float> buf(C);
  for (int lane = 0; lane < a->B * a->T; ++lane) {
    if (a->diff)
      zc_host_lane<ZcDiff>(*a, lane, C, buf.data());
    else
      zc_host_lane<ZcPlain>(*a, lane, C, buf.data());
  }
}

extern "C" void zs_host_run(const ZsArgs* a) {
  float ring[NRZI_MAX_CLK_RING];
  for (int lane = 0; lane < a->B * a->P * a->T; ++lane) zs_lane(*a, lane, ring);
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not available")
    d = tmp_path_factory.mktemp("zeros_host")
    src = d / "host_run.cpp"
    src.write_text(_HOST_SRC)
    so = d / "libzeros_host.so"
    subprocess.run([gxx, "-O2", "-ffp-contract=off", "-std=c++17", "-shared",
                    "-fPIC", "-I", kernels.CSRC, "-o", str(so), str(src)],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    lib.zc_host_run.argtypes = [ctypes.POINTER(kernels.ZcArgs), ctypes.c_int]
    lib.zc_host_run.restype = None
    lib.zs_host_run.argtypes = [ctypes.POINTER(kernels.ZsArgs)]
    lib.zs_host_run.restype = None
    return lib


@pytest.mark.parametrize("differentiated", [False, True])
def test_host_zeros_machines_match_plain(host_lib, differentiated):
    """zeros_core.h on the host: Z1 at the kernel's chunk of 4096 samples
    and at 64, with the full list and one that overflows; Z2 over the
    full lists with the 5 GCR parmsets."""
    v, spb, maxb = _inputs(differentiated)
    vt = torch.from_numpy(v)
    lens, leads = torch.from_numpy(SEG_LENS), torch.from_numpy(LEADS)
    for cap in (_cap(spb, None), 150):
        want = _port_lists(v, spb, differentiated, cap)
        for chunk in (4096, 64):
            args, got, keep = kernels.zerocross_prepare(
                vt, lens, leads, cap=cap, differentiated=differentiated)
            host_lib.zc_host_run(ctypes.byref(args), chunk)
            del keep
            got["overflow"] = (got.pop("n_found") > cap).any(dim=-1)
            for k in want:
                assert torch.equal(got[k], want[k]), (cap, chunk, k)
    pa = cm.ParmArrays.from_parmsets(builtin_parmsets(tb.MODE_GCR),
                                     torch.device("cpu"))
    trans = _port_lists(v, spb, differentiated, None)
    want = tz.gcr_zeros_scan(trans, pa, spb=spb, maxb=maxb)
    args, got, keep = kernels.gcr_zeros_prepare(trans["t"], trans, pa,
                                                spb=spb, maxb=maxb)
    host_lib.zs_host_run(ctypes.byref(args))
    del keep
    for k in got:
        assert torch.equal(got[k], want[k]), k
