"""The -zeros front end: the plain versions of kernels Z1 and Z2
(readtape_tpu_torch.decode.gcr zerocross_transitions and
gcr_zeros_track_scan, reached through decode.zeros on the CPU) against the
JAX package's readtape_tpu.decode.gcr functions on the CPU, and a g++
host build of the kernels' passes (csrc/zeros_core.h), run in the
kernels' order at their chunks and at smaller ones, against the plain
versions, also on volts built to put Z1's state across its chunk edges.
The CUDA build runs only on the card (tests/test_torch_cuda.py,
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
import dataclasses
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

// Z1's passes in the kernel's order (csrc/zeros.cu zc_kernel): each
// lane's samples a chunk of C at a time, its C / ZC_R threads run one
// after another and each block scan an exclusive fold
extern "C" void zc_host_run(const ZcArgs* a, int C) {
  const int nt = C / ZC_R, S = a->S, cap = a->cap;
  std::vector<float> buf(C);
  std::vector<ZcThread> th(nt);
  std::vector<int32_t> ra(C + 2), rj(C + 2);
  std::vector<float> rv(C + 2);
  std::vector<uint32_t> rm(C + 2);
  std::vector<uint8_t> rf(C + 2);
  ZcRecs R;
  R.a = ra.data();
  R.v = rv.data();
  R.m = rm.data();
  R.j = rj.data();
  R.f = rf.data();
  for (int lane = 0; lane < a->B * a->T; ++lane) {
    const int b = lane / a->T, lo = a->lead[b], hi = a->seg_len[b];
    const float* v = a->volts + (int64_t)lane * S;
    ZcScan1 c1 = zc_scan1_id();
    ZcScan2 c2 = zc_scan2_id();
    float fill_t = 0.0f;
    int fill_top = 0;
    ZcLane L;
    zc_lane_init(L);
    for (int c0 = 0; c0 < S; c0 += C) {
      const int kc = c2.n;
      for (int q = 0; q < C; ++q) buf[q] = c0 + q < S ? v[c0 + q] : 0.0f;
      for (int q = 0; q <= C; ++q) {
        rm[q] = 0u;
        rj[q] = ZC_NONE;
      }
      for (int t = 0; t < nt; ++t) zc_t_load(th[t], &buf[t * ZC_R], c0 + t * ZC_R, lo, hi, S);
      for (int t = 0; t < nt; ++t) {
        const ZcScan1 s1 = zc_t_sum1(th[t]);
        th[t].e1 = c1;
        c1 = zc_comb(c1, s1);
      }
      if (a->diff) {
        for (int t = 0; t < nt; ++t) {
          const ZcScan2 s2 = zc_t_diff2(th[t], S, &fill_t, &fill_top);
          th[t].e2 = c2;
          c2 = zc_comb(c2, s2);
        }
        for (int t = 0; t < nt; ++t) zc_t_diff_put(th[t], *a, lane, c2.n);
        continue;
      }
      for (int t = 0; t < nt; ++t) {
        const ZcScan2 s2 = zc_t_plain2(th[t]);
        th[t].e2 = c2;
        c2 = zc_comb(c2, s2);
      }
      for (int t = 0; t < nt; ++t) zc_t_records(th[t], R, kc, cap);
      const int nev = c2.n - kc;
      zc_pass_b(L, R, nev, cap);
      for (int t = 0; t < nt; ++t) zc_t_pass_c(th[t], R, kc, cap);
      for (int k = kc > 1 ? kc : 1; k <= kc + nev - 1 && k <= cap; ++k)
        zc_put_bucket(*a, lane, R, k - kc, k);
      zc_lane_j(L, R, kc, cap);
    }
    const int n = a->diff ? c2.n : zc_finish(*a, lane, L);
    a->n_found[lane] = n;
    zc_fill(*a, lane, n, a->diff ? fill_t : (float)S, a->diff ? fill_top != 0 : false, 0, 1);
  }
}

// Z2 in the kernel's order: each track's list staged C entries at a
// time, every parmset's walker over each chunk
extern "C" void zs_host_run(const ZsArgs* a, int C) {
  std::vector<float> et(C), edt(C), rings((size_t)a->P * a->ring);
  std::vector<uint8_t> ef(C);
  std::vector<ZsWalker> w(a->P);
  for (int row = 0; row < a->B * a->T; ++row) {
    const int64_t base = (int64_t)row * a->cap;
    for (int p = 0; p < a->P; ++p) zs_walker_init(w[p], *a, row, p, &rings[(size_t)p * a->ring]);
    for (int c0 = 0; c0 < a->cap; c0 += C) {
      const int n = C < a->cap - c0 ? C : a->cap - c0;
      for (int q = 0; q < n; ++q) {
        et[q] = a->t[base + c0 + q];
        edt[q] = a->dt[base + c0 + q];
        ef[q] = zs_flags(*a, base + c0 + q);
      }
      bool alive = false;
      for (int p = 0; p < a->P; ++p) {
        if (!w[p].alive) continue;
        zs_walk_chunk(w[p], et.data(), edt.data(), ef.data(), n, a->spb, a->maxb);
        alive = alive || w[p].alive;
      }
      if (!alive) break;
    }
    for (int p = 0; p < a->P; ++p) zs_walker_finish(w[p], *a, row, p);
  }
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
    lib.zs_host_run.argtypes = [ctypes.POINTER(kernels.ZsArgs), ctypes.c_int]
    lib.zs_host_run.restype = None
    return lib


# the chunks the host build runs Z1's passes at: the kernel's 2048
# samples (csrc/zeros.cu ZC_CHUNK), 4096 and 64; Z2's: the kernel's 1024
# entries (ZS_CHUNK) and 64
HOST_CHUNKS = (2048, 4096, 64)


def _host_lists(host_lib, v, lens, leads, cap, differentiated, chunk):
    """Z1's passes on the host at a chunk of `chunk` samples: the lists
    with overflow."""
    args, got, keep = kernels.zerocross_prepare(
        torch.from_numpy(v), torch.from_numpy(lens),
        torch.from_numpy(leads), cap=cap, differentiated=differentiated)
    host_lib.zc_host_run(ctypes.byref(args), chunk)
    del keep
    got["overflow"] = (got.pop("n_found") > cap).any(dim=-1)
    return got


def _host_zs(host_lib, trans, pa, spb, maxb, chunk):
    args, got, keep = kernels.gcr_zeros_prepare(trans["t"], trans, pa,
                                                spb=spb, maxb=maxb)
    host_lib.zs_host_run(ctypes.byref(args), chunk)
    del keep
    return got


@pytest.mark.parametrize("differentiated", [False, True])
def test_host_zeros_machines_match_plain(host_lib, differentiated):
    """zeros_core.h's passes on the host in the kernels' order: Z1 at the
    kernel's chunk of 2048 samples, at 4096 and at 64, with the full list
    and one that overflows; Z2 over the full lists with the 5 GCR
    parmsets, at the kernel's chunk of 1024 entries and at 64."""
    v, spb, maxb = _inputs(differentiated)
    for cap in (_cap(spb, None), 150):
        want = _port_lists(v, spb, differentiated, cap)
        for chunk in HOST_CHUNKS:
            got = _host_lists(host_lib, v, SEG_LENS, LEADS, cap,
                              differentiated, chunk)
            for k in want:
                assert torch.equal(got[k], want[k]), (cap, chunk, k)
    pa = cm.ParmArrays.from_parmsets(builtin_parmsets(tb.MODE_GCR),
                                     torch.device("cpu"))
    trans = _port_lists(v, spb, differentiated, None)
    want = tz.gcr_zeros_scan(trans, pa, spb=spb, maxb=maxb)
    for chunk in (1024, 64):
        got = _host_zs(host_lib, trans, pa, spb, maxb, chunk)
        for k in got:
            assert torch.equal(got[k], want[k]), (chunk, k)


# ---------------------------------------------------------------------------
# Z1's chunk edges: volts built lobe by lobe (half sines, sign given, no
# exact zeros inside a lobe; adjacent lobes of opposite sign meet on a
# literal sign flip), two tracks of S = 4096 samples, the kernel's chunk
# boundary at 2048 (also a boundary of the host's 64-sample chunks)
# ---------------------------------------------------------------------------

ES = 4096
EDGE = 2048
E_LENS = np.array([ES - 50], np.int32)
E_LEADS = np.array([20], np.int32)


def _lobe(n, amp, sign):
    k = np.arange(n, dtype=np.float64)
    return (sign * amp * np.sin(np.pi * (k + 0.5) / n)).astype(np.float32)


def _train(rng, n, start_sign=1):
    """n samples of lobes of random width (12-70) and height (0.05-1.0,
    some below ZC_PEAK), now and then a few exact zeros between them."""
    out, sign = [], start_sign
    while sum(len(x) for x in out) < n:
        out.append(_lobe(int(rng.integers(12, 70)),
                         float(rng.uniform(0.05, 1.0)), sign))
        if rng.random() < 0.2:
            out.append(np.zeros(int(rng.integers(1, 6)), np.float32))
        sign = -sign
    return np.concatenate(out)[:n]


def _edge_volts(case):
    """(volts [1, 2, ES], cap, differentiated): track 0 holds the case's
    feature, track 1 a random lobe train."""
    rng = np.random.default_rng(11)
    v = np.zeros((1, 2, ES), np.float32)
    v[0, 1] = _train(rng, ES)
    t0 = np.zeros(ES, np.float32)
    t0[:1700] = _train(rng, 1700)
    t0[2400:] = _train(rng, ES - 2400)
    cap, diff = 400, case.endswith("diff")
    if case == "span":
        # + lobe, zeros (the next lobe is not armed), - lobe, then a
        # + lobe from 2000 whose threshold (the carried + extremum, 0.8)
        # it crosses only after the chunk boundary
        t0[1700:1800] = _lobe(100, 0.8, 1)
        t0[1860:2000] = _lobe(140, 0.8, -1)
        t0[2000:2200] = _lobe(200, 1.0, 1)
        t0[2200:2400] = _lobe(200, 0.9, -1)
    elif case == "late_sig":
        # a + phase starting at 2040 stays at 0.1 up to the boundary and
        # turns significant after it
        t0[1700:1940] = _train(rng, 240)
        t0[1940:2040] = _lobe(100, 0.7, -1)
        t0[2040:2056] = 0.1
        t0[2056:2200] = _lobe(144, 0.9, 1)
        t0[2200:2400] = _lobe(200, 0.9, -1)
    elif case == "zero_run_diff":
        # + lobe with its last sample above ZC_PEAK before 2030, exact
        # zeros 2030..2069 across the boundary, then a - crossing at 2070
        t0[1700:1950] = _train(rng, 250)
        t0[1950:2030] = _lobe(80, 0.6, 1)
        t0[2070:2400] = _lobe(330, 0.6, -1)
    elif case.startswith("silent"):
        # no sample of track 0 above ZC_PEAK
        t0[:] = rng.uniform(-0.15, 0.15, ES).astype(np.float32)
    elif case.startswith("over_cap"):
        t0[1700:2400] = _train(rng, 700)
        cap = 8
    v[0, 0] = t0
    return v, cap, diff


EDGE_CASES = ["span", "late_sig", "zero_run_diff", "silent", "silent_diff",
              "over_cap", "over_cap_diff"]
# one XLA program per (cap, variant): the eager call compiles op by op
_jax_zc = jax.jit(jgcr.zerocross_transitions, static_argnums=(2, 3))


@pytest.mark.parametrize("case", EDGE_CASES)
def test_host_zerocross_edge_cases(host_lib, case):
    """Z1 at its chunk edges: the plain version against the JAX function,
    and the host-built passes (at the kernel's chunk and at 64) against
    the plain version, field for field. Each case asserts that its volts
    show what it is named for: a bucket whose phase starts before the
    boundary and confirms after it (span); a phase that starts before the
    boundary and turns significant after it (late_sig); a zero run across
    the boundary timing a differentiated crossing (zero_run_diff); a
    track with no significant phase (silent); a list past cap (over_cap:
    plain keeps the first cap buckets, differentiated puts the last
    crossing in slot cap - 1)."""
    v, cap, diff = _edge_volts(case)
    want = tz.zerocross_transitions(
        torch.from_numpy(v), torch.from_numpy(E_LENS),
        torch.from_numpy(E_LEADS), cap=cap, differentiated=diff)
    jw = _jax_zc(jnp.asarray(v[0]), jnp.float32(10.0), cap, diff,
                 jnp.int32(E_LENS[0]), jnp.int32(E_LEADS[0]))
    for k in ("t", "ok", "dt", "det", "is_top", "valid", "overflow"):
        np.testing.assert_array_equal(want[k][0].numpy(), np.asarray(jw[k]),
                                      err_msg=k)
    for chunk in (HOST_CHUNKS[0], HOST_CHUNKS[-1]):
        got = _host_lists(host_lib, v, E_LENS, E_LEADS, cap, diff, chunk)
        for k in want:
            assert torch.equal(got[k], want[k]), (chunk, k)
    t, ok, det = (want[k][0, 0].numpy() for k in ("t", "ok", "det"))
    valid = want["valid"][0, 0].numpy()
    if case == "span":
        k = int(np.flatnonzero(valid & (t == 2000))[0])
        assert ok[k] and det[k] >= EDGE
    elif case == "late_sig":
        assert 0 < v[0, 0, 2040:EDGE].min() and v[0, 0, 2040:EDGE].max() <= 0.2
        assert (valid & (t == 2040)).any()
    elif case == "zero_run_diff":
        k = int(np.flatnonzero(valid & (det == 2070))[0])
        assert t[k] == (2030 + 2069) / 2
    elif case.startswith("silent"):
        assert not valid.any() and want["valid"][0, 1].any()
    else:
        assert bool(want["overflow"][0]) and valid.all()
        if diff:
            full = tz.zerocross_transitions(
                torch.from_numpy(v), torch.from_numpy(E_LENS),
                torch.from_numpy(E_LEADS), cap=400, differentiated=True)
            n = int(full["valid"][0, 0].sum())
            assert n > cap
            for key in ("t", "det", "is_top"):
                assert full[key][0, 0, n - 1] == want[key][0, 0, cap - 1]


def test_host_gcr_zeros_clk_windows(host_lib):
    """Z2 with parmsets of different clock windows (0: the exponential
    clock; 24, 5, 10 and 50, the reference's largest): the plain
    version against gcr_zeros_track_scan, the host-built walkers at the
    kernel's chunk and at 64 against the plain version."""
    v, spb, maxb = _inputs(False)
    cap = _cap(spb, None)
    trans = _port_lists(v, spb, False, None)
    windows = [0, 24, 5, 10, 50]
    pa = dataclasses.replace(
        cm.ParmArrays.from_parmsets(builtin_parmsets(tb.MODE_GCR),
                                    torch.device("cpu")),
        clk_window=torch.tensor(windows, dtype=torch.int32))
    want = tz.gcr_zeros_scan(trans, pa, spb=spb, maxb=maxb)
    jpa = JParmArrays.from_parmsets(jbuiltin(tb.MODE_GCR))
    lane = jax.vmap(lambda tt, ok, dtc, *p: jgcr.gcr_zeros_track_scan(
        tt, ok, dtc, cap, *p, jnp.float32(spb), maxb),
        in_axes=(0, 0, 0) + (None,) * 5)
    b = 1
    args = [jnp.asarray(x[b].numpy()) for x in (
        trans["t"], trans["ok"] & trans["valid"], trans["dt"])]
    jw = jax.vmap(lambda *p: lane(*args, *p))(
        jnp.asarray(windows, jnp.int32), jpa.clk_alpha, jpa.z1pt, jpa.z2pt,
        jpa.pulse_adj)
    for k in ("bits", "datacount", "peakcount", "t_firstbit", "t_lastbit"):
        np.testing.assert_array_equal(want[k][b].numpy(), np.asarray(jw[k]),
                                      err_msg=k)
    for chunk in (1024, 64):
        got = _host_zs(host_lib, trans, pa, spb, maxb, chunk)
        for k in got:
            assert torch.equal(got[k], want[k]), (chunk, k)
    dc = want["datacount"][b]
    assert len({tuple(dc[p].tolist()) for p in range(len(windows))}) > 1
