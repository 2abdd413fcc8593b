"""The port's NRZI admission alone (readtape_tpu_torch.decode.scan: B5a
nrzi_track_scan, B5b nrzi_track_scan_tracks, plain versions on the CPU)
against the JAX package's XLA scan trackscan.nrzi_track_scan_pre run with
nsteps = S, the contract tests/test_pallas_scan.py holds the TPU kernels
to, on that file's inputs (_setup: B=2, S=4096, P=3 with mixed widths, or
one shared width for B5b); plus the density-detection shape (window 8,
parmset 0's knobs, the XLA scan's step budget, no candidate mask) on a
noisy segment where the budget binds. The port computes its own window
features and jump tables from the same volts.

Then csrc/nrzi_core.h's B5 lanes, compiled for the host with g++, against
the plain version on the same inputs: the CUDA source's logic checked
without a GPU. B5a's lane walks its table whole (nrzi_scan_lane, what
csrc/nrzi_scan.cu runs per thread); B5b's and density detection's walk it
chunk by chunk as B5b's blocks do (nrzi_walk_chunk over each chunk's
candidate words, bit s set where nxt[s] == s, and the feature rows of its
candidates only; the other rows hold NaN), at the kernel's chunk of 256
entries and at one of 64.

Tolerance: none. Every buffer entry (fill included), count, flag and
f32 value is exact.
"""

import ctypes
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from readtape_tpu.decode import trackscan as jts
from readtape_tpu_torch import kernels
from readtape_tpu_torch.decode import common as cm
from readtape_tpu_torch.decode import fused as tfu
from readtape_tpu_torch.decode import scan as tsc
from readtape_tpu_torch.formats import tbin as tb
from readtape_tpu_torch.formats.parms import ParmSets, builtin_parmsets

from test_pallas_scan import _setup

torch.set_num_threads(2)

FIELDS = ("tr_s", "tr_t", "tr_agc", "tr_top", "n_admitted", "max_agc_gain",
          "min_agc_gain", "incomplete")


def port_parms(P):
    """The port's ParmArrays of the first P builtin NRZI parmsets."""
    sets = builtin_parmsets(tb.MODE_NRZI).sets[:P]
    return cm.ParmArrays.from_parmsets(ParmSets(sets=sets,
                                                mode=tb.MODE_NRZI), "cpu")


def jax_scan(v, Ws, P, K, nsteps, rf, mf, seg_len, lead, masked=True):
    """trackscan.nrzi_track_scan_pre for every (b, p, t) lane of v
    [B, T, S] (numpy), its own features and union jump table, masked to
    [lead, seg_len) unless masked=False. Returns numpy [B, P, T, ...]."""
    sets = builtin_parmsets(tb.MODE_NRZI).sets[:P]
    B, T, S = v.shape
    out = {k: [] for k in FIELDS}
    wset = sorted(set(Ws))
    for b in range(B):
        vb = jnp.asarray(v[b])
        nxt = None
        for W in wset:
            t_ = jts.loose_jump_table(vb, W, jnp.asarray(rf), jnp.asarray(mf))
            nxt = t_ if nxt is None else jnp.minimum(nxt, t_)
        if masked:
            nxt = jnp.where(nxt < seg_len, nxt, S)
            first = nxt[:, lead:lead + 1]
            iota = jnp.arange(S + 1)[None, :]
            nxt = jnp.where(iota < lead, first, nxt)
        per_p = {k: [] for k in FIELDS}
        for p, W in zip(sets, Ws):
            feat = jts.precompute_window_features(vb, W, nxt)
            fin = jax.vmap(lambda f, nx, W=W, p=p: jts.nrzi_track_scan_pre(
                f, nx, W, S, nsteps, K, jnp.float32(p.pkww_rise),
                jnp.float32(p.min_peak), jnp.float32(p.agc_alpha),
                jnp.int32(p.agc_window)))(feat, nxt)
            for k in FIELDS:
                per_p[k].append(np.asarray(fin[k]))
        for k in FIELDS:
            out[k].append(np.stack(per_p[k]))
    return {k: np.stack(x) for k, x in out.items()}


def port_inputs(v, Ws, rf, mf, seg_len, lead, masked=True):
    """The port's features [G, B, T, S, 10] and jump tables [B, T, S+1]
    for v [B, T, S] (numpy), as the tiered pipeline builds them."""
    volts = torch.from_numpy(np.array(v))
    B, T, S = volts.shape
    nxt = tfu._union_jump_table(volts, Ws, torch.from_numpy(rf),
                                torch.from_numpy(mf))
    if masked:
        nxt = tfu._mask_jump_table(nxt, torch.full((B,), seg_len),
                                   torch.full((B,), lead), S)
    return tsc.window_features(volts, Ws), nxt.to(torch.int32)


def setup_case(name):
    """(port inputs, scan kwargs, JAX reference) of one case."""
    if name == "density":
        return density_case()
    cfg = _setup(uniform_w=(name == "B5b"))
    v = np.asarray(cfg["v"])
    B, T, S = v.shape
    rf = np.full(T, 0.02, np.float32)
    mf = np.zeros(T, np.float32)
    seg_len, lead, K = S - 700, 64, 512
    feat, nxt = port_inputs(v, cfg["Ws"], rf, mf, seg_len, lead)
    ref = jax_scan(v, cfg["Ws"], cfg["P"], K, S, rf, mf, seg_len, lead)
    kw = dict(Ws=cfg["Ws"], K=K, max_steps=None)
    return feat, nxt, port_parms(cfg["P"]), kw, ref


def density_case():
    """detect_density's scan on two 4096-sample segments under 0.6 V rms
    of noise: W=8, parmset 0, floors at half the AGC ceiling, no mask, the
    XLA budget max(512, S // 4) steps (it stops 8 of the 18 lanes),
    K = max(512, S // 6)."""
    cfg = _setup(B=2)
    rng = np.random.default_rng(5)
    v = np.asarray(cfg["v"]) + rng.normal(
        0.0, 0.6, cfg["v"].shape).astype(np.float32)
    B, T, S = v.shape
    p0 = builtin_parmsets(tb.MODE_NRZI).sets[0]
    rf = np.full(T, p0.pkww_rise / 2 * 0.8, np.float32)
    mf = np.full(T, p0.min_peak / 2 * 0.8, np.float32)
    K, nsteps = max(512, S // 6), max(512, S // 4)
    feat, nxt = port_inputs(v, (8,), rf, mf, S, 0, masked=False)
    ref = jax_scan(v, (8,), 1, K, nsteps, rf, mf, S, 0, masked=False)
    kw = dict(Ws=(8,), K=K, max_steps=tfu.scan_step_budget(nsteps))
    return feat, nxt, port_parms(1), kw, ref


def run_port(name, feat, nxt, pa, kw):
    """The case's wrapper on CPU tensors: its plain version runs."""
    fn, plain = ((tsc.nrzi_track_scan, tsc.nrzi_track_scan_plain)
                 if name == "B5a" else
                 (tsc.nrzi_track_scan_tracks,
                  tsc.nrzi_track_scan_tracks_plain))
    calls = plain.calls
    got = fn(feat, nxt, pa, **kw)
    assert plain.calls == calls + 1 and fn.launches == 0
    return {k: x.numpy() for k, x in got.items()}


@pytest.mark.parametrize("name", ["B5a", "B5b", "density"])
def test_scan_matches_jax_xla(name):
    feat, nxt, pa, kw, ref = setup_case(name)
    if name != "B5a":
        assert feat.shape[0] == 1
    got = run_port(name, feat, nxt, pa, kw)
    for k in FIELDS:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert got["n_admitted"].sum() > 300, "too few admissions"
    # the XLA budget binds on the density case only; nothing overflows K
    assert got["incomplete"].any() == (name == "density")
    assert got["n_admitted"].max() <= kw["K"]


_DRIVER = r"""
#include <math.h>
#include <vector>
#include "nrzi_core.h"
extern "C" void scan_host_run(const NrziScanArgs* a) {
  for (int lane = 0; lane < a->B * a->P * a->T; ++lane) nrzi_scan_lane(*a, lane);
}
// B5b's walk: each lane's table in chunks of C entries
extern "C" void scan_chunk_host_run(const NrziScanArgs* a, int C) {
  const int S = a->S;
  std::vector<uint32_t> words(C / 32);
  std::vector<NrziTableRow> rows(C);
  NrziTableRow poison;
  for (int k = 0; k < NRZI_NFEAT; ++k) poison.r[k] = NAN;
  float heights[NRZI_MAX_AGC_RING];
  for (int lane = 0; lane < a->B * a->P * a->T; ++lane) {
    const NrziTableSrc src = nrzi_scan_src(*a, lane);
    NrziWalk w;
    nrzi_scan_walk_init(w, *a, lane, heights);
    for (int c0 = 0; c0 < S; c0 += C) {
      const int c1 = c0 + C < S ? c0 + C : S;
      for (int i = 0; i < C; ++i) {
        rows[i] = poison;
        if (i % 32 == 0) words[i / 32] = 0;
        if (c0 + i < c1 && src.cand(c0 + i)) {
          words[i / 32] |= 1u << (i % 32);
          rows[i] = src.ft[c0 + i];
        }
      }
      if (!nrzi_walk_chunk(w, words.data(), rows.data(), c0, c1, S, a->max_steps))
        break;
    }
    nrzi_scan_walk_finish(w, *a, lane);
  }
}
extern "C" void slot_host_run(const NrziSlotArgs* a) {
  for (int lane = 0; lane < a->B * a->P; ++lane) nrzi_slot_lane(*a, lane);
}
"""


@pytest.fixture(scope="session")
def tiered_host_lib(tmp_path_factory):
    """csrc/nrzi_core.h's B5 and B6 lanes built for the host."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not available")
    d = tmp_path_factory.mktemp("tiered_host")
    src = d / "driver.cpp"
    src.write_text(_DRIVER)
    so = d / "libtiered_host.so"
    subprocess.run([gxx, "-O2", "-ffp-contract=off", "-std=c++17", "-shared",
                    "-fPIC", "-I", kernels.CSRC, "-o", str(so), str(src)],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    for fn, struct in ((lib.scan_host_run, kernels.NrziScanArgs),
                       (lib.slot_host_run, kernels.NrziSlotArgs)):
        fn.argtypes = [ctypes.POINTER(struct)]
        fn.restype = None
    lib.scan_chunk_host_run.argtypes = [ctypes.POINTER(kernels.NrziScanArgs),
                                        ctypes.c_int]
    lib.scan_chunk_host_run.restype = None
    return lib


@pytest.mark.parametrize("name", ["B5a", "B5b", "density"])
def test_host_scan_lane_matches_plain(tiered_host_lib, name):
    feat, nxt, pa, kw, _ = setup_case(name)
    want = run_port(name, feat, nxt, pa, kw)
    steps = feat.shape[3] + 1 if kw["max_steps"] is None else kw["max_steps"]
    for chunk in ((None,) if name == "B5a" else (256, 64)):
        args, got, keep = kernels.nrzi_scan_prepare(
            feat, nxt, pa, Ws=kw["Ws"], K=kw["K"], max_steps=steps)
        if chunk is None:
            tiered_host_lib.scan_host_run(ctypes.byref(args))
        else:
            tiered_host_lib.scan_chunk_host_run(ctypes.byref(args), chunk)
        del keep
        for k in FIELDS:
            np.testing.assert_array_equal(got[k].numpy(), want[k],
                                          err_msg=f"{k}, chunk {chunk}")
