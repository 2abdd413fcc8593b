"""The port's NRZI admission alone (readtape_tpu_torch.decode.scan: B5a
nrzi_track_scan, B5b nrzi_track_scan_tracks, plain versions on the CPU)
against the JAX package's XLA scan trackscan.nrzi_track_scan_pre run with
nsteps = S, the contract tests/test_pallas_scan.py holds the TPU kernels
to, on that file's inputs (_setup: B=2, S=4096, P=3 with mixed widths, or
one shared width for B5b); plus the density-detection shape (window 8,
parmset 0's knobs, the XLA scan's step budget, no candidate mask) on a
noisy segment where the budget binds, and B5a with all 8 parmsets under
-correctdbg's step budget on segments under 5 mV rms of noise, where it
binds for some parmsets only. The port computes its own window features
and jump tables from the same volts.

Then csrc/nrzi_core.h's B5 blocks, compiled for the host with g++,
against the plain version on the same inputs: the CUDA source's logic
checked without a GPU. Both walk the table chunk by chunk
(nrzi_walk_chunk over each chunk's candidate words, bit s set where
nxt[s] == s, and the feature rows of its candidates only; the other rows
hold NaN), at the kernel's chunk of 256 entries and at one of 64. B5a
runs its blocks' step, nrzi_scan_chunk, as csrc/nrzi_scan.cu does: one
block per (segment, track) and part of the parmsets, each chunk's words
and each width group's rows staged once, then every live walker's walk
over them; on the existing B5a inputs, on the noisy ones, with K = 60
(admissions overflow the buffers) and with 15 parmsets (two parts, six
widths) under a budget that binds on some lanes. B5b's and density
detection's walk each lane as B5b's blocks do.

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


def setup_case(name, ref=True):
    """(port inputs, scan kwargs, JAX reference or None) of one case."""
    if name == "density":
        return density_case(ref)
    if name == "B5a-P15":
        return p15_case()
    noisy = name == "B5a-noisy"
    cfg = _setup(uniform_w=(name == "B5b"), P=8 if noisy else 3)
    v = np.asarray(cfg["v"])
    B, T, S = v.shape
    nsteps = S
    if noisy:
        v = v + np.random.default_rng(5).normal(0.0, 0.005, v.shape).astype(
            np.float32)
        nsteps = 1536
    rf = np.full(T, 0.02, np.float32)
    mf = np.zeros(T, np.float32)
    seg_len, lead = S - 700, 64
    K = 60 if name == "B5a-overflow" else 512
    feat, nxt = port_inputs(v, cfg["Ws"], rf, mf, seg_len, lead)
    want = jax_scan(v, cfg["Ws"], cfg["P"], K, nsteps, rf, mf, seg_len,
                    lead) if ref else None
    kw = dict(Ws=cfg["Ws"], K=K,
              max_steps=tfu.scan_step_budget(nsteps) if noisy else None)
    return feat, nxt, port_parms(cfg["P"]), kw, want


def p15_case():
    """B5a with 15 parmsets, the most a parms file holds: the 8 builtin
    NRZI ones and 7 more with wider windows (bitfrac + 0.15) and a lower
    rise (x 0.6), six widths in all, so the kernel splits them over two
    blocks per (segment, track) (8 + 7, three widths each, two of the
    second's not the first's), on _setup's segments under 5 mV rms of
    noise; a step budget of 1,792 stops about a third of the lanes."""
    import dataclasses
    cfg = _setup(P=8)
    v = np.asarray(cfg["v"]) + np.random.default_rng(7).normal(
        0.0, 0.005, cfg["v"].shape).astype(np.float32)
    B, T, S = v.shape
    base = builtin_parmsets(tb.MODE_NRZI).sets
    sets = base + [dataclasses.replace(
        p, pkww_bitfrac=p.pkww_bitfrac + 0.15, pkww_rise=p.pkww_rise * 0.6)
        for p in base[:7]]
    Ws = tuple(cm.pkww_width_for(p.pkww_bitfrac, 800, 50, 1.28e-6)
               for p in sets)
    feat, nxt = port_inputs(v, Ws, np.full(T, 0.02, np.float32),
                            np.zeros(T, np.float32), S - 700, 64)
    pa = cm.ParmArrays.from_parmsets(ParmSets(sets=sets,
                                              mode=tb.MODE_NRZI), "cpu")
    return feat, nxt, pa, dict(Ws=Ws, K=512, max_steps=1792), None


def density_case(ref=True):
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
    ref = jax_scan(v, (8,), 1, K, nsteps, rf, mf, S, 0,
                   masked=False) if ref else None
    kw = dict(Ws=(8,), K=K, max_steps=tfu.scan_step_budget(nsteps))
    return feat, nxt, port_parms(1), kw, ref


def run_port(name, feat, nxt, pa, kw):
    """The case's wrapper on CPU tensors: its plain version runs."""
    fn, plain = ((tsc.nrzi_track_scan, tsc.nrzi_track_scan_plain)
                 if name.startswith("B5a") else
                 (tsc.nrzi_track_scan_tracks,
                  tsc.nrzi_track_scan_tracks_plain))
    calls = plain.calls
    got = fn(feat, nxt, pa, **kw)
    assert plain.calls == calls + 1 and fn.launches == 0
    return {k: x.numpy() for k, x in got.items()}


@pytest.mark.parametrize("name", ["B5a", "B5b", "density", "B5a-noisy"])
def test_scan_matches_jax_xla(name):
    feat, nxt, pa, kw, ref = setup_case(name)
    if not name.startswith("B5a"):
        assert feat.shape[0] == 1
    got = run_port(name, feat, nxt, pa, kw)
    for k in FIELDS:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert got["n_admitted"].sum() > 300, "too few admissions"
    # the XLA budget binds on the density and noisy cases only; nothing
    # overflows K
    assert got["incomplete"].any() == (name in ("density", "B5a-noisy"))
    assert got["n_admitted"].max() <= kw["K"]
    if name == "B5a-noisy":             # some parmsets only
        cut = got["incomplete"].any(axis=(0, 2))
        assert cut.any() and not cut.all(), cut


_DRIVER = r"""
#include <math.h>
#include <vector>
#include "nrzi_core.h"
// B5a's blocks (nrzi_scan.cu nrzi_scan_kernel), one after another: each
// (segment, track) row and part of the parmsets, its walkers driven chunk
// by chunk at C entries through nrzi_scan_chunk; a row slot holds NaN
// before the step that fills it, so a walk reads rows at candidates only
extern "C" void scan_block_host_run(const NrziScanArgs* a, int C) {
  int pb;
  const int parts = nrzi_scan_parts(a->P, &pb);
  const int ng = a->G < pb ? a->G : pb, nch = (a->S + C - 1) / C;
  std::vector<uint64_t> sm((nrzi_scan_blk_smem(C, ng, pb) + 7) / 8);
  NrziTableRow poison;
  for (int k = 0; k < NRZI_NFEAT; ++k) poison.r[k] = NAN;
  for (int row = 0; row < a->B * a->T; ++row)
    for (int y = 0; y < parts; ++y) {
      const int p0 = y * pb, nw = pb < a->P - p0 ? pb : a->P - p0;
      float* heights;
      const NrziScanBlk k = nrzi_scan_blk(*a, row, p0, nw, C, ng,
                                          (unsigned char*)sm.data(), &heights);
      auto clear = [&](int slot) {
        for (int x = 0; x < k.ng * C; ++x) k.rows[slot * k.ng * C + x] = poison;
      };
      NrziScanWalker w[NRZI_SCAN_MAX_WALK];
      for (int j = 0; j < nw; ++j) nrzi_scan_walker_init(w[j], *a, k, row, p0, j, heights);
      NrziScanSerial ex{w, nw, 0, 1, 0, 1};
      clear(0);
      nrzi_scan_prime(ex, k, nch);
      for (int i = 0; i < nch; ++i) {
        clear((i + 1) & 1);
        if (!nrzi_scan_chunk(ex, k, i, nch, a->max_steps)) break;
      }
      for (int j = 0; j < nw; ++j) nrzi_scan_walk_finish(w[j].w, *a, w[j].lane);
    }
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
    lib.slot_host_run.argtypes = [ctypes.POINTER(kernels.NrziSlotArgs)]
    lib.slot_host_run.restype = None
    for fn in (lib.scan_block_host_run, lib.scan_chunk_host_run):
        fn.argtypes = [ctypes.POINTER(kernels.NrziScanArgs), ctypes.c_int]
        fn.restype = None
    return lib


@pytest.mark.parametrize("name", ["B5a", "B5b", "density", "B5a-noisy",
                                  "B5a-overflow", "B5a-P15"])
def test_host_scan_lane_matches_plain(tiered_host_lib, name):
    feat, nxt, pa, kw, _ = setup_case(name, ref=False)
    want = run_port(name, feat, nxt, pa, kw)
    steps = feat.shape[3] + 1 if kw["max_steps"] is None else kw["max_steps"]
    run = (tiered_host_lib.scan_block_host_run if name.startswith("B5a")
           else tiered_host_lib.scan_chunk_host_run)
    for chunk in (256, 64):
        args, got, keep = kernels.nrzi_scan_prepare(
            feat, nxt, pa, Ws=kw["Ws"], K=kw["K"], max_steps=steps)
        run(ctypes.byref(args), chunk)
        del keep
        for k in FIELDS:
            np.testing.assert_array_equal(got[k].numpy(), want[k],
                                          err_msg=f"{k}, chunk {chunk}")
    # each case's point: the K overflow, the budget binding on some
    # lanes (noisy: on some parmsets only) and not others
    inc, nadm = want["incomplete"], want["n_admitted"]
    if name == "B5a-overflow":
        assert (nadm > kw["K"]).any() and (nadm <= kw["K"]).any()
    elif name in ("B5a-noisy", "B5a-P15"):
        assert not (nadm > kw["K"]).any()
        cut = inc.any(axis=(0, 2)) if name == "B5a-noisy" else inc
        assert cut.any() and not cut.all()
    if name == "B5a-P15":
        assert len(kw["Ws"]) == 15 and feat.shape[0] == 6
