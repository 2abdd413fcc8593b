"""The port's GCR segment batch (pipeline._gcr_group_fused: volts prep,
gcr_fused_scan's plain version on the CPU, gcr_fused_state, gcr_finish)
against the JAX package's _gcr_segment_device (its XLA scans on the CPU),
field for field, on chip_smoke.py's phase-3 GCR segments: clean, noisy,
one weak track, and two blocks behind a short gap (tau inside the
window); B=4, all 5 built-in GCR parmsets, S=16384, with -correct.

Tolerance: none. Integers, frames and every f32 field are exact.
"""

import dataclasses

import numpy as np
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from readtape_tpu.decode import common as jcm
from readtape_tpu.decode import pipeline as jpl
from readtape_tpu.formats import tbin as jtb
from readtape_tpu.formats.parms import builtin_parmsets
from readtape_tpu_torch.decode import common as cm
from readtape_tpu_torch.decode import fused as tfu
from readtape_tpu_torch.decode import pipeline as tpl

torch.set_num_threads(2)

S = 16384


def test_group_matches_gcr_segment_device():
    raw, h_est, deltat, maxvolts = chip_smoke.gcr_segments(S, seed=5)
    B, _, T = raw.shape
    bpi, ips = 9042.0, 25.0
    spb = 1.0 / (bpi * ips * deltat)
    sets = builtin_parmsets(jtb.MODE_GCR).sets
    P = len(sets)
    Ws = tuple(jcm.pkww_width_for(p.pkww_bitfrac, bpi, ips, deltat)
               for p in sets)
    scale = min(1.0, h_est / jcm.PKWW_PEAKHEIGHT)
    rf = np.full(T, min(p.pkww_rise for p in sets) * scale
                 / jcm.AGC_MAX_VALUE * 0.8, np.float32)
    mf = np.full(T, min(p.min_peak for p in sets) * scale
                 / jcm.AGC_MAX_VALUE * 0.8, np.float32)
    lb, bw = jpl._peakstat_bins(jtb.MODE_GCR, 1.0 / (bpi * ips))
    lb, bw = np.float32(lb / deltat), np.float32(bw / deltat)
    nsteps = int(S / spb * 3.2) + 64
    maxb = int(S / spb * 1.3) + 64
    lead = 64

    jpa = jcm.ParmArrays.from_parmsets(builtin_parmsets(jtb.MODE_GCR))
    run = jax.jit(jax.vmap(
        lambda v: jpl._gcr_segment_device(
            v, jnp.int32(S), jnp.int32(lead), jnp.float32(maxvolts),
            jnp.float32(1.0), jnp.zeros(T, jnp.int32), jpa,
            jnp.float32(spb), jnp.int32(1), jnp.int32(0), jnp.asarray(rf),
            jnp.asarray(mf), jnp.float32(lb), jnp.float32(bw), S=S, T=T,
            P=P, nsteps=nsteps, maxb=maxb, Ws=Ws, do_correct=True,
            do_correct2=False, find_zeros=False, differentiate=False,
            spb_int=int(spb), clk_ring=max(p.clk_window for p in sets),
            agc_ring=max(max(p.agc_window for p in sets), 1),
            skew_on=False)))
    want = jax.tree.map(np.asarray,
                        run(jnp.asarray(raw.transpose(0, 2, 1))))

    pa = cm.ParmArrays.from_numpy(
        {f.name: np.asarray(getattr(jpa, f.name))
         for f in dataclasses.fields(jpa)}, "cpu")
    tape = torch.from_numpy(np.ascontiguousarray(
        raw.transpose(2, 0, 1).reshape(T, B * S)))
    calls = tfu.gcr_fused_scan_plain.calls
    got = tpl._gcr_group_fused(
        tape, torch.arange(B) * S, torch.full((B,), S, dtype=torch.int32),
        torch.full((B,), lead, dtype=torch.int32), maxvolts, 1.0,
        torch.zeros(T, dtype=torch.int32), pa, spb, 1, 0,
        torch.from_numpy(rf), torch.from_numpy(mf), float(lb), float(bw),
        S=S, T=T, maxb=maxb, max_steps=tfu.scan_step_budget(nsteps), Ws=Ws,
        do_correct=True, do_correct2=False, differentiate=False,
        spb_int=int(spb), skew_on=False)
    assert tfu.gcr_fused_scan_plain.calls == calls + 1       # CPU: plain

    assert set(got) == set(want)
    for k in want:
        w = want[k]
        if k == "event_overflow":         # per segment; per lane in the port
            w = np.broadcast_to(w[:, None], (B, P))
        np.testing.assert_array_equal(got[k].numpy().astype(w.dtype), w,
                                      err_msg=k)
    # the segments decode, and the two-block one ends inside its window
    assert (want["blktype"][0] == tpl.nrzi_mod.BS_BLOCK).all()
    assert (want["end_s"][3] < S).all() and (want["unconsumed"][3] > 0).all()
    assert (want["errcount"][1:3] > 0).any()
