"""The port's GCR module (readtape_tpu_torch.decode.gcr, plain versions on
the CPU) against the JAX package's readtape_tpu.decode.gcr on the CPU
(its XLA scans), function by function, on the same numpy inputs.

Tolerance: none. Integers, bits and every f32 field are exact.

Cases: the per-track scan (``pre=True, idle_out=True``) on two one-segment
tapes -- one clean block, and two blocks behind a gap that holds a flat
level on track 0, so the segment covers both, every track goes idle
after the first block and re-seeds on the second; the truncation at the
lane's all-idle point and at BIG_TAU; the ECC algebra for every 1- and
2-track mask; the group postprocess over synthesized storage bits with
injected errors, with and without -correct/-correct2; gcr_finish.
"""

import dataclasses
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from readtape_tpu.decode import common as jcm
from readtape_tpu.decode import gcr as jgcr
from readtape_tpu.decode import pe as jpe
from readtape_tpu.decode import pipeline as jpl
from readtape_tpu.decode import trackscan as jts
from readtape_tpu.formats import tbin as tb
from readtape_tpu.formats.parms import ParmSets, builtin_parmsets
from readtape_tpu.synth import default_spec, synthesize_tape
from readtape_tpu.synth.synthesize import gcr_storage_bits
from readtape_tpu_torch.decode import common as cm
from readtape_tpu_torch.decode import fused as tfu
from readtape_tpu_torch.decode import gcr as tgcr
from readtape_tpu_torch.decode import pe as tpe

torch.set_num_threads(2)

SETS = (0, 3, 4)          # exponential clocks and a moving window of 10


def _tape(case):
    if case == "clean":
        rng = np.random.default_rng(40)
        spec = default_spec(tb.MODE_GCR, ibg_secs=0.002, start_gap_secs=0.002)
        return synthesize_tape(
            spec, [("block", bytes(rng.integers(0, 256, 300,
                                                dtype=np.uint8)))])
    # two blocks behind a 0.5 ms gap that holds a flat 0.5 V level on
    # track 0: the gap is active, so one segment covers both blocks
    rng = np.random.default_rng(91)
    blocks = [bytes(rng.integers(0, 256, 80, dtype=np.uint8))
              for _ in range(2)]
    spec = default_spec(tb.MODE_GCR, ibg_secs=0.0005, start_gap_secs=0.003)
    hdr, samples = synthesize_tape(spec, [("block", b) for b in blocks])
    opts = jpl.DecodeOptions(mode=tb.MODE_GCR, ntrks=9, bpi=9042, ips=25,
                             deltat=hdr.tdelta_ns * 1e-9,
                             maxvolts=hdr.maxvolts)
    (_, b1), (a2, _) = jpl.TapeDecoder(samples, opts).segments()
    samples = np.array(samples)
    spb = opts.spb
    samples[b1 - int(7 * spb):a2 + int(spb), 0] += np.int16(
        0.5 / hdr.maxvolts * 32767)
    return hdr, samples


def _jax_finals(case):
    """A one-segment tape's per-track GCR scans as _gcr_segment_device
    runs them (stacked [P, T]), with the port-side arguments."""
    hdr, samples = _tape(case)
    sets = [builtin_parmsets(tb.MODE_GCR).sets[i] for i in SETS]
    opts = jpl.DecodeOptions(mode=tb.MODE_GCR, ntrks=9, bpi=9042, ips=25,
                             deltat=hdr.tdelta_ns * 1e-9,
                             maxvolts=hdr.maxvolts,
                             parmsets=ParmSets(sets=sets, mode=tb.MODE_GCR))
    jdec = jpl.TapeDecoder(samples, opts)
    segs = jdec.segments()
    assert len(segs) == 1, segs
    a, b = segs[0]
    a0 = max(a - 64, 0)
    S = jpl.seg.bucket_length(b - a0)
    T = 9
    tape = jdec._tape_padded(a0 + S)
    v = jpl._prep_volts(tape[:, a0:a0 + S], jnp.float32(opts.maxvolts),
                        jnp.float32(1.0), jnp.zeros(T, jnp.int32), S=S, T=T,
                        differentiate=False, spb_int=int(opts.spb),
                        apply_skew=False)
    spb = opts.spb
    Ws = tuple(jcm.pkww_width_for(p.pkww_bitfrac, opts.bpi, opts.ips,
                                  opts.deltat) for p in sets)
    scale = min(1.0, jdec.h_est / jcm.PKWW_PEAKHEIGHT)
    rf = jnp.full(T, min(p.pkww_rise for p in sets) * scale
                  / jcm.AGC_MAX_VALUE * 0.8, jnp.float32)
    mf = jnp.full(T, min(p.min_peak for p in sets) * scale
                  / jcm.AGC_MAX_VALUE * 0.8, jnp.float32)
    lb, bw = jpl._peakstat_bins(tb.MODE_GCR, 1.0 / (opts.bpi * opts.ips))
    lb, bw = np.float32(lb / opts.deltat), np.float32(bw / opts.deltat)
    nsteps = int(S / spb * 3.2) + 64
    maxb = int(S / spb * 1.3) + 64
    seg_len, lead = b - a0, a - a0
    trk = jnp.arange(T, dtype=jnp.int32)
    nxt_union = jpl._union_jump_table(v, Ws, rf, mf)
    pa = jdec.pa
    finals = []
    for p, W in enumerate(Ws):
        nxt = jpl._mask_jump_table(nxt_union, seg_len, lead + trk + W - 1, S)
        feat = jts.precompute_window_features(v, W, nxt)
        lane = jax.vmap(
            lambda ft, nx, sf: jgcr.gcr_track_scan(
                ft, nx, W, S, nsteps, pa.pkww_rise[p], pa.min_peak[p],
                pa.agc_alpha[p], pa.agc_window[p], pa.clk_window[p],
                pa.clk_alpha[p], pa.z1pt[p], pa.z2pt[p], pa.pulse_adj[p],
                jnp.float32(spb), maxb, jnp.float32(lb), jnp.float32(bw),
                clk_ring=max(max(q.clk_window for q in sets), 1),
                agc_ring=max(max(q.agc_window for q in sets), 1), pre=True,
                idle_out=True, s_first_check=sf))
        finals.append(lane(feat, nxt, lead + trk + 1))
    finals = jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]),
                          *finals)
    pa_t = cm.ParmArrays.from_numpy(
        {f.name: np.asarray(getattr(pa, f.name))
         for f in dataclasses.fields(pa)}, "cpu")
    knobs = dict(Ws=Ws, rise_floor=torch.from_numpy(np.array(rf)),
                 min_floor=torch.from_numpy(np.array(mf)),
                 stat_lb=float(lb), stat_bw=float(bw), spb=spb, maxb=maxb,
                 max_steps=tfu.scan_step_budget(nsteps))
    return np.array(v), seg_len, lead, finals, pa_t, knobs


@pytest.fixture(scope="module", params=["clean", "tau"])
def scans(request):
    v, seg_len, lead, jf, pa, knobs = _jax_finals(request.param)
    fin, _ = tfu.gcr_scan_lanes(
        torch.from_numpy(v)[None], torch.tensor([seg_len]),
        torch.tensor([lead]), pa, **knobs)
    return request.param, seg_len, jf, fin, knobs


def test_track_scan_matches(scans):
    """Every admitted record, the idle intervals, counts and the trailing
    entry of every (parmset, track) lane."""
    name, seg_len, jf, fin, _ = scans
    for k in ("ie_e", "ie_w", "n_ie", "ie_trail", "incomplete",
              "n_admitted"):
        np.testing.assert_array_equal(fin[k].numpy(), jf[k],
                                      err_msg=f"{name} {k}")
    adm_j, adm_t = jf["_st_adm"], fin["_st_adm"].numpy()
    for p in range(len(SETS)):
        for t in range(9):
            for k in tgcr.STREAMS:
                np.testing.assert_array_equal(
                    fin["_st_" + k][p, t].numpy()[adm_t[p, t]],
                    jf["_st_" + k][p, t][adm_j[p, t]],
                    err_msg=f"{name} p{p} t{t} {k}")
    if name == "tau":
        # every track went idle after the first block and re-seeded
        assert (jf["n_ie"] >= 1).all()


def _jax_tau(jf):
    C = jpe.IDLE_CAP
    n_c = np.minimum(jf["n_ie"], C)
    e = jf["ie_e"].copy()
    for p in range(e.shape[0]):
        for t in range(9):
            if n_c[p, t] < C:
                e[p, t, n_c[p, t]] = jf["ie_trail"][p, t]
    valid = np.arange(C)[None, None, :] <= n_c[..., None]
    return np.asarray([jpe.pe_idle_tau(e[p], jf["ie_w"][p], valid[p])
                       for p in range(e.shape[0])])


@pytest.mark.parametrize("where", ["tau", "big_tau"])
def test_apply_tau_and_finish(scans, where):
    """gcr_apply_tau at the lanes' all-idle point (inside the window on
    the two-block tape) and at BIG_TAU, then gcr_finish, fed the JAX
    package's own scan records."""
    name, seg_len, jf, _, knobs = scans
    maxb = knobs["maxb"]
    P = len(SETS)
    jtau = _jax_tau(jf)
    ttau, _ = tpe.lane_tau(*(torch.from_numpy(jf[k]) for k in
                             ("ie_e", "ie_w", "n_ie", "ie_trail")))
    np.testing.assert_array_equal(ttau.numpy(), np.minimum(jtau, 2 ** 30))
    left = jf["_st_adm"] & (jf["_st_s_det"] >= jtau[:, None, None])
    if name == "tau":
        # the second block's admissions lie past the all-idle point
        assert (jtau < seg_len).all() and left.any(axis=(1, 2)).all()
    if where == "big_tau":
        jtau = np.full(P, jpe.BIG_TAU, np.int32)
    jtr = [jax.tree.map(np.asarray, jgcr.gcr_apply_tau(
        jax.tree.map(lambda x: x[p], jf), maxb, jtau[p])) for p in range(P)]
    streams = {k: torch.from_numpy(jf[k]) for k in jf if k.startswith("_st_")}
    streams["incomplete"] = torch.from_numpy(jf["incomplete"])
    ttr = tgcr.gcr_apply_tau(streams, maxb, torch.from_numpy(jtau))
    for p in range(P):
        for k in jtr[p]:
            np.testing.assert_array_equal(ttr[k][p].numpy(), jtr[p][k],
                                          err_msg=f"{name} p{p} {k}")
        want = jax.tree.map(np.asarray, jax.jit(
            lambda f: jgcr.gcr_finish(f, 9, 1, 0, False, maxb))(jtr[p]))
        got = tgcr.gcr_finish({k: torch.from_numpy(np.array(x))
                               for k, x in jtr[p].items()}, 9, 1, 0, False,
                              maxb)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]), want[k],
                                          err_msg=f"{name} p{p} {k}")
        assert int(want["blktype"]) == tgcr.BS_BLOCK


def _tom_masks():
    bits = [1 << b for b in range(9)]
    return bits + [a | b for i, a in enumerate(bits) for b in bits[i + 1:]]


def test_correct_errors_every_mask():
    """gcr_correct_errors on one random ECC-consistent group with each 1-
    and 2-track mask, clean and with those tracks corrupted; and
    gcr_compute_ecc_vec on random frames."""
    rng = np.random.default_rng(7)
    data = rng.integers(0, 256, 7)
    frames = [(int(d) << 1) | (1 - bin(int(d)).count("1") % 2) for d in data]
    ecc = int(jgcr.gcr_compute_ecc_vec(jnp.asarray(frames, jnp.int32)))
    frames.append((ecc << 1) | (1 - bin(ecc).count("1") % 2))
    clean = np.asarray(frames, np.int32)
    masks = _tom_masks()
    groups = [clean]
    for m in masks:
        # corrupt the tracks of the mask (tom bit 7 - t = data track t,
        # bit 8 = parity = frame bit 0) in a few random frames
        g = clean.copy()
        for b in range(9):
            if (m >> b) & 1:
                fbit = 0 if b == 8 else b + 1
                g ^= (rng.integers(0, 2, 8) << fbit).astype(np.int32)
        groups.append(g)
    groups = np.stack(groups)                               # [G, 8]
    mm = np.asarray(masks + [0x01], np.int32)
    gg = np.repeat(groups[None], len(mm), axis=0).reshape(-1, 8)
    mm = np.repeat(mm, len(groups))
    jok, jfixed = jax.jit(jax.vmap(jgcr.gcr_correct_errors))(
        jnp.asarray(gg), jnp.asarray(mm))
    ok, fixed = tgcr.gcr_correct_errors(torch.from_numpy(gg),
                                        torch.from_numpy(mm))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(fixed.numpy(), np.asarray(jfixed))
    assert not np.asarray(jok).all() and (np.asarray(jfixed) != gg).any()
    f7 = rng.integers(0, 512, (64, 7)).astype(np.int32)
    np.testing.assert_array_equal(
        tgcr.gcr_compute_ecc_vec(torch.from_numpy(f7)).numpy(),
        np.asarray(jax.vmap(jgcr.gcr_compute_ecc_vec)(jnp.asarray(f7))))


def _storage_lanes(n_lanes=6, maxb=None):
    """Synthesized GCR storage bits of several blocks [L, 9, maxb] with
    injected bit flips (single tracks, track pairs, burst) and their
    maxbits."""
    rng = np.random.default_rng(12)
    spec = default_spec(tb.MODE_GCR)
    lanes, dcs = [], []
    for i in range(n_lanes):
        data = bytes(rng.integers(0, 256, [154, 100, 33, 210, 7, 64][i],
                                  dtype=np.uint8))
        trk = gcr_storage_bits(data, spec)
        n = max(len(t) for t in trk)
        bits = np.zeros((9, n), np.int8)
        for t in range(9):
            bits[t, :len(trk[t])] = trk[t]
        if i in (1, 3, 4):                      # one bad track
            pos = rng.integers(40, n - 40, 3)
            bits[2, pos] ^= 1
        if i in (2, 3):                         # two bad tracks, one pair
            pos = rng.integers(60, n - 60)
            bits[5, pos] ^= 1
            bits[7, pos + 2] ^= 1
        if i == 5:                              # a burst on one track
            bits[0, n // 2:n // 2 + 6] ^= 1
        lanes.append(bits)
        dcs.append(n)
    maxb = maxb or max(dcs) + 64
    out = np.zeros((n_lanes, 9, maxb), np.int8)
    for i, b in enumerate(lanes):
        out[i, :, :b.shape[1]] = b
    return out, np.asarray(dcs, np.int32), maxb


@pytest.mark.parametrize("correct", [(False, False), (True, False),
                                     (True, True)])
def test_postprocess_with_errors(correct):
    do_correct, do_correct2 = correct
    bits, dcs, maxb = _storage_lanes()
    got = tgcr.gcr_postprocess(torch.from_numpy(bits), torch.from_numpy(dcs),
                               1, do_correct, maxb, do_correct2=do_correct2)
    want = jax.tree.map(np.asarray, jax.jit(jax.vmap(partial(
        jgcr.gcr_postprocess, expected_parity=1, do_correct=do_correct,
        maxb=maxb, do_correct2=do_correct2)))(
            jnp.asarray(bits), jnp.repeat(jnp.asarray(dcs)[:, None], 9, 1),
            jnp.asarray(dcs)))
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    assert (want["vparity_errs"] > 0).any()
    if do_correct:
        assert want["corrected_bits"].sum() > 0, "no pair was corrected"


def test_finish_batched():
    """gcr_finish over [lanes, T] at once: clean and damaged blocks, a
    tapemark-sized and a noise-sized lane."""
    bits, dcs, maxb = _storage_lanes()
    L = len(dcs)
    rng = np.random.default_rng(5)
    dc = np.repeat(dcs[:, None], 9, axis=1)
    dc[1, 3] -= 5                                     # a track mismatch
    dc[4] = [300, 0, 320, 1, 0, 280, 300, 310, 300]    # tapemark shape
    dc[5] = [8, 3, 0, 0, 1, 2, 0, 0, 0]                # noise
    st = dict(bits=bits, datacount=dc.astype(np.int32),
              peakcount=dc.astype(np.int32) // 2,
              t_firstbit=rng.uniform(0, 100, (L, 9)).astype(np.float32),
              t_lastbit=rng.uniform(1000, 9000, (L, 9)).astype(np.float32),
              max_agc_gain=rng.uniform(1, 2, (L, 9)).astype(np.float32),
              min_agc_gain=rng.uniform(0.5, 1, (L, 9)).astype(np.float32),
              hist=rng.integers(0, 9, (L, 9, 50)).astype(np.int32),
              trksum=rng.integers(0, 900, (L, 9)).astype(np.int32),
              incomplete=np.zeros((L, 9), bool))
    st["peakcount"][4] = [150, 2, 160, 1, 0, 140, 150, 155, 150]
    got = tgcr.gcr_finish({k: torch.from_numpy(v) for k, v in st.items()},
                          9, 1, 0, True, maxb)
    want = jax.tree.map(np.asarray, jax.jit(jax.vmap(
        lambda f: jgcr.gcr_finish(f, 9, 1, 0, True, maxb)))(
            {k: jnp.asarray(v) for k, v in st.items()}))
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    assert set(want["blktype"].tolist()) >= {tgcr.BS_BLOCK, tgcr.BS_BADBLOCK, tgcr.BS_TAPEMARK,
                     tgcr.BS_NOISE}
