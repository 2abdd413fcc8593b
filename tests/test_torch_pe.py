"""The port's PE modules (readtape_tpu_torch.decode.pe and the PE batch of
decode.fused / decode.pipeline, plain versions on the CPU) against the JAX
package on the CPU, where its TapeDecoder runs _pe_segment_device (the XLA
scans; its fuzzed reference semantics). Same numpy inputs on both sides,
the same three parmsets (ParmArrays.from_numpy of the JAX ParmArrays).

Tolerance: none. Integers, bits and every f32 field are exact.

Cases (S <= 16384, P = 3): a clean 3-block tape, one block under noise
and amplitude jitter, and two blocks whose gap is active but quiet, so
one segment holds both and the all-idle point tau falls inside it.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from readtape_tpu.decode import common as jcm
from readtape_tpu.decode import pe as jpe
from readtape_tpu.decode import pipeline as jpl
from readtape_tpu.decode import trackscan as jts
from readtape_tpu.formats import tbin as tb
from readtape_tpu.formats.parms import ParmSets, builtin_parmsets
from readtape_tpu.synth import default_spec, synthesize_tape
from readtape_tpu_torch.decode import common as cm
from readtape_tpu_torch.decode import fused as tfu
from readtape_tpu_torch.decode import pe as tpe
from readtape_tpu_torch.decode import pipeline as tpl

torch.set_num_threads(2)

SETS = (0, 2, 5)          # exponential clock; moving windows of 3 and 5

# every field _pe_segment_device returns
FIELDS = ("blktype", "minbits", "maxbits", "track_mismatch", "vparity_errs",
          "crc_errs", "lrc_errs", "errcount", "warncount", "missed_midbits",
          "corrected_bits", "faked_tracks", "avg_bit_spacing", "frames",
          "faked_frames", "hist", "trksums", "consume_overflow",
          "alltrk_max_agc", "alltrk_min_agc", "event_overflow", "end_s",
          "tau_gaveup", "scan_incomplete", "consumed", "unconsumed",
          "cand_after", "cand_race")


def _tape(case):
    if case == "clean":
        rng = np.random.default_rng(30)
        blocks = [bytes(rng.integers(0, 256, 120, dtype=np.uint8))
                  for _ in range(3)]
        spec = default_spec(tb.MODE_PE, ibg_secs=0.002, start_gap_secs=0.002)
        return synthesize_tape(spec, [("block", b) for b in blocks])
    if case == "noisy":
        rng = np.random.default_rng(31)
        spec = default_spec(tb.MODE_PE, noise_rms=0.05, amp_jitter=0.1,
                            ibg_secs=0.002, start_gap_secs=0.002, seed=31)
        return synthesize_tape(
            spec, [("block", bytes(rng.integers(0, 256, 200,
                                                dtype=np.uint8)))])
    # two blocks behind a 0.6 ms gap that holds a flat 0.5 V level on
    # track 0: the gap is active, so one segment covers both blocks, but
    # has no peaks, so every track goes idle after the first block
    rng = np.random.default_rng(89)
    blocks = [bytes(rng.integers(0, 256, 90, dtype=np.uint8))
              for _ in range(2)]
    spec = default_spec(tb.MODE_PE, ibg_secs=0.0006, start_gap_secs=0.003)
    hdr, samples = synthesize_tape(spec, [("block", b) for b in blocks])
    opts = tpl.DecodeOptions(mode=tb.MODE_PE, ntrks=9, bpi=1600, ips=50,
                             deltat=hdr.tdelta_ns * 1e-9,
                             maxvolts=hdr.maxvolts)
    (_, b1), (a2, _) = tpl.TapeDecoder(samples, opts,
                                       device="cpu").segments()
    samples = np.array(samples)
    # from one bit after block 1's activity to one bit before block 2's
    spb = opts.spb
    samples[b1 - int(2 * spb):a2 + int(spb), 0] += np.int16(
        0.5 / hdr.maxvolts * 32767)
    return hdr, samples


def _decoders(case):
    hdr, samples = _tape(case)
    sets = [builtin_parmsets(tb.MODE_PE).sets[i] for i in SETS]
    kw = dict(mode=tb.MODE_PE, ntrks=9, bpi=1600, ips=50,
              deltat=hdr.tdelta_ns * 1e-9, maxvolts=hdr.maxvolts,
              parmsets=ParmSets(sets=sets, mode=tb.MODE_PE))
    jdec = jpl.TapeDecoder(samples, jpl.DecodeOptions(**kw))
    tdec = tpl.TapeDecoder(samples, tpl.DecodeOptions(**kw), device="cpu")
    segs = jdec.segments()
    assert tdec.segments() == segs
    return jdec, tdec, segs


@pytest.fixture(scope="module", params=["clean", "noisy", "tau"])
def case(request):
    jdec, tdec, segs = _decoders(request.param)
    jres = jax.tree.map(lambda x: np.asarray(x)[0],
                        jdec.decode_segment_batch(segs))
    calls = tfu.pe_fused_scan_plain.calls
    tres = tdec.decode_segment_batch(segs)
    assert tfu.pe_fused_scan_plain.calls == calls + 1       # CPU: plain
    return request.param, jdec, tdec, segs, jres, tres


def test_segment_batch_matches_pe_segment_device(case):
    name, _, _, segs, jres, tres = case
    assert set(FIELDS) <= set(jres)
    assert set(tres) == set(jres)
    for k in FIELDS:
        np.testing.assert_array_equal(np.asarray(tres[k]).astype(
            np.asarray(jres[k]).dtype), jres[k], err_msg=f"{name} {k}")
    S = jpl.seg.bucket_length(max(b - max(a - 64, 0) for a, b in segs))
    seg_len = np.asarray([b - max(a - 64, 0) for a, b in segs])[:, None]
    if name == "tau":
        # one segment holds both blocks: its lanes end at the first
        # all-idle point, with admissions left over for the walk
        assert len(segs) == 1 and (jres["end_s"] < seg_len).all()
        assert (jres["unconsumed"] > 0).all()
    else:
        assert (jres["blktype"] == tpe.BS_BLOCK).any()
    assert (jres["end_s"] < S).all()


def _jax_finals(jdec, segs, i):
    """_pe_segment_device's per-track scans of segment i up to the
    finals (stacked [P, T]), with the volts and knobs it used."""
    opts = jdec.opts
    a, b = segs[i]
    a0 = max(a - 64, 0)
    S = jpl.seg.bucket_length(max(b_ - max(a_ - 64, 0) for a_, b_ in segs))
    T = opts.ntrks
    tape = jdec._tape_padded(a0 + S)
    v = jpl._prep_volts(tape[:, a0:a0 + S], jnp.float32(opts.maxvolts),
                        jnp.float32(1.0), jnp.zeros(T, jnp.int32), S=S, T=T,
                        differentiate=False, spb_int=int(opts.spb),
                        apply_skew=False)
    spb = opts.spb
    sets = opts.parmsets.sets
    Ws = tuple(jcm.pkww_width_for(p.pkww_bitfrac, opts.bpi, opts.ips,
                                  opts.deltat) for p in sets)
    scale = min(1.0, jdec.h_est / jcm.PKWW_PEAKHEIGHT)
    rf = jnp.full(T, min(p.pkww_rise for p in sets) * scale
                  / jcm.AGC_MAX_VALUE * 0.8,
                  jnp.float32)
    mf = jnp.full(T, min(p.min_peak for p in sets) * scale
                  / jcm.AGC_MAX_VALUE * 0.8,
                  jnp.float32)
    lb, bw = jpl._peakstat_bins(tb.MODE_PE, 1.0 / (opts.bpi * opts.ips))
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
            lambda ft, nx, tv, sf: jpe.pe_track_scan(
                ft, nx, W, S, nsteps, pa.pkww_rise[p], pa.min_peak[p],
                pa.agc_alpha[p], pa.agc_window[p], pa.clk_window[p],
                pa.clk_alpha[p], pa.clk_factor[p], pa.pulse_adj[p],
                jnp.float32(spb), maxb, jnp.float32(lb), jnp.float32(bw),
                clk_ring=max(max(q.clk_window for q in sets), 1),
                agc_ring=max(max(q.agc_window for q in sets), 1), pre=True,
                idle_out=True, t_lp_virtual=tv, s_first_check=sf))
        finals.append(lane(feat, nxt, (lead + trk).astype(jnp.float32),
                           lead + trk + 1))
    finals = jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]),
                          *finals)
    knobs = dict(Ws=Ws, rise_floor=torch.from_numpy(np.array(rf)),
                 min_floor=torch.from_numpy(np.array(mf)),
                 stat_lb=float(lb), stat_bw=float(bw), spb=spb, maxb=maxb,
                 max_steps=tfu.scan_step_budget(nsteps))
    return (np.array(v), seg_len, lead, finals, knobs)


def _port_pa(jdec):
    return cm.ParmArrays.from_numpy(
        {f.name: np.asarray(getattr(jdec.pa, f.name))
         for f in dataclasses.fields(jdec.pa)}, "cpu")


def test_track_scan_tau_replay_and_finish(case):
    """pe_track_scan(idle_out) lane by lane, then pe_idle_tau,
    pe_apply_tau and pe_finish fed the JAX package's own intermediate
    values, on the case's last segment."""
    name, jdec, _, segs, jres, _ = case
    i = len(segs) - 1
    v, seg_len, lead, jf, knobs = _jax_finals(jdec, segs, i)
    maxb = knobs["maxb"]
    fin, _ = tfu.pe_scan_lanes(
        torch.from_numpy(v)[None], torch.tensor([seg_len]),
        torch.tensor([lead]), _port_pa(jdec), **knobs)
    # the scans: idle streams, counts and every admitted record
    for k in ("ie_e", "ie_w", "n_ie", "ie_trail", "incomplete",
              "n_admitted"):
        np.testing.assert_array_equal(fin[k].numpy(), jf[k], err_msg=k)
    adm_j, adm_t = jf["_st_adm"], fin["_st_adm"].numpy()
    for p in range(len(SETS)):
        for t in range(9):
            for k in tpe.STREAMS:
                np.testing.assert_array_equal(
                    fin["_st_" + k][p, t].numpy()[adm_t[p, t]],
                    jf["_st_" + k][p, t][adm_j[p, t]],
                    err_msg=f"{name} p{p} t{t} {k}")

    # tau from the JAX intervals, as _pe_segment_device builds them
    C = jpe.IDLE_CAP
    n_c = np.minimum(jf["n_ie"], C)
    e = jf["ie_e"].copy()
    for p in range(len(SETS)):
        for t in range(9):
            if n_c[p, t] < C:
                e[p, t, n_c[p, t]] = jf["ie_trail"][p, t]
    valid = np.arange(C)[None, None, :] <= n_c[..., None]
    jtau = np.asarray([jpe.pe_idle_tau(e[p], jf["ie_w"][p], valid[p])
                       for p in range(len(SETS))])
    ttau = tpe.pe_idle_tau(torch.from_numpy(e), torch.from_numpy(jf["ie_w"]),
                           torch.from_numpy(valid)).numpy()
    np.testing.assert_array_equal(ttau, jtau)
    ltau, _ = tpe.lane_tau(*(torch.from_numpy(jf[k]) for k in
                             ("ie_e", "ie_w", "n_ie", "ie_trail")))
    np.testing.assert_array_equal(ltau.numpy(), np.minimum(jtau, 2 ** 30))
    np.testing.assert_array_equal(np.minimum(jtau, seg_len),
                                  jres["end_s"][i])

    # truncation at tau and block assembly
    jtr = [jax.tree.map(np.asarray, jpe.pe_apply_tau(
        jax.tree.map(lambda x: x[p], jf), maxb, 0, jtau[p]))
        for p in range(len(SETS))]
    streams = {k: torch.from_numpy(jf[k]) for k in jf
               if k.startswith("_st_")}
    streams["incomplete"] = torch.from_numpy(jf["incomplete"])
    ttr = tpe.pe_apply_tau(streams, maxb, torch.from_numpy(jtau))
    for p in range(len(SETS)):
        for k in ("bits", "faked", "hist", "trksum", "peakcount",
                  "datacount", "t_firstbit", "t_lastbit", "max_agc_gain",
                  "min_agc_gain", "corrected_bits", "incomplete",
                  "n_consumed", "n_total"):
            np.testing.assert_array_equal(ttr[k][p].numpy(), jtr[p][k],
                                          err_msg=f"{name} p{p} {k}")
        want = jax.tree.map(np.asarray, jpe.pe_finish(jtr[p], 9, 1, 0, maxb))
        got = tpe.pe_finish({k: torch.from_numpy(np.array(x))
                             for k, x in jtr[p].items()}, 9, 1, 0, maxb)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]), want[k],
                                          err_msg=f"{name} p{p} {k}")
