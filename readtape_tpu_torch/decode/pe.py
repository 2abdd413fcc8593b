"""PE decoder (9-track 1600 BPI phase encoding) -- counterpart of
readtape_tpu/decode/pe.py.

PE is self-clocking per track (decode_pe.c): each track detects its
preamble (>= 70 zero peaks, then a missed-clock 1-bit, with automatic
polarity), classifies the following transitions as clock or data, bridges
dropouts with fake bits, and the block ends the first time every track is
idle at once (pe_end_of_block, decoder.c:868-877).

This is the PLAIN version that the pe_fused_scan kernel is held against
(decode/fused.py): the per-track admission scan with the PE state machine
(``pe_track_scan``, the ``pre=True, idle_out=True`` form of the JAX
package), the cross-track all-idle point (``pe_idle_tau``), the replay of
each track's records truncated there (``pe_apply_tau``,
``pe_replay_streams``) and block assembly (``pe_finish``), all vectorized
over lanes. Operation order follows the JAX functions exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import telemetry
from . import common as cm
from . import trackscan
from .common import F32, I32
from .nrzi import BS_BLOCK, BS_NOISE, BS_TAPEMARK, f32_to_i32, seq_sum

RUN_CAP = 128        # fake-bit runs replayed per track (compact_outputs rule)
IDLE_CAP = 510       # idle-entry intervals kept per track
IDLE_ECAP = 128      # idle entries per track tested as all-idle candidates
BIG_TAU = 2 ** 30

# per-step records pe_track_scan streams out (step axis last)
STREAMS = ("adm", "s_det", "widx", "bitval", "run_start", "run_len",
           "run_bit", "run_valid", "hb", "t_fb", "t_lb", "agc_mx", "agc_mn")
# and with debug=True the -trace records (the JAX package's debug_peaks):
# the peak time, top or bottom, data or clock, the clock window after it
DEBUG_STREAMS = ("t_pk", "top", "isdata", "clkw")


def idle_entry_sample(t_lp, thr, s_floor):
    """First integer sample s >= s_floor where (f32(s) - t_lp) > thr: the
    sample at which the reference's per-sample idle check (decoder.c:868)
    first fires after a peak at t_lp. Four integer probes around
    floor(t_lp + thr), with the scan's own f32 compare."""
    c = torch.floor(t_lp + thr).to(I32)
    offs = c.unsqueeze(-1) - 1 + torch.arange(4, dtype=I32, device=c.device)
    pred = (offs.to(F32) - t_lp.unsqueeze(-1)) > thr.unsqueeze(-1)
    first = pred.to(torch.int8).argmax(dim=-1).to(I32)
    e = torch.where(pred.any(dim=-1), c - 1 + first, c + 2)
    return torch.maximum(e, s_floor)


def pe_track_scan(feat, src, nxt, nsrc, W, S: int, max_steps: int,
                  rise_parm, min_parm, agc_alpha, agc_window, clk_window,
                  clk_alpha, clk_factor, pulse_adj_parm, spb: float,
                  maxb: int, stat_lb: float, stat_bw: float, t_lp_virtual,
                  s_first_check, clk_ring: int, agc_ring: int,
                  debug: bool = False):
    """PE admission scan for N (segment x parmset x track) lanes at once,
    over precomputed window features: feat [M, S, 10] with lane rows src
    [N], masked jump tables nxt [M2, S+1] with lane rows nsrc [N]; W, the
    parmset knobs, t_lp_virtual (the pre-first-peak t_lastpeak) and
    s_first_check are [N]. Returns the final state with the per-step
    records (STREAMS, each [N, steps]) and the track's idle intervals:
    ie_e/ie_w [N, IDLE_CAP] (entry sample, waking detection), n_ie and
    the trailing entry ie_trail after the last admission. debug: the JAX
    package's -trace scan, whose exponential clock XLA contracts as
    fma(1 - a, avg, a * delta), with the DEBUG_STREAMS too (debug_peaks
    compacts them)."""
    N = src.shape[0]
    dev = feat.device
    spb32 = torch.tensor(float(np.float32(spb)), dtype=F32, device=dev)
    lb = torch.tensor(stat_lb, dtype=F32, device=dev)
    bw = torch.tensor(stat_bw, dtype=F32, device=dev)
    idle_f = float(np.float32(cm.PE_IDLE_FACTOR))
    # strategies some lane uses (the others are computed nowhere)
    agc_exp = bool((agc_alpha > 0).any())
    clk_win = bool((clk_window > 0).any())
    clk_exp = bool(((clk_window <= 0) & (clk_alpha > 0)).any())

    zero_i = torch.zeros(N, dtype=I32, device=dev)
    no_b = torch.zeros(N, dtype=torch.bool, device=dev)
    no_hb = torch.full((N,), 50, dtype=I32, device=dev)
    no_w = torch.full((N,), maxb, dtype=I32, device=dev)

    def extra(st2, st, ev, admit_top, admit_bot, t_peak, s):
        # A lane that does not admit keeps its state (the JAX step is
        # inert there), so each branch below runs only when some lane
        # takes it.
        admit = admit_top | admit_bot
        out = dict(st2)
        s32 = s.to(I32)
        tlp = st["t_lastpeak"]
        b = st["clkavg"]["t_bitspaceavg"]
        pc = st["peakcount"] + admit.to(I32)
        out["peakcount"] = pc
        out["idle"] = st["idle"] & ~admit
        in_pre = admit & ~st["datablock"]
        in_data = admit & st["datablock"]
        bit1_up = st["bit1_up"]
        clknext = st["clknext"]
        numfake, run_valid, widx, stat_hb = zero_i, no_b, no_w, no_hb
        is_data = no_b

        # preamble (decode_pe.c:127-155)
        if bool(in_pre.any()):
            bit1_up = torch.where(in_pre & (pc == 1), ~admit_top, bit1_up)
            start_data = (in_pre & (pc > cm.PE_MIN_PREBITS) &
                          (bit1_up == admit_top) &
                          ((t_peak - tlp) > st["t_clkwindow"]))
            acc_ok = (in_pre & ~start_data & (pc >= cm.AGC_STARTBASE) &
                      (pc <= cm.AGC_ENDBASE) & (st2["v_top"] > st2["v_bot"]))
            if bool(acc_ok.any()):
                acc = cm.accumulate_baseline(
                    st2, st2["v_top"] - st2["v_bot"], agc_window)
                for kk in ("v_avg_height_sum", "v_avg_height_count",
                           "v_heights", "heightndx"):
                    out[kk] = trackscan._sel(acc_ok, acc[kk], st2[kk])
            out["v_avg_height"] = torch.where(
                start_data,
                cm.fdiv(st["v_avg_height_sum"],
                        torch.clamp_min(st["v_avg_height_count"], 1).to(F32)),
                st["v_avg_height"])
            out["datablock"] = st["datablock"] | start_data
            out["bit1_up"] = bit1_up
            clknext = torch.where(in_pre & ~start_data, admit_top != bit1_up,
                                  clknext)
        bitval = torch.where(admit_top, bit1_up, ~bit1_up)

        if bool(in_data.any()):
            # idle detection + fake-bit runs (decoder.c:868-877,
            # decode_pe.c:245-258)
            s_now = s.to(F32)
            dc = st["datacount"]
            t_lastbit = st["t_lastbit"]
            was_idle = st["idle"] | ((s_now - 1.0 - tlp) >
                                     b * cm.PE_IDLE_FACTOR)
            gen_fakes = in_data & was_idle & (dc > 1)
            if bool(gen_fakes.any()):
                numfake = f32_to_i32(torch.floor(cm.fdiv(
                    s_now - t_lastbit, torch.clamp_min(b, 1e-3))))
                numfake = torch.where(gen_fakes, torch.clamp_min(numfake, 0),
                                      0).to(I32)
                run_valid = gen_fakes & (numfake > 0)
                dc = torch.clamp_max(dc + numfake, maxb)
                t_lastbit = torch.where(run_valid, 0.0, t_lastbit)

            # data classification (decode_pe.c:157-201); peak statistics
            # vs the previous peak with the pre-update clock: 52/53 = out
            # of range low/high, 50 = not recorded
            stat_bkt = f32_to_i32(cm.fdiv((t_peak - tlp) - lb, bw))
            stat_hb = torch.where(
                in_data, torch.where(stat_bkt < 0, 52,
                                     torch.where(stat_bkt > 49, 53,
                                                 stat_bkt)), 50).to(I32)
            missed = ((t_peak + st["t_pulse_adj"]) - tlp >
                      st["t_clkwindow"])
            is_data = in_data & (~st["clknext"] | missed)
            clk = st["clkavg"]
            if bool(is_data.any()):
                # pe_addbit (decode_pe.c:104-125)
                t_lb_seed = torch.where(t_lastbit == 0.0, t_peak - spb32,
                                        t_lastbit)
                # XLA's CPU build contracts the -trace scan's exponential
                # clock the other way (common.adjust_clock's avg_fma)
                clk_new = cm.adjust_clock(clk, t_peak - t_lb_seed,
                                          clk_window, clk_alpha, spb,
                                          win=clk_win, exp=clk_exp,
                                          avg_fma=debug)
                clk = {k: trackscan._sel(is_data, clk_new[k], clk[k])
                       for k in clk}
                out["clkavg"] = clk
                out["t_clkwindow"] = torch.where(
                    is_data, clk["t_bitspaceavg"] / 2 * clk_factor,
                    st["t_clkwindow"])
                widx = torch.where(is_data, torch.clamp_max(dc, maxb - 1),
                                   maxb).to(I32)
                out["t_firstbit"] = torch.where(is_data & (dc == 0), t_peak,
                                                st["t_firstbit"])
                dc = torch.where(is_data, torch.clamp_max(dc + 1, maxb), dc)
                t_lastbit = torch.where(is_data, t_peak, t_lastbit)
                out["lastdatabit"] = torch.where(is_data, bitval,
                                                 st["lastdatabit"])
            out["datacount"] = dc
            out["t_lastbit"] = t_lastbit
            clknext = torch.where(in_data, is_data, clknext)
            q = torch.where(missed, 1.0, 2.0).to(F32)
            out["t_pulse_adj"] = torch.where(
                in_data,
                ((t_peak - tlp) - cm.fdiv(clk["t_bitspaceavg"], q)) *
                pulse_adj_parm, st["t_pulse_adj"])
            # AGC: pe_top/bot run adjust_agc on every data-block peak
            agc_new = cm.adjust_agc(st2, agc_alpha, agc_window, exp=agc_exp)
            for kk in ("agc_gain", "v_heights", "heightndx", "max_agc_gain",
                       "min_agc_gain"):
                out[kk] = trackscan._sel(in_data, agc_new[kk], out[kk])
        out["clknext"] = clknext
        out["v_lasttop"] = torch.where(admit_top, ev["wmax"],
                                       st["v_lasttop"])
        out["v_lastbot"] = torch.where(admit_bot, ev["wmin"],
                                       st["v_lastbot"])
        out["t_lastpeak"] = torch.where(admit, t_peak, tlp)

        # idle-entry interval: the track went idle between the previous
        # admission and this one; entry from the pre-admission clock, no
        # earlier than the previous admission's detection sample
        entry = idle_entry_sample(tlp, b * idle_f, st["s_lastdet"])
        out["s_lastdet"] = torch.where(admit, s32, st["s_lastdet"])
        rec = dict(adm=admit, s_det=s32, widx=widx,
                   bitval=bitval.to(torch.int8),
                   run_start=st["datacount"], run_len=numfake,
                   run_bit=st["lastdatabit"].to(torch.int8),
                   run_valid=run_valid, hb=stat_hb,
                   t_fb=out["t_firstbit"], t_lb=out["t_lastbit"],
                   agc_mx=out["max_agc_gain"], agc_mn=out["min_agc_gain"],
                   ie_valid=admit & (entry <= s32 - 1), ie_e=entry)
        if debug:
            rec.update(t_pk=t_peak, top=admit_top, isdata=is_data,
                       clkw=out["t_clkwindow"])
        return out, rec

    def ev_fn(st, s):
        return trackscan.gather_window_features(feat, src, s)

    def nxt_fn(i):
        return nxt[nsrc, i]

    def full(v, dt=F32):
        return torch.full((N,), v, dtype=dt, device=dev)

    init = trackscan.admission_init(W, (N,), dev, agc_ring)
    init.update(
        idle=full(True, torch.bool), datablock=full(False, torch.bool),
        clknext=full(False, torch.bool), bit1_up=full(True, torch.bool),
        clkavg=cm.clkavg_init(spb, (N,), dev, clk_ring),
        t_clkwindow=spb32 / 2 * clk_factor,
        t_pulse_adj=full(0.0), t_lastbit=full(0.0), t_firstbit=full(0.0),
        t_lastpeak=t_lp_virtual.to(F32), datacount=full(0, I32),
        lastdatabit=full(False, torch.bool),
        s_lastdet=s_first_check.to(I32))
    final, outs = trackscan.run_jump_scan_seq(
        extra, init, ev_fn, nxt_fn, S, rise_parm, min_parm, max_steps)
    final.update(trackscan.compact_outputs(
        outs["ie_valid"], IDLE_CAP,
        ie_e=(outs["ie_e"], BIG_TAU), ie_w=(outs["s_det"], BIG_TAU)))
    final["n_ie"] = outs["ie_valid"].sum(dim=-1).to(I32)
    final["ie_trail"] = idle_entry_sample(
        final["t_lastpeak"], final["clkavg"]["t_bitspaceavg"] * idle_f,
        final["s_lastdet"])
    for k in STREAMS + (DEBUG_STREAMS if debug else ()):
        final["_st_" + k] = outs[k]
    return final


def debug_peaks(fin, cap: int):
    """pe_track_scan(debug=True)'s admitted peaks compacted to cap entries
    per lane (compact_outputs' overflow rule), as the JAX package's
    pe_track_scan(debug_peaks=True) returns them: tr_s, tr_t, tr_top,
    tr_isdata, tr_clkw, tr_bitval and the uncapped n_admitted."""
    adm = fin["_st_adm"]
    out = trackscan.compact_outputs(
        adm, cap, tr_s=(fin["_st_s_det"], trackscan.BIG_S),
        tr_t=(fin["_st_t_pk"], 0.0), tr_top=(fin["_st_top"], False),
        tr_isdata=(fin["_st_isdata"], False),
        tr_clkw=(fin["_st_clkw"], 0.0),
        tr_bitval=(fin["_st_bitval"], 0))
    out["n_admitted"] = adm.sum(dim=-1).to(I32)
    return out


def pe_idle_tau(e, w, valid):
    """First sample where ALL tracks are idle at once (pe_end_of_block,
    decoder.c:868-877), for L lanes: e, w, valid [L, T, C] idle intervals
    (entry sample, waking detection sample, BIG_TAU-filled). At a
    candidate entry (track i, sample s), tracks k < i must be idle at s
    and tracks k > i at s-1 (the reference's in-order track loop). Only
    the first IDLE_ECAP entries per track are candidates. Returns [L]
    int32, BIG_TAU where the tracks never align. Lanes go through in
    chunks so the [L, T*ECAP, T, C] comparison stays small."""
    L, T, C = e.shape
    ecap = min(C, IDLE_ECAP)
    out = []
    step = max(1, (1 << 24) // max(1, T * ecap * T * C))
    k = torch.arange(T, device=e.device)
    ti = torch.arange(T, device=e.device).repeat_interleave(ecap)   # [Nc]
    for lo in range(0, L, step):
        ee, ww, vv = e[lo:lo + step], w[lo:lo + step], valid[lo:lo + step]
        s0 = ee[:, :, :ecap].reshape(ee.shape[0], -1)              # [l, Nc]
        ok0 = vv[:, :, :ecap].reshape(ee.shape[0], -1)

        def idle_at(s):                                            # [l, Nc, T]
            s4 = s[:, :, None, None]
            return (vv[:, None] & (ee[:, None] <= s4) &
                    (s4 < ww[:, None])).any(dim=-1)

        ia_now = idle_at(s0)
        ia_prev = idle_at(s0 - 1)
        kk = k.view(1, 1, T)
        tt = ti.view(1, -1, 1)
        cond = torch.where(kk < tt, ia_now,
                           torch.where(kk > tt, ia_prev, True)).all(dim=-1)
        fire = ok0 & cond
        out.append(torch.where(fire, s0, BIG_TAU).amin(dim=-1))
    return torch.cat(out).to(I32)


def lane_tau(ie_e, ie_w, n_ie, ie_trail):
    """tau and tau_gaveup per lane from each track's idle intervals
    ([L, T, IDLE_CAP], n_ie and ie_trail [L, T]), as the JAX package's
    _pe_segment_device does: the trailing entry joins the stream; an
    overflowing stream gives no tau; a tau beyond the tested candidate
    horizon is unknown (gave up), not never."""
    L, T, C = ie_e.shape
    n_c = torch.clamp_max(n_ie, C)
    pad = torch.full((L, T, 1), BIG_TAU, dtype=ie_e.dtype,
                     device=ie_e.device)
    e = torch.cat([ie_e, pad], dim=-1).scatter(
        -1, n_c.long().unsqueeze(-1), ie_trail.unsqueeze(-1))[..., :C]
    valid = (torch.arange(C, device=ie_e.device).view(1, 1, C) <=
             n_c.unsqueeze(-1))
    # entries past every track's count are invalid: leave them out
    cu = min(C, int(n_c.max()) + 1) if n_c.numel() else 1
    tau = pe_idle_tau(e[..., :cu], ie_w[..., :cu], valid[..., :cu])
    overflow = (n_ie > C).any(dim=-1)
    gaveup = overflow | ((n_ie > IDLE_ECAP).any(dim=-1) & (tau >= BIG_TAU))
    return torch.where(overflow, BIG_TAU, tau).to(I32), gaveup


def peak_hist(hb):
    """Histogram codes hb [..., steps] (0..49 in range, 52/53 out of range
    low/high, 50 none) -> (hist [..., 50], trksum [...]): the out-of-range
    codes land in the end buckets and count nothing toward trksum."""
    hb2 = torch.where(hb == 52, 0, torch.where(hb == 53, 49, hb)).long()
    hist = torch.zeros(hb.shape[:-1] + (51,), dtype=I32,
                       device=hb.device).scatter_add(
        -1, hb2, torch.ones_like(hb2, dtype=I32))[..., :50]
    return hist, (hb <= 49).sum(dim=-1).to(I32)


def pe_replay_streams(recs, maxb: int, mask):
    """Replay streamed bit/run/stat records ([..., steps]) into the block
    buffers (bits, faked, hist, trksum); records where mask is False never
    happened (nothing after the all-idle point exists)."""
    widx = torch.where(mask, recs["widx"], maxb).long()
    run_valid = recs["run_valid"] & mask
    hb = torch.where(mask, recs["hb"], 50)
    lead = widx.shape[:-1]
    dev = widx.device
    # bit writes, the last write to a position winning
    steps = torch.arange(widx.shape[-1], device=dev).expand(widx.shape)
    last = torch.full(lead + (maxb + 1,), -1, dtype=torch.long, device=dev)
    last = last.scatter_reduce(-1, widx, steps, "amax")[..., :maxb]
    bits = torch.where(last >= 0, recs["bitval"].gather(
        -1, last.clamp_min(0)), 0).to(torch.int8)
    hist, trksum = peak_hist(hb)
    runs = trackscan.compact_outputs(
        run_valid, RUN_CAP, run_start=(recs["run_start"], 0),
        run_len=(recs["run_len"], 0), run_bit=(recs["run_bit"], 0))
    n_runs = run_valid.sum(dim=-1, keepdim=True)
    valid = torch.arange(RUN_CAP, device=dev) < n_runs
    starts = torch.where(valid, runs["run_start"], maxb).long()
    ends = torch.where(valid, torch.clamp_max(
        runs["run_start"] + runs["run_len"], maxb), maxb).long()
    bvals = runs["run_bit"].to(I32)

    def cum(at_start, at_end):
        d = torch.zeros(lead + (maxb + 1,), dtype=I32, device=dev)
        d = d.scatter_add(-1, starts, at_start).scatter_add(-1, ends, at_end)
        return torch.cumsum(d[..., :maxb], dim=-1)
    one = torch.ones_like(bvals)
    inrun = cum(one, -one) > 0
    runbit = cum(bvals, -bvals)
    bits = torch.where(inrun, runbit.to(torch.int8), bits)
    faked = inrun.to(torch.int8)
    return dict(bits=bits, faked=faked, hist=hist, trksum=trksum)


def pe_apply_tau(fin, maxb: int, tau):
    """Truncate each track's streams at its lane's all-idle sample tau
    and rebuild the per-track block state pe_finish reads. fin: scan
    state with _st_* streams [..., T, steps]; tau [...]. tau = BIG_TAU
    keeps the whole scan."""
    adm = fin["_st_adm"]
    mask = adm & (fin["_st_s_det"] < tau.view(tau.shape + (1, 1)))
    steps = torch.arange(mask.shape[-1], device=mask.device)
    last = torch.where(mask, steps, -1).amax(dim=-1)
    has = last >= 0

    def at_last(name, init):
        x = fin["_st_" + name]
        v = x.gather(-1, last.clamp_min(0).unsqueeze(-1)).squeeze(-1)
        return torch.where(has, v, init)
    fakes = torch.where(mask & fin["_st_run_valid"], fin["_st_run_len"],
                        0).sum(dim=-1).to(I32)
    recs = {k: fin["_st_" + k] for k in
            ("widx", "bitval", "run_start", "run_len", "run_bit",
             "run_valid", "hb")}
    out = pe_replay_streams(recs, maxb, mask)
    out["peakcount"] = mask.sum(dim=-1).to(I32)
    out["datacount"] = torch.clamp_max(
        (mask & (fin["_st_widx"] < maxb)).sum(dim=-1).to(I32) + fakes, maxb)
    out["t_firstbit"] = at_last("t_fb", 0.0)
    out["t_lastbit"] = at_last("t_lb", 0.0)
    out["max_agc_gain"] = at_last("agc_mx", 0.0)
    out["min_agc_gain"] = at_last("agc_mn", cm.FLT_MAX)
    out["corrected_bits"] = fakes
    out["incomplete"] = fin["incomplete"]
    out["n_consumed"] = out["peakcount"]
    out["n_total"] = adm.sum(dim=-1).to(I32)
    return out


@telemetry.spanned("finish")
def pe_finish(st, T: int, expected_parity: int, revparity: int, maxb: int):
    """Block assembly (decode_pe.c:33-102): tapemark test, postamble
    strip, parity count, batched over the leading lane axes of st
    (per-track fields [..., T], bits/faked [..., T, maxb])."""
    dev = st["datacount"].device
    trk = torch.arange(T, device=dev)
    dc = st["datacount"]
    pc = st["peakcount"]

    if T == 9:
        with telemetry.wait("const_upload"):
            live = torch.tensor([1, 0, 1, 0, 0, 1, 1, 1, 1],
                                dtype=torch.bool, device=dev)
        is_tm = (torch.where(live, (dc <= 2) & (pc > 75), True).all(dim=-1)
                 & torch.where(~live, pc <= 2, True).all(dim=-1))
    else:
        is_tm = torch.zeros(dc.shape[:-1], dtype=torch.bool, device=dev)

    spacing = cm.fdiv(st["t_lastbit"] - st["t_firstbit"],
                      torch.clamp_min(dc, 1).to(F32))
    # jnp.mean under jit: an in-order sum times the f32 reciprocal of T
    avg_sp = seq_sum(spacing) * float(np.float32(1) / np.float32(T))

    # postamble strip: trailing bits through the first 1-bit past the
    # PE_IGNORE_POSTBITS ignored ones (at most PE_MAX_POSTBITS+1)
    j = torch.arange(cm.PE_MAX_POSTBITS + 1, dtype=I32, device=dev)
    pos = dc.unsqueeze(-1) - 1 - j                           # [..., T, 41]
    pos_c = torch.clamp(pos, 0, maxb - 1).long()
    bit_at = st["bits"].to(I32).gather(-1, pos_c)
    fake_at = st["faked"].to(I32).gather(-1, pos_c)
    stop = (j > cm.PE_IGNORE_POSTBITS) & (bit_at == 1) & (pos >= 0)
    first_stop = stop.to(torch.int8).argmax(dim=-1).to(I32)
    nstrip = torch.where(stop.any(dim=-1), first_stop + 1,
                         cm.PE_MAX_POSTBITS + 1)
    nstrip = torch.where(dc > 0, torch.minimum(nstrip, dc), 0)
    stripped_fakes = torch.where((j < nstrip.unsqueeze(-1)) & (pos >= 0),
                                 fake_at, 0).sum(dim=(-1, -2))
    dc2 = dc - nstrip

    minbits = dc2.amin(dim=-1)
    maxbits = dc2.amax(dim=-1)
    corrected = torch.clamp_min(
        st["corrected_bits"].sum(dim=-1) - stripped_fakes, 0)

    has_data = dc > 0
    alltrk_max = torch.where(has_data, st["max_agc_gain"], 0.0).amax(dim=-1)
    alltrk_min = torch.where(has_data, st["min_agc_gain"],
                             cm.FLT_MAX).amin(dim=-1)

    idx = torch.arange(maxb, device=dev)
    inb = idx < dc2.unsqueeze(-1)
    shift = (T - 1 - trk).to(I32).unsqueeze(-1)
    frames = ((st["bits"].to(I32) << shift) * inb).sum(dim=-2).to(I32)
    faked_frames = ((st["faked"].to(I32) << shift) * inb).sum(
        dim=-2).to(I32)

    is_noise = (~is_tm) & (maxbits == 0)
    is_block = (~is_tm) & (~is_noise)
    mismatch = torch.where(is_block & (minbits != maxbits),
                           maxbits - minbits, 0)
    flip = (revparity > 0) & (maxbits == revparity)
    exp_par = torch.where(flip, 1 - expected_parity, expected_parity)
    par = cm.parity9(frames)
    keep = idx < minbits.unsqueeze(-1)
    vparity = (keep & is_block.unsqueeze(-1) &
               (par != exp_par.unsqueeze(-1))).sum(dim=-1)

    blktype = torch.where(is_tm, BS_TAPEMARK,
                          torch.where(is_noise, BS_NOISE, BS_BLOCK))
    zero = torch.zeros_like(minbits)
    i32 = lambda x: x.to(I32)                          # noqa: E731
    return dict(
        blktype=i32(blktype), minbits=i32(minbits), maxbits=i32(maxbits),
        track_mismatch=i32(mismatch), vparity_errs=i32(vparity),
        crc_errs=i32(zero), lrc_errs=i32(zero),
        errcount=i32(mismatch + vparity), warncount=i32(corrected),
        missed_midbits=i32(zero), corrected_bits=i32(corrected),
        faked_tracks=i32(zero), avg_bit_spacing=avg_sp, frames=frames,
        faked_frames=faked_frames, hist=st["hist"], trksums=st["trksum"],
        consume_overflow=st["incomplete"].any(dim=-1),
        alltrk_max_agc=alltrk_max, alltrk_min_agc=alltrk_min)
