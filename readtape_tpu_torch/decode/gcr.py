"""GCR decoder (9-track 6250 BPI = 9042 frpi group-coded recording) --
counterpart of readtape_tpu/decode/gcr.py.

Per track, GCR is NRZI with at most two consecutive zeros, so each track
clocks itself: zero bits are inferred from the spacing of flux
transitions against the z1pt/z2pt thresholds, with pulse adjustment,
clock tracking on runs of three ones, and resync bursts (MARK2 ... MARK1)
that force the clock (decode_gcr.c:731-865). A track goes idle after
GCR_IDLE_THRESH bit times without a peak, and the block ends where every
track is idle at once (gcr_end_of_block, decoder.c:879-888).

This is the PLAIN version that the gcr_fused_scan kernel is held against
(decode/fused.py): the per-track admission scan with the bit machine
(``gcr_track_scan``, the JAX package's ``pre=True, idle_out=True`` form),
the records replayed up to the lane's all-idle point (``gcr_apply_tau``),
and block assembly (``gcr_postprocess``, ``gcr_finish``), all vectorized
over lanes. Under -zeros the transitions come from the zero-crossing
state machines instead (``zerocross_transitions``, NRZI's too) and the bit
machine runs over them (``gcr_zeros_track_scan``): the plain versions of
kernels Z1 and Z2 (decode/zeros.py). Operation order follows the JAX
functions exactly; ``cm.fma`` stands where the JAX package's XLA CPU
build contracts a multiply-add.

The group-level postprocess is a ``lax.scan`` over 5-bit storage groups in
the JAX package. Here it has no loop: every per-group quantity (codes,
frames, parity, marks, the ECC check and the ``-correct`` fix of each
group pair) is a tensor over groups, the block state machine's state
before each group is a prefix composition of per-group transition
functions (log2(groups) gathers), and the byte index and frame writes
follow from it by cumulative sums and a last-write-wins scatter.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import telemetry
from . import common as cm
from . import gcr_tables as gt
from . import trackscan
from .common import F32, I32
from .nrzi import (BS_BADBLOCK, BS_BLOCK, BS_NOISE, BS_TAPEMARK, f32_to_i32,
                   seq_sum)
from .pe import BIG_TAU, IDLE_CAP, peak_hist

IDLE_THR = float(np.float32(cm.GCR_IDLE_THRESH))
ZEROCROSS_PEAK = 0.2
ZEROCROSS_SLOPE = 1.5
_PEAK = float(np.float32(ZEROCROSS_PEAK))

# per-step records gcr_track_scan streams out (step axis last; "wr" has a
# trailing axis of the step's 3 write indices)
STREAMS = ("adm", "s_det", "wr", "hb", "t_fb", "t_lb", "agc_mx", "agc_mn")
# and with debug=True the -trace records (the JAX package's debug_peaks):
# the peak time, top or bottom, the zeros inferred before it, the pulse
# adjustment after it
DEBUG_STREAMS = ("t_pk", "top", "nzeros", "padj")


# ---------------------------------------------------------------------------
# per-track bit recovery (decode_gcr.c:731-834)
# ---------------------------------------------------------------------------

def gcr_bit_state_init(spb: float, shape, device,
                       clk_ring: int = cm.CLKRATE_WINDOW):
    """The bit-recovery state of lanes of `shape` before their first
    admission."""
    def full(v, dt=F32):
        return torch.full(tuple(shape), v, dtype=dt, device=device)
    return dict(
        clkavg=cm.clkavg_init(spb, shape, device, clk_ring),
        t_pulse_adj=full(0.0), t_peakdelta=full(0.0),
        datablock=full(False, torch.bool), datacount=full(0, I32),
        lastbits=full(0, I32), resync_bitcount=full(0, I32),
        t_firstbit=full(0.0), t_lastbit=full(0.0), t_lastpeak=full(0.0))


def gcr_bit_step(st, admit, t_this, z1pt, z2pt, pulse_adj_parm, clk_window,
                 clk_alpha, spb: float, maxb: int, clk_win: bool = True,
                 clk_exp: bool = True):
    """gcr_checkzeros + gcr_addbit for one admitted transition per lane.
    Returns (state, wr [..., 3]): the step's three bit-write indices
    (inferred 0, inferred 0, then the 1; maxb = no write). The
    three-ones clock test reads the pattern register before the 1-bit.
    clk_win/clk_exp: some lane uses that clock strategy."""
    b = st["clkavg"]["t_bitspaceavg"]
    delta = t_this - st["t_lastpeak"]
    in_blk = admit & st["datablock"]
    zero1 = in_blk & (delta - st["t_pulse_adj"] > z1pt * b)
    zero2 = zero1 & (delta - st["t_pulse_adj"] > z2pt * b)
    numbits = 1 + zero1.to(I32) + zero2.to(I32)
    t_peakdelta_new = torch.where(in_blk, delta, st["t_peakdelta"])
    wr = []

    def add_one_bit(carry, bitval: int, enable):
        """One gcr_addbit: write, shift the pattern register, resync
        detection at 5-bit boundaries, the mid-resync force_clock."""
        dc, lastbits, rsc, clk = carry
        wr.append(torch.where(enable, torch.clamp_max(dc, maxb - 1), maxb))
        dc_n = torch.where(enable, torch.clamp_max(dc + 1, maxb), dc)
        lb_n = torch.where(enable, ((lastbits << 1) | bitval) & 0xFF,
                           lastbits)
        at5 = enable & ((dc_n % 5) == 0)
        code = lb_n & 0x1F
        rsc = torch.where(at5 & (code == gt.GCR_MARK2), 1,
                          torch.where(at5 & (code == gt.GCR_MARK1) &
                                      (rsc > 0), 0, rsc))
        in_resync = enable & (rsc > 0)
        force = in_resync & (rsc == 5)
        if bool(force.any()):
            fc = cm.force_clock(clk, t_peakdelta_new)
            clk = {k: trackscan._sel(force, fc[k], clk[k]) for k in clk}
        rsc = torch.where(in_resync, rsc + 1, rsc)
        return dc_n.to(I32), lb_n.to(I32), rsc.to(I32), clk

    carry = (st["datacount"], st["lastbits"], st["resync_bitcount"],
             st["clkavg"])
    carry = add_one_bit(carry, 0, zero1)
    dc1, lastbits, rsc, clk = add_one_bit(carry, 0, zero2)

    # clock adjust on 3 consecutive one-bits (decode_gcr.c:808-810) with
    # the previous peak delta, before the current 1-bit is added
    prev2 = torch.where(dc1 >= 2, (lastbits >> 1) & 1, 0)
    do_adj = in_blk & (dc1 > 3) & (numbits == 1) & (prev2 == 1)
    if bool(do_adj.any()):
        cn = cm.adjust_clock(clk, st["t_peakdelta"], clk_window, clk_alpha,
                             spb, win=clk_win, exp=clk_exp)
        clk = {k: trackscan._sel(do_adj, cn[k], clk[k]) for k in clk}
    t_pulse_adj = torch.where(
        in_blk, pulse_adj_parm * cm.fma(numbits.to(F32),
                                        clk["t_bitspaceavg"], -delta),
        st["t_pulse_adj"])
    dc2, lastbits, rsc, clk = add_one_bit((dc1, lastbits, rsc, clk), 1,
                                          admit)

    out = dict(st)
    out.update(
        datacount=dc2, lastbits=lastbits, resync_bitcount=rsc, clkavg=clk,
        t_pulse_adj=t_pulse_adj, t_peakdelta=t_peakdelta_new,
        datablock=st["datablock"] | admit,
        t_firstbit=torch.where(admit & (st["datacount"] == 0), t_this,
                               st["t_firstbit"]),
        t_lastbit=torch.where(admit, t_this, st["t_lastbit"]),
        t_lastpeak=torch.where(admit, t_this, st["t_lastpeak"]))
    return out, torch.stack(wr, dim=-1).to(I32)


def gcr_replay_bits(wr, maxb: int):
    """Scatter write records wr [..., steps, 3] into bit buffers
    [..., maxb]: the values are 0, 0, 1 by position in the step; a
    position written more than once (a saturated count) keeps the last
    write."""
    flat = wr.reshape(wr.shape[:-2] + (-1,)).long()
    order = torch.arange(flat.shape[-1], device=wr.device).expand(flat.shape)
    last = torch.full(flat.shape[:-1] + (maxb + 1,), -1, dtype=torch.long,
                      device=wr.device)
    last = last.scatter_reduce(-1, flat, order, "amax")[..., :maxb]
    return ((last >= 0) & (last % 3 == 2)).to(torch.int8)


def gcr_idle_entry_sample(t_lp, b, s_floor):
    """First integer sample s >= s_floor where f32(s) > t_lp + thr, thr =
    GCR_IDLE_THRESH bit times of the clock b: the reference's per-sample
    GCR idle check (decoder.c:879-880, timenow > t_lastpeak +
    GCR_IDLE_THRESH * bitspaceavg), with its comparison form (threshold
    added to the peak time, unlike PE's subtracted gap). The JAX package's
    XLA CPU build contracts t_lp + thr into one fused multiply-add."""
    x = cm.fma(IDLE_THR, b, t_lp)
    c = torch.floor(x).to(I32)
    offs = c.unsqueeze(-1) - 1 + torch.arange(4, dtype=I32, device=c.device)
    pred = offs.to(F32) > x.unsqueeze(-1)
    first = pred.to(torch.int8).argmax(dim=-1).to(I32)
    e = torch.where(pred.any(dim=-1), c - 1 + first, c + 2)
    return torch.maximum(e, s_floor)


def gcr_track_scan(feat, src, nxt, nsrc, W, S: int, max_steps: int,
                   rise_parm, min_parm, agc_alpha, agc_window, clk_window,
                   clk_alpha, z1pt, z2pt, pulse_adj_parm, spb: float,
                   maxb: int, stat_lb: float, stat_bw: float, s_first_check,
                   clk_ring: int, agc_ring: int, debug: bool = False):
    """GCR admission scan for N (segment x parmset x track) lanes at once:
    admission with the NRZI AGC policy, then the bit machine. Inputs as
    pe.pe_track_scan's (feat [M, S, 10] with lane rows src, masked jump
    tables nxt with lane rows nsrc; W, the knobs and s_first_check [N]).

    A datablock track whose idle point (GCR_IDLE_THRESH bit times after
    its last peak) comes before its next admission drops datablock, so
    that admission re-seeds the block without zero inference
    (gcr_addbit:749-753); peak statistics gate on "has ever had data".
    Returns the final state with the per-step records (STREAMS, [N,
    steps], "wr" [N, steps, 3]) and the idle intervals: ie_e/ie_w [N,
    IDLE_CAP] (entry sample, waking detection), n_ie, and the trailing
    entry ie_trail (BIG_TAU unless the track still holds an open block).

    debug=True is the JAX package's -trace scan (gcr_track_scan without
    idle tracking, debug_peaks=True): datablock never drops (the
    intervals are still recorded), and the DEBUG_STREAMS stream out too
    (debug_peaks compacts them)."""
    N = src.shape[0]
    dev = feat.device
    lb = torch.tensor(stat_lb, dtype=F32, device=dev)
    bw = torch.tensor(stat_bw, dtype=F32, device=dev)
    clk_win = bool((clk_window > 0).any())
    clk_exp = bool(((clk_window <= 0) & (clk_alpha > 0)).any())

    def extra(st2, st, ev, admit_top, admit_bot, t_peak, s):
        admit = admit_top | admit_bot
        s32 = s.to(I32)
        st2["max_agc_gain"] = torch.where(admit & (st["datacount"] == 0),
                                          st["agc_gain"], st["max_agc_gain"])
        st3 = trackscan.nrzi_agc_policy(st2, st, admit_top, admit_bot,
                                        agc_alpha, agc_window)
        st3["v_lasttop"] = torch.where(admit_top, ev["wmax"],
                                       st["v_lasttop"])
        st3["v_lastbot"] = torch.where(admit_bot, ev["wmin"],
                                       st["v_lastbot"])
        # peak statistics (decode_gcr.c:839-850) once the track has ever
        # had data: 52/53 = out of range low/high, 50 = not recorded
        bkt = f32_to_i32(cm.fdiv((t_peak - st["t_lastpeak"]) - lb, bw))
        hb = torch.where(admit & st["had_data"],
                         torch.where(bkt < 0, 52,
                                     torch.where(bkt > 49, 53, bkt)), 50)
        # mid-scan idle (decoder.c:879-888) between the previous
        # admission and this one
        entry = gcr_idle_entry_sample(st["t_lastpeak"],
                                      st["clkavg"]["t_bitspaceavg"],
                                      st["s_lastdet"])
        went_idle = admit & st["datablock"] & (entry <= s32 - 1)
        if not debug:
            st3["datablock"] = st["datablock"] & ~went_idle
        st3["s_lastdet"] = torch.where(admit, s32, st["s_lastdet"])
        st3["had_data"] = st["had_data"] | admit
        st4, wr = gcr_bit_step(st3, admit, t_peak, z1pt, z2pt,
                               pulse_adj_parm, clk_window, clk_alpha, spb,
                               maxb, clk_win=clk_win, clk_exp=clk_exp)
        rec = dict(adm=admit, s_det=s32, wr=wr, hb=hb.to(I32),
                   t_fb=st4["t_firstbit"], t_lb=st4["t_lastbit"],
                   agc_mx=st4["max_agc_gain"], agc_mn=st4["min_agc_gain"],
                   ie_valid=went_idle, ie_e=entry)
        if debug:
            rec.update(t_pk=t_peak, top=admit_top, padj=st4["t_pulse_adj"],
                       nzeros=(st4["datacount"] - st["datacount"] - 1)
                       .to(torch.int8))
        return st4, rec

    def ev_fn(st, s):
        return trackscan.gather_window_features(feat, src, s)

    def nxt_fn(i):
        return nxt[nsrc, i]

    init = trackscan.admission_init(W, (N,), dev, agc_ring)
    init.update(gcr_bit_state_init(spb, (N,), dev, clk_ring))
    init.update(s_lastdet=s_first_check.to(I32),
                had_data=torch.zeros(N, dtype=torch.bool, device=dev))
    final, outs = trackscan.run_jump_scan_seq(
        extra, init, ev_fn, nxt_fn, S, rise_parm, min_parm, max_steps)
    final.update(trackscan.compact_outputs(
        outs["ie_valid"], IDLE_CAP,
        ie_e=(outs["ie_e"], BIG_TAU), ie_w=(outs["s_det"], BIG_TAU)))
    final["n_ie"] = outs["ie_valid"].sum(dim=-1).to(I32)
    trail = gcr_idle_entry_sample(final["t_lastpeak"],
                                  final["clkavg"]["t_bitspaceavg"],
                                  final["s_lastdet"])
    # a dead or never-written track never goes idle (decoder.c:879)
    final["ie_trail"] = torch.where(final["datablock"], trail, BIG_TAU)
    for k in STREAMS + (DEBUG_STREAMS if debug else ()):
        final["_st_" + k] = outs[k]
    final["_st_wr"] = outs["wr"].transpose(-1, -2)
    return final


def debug_peaks(fin, cap: int):
    """gcr_track_scan(debug=True)'s admitted peaks compacted to cap entries
    per lane (compact_outputs' overflow rule), as the JAX package's
    gcr_track_scan(debug_peaks=True) returns them: tr_s, tr_t, tr_top,
    tr_nzeros, tr_padj and the uncapped n_admitted."""
    adm = fin["_st_adm"]
    out = trackscan.compact_outputs(
        adm, cap, tr_s=(fin["_st_s_det"], trackscan.BIG_S),
        tr_t=(fin["_st_t_pk"], 0.0), tr_top=(fin["_st_top"], False),
        tr_nzeros=(fin["_st_nzeros"], 0), tr_padj=(fin["_st_padj"], 0.0))
    out["n_admitted"] = adm.sum(dim=-1).to(I32)
    return out


def gcr_apply_tau(fin, maxb: int, tau):
    """Truncate each track's streams at its lane's all-idle sample tau
    (gcr_end_of_block) and rebuild the per-track state gcr_finish reads.
    fin: scan state with _st_* streams [..., T, steps]; tau [...]. tau =
    BIG_TAU keeps the whole scan."""
    adm = fin["_st_adm"]
    mask = adm & (fin["_st_s_det"] < tau.view(tau.shape + (1, 1)))
    steps = torch.arange(mask.shape[-1], device=mask.device)
    last = torch.where(mask, steps, -1).amax(dim=-1)
    has = last >= 0

    def at_last(name, init):
        x = fin["_st_" + name]
        v = x.gather(-1, last.clamp_min(0).unsqueeze(-1)).squeeze(-1)
        return torch.where(has, v, init)
    wr = torch.where(mask.unsqueeze(-1), fin["_st_wr"], maxb)
    hist, trksum = peak_hist(torch.where(mask, fin["_st_hb"], 50))
    out = dict(
        bits=gcr_replay_bits(wr, maxb),
        datacount=torch.clamp_max((wr < maxb).sum(dim=(-1, -2)),
                                  maxb).to(I32),
        hist=hist, trksum=trksum, peakcount=mask.sum(dim=-1).to(I32),
        t_firstbit=at_last("t_fb", 0.0), t_lastbit=at_last("t_lb", 0.0),
        max_agc_gain=at_last("agc_mx", 0.0),
        min_agc_gain=at_last("agc_mn", cm.FLT_MAX),
        incomplete=fin["incomplete"], n_total=adm.sum(dim=-1).to(I32))
    out["n_consumed"] = out["peakcount"]
    return out


# ---------------------------------------------------------------------------
# -zeros: zero-crossing transitions (decoder.c:617-683) and the bit machine
# over them
# ---------------------------------------------------------------------------

def _shift(x, fill):
    """x one sample later along the last axis, `fill` first."""
    return torch.cat([torch.full_like(x[..., :1], fill), x[..., :-1]], dim=-1)


def _last_at(mask, idx):
    """Index of the last True at or before each sample (-1: none)."""
    return torch.where(mask, idx, -1).cummax(dim=-1).values


def _first_from(mask, idx, S: int):
    """Index of the first True at or after each sample (S: none)."""
    return torch.where(mask, idx, S).flip(-1).cummin(dim=-1).values.flip(-1)


def _buckets(n: int, slot, src, reduce: str, init):
    """src [..., S] reduced into n buckets by slot [..., S]."""
    out = torch.full(slot.shape[:-1] + (n,), init, dtype=src.dtype,
                     device=src.device)
    return out.scatter_reduce(-1, slot, src, reduce)


def zerocross_transitions(v, cap: int, differentiated: bool, seg_len=None,
                          lead_len=None):
    """gcr.zerocross_transitions of the JAX package over leading axes: v
    [..., T, S] f32 volts, seg_len/lead_len [...] (or None) the eligible
    window [lead_len, seg_len) of each segment (samples outside read as
    0). Returns the per-track transition lists [..., T, cap]: t (crossing
    time), ok, dt (confirmation lag), det (confirmation sample), is_top,
    valid, and overflow [...] (some track had more than cap).

    Plain variant: a phase is a maximal run of same-sign samples (exact
    zeros transparent); a significant phase (one sample above
    ZEROCROSS_PEAK) opens a bucket that sweeps to the next significant
    phase. The carried extrema (v_top, -v_bot) run over the buckets in a
    Python loop; the first sample above each bucket's threshold is its
    confirmation point. Differentiated variant: a crossing fires iff the
    span since the previous crossing attained the threshold; its time is
    the midpoint of the zeros after that span's last attaining sample,
    else the crossing less half a sample. The list keeps the first cap
    crossings and, past them, the last in slot cap - 1 (the JAX scatter's
    last write)."""
    S = v.shape[-1]
    lead = v.shape[:-1]
    dev = v.device
    idx = torch.arange(S, device=dev)
    elig = torch.ones(S, dtype=torch.bool, device=dev)
    if seg_len is not None:
        elig = elig & (idx < seg_len.to(dev).view(seg_len.shape + (1, 1)))
    if lead_len is not None:
        elig = elig & (idx >= lead_len.to(dev).view(lead_len.shape + (1, 1)))
    vv = torch.where(elig, v, 0.0)
    sgn = torch.sign(vv).to(torch.int8)
    nz = sgn != 0
    amp = vv.abs()
    att = amp > _PEAK
    last_nz = _last_at(nz, idx)
    ff_excl = _shift(torch.where(last_nz >= 0,
                                 sgn.gather(-1, last_nz.clamp_min(0)), 0), 0)
    last_att = _last_at(att, idx)

    if differentiated:
        crossing = nz & (ff_excl != 0) & (sgn != ff_excl)
        # the or-scan of att restarting at each crossing
        pre_any = last_att >= torch.where(crossing, idx, 0).cummax(-1).values
        keep = crossing & _shift(pre_any, False)
        cnt = keep.cumsum(dim=-1)
        slot = torch.where(keep, torch.clamp_max(cnt - 1, cap - 1), cap)
        cpos = _buckets(cap + 1, slot, torch.where(keep, idx, -1), "amax",
                        -1)[..., :cap]
        valid = cpos >= 0
        pos = torch.where(valid, cpos, S - 1)
        la = _shift(last_att, -1).gather(-1, pos)
        zf = _first_from(~nz, idx, S).gather(-1, (la + 1).clamp_max(S - 1))
        zl = _shift(_last_at(~nz, idx), -1).gather(-1, pos)
        has_zero = (zf < pos) & (zl >= zf)
        t = torch.where(has_zero, (zf.to(F32) + zl.to(F32)) / 2,
                        pos.to(F32) - 0.5)
        return dict(t=t, ok=valid, dt=torch.zeros_like(t), det=pos.to(I32),
                    is_top=sgn.gather(-1, pos) > 0, valid=valid,
                    overflow=(cnt[..., -1] > cap).any(dim=-1))

    # plain variant: phases, significant phases, buckets
    phase_start = nz & (ff_excl != sgn)
    strict = nz & (_shift(sgn, 0) == -sgn)
    nxt_start = torch.cat([_first_from(phase_start, idx, S)[..., 1:],
                           torch.full_like(idx[..., :1], S).expand(
                               lead + (1,))], dim=-1)
    sig_start = phase_start & (last_att.gather(-1, nxt_start - 1) >= idx)
    sid = sig_start.cumsum(dim=-1)
    nph = cap + 2
    sc = sid.clamp_max(nph - 1)
    at_sig = torch.where(sig_start, sc, nph - 1)
    ph_a = _buckets(nph, at_sig, torch.where(sig_start, idx, S), "amin", S)
    ph_flip = _buckets(nph, at_sig, (strict & sig_start).to(torch.uint8),
                       "amax", 0) > 0
    ph_sig = _buckets(nph, at_sig, torch.where(sig_start, sgn, 0).to(I32),
                      "sum", 0)
    ph_max = _buckets(nph, sc, amp, "amax", 0.0)
    ph_va = _buckets(nph, at_sig, torch.where(sig_start, amp, 0.0), "amax",
                     0.0)
    nphase = sid[..., -1]
    # the carried extrema over the buckets: bucket 0 (no significant
    # phase) and buckets past a track's last one change nothing
    ct = torch.zeros(lead, dtype=F32, device=dev)
    cbm = torch.zeros_like(ct)
    conf = torch.zeros(lead + (nph,), dtype=torch.bool, device=dev)
    thr = torch.full(lead + (nph,), _PEAK, dtype=F32, device=dev)
    for k in range(1, min(int(nphase.max()) if nphase.numel() else 0,
                          cap) + 1):
        sig, M, va = ph_sig[..., k], ph_max[..., k], ph_va[..., k]
        is_pos = sig > 0
        own = torch.where(is_pos, ct, cbm)
        opp = torch.where(is_pos, cbm, ct)
        pend = ph_flip[..., k] & (opp > _PEAK)
        th = torch.clamp_min(torch.maximum(own, va), _PEAK)
        cf = pend & (M > th)
        own2 = torch.maximum(own, M)
        opp2 = torch.where(cf, 0.0, opp)
        nzp = sig != 0
        ct = torch.where(nzp, torch.where(is_pos, own2, opp2), ct)
        cbm = torch.where(nzp, torch.where(is_pos, opp2, own2), cbm)
        conf[..., k] = cf
        thr[..., k] = th
    exceed = conf.gather(-1, sc) & (amp > thr.gather(-1, sc)) & nz
    ph_j = _buckets(nph, torch.where(exceed, sc, nph - 1),
                    torch.where(exceed, idx, S), "amin", S)
    a_l, j_l = ph_a[..., 1:cap + 1], ph_j[..., 1:cap + 1]
    valid = torch.arange(1, cap + 1, device=dev) <= nphase.unsqueeze(-1)
    ok = conf[..., 1:cap + 1] & valid
    return dict(t=a_l.to(F32), ok=ok,
                dt=torch.where(ok, (j_l - a_l).to(F32), 0.0),
                det=j_l.clamp_max(S - 1).to(I32),
                is_top=ph_sig[..., 1:cap + 1] > 0, valid=valid,
                overflow=(nphase > cap).any(dim=-1))


def gcr_zeros_track_scan(trans, pa, spb: float, maxb: int):
    """gcr.gcr_zeros_track_scan of the JAX package for every (segment,
    parmset, track) lane: the bit machine (gcr_bit_step) over each
    track's transition list, trans [B, T, cap] (zerocross_transitions'
    outputs), one step per list entry in a Python loop. An entry is
    emitted if it is ok and valid and its confirmation lag dt is within
    ZEROCROSS_SLOPE bit times of the lane's live clock. Returns the
    [B, P, T] state gcr_finish reads (no AGC: gains 0 and FLT_MAX; no
    peak statistics)."""
    okv = trans["ok"] & trans["valid"]
    B, T, cap = okv.shape
    P = len(pa.z1pt)
    dev = okv.device
    shape = (B, P, T)

    def knob(x):
        return x.to(dev).view(1, P, 1).expand(shape)
    z1, z2, padj = knob(pa.z1pt), knob(pa.z2pt), knob(pa.pulse_adj)
    cwin, calpha = knob(pa.clk_window), knob(pa.clk_alpha)
    clk_win = bool((pa.clk_window > 0).any())
    clk_exp = bool(((pa.clk_window <= 0) & (pa.clk_alpha > 0)).any())
    st = gcr_bit_state_init(spb, shape, dev)
    wrs = [torch.full(shape + (3,), maxb, dtype=I32, device=dev)]
    peaks = torch.zeros(shape, dtype=I32, device=dev)
    # entries past a track's valid prefix are never emitted
    for k in range(int(trans["valid"].sum(dim=-1).max()) if okv.numel()
                   else 0):
        emit = okv[..., k].unsqueeze(1) & (
            trans["dt"][..., k].unsqueeze(1)
            <= st["clkavg"]["t_bitspaceavg"] * ZEROCROSS_SLOPE)
        st, wr = gcr_bit_step(st, emit, trans["t"][..., k].unsqueeze(1)
                              .expand(shape), z1, z2, padj, cwin, calpha,
                              spb, maxb, clk_win=clk_win, clk_exp=clk_exp)
        wrs.append(wr)
        peaks += emit.to(I32)
    return dict(bits=gcr_replay_bits(torch.stack(wrs, dim=-2), maxb),
                datacount=st["datacount"], peakcount=peaks,
                t_firstbit=st["t_firstbit"], t_lastbit=st["t_lastbit"],
                **zeros_fixed_fields(shape, dev))


def zeros_fixed_fields(shape, device):
    """The fields gcr_finish reads that -zeros leaves at their initial
    values: no AGC (max 0, min FLT_MAX), no peak statistics, never
    incomplete."""
    return dict(max_agc_gain=torch.zeros(shape, dtype=F32, device=device),
                min_agc_gain=torch.full(shape, cm.FLT_MAX, dtype=F32,
                                        device=device),
                incomplete=torch.zeros(shape, dtype=torch.bool,
                                       device=device),
                hist=torch.zeros(tuple(shape) + (50,), dtype=I32,
                                 device=device),
                trksum=torch.zeros(shape, dtype=I32, device=device))


# ---------------------------------------------------------------------------
# ECC algebra (decode_gcr.c:111-341), vectorized over leading axes
# ---------------------------------------------------------------------------

def _reorder9_vec(x, order):
    out = torch.zeros_like(x)
    for i in range(9):
        out = out | (((x >> i) & 1) << int(order[i]))
    return out


def _reverse8_vec(x):
    out = torch.zeros_like(x)
    for i in range(8):
        out = out | (((x >> i) & 1) << (7 - i))
    return out


def _times_alpha_vec(s):
    return ((s << 1) & 0xFF) ^ torch.where(((s >> 7) & 1) == 1, 0x39, 0)


def _divby_alpha_vec(s):
    return (s >> 1) ^ torch.where((s & 1) == 1, 0x9C, 0)


def gcr_correct_errors(frames8, bad_tracks):
    """General 1-2 track ECC correction of 8-frame groups: frames8 [...,
    8] int32 in (msb..lsb, P) order; bad_tracks [...] (or an int): a
    9-bit mask in the reference's tom_order bit space (bit 7-t = data
    track t, bit 8 = parity). With one bit set (the reference's decode
    path passes 0x01) the syndrome locates the bad track; with two set
    both are corrected as erasures. Returns (ok [...], corrected [...,
    8])."""
    frames8 = frames8.to(I32)
    dev = frames8.device
    lead = frames8.shape[:-1]
    bad = torch.as_tensor(bad_tracks, dtype=I32, device=dev).expand(lead)
    tom = ((frames8 >> 1) & 0xFF) | ((frames8 & 1) << 8)
    B = _reorder9_vec(tom, gt.BIT_ORDER)
    bt = _reorder9_vec(bad, gt.BIT_ORDER)
    idx9 = torch.arange(9, dtype=I32, device=dev)
    setb = (bt.unsqueeze(-1) >> idx9) & 1                  # [..., 9]
    nset = setb.sum(dim=-1)
    pi = torch.where(nset > 0, setb.to(torch.int8).argmax(dim=-1), 0)
    setb2 = setb.scatter(-1, pi.long().unsqueeze(-1), 0)
    pj = torch.where(nset >= 2, setb2.to(torch.int8).argmax(dim=-1), pi)
    two = pj > pi

    par = cm.parity9(B)
    i8 = torch.arange(8, dtype=I32, device=dev)
    S1p = 0xFF ^ (par << i8).sum(dim=-1).to(I32)
    S2p = torch.zeros(lead, dtype=I32, device=dev)
    for i in range(8):
        S2p = _times_alpha_vec(S2p) ^ (B[..., i] & 0xFF)
    S2p = _reverse8_vec(S2p)

    # single-track path (pi == pj): the syndrome locates the track
    errloc = torch.where(S2p == 0, 8, -1)
    Sxp = S1p
    found = S2p == 0
    for i in range(8):
        hit = (~found) & (S2p == Sxp)
        errloc = torch.where(hit, i, errloc)
        found = found | hit
        Sxp = _divby_alpha_vec(Sxp)
    has_err = S1p != 0
    ok1 = (~has_err) | (errloc >= 0)
    do_fix1 = has_err & (errloc >= 0)
    loc = torch.clamp_min(errloc, 0).unsqueeze(-1)
    corr1 = torch.where(do_fix1.unsqueeze(-1),
                        ((S1p.unsqueeze(-1) >> i8) & 1) << loc, 0)

    # two-track path (pi < pj): erasure correction via Mk
    ms = torch.as_tensor(gt.CORR_MS, dtype=I32, device=dev)
    Mk = _reverse8_vec(ms[torch.clamp_max(pj - pi, 7).long()])   # [..., 8]
    Syp = S2p
    for i in range(8):
        Syp = torch.where(i < pi, _times_alpha_vec(Syp), Syp)
    Syp = Syp ^ S1p
    e2m = (cm.parity9(Mk & Syp.unsqueeze(-1)) << (7 - i8)).sum(dim=-1)
    e2p = torch.where(pj == 8, Syp, e2m.to(I32))
    e1p = e2p ^ S1p
    corr2 = ((((e1p.unsqueeze(-1) >> i8) & 1) << pi.unsqueeze(-1)) |
             (((e2p.unsqueeze(-1) >> i8) & 1) << pj.unsqueeze(-1)))

    corr = torch.where(two.unsqueeze(-1), corr2, corr1)
    ok = torch.where(two, True, ok1)
    applied = two | do_fix1 | (~has_err)
    B = B ^ torch.where(applied.unsqueeze(-1), corr, 0)
    back = _reorder9_vec(B, gt.UNDO_ORDER)
    out = ((back & 0xFF) << 1) | ((back >> 8) & 1)
    return ok, torch.where(applied.unsqueeze(-1), out, frames8).to(I32)


def gcr_correct_single(frames8):
    """The reference decode path's correction call: correct_errors with
    bad_tracks 0x01 (decode_gcr.c:593), the syndrome-locating path."""
    return gcr_correct_errors(frames8, 0x01)


def gcr_compute_ecc_vec(frames7):
    """ECC over 7 frames' data bytes (decode_gcr.c:127-144): frames7 [...,
    7] -> [...]."""
    bytes7 = (frames7.to(I32) >> 1) & 0xFF
    lo = torch.zeros(frames7.shape[:-1], dtype=I32, device=frames7.device)
    hi = torch.zeros_like(lo)
    for i in range(7):
        shift = 8 * (6 - i)          # byte i occupies bits [shift, shift+8)
        b = bytes7[..., i]
        if shift >= 28:
            hi = hi | (b << (shift - 28))
        elif shift + 8 <= 28:
            lo = lo | (b << shift)
        else:                        # straddles the 28-bit boundary
            lo = lo | ((b << shift) & 0xFFFFFFF)
            hi = hi | (b >> (28 - shift))
    lo = lo & 0xFFFFFFF
    ecc = torch.zeros_like(lo)
    for i in range(8):
        p = (cm.parity9(lo & int(gt.ECC_LO[i])) ^
             cm.parity9(hi & int(gt.ECC_HI[i])))
        ecc = ecc | (p << i)
    return ecc


def _ecc_ok(frames8):
    return gcr_compute_ecc_vec(frames8[..., :7]) == ((frames8[..., 7] >> 1)
                                                     & 0xFF)


# ---------------------------------------------------------------------------
# group-level postprocess (decode_gcr.c:503-674)
# ---------------------------------------------------------------------------

S_PREAMBLE, S_DATA_A, S_DATA_B, S_RESYNC = 0, 1, 2, 3
S_RESID_A, S_RESID_B, S_CRC_A, S_CRC_B, S_POSTAMBLE = 4, 5, 6, 7, 8
# class of the master track's storage group; FROZEN: past maxbits, where
# the state no longer moves
C_MARK1, C_MARK2, C_SYNC, C_OTHER, C_FROZEN = range(5)


def _transitions() -> np.ndarray:
    """next state [state, class] of gcr_postprocess's state machine."""
    tbl = np.repeat(np.arange(9)[:, None], 5, axis=1)
    live = [C_MARK1, C_MARK2, C_SYNC, C_OTHER]
    tbl[S_PREAMBLE, C_MARK1] = S_DATA_A
    tbl[S_DATA_A, [C_MARK1, C_OTHER]] = S_DATA_B
    tbl[S_DATA_A, C_MARK2] = S_RESYNC
    tbl[S_DATA_A, C_SYNC] = S_RESID_A
    tbl[S_DATA_B, live] = S_DATA_A
    tbl[S_RESYNC, C_MARK1] = S_DATA_A
    for a, b in ((S_RESID_A, S_RESID_B), (S_RESID_B, S_CRC_A),
                 (S_CRC_A, S_CRC_B), (S_CRC_B, S_POSTAMBLE)):
        tbl[a, live] = b
    return tbl


def _states(cls):
    """State before and after each group, from the classes cls [L, G]:
    M[l, g] maps the state before group 0 to the state after group g,
    built by doubling (Hillis-Steele composition of lookup tables)."""
    L, G = cls.shape
    tbl = torch.as_tensor(_transitions().T, dtype=torch.long,
                          device=cls.device)                  # [5, 9]
    M = tbl[cls.long()]                                        # [L, G, 9]
    d = 1
    while d < G:
        M = torch.cat([M[:, :d], M[:, d:].gather(-1, M[:, :-d])], dim=1)
        d *= 2
    after = M[..., S_PREAMBLE]
    before = torch.cat([torch.full((L, 1), S_PREAMBLE, dtype=torch.long,
                                   device=cls.device), after[:, :-1]], dim=1)
    return before, after


def gcr_postprocess(bits, maxbits, expected_parity: int, do_correct: bool,
                    maxb: int, do_correct2: bool = False):
    """Decode the storage bits of L lanes: bits [L, 9, maxb], maxbits [L].
    Returns decoded frames and error counts [L] (decode_gcr.c:503-674):
    state (after the last group), bytenum, data [L, maxb], vparity_errs,
    ecc_errs, bad_dgroups, gcr_bad_sequence, corrected_bits, first_error.

    do_correct2 is the JAX package's extension beyond the reference: when
    the 0x01 syndrome-located fix fails on a parity-bad group pair, up to
    two bad tracks named by the pair's invalid 5-bit codes are corrected
    as erasures."""
    T = 9
    L = bits.shape[0]
    dev = bits.device
    G = maxb // 5
    g_i = torch.arange(G, device=dev)
    k4 = torch.arange(4, device=dev)
    trk = torch.arange(T, device=dev)
    weights = torch.tensor([16, 8, 4, 2, 1], dtype=I32, device=dev)
    sg = (bits[..., :G * 5].to(I32).reshape(L, T, G, 5)
          * weights).sum(dim=-1)                                # [L, T, G]
    in_range = (g_i * 5 + 5).unsqueeze(0) <= maxbits.unsqueeze(-1)
    sub = sg[:, 0]                                 # master track (MTRK=0)
    datamap = torch.as_tensor(gt.GCR_DATAMAP, dtype=I32, device=dev)
    nib_raw = datamap[sg.long()]
    bad_code = nib_raw >= 16
    nibble = torch.where(bad_code, nib_raw - 16, nib_raw)
    shift = (T - 1 - trk).view(1, T, 1)
    frames4 = torch.stack([(((nibble >> (3 - k)) & 1) << shift).sum(dim=1)
                           for k in range(4)], dim=-1).to(I32)   # [L, G, 4]
    parbad = cm.parity9(frames4) != expected_parity
    nbad_par = parbad.sum(dim=-1)
    nbad_codes = bad_code.sum(dim=1)

    is_m1, is_m2 = sub == gt.GCR_MARK1, sub == gt.GCR_MARK2
    is_sync = sub == gt.GCR_SYNC
    cls = torch.where(is_m1, C_MARK1, torch.where(
        is_m2, C_MARK2, torch.where(is_sync, C_SYNC, C_OTHER)))
    state, after = _states(torch.where(in_range, cls, C_FROZEN))
    da_store = (state == S_DATA_A) & ~is_m2 & ~is_sync
    db = state == S_DATA_B
    crc = (state >= S_RESID_A) & (state <= S_CRC_B)
    store = (da_store | db | crc) & in_range
    isdb = db & in_range
    iscb = (state == S_CRC_B) & in_range
    bad_resync = (state == S_RESYNC) & ~is_m1 & ~is_sync & in_range

    # byte index before each group: +4 per stored group, -1 for the ECC
    # byte after each data pair, the CRC trim from the residual count
    # (the third frame of the CRC B group, read back right after it is
    # stored)
    resid_cnt = frames4[..., 2] >> 6
    dbn = (4 * store.long() - isdb.long() -
           torch.where(iscb, 16 - resid_cnt, 0).long())
    bn_after = torch.cumsum(dbn, dim=-1)
    bn = bn_after - dbn

    # the ECC check (and -correct fix) of each data pair: a DATA_B group
    # always follows the DATA_A group that stored its first four frames
    def prev(x):
        return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)
    frames8 = torch.cat([prev(frames4), frames4], dim=-1)      # [L, G, 8]
    ecc_err0 = isdb & ~_ecc_ok(frames8)
    bp = prev(nbad_par) + nbad_par
    ecc_errs = ecc_err0.sum(dim=-1)
    corrected = torch.zeros(L, dtype=torch.long, device=dev)
    do_fix = torch.zeros_like(isdb)
    fixed = frames8
    if do_correct:
        fix_ok, fixed = gcr_correct_single(frames8)
        do_fix = isdb & (bp > 0) & fix_ok
        if do_correct2:
            bad2 = prev(bad_code.transpose(1, 2)) | bad_code.transpose(1, 2)
            tom = torch.where(trk == 8, 8, 7 - trk)             # [T]
            mask2 = torch.where(bad2, 1 << tom, 0).sum(dim=-1)
            cnt2 = bad2.sum(dim=-1)
            ok2, fixed2 = gcr_correct_errors(frames8, mask2)
            do_fix2 = (isdb & (bp > 0) & ~do_fix & ok2 & (cnt2 >= 1) &
                       (cnt2 <= 2))
            fixed = torch.where(do_fix2.unsqueeze(-1), fixed2, fixed)
            do_fix = do_fix | do_fix2
        new_bp = (cm.parity9(fixed) != expected_parity).sum(dim=-1)
        ecc_errs = ecc_errs + (do_fix & ~_ecc_ok(fixed)).sum(dim=-1)
        corrected = do_fix.sum(dim=-1)
        bp = torch.where(do_fix, new_bp, bp)
    vpar = torch.where(isdb, bp, 0).sum(dim=-1)

    # first_error: the first parity-bad byte seen at store time (the ECC
    # byte included), else an ECC mismatch marks the pair's ECC byte
    first_par = torch.where(parbad, bn.unsqueeze(-1) + k4,
                            2 ** 30).amin(dim=-1)
    cand = torch.where(store & parbad.any(dim=-1), first_par,
                       torch.where(ecc_err0, bn + 3, -1))
    has = cand >= 0
    g_first = has.to(torch.int8).argmax(dim=-1, keepdim=True)
    first_error = torch.where(has.any(dim=-1),
                              cand.gather(-1, g_first).squeeze(-1), -1)

    # frame writes in program order, the last write to a position winning:
    # per group, its 4 stored frames, then the fixed pair (8 frames from
    # bn - 4), whose ECC byte the next group's store overwrites
    pos = torch.cat([torch.clamp_max(bn.unsqueeze(-1) + k4, maxb - 1),
                     torch.clamp(bn - 4, 0, maxb - 8).unsqueeze(-1)
                     + torch.arange(8, device=dev)], dim=-1)    # [L, G, 12]
    ok = torch.cat([store.unsqueeze(-1).expand(L, G, 4),
                    do_fix.unsqueeze(-1).expand(L, G, 8)], dim=-1)
    vals = torch.cat([frames4, fixed], dim=-1).reshape(L, -1)
    pos = torch.where(ok, pos, maxb).reshape(L, -1)
    order = torch.arange(pos.shape[-1], device=dev).expand(L, -1)
    last = torch.full((L, maxb + 1), -1, dtype=torch.long, device=dev)
    last = last.scatter_reduce(-1, pos, order, "amax")[:, :maxb]
    data = torch.where(last >= 0, vals.gather(-1, last.clamp_min(0)), 0)

    def i32(x):
        return x.to(I32)
    return dict(state=i32(after[:, -1]), bytenum=i32(bn_after[:, -1]),
                data=i32(data), vparity_errs=i32(vpar),
                ecc_errs=i32(ecc_errs), bad_dgroups=i32(
                    (store * nbad_codes).sum(dim=-1)),
                gcr_bad_sequence=i32(bad_resync.sum(dim=-1)),
                corrected_bits=i32(corrected), first_error=i32(first_error))


@telemetry.spanned("finish")
def gcr_finish(st, T: int, expected_parity: int, revparity: int,
               do_correct: bool, maxb: int, do_correct2: bool = False):
    """gcr_end_of_block (decode_gcr.c:682-729), batched over the leading
    lane axes of st (per-track fields [..., T], bits [..., T, maxb]); the
    tapemark test and the postprocess assume T = 9."""
    dev = st["datacount"].device
    dc = st["datacount"]
    pc = st["peakcount"]
    lead = dc.shape[:-1]
    minbits = dc.amin(dim=-1)
    maxbits = dc.amax(dim=-1)
    started = maxbits > 0
    spacing = cm.fdiv(st["t_lastbit"] - st["t_firstbit"],
                      torch.clamp_min(dc, 1).to(F32))
    # jnp.mean under jit: an in-order sum times the f32 reciprocal of T
    avg_sp = seq_sum(spacing) * float(np.float32(1) / np.float32(T))

    is_noise = maxbits <= 10
    with telemetry.wait("const_upload"):
        live = torch.tensor([1, 0, 1, 0, 0, 1, 1, 1, 1], dtype=torch.bool,
                            device=dev)
    is_tm = ((~is_noise) &
             torch.where(live, (dc >= 250) & (dc <= 400), True).all(dim=-1) &
             torch.where(~live, pc <= 2, True).all(dim=-1))
    mismatch = maxbits - minbits
    is_bad = (~is_noise) & (~is_tm) & (mismatch > 2)
    is_block = (~is_noise) & (~is_tm) & (~is_bad)

    post = gcr_postprocess(st["bits"].reshape((-1, T, maxb)),
                           maxbits.reshape(-1), expected_parity, do_correct,
                           maxb, do_correct2=do_correct2)
    post = {k: v.reshape(lead + v.shape[1:]) for k, v in post.items()}
    n = post["bytenum"]

    blktype = torch.where(~started, 0, torch.where(
        is_noise, BS_NOISE, torch.where(is_tm, BS_TAPEMARK, torch.where(
            is_bad, BS_BADBLOCK, BS_BLOCK))))

    def blk(k):
        return torch.where(is_block, post[k], 0)
    vpar, ecc, badseq = blk("vparity_errs"), blk("ecc_errs"), \
        blk("gcr_bad_sequence")
    baddg, corrected = blk("bad_dgroups"), blk("corrected_bits")
    track_mismatch = torch.where(is_bad, mismatch, 0)
    zero = torch.zeros_like(minbits)

    def i32(x):
        return x.to(I32)
    return dict(
        blktype=i32(blktype), minbits=i32(torch.where(is_block, n, minbits)),
        maxbits=i32(torch.where(is_block, n, maxbits)),
        track_mismatch=i32(track_mismatch), vparity_errs=i32(vpar),
        crc_errs=i32(zero), lrc_errs=i32(zero), ecc_errs=i32(ecc),
        gcr_bad_dgroups=i32(baddg), gcr_bad_sequence=i32(badseq),
        errcount=i32(track_mismatch + vpar + ecc + badseq),
        warncount=i32(baddg + corrected), first_error=post["first_error"],
        missed_midbits=i32(zero), corrected_bits=i32(corrected),
        faked_tracks=i32(zero), avg_bit_spacing=avg_sp,
        frames=post["data"], hist=st["hist"], trksums=st["trksum"],
        consume_overflow=st["incomplete"].any(dim=-1),
        alltrk_max_agc=st["max_agc_gain"].amax(dim=-1),
        alltrk_min_agc=st["min_agc_gain"].amin(dim=-1))
