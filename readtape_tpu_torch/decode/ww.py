"""Whirlwind I decoder (6-track 100 BPI, 2 bits per tape character) --
counterpart of readtape_tpu/decode/ww.py.

Whirlwind tapes carry redundant primary/alternate clock, MSB and LSB tracks
(decode_ww.c). A "pulse" is a full flux excursion -- two opposite peaks
(start + end). Data bits are pulses on the MSB/LSB tracks within one bit
time before a clock pulse end; a blockmark is an LSB pulse with no clock
running. Blocks can abut within a bit time, so the whole tape decodes as
ONE pass:

  1. per-track jump scans admit peaks (AGC on every pulse edge),
  2. the admitted transitions of all tracks merge in detection order,
  3. a single global scan replays the reference's pulse/clock/blockmark
     state machine, emitting 2-bit characters and block boundaries,
  4. block assembly (8 chars -> 16-bit words, leading-clock trim,
     -reverse) is done per block on the host.

This is the PLAIN version that the ww_fused_scan kernel is held against
(decode/fused.py). ``ww_track_scan`` is the JAX package's ``pre=True``,
non-chunked form over trackscan.run_jump_scan_seq, vectorized over tracks.
``ww_global_scan`` is a loop over the merged events: its float state is
0-d f32 tensors on the events' device, combined in the JAX function's
operation order, and it branches on the host where the JAX scan selects
with ``where`` (a branch not taken there leaves the state as it was).
"""

from __future__ import annotations

import numpy as np
import torch

from . import common as cm
from . import trackscan
from .common import F32, I32
from .nrzi import BS_BLOCK, BS_TAPEMARK

WWTRK_PRICLK, WWTRK_PRILSB, WWTRK_PRIMSB = 0, 1, 2
WWTRK_ALTCLK, WWTRK_ALTLSB, WWTRK_ALTMSB = 3, 4, 5
NOTRK = -1
# the track roles in WWTRK_* order, as ww_global_scan's keywords name them
ROLES = ("pri_clk", "pri_lsb", "pri_msb", "alt_clk", "alt_lsb", "alt_msb")

FLUX_POS, FLUX_NEG, FLUX_AUTO = 0, 1, 2
FLUX_DIRS = {"pos": FLUX_POS, "neg": FLUX_NEG, "auto": FLUX_AUTO}

REBASE_SPAN = 1 << 22     # rebase when an event is this far past the base
MAXBLOCKS = 4096          # block records kept (the last one is overwritten)


def parse_ww_order(order: str):
    """-order string like "CMLcml" -> dict of track-type -> track index
    (tracks numbered in head order, ignoring 'x'; readtape.c:869-902)."""
    type_to_trk = {k: NOTRK for k in range(6)}
    head_to_trk = []
    sym = {"C": WWTRK_PRICLK, "L": WWTRK_PRILSB, "M": WWTRK_PRIMSB,
           "c": WWTRK_ALTCLK, "l": WWTRK_ALTLSB, "m": WWTRK_ALTMSB}
    ntrks = 0
    for head, ch in enumerate(order):
        if ch == "x":
            head_to_trk.append(NOTRK)
            continue
        if ch not in sym:
            raise ValueError(f"bad Whirlwind track order symbol: {ch}")
        type_to_trk[sym[ch]] = ntrks
        head_to_trk.append(ntrks)
        ntrks += 1
    for need, name in [(WWTRK_PRICLK, "C"), (WWTRK_PRIMSB, "M"),
                       (WWTRK_PRILSB, "L")]:
        if type_to_trk[need] == NOTRK:
            raise ValueError(f"primary track '{name}' wasn't assigned")
    return type_to_trk, head_to_trk, ntrks


def ww_track_scan(feat, nxt, W, S: int, max_steps: int, K: int, rise_parm,
                  min_parm, agc_alpha, agc_window, v_avg_height_init,
                  agc_ring: int = cm.AGC_MAX_WINDOW):
    """Admission + the WW AGC policy for T tracks at once: adjust_agc on
    every pulse edge (decode_ww.c:171,190), v_avg_height per track from
    the deskew pass or the nominal value (decoder.c:484-497), and the
    average pulse heights (accumulate_avg_height) for the deskew pass.
    feat [T, S, 10] window features, nxt [T, S+1] jump tables; the knobs
    and v_avg_height_init are [T]; each track takes at most max_steps
    steps, and counts them in `steps`. Admitted transitions compact into
    [T, K] buffers (tr_s, tr_t, tr_frac, tr_top)."""
    T = feat.shape[0]
    dev = feat.device
    src = torch.arange(T, device=dev)
    # strategies some track uses (the others are computed nowhere)
    agc_exp = bool((agc_alpha > 0).any())
    agc_win = bool((agc_window > 0).any())

    def extra(st2, st, ev, admit_top, admit_bot, t_peak, s):
        admit = admit_top | admit_bot
        st2["peakcount"] = st["peakcount"] + admit.to(I32)
        st2["steps"] = st["steps"] + (s < S).to(I32)
        agc_new = cm.adjust_agc(st2, agc_alpha, agc_window, exp=agc_exp,
                                win=agc_win)
        st3 = dict(st2)
        for k in ("agc_gain", "v_heights", "heightndx", "max_agc_gain",
                  "min_agc_gain"):
            if agc_new[k] is not st2[k]:           # unchanged: nothing to pick
                st3[k] = trackscan._sel(admit, agc_new[k], st2[k])
        # average-height measurement (accumulate_avg_height at pulse ends;
        # decode_ww.c:189) for the deskew calibration pass
        height = st2["v_top"] - st2["v_bot"]
        meas = admit_top & (height > 0)
        st3["h_sum"] = st["h_sum"] + torch.where(meas, height, 0.0)
        st3["h_cnt"] = st["h_cnt"] + meas.to(I32)
        st3["v_lasttop"] = torch.where(admit_top, ev["wmax"],
                                       st["v_lasttop"])
        st3["v_lastbot"] = torch.where(admit_bot, ev["wmin"],
                                       st["v_lastbot"])
        # the exact sub-sample offset beside the time: the global scan
        # rebuilds local times as f32(s - base) + frac
        out = dict(admit=admit, s_det=s.to(I32), t_peak=t_peak,
                   t_frac=ev["frac"], is_top=admit_top)
        return st3, out

    init = trackscan.admission_init(W, (T,), dev, agc_ring)
    init.update(v_avg_height=torch.as_tensor(v_avg_height_init, dtype=F32,
                                             device=dev).expand(T).clone(),
                h_sum=torch.zeros(T, dtype=F32, device=dev),
                h_cnt=torch.zeros(T, dtype=I32, device=dev),
                steps=torch.zeros(T, dtype=I32, device=dev))
    final, outs = trackscan.run_jump_scan_seq(
        extra, init, lambda st, s: trackscan.gather_window_features(
            feat, src, s),
        lambda i: nxt[src, i], S, rise_parm, min_parm, max_steps)
    final.update(trackscan.compact_outputs(
        outs["admit"], K,
        tr_s=(outs["s_det"], trackscan.BIG_S),
        tr_t=(outs["t_peak"], 0.0),
        tr_frac=(outs["t_frac"], 0.0),
        tr_top=(outs["is_top"], False)))
    return final


def merge_transitions(trans, T: int, cap: int):
    """trans: dict of [T, K] compacted per-track transitions. Merge into one
    detection-ordered stream [cap]: within a sample, lower tracks first (the
    reference's per-sample track loop order). A STABLE sort on s_det over
    the [T, K] row-major flattening gives exactly that tiebreak."""
    K = trans["s_det"].shape[1]
    order = torch.argsort(trans["s_det"].reshape(-1), stable=True)[:cap]
    out = {k: v.reshape(-1)[order] for k, v in trans.items()}
    out["trk"] = (order // K).to(I32)
    out["valid"] = out["s_det"] < trackscan.BIG_S
    return out


class _Machine:
    """ww_global_scan's carried state. Floats are 0-d f32 tensors, never
    updated in place (a field is rebound to a new tensor), so one tensor
    may back several fields; integers and flags are host values."""

    def __init__(self, T, spb32, clk_window, clk_alpha, maxblocks,
                 maxchars, debug_times=False):
        self.T, self.spb, self.cw, self.ca = T, spb32, clk_window, clk_alpha
        self.maxblocks, self.maxchars = maxblocks, maxchars
        zero = torch.zeros((), dtype=F32, device=spb32.device)
        self.zero = zero
        self.clock_reset()
        for k in ("t_lcs", "t_lce", "t_lpcs", "t_lacs", "t_lpce", "t_lbm",
                  "ww_lastpeak"):
            setattr(self, k, zero)
        self.lps = [zero] * T          # per-track last pulse start
        self.lpe = [zero] * T          # per-track last pulse end
        self.lpk = [zero] * T          # per-track last peak
        self.plpk = [zero] * T         # per-track peak before that
        self.datablock = False
        self.datacount = self.blockstart = self.nblocks = 0
        self.miss1 = self.missclk = 0
        self.base = 0
        self.chars = np.zeros(maxchars, np.int8)
        # each data character's clock-end time (-trace), or None
        self.char_t = [zero] * maxchars if debug_times else None
        self.blk = {k: [0] * maxblocks for k in (
            "b_start", "b_end", "b_type", "b_t_base", "b_missing1",
            "b_missingclk")}
        self.blk_f = {k: [zero] * maxblocks for k in ("b_t_end",
                                                      "b_bitspace")}
        self.hist = np.zeros((T, 50), np.int32)
        self.trksums = np.zeros(T, np.int32)

    TIMES = ("t_lcs", "t_lce", "t_lpcs", "t_lacs", "t_lpce", "t_lbm",
             "ww_lastpeak")
    TRACK_TIMES = ("lps", "lpe", "lpk", "plpk")

    def clock_reset(self):
        """clkavg_init: the moving-window ring, its index and the
        average."""
        self.avg = self.spb
        self.ring = [self.spb] * cm.CLKRATE_WINDOW
        self.bitndx = 0

    def rebase(self, dsf):
        """Shift every carried time down by dsf; 0.0 ('never') stays."""
        def sh(x):
            return x if bool(x == 0.0) else x - dsf
        for k in self.TIMES:
            setattr(self, k, sh(getattr(self, k)))
        for k in self.TRACK_TIMES:
            setattr(self, k, [sh(x) for x in getattr(self, k)])

    def emit(self, btype, end_t):
        """Record a block boundary (ww_end_of_block / ww_blockmark); once
        the records are full the last one is overwritten. Then
        ww_init_blockstate: reset the clock and the per-track peaks."""
        i = min(self.nblocks, self.maxblocks - 1)
        for k, v in (("b_start", self.blockstart), ("b_end", self.datacount),
                     ("b_type", btype), ("b_t_base", self.base),
                     ("b_missing1", self.miss1),
                     ("b_missingclk", self.missclk)):
            self.blk[k][i] = v
        self.blk_f["b_t_end"][i] = end_t
        self.blk_f["b_bitspace"][i] = self.avg
        self.nblocks += 1
        self.blockstart = self.datacount
        self.miss1 = self.missclk = 0
        self.clock_reset()
        for k in ("t_lcs", "t_lce", "t_lpce", "t_lpcs", "t_lacs"):
            setattr(self, k, self.zero)
        self.datablock = False
        self.lpk = [self.zero] * self.T
        self.plpk = [self.zero] * self.T

    def adjust_clock(self, delta):
        """common.adjust_clock's three strategies on the scalar clock."""
        if self.cw > 0:
            old = self.ring[self.bitndx]
            self.ring[self.bitndx] = delta
            self.bitndx = 0 if self.bitndx + 1 >= self.cw else self.bitndx + 1
            self.avg = self.avg + cm.fdiv(
                delta - old, torch.tensor(float(max(self.cw, 1)), dtype=F32,
                                          device=delta.device))
        elif bool(self.ca > 0):
            # here XLA's CPU build fuses the OTHER product than in the
            # NRZI slot machine: (1 - a) * avg + a * delta, one rounding
            self.avg = cm.fma(1 - self.ca, self.avg, self.ca * delta)
        else:
            self.avg = self.spb

    def chk_databits(self, clkend, roles):
        """ww_chk_databits at a clock pulse end (decode_ww.c:51-92)."""
        lo = clkend - self.avg

        def chk(trk):
            if trk < 0:
                return 0
            tps = self.lps[trk]
            return 1 if bool(tps > lo) and bool(tps < clkend) else 2
        r_pm, r_am = chk(roles["pri_msb"]), chk(roles["alt_msb"])
        r_pl, r_al = chk(roles["pri_lsb"]), chk(roles["alt_lsb"])
        msb = int(r_pm == 1 or r_am == 1)
        lsb = int(r_pl == 1 or r_al == 1)
        miss = int((r_pm | r_am) == 3) + int((r_pl | r_al) == 3)
        self.chars[min(self.datacount, self.maxchars - 1)] = (msb << 1) | lsb
        if self.char_t is not None:
            self.char_t[min(self.datacount, self.maxchars - 1)] = clkend
        self.datacount = min(self.datacount + 1, self.maxchars)
        self.miss1 += miss


@torch.inference_mode()
def ww_global_scan(m_trk, m_t, m_s, m_is_top, m_valid, clk_window, clk_alpha,
                   spb, stat_leftbin=0.0, stat_binwidth=1.0, *, pri_clk,
                   pri_lsb, pri_msb, alt_clk, alt_lsb, alt_msb, T: int,
                   maxchars: int, maxblocks: int, fluxdir_req: int,
                   m_frac=None, span: int = REBASE_SPAN,
                   debug_times: bool = False):
    """The merged-stream state machine (decode_ww.c:51-271) and its
    trailing flush, over the merged events ([M] tensors on one device).

    Carried times are RELATIVE to a rolling integer base: when an event
    lands more than `span` samples past the base, the base jumps to it and
    every carried time shifts down (0.0 'never' sentinels preserved).
    Event times are f32(s - base) + frac (m_t itself while the base is 0).
    The [maxblocks] and [maxchars] writes clamp to the last index once
    full. Returns the final state: chars, datacount, nblocks, the b_*
    block records, hist [T, 50], trksums [T], flux, num_flux_changes and
    base, as tensors on the events' device; with debug_times also char_t
    [maxchars] f32, each data character's clock-end time in the carried
    (relative) time base (the -trace data lane, decode_ww.c:90)."""
    dev = m_t.device
    roles = dict(pri_clk=pri_clk, pri_lsb=pri_lsb, pri_msb=pri_msb,
                 alt_clk=alt_clk, alt_lsb=alt_lsb, alt_msb=alt_msb)
    clk_trks = {t for t in (pri_clk, alt_clk) if t >= 0}
    lsb_trks = [t for t in (pri_lsb, alt_lsb) if t >= 0]

    def f32(x):
        return torch.tensor(float(np.float32(x)), dtype=F32, device=dev)
    spb32, lb, bw = f32(spb), f32(stat_leftbin), f32(stat_binwidth)
    m = _Machine(T, spb32, int(clk_window), f32(clk_alpha), maxblocks,
                 maxchars, debug_times)
    m.flux = FLUX_NEG if fluxdir_req == FLUX_AUTO else fluxdir_req
    m.flux_set, m.nflux = False, 0

    trk_l, s_l = m_trk.tolist(), m_s.tolist()
    top_l, valid_l = m_is_top.tolist(), m_valid.tolist()
    # the rolling base depends on the event positions alone
    bases, base = [], 0
    for s, v in zip(s_l, valid_l):
        if v and s - base > span:
            base = s
        bases.append(base)
    base_t = torch.as_tensor(bases, dtype=I32, device=dev)
    s_rel_all = (m_s.to(I32) - base_t).to(F32)
    frac = m_frac if m_frac is not None else torch.zeros_like(m_t)
    t_all = torch.where(base_t == 0, m_t, s_rel_all + frac)

    for i, valid in enumerate(valid_l):
        if not valid:
            continue                 # invalid events are exact no-ops
        trk, s, top = trk_l[i], s_l[i], top_l[i]
        if bases[i] != m.base:       # the rolling rebase
            m.rebase(torch.tensor(s - m.base, dtype=I32,
                                  device=dev).to(F32))
            m.base = bases[i]
        t, s_rel = t_all[i], s_rel_all[i]
        b = m.avg

        # block end between events: the clock stopped (decoder.c:892-894)
        if m.datablock and bool(m.t_lce > 0) and bool(
                s_rel - m.t_lce > b * cm.WW_CLKSTOP_BITS):
            # queued blockmark: an LSB pulse end straggling past the last
            # clock (decode_ww.c:148-158)
            strag = any(bool(m.lpe[lt] - m.t_lce > b * cm.WW_PEAKSCLOSE_BITS)
                        for lt in lsb_trks)
            m.emit(BS_BLOCK, t)
            if strag:
                m.emit(BS_TAPEMARK, t)
                m.t_lbm = t

        # flux direction (decode_ww.c:244-271); mid-tape polarity changes
        # are counted like num_flux_polarity_changes (decode_ww.c:246)
        if fluxdir_req == FLUX_AUTO:
            if bool(t - m.ww_lastpeak > b * cm.WW_PEAKSFAR_BITS):
                newdir = FLUX_POS if top else FLUX_NEG
                if m.flux_set and newdir != m.flux:
                    m.nflux += 1
                m.flux, m.flux_set = newdir, True
            flux = m.flux
        else:
            flux = fluxdir_req
        m.ww_lastpeak = t

        if top == (flux == FLUX_POS):
            # ---- pulse start (decode_ww.c:167-183) ----
            m.lps[trk] = t
            if trk in clk_trks:
                m.datablock = True
                d = t - m.plpk[trk]
                if bool(d < b * cm.WW_PEAKSFAR_BITS):
                    m.adjust_clock(d)
                m.t_lcs = t
            if trk == pri_clk:
                m.t_lpcs = t
            if trk == alt_clk:
                m.t_lacs = t
        else:
            # ---- pulse end (decode_ww.c:185-232) ----
            m.lpe[trk] = t
            # skew statistics vs the last primary clock pulse end
            # (decode_ww.c:192-203): normalize the delta to ~one bit
            delta = t - m.t_lpce
            if (bool(m.t_lpce > 0) and bool(delta > -b * 1.5)
                    and bool(delta < b * 1.5)):
                if bool(delta <= 0) or bool(delta < b * 0.5):
                    delta = delta + b
                # (int) cast truncates toward zero (decoder.c:160)
                bkt = int(cm.fdiv(delta - lb, bw).to(I32))
                m.hist[trk, min(max(bkt, 0), 49)] += 1
                if 0 <= bkt <= 49:
                    m.trksums[trk] += 1
            if trk in clk_trks:
                if bool(t - m.t_lce > b * cm.WW_PEAKSCLOSE_BITS):
                    m.chk_databits(t, roles)
                m.t_lce = t
            # missing-clock warnings (decode_ww.c:210-223)
            if trk == pri_clk:
                if bool(m.t_lacs > 0) and bool(m.t_lacs < t - b):
                    m.missclk += 1
                m.t_lpce = t
            if trk == alt_clk and bool(m.t_lpcs > 0) and bool(
                    m.t_lpcs < t - b):
                m.missclk += 1
            # standalone blockmark: LSB pulse end with no clock running
            if (trk in lsb_trks and bool(m.t_lcs == 0)
                    and bool(t - m.t_lbm > b)):
                m.emit(BS_TAPEMARK, t)
                m.t_lbm = t

        # per-track peak history (process_up/down_transition tail)
        m.plpk[trk] = m.lpk[trk]
        m.lpk[trk] = t

    # flush a trailing block (samples continue past the last event, so the
    # clock-stop check would have fired eventually)
    strag = any(bool(m.lpe[lt] - m.t_lce > m.avg * cm.WW_PEAKSCLOSE_BITS)
                for lt in lsb_trks)
    if m.datablock and bool(m.t_lce > 0):
        m.emit(BS_BLOCK, m.t_lce)
        if strag:
            m.emit(BS_TAPEMARK, m.t_lce)

    def i32(x):
        return torch.as_tensor(np.asarray(x, np.int32), device=dev)
    out = {k: i32(v) for k, v in m.blk.items()}
    out.update({k: torch.stack(v) for k, v in m.blk_f.items()})
    out.update(chars=torch.as_tensor(m.chars, device=dev),
               datacount=i32(m.datacount), nblocks=i32(m.nblocks),
               hist=i32(m.hist), trksums=i32(m.trksums), flux=i32(m.flux),
               num_flux_changes=i32(m.nflux), base=i32(m.base),
               n_events=i32(sum(valid_l)))
    if debug_times:
        out["char_t"] = torch.stack(m.char_t)
    return out


def assemble_ww_blocks(res_host, spb, reverse: bool):
    """Host-side block assembly (ww_assemble_data, decode_ww.c:94-127)."""
    out = []
    chars = res_host["chars"]
    n = int(res_host["nblocks"])
    for i in range(min(n, len(res_host["b_start"]))):
        btype = int(res_host["b_type"][i])
        if btype == BS_TAPEMARK:
            out.append(dict(kind="tapemark", data=b"", warnings={},
                            t_end_samples=float(res_host["b_t_base"][i]) +
                            float(res_host["b_t_end"][i])))
            continue
        a, b = int(res_host["b_start"][i]), int(res_host["b_end"][i])
        two = np.asarray(chars[a:b], np.int32)
        lead = 0
        if len(two) % 8 == 1 and len(two) >= 9:
            # a spurious leading clock produced one extra char: drop it
            two = two[1:]
            lead = 1
        if reverse:
            two = two[::-1]
        nbytes = len(two) // 4
        usable = two[:nbytes * 4]
        if len(usable):
            quads = usable.reshape(-1, 4)
            byts = ((quads[:, 0] << 6) | (quads[:, 1] << 4) |
                    (quads[:, 2] << 2) | quads[:, 3]).astype(np.uint8)
        else:
            byts = np.zeros(0, np.uint8)
        bitspace = float(res_host["b_bitspace"][i])
        speed_err = 1 if abs(bitspace - spb) / spb > cm.WW_MAX_CLK_VARIATION \
            else 0
        warnings = dict(
            ww_leading_clock=lead,
            ww_missing_onebit=int(res_host["b_missing1"][i]),
            ww_missing_clock=int(res_host["b_missingclk"][i]),
            ww_bad_length=0 if len(two) % 8 == 0 else 1,
            ww_speed_err=speed_err,
            avg_bit_spacing=bitspace,
        )
        out.append(dict(kind="data", data=byts.tobytes(), warnings=warnings,
                        t_end_samples=float(res_host["b_t_base"][i]) +
                        float(res_host["b_t_end"][i])))
    return out
