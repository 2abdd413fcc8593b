"""The plain PyTorch versions of the port's NRZI (B1) and PE (B2) fused
decodes, frozen here as the benchmark's reference: a copy of
readtape_tpu_torch/decode/fused.py's ``nrzi_fused_scan_plain``,
``pe_fused_scan_plain`` and their read-outs, with the kernel wrappers,
GCR and Whirlwind taken out. Nothing here launches a kernel.
"""

from __future__ import annotations

import torch

from . import common as cm
from . import pe as pe_mod
from . import scan as scan_mod
from . import slot as slot_mod
from . import trackscan
from .common import F32, I32
# FusedOut's columns (decode/slot.py writes the same layout)
from .slot import (LI_CONSOVF, LI_CORR, LI_ENDS, LI_FAKED,  # noqa: F401
                   LI_MISSMID, LI_NSLOT, N_LI, N_TF, N_TI, TF_MAXAGC,
                   TF_MINAGC, TF_TFIRST, TF_TLAST, TI_DC, TI_INCOMP,
                   TI_KVIS, TI_NADM, TI_TRKSUM)

(PI_DC, PI_PEAKCNT, PI_CORR, PI_TRKSUM, PI_INCOMP, PI_NTOTAL) = range(6)
N_PI = 6
(PL_TAU, PL_GAVEUP, PL_CAND_AFTER, PL_CAND_RACE) = range(4)
N_PL = 4

MAX_TRACKS = 16


def _mask_jump_table(nxt, seg_len, lead_len, S: int):
    """Restrict candidates to [lead_len, seg_len): positions below the
    warmup lead snap forward to the first candidate at or after it,
    positions at or past the segment's true end vanish. nxt [B, T, S+1];
    seg_len, lead_len [B] (or lead_len [B, T]: each track's lead applies
    on its own)."""
    B, T, _ = nxt.shape
    lead = torch.as_tensor(lead_len, device=nxt.device).long()
    lead = lead.view(B, -1).expand(B, T).unsqueeze(-1)
    first = nxt.gather(-1, lead.clamp(0, nxt.shape[-1] - 1))
    iota = torch.arange(nxt.shape[-1], device=nxt.device)
    nxt = torch.where(iota < lead, first, nxt)
    seg = torch.as_tensor(seg_len, device=nxt.device).view(B, 1, 1)
    return torch.where(nxt < seg, nxt, S).to(I32)


def _union_jump_table(v, Ws, rise_floor, min_floor):
    """Candidate jump table valid for every parmset window width: the
    element-wise min over per-width tables is the union of the candidate
    sets."""
    nxt = None
    for W in sorted(set(Ws)):
        t_ = trackscan.loose_jump_table(v, W, rise_floor, min_floor)
        nxt = t_ if nxt is None else torch.minimum(nxt, t_)
    return nxt


def scan_step_budget(nsteps: int, chunk: int = 512) -> int:
    """The per-lane step cap of the JAX package's XLA admission scan
    (trackscan.run_jump_scan_seq): it runs whole chunks of min(chunk,
    nsteps) steps, ceil(nsteps / chunk) of them."""
    ch = max(1, min(chunk, nsteps))
    return -(-nsteps // ch) * ch


def _check(volts, seg_lens, leads, Ws, rise_floor, K, maxb, max_slots,
           max_steps):
    if volts.dim() != 3 or volts.dtype != F32:
        raise ValueError("volts must be float32 [B, T, S]")
    B, T, S = volts.shape
    if not 1 <= T <= MAX_TRACKS:
        raise ValueError(f"{T} tracks (at most {MAX_TRACKS})")
    if not Ws or max(Ws) > S or min(Ws) < 1:
        raise ValueError(f"bad window widths {Ws}")
    if tuple(seg_lens.shape) != (B,) or tuple(leads.shape) != (B,):
        raise ValueError("seg_lens and leads must be [B]")
    if tuple(rise_floor.shape) != (T,):
        raise ValueError("rise_floor/min_floor must be [T]")
    if min(K, maxb, max_slots, max_steps) < 1:
        raise ValueError("K, maxb, max_slots and max_steps must be "
                         "positive")


@torch.inference_mode()
def nrzi_fused_scan_plain(volts, seg_lens, leads, pa: cm.ParmArrays, *,
                          Ws, rise_floor, min_floor, stat_lb: float,
                          stat_bw: float, expected_parity: int, spb: float,
                          do_correct: bool, maxb: int, max_slots: int,
                          K: int, max_steps: int):
    """The plain PyTorch version of the kernel (same arguments and
    outputs as nrzi_fused_scan): union jump table -> per-lane admission
    scans (scan.scan_lanes) -> slot scans (slot.slot_lanes), the plain
    versions of B5 and B6 without their counters."""
    nrzi_fused_scan_plain.calls += 1
    _check(volts, seg_lens, leads, Ws, rise_floor, K, maxb, max_slots,
           max_steps)
    S = volts.shape[-1]
    nxt = _mask_jump_table(_union_jump_table(volts, Ws, rise_floor,
                                             min_floor),
                           seg_lens, leads, S)                # [B, T, S+1]
    fin = scan_mod.scan_lanes(scan_mod.window_features(volts, Ws), nxt, pa,
                              Ws, K, max_steps)
    return slot_mod.slot_lanes(
        fin, pa, S=S, spb=spb, expected_parity=expected_parity,
        do_correct=do_correct, maxb=maxb, max_slots=max_slots,
        stat_lb=stat_lb, stat_bw=stat_bw)


nrzi_fused_scan_plain.calls = 0


def fused_state(out) -> dict:
    """The JAX package's fused_state dict, field for field, for every lane
    of a FusedOut at once (leading [B, P] axes)."""
    ti, tf, li = out["trk_i"], out["trk_f"], out["lane_i"]
    return dict(
        dc=ti[..., TI_DC],
        kvis=ti[..., TI_KVIS],
        bits=out["bits"],
        t_firstbit=tf[..., TF_TFIRST],
        t_lastbit=tf[..., TF_TLAST],
        missed_midbits=li[..., LI_MISSMID],
        corrected_bits=li[..., LI_CORR],
        faked_tracks=li[..., LI_FAKED],
        hist=out["hist"],
        trksums=ti[..., TI_TRKSUM],
        consume_overflow=li[..., LI_CONSOVF] > 0,
        end_s=li[..., LI_ENDS],
        n_admitted=ti[..., TI_NADM],
        max_agc_gain=tf[..., TF_MAXAGC],
        min_agc_gain=tf[..., TF_MINAGC],
        incomplete=ti[..., TI_INCOMP] > 0,
        bail=torch.zeros_like(li[..., LI_CONSOVF], dtype=torch.bool),
    )


# ---------------------------------------------------------------------------
# PE
# ---------------------------------------------------------------------------

def _check_pe(volts, seg_lens, leads, Ws, rise_floor, maxb, K, max_steps):
    _check(volts, seg_lens, leads, Ws, rise_floor, K, maxb, 1, max_steps)
    if K < max_steps:
        raise ValueError("K must hold one record per step (K >= max_steps)")


def _pe_jump_tables(volts, seg_lens, leads, Ws, rise_floor, min_floor,
                    stagger=True):
    """The union candidacy masked per window width W to each track's own
    [lead + t + W - 1, seg_len): the reference's moving window refills
    sample by sample after each track's staggered start (without stagger,
    the -trace scan's, to [0, seg_len)). Returns {W: nxt [B, T, S+1]}."""
    B, T, S = volts.shape
    nxt_union = _union_jump_table(volts, Ws, rise_floor, min_floor)
    trk = torch.arange(T, device=volts.device)
    return {W: _mask_jump_table(nxt_union, seg_lens,
                                leads.long().view(B, 1) + trk + W - 1
                                if stagger else torch.zeros_like(leads), S)
            for W in sorted(set(Ws))}


def _track_lanes(volts, seg_lens, leads, Ws, rise_floor, min_floor,
                 stagger=True):
    """What the per-track scans of PE and GCR share: per-width jump
    tables and window features, and every (segment, parmset, track) lane
    in (b, p, t) order. Returns (feat [G*B*T, S, 10], nxt [G*B*T, S+1],
    src [N] (each lane's row of both), pl [N] (its parmset), lead_l [N]
    (its track's staggered start lead + t), the smallest width's jump
    table [B, T, S+1])."""
    dev = volts.device
    B, T, S = volts.shape
    P = len(Ws)
    wset = sorted(set(Ws))
    G = len(wset)
    tables = _pe_jump_tables(volts, seg_lens, leads, Ws, rise_floor,
                             min_floor, stagger)
    nxt = torch.stack([tables[W] for W in wset]).reshape(G * B * T, S + 1)
    feat = torch.stack([trackscan.precompute_window_features(volts, W)
                        .transpose(-1, -2) for W in wset])   # [G,B,T,S,10]
    feat = feat.reshape(G * B * T, S, trackscan.N_FEAT)
    b_i = torch.arange(B, device=dev).view(B, 1, 1).expand(B, P, T)
    p_i = torch.arange(P, device=dev).view(1, P, 1).expand(B, P, T)
    t_i = torch.arange(T, device=dev).view(1, 1, T).expand(B, P, T)
    grp = torch.as_tensor([wset.index(w) for w in Ws], device=dev)
    src = ((grp[p_i] * B + b_i) * T + t_i).reshape(-1)
    lead_l = leads.to(dev).long()[b_i.reshape(-1)] + t_i.reshape(-1)
    return feat, nxt, src, p_i.reshape(-1), lead_l, tables[wset[0]]


def _lane_streams(fin, B, P, T):
    """A per-track scan's idle intervals, counts and record streams with
    lane axes [B*P, T, ...]."""
    keys = [k for k in fin if k.startswith("_st_")] + [
        "ie_e", "ie_w", "n_ie", "ie_trail", "incomplete", "n_admitted"]
    return {k: fin[k].reshape((B * P, T) + fin[k].shape[1:]) for k in keys}


def pe_scan_lanes(volts, seg_lens, leads, pa: cm.ParmArrays, *, Ws,
                  rise_floor, min_floor, stat_lb: float, stat_bw: float,
                  spb: float, maxb: int, max_steps: int,
                  trace_scan: bool = False):
    """The PE scan of every (segment, parmset, track) lane
    (pe.pe_track_scan; with trace_scan the -trace scan and its debug
    streams). Returns (the scans' idle intervals, counts and record
    streams with lane axes [B*P, T, ...], the smallest width's jump table
    [B, T, S+1])."""
    dev = volts.device
    B, T, S = volts.shape
    feat, nxt, src, pl, lead_l, first = _track_lanes(
        volts, seg_lens, leads, Ws, rise_floor, min_floor,
        stagger=not trace_scan)
    fin = pe_mod.pe_track_scan(
        feat, src, nxt, src, torch.as_tensor(Ws, dtype=I32, device=dev)[pl],
        S, max_steps, pa.pkww_rise[pl], pa.min_peak[pl], pa.agc_alpha[pl],
        pa.agc_window[pl], pa.clk_window[pl], pa.clk_alpha[pl],
        pa.clk_factor[pl], pa.pulse_adj[pl], spb, maxb, stat_lb, stat_bw,
        t_lp_virtual=(torch.zeros_like(lead_l) if trace_scan
                      else lead_l).to(F32),
        s_first_check=lead_l + 1, clk_ring=max(int(pa.clk_window.max()), 1),
        agc_ring=max(int(pa.agc_window.max()), 1), debug=trace_scan)
    return _lane_streams(fin, B, len(Ws), T), first


def _records(peaks, B, P, T, f2, i2):
    """rec_f, rec_i and rec_n from a debug_peaks dict compacted to K
    entries per track ([B*P*T, K] fields) and the second columns of rec_f
    (f2) and rec_i (i2)."""
    def lanes(x):
        return x.reshape((B, P, T) + x.shape[1:])
    return dict(
        rec_f=lanes(torch.stack([peaks["tr_t"], f2], dim=-1)),
        rec_i=lanes(torch.stack([peaks["tr_top"].to(I32), i2], dim=-1)),
        rec_n=lanes(peaks["n_admitted"]))


@torch.inference_mode()
def pe_fused_scan_plain(volts, seg_lens, leads, pa: cm.ParmArrays, *, Ws,
                        rise_floor, min_floor, stat_lb: float,
                        stat_bw: float, spb: float, maxb: int, K: int,
                        max_steps: int, trace_scan: bool = False):
    """The plain PyTorch version of the PE kernel (same arguments and
    outputs as pe_fused_scan): the per-lane PE scans (pe_scan_lanes) ->
    tau -> the replay truncated at tau -> the first candidates after
    tau."""
    pe_fused_scan_plain.calls += 1
    _check_pe(volts, seg_lens, leads, Ws, rise_floor, maxb, K, max_steps)
    B, T, S = volts.shape
    P = len(Ws)
    fin, first = pe_scan_lanes(
        volts, seg_lens, leads, pa, Ws=Ws, rise_floor=rise_floor,
        min_floor=min_floor, stat_lb=stat_lb, stat_bw=stat_bw, spb=spb,
        maxb=maxb, max_steps=max_steps, trace_scan=trace_scan)
    tau, gaveup = pe_mod.lane_tau(fin["ie_e"], fin["ie_w"], fin["n_ie"],
                                  fin["ie_trail"])
    tr = pe_mod.pe_apply_tau(fin, maxb, tau)

    # first (smallest-W) candidates after tau and at tau - max(Ws)
    first = first.long()
    tau_b = tau.view(B, P).long()

    def cand_at(x):
        idx = torch.clamp(x, 0, S).unsqueeze(1).expand(B, T, P)
        return first.gather(-1, idx).amin(dim=1)             # [B, P]
    trk_i = torch.stack([tr["datacount"], tr["peakcount"],
                         tr["corrected_bits"], tr["trksum"],
                         tr["incomplete"].to(I32), tr["n_total"]], dim=-1)
    trk_f = torch.stack([tr["t_firstbit"], tr["t_lastbit"],
                         tr["max_agc_gain"], tr["min_agc_gain"]], dim=-1)
    lane_i = torch.stack([tau_b, gaveup.view(B, P).long(),
                          cand_at(tau_b + 1), cand_at(tau_b - max(Ws))],
                         dim=-1)
    out = dict(bits=tr["bits"].reshape(B, P, T, maxb),
               faked=tr["faked"].reshape(B, P, T, maxb),
               hist=tr["hist"].reshape(B, P, T, 50),
               trk_i=trk_i.reshape(B, P, T, N_PI).to(I32),
               trk_f=trk_f.reshape(B, P, T, N_TF),
               lane_i=lane_i.to(I32))
    if trace_scan:
        pk = pe_mod.debug_peaks({k: v.flatten(0, 1) for k, v in fin.items()
                                 if k.startswith("_st_")}, K)
        out.update(_records(pk, B, P, T, pk["tr_clkw"],
                            pk["tr_isdata"].to(I32)
                            | (pk["tr_bitval"].to(I32) << 1)))
    return out


pe_fused_scan_plain.calls = 0


def pe_fused_state(out) -> dict:
    """Per-track block state (pe_apply_tau's fields, for pe_finish) and
    the lane fields of a PeOut, with leading [B, P] axes."""
    ti, tf, li = out["trk_i"], out["trk_f"], out["lane_i"]
    return dict(
        bits=out["bits"], faked=out["faked"], hist=out["hist"],
        datacount=ti[..., PI_DC], peakcount=ti[..., PI_PEAKCNT],
        n_consumed=ti[..., PI_PEAKCNT], corrected_bits=ti[..., PI_CORR],
        trksum=ti[..., PI_TRKSUM], incomplete=ti[..., PI_INCOMP] > 0,
        n_total=ti[..., PI_NTOTAL],
        t_firstbit=tf[..., TF_TFIRST], t_lastbit=tf[..., TF_TLAST],
        max_agc_gain=tf[..., TF_MAXAGC], min_agc_gain=tf[..., TF_MINAGC],
        tau=li[..., PL_TAU], tau_gaveup=li[..., PL_GAVEUP] > 0,
        cand_after=li[..., PL_CAND_AFTER], cand_race=li[..., PL_CAND_RACE])
