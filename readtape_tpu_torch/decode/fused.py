"""The fused NRZI, PE, GCR and Whirlwind decodes -- counterparts of those
parts of readtape_tpu/decode/pallas_fused.py.

``nrzi_fused_scan`` runs window features, peak admission with AGC, the
global bit-slot machine, ``-correct``'s column-0 flip, the bits, the peak
histogram and the block scalars for every (segment, parmset) lane in one
call. On a CUDA tensor it launches the hand-written kernel
(csrc/nrzi_fused.cu, built by kernels.py); on a CPU tensor it runs
``nrzi_fused_scan_plain``, the same computation in plain PyTorch built
from stage1/trackscan/nrzi (the JAX package's XLA recipe). There is no
fallback between the two: a CUDA tensor launches the kernel or raises.

Unlike the TPU kernel, neither version keeps a bounded transition ring:
each lane's admitted transitions live in a [T, K] buffer with
compact_outputs' overflow rule, so nothing bails and no segment needs a
second decode. Both keep the JAX XLA scan's admission step budget
(scan_step_budget), which decides the JAX package's output on segments
dense enough to reach it.

Outputs (``FusedOut``), typed, for B segments x P parmsets:
  bits  int8  [B, P, T, maxb]
  hist  int32 [B, P, T, 50]
  trk_i int32 [B, P, T, 5]   TI_* per-track integers
  trk_f f32   [B, P, T, 4]   TF_* per-track floats
  lane_i int32 [B, P, 6]     LI_* per-lane integers
``fused_state`` reads them out into the JAX package's fused_state dict.

``pe_fused_scan`` does the same for PE (csrc/pe_fused.cu, plain version
``pe_fused_scan_plain`` built from decode/pe.py). It computes what the
JAX package's _pe_segment_device computes, the reference semantics its CPU
tests and fuzzing hold: per-track admission with the PE state machine,
each track's idle intervals, the lane's all-idle point tau, the records
replayed up to tau, and the first candidates after it. Outputs
(``PeOut``):
  bits, faked int8  [B, P, T, maxb]
  hist  int32 [B, P, T, 50]
  trk_i int32 [B, P, T, 6]   PI_* per-track integers
  trk_f f32   [B, P, T, 4]   TF_* per-track floats
  lane_i int32 [B, P, 4]     PL_* per-lane integers
``pe_fused_state`` reads them out for pe_finish and the pipeline.

With ``trace_scan=True`` pe_fused_scan and gcr_fused_scan replace the
decode's scan by the JAX package's -trace scan (its pe_track_scan /
gcr_track_scan without idle tracking): candidates in [0, seg_len) on
every track; for PE the pre-first-peak t_lastpeak 0 and the exponential
clock contracted as fma(1 - a, avg, a * delta) (XLA's CPU build of that
scan), for GCR no mid-scan idle. They return each track's admitted peaks
beside the outputs above (the outputs are then those of that scan, which
nothing reads):
  rec_f float32 [B, P, T, K, 2]  the peak time, then PE the clock window
                                 after it, GCR the pulse adjustment
  rec_i int32   [B, P, T, K, 2]  top (1) or bottom, then PE is_data |
                                 bitval << 1, GCR the zeros inferred
                                 before the peak
  rec_n int32   [B, P, T]        admitted peaks (entries past it are 0)

``gcr_fused_scan`` does the same for GCR (csrc/gcr_fused.cu, plain version
``gcr_fused_scan_plain`` built from decode/gcr.py), computing what the
JAX package's _gcr_segment_device computes without -zeros: per-track
admission with the GCR bit machine, idle intervals, tau, the records
replayed up to tau and the first candidates after it. The group-level
postprocess (gcr_finish) stays outside, in plain PyTorch. Outputs
(``GcrOut``):
  bits  int8  [B, P, T, maxb]
  hist  int32 [B, P, T, 50]
  trk_i int32 [B, P, T, 5]   GI_* per-track integers
  trk_f f32   [B, P, T, 4]   TF_* per-track floats
  lane_i int32 [B, P, 2]     GL_* per-lane integers
``gcr_fused_state`` reads them out for gcr_finish and the pipeline.

``ww_fused_scan`` runs the whole Whirlwind decode of one tape (one lane,
one parmset) in one call (csrc/ww_fused.cu, plain version
``ww_fused_scan_plain`` built from decode/ww.py): per-track admission with
WW's AGC policy, the merge of every track's transitions in detection
order, and the pulse/clock/blockmark machine with its rolling integer
time base and trailing flush -- the JAX package's XLA recipe
(run_pass_single), not its TPU kernel, but without the XLA scan's
admission step budget: like the TPU kernel, each track's scan runs to the
end of the tape. The XLA path pools 3.2 steps per bit over the whole tape
and a Whirlwind clock track takes ~3.7 per character, so on a tape
that is nearly all blocks (bench.py's) it stops early and loses the rest
of the tape. Outputs (``WwOut``):
  chars  int8  [maxchars]          2-bit characters
  blk_i  int32 [maxblocks, 6]      WB_* block records
  blk_f  f32   [maxblocks, 2]      WBF_* block times and bit spacing
  hist   int32 [T, 50]
  trk_i  int32 [T, 4]              WT_* per-track integers
  trk_f  f32   [T]                 h_sum, the pulse heights' sum
  scal   int32 [6]                 WS_* scalars
``ww_fused_state`` reads them out into run_pass_single's fields. With
``records=True`` it also returns the -trace records: tr_t f32 [T, K] and
tr_top int8 [T, K] (each track's admitted peaks, trk_i's WT_NADM of them,
the last in K - 1 past K) and char_t f32 [maxchars] (each data
character's clock-end time).
"""

from __future__ import annotations

import torch

from .. import kernels, telemetry
from . import common as cm
from . import gcr as gcr_mod
from . import pe as pe_mod
from . import scan as scan_mod
from . import slot as slot_mod
from . import trackscan
from . import ww as ww_mod
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
(GI_DC, GI_PEAKCNT, GI_TRKSUM, GI_INCOMP, GI_NTOTAL) = range(5)
N_GI = 5
(GL_TAU, GL_CAND_AFTER) = range(2)
N_GL = 2
(WB_START, WB_END, WB_TYPE, WB_TBASE, WB_MISS1, WB_MISSCLK) = range(6)
N_WB = 6
(WBF_TEND, WBF_BITSPACE) = range(2)
N_WBF = 2
# WT_STEPS, the admission steps a track took, feeds no decode: the tests
# read it to show where the XLA scan's step budget would have bound
(WT_TRKSUM, WT_NADM, WT_HCNT, WT_STEPS) = range(4)
N_WT = 4
(WS_DATACOUNT, WS_NBLOCKS, WS_FLUX, WS_NFLUX, WS_BASE, WS_NEVENTS) = range(6)
N_WS = 6
WW_MAX_SAMPLES = 1 << 30   # positions stay int32 below the BIG_S sentinel

MAX_TRACKS = kernels.NRZI_MAX_TRACKS
MAX_AGC_RING = kernels.NRZI_MAX_AGC_RING
MAX_CLK_RING = kernels.NRZI_MAX_CLK_RING


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


def _dispatch(name, plain, launch, check, volts, seg_lens, leads, pa, args):
    """A wrapper's body: the plain version on a CPU tensor; on a CUDA
    tensor the kernel, after check() and the ring sizes, or raise.
    Returns (outputs, launched)."""
    if volts.device.type == "cpu":
        return plain(volts, seg_lens, leads, pa, **args), False
    if volts.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {volts.device}")
    with telemetry.span("launch." + name):
        telemetry.count("launches." + name)
        check()
        with telemetry.wait("ring_check", 2):
            rings = int(pa.agc_window.max()), int(pa.clk_window.max())
        if rings[0] > MAX_AGC_RING or rings[1] > MAX_CLK_RING:
            raise ValueError("agc_window/clk_window beyond the kernel's "
                             "rings")
        return launch(volts, seg_lens, leads, pa, **args), True


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


def nrzi_fused_scan(volts, seg_lens, leads, pa: cm.ParmArrays, *, Ws,
                    rise_floor, min_floor, stat_lb: float, stat_bw: float,
                    expected_parity: int, spb: float, do_correct: bool,
                    maxb: int, max_slots: int, K: int, max_steps: int):
    """volts: [B, T, S] f32 (segment-relative, S the shared bucket);
    seg_lens, leads: [B] int (candidates live in [lead, seg_len)); pa: the
    P active parmsets, Ws their window widths; rise_floor/min_floor: [T]
    loose-candidate floors; stat_lb/stat_bw: peak-statistics bins in
    samples. K: transition buffer entries per track; maxb: bit buffer
    length; max_slots: slot-machine cap; max_steps: admission step budget
    per track (scan_step_budget). Returns FusedOut (see module
    docstring)."""
    args = dict(Ws=tuple(int(w) for w in Ws), rise_floor=rise_floor,
                min_floor=min_floor, stat_lb=stat_lb, stat_bw=stat_bw,
                expected_parity=int(expected_parity), spb=float(spb),
                do_correct=bool(do_correct), maxb=int(maxb),
                max_slots=int(max_slots), K=int(K),
                max_steps=int(max_steps))
    out, launched = _dispatch(
        "nrzi_fused_scan", nrzi_fused_scan_plain, kernels.nrzi_fused,
        lambda: _check(volts, seg_lens, leads, args["Ws"], rise_floor, K,
                       maxb, max_slots, max_steps),
        volts, seg_lens, leads, pa, args)
    nrzi_fused_scan.launches += launched
    return out


nrzi_fused_scan.launches = 0


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


def _idle_scan(name, plain, launch, volts, seg_lens, leads, pa, *, Ws,
               rise_floor, min_floor, stat_lb, stat_bw, spb, maxb, K,
               max_steps, trace_scan):
    """pe_fused_scan's and gcr_fused_scan's body (their arguments are the
    same): _dispatch with the arguments normalized."""
    args = dict(Ws=tuple(int(w) for w in Ws), rise_floor=rise_floor,
                min_floor=min_floor, stat_lb=stat_lb, stat_bw=stat_bw,
                spb=float(spb), maxb=int(maxb), K=int(K),
                max_steps=int(max_steps), trace_scan=bool(trace_scan))
    return _dispatch(name, plain, launch, lambda: _check_pe(
        volts, seg_lens, leads, args["Ws"], rise_floor, maxb, K, max_steps),
        volts, seg_lens, leads, pa, args)


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


def pe_fused_scan(volts, seg_lens, leads, pa: cm.ParmArrays, *, Ws,
                  rise_floor, min_floor, stat_lb: float, stat_bw: float,
                  spb: float, maxb: int, K: int, max_steps: int,
                  trace_scan: bool = False):
    """volts: [B, T, S] f32; seg_lens, leads: [B] int (track t's
    candidates live in [lead + t + W - 1, seg_len)); pa: the P active
    parmsets, Ws their window widths; rise_floor/min_floor: [T]
    loose-candidate floors; stat_lb/stat_bw: peak-statistics bins in
    samples; maxb: bit buffer length; K: record buffer entries per track
    (>= max_steps); max_steps: admission step budget per track
    (scan_step_budget); trace_scan: run the -trace scan in place of the
    decode's and return its records (module docstring); the other outputs
    are then that scan's. Returns PeOut (see module docstring)."""
    out, launched = _idle_scan(
        "pe_fused_scan", pe_fused_scan_plain, kernels.pe_fused, volts,
        seg_lens, leads, pa, Ws=Ws, rise_floor=rise_floor,
        min_floor=min_floor, stat_lb=stat_lb, stat_bw=stat_bw, spb=spb,
        maxb=maxb, K=K, max_steps=max_steps, trace_scan=trace_scan)
    pe_fused_scan.launches += launched
    return out


pe_fused_scan.launches = 0


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


# ---------------------------------------------------------------------------
# GCR
# ---------------------------------------------------------------------------

def gcr_scan_lanes(volts, seg_lens, leads, pa: cm.ParmArrays, *, Ws,
                   rise_floor, min_floor, stat_lb: float, stat_bw: float,
                   spb: float, maxb: int, max_steps: int,
                   trace_scan: bool = False):
    """The GCR scan of every (segment, parmset, track) lane
    (gcr.gcr_track_scan; with trace_scan the -trace scan and its debug
    streams). Returns what pe_scan_lanes returns."""
    dev = volts.device
    B, T, S = volts.shape
    feat, nxt, src, pl, lead_l, first = _track_lanes(
        volts, seg_lens, leads, Ws, rise_floor, min_floor,
        stagger=not trace_scan)
    fin = gcr_mod.gcr_track_scan(
        feat, src, nxt, src, torch.as_tensor(Ws, dtype=I32, device=dev)[pl],
        S, max_steps, pa.pkww_rise[pl], pa.min_peak[pl], pa.agc_alpha[pl],
        pa.agc_window[pl], pa.clk_window[pl], pa.clk_alpha[pl],
        pa.z1pt[pl], pa.z2pt[pl], pa.pulse_adj[pl], spb, maxb, stat_lb,
        stat_bw, s_first_check=lead_l + 1,
        clk_ring=max(int(pa.clk_window.max()), 1),
        agc_ring=max(int(pa.agc_window.max()), 1), debug=trace_scan)
    return _lane_streams(fin, B, len(Ws), T), first


@torch.inference_mode()
def gcr_fused_scan_plain(volts, seg_lens, leads, pa: cm.ParmArrays, *, Ws,
                         rise_floor, min_floor, stat_lb: float,
                         stat_bw: float, spb: float, maxb: int, K: int,
                         max_steps: int, trace_scan: bool = False):
    """The plain PyTorch version of the GCR kernel (same arguments and
    outputs as gcr_fused_scan): the per-lane GCR scans (gcr_scan_lanes) ->
    tau (an overflowing interval stream gives none) -> the replay
    truncated at tau -> the first candidates after tau."""
    gcr_fused_scan_plain.calls += 1
    _check_pe(volts, seg_lens, leads, Ws, rise_floor, maxb, K, max_steps)
    B, T, S = volts.shape
    P = len(Ws)
    fin, first = gcr_scan_lanes(
        volts, seg_lens, leads, pa, Ws=Ws, rise_floor=rise_floor,
        min_floor=min_floor, stat_lb=stat_lb, stat_bw=stat_bw, spb=spb,
        maxb=maxb, max_steps=max_steps, trace_scan=trace_scan)
    tau, _ = pe_mod.lane_tau(fin["ie_e"], fin["ie_w"], fin["n_ie"],
                             fin["ie_trail"])
    tr = gcr_mod.gcr_apply_tau(fin, maxb, tau)
    tau_b = tau.view(B, P).long()
    idx = torch.clamp(tau_b + 1, 0, S).unsqueeze(1).expand(B, T, P)
    cand_after = first.long().gather(-1, idx).amin(dim=1)       # [B, P]
    trk_i = torch.stack([tr["datacount"], tr["peakcount"], tr["trksum"],
                         tr["incomplete"].to(I32), tr["n_total"]], dim=-1)
    trk_f = torch.stack([tr["t_firstbit"], tr["t_lastbit"],
                         tr["max_agc_gain"], tr["min_agc_gain"]], dim=-1)
    out = dict(bits=tr["bits"].reshape(B, P, T, maxb),
               hist=tr["hist"].reshape(B, P, T, 50),
               trk_i=trk_i.reshape(B, P, T, N_GI).to(I32),
               trk_f=trk_f.reshape(B, P, T, N_TF),
               lane_i=torch.stack([tau_b, cand_after], dim=-1).to(I32))
    if trace_scan:
        pk = gcr_mod.debug_peaks({k: v.flatten(0, 1)
                                  for k, v in fin.items()
                                  if k.startswith("_st_")}, K)
        out.update(_records(pk, B, P, T, pk["tr_padj"],
                            pk["tr_nzeros"].to(I32)))
    return out


gcr_fused_scan_plain.calls = 0


def gcr_fused_scan(volts, seg_lens, leads, pa: cm.ParmArrays, *, Ws,
                   rise_floor, min_floor, stat_lb: float, stat_bw: float,
                   spb: float, maxb: int, K: int, max_steps: int,
                   trace_scan: bool = False):
    """Arguments as pe_fused_scan's (track t's candidates live in
    [lead + t + W - 1, seg_len); K >= max_steps; trace_scan replaces the
    decode's scan by the -trace scan). Returns GcrOut (see module
    docstring)."""
    out, launched = _idle_scan(
        "gcr_fused_scan", gcr_fused_scan_plain, kernels.gcr_fused, volts,
        seg_lens, leads, pa, Ws=Ws, rise_floor=rise_floor,
        min_floor=min_floor, stat_lb=stat_lb, stat_bw=stat_bw, spb=spb,
        maxb=maxb, K=K, max_steps=max_steps, trace_scan=trace_scan)
    gcr_fused_scan.launches += launched
    return out


gcr_fused_scan.launches = 0


def gcr_fused_state(out) -> dict:
    """Per-track block state (gcr_apply_tau's fields, for gcr_finish) and
    the lane fields of a GcrOut, with leading [B, P] axes."""
    ti, tf, li = out["trk_i"], out["trk_f"], out["lane_i"]
    return dict(
        bits=out["bits"], hist=out["hist"], datacount=ti[..., GI_DC],
        peakcount=ti[..., GI_PEAKCNT], n_consumed=ti[..., GI_PEAKCNT],
        trksum=ti[..., GI_TRKSUM], incomplete=ti[..., GI_INCOMP] > 0,
        n_total=ti[..., GI_NTOTAL],
        t_firstbit=tf[..., TF_TFIRST], t_lastbit=tf[..., TF_TLAST],
        max_agc_gain=tf[..., TF_MAXAGC], min_agc_gain=tf[..., TF_MINAGC],
        tau=li[..., GL_TAU], cand_after=li[..., GL_CAND_AFTER])


# ---------------------------------------------------------------------------
# Whirlwind
# ---------------------------------------------------------------------------

def _check_ww(volts, W, rise_floor, v_avg_height, parms, K, maxchars,
              maxblocks, fluxdir, roles, span):
    if volts.dim() != 2 or volts.dtype != F32:
        raise ValueError("volts must be float32 [T, S]")
    T, S = volts.shape
    if not 1 <= T <= MAX_TRACKS:
        raise ValueError(f"{T} tracks (at most {MAX_TRACKS})")
    if not 1 <= W <= S or S >= WW_MAX_SAMPLES:
        raise ValueError(f"window width {W} or length {S} out of range")
    if tuple(rise_floor.shape) != (T,) or tuple(v_avg_height.shape) != (T,):
        raise ValueError("rise_floor/min_floor/v_avg_height must be [T]")
    if min(K, maxchars, maxblocks, span) < 1:
        raise ValueError("K, maxchars, maxblocks and span must be positive")
    if not 0 <= parms.agc_window <= cm.AGC_MAX_WINDOW or \
            not 0 <= parms.clk_window <= cm.CLKRATE_WINDOW:
        raise ValueError("agc_window/clk_window beyond the parmset limits")
    if fluxdir not in (ww_mod.FLUX_POS, ww_mod.FLUX_NEG, ww_mod.FLUX_AUTO):
        raise ValueError(f"bad flux direction {fluxdir}")
    if len(roles) != len(ww_mod.ROLES) or not all(-1 <= r < T
                                                   for r in roles):
        raise ValueError(f"bad track roles {roles}")


@torch.inference_mode()
def ww_fused_scan_plain(volts, *, W, rise_floor, min_floor, v_avg_height,
                        parms, spb: float, stat_lb: float, stat_bw: float,
                        K: int, maxchars: int, fluxdir: int, roles,
                        maxblocks: int = ww_mod.MAXBLOCKS,
                        span: int = ww_mod.REBASE_SPAN,
                        records: bool = False):
    """The plain PyTorch version of the WW kernel (same arguments and
    outputs as ww_fused_scan): jump tables and window features ->
    ww_track_scan -> merge_transitions -> ww_global_scan, as the JAX
    package's run_pass_single composes them."""
    ww_fused_scan_plain.calls += 1
    _check_ww(volts, W, rise_floor, v_avg_height, parms, K, maxchars,
              maxblocks, fluxdir, roles, span)
    dev = volts.device
    T, S = volts.shape
    nxt = trackscan.loose_jump_table(volts, W, rise_floor, min_floor)
    feat = trackscan.precompute_window_features(volts, W).transpose(
        -1, -2).contiguous()                                  # [T, S, 10]

    def knob(x, dt=F32):
        return torch.full((T,), x, dtype=dt, device=dev)
    # every step moves a cursor forward: S + 1 steps never bind
    fin = ww_mod.ww_track_scan(
        feat, nxt, W, S, S + 1, K, knob(parms.pkww_rise),
        knob(parms.min_peak), knob(parms.agc_alpha),
        knob(parms.agc_window, I32), v_avg_height)
    del feat, nxt
    counts = fin["n_admitted"]
    keep = torch.arange(K, device=dev) < counts.unsqueeze(-1)
    trans = dict(
        s_det=torch.where(keep, fin["tr_s"], trackscan.BIG_S),
        t_peak=torch.where(keep, fin["tr_t"], 0.0),
        t_frac=torch.where(keep, fin["tr_frac"], 0.0),
        is_top=keep & fin["tr_top"])
    cap = min(T * K, int(counts.sum()) + 16)
    mg = ww_mod.merge_transitions(trans, T, cap)
    res = ww_mod.ww_global_scan(
        mg["trk"], mg["t_peak"], mg["s_det"], mg["is_top"], mg["valid"],
        parms.clk_window, parms.clk_alpha, spb, stat_lb, stat_bw,
        T=T, maxchars=maxchars, maxblocks=maxblocks, fluxdir_req=fluxdir,
        m_frac=mg["t_frac"], span=span, debug_times=records,
        **dict(zip(ww_mod.ROLES, roles)))
    blk_i = torch.stack([res["b_start"], res["b_end"], res["b_type"],
                         res["b_t_base"], res["b_missing1"],
                         res["b_missingclk"]], dim=-1)
    trk_i = torch.stack([res["trksums"], counts, fin["h_cnt"],
                         fin["steps"]], dim=-1)
    scal = torch.stack([res["datacount"], res["nblocks"], res["flux"],
                        res["num_flux_changes"], res["base"],
                        res["n_events"]])
    out = dict(chars=res["chars"], blk_i=blk_i.to(I32),
               blk_f=torch.stack([res["b_t_end"], res["b_bitspace"]],
                                 dim=-1),
               hist=res["hist"], trk_i=trk_i.to(I32), trk_f=fin["h_sum"],
               scal=scal.to(I32))
    if records:
        out.update(tr_t=torch.where(keep, fin["tr_t"], 0.0),
                   tr_top=(keep & fin["tr_top"]).to(torch.int8),
                   char_t=res["char_t"])
    return out


ww_fused_scan_plain.calls = 0


def ww_fused_scan(volts, *, W, rise_floor, min_floor, v_avg_height, parms,
                  spb: float, stat_lb: float, stat_bw: float, K: int,
                  maxchars: int, fluxdir: int, roles,
                  maxblocks: int = ww_mod.MAXBLOCKS,
                  span: int = ww_mod.REBASE_SPAN, records: bool = False):
    """volts: [T, S] f32, the whole prepared tape; W: the window width;
    rise_floor/min_floor: [T] loose-candidate floors; v_avg_height: [T]
    nominal pulse heights; parms: the parmset (formats.parms.Parms);
    stat_lb/stat_bw: skew-histogram bins in samples; K: transition buffer
    entries per track; maxchars/maxblocks: character and block record
    capacity; fluxdir: ww.FLUX_*; roles: the track of each of ww.ROLES
    (-1 = none); span: the rolling base's span; records: the -trace
    records too. Returns WwOut (see module docstring)."""
    args = dict(W=int(W), rise_floor=rise_floor, min_floor=min_floor,
                v_avg_height=v_avg_height, parms=parms, spb=float(spb),
                stat_lb=float(stat_lb), stat_bw=float(stat_bw), K=int(K),
                maxchars=int(maxchars),
                fluxdir=int(fluxdir), roles=tuple(int(r) for r in roles),
                maxblocks=int(maxblocks), span=int(span),
                records=bool(records))
    if volts.device.type == "cpu":
        return ww_fused_scan_plain(volts, **args)
    if volts.device.type != "cuda":
        raise ValueError(f"ww_fused_scan: no kernel for {volts.device}")
    _check_ww(volts, args["W"], rise_floor, v_avg_height, parms, K, maxchars,
              maxblocks, args["fluxdir"], args["roles"], span)
    with telemetry.span("launch.ww_fused_scan"):
        telemetry.count("launches.ww_fused_scan")
        out = kernels.ww_fused(volts, **args)
    ww_fused_scan.launches += 1
    return out


ww_fused_scan.launches = 0


def ww_fused_state(out) -> dict:
    """run_pass_single's (res, finals) fields of a WwOut: chars,
    datacount, nblocks, the b_* block records, hist, trksums, flux,
    num_flux_changes, base, and per track n_admitted, h_sum, h_cnt and
    the admission steps taken."""
    bi, bf, ti, sc = out["blk_i"], out["blk_f"], out["trk_i"], out["scal"]
    return dict(
        chars=out["chars"], hist=out["hist"], datacount=sc[WS_DATACOUNT],
        nblocks=sc[WS_NBLOCKS], flux=sc[WS_FLUX],
        num_flux_changes=sc[WS_NFLUX], base=sc[WS_BASE],
        n_events=sc[WS_NEVENTS],
        b_start=bi[:, WB_START], b_end=bi[:, WB_END], b_type=bi[:, WB_TYPE],
        b_t_base=bi[:, WB_TBASE], b_missing1=bi[:, WB_MISS1],
        b_missingclk=bi[:, WB_MISSCLK], b_t_end=bf[:, WBF_TEND],
        b_bitspace=bf[:, WBF_BITSPACE], trksums=ti[:, WT_TRKSUM],
        n_admitted=ti[:, WT_NADM], h_cnt=ti[:, WT_HCNT],
        steps=ti[:, WT_STEPS], h_sum=out["trk_f"])
