"""Decode pipeline orchestrator -- the NRZI, PE, GCR and Whirlwind slices
of readtape_tpu/decode/pipeline.py.

Host-side driver that turns a sample tensor into decoded blocks:

  1. permute heads -> tracks, estimate signal height, find segments (gaps),
  2. upload the tape to the device once (int16 samples, or float32 volts
     of a CSV capture),
  3. per batch of segments: cut each segment's window from the resident
     tape, prepare volts, run the fused decode (decode/fused.py) for all
     active parmsets at once, finish the blocks (nrzi_finish, pe_finish,
     gcr_finish) and fetch the results in one round trip,
  4. staged retry: every block decodes with parmset 0 first, only
     imperfect blocks are re-decoded with all parmsets; best-pick over the
     reference's "tried" prefix (readtape.c:1755-1843),
  5. re-dispatch the remainder of segments that hold more than one block
     (NRZI after the slot machine's block end, GCR after the all-idle
     point), or walk each PE segment block by block from its all-idle
     point, emit blocks/tapemarks in tape order.

Whirlwind tapes decode whole, in one pass (``_decode_tape_ww``): one
ww_fused_scan call over the prepared tape, then block assembly on the
host; ``-deskew`` adds a calibration pass before it.

NRZI runs one of two kernel paths (``kernel_path``): "fused" (B1, one
kernel per batch) or "tiered" (admission alone, B5a or B5b, then the slot
machine alone, B6), the JAX package's READTAPE_FUSED=0 tier. Under -zeros
NRZI and GCR take their transitions from the zero crossings instead
(decode/zeros.py: Z1, then B6 for NRZI, Z2 for GCR), and NRZI decodes as
a sequential chain of one window per block. NRZI -adjskew and -correctdbg
take the tiered kernels under the JAX XLA scan's admission step budget,
whatever the kernel path, as the JAX package takes its XLA path for them:
-adjskew decodes one segment and one parmset try at a time, threading
B6's skew-deviation accumulators from try to try and nudging the skew
after every data block; -correctdbg decodes every segment with all
parmsets, B6 running the DEBUG build's -correct.

-trace's debug spreadsheet takes its event lanes from
``TapeDecoder.trace_lanes`` (NRZI, PE, GCR) and ``ww_trace_lanes``: one
window, parmset 0, the kernels in their record modes (B5b then B6, B2,
B3, B4), as the JAX package's functions of those names compute them.

Under a decode mesh (parallel/mesh.py) each segment batch splits over a
(data, parm) grid of devices, every shard launching the same kernels on
its own device, and the results join on the host; the mesh changes no
output.

A tape of unknown density (bpi <= 0; NRZI and PE, as the JAX command line
detects it) first goes through ``TapeDecoder.detect_density``. With a
``log``, GCR's -parmscan grid (``gcr_parmscan``) runs over the leading
segments before the decode and logs one line per combo.

9/7-track NRZI, 9-track PE, 9-track GCR and 6-track Whirlwind, from
int16 samples or float32 volts, -zeros for NRZI and GCR, -parmscan,
-adjskew and -correctdbg are ported (the last two NRZI only and not under
-zeros: elsewhere they are ignored, as in the JAX package); -zeros for PE
or Whirlwind (which the JAX command line refuses) raises
NotImplementedError naming the option. The entry points run on the card
("cuda") unless the caller asks for the CPU.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import warnings
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import telemetry
from ..formats import tbin as tb
from ..formats.parms import ParmSets, builtin_parmsets
from ..parallel import mesh as pmesh

from . import common as cm
from . import fused as fused_mod
from . import gcr as gcr_mod
from . import nrzi as nrzi_mod
from . import pe as pe_mod
from . import scan as scan_mod
from . import segment as seg
from . import slot as slot_mod
from . import trackscan
from . import ww as ww_mod
from . import zeros as zeros_mod
from .common import F32, I32, ParmArrays

# Window warmup: each segment's device slice starts this many samples early
# so the first eligible positions see a peak window full of real preceding
# gap samples, as the reference's gap-to-gap scan does. Candidates inside
# the warmup are masked.
SEG_WARMUP = 64          # > PKWW_MAX_WIDTH + refine margin

DIFFERENTIATE_THRESHOLD = 0.05
DIFFERENTIATE_SCALE = 0.4

# lanes (segments x parmsets x samples) per device batch, as the JAX
# package caps them
MAX_BATCH_ELEMS = 16 * 32768

KERNEL_PATHS = ("fused", "tiered")
STANDARD_DENSITIES = (200.0, 556.0, 800.0, 1600.0, 9042.0)


@dataclass
class DecodeOptions:
    mode: int = tb.MODE_NRZI
    ntrks: int = 9
    bpi: float = 800.0
    ips: float = 50.0
    deltat: float = 1.28e-6
    maxvolts: float = 6.0
    parmsets: ParmSets = None
    multiple_tries: bool = True
    do_correct: bool = False
    do_correct2: bool = False         # GCR: 2-track erasure correction
    # NRZI -correct with the reference's DEBUG-build parity-index semantics
    do_correct_debug: bool = False
    expected_parity: int = 1          # 1 = odd (default), 0 = even
    revparity: int = 0
    invert: bool = False
    differentiate: bool = False
    find_zeros: bool = False
    deskew: bool = False
    skew: tuple = None                # per-track delays in samples, or None
    add_parity: bool = False
    head_to_trk: tuple = None         # permutation; None = identity
    reverse: bool = False             # ww: reverse each block's characters
    adjskew: bool = False             # NRZI: per-block +-1 skew nudging
    fluxdir: str = "neg"              # ww: "pos" | "neg" | "auto"
    ww_order: str = "CMLcml"
    blklimit: int = 2 ** 31 - 1
    t0_seconds: float = 0.0
    parmscan: bool = False        # GCR: grid-scan parms on the first block

    def __post_init__(self):
        if self.parmsets is None:
            self.parmsets = builtin_parmsets(self.mode)

    @property
    def spb(self) -> float:
        """samples per bit"""
        return 1.0 / (self.bpi * self.ips * self.deltat)


@dataclass
class BlockResult:
    kind: str                 # "data" | "tapemark" | "noise" | "badblock"
    data: bytes = b""
    parmset: int = 0
    tries: int = 1
    errcount: int = 0
    warncount: int = 0
    detail: dict = field(default_factory=dict)
    t_start: float = 0.0      # seconds (absolute tape time)
    t_end: float = 0.0


def check_supported(opts: DecodeOptions, kernel_path: str = "fused"):
    """Raise NotImplementedError for what this slice of the port does not
    run yet, ValueError for a kernel path the mode does not have."""
    if opts.mode not in (tb.MODE_NRZI, tb.MODE_PE, tb.MODE_GCR, tb.MODE_WW):
        raise NotImplementedError(
            f"mode {tb.MODE_NAMES.get(opts.mode, opts.mode)}")
    if kernel_path not in KERNEL_PATHS:
        raise ValueError(f"kernel_path {kernel_path!r}: one of "
                         f"{KERNEL_PATHS}")
    if kernel_path == "tiered" and opts.mode != tb.MODE_NRZI:
        raise ValueError("kernel_path 'tiered' is NRZI's")
    # the JAX command line detects the density of NRZI and PE tapes only
    # (GCR is always 9042 bpi, Whirlwind 100)
    for flag, name in ((opts.find_zeros and opts.mode not in (tb.MODE_NRZI,
                                                             tb.MODE_GCR),
                        "-zeros of a PE or Whirlwind tape"),
                       (opts.bpi <= 0 and opts.mode not in (tb.MODE_NRZI,
                                                            tb.MODE_PE),
                        "density detection (bpi <= 0) of a "
                        f"{tb.MODE_NAMES.get(opts.mode, opts.mode)} tape")):
        if flag:
            raise NotImplementedError(name)


# ---------------------------------------------------------------------------
# device segment decode
# ---------------------------------------------------------------------------

def _prep_volts(v_i16, maxvolts, invert_sign, skew_delay, *,
                differentiate: bool, spb_int: int, apply_skew: bool = True):
    """int16 [..., T, S] -> float32 volts, optional differentiation
    (readtape.c:1383), per-track deskew delay lines (decoder.c:819-830).
    The scale is f32 maxvolts times the f32 reciprocal of 32767: the JAX
    package writes maxvolts / 32767.0, which XLA compiles into that
    multiplication."""
    scale = float(np.float32(maxvolts) * (np.float32(1) / np.float32(32767)))
    v = v_i16.to(F32) * scale * float(invert_sign)
    if differentiate:
        prev = torch.cat([torch.zeros_like(v[..., :1]), v[..., :-1]], dim=-1)
        d = v - prev
        d = torch.where((d < DIFFERENTIATE_THRESHOLD) &
                        (d > -DIFFERENTIATE_THRESHOLD), 0.0, d)
        v = d * float(np.float32(DIFFERENTIATE_SCALE * spb_int))
    if not apply_skew:
        return v
    S = v.shape[-1]
    idx = torch.clamp_min(torch.arange(S, device=v.device)
                          - skew_delay.long().unsqueeze(-1), 0)
    return torch.gather(v, -1, idx.expand(v.shape))


@telemetry.spanned("dispatch.prep")
def _segment_volts(tape, offsets, S, maxvolts, invert_sign, skew_delay,
                   differentiate, spb_int, skew_on):
    """The batch's segment windows [B, T, S] cut from the resident tape
    [T, N] at offsets [B], as contiguous float32 volts."""
    idx = offsets.view(-1, 1) + torch.arange(S, device=tape.device)
    v_i16 = tape[:, idx].permute(1, 0, 2)
    return _prep_volts(v_i16, maxvolts, invert_sign, skew_delay,
                       differentiate=differentiate, spb_int=spb_int,
                       apply_skew=skew_on).contiguous()


def _nrzi_results(out, T, expected_parity, revparity, maxb):
    """A FusedOut (B1's, or B6's) through fused_state and nrzi_finish,
    plus the fields the pipeline reads beside the block results."""
    st = fused_mod.fused_state(out)
    r = nrzi_mod.nrzi_finish(st, T, expected_parity, revparity, maxb)
    r["end_s"] = st["end_s"]
    r["unconsumed"] = torch.clamp_min(st["n_admitted"] - st["kvis"],
                                      0).sum(dim=-1).to(I32)
    r["alltrk_max_agc"] = st["max_agc_gain"].amax(dim=-1)
    r["alltrk_min_agc"] = st["min_agc_gain"].amin(dim=-1)
    r["event_overflow"] = st["incomplete"].any(dim=-1)
    if "adj" in out:
        # -adjskew: the running accumulators and the clock at block end
        # (adjust_deskew's bit spacing, readtape.c:1310)
        r["adj_n"] = out["adj"][..., slot_mod.ADJ_N]
        r["adj_mean"] = out["adj"][..., slot_mod.ADJ_MEAN]
        r["t_bitspaceavg"] = out["bitspace"]
    return r


def _nrzi_group_fused(tape, offsets, seg_lens, leads, maxvolts, invert_sign,
                      skew_delay, pa: ParmArrays, spb, expected_parity,
                      revparity, rise_floor, min_floor, stat_leftbin,
                      stat_binwidth, *, S, T, maxb, max_slots, K,
                      max_steps, Ws,
                      do_correct, differentiate, spb_int, skew_on):
    """One batch of segments through the fused decode: volts prep, the
    kernel (plain version on a CPU tape), fused_state and nrzi_finish.
    tape [T, N] int16 on the device; offsets/seg_lens/leads [B]. Returns
    device tensors with leading [B, P] axes."""
    volts = _segment_volts(tape, offsets, S, maxvolts, invert_sign,
                           skew_delay, differentiate, spb_int, skew_on)
    out = fused_mod.nrzi_fused_scan(
        volts, seg_lens, leads, pa, Ws=Ws, rise_floor=rise_floor,
        min_floor=min_floor, stat_lb=stat_leftbin, stat_bw=stat_binwidth,
        expected_parity=expected_parity, spb=spb, do_correct=do_correct,
        maxb=maxb, max_slots=max_slots, K=K, max_steps=max_steps)
    return _nrzi_results(out, T, expected_parity, revparity, maxb)


def _nrzi_group_tiered(tape, offsets, seg_lens, leads, maxvolts,
                       invert_sign, skew_delay, pa: ParmArrays, spb,
                       expected_parity, revparity, rise_floor, min_floor,
                       stat_leftbin, stat_binwidth, *, S, T, maxb,
                       max_slots, K, max_steps, Ws, do_correct,
                       differentiate, spb_int, skew_on, correct_debug=False,
                       adj_init=None, clk_avg_fma=False):
    """The tiered counterpart of _nrzi_group_fused (the JAX package's
    _nrzi_group_pallas): volts prep, the masked union jump table, window
    features per distinct width, admission alone (B5b when every parmset
    shares one width, else B5a), then the slot machine alone (B6) and
    nrzi_finish. Returns device tensors with leading [B, P] axes.

    max_steps: the admission step budget; None for none, as the TPU
    kernels have none. With the XLA scan's budget this is the JAX
    package's XLA group (_nrzi_segment_device), which -adjskew and
    -correctdbg take, with B6's correct_debug, adj_init and clk_avg_fma
    (decode/slot.py)."""
    volts = _segment_volts(tape, offsets, S, maxvolts, invert_sign,
                           skew_delay, differentiate, spb_int, skew_on)
    nxt = fused_mod._mask_jump_table(
        fused_mod._union_jump_table(volts, Ws, rise_floor, min_floor),
        seg_lens, leads, S)
    feat = scan_mod.window_features(volts, Ws)
    del volts
    admit = (scan_mod.nrzi_track_scan_tracks if len(set(Ws)) == 1
             else scan_mod.nrzi_track_scan)
    fin = admit(feat, nxt, pa, Ws=Ws, K=K, max_steps=max_steps)
    del feat, nxt
    out = slot_mod.nrzi_slot_scan(
        fin, pa, S=S, spb=spb, expected_parity=expected_parity,
        do_correct=do_correct, maxb=maxb, max_slots=max_slots,
        stat_lb=stat_leftbin, stat_bw=stat_binwidth, clk_avg_fma=clk_avg_fma,
        correct_debug=correct_debug, adj_init=adj_init)
    return _nrzi_results(out, T, expected_parity, revparity, maxb)


def _pe_group_fused(tape, offsets, seg_lens, leads, maxvolts, invert_sign,
                    skew_delay, pa: ParmArrays, spb, expected_parity,
                    revparity, rise_floor, min_floor, stat_leftbin,
                    stat_binwidth, *, S, T, maxb, max_steps, Ws,
                    differentiate, spb_int, skew_on):
    """One batch of PE segments: volts prep, the kernel (plain version on
    a CPU tape), pe_fused_state and pe_finish, plus the fields the PE
    walk reads -- _pe_segment_device's results, field for field. Returns
    device tensors with leading [B, P] axes."""
    volts = _segment_volts(tape, offsets, S, maxvolts, invert_sign,
                           skew_delay, differentiate, spb_int, skew_on)
    out = fused_mod.pe_fused_scan(
        volts, seg_lens, leads, pa, Ws=Ws, rise_floor=rise_floor,
        min_floor=min_floor, stat_lb=stat_leftbin, stat_bw=stat_binwidth,
        spb=spb, maxb=maxb, K=max_steps, max_steps=max_steps)
    st = fused_mod.pe_fused_state(out)
    r = pe_mod.pe_finish(st, T, expected_parity, revparity, maxb)
    B, P = st["tau"].shape
    # any scan of the segment (every parmset) out of step budget
    r["event_overflow"] = st["incomplete"].flatten(1).any(
        dim=-1, keepdim=True).expand(B, P)
    r["end_s"] = torch.minimum(st["tau"], seg_lens.view(B, 1)).to(I32)
    r["tau_gaveup"] = st["tau_gaveup"]
    r["scan_incomplete"] = st["incomplete"].any(dim=-1)
    r["consumed"] = st["n_consumed"].sum(dim=-1).to(I32)
    r["unconsumed"] = (st["n_total"] - st["n_consumed"]).sum(dim=-1).to(I32)
    r["cand_after"] = st["cand_after"]
    r["cand_race"] = st["cand_race"]
    return r


def _gcr_group_fused(tape, offsets, seg_lens, leads, maxvolts, invert_sign,
                     skew_delay, pa: ParmArrays, spb, expected_parity,
                     revparity, rise_floor, min_floor, stat_leftbin,
                     stat_binwidth, *, S, T, maxb, max_steps, Ws,
                     do_correct, do_correct2, differentiate, spb_int,
                     skew_on):
    """One batch of GCR segments: volts prep, the kernel (plain version
    on a CPU tape), gcr_fused_state and gcr_finish, plus the fields the
    multi-block rounds read -- _gcr_segment_device's results, field for
    field. Returns device tensors with leading [B, P] axes."""
    volts = _segment_volts(tape, offsets, S, maxvolts, invert_sign,
                           skew_delay, differentiate, spb_int, skew_on)
    out = fused_mod.gcr_fused_scan(
        volts, seg_lens, leads, pa, Ws=Ws, rise_floor=rise_floor,
        min_floor=min_floor, stat_lb=stat_leftbin, stat_bw=stat_binwidth,
        spb=spb, maxb=maxb, K=max_steps, max_steps=max_steps)
    st = fused_mod.gcr_fused_state(out)
    r = gcr_mod.gcr_finish(st, T, expected_parity, revparity, do_correct,
                           maxb, do_correct2=do_correct2)
    B, P = st["tau"].shape
    r["event_overflow"] = st["incomplete"].flatten(1).any(
        dim=-1, keepdim=True).expand(B, P)
    r["end_s"] = torch.minimum(st["tau"], seg_lens.view(B, 1)).to(I32)
    r["consumed"] = st["n_consumed"].sum(dim=-1).to(I32)
    r["unconsumed"] = (st["n_total"] - st["n_consumed"]).sum(dim=-1).to(I32)
    r["cand_after"] = st["cand_after"]
    return r


def _gcr_group_zeros(tape, offsets, seg_lens, leads, maxvolts, invert_sign,
                     skew_delay, pa: ParmArrays, spb, expected_parity,
                     revparity, *, S, T, maxb, cap, do_correct, do_correct2,
                     differentiate, spb_int, skew_on):
    """One batch of GCR segments under -zeros (the JAX package's
    _gcr_segment_device with find_zeros): volts prep, the zero-crossing
    lists once per segment (Z1), the bit machine over them for every
    parmset (Z2), gcr_finish. No all-idle point: the multi-block rounds do
    not run under -zeros. Returns device tensors with leading [B, P]
    axes."""
    volts = _segment_volts(tape, offsets, S, maxvolts, invert_sign,
                           skew_delay, differentiate, spb_int, skew_on)
    trans = zeros_mod.zerocross_transitions(volts, seg_lens, leads, cap=cap,
                                            differentiated=differentiate)
    del volts
    fin = zeros_mod.gcr_zeros_scan(trans, pa, spb=spb, maxb=maxb)
    r = gcr_mod.gcr_finish(fin, T, expected_parity, revparity, do_correct,
                           maxb, do_correct2=do_correct2)
    B, P = r["blktype"].shape
    r["event_overflow"] = trans["overflow"].view(B, 1).expand(B, P)
    return r


def _nrzi_group_zeros(tape, offsets, seg_lens, leads, maxvolts, invert_sign,
                      skew_delay, pa: ParmArrays, spb, expected_parity,
                      revparity, stat_leftbin, stat_binwidth, *, S, T, maxb,
                      max_slots, K, cap, do_correct, differentiate, spb_int,
                      skew_on):
    """One batch of NRZI segments under -zeros (the JAX package's
    _nrzi_segment_device with find_zeros): volts prep, the zero-crossing
    lists (Z1); the plain variant's slope gate against the track's static
    clock (NRZI never adjusts it: dt <= f32(spb) * ZEROCROSS_SLOPE); each
    track's emitted transitions compacted to K entries at their
    confirmation samples (past K the last one in entry K - 1, as the JAX
    scatter leaves it), the same for every parmset, with AGC off (gain
    1); then the slot machine alone (B6) and nrzi_finish. Returns device
    tensors with leading [B, P] axes."""
    volts = _segment_volts(tape, offsets, S, maxvolts, invert_sign,
                           skew_delay, differentiate, spb_int, skew_on)
    trans = zeros_mod.zerocross_transitions(volts, seg_lens, leads, cap=cap,
                                            differentiated=differentiate)
    del volts
    emit = trans["ok"] & trans["valid"]
    if not differentiate:
        emit = emit & (trans["dt"] <= float(
            np.float32(spb) * np.float32(gcr_mod.ZEROCROSS_SLOPE)))
    cnt = emit.cumsum(dim=-1)
    n_adm = cnt[..., -1]
    slot = torch.where(emit, torch.clamp_max(cnt - 1, K - 1), K)
    src = torch.full(slot.shape[:-1] + (K + 1,), -1, dtype=slot.dtype,
                     device=slot.device).scatter_reduce(
        -1, slot, torch.where(emit, torch.arange(cap, device=slot.device),
                              -1), "amax")[..., :K]
    has = src >= 0
    src = src.clamp_min(0)
    B, P = len(offsets), len(pa.clk_window)

    def lanes(x):
        return x.unsqueeze(1).expand((B, P) + x.shape[1:])
    fin = dict(
        tr_s=lanes(torch.where(has, trans["det"].gather(-1, src),
                               nrzi_mod.BIG_S)),
        tr_t=lanes(torch.where(has, trans["t"].gather(-1, src), 0.0)),
        tr_agc=torch.ones((B, P, T, K), dtype=F32, device=src.device),
        n_admitted=lanes(torch.clamp_max(n_adm, K).to(I32)),
        # AGC is off under -zeros, but each track's first bit records a
        # gain of 1 as its maximum (decode_nrzi.c:149)
        max_agc_gain=torch.ones((B, P, T), dtype=F32, device=src.device),
        min_agc_gain=torch.full((B, P, T), cm.FLT_MAX, dtype=F32,
                                device=src.device),
        incomplete=lanes(trans["overflow"].view(B, 1) | (n_adm > K)))
    # the JAX package's -zeros program contracts the clock differently in
    # a batch of one parmset (decode/slot.py)
    out = slot_mod.nrzi_slot_scan(
        fin, pa, S=S, spb=spb, expected_parity=expected_parity,
        do_correct=do_correct, maxb=maxb, max_slots=max_slots,
        stat_lb=stat_leftbin, stat_bw=stat_binwidth, clk_avg_fma=P == 1)
    return _nrzi_results(out, T, expected_parity, revparity, maxb)


@telemetry.spanned("fetch")
def _fetch(res) -> dict:
    """Device results -> host numpy, in one round trip: every field packs
    into one int32 and one float32 tensor before the copy. A mesh's grid
    of shard results comes back one round trip per shard (a fetch.shard
    span each, with its device), joined on the host along P, then B."""
    if isinstance(res, list):
        def shard(r):
            with telemetry.span("fetch.shard",
                                device=str(r["blktype"].device)):
                return _fetch_one(r)
        return pmesh.gather([[shard(r) for r in row] for row in res],
                            lambda parts, axis: np.concatenate(parts, axis))
    return _fetch_one(res)


def _fetch_one(res) -> dict:
    """_fetch of one device's results."""
    B, P = res["blktype"].shape[:2]
    ints, flts, layout = [], [], []
    for k in sorted(res):
        x = res[k]
        tail = tuple(x.shape[2:])
        flat = x.reshape(B, P, -1)
        if x.dtype == F32:
            layout.append((k, "f", sum(t.shape[-1] for t in flts),
                           flat.shape[-1], tail, x.dtype))
            flts.append(flat)
        else:
            layout.append((k, "i", sum(t.shape[-1] for t in ints),
                           flat.shape[-1], tail, x.dtype))
            ints.append(flat.to(I32))
    hi, hf = torch.cat(ints, dim=-1), torch.cat(flts, dim=-1)
    telemetry.count("d2h_bytes", hi.nbytes + hf.nbytes)
    with telemetry.wait("fetch", 2):
        hi, hf = hi.cpu().numpy(), hf.cpu().numpy()
    out = {}
    for k, kind, off, n, tail, dt in layout:
        a = (hi if kind == "i" else hf)[:, :, off:off + n]
        a = a.reshape((B, P) + tail)
        out[k] = a.astype(bool) if dt == torch.bool else a
    return out


# ---------------------------------------------------------------------------
# best-decoding selection (readtape.c:1776-1843)
# ---------------------------------------------------------------------------

def is_stopping_decode(bt, err, warn, minbits, mode) -> bool:
    """The sequential retry loop's early-stop rule (readtape.c:1755-1795
    with SKIP_NOISE): a tapemark, noise, a perfect block, or (PE) a
    zero-bit decode ends the parmset retries."""
    perfect = bt == nrzi_mod.BS_BLOCK and err == 0 and warn == 0
    return (bt == nrzi_mod.BS_TAPEMARK or bt == nrzi_mod.BS_NOISE
            or perfect or (mode == tb.MODE_PE and minbits == 0))


def pick_best(res_host: dict, P: int, multiple_tries: bool, mode: int):
    """Emulates the sequential retry loop's stopping rule and 4-stage pick.
    res_host fields are numpy arrays [P]. Returns (chosen_idx, tries)."""
    bt = res_host["blktype"]
    err = res_host["errcount"]
    warn = res_host["warncount"]
    minbits = res_host["minbits"]

    if not multiple_tries:
        return 0, 1
    # the C tries parmsets in order and stops early (SKIP_NOISE=true)
    tried = P
    for i in range(P):
        if is_stopping_decode(bt[i], err[i], warn[i], minbits[i], mode):
            tried = i + 1
            break
    cand = range(tried)
    last = tried - 1
    if bt[last] in (nrzi_mod.BS_TAPEMARK,):
        return last, tried
    if bt[last] == nrzi_mod.BS_NOISE:
        return last, tried
    if (bt[last] == nrzi_mod.BS_BLOCK and err[last] == 0 and warn[last] == 0):
        return last, tried
    # try 1: no errors, min warnings
    best, best_w = -1, None
    for i in cand:
        if bt[i] == nrzi_mod.BS_BLOCK and err[i] == 0:
            if best_w is None or warn[i] < best_w:
                best, best_w = i, warn[i]
    if best >= 0:
        return best, tried
    # try 2: min errors
    best, best_e = -1, None
    for i in cand:
        if bt[i] == nrzi_mod.BS_BLOCK:
            if best_e is None or err[i] < best_e:
                best, best_e = i, err[i]
    if best >= 0:
        return best, tried
    # try 3: min track mismatch among bad blocks
    best, best_m = -1, None
    for i in cand:
        if bt[i] == nrzi_mod.BS_BADBLOCK:
            m = res_host["track_mismatch"][i]
            if best_m is None or m < best_m:
                best, best_m = i, m
    if best >= 0:
        return best, tried
    # try 4: first noise
    for i in cand:
        if bt[i] == nrzi_mod.BS_NOISE:
            return i, tried
    return last, tried


# ---------------------------------------------------------------------------
# top-level decode
# ---------------------------------------------------------------------------

def _peakstat_bins(mode: int, bitspacing_secs: float):
    """record_peakstat's bin geometry (decoder.c:136-158), in seconds."""
    rangef = {tb.MODE_NRZI: 1.0, tb.MODE_PE: 1.2,
              tb.MODE_GCR: 3.0, tb.MODE_WW: 0.75}.get(mode, 1.0)
    rng = bitspacing_secs * rangef
    binwidth = rng / 50
    binwidth = (int(binwidth * 10e6 + 0.5) * 1e-6) / 10.0
    leftbin = bitspacing_secs - rng / 2
    leftbin = int(leftbin / binwidth) * binwidth
    return leftbin, binwidth


def permute_heads(samples: np.ndarray, head_to_trk) -> np.ndarray:
    """[N, heads] -> [N, tracks] per the -order permutation."""
    if head_to_trk is None:
        return samples
    ntrks = samples.shape[1]
    out_cols = np.zeros(ntrks, np.int64)
    for head, trkn in enumerate(head_to_trk):
        out_cols[trkn] = head
    return samples[:, out_cols]


def _resident_tape(samples: np.ndarray, maxvolts: float, device, step: int):
    """The tape [T, N] on `device` (int16 samples as they are, or float32
    volts), its height estimate and activity mask, as the JAX package
    computes them: for int16 from the upload in row order
    (segment.tape_activity, host_activity's subsample step), for float
    volts from the tape (segment.device_activity over every step-th
    sample)."""
    with telemetry.span("resident.upload"):
        with warnings.catch_warnings():
            # a read-only memmap of a .tbin file: the tensor is only read
            # (the transpose copies it)
            warnings.filterwarnings("ignore", "The given NumPy array is "
                                    "not writable")
            tape = torch.from_numpy(np.ascontiguousarray(samples))
        telemetry.count("h2d_bytes", tape.nbytes)
        rows = tape.to(device)
        tape = rows.T.contiguous()
    with telemetry.span("resident.scan"):
        if samples.dtype == np.int16:
            h_est, act = seg.tape_activity(
                rows, maxvolts, max(1, samples.size // 2_000_000))
        else:
            h_est, act = seg.device_activity(tape, maxvolts, step)
    return tape, h_est, act


def _capped(n, cap: int, rows):
    """Per-track admission records rows [T, K] (numpy, the first n[t] of
    each row valid, K >= n) as compact_outputs leaves them in cap entries:
    the first cap - 1 and, past cap, the last one. Returns a list of T
    arrays."""
    return [r[:n_] if n_ <= cap else np.concatenate([r[:cap - 1],
                                                      r[n_ - 1:n_]])
            for r, n_ in zip(rows, n)]


class TapeDecoder:
    """Holds the device-resident tape and runs decode passes over it.

    The tape uploads once, [T, N] on `device`, int16 samples or float32
    volts; activity and the height estimate come from the device, for
    int16 by segment.tape_activity (host_activity's values), for volts by
    segment.device_activity. kernel_path: "fused" (B1) or, for NRZI,
    "tiered" (B5 then B6).

    Under a decode mesh (parallel.mesh.get_decode_mesh, read here) the
    tape is resident on every distinct device of the mesh, and the
    decoder's own device is the mesh's first: density detection and
    -trace run there, the activity scan and height estimate once."""

    def __init__(self, samples: np.ndarray, opts: DecodeOptions, *,
                 device="cuda", kernel_path: str = "fused"):
        check_supported(opts, kernel_path)
        if opts.mode == tb.MODE_WW:
            raise ValueError("a Whirlwind tape decodes whole: call "
                             "decode_tape")
        self.device, self.mesh = _placement(device, samples)
        self.opts = opts
        self.kernel_path = kernel_path
        samples = permute_heads(samples, opts.head_to_trk)
        self.n_samples = samples.shape[0]
        self.tape, self.h_est, self._act = _resident_tape(
            samples, opts.maxvolts, self.device,
            max(1, (self.n_samples * opts.ntrks) // 2_000_000))
        # the other devices of the mesh: a copy of the tape each, and the
        # parmsets copied when a shard first needs them (_pa_on)
        self._tapes = {}
        others = self.mesh.distinct()[1:] if self.mesh else []
        if others:
            with telemetry.span("resident.upload"), \
                    telemetry.span("resident.replicate"):
                telemetry.count("d2d_bytes", self.tape.nbytes * len(others))
                self._tapes = {d: self.tape.to(d) for d in others}
        self._pas = {}
        with telemetry.wait("parms", len(dataclasses.fields(ParmArrays))):
            self.pa = ParmArrays.from_parmsets(opts.parmsets, self.device)
        self.P = len(opts.parmsets)
        self.skew = np.zeros(opts.ntrks, np.int32)
        if opts.skew is not None:
            self.skew[:len(opts.skew)] = opts.skew
        self.deskew_percent = 0.0

    # ---- segmentation ----
    def segments(self):
        opts = self.opts
        # an unknown density (bpi <= 0, before detect_density) segments
        # with a provisional 1600 bpi: detection needs active regions, not
        # exact block boundaries
        spb = (opts.spb if opts.bpi > 0
               else 1.0 / (1600.0 * opts.ips * opts.deltat))
        blank = 0
        if opts.mode == tb.MODE_PE:
            # a PE track goes idle 2.5 bit times after its last peak
            # (decoder.c:868-877), so an all-track quiet run that long
            # ends the block; the idle horizon plus PE_IBG_SECS is blanked
            # after it
            min_gap_secs = cm.PE_IDLE_FACTOR * spb * opts.deltat
            blank = int(cm.PE_IDLE_FACTOR * spb +
                        cm.PE_IBG_SECS / opts.deltat)
            post_bits = 3.0
        elif opts.mode == tb.MODE_GCR:
            # a GCR track goes idle GCR_IDLE_THRESH bit times after its
            # last peak (decoder.c:879-888); likewise blanked after
            min_gap_secs = cm.GCR_IDLE_THRESH * spb * opts.deltat
            blank = int(cm.GCR_IDLE_THRESH * spb +
                        cm.GCR_IBG_SECS / opts.deltat)
            post_bits = 7.0
        else:
            # NRZI allows indefinite per-track idle; its blocks end via
            # the global clock's post counter (~10 free-running slots),
            # handled by the multi-block re-dispatch
            min_gap_secs = max(20 * spb * opts.deltat, 0.0015)
            post_bits = 13.0
        min_gap_chunks = max(2, int(min_gap_secs / (opts.deltat * seg.CHUNK)))
        with telemetry.span("driver.segments"):
            return seg.find_segments(
                self._act, min_gap_chunks, self.n_samples,
                pre_margin=int(2 * spb), post_margin=int(post_bits * spb),
                blank=blank)

    # ---- per-segment decode ----
    def decode_segment(self, a: int, b: int, nparms=None):
        res = self.decode_segment_batch([(a, b)], nparms=nparms)
        return {k: v[0] for k, v in res.items()}

    def _tape_padded(self, min_len: int):
        """The device tape, zero-padded so every segment window fits
        (padded once, grown if ever needed)."""
        if self.tape.shape[1] < min_len:
            n_pad = seg.bucket_length(min_len)
            self.tape = torch.nn.functional.pad(
                self.tape, (0, n_pad - self.tape.shape[1]))
        return self.tape

    def _tape_on(self, dev):
        """The resident tape on mesh device `dev`, padded as far as the
        decoder's own."""
        if dev == self.device:
            return self.tape
        t = self._tapes[dev]
        if t.shape[1] < self.tape.shape[1]:
            t = self._tapes[dev] = torch.nn.functional.pad(
                t, (0, self.tape.shape[1] - t.shape[1]))
        return t

    def _pa_on(self, dev):
        """self.pa on mesh device `dev` (copied again whenever self.pa is
        replaced, as gcr_parmscan does)."""
        if dev == self.device:
            return self.pa
        src, pa = self._pas.get(dev, (None, None))
        if src is not self.pa:
            pa = self.pa.to(dev)
            self._pas[dev] = (self.pa, pa)
        return pa

    def dispatch_segment_batch(self, spans, bucket=None, nparms=None,
                               parm_sel=None, adj_init=None,
                               correctdbg=False):
        """Enqueue the decode of a batch of segments (one kernel launch for
        all of them and the first nparms parmsets, per shard under a decode
        mesh); returns device results with leading [B, P] axes, or under a
        mesh a grid of them (rows of shards, parallel.mesh.DecodeMesh.cells),
        for _fetch to bring to the host.

        parm_sel: a tuple of parmset indices instead of the nparms prefix.
        NRZI only: adj_init=(n0 [T], mean0 [T]) seeds -adjskew's
        accumulators (results gain adj_n, adj_mean, t_bitspaceavg);
        correctdbg runs -correct as the DEBUG build does. Either takes
        the JAX package's XLA group: the tiered kernels under the XLA
        scan's admission step budget, whatever the kernel path.

        Under a mesh the batch pads to a multiple of its data axis by
        repeating the last span (callers index results by chunk position
        and never read the pad lanes), each data row decodes a contiguous
        slice of it, and when every parmset shares one window width the
        parmsets split over the parm axis as well (not under -zeros or
        -adjskew), as the JAX package shards its batches."""
        opts = self.opts
        if parm_sel is not None:
            sel = list(parm_sel)
        else:
            sel = list(range(self.P if nparms is None
                             else min(nparms, self.P)))
        active = [opts.parmsets.sets[k] for k in sel]
        mesh = self.mesh
        if mesh is not None:
            spans = list(spans)
            pad = -len(spans) % mesh.shape["data"]
            spans += [spans[-1]] * pad
        S = bucket or seg.bucket_length(max(b - max(a - SEG_WARMUP, 0)
                                            for a, b in spans))
        with telemetry.span("dispatch", B=len(spans), P=len(sel), S=S):
            if mesh is not None:
                telemetry.count("dispatch.pad_lanes", pad)
            self._tape_padded(max(max(a - SEG_WARMUP, 0)
                                  for a, b in spans) + S)
            Ws = tuple(cm.pkww_width_for(p.pkww_bitfrac, opts.bpi, opts.ips,
                                         opts.deltat) for p in active)
            # the peak floors come from every active parmset, on every
            # shard
            floors = (min(p.pkww_rise for p in active),
                      min(p.min_peak for p in active))
            if mesh is None:
                return self._dispatch_shard(self.device, spans, sel, S,
                                            floors, adj_init, correctdbg)
            shard_parm = (mesh.shape["parm"] > 1 and len(set(Ws)) == 1
                          and len(sel) % mesh.shape["parm"] == 0
                          and not opts.find_zeros and adj_init is None)

            def shard(dev, bs, ps):
                with telemetry.span("dispatch.shard", device=str(dev)):
                    return self._dispatch_shard(dev, spans[bs], sel[ps], S,
                                                floors, adj_init, correctdbg)
            grid = [[shard(*cell) for cell in row]
                    for row in mesh.cells(len(spans), len(sel), shard_parm)]
            return grid[0][0] if len(grid) == len(grid[0]) == 1 else grid

    def _dispatch_shard(self, dev, spans, sel, S, floors, adj_init,
                        correctdbg):
        """dispatch_segment_batch's launches for one shard: the segments
        `spans` and parmsets `sel` on device `dev`, from the tape and
        parmsets resident there; S and the peak floors are the whole
        batch's."""
        opts = self.opts
        active = [opts.parmsets.sets[k] for k in sel]
        pa = self._pa_on(dev)
        if sel != list(range(self.P)):
            pa = pa.select(sel)

        def a0(a):
            return max(a - SEG_WARMUP, 0)
        T = opts.ntrks
        tape = self._tape_on(dev)
        with telemetry.wait("batch_args", 4):
            offsets = torch.as_tensor([a0(a) for a, b in spans], device=dev)
            seg_lens = torch.as_tensor([b - a0(a) for a, b in spans],
                                       dtype=I32, device=dev)
            leads = torch.as_tensor([a - a0(a) for a, b in spans],
                                    dtype=I32, device=dev)
            skew = torch.as_tensor(self.skew, dtype=I32, device=dev)
        spb = opts.spb
        Ws = tuple(cm.pkww_width_for(p.pkww_bitfrac, opts.bpi, opts.ips,
                                     opts.deltat) for p in active)
        # admission step budget of the JAX XLA scan: ~2 peaks/bit plus
        # reject slack; only noise-dense segments reach it
        max_steps = fused_mod.scan_step_budget(int(S / spb * 3.2) + 64)
        K = int(S / spb * 2.5) + 64
        maxb = int(S / spb * 1.3) + 64
        max_slots = int(S / spb * 1.25) + 48

        scale = min(1.0, self.h_est / cm.PKWW_PEAKHEIGHT)
        rise_min, minp_min = floors
        rise_floor = torch.full(
            (T,), rise_min * scale / cm.AGC_MAX_VALUE * 0.8, dtype=F32,
            device=dev)
        min_floor = torch.full(
            (T,), minp_min * scale / cm.AGC_MAX_VALUE * 0.8, dtype=F32,
            device=dev)
        lb, bw = _peakstat_bins(opts.mode, 1.0 / (opts.bpi * opts.ips))
        head = (tape, offsets, seg_lens, leads, opts.maxvolts,
                -1.0 if opts.invert else 1.0, skew, pa, spb,
                opts.expected_parity, opts.revparity)
        stat = (float(np.float32(lb / opts.deltat)),
                float(np.float32(bw / opts.deltat)))
        kw = dict(S=S, T=T, maxb=maxb, differentiate=opts.differentiate,
                  spb_int=int(spb), skew_on=bool(np.any(self.skew)))
        if opts.find_zeros:
            # the transition lists hold up to the XLA scan's step count
            kw["cap"] = int(S / spb * 3.2) + 64
            if opts.mode == tb.MODE_GCR:
                return _gcr_group_zeros(*head, do_correct=opts.do_correct,
                                        do_correct2=opts.do_correct2, **kw)
            return _nrzi_group_zeros(*head, *stat, max_slots=max_slots, K=K,
                                     do_correct=opts.do_correct, **kw)
        args = head + (rise_floor, min_floor) + stat
        kw.update(max_steps=max_steps, Ws=Ws)
        if opts.mode == tb.MODE_PE:
            return _pe_group_fused(*args, **kw)
        if opts.mode == tb.MODE_GCR:
            return _gcr_group_fused(*args, do_correct=opts.do_correct,
                                    do_correct2=opts.do_correct2, **kw)
        if adj_init is not None or correctdbg:
            B, P = len(spans), len(active)
            adj = None if adj_init is None else tuple(
                torch.as_tensor(np.asarray(x, np.float32), device=dev)
                .expand(B, P, T) for x in adj_init)
            # XLA's CPU build contracts the clock as fma(1 - a, avg, a *
            # delta) in the JAX package's -adjskew programs, as in its
            # peak path in the -correctdbg ones
            # (scripts/probe_adjskew_contraction.py)
            return _nrzi_group_tiered(
                *args, max_slots=max_slots, K=K,
                do_correct=opts.do_correct and not correctdbg,
                correct_debug=correctdbg, adj_init=adj,
                clk_avg_fma=adj is not None, **kw)
        if self.kernel_path == "tiered":
            kw["max_steps"] = None
            return _nrzi_group_tiered(*args, max_slots=max_slots, K=K,
                                      do_correct=opts.do_correct, **kw)
        return _nrzi_group_fused(*args, max_slots=max_slots, K=K,
                                 do_correct=opts.do_correct, **kw)

    def decode_segment_batch(self, spans, bucket=None, nparms=None, **kw):
        """Decode a batch of same-bucket segments; host numpy results with
        leading [B, P] axes (kw: dispatch_segment_batch's parm_sel,
        adj_init, correctdbg)."""
        return _fetch(self.dispatch_segment_batch(spans, bucket, nparms,
                                                  **kw))

    # ---- debug trace (trace.c equivalent; runtime option) ----
    def trace_lanes(self, a: int, b: int):
        """Decode samples [a, b) with parmset 0 and return (volts [b-a, T]
        numpy, lanes dict) for the <base>.trace.csv debug spreadsheet --
        the reference's event lanes (trace.c:46-92), mode-filtered: the
        JAX package's TapeDecoder.trace_lanes, with its own arguments (one
        window of S = bucket_length(b - a), the loose jump table, step
        budget max(512, S // 4)). Its scans are the kernels' record modes
        on the card (B2 for PE, B3 for GCR, B5b then B6 for NRZI), their
        plain versions on the CPU."""
        opts = self.opts
        T, dev = opts.ntrks, self.device
        S = seg.bucket_length(b - a)
        v = self._tape_padded(b)[:, a:b]
        v = torch.nn.functional.pad(v, (0, S - v.shape[1]))
        vf = _prep_volts(v, opts.maxvolts, -1.0 if opts.invert else 1.0,
                         torch.as_tensor(self.skew, dtype=I32, device=dev),
                         differentiate=opts.differentiate,
                         spb_int=int(opts.spb)).contiguous()
        p0 = opts.parmsets[0]
        pa0 = self.pa.select([0])
        W = cm.pkww_width_for(p0.pkww_bitfrac, opts.bpi, opts.ips,
                              opts.deltat)
        scale = min(1.0, self.h_est / cm.PKWW_PEAKHEIGHT)
        rise_floor = torch.full((T,), p0.pkww_rise * scale / 2 * 0.8,
                                dtype=F32, device=dev)
        min_floor = torch.full((T,), p0.min_peak * scale / 2 * 0.8,
                               dtype=F32, device=dev)
        spb = opts.spb
        steps = fused_mod.scan_step_budget(max(512, S // 4))
        Kd = max(512, S // 6)
        maxb = int(S / spb * 1.3) + 64
        lb, bw = _peakstat_bins(opts.mode, 1.0 / (opts.bpi * opts.ips))
        stat = dict(stat_lb=float(np.float32(lb / opts.deltat)),
                    stat_bw=float(np.float32(bw / opts.deltat)))
        t0 = opts.t0_seconds + a * opts.deltat
        dt = opts.deltat

        def tsec(x):
            return t0 + float(x) * dt

        def peak_lane(n, tr_t, tr_top):
            return [[(tsec(x), bool(u)) for x, u in zip(tr_t[trk][:n[trk]],
                                                        tr_top[trk][:n[trk]])]
                    for trk in range(T)]

        lanes = {}
        if opts.mode in (tb.MODE_PE, tb.MODE_GCR):
            scan = (fused_mod.pe_fused_scan if opts.mode == tb.MODE_PE
                    else fused_mod.gcr_fused_scan)
            out = scan(vf[None], torch.full((1,), S, dtype=I32, device=dev),
                       torch.zeros(1, dtype=I32, device=dev), pa0, Ws=(W,),
                       rise_floor=rise_floor, min_floor=min_floor, spb=spb,
                       maxb=maxb, K=steps, max_steps=steps, trace_scan=True,
                       **stat)
            n = out["rec_n"][0, 0].cpu().numpy()
            rf = out["rec_f"][0, 0].cpu().numpy()
            ri = out["rec_i"][0, 0].cpu().numpy()
            # the JAX scan's records compacted to maxb entries per track
            tt, x2, top, i2 = (_capped(n, maxb, c) for c in (
                rf[..., 0], rf[..., 1], ri[..., 0] != 0, ri[..., 1]))
            peaks = peak_lane(n, tt, top)
        if opts.mode == tb.MODE_PE:
            clkedg, datedg, clkwin, clkdet, data = [], [], [], [], []
            for trk in range(T):
                isd = i2[trk] & 1
                bv = (i2[trk] >> 1).astype(np.int8)
                datedg.append([(tsec(x), 1) for x, d in zip(tt[trk], isd)
                               if d])
                clkedg.append([(tsec(x), 1) for x, d in zip(tt[trk], isd)
                               if not d])
                cw = []
                for x, d, w in zip(tt[trk], isd, x2[trk]):
                    if d:
                        cw.append((tsec(x), 1))
                        cw.append((tsec(x + w), 0))
                clkwin.append(cw)
                clkdet.append([(tsec(tt[trk][0]), 1), (tsec(tt[trk][-1]), 0)]
                              if n[trk] else [])
                data.append([(tsec(x), int(bb))
                             for x, d, bb in zip(tt[trk], isd, bv) if d])
            lanes = dict(peak=peaks, clkedg=clkedg, datedg=datedg,
                         clkwin=clkwin, clkdet=clkdet, data=data)
        elif opts.mode == tb.MODE_GCR:
            zerpos, adjpos, data = [], [], []
            for trk in range(T):
                t_, nz = tt[trk], i2[trk].astype(np.int8)
                zp, dd = [], []
                for i in range(1, len(t_)):
                    k = int(nz[i])
                    for z in range(max(k, 0)):
                        tz = t_[i - 1] + (t_[i] - t_[i - 1]) * \
                            (z + 1) / (k + 1)
                        zp.append((tsec(tz), 1))
                        dd.append((tsec(tz), 0))
                    dd.append((tsec(t_[i]), 1))
                zerpos.append(zp)
                data.append(dd)
                adjpos.append([(tsec(x), 1) for x, adj in zip(t_, x2[trk])
                               if abs(adj) > 1e-6])
            lanes = dict(peak=peaks, zerpos=zerpos, adjpos=adjpos,
                         data=data)
        elif opts.mode == tb.MODE_NRZI:
            # per-track admission (B5b), then the slot machine (B6) with
            # its per-slot and per-column records, -correct off
            nxt = trackscan.loose_jump_table(vf, W, rise_floor, min_floor)
            fin = scan_mod.nrzi_track_scan_tracks(
                scan_mod.window_features(vf[None], (W,)), nxt[None], pa0,
                Ws=(W,), K=Kd, max_steps=steps)
            n = fin["n_admitted"][0, 0].cpu().numpy()
            lanes["peak"] = peak_lane(n, fin["tr_t"][0, 0].cpu().numpy(),
                                      fin["tr_top"][0, 0].cpu().numpy())
            # XLA's CPU build contracts the JAX trace's one-lane clock as
            # fma(1 - a, avg, a * delta) (decode/slot.py)
            out = slot_mod.nrzi_slot_scan(
                fin, pa0, S=S, spb=spb, expected_parity=opts.expected_parity,
                do_correct=False, maxb=maxb,
                max_slots=int(S / spb * 1.25) + 48, clk_avg_fma=True,
                records=True, **stat)
            bits = out["bits"][0, 0].cpu().numpy()
            dcs = out["trk_i"][0, 0, :, slot_mod.TI_DC].cpu().numpy()
            nslot = int(out["lane_i"][0, 0, slot_mod.LI_NSLOT])
            slot_f = out["slot_f"][0, 0].cpu().numpy()
            col_slot = out["col_slot"][0, 0].cpu().numpy()      # [T, maxb]
            zc = slot_f[:nslot, slot_mod.SL_ZC]
            ap = slot_f[:nslot, slot_mod.SL_AVGPOS]
            lanes["zerchk"] = [(tsec(x), 1) for x in zc]
            lanes["avgpos"] = [(tsec(x), 1) for x in ap if x > 0]
            # data lane + parity errors per completed column
            frames = np.zeros(maxb, np.int64)
            for trk in range(T):
                frames |= bits[trk].astype(np.int64) << (T - 1 - trk)
            slot_t = np.zeros(slot_f.shape[0] + 1)
            slot_t[:slot_f.shape[0]] = slot_f[:, slot_mod.SL_ZC]
            data = []
            for trk in range(T):
                dd = []
                for c in range(int(dcs[trk])):
                    sl = col_slot[trk, c]
                    if sl >= 0:
                        dd.append((tsec(slot_t[sl]), int(bits[trk][c])))
                data.append(dd)
            lanes["data"] = data
            par = np.zeros(maxb, np.int64)
            x = frames.copy()
            while x.any():
                par ^= x & 1
                x >>= 1
            perr = []
            for c in range(int(dcs.min())):
                if par[c] != opts.expected_parity:
                    sl = col_slot[:, c].max()
                    if sl >= 0:
                        perr.append((tsec(slot_t[sl]), 1))
            lanes["parerr"] = perr
        volts = vf.T[:b - a].cpu().numpy()
        return volts, lanes

    def trace_window(self, a: int, b: int):
        """(volts, peak lanes) of trace_lanes."""
        volts, lanes = self.trace_lanes(a, b)
        return volts, lanes.get("peak")

    # ---- deskew calibration (decoder.c:243-281) ----
    def calibrate_deskew(self, segments, max_blocks=100, min_transitions=1000):
        opts = self.opts
        lb, bw = _peakstat_bins(opts.mode, 1.0 / (opts.bpi * opts.ips))
        hist = np.zeros((opts.ntrks, 50), np.int64)
        trksums = np.zeros(opts.ntrks, np.int64)
        nblks = 0
        for (a, b) in segments:
            # calibration reads only parmset 0's histogram, like the
            # reference's first-parmset deskew pass (readtape.c:1676-1717)
            res = self.decode_segment(a, b, nparms=1)
            if res["blktype"][0] == nrzi_mod.BS_NOISE:
                continue
            hist += res["hist"][0]
            trksums += res["trksums"][0]
            nblks += 1
            if nblks >= max_blocks or trksums.min() >= min_transitions:
                break
        if trksums.min() == 0:
            return False
        # average peak position per track over interior buckets, with the
        # C's exact arithmetic (skew_compute_deskew, decoder.c:243-281)
        lb32 = np.float64(np.float32(lb)) * 1e6
        bw32 = np.float64(np.float32(bw)) * 1e6
        avgsum = np.asarray(
            [sum(int(int(hist[t, k]) * (bw32 * k + lb32))
                 for k in range(1, 49)) for t in range(opts.ntrks)])
        avg = (np.float32(avgsum) / np.float32(trksums)).astype(np.float32)
        maxavg = avg.max()
        t_sec = np.where(trksums > 0,
                         ((maxavg - avg).astype(np.float32)
                          / np.float32(1e6)), np.float32(0))
        delays = np.minimum(
            ((t_sec.astype(np.float64) + opts.deltat / 2)
             / opts.deltat).astype(int), 50)
        self.skew = delays.astype(np.int32)
        bitspace_us = 1e6 / (opts.bpi * opts.ips)
        self.deskew_percent = float((maxavg - avg.min()) / bitspace_us * 100)
        return True

    # ---- density detection (decoder.c:329-394) ----
    def detect_density(self, segments):
        """The JAX package's TapeDecoder.detect_density: admission alone
        (window 8, parmset 0's knobs, the XLA scan's step budget) over the
        leading segments until 9999 transition deltas, then the host-side
        histogram of their spacings. On the card the admission runs B5b
        (decode/scan.py), on the CPU its plain version. Returns (standard
        density, raw estimate) in bpi; raises RuntimeError if none fits."""
        opts = self.opts
        T, dev = opts.ntrks, self.device
        p0 = opts.parmsets[0]
        pa0 = self.pa.select([0])
        scale = min(1.0, self.h_est / cm.PKWW_PEAKHEIGHT)
        rise_floor = torch.full((T,), p0.pkww_rise * scale / 2 * 0.8,
                                dtype=F32, device=dev)
        min_floor = torch.full((T,), p0.min_peak * scale / 2 * 0.8,
                               dtype=F32, device=dev)
        vscale = float(np.float32(opts.maxvolts / 32767.0))
        deltas = []
        total = 0
        for (a, b) in segments:
            S = seg.bucket_length(b - a)
            v = self._tape_padded(b)[:, a:b]
            v = torch.nn.functional.pad(v, (0, S - v.shape[1]))
            vf = v.to(F32) * vscale
            if opts.invert:
                vf = -vf
            nxt = trackscan.loose_jump_table(vf, 8, rise_floor, min_floor)
            fin = scan_mod.nrzi_track_scan_tracks(
                scan_mod.window_features(vf[None], (8,)), nxt[None], pa0,
                Ws=(8,), K=max(512, S // 6),
                max_steps=fused_mod.scan_step_budget(max(512, S // 4)))
            n_adm = fin["n_admitted"][0, 0].cpu().numpy()
            t_peak = fin["tr_t"][0, 0].cpu().numpy()
            for trk in range(T):
                t = t_peak[trk][:n_adm[trk]] * opts.deltat
                d = np.diff(t)
                deltas.append(d[(d > 0) & (d <= 120e-6)])
                total += len(deltas[-1])
            if total >= 9999:
                break
        if not deltas:
            raise RuntimeError("density detection failed: no transitions")
        d = np.concatenate(deltas)
        bins = (d / 0.5e-6).astype(int)
        counts = np.bincount(bins)
        need = len(d) * 0.05
        ok = np.nonzero(counts > need)[0]
        if len(ok) == 0:
            raise RuntimeError("density detection failed")
        mindist = ok.min()
        density = 1.0 / (opts.ips * (mindist + 0.5) * 0.5e-6)
        if opts.mode == tb.MODE_PE:
            density /= 2
        for std in STANDARD_DENSITIES:
            if abs(density - std) < std * 0.20:
                return std, density
        raise RuntimeError(f"non-standard density {density:.0f} BPI "
                           "detected; please specify -bpi")


def check_device(device) -> torch.device:
    """torch.device(device); raises RuntimeError for "cuda" on a host
    without a card (no entry point falls back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but "
                           "torch.cuda.is_available() is false")
    return device


def _placement(device, samples: np.ndarray):
    """(the decode's device, the decode mesh or None), after the checks
    every entry point makes. Under a mesh every device of it must be of
    `device`'s type (ValueError otherwise: no shard runs elsewhere), and
    the decode's own device is the mesh's first, where what is not
    sharded runs (Whirlwind, -trace, density detection)."""
    device = check_device(device)
    if samples.dtype not in (np.int16, np.float32):
        raise ValueError(f"{samples.dtype} samples: int16 samples or "
                         "float32 volts")
    mesh, _ = pmesh.get_decode_mesh()
    if mesh is None:
        return device, None
    mesh.check_type(device)
    return mesh.first, mesh


def decode_tape(samples: np.ndarray, opts: DecodeOptions, log=None, *,
                device="cuda", decoder: TapeDecoder = None,
                kernel_path: str = "fused"):
    """Decode a whole NRZI, PE, GCR or Whirlwind tape on `device` ("cuda"
    runs the kernels, "cpu" the plain versions). Returns (blocks, stats
    dict). log: a callable taking one line, for -parmscan's lines (as the
    JAX decode_tape's; without it -parmscan does nothing). decoder: reuse
    a TapeDecoder whose tape is already resident (its device and kernel
    path win; NRZI, PE and GCR only). kernel_path: NRZI's
    "fused" (B1) or "tiered" (B5 + B6) kernels. With opts.bpi <= 0 (NRZI
    and PE) the density is detected first, as the JAX command line does,
    and the tape decodes at the standard density found; stats["density"]
    is then (standard, raw estimate). While telemetry records, the call
    is one ``capture`` span."""
    with telemetry.span("capture", samples=int(samples.shape[0]),
                        mode=int(opts.mode)):
        if opts.mode == tb.MODE_WW:
            check_supported(opts, kernel_path)
            # unsharded, on the mesh's first device under a mesh
            return _decode_tape_ww(samples, opts,
                                   _placement(device, samples)[0])
        dec = (decoder if decoder is not None
               else TapeDecoder(samples, opts, device=device,
                                kernel_path=kernel_path))
        if opts.bpi > 0:
            return _decode_tape_blocks(dec, opts, log)
        density = dec.detect_density(dec.segments())
        dec.opts = opts = dataclasses.replace(opts, bpi=density[0])
        blocks, stats = _decode_tape_blocks(dec, opts, log)
        stats["density"] = density
        return blocks, stats


def parmscan_grid():
    """The reference's GCR parameter grid (readtape.c:1730-1754), with its
    float32 loop stepping reproduced exactly so the combo list (and its
    nesting order) matches the C binary's log line for line."""
    f32 = np.float32
    combos = []
    clk_alpha = f32(0.010)
    while clk_alpha <= f32(0.030):
        pulse_adj = f32(0.2)
        while pulse_adj <= f32(0.401):
            z1pt = f32(1.4)
            while z1pt <= f32(1.501):
                z2pt = f32(2.20)
                while z2pt <= f32(2.501):
                    combos.append((float(clk_alpha), float(pulse_adj),
                                   float(z1pt), float(z2pt)))
                    z2pt = f32(z2pt + f32(0.02))
                z1pt = f32(z1pt + f32(0.01))
            pulse_adj = f32(pulse_adj + f32(0.1))
        clk_alpha = f32(clk_alpha + f32(0.002))
    return combos


def gcr_parmscan(dec: TapeDecoder, span, log, combos=None):
    """GCR parmset grid scan over one segment (readtape.c:1730-1754, the
    GCR_PARMSCAN debug build): decode `span` under every (clk_alpha,
    pulse_adj, z1pt, z2pt) combo and log the reference's result line per
    combo. The combos ride the parmset axis of decode_segment, a chunk of
    them (READTAPE_PARMSCAN_CHUNK, 64) per launch of B3; the last chunk is
    padded with its last combo. READTAPE_PARMSCAN_LIMIT > 0 cuts the
    5,280-combo grid (a test hook, as in the JAX package)."""
    opts = dec.opts
    if combos is None:
        combos = parmscan_grid()
        limit = int(os.environ.get("READTAPE_PARMSCAN_LIMIT", "0"))
        if limit > 0:
            combos = combos[:limit]
    base = dataclasses.replace(opts.parmsets.sets[0], clk_window=0)
    chunk = int(os.environ.get("READTAPE_PARMSCAN_CHUNK", "64"))
    saved = (opts.parmsets, dec.pa, dec.P)
    a, b = span
    try:
        for lo in range(0, len(combos), chunk):
            cs = combos[lo:lo + chunk]
            pad = cs + [cs[-1]] * (min(chunk, len(combos)) - len(cs))
            ps = copy.copy(opts.parmsets)
            ps.sets = [dataclasses.replace(
                base, clk_alpha=ca, pulse_adj=pa_, z1pt=z1, z2pt=z2)
                for ca, pa_, z1, z2 in pad]
            opts.parmsets = ps
            dec.pa = ParmArrays.from_parmsets(ps, dec.device)
            dec.P = len(ps.sets)
            res = dec.decode_segment(a, b)
            for j, (ca, pa_, z1, z2) in enumerate(cs):
                log(f"clk_alpha {ca:.3f} pulseadj {pa_:.3f} "
                    f"z1pt {z1:.3f} z2pt {z2:.3f} "
                    f"firsterr {int(res['first_error'][j]):4d} "
                    f"errors {int(res['errcount'][j])} "
                    f"warnings {int(res['warncount'][j])} "
                    f"minbits {int(res['minbits'][j])} "
                    f"maxbits {int(res['maxbits'][j])}\n")
    finally:
        opts.parmsets, dec.pa, dec.P = saved


def _decode_tape_blocks(dec: TapeDecoder, opts: DecodeOptions, log=None):
    """The block decode of NRZI, PE and GCR tapes (the JAX package's
    _decode_tape_nrzi_like): -parmscan's grid where asked, batched segment
    decodes with the staged retry, then NRZI's or GCR's remainder rounds
    or PE's block walk, then block emission in tape order. NRZI -zeros
    and -adjskew are sequential chains of their own; -correctdbg decodes
    every segment with all parmsets."""
    segs = dec.segments()
    nrzi_peaks = opts.mode == tb.MODE_NRZI and not opts.find_zeros
    adjskew = nrzi_peaks and opts.adjskew
    correctdbg = nrzi_peaks and opts.do_correct_debug and not adjskew
    stats = dict(nblocks=0, ntapemarks=0, nerrblocks=0, nwarnblocks=0,
                 nunusable=0, nmismatched=0, nmidbiterr=0, ncorrected=0,
                 ngoodmultiple=0,
                 tried=np.zeros(dec.P, int), chosen=np.zeros(dec.P, int),
                 deskew_percent=0.0, skew=None,
                 peak_hist=np.zeros((opts.ntrks, 50), np.int64),
                 peak_trksums=np.zeros(opts.ntrks, np.int64),
                 peak_bins=_peakstat_bins(opts.mode,
                                          1.0 / (opts.bpi * opts.ips)))
    if opts.deskew and opts.skew is None:
        with telemetry.span("driver.calibrate"):
            dec.calibrate_deskew(segs)
        stats["deskew_percent"] = dec.deskew_percent
    stats["skew"] = dec.skew.tolist()
    if opts.parmscan and log and opts.mode != tb.MODE_GCR:
        log("-parmscan is only implemented for GCR (as in the reference's "
            "GCR_PARMSCAN build); ignored\n")
    if opts.parmscan and log and opts.mode == tb.MODE_GCR:
        # the reference re-scans at every block position while numblks ==
        # 0: here the segments up to and including the first that does
        # not decode as noise (or nothing) with parmset 0
        for sp in segs:
            gcr_parmscan(dec, sp, log)
            r0 = dec.decode_segment(*sp, nparms=1)
            if int(r0["blktype"][0]) not in (nrzi_mod.BS_NONE,
                                             nrzi_mod.BS_NOISE):
                break
    if not segs:
        return [], stats

    # NRZI: one bucket for every segment, so tapemark-sized segments ride
    # along with data blocks (the slot machine ends each block at its
    # postamble). PE and GCR scans have no in-scan block end, so they keep
    # tight per-segment buckets.
    buckets = [seg.bucket_length(b - max(a - SEG_WARMUP, 0))
               for a, b in segs]
    maxbkt = max(buckets)
    unified = opts.mode == tb.MODE_NRZI and maxbkt <= 65536
    if unified:
        buckets = [maxbkt] * len(buckets)

    def dispatch(indices, nparms):
        """Enqueue every batch of `indices`; returns [(chunk, results)]
        with results still on the device. Under -correctdbg every batch
        runs the DEBUG build's -correct."""
        elems = MAX_BATCH_ELEMS * max(1, dec.P // nparms)
        by_bucket = {}
        for i in indices:
            by_bucket.setdefault(buckets[i], []).append(i)
        pending = []
        for S, idxs in sorted(by_bucket.items()):
            bmax = max(1, elems // S)
            for lo in range(0, len(idxs), bmax):
                chunk = idxs[lo:lo + bmax]
                pending.append((chunk, dec.dispatch_segment_batch(
                    [segs[i] for i in chunk], bucket=S, nparms=nparms,
                    correctdbg=correctdbg)))
        return pending

    def collect(pending, results):
        for chunk, dev_res in pending:
            res = _fetch(dev_res)
            for j, i in enumerate(chunk):
                results[i] = {k: v[j] for k, v in res.items()}

    results = [None] * len(segs)

    def pe_unreliable(res, j, seg_len):
        """A PE lane that never all-idled in its window, gave up on tau or
        ran out of scan budget, and reports a block with errors and
        minbits 0. Its reference counterpart is a giant merged scan with
        data on every track, a non-stopping BS_BLOCK with errors, so its
        minbits counts as 1."""
        return ((int(res["end_s"][j]) >= seg_len
                 or bool(res["tau_gaveup"][j])
                 or bool(res["scan_incomplete"][j]))
                and int(res["blktype"][j]) in (nrzi_mod.BS_BLOCK,
                                               nrzi_mod.BS_BADBLOCK)
                and int(res["minbits"][j]) == 0
                and int(res["errcount"][j]) > 0)

    def stopper(i):
        res = results[i]
        a, b = segs[i]
        mb = int(res["minbits"][0])
        if opts.mode == tb.MODE_PE and pe_unreliable(
                res, 0, b - max(a - SEG_WARMUP, 0)):
            mb = 1              # must not trip PE's dead-track stop rule
        return is_stopping_decode(
            int(res["blktype"][0]), int(res["errcount"][0]),
            int(res["warncount"][0]), mb, opts.mode)

    def stage(idxs, nparms):
        with telemetry.span("driver.stage", nparms=nparms,
                            segments=len(idxs)):
            collect(dispatch(idxs, nparms), results)

    def decode_indices(idxs):
        if correctdbg:
            # the JAX package decodes each segment with every parmset
            # under -correctdbg and picks over all of them; a segment's
            # lanes do not depend on the others', so they batch
            stage(idxs, dec.P)
            return
        # staged retry, the reference's sequential-try semantics
        # (readtape.c:1755-1795): parmset 0 everywhere, then all parmsets
        # for the blocks that were not a stopping decode
        stage(idxs, 1)
        if opts.multiple_tries and dec.P > 1:
            retry = [i for i in idxs if not stopper(i)]
            stage(retry, dec.P)

    def add_segment(a, b, after):
        """A new segment (a, b) placed right after `after` in tape order;
        returns its index."""
        j = len(segs)
        segs.append((a, b))
        buckets.append(maxbkt if unified else
                       seg.bucket_length(b - max(a - SEG_WARMUP, 0)))
        results.append(None)
        order.insert(order.index(after) + 1, j)
        return j

    def remainder_rounds(next_start):
        """Multi-block segments (NRZI, GCR), round by round:
        next_start(res, p, seg_len) gives the window offset where the
        rest of a segment starts after its winner p's block, or None; each
        rest is decoded as a fresh segment right after its parent in tape
        order, the per-block re-entry of readtape.c:1720-1882. Every spawn
        strictly advances its chain's start, so the loop ends; the cap
        only guards against a runaway."""
        frontier = order[:]
        for _round in range(65536):
            spawned = []
            for i in frontier:
                a, b = segs[i]
                res = results[i]
                p, _ = pick_best(res, len(res["blktype"]),
                                 opts.multiple_tries, opts.mode)
                a0 = max(a - SEG_WARMUP, 0)
                off = next_start(res, p, b - a0)
                if off is not None and a < a0 + off < b - 4:
                    spawned.append(add_segment(a0 + off, b, i))
            if not spawned:
                break
            decode_indices(spawned)
            frontier = spawned

    def nrzi_next(res, p, seg_len):
        """NRZI: the slot scan self-terminates at the block's postamble
        idle; admitted transitions left past that point are another block
        behind a sub-min_gap gap, after the interblock blanking
        (decode_nrzi.c:112)."""
        if int(res["unconsumed"][p]) <= 0 or (
                (adjskew or correctdbg)
                and int(res["blktype"][p]) == nrzi_mod.BS_NONE):
            return None
        return int(res["end_s"][p]) + int(cm.NRZI_IBG_SECS / opts.deltat)

    def gcr_next(res, p, seg_len):
        """GCR: the block ends where every track's datablock has dropped
        (all-idle, decoder.c:879-888); the rest starts after the
        interblock blanking that only a clean block (gcr_postprocess)
        sets (decode_gcr.c:673), pulled up to `anchor` samples before the
        first candidate behind the block, so that a scan sees it with a
        full window on every track (stagger + W). A GCR track goes idle
        only after it has data, so a stretch without admissions never
        ends a block: unlike PE's walk, no hop needs a race re-anchor."""
        anchor = max(cm.pkww_width_for(ps.pkww_bitfrac, opts.bpi, opts.ips,
                                       opts.deltat)
                     for ps in opts.parmsets.sets) + opts.ntrks - 2
        bt = int(res["blktype"][p])
        end_s = int(res["end_s"][p])
        cand = int(res["cand_after"][p])
        if end_s >= seg_len or bt == nrzi_mod.BS_NONE or cand >= seg_len:
            return None
        step = (int(cm.GCR_IBG_SECS / opts.deltat)
                if bt == nrzi_mod.BS_BLOCK else 1)
        return max(end_s + step, cand - anchor)

    def pe_walk():
        """Multi-block segments (PE), the JAX package's PE walk: the
        reference ends a PE block the moment ALL tracks go idle
        (pe_end_of_block, decoder.c:868-877) and restarts the scan with
        fresh track state right after (noise/tapemark: next sample; data
        block: after PE_IBG_SECS of blanking). Each winner whose scan
        left admissions or candidates beyond its all-idle point (end_s)
        re-dispatches the rest, readtape.c:1720-1882's per-block loop;
        hops with no peaks fast-forward to the next candidate. A lane
        that never all-idled inside its window widens to the next
        activity horizon (its reference scan merges across segments),
        and at the tape end is the reference's EOF BS_NONE."""
        ibg_blank = int(cm.PE_IBG_SECS / opts.deltat)
        # re-anchor margin: a scan started ANCHOR samples before a peak
        # sees it with a full moving window on every track (stagger + W)
        # while its detection still lands inside the virtual idle horizon
        maxW = max(cm.pkww_width_for(ps.pkww_bitfrac, opts.bpi, opts.ips,
                                     opts.deltat)
                   for ps in opts.parmsets.sets)
        anchor = maxW + opts.ntrks - 2
        n_total = dec.n_samples
        orig_ends = sorted(b for _, b in (segs[i] for i in order))
        consumed_until = -1
        endfile = False

        def tried_prefix(res, P_):
            """Lanes the sequential retry would have consumed."""
            if not opts.multiple_tries:
                return 1
            for j in range(P_):
                if is_stopping_decode(int(res["blktype"][j]),
                                      int(res["errcount"][j]),
                                      int(res["warncount"][j]),
                                      int(res["minbits"][j]), opts.mode):
                    return j + 1
            return P_

        for i0 in order[:]:
            if endfile or segs[i0][0] < consumed_until:
                if i0 in order:
                    order.remove(i0)     # consumed by an earlier chain
                continue
            cur = i0
            for _hop in range(65536):
                if results[cur] is None:
                    decode_indices([cur])
                res = results[cur]
                a_c, b_c = segs[cur]
                a0_ = max(a_c - SEG_WARMUP, 0)
                seg_len_c = b_c - a0_
                P_ = len(res["blktype"])
                unrel = [j for j in range(P_)
                         if pe_unreliable(res, j, seg_len_c)]
                if unrel:
                    res = dict(res, minbits=np.array(res["minbits"]))
                    res["minbits"][unrel] = 1
                    results[cur] = res
                tp = tried_prefix(res, P_)
                # gave-up and incomplete lanes are not proven never-idle:
                # they count as finished at the segment end
                unfinished = [j for j in range(tp)
                              if int(res["end_s"][j]) >= seg_len_c
                              and not bool(res["tau_gaveup"][j])
                              and not bool(res["scan_incomplete"][j])]
                if unfinished and b_c < n_total - 4:
                    # widen to the next activity horizon
                    nxt_b = next((e for e in orig_ends if e > b_c), n_total)
                    nxt_b = max(nxt_b, min(2 * b_c - a_c, n_total))
                    segs[cur] = (a_c, nxt_b)
                    buckets[cur] = seg.bucket_length(nxt_b - a0_)
                    results[cur] = None
                    continue
                p, _t = pick_best(res, P_, opts.multiple_tries, opts.mode)
                if unfinished and p in unfinished:
                    # tape end, and the best decode never all-idled: EOF,
                    # the partial block is dropped and nothing follows
                    if cur in order:
                        order.remove(cur)
                    endfile = True
                    break
                bt = int(res["blktype"][p])
                end_s = int(res["end_s"][p])
                cand = int(res["cand_after"][p])
                cand_abs = a0_ + cand if cand < seg_len_c else None
                if int(res["consumed"][p]) == 0 and bt == nrzi_mod.BS_NOISE:
                    # zero-admission hop: candidates whose detection would
                    # have landed past tau restart fully visible
                    race = int(res["cand_race"][p])
                    if race >= seg_len_c:
                        break
                    nxt_start = max(a_c + 1, a0_ + race - anchor)
                else:
                    # BS_BLOCK sets the interblock counter (decode_pe.c:95);
                    # noise and tapemarks return at once
                    step = (ibg_blank if bt in (nrzi_mod.BS_BLOCK,
                                                nrzi_mod.BS_BADBLOCK)
                            else 1)
                    if cand_abs is None:
                        break           # nothing beyond tau at all
                    # skip empty hops: re-anchor at the next candidate
                    nxt_start = max(a0_ + end_s + step, cand_abs - anchor)
                if not (a_c < nxt_start < b_c - 4):
                    break
                # bound the hop to the next activity horizon
                b_hop = next((e for e in orig_ends if e > nxt_start + 4), b_c)
                b_hop = min(max(b_hop, nxt_start + 5), b_c)
                cur = add_segment(nxt_start, b_hop, cur)
            consumed_until = max(consumed_until, segs[cur][1])

    def zeros_chain():
        """NRZI -zeros, the JAX package's sequential chain (readtape.c:
        1720-1882): the zero-crossing extremum carries run across the gap
        from one block to the next, so each window starts where the
        reference resets them, at the previous block's end plus the NRZI
        interblock blanking (decoder.c:901-904), and runs to the end of
        the activity segment it lies in. A window with nothing in it
        (BS_NONE) is dropped and the next one keeps its start, widened to
        the next segment's end. The windows share one bucket."""
        ibg_blank = int(cm.NRZI_IBG_SECS / opts.deltat)
        act = segs[:]
        chainbkt = max(seg.bucket_length(b - max(a - SEG_WARMUP, 0))
                       for a, b in zip([0] + [a for a, _ in act],
                                       [b for _, b in act]))
        del segs[:], buckets[:], results[:], order[:]
        cur, si = 0, 0
        while si < len(act):
            b_i = act[si][1]
            if cur >= b_i - 4:
                si += 1
                continue
            a0w = max(cur - SEG_WARMUP, 0)
            i = len(segs)
            segs.append((cur, b_i))
            buckets.append(max(chainbkt, seg.bucket_length(b_i - a0w)))
            results.append(None)
            order.append(i)
            decode_indices([i])
            res = results[i]
            p, _ = pick_best(res, len(res["blktype"]), opts.multiple_tries,
                             opts.mode)
            if int(res["blktype"][p]) == nrzi_mod.BS_NONE:
                order.remove(i)
                si += 1
                continue
            nxt = a0w + int(res["end_s"][p]) + ibg_blank
            if nxt <= cur:
                si += 1
                continue
            cur = nxt

    def adjskew_chain():
        """-adjskew (decoder.c:305-320), the JAX package's sequential
        driver: after every data block each track's skew delay moves by
        one sample towards its average peak deviation. The skew of block
        n depends on blocks 0..n-1, and the deviation accumulators thread
        through every parmset try in the reference's order (reset only
        after a data block, so tapemark and noise segments roll into the
        next data block): one segment at a time, each try its own B=1,
        P=1 decode seeded with the running (count, mean), a winner that
        is not the last try decoded again (its peaks accumulate again,
        readtape.c:1853-1863), each remainder decoded right after its
        block."""
        T = opts.ntrks
        adj = [np.zeros(T, np.float32), np.zeros(T, np.float32)]
        k = 0
        while k < len(order):
            i = order[k]
            k += 1
            a, b = segs[i]

            def one(psel):
                r = dec.decode_segment_batch(
                    [(a, b)], bucket=buckets[i], parm_sel=(psel,),
                    adj_init=tuple(adj))
                r = {kk: v[0] for kk, v in r.items()}      # [P=1, ...]
                adj[:] = [r["adj_n"][0], r["adj_mean"][0]]
                return r

            tries = [one(0)]
            while opts.multiple_tries and len(tries) < dec.P:
                r = tries[-1]
                if is_stopping_decode(int(r["blktype"][0]),
                                      int(r["errcount"][0]),
                                      int(r["warncount"][0]),
                                      int(r["minbits"][0]), opts.mode):
                    break
                tries.append(one(len(tries)))
            res = {kk: np.stack([r[kk][0] for r in tries]) for kk in tries[0]}
            results[i] = res
            p, _ = pick_best(res, len(tries), opts.multiple_tries, opts.mode)
            bitspace = np.float32(one(p)["t_bitspaceavg"][0]
                                  if p != len(tries) - 1
                                  else res["t_bitspaceavg"][p])
            bt = int(res["blktype"][p])
            if bt in (nrzi_mod.BS_BLOCK, nrzi_mod.BS_BADBLOCK):
                # adjust_deskew, for every data block (readtape.c:1310);
                # MAXSKEWSAMP 50
                report = []
                thr = np.float32(0.1) * bitspace
                for trk in range(T):
                    dev_ = np.float32(adj[1][trk])
                    act = 0
                    if dev_ < thr and dec.skew[trk] > 0:
                        dec.skew[trk] -= 1
                        act = -1
                    elif dev_ > thr and dec.skew[trk] < 50:
                        dec.skew[trk] += 1
                        act = 1
                    report.append((float(dev_) * opts.deltat,
                                   float(bitspace) * opts.deltat, act,
                                   int(dec.skew[trk])))
                res["_adjskew_report"] = report
                adj[:] = [np.zeros(T, np.float32), np.zeros(T, np.float32)]
            a0 = max(a - SEG_WARMUP, 0)
            off = nrzi_next(res, p, b - a0)
            if off is not None and a < a0 + off < b - 4:
                add_segment(a0 + off, b, i)

    order = list(range(len(segs)))
    if opts.mode == tb.MODE_NRZI and opts.find_zeros:
        zeros_chain()
    elif adjskew:
        adjskew_chain()
    else:
        decode_indices(order[:])
    if opts.mode == tb.MODE_PE:
        with telemetry.span("driver.pe_walk"):
            pe_walk()
    elif not opts.find_zeros and not adjskew:
        with telemetry.span("driver.remainder"):
            remainder_rounds(gcr_next if opts.mode == tb.MODE_GCR
                             else nrzi_next)
    with telemetry.span("driver.emit"):
        return _emit_blocks(dec, opts, segs, order, results, stats,
                            adjskew)


def _emit_blocks(dec, opts, segs, order, results, stats, adjskew):
    """Block emission in tape order: each segment's pick over its tried
    parmsets, the peak statistics, and the blocks, tapemarks and counts
    of `stats`. Returns (blocks, stats)."""
    blocks = []
    for i in order:
        a, b = segs[i]
        if stats["nblocks"] >= opts.blklimit:
            break
        res = results[i]
        p, tries = pick_best(res, len(res["blktype"]),
                             opts.multiple_tries, opts.mode)
        # peak stats accumulate across every parmset try, plus the
        # winner's re-decode when it wasn't the last try (the C never
        # resets peak_counts between retries, decoder.c:136-141;
        # re-decode at readtape.c:1853-1863)
        for t_i in range(min(tries, len(res["hist"]))):
            stats["peak_hist"] += res["hist"][t_i]
            stats["peak_trksums"] += res["trksums"][t_i]
        if tries > 1 and p != tries - 1:
            stats["peak_hist"] += res["hist"][p]
            stats["peak_trksums"] += res["trksums"][p]
        for t_i in range(tries):
            stats["tried"][t_i] += 1
        bt = int(res["blktype"][p])
        t_start = opts.t0_seconds + a * opts.deltat
        # block end: where the scan ended the block (postamble fire, the
        # all-idle point); GCR under -zeros has none: the segment's end
        end_b = b
        if "end_s" in res:
            end_b = min(max(a - SEG_WARMUP, 0) + int(res["end_s"][p]), b)
        t_end = opts.t0_seconds + end_b * opts.deltat
        if bt == nrzi_mod.BS_NONE:
            continue
        if bt != nrzi_mod.BS_NOISE:
            stats["chosen"][p] += 1
        if bt == nrzi_mod.BS_TAPEMARK:
            blocks.append(BlockResult("tapemark", parmset=p, tries=tries,
                                      t_start=t_start, t_end=t_end))
            stats["ntapemarks"] += 1
            continue
        if bt == nrzi_mod.BS_NOISE:
            continue
        err = int(res["errcount"][p])
        warn = int(res["warncount"][p])
        detail = {k: np.asarray(res[k][p]).tolist()
                  for k in ("minbits", "maxbits", "track_mismatch",
                            "vparity_errs", "crc_errs", "lrc_errs",
                            "missed_midbits", "corrected_bits",
                            "faked_tracks", "avg_bit_spacing",
                            "alltrk_max_agc", "alltrk_min_agc")}
        if "_adjskew_report" in res:
            detail["adjskew"] = res["_adjskew_report"]
        if bt == nrzi_mod.BS_BADBLOCK:
            blocks.append(BlockResult("badblock", parmset=p, tries=tries,
                                      errcount=err, warncount=warn,
                                      detail=detail,
                                      t_start=t_start, t_end=t_end))
            stats["nunusable"] += 1
            continue
        n = int(res["minbits"][p])
        frames = res["frames"][p][:n]
        data = (frames >> 1).astype(np.uint8)
        if opts.add_parity:
            data = data | ((frames & 1).astype(np.uint8) << (opts.ntrks - 1))
        blocks.append(BlockResult("data", bytes(data.tobytes()), parmset=p,
                                  tries=tries, errcount=err, warncount=warn,
                                  detail=detail,
                                  t_start=t_start, t_end=t_end))
        stats["nblocks"] += 1
        if err:
            stats["nerrblocks"] += 1
        if warn:
            stats["nwarnblocks"] += 1
        if detail["track_mismatch"]:
            stats["nmismatched"] += 1
        if detail["missed_midbits"]:
            stats["nmidbiterr"] += 1
        if detail["corrected_bits"]:
            stats["ncorrected"] += 1
        if err == 0 and warn == 0 and tries > 1:
            stats["ngoodmultiple"] += 1
    if adjskew:
        # the end-of-run skew report shows the adjusted delays
        stats["skew"] = dec.skew.tolist()
    return blocks, stats


# ---------------------------------------------------------------------------
# Whirlwind
# ---------------------------------------------------------------------------

def ww_trace_lanes(samples, opts: DecodeOptions, a: int, b: int, *,
                   device="cuda"):
    """Whirlwind -trace extraction: per-track peak events plus the track-0
    data lane (TRACE(data, clkendtime, UPTICK*(1 + 2 bits)),
    decode_ww.c:90), for samples [a, b) with parmset 0. Returns (volts
    [b-a, T] numpy, lanes) like TapeDecoder.trace_lanes: the JAX package's
    ww_trace_lanes, with the height estimate of the window alone, over B4
    in its record mode on the card (its plain version on the CPU). Like
    the decode, the admission runs to the window's end: the JAX function
    stops each track after int(S / spb * 3.2) + 64 steps."""
    type_to_trk, head_to_trk, ntrks = ww_mod.parse_ww_order(opts.ww_order)
    used = [h for h, t in enumerate(head_to_trk) if t >= 0]
    samples = samples[:, used]
    perm = [head_to_trk[h] for h in used]
    cols = np.zeros(ntrks, np.int64)
    for pos, trkn in enumerate(perm):
        cols[trkn] = pos
    samples = np.ascontiguousarray(samples[a:b][:, cols])
    dev = _placement(device, samples)[0]
    T = ntrks
    S = seg.bucket_length(b - a)
    v = torch.from_numpy(samples).to(dev).T.contiguous()        # [T, b-a]
    h_est, _ = seg.device_activity(v.to(F32), opts.maxvolts, 1)
    v = torch.nn.functional.pad(v, (0, S - v.shape[1]))
    skew = np.zeros(T, np.int32)
    if opts.skew is not None:
        skew[:len(opts.skew)] = opts.skew
    spb = opts.spb
    p0 = opts.parmsets[0]
    vf = _prep_volts(v, opts.maxvolts, -1.0 if opts.invert else 1.0,
                     torch.as_tensor(skew, dtype=I32, device=dev),
                     differentiate=opts.differentiate,
                     spb_int=int(spb)).contiguous()
    scale = min(1.0, h_est / cm.PKWW_PEAKHEIGHT)
    lb, bw = _peakstat_bins(opts.mode, 1.0 / (opts.bpi * opts.ips))
    out = fused_mod.ww_fused_scan(
        vf, W=cm.pkww_width_for(p0.pkww_bitfrac, opts.bpi, opts.ips,
                                opts.deltat),
        rise_floor=torch.full((T,), p0.pkww_rise * scale / cm.AGC_MAX_VALUE
                              * 0.8, dtype=F32, device=dev),
        min_floor=torch.full((T,), p0.min_peak * scale / cm.AGC_MAX_VALUE
                             * 0.8, dtype=F32, device=dev),
        v_avg_height=torch.full((T,), cm.PKWW_PEAKHEIGHT, dtype=F32,
                                device=dev),
        parms=p0, spb=spb, stat_lb=float(np.float32(lb / opts.deltat)),
        stat_bw=float(np.float32(bw / opts.deltat)),
        K=int(S / spb * 2.5) + 64, maxchars=int(S / spb) + 256,
        fluxdir=ww_mod.FLUX_DIRS[opts.fluxdir],
        roles=[type_to_trk[k] for k in range(len(ww_mod.ROLES))],
        maxblocks=4096, records=True)
    t0 = opts.t0_seconds + a * opts.deltat
    dt = opts.deltat

    def tsec(x):
        return t0 + float(x) * dt

    n = out["trk_i"][:, fused_mod.WT_NADM].cpu().numpy()
    tr_t = out["tr_t"].cpu().numpy()
    tr_top = out["tr_top"].cpu().numpy()
    peaks = [[(tsec(x), bool(u)) for x, u in zip(tr_t[trk][:n[trk]],
                                                 tr_top[trk][:n[trk]])]
             for trk in range(T)]
    nchars = int(out["scal"][fused_mod.WS_DATACOUNT])
    chars = out["chars"].cpu().numpy()
    char_t = out["char_t"].cpu().numpy()
    data = [[] for _ in range(T)]
    data[0] = [(tsec(char_t[i]), int(chars[i])) for i in range(nchars)]
    volts = vf.T[:b - a].cpu().numpy()
    return volts, dict(peak=peaks, data=data)


def _decode_tape_ww(samples, opts: DecodeOptions, device: torch.device):
    """Whirlwind: the whole tape decodes in one pass (blocks can abut;
    decode_ww.c:29-31), no multi-parmset retry (readtape.c:1987). The JAX
    package's single-pass path (run_pass_single) without its admission
    step budget (see decode/fused.py): positions are int32 and the
    machine's rolling base keeps sub-sample times exact, so any tape
    below 2^30 samples is one ww_fused_scan call."""
    type_to_trk, head_to_trk, ntrks = ww_mod.parse_ww_order(opts.ww_order)
    used = [h for h, t in enumerate(head_to_trk) if t >= 0]
    samples = samples[:, used]
    perm = [head_to_trk[h] for h in used]
    cols = np.zeros(ntrks, np.int64)
    for pos, trkn in enumerate(perm):
        cols[trkn] = pos
    samples = samples[:, cols]
    T, N = ntrks, samples.shape[0]
    if N >= fused_mod.WW_MAX_SAMPLES:
        raise ValueError(f"{N} samples: a Whirlwind tape must be shorter "
                         f"than {fused_mod.WW_MAX_SAMPLES}")
    p0 = opts.parmsets[0]
    W = cm.pkww_width_for(p0.pkww_bitfrac, opts.bpi, opts.ips, opts.deltat)
    # eighth-granularity buckets: the whole padded tape is one sweep, so a
    # power-of-two bucket would cost up to 2x
    p2 = seg.bucket_length(N)
    gran = max(p2 // 8, 2048)
    S = -(-N // gran) * gran
    tape, h_est, _ = _resident_tape(samples, opts.maxvolts, device,
                                    max(1, (N * T) // 2_000_000))
    tape = torch.nn.functional.pad(tape, (0, S - N))
    skew = np.zeros(T, np.int32)
    if opts.skew is not None:
        skew[:len(opts.skew)] = opts.skew

    spb = opts.spb
    lb, bw = _peakstat_bins(opts.mode, 1.0 / (opts.bpi * opts.ips))
    scale = min(1.0, h_est / cm.PKWW_PEAKHEIGHT)
    knobs = dict(
        W=W, parms=p0, spb=spb,
        rise_floor=torch.full((T,), p0.pkww_rise * scale / cm.AGC_MAX_VALUE
                              * 0.8, dtype=F32, device=device),
        min_floor=torch.full((T,), p0.min_peak * scale / cm.AGC_MAX_VALUE
                             * 0.8, dtype=F32, device=device),
        stat_lb=float(np.float32(lb / opts.deltat)),
        stat_bw=float(np.float32(bw / opts.deltat)),
        K=int(S / spb * 2.5) + 64,
        maxchars=int(N / spb) + 256,
        fluxdir=ww_mod.FLUX_DIRS[opts.fluxdir],
        roles=[type_to_trk[k] for k in range(len(ww_mod.ROLES))])

    def run_pass(skew_arr, v_avg_init):
        volts = _prep_volts(tape, opts.maxvolts,
                            -1.0 if opts.invert else 1.0,
                            torch.as_tensor(skew_arr, dtype=I32,
                                            device=device),
                            differentiate=opts.differentiate,
                            spb_int=int(spb)).contiguous()
        out = fused_mod.ww_fused_scan(
            volts, v_avg_height=torch.as_tensor(v_avg_init, device=device),
            **knobs)
        host = {k: v.cpu() for k, v in out.items()}
        return {k: v.numpy()
                for k, v in fused_mod.ww_fused_state(host).items()}

    v_avg_init = np.full(T, cm.PKWW_PEAKHEIGHT, np.float32)
    if opts.deskew and opts.skew is None:
        # calibration pass: skew from the transition-position histogram
        # (readtape.c:1676-1717), average pulse heights for AGC baselines
        res0 = run_pass(np.zeros(T, np.int32), v_avg_init)
        sums = res0["trksums"].astype(np.int64)
        if sums.min() > 0:
            us = bw * 1e6 * np.arange(50) + lb * 1e6
            avg = (res0["hist"][:, 1:49] *
                   us[1:49][None, :]).sum(axis=1) / np.maximum(sums, 1)
            delays_us = avg.max() - avg
            skew = np.minimum(((delays_us * 1e-6 + opts.deltat / 2) /
                               opts.deltat).astype(np.int32), 50)
        hc = np.maximum(res0["h_cnt"], 1)
        v_avg_init = np.where(res0["h_cnt"] > 0, res0["h_sum"] / hc,
                              cm.PKWW_PEAKHEIGHT).astype(np.float32)

    res = run_pass(skew, v_avg_init)
    raw = ww_mod.assemble_ww_blocks(res, spb, opts.reverse)

    blocks = []
    stats = dict(nblocks=0, ntapemarks=0, nerrblocks=0, nwarnblocks=0,
                 nunusable=0, nmismatched=0, nmidbiterr=0, ncorrected=0,
                 ngoodmultiple=0, tried=np.zeros(1, int),
                 chosen=np.zeros(1, int), deskew_percent=0.0,
                 skew=np.asarray(skew).tolist(),
                 peak_hist=res["hist"].astype(np.int64),
                 peak_trksums=res["trksums"].astype(np.int64),
                 peak_bins=(lb, bw),
                 num_flux_changes=int(res["num_flux_changes"]),
                 flux_dir_final=("pos" if int(res["flux"]) ==
                                 ww_mod.FLUX_POS else "neg"))
    for rb in raw:
        if stats["nblocks"] >= opts.blklimit:
            break
        t_blk = opts.t0_seconds + rb["t_end_samples"] * opts.deltat
        if rb["kind"] == "tapemark":
            blocks.append(BlockResult("tapemark", t_start=t_blk,
                                      t_end=t_blk))
            stats["ntapemarks"] += 1
            continue
        w = rb["warnings"]
        err = w["ww_bad_length"] + w["ww_speed_err"]
        warn = (w["ww_leading_clock"] + w["ww_missing_onebit"] +
                w["ww_missing_clock"])
        blocks.append(BlockResult("data", rb["data"], errcount=err,
                                  warncount=warn, detail=dict(w),
                                  t_start=t_blk, t_end=t_blk))
        stats["nblocks"] += 1
        stats["tried"][0] += 1
        stats["chosen"][0] += 1
        if err:
            stats["nerrblocks"] += 1
        if warn:
            stats["nwarnblocks"] += 1
    return blocks, stats
