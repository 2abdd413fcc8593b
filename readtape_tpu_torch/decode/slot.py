"""The NRZI global bit-slot machine alone -- the counterpart of
readtape_tpu/decode/pallas_slot.py (TPU kernel B6).

``nrzi_slot_scan`` runs nrzi.nrzi_slot_scan's machine (zerocheck, clock,
peak statistics, ``-correct``) for every (segment, parmset) lane over the
transition buffers that decode/scan.py's admission wrote, and returns B1's
output (``FusedOut``, read by fused.fused_state): the TPU kernel's
stream/track-block split and slot_stream_reconstruct exist only to get
state out of a TPU kernel, so the port writes the state directly. On a
CUDA tensor it launches csrc/nrzi_slot.cu; on a CPU tensor it runs
``nrzi_slot_scan_plain``. There is no fallback between the two. Unlike
the TPU kernel, both keep -correct, up to 16 tracks and any S below 2^30,
as the XLA scan does.

The exponential clock average, a * delta + (1 - a) * avg in the JAX
package, is one fused multiply-add in XLA's CPU build, and which product
it fuses depends on the program: fma(a, delta, (1 - a) * avg) in its NRZI
peak path and in its -zeros batches of several parmsets, fma(1 - a, avg,
a * delta) in its -zeros batches of one parmset (found on -zeros tapes
whose peak histograms differ by the choice, tests/
test_torch_zeros_pipeline.py). ``clk_avg_fma`` selects the second.

FusedOut, for B segments x P parmsets:
  bits  int8  [B, P, T, maxb]
  hist  int32 [B, P, T, 50]
  trk_i int32 [B, P, T, 5]   TI_* per-track integers
  trk_f f32   [B, P, T, 4]   TF_* per-track floats
  lane_i int32 [B, P, 6]     LI_* per-lane integers
"""

from __future__ import annotations

import torch

from .. import kernels
from . import common as cm
from . import nrzi as nrzi_mod
from .common import F32, I32

(TI_DC, TI_KVIS, TI_NADM, TI_TRKSUM, TI_INCOMP) = range(5)
N_TI = 5
(TF_TFIRST, TF_TLAST, TF_MAXAGC, TF_MINAGC) = range(4)
N_TF = 4
(LI_MISSMID, LI_CORR, LI_FAKED, LI_CONSOVF, LI_ENDS, LI_NSLOT) = range(6)
N_LI = 6


def slot_lanes(fin, pa: cm.ParmArrays, *, S: int, spb: float,
               expected_parity: int, do_correct: bool, maxb: int,
               max_slots: int, stat_lb: float, stat_bw: float,
               clk_avg_fma: bool = False):
    """nrzi.nrzi_slot_scan over every (b, p) lane of the admission
    outputs fin ([B, P, T, K] buffers, [B, P, T] counts and per-track
    fields); returns FusedOut."""
    B, P, T, K = fin["tr_s"].shape
    dev = fin["tr_s"].device

    def lanes(x):
        return x.reshape((B * P, T) + x.shape[3:])
    # the machine reads s_det past a track's count as "never"
    keep = torch.arange(K, device=dev) < fin["n_admitted"].unsqueeze(-1)
    tr_s = torch.where(keep, fin["tr_s"], nrzi_mod.BIG_S)
    pp = torch.arange(P, device=dev).repeat(B)
    st = nrzi_mod.nrzi_slot_scan(
        lanes(tr_s), lanes(fin["tr_t"]), lanes(fin["tr_agc"]),
        lanes(fin["n_admitted"]), S, spb, pa.clk_window[pp],
        pa.clk_alpha[pp], pa.pulse_adj[pp], pa.midbit[pp], expected_parity,
        do_correct, maxb, max_slots, stat_lb, stat_bw,
        clk_ring=max(int(pa.clk_window.max()), 1), clk_avg_fma=clk_avg_fma)
    trk_i = torch.stack([st["dc"], st["kvis"], lanes(fin["n_admitted"]),
                         st["trksums"], lanes(fin["incomplete"]).to(I32)],
                        dim=-1)
    trk_f = torch.stack([st["t_firstbit"], st["t_lastbit"],
                         lanes(fin["max_agc_gain"]),
                         lanes(fin["min_agc_gain"])], dim=-1)
    lane_i = torch.stack([st["missed_midbits"], st["corrected_bits"],
                          st["faked_tracks"],
                          st["consume_overflow"].to(I32), st["end_s"],
                          st["nslots"]], dim=-1)
    return dict(bits=st["bits"].reshape(B, P, T, maxb),
                hist=st["hist"].reshape(B, P, T, 50),
                trk_i=trk_i.reshape(B, P, T, N_TI).to(I32),
                trk_f=trk_f.reshape(B, P, T, N_TF),
                lane_i=lane_i.reshape(B, P, N_LI).to(I32))


def _check(fin, pa, S, maxb, max_slots):
    B, P, T, K = fin["tr_s"].shape
    for k, dt in (("tr_s", I32), ("tr_t", F32), ("tr_agc", F32)):
        if fin[k].shape != (B, P, T, K) or fin[k].dtype != dt:
            raise ValueError(f"{k} must be {dt} [B, P, T, K]")
    for k in ("n_admitted", "max_agc_gain", "min_agc_gain", "incomplete"):
        if fin[k].shape != (B, P, T):
            raise ValueError(f"{k} must be [B, P, T]")
    if not 1 <= T <= kernels.NRZI_MAX_TRACKS or len(pa.clk_window) != P:
        raise ValueError(f"{T} tracks or {len(pa.clk_window)} parmsets")
    if not 0 < S < nrzi_mod.BIG_S or min(K, maxb, max_slots) < 1:
        raise ValueError("S, K, maxb and max_slots out of range")


@torch.inference_mode()
def nrzi_slot_scan_plain(fin, pa: cm.ParmArrays, **kw):
    """The plain PyTorch version of B6 (same arguments and outputs as
    nrzi_slot_scan)."""
    nrzi_slot_scan_plain.calls += 1
    _check(fin, pa, kw["S"], kw["maxb"], kw["max_slots"])
    return slot_lanes(fin, pa, **kw)


nrzi_slot_scan_plain.calls = 0


def nrzi_slot_scan(fin, pa: cm.ParmArrays, *, S: int, spb: float,
                   expected_parity: int, do_correct: bool, maxb: int,
                   max_slots: int, stat_lb: float, stat_bw: float,
                   clk_avg_fma: bool = False):
    """fin: decode/scan.py's outputs for B segments x P parmsets; pa: the
    P parmsets; S: the segments' bucket; spb: samples per bit; maxb: bit
    buffer length; max_slots: slot cap per lane; stat_lb/stat_bw:
    peak-statistics bins in samples; clk_avg_fma: the clock's other
    contraction (module docstring). Returns FusedOut."""
    kw = dict(S=int(S), spb=float(spb), expected_parity=int(expected_parity),
              do_correct=bool(do_correct), maxb=int(maxb),
              max_slots=int(max_slots), stat_lb=float(stat_lb),
              stat_bw=float(stat_bw), clk_avg_fma=bool(clk_avg_fma))
    dev = fin["tr_s"].device
    if dev.type == "cpu":
        return nrzi_slot_scan_plain(fin, pa, **kw)
    if dev.type != "cuda":
        raise ValueError(f"nrzi_slot_scan: no kernel for {dev}")
    _check(fin, pa, kw["S"], kw["maxb"], kw["max_slots"])
    if int(pa.clk_window.max()) > kernels.NRZI_MAX_CLK_RING:
        raise ValueError("clk_window beyond the kernel's ring")
    out = kernels.nrzi_slot(fin, pa, **kw)
    nrzi_slot_scan.launches += 1
    return out


nrzi_slot_scan.launches = 0
