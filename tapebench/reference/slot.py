"""The NRZI global bit-slot machine alone -- the counterpart of
readtape_tpu/decode/pallas_slot.py (TPU kernel B6).

``nrzi_slot_scan`` runs nrzi.nrzi_slot_scan's machine (zerocheck, clock,
peak statistics, ``-correct`` as the release or, ``correct_debug``, the
DEBUG build computes it, and with ``adj_init`` the -adjskew deviation
accumulators) for every (segment, parmset) lane over the
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
and with adj_init=(n0, mean0), each f32 [B, P, T], the seeds:
  adj   f32   [B, P, T, 2]   ADJ_N, ADJ_MEAN: the accumulators at the end
  bitspace f32 [B, P]        the clock's t_bitspaceavg at the end
and with records=True (-correct off), the -trace records:
  slot_f   f32   [B, P, max_slots, 2]  SL_ZC, SL_AVGPOS per live slot
                                       (lane_i's LI_NSLOT of them), 0 after
  col_slot int32 [B, P, T, maxb]       the slot of the last write to each
                                       column, -1 if none

Frozen here for the benchmark's reference: the plain PyTorch parts only
(the kernel wrappers and their checks are taken out), which B1's plain
version reads.
"""

from __future__ import annotations

import torch

from . import common as cm
from . import nrzi as nrzi_mod
from .common import F32, I32

(TI_DC, TI_KVIS, TI_NADM, TI_TRKSUM, TI_INCOMP) = range(5)
N_TI = 5
(TF_TFIRST, TF_TLAST, TF_MAXAGC, TF_MINAGC) = range(4)
N_TF = 4
(LI_MISSMID, LI_CORR, LI_FAKED, LI_CONSOVF, LI_ENDS, LI_NSLOT) = range(6)
N_LI = 6
(ADJ_N, ADJ_MEAN) = range(2)
(SL_ZC, SL_AVGPOS) = range(2)


def slot_lanes(fin, pa: cm.ParmArrays, *, S: int, spb: float,
               expected_parity: int, do_correct: bool, maxb: int,
               max_slots: int, stat_lb: float, stat_bw: float,
               clk_avg_fma: bool = False, correct_debug: bool = False,
               adj_init=None, records: bool = False):
    """nrzi.nrzi_slot_scan over every (b, p) lane of the admission
    outputs fin ([B, P, T, K] buffers, [B, P, T] counts and per-track
    fields); returns FusedOut (with records, its -trace records)."""
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
        clk_ring=max(int(pa.clk_window.max()), 1), clk_avg_fma=clk_avg_fma,
        correct_debug=correct_debug,
        adj_init=None if adj_init is None else tuple(lanes(x)
                                                     for x in adj_init),
        debug=records)
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
    out = dict(bits=st["bits"].reshape(B, P, T, maxb),
               hist=st["hist"].reshape(B, P, T, 50),
               trk_i=trk_i.reshape(B, P, T, N_TI).to(I32),
               trk_f=trk_f.reshape(B, P, T, N_TF),
               lane_i=lane_i.reshape(B, P, N_LI).to(I32))
    if adj_init is not None:
        out["adj"] = torch.stack([st["adj_n"], st["adj_mean"]],
                                 dim=-1).reshape(B, P, T, 2)
        out["bitspace"] = st["t_bitspaceavg"].reshape(B, P)
    if records:
        out["slot_f"] = torch.stack([st["dbg_zc"], st["dbg_avgpos"]],
                                    dim=-1).reshape(B, P, max_slots, 2)
        out["col_slot"] = st["dbg_col_slot"].reshape(B, P, T, maxb)
    return out
