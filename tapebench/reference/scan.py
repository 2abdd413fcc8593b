"""NRZI admission alone -- the counterpart of
readtape_tpu/decode/pallas_scan.py (TPU kernels B5a and B5b).

``nrzi_track_scan`` (B5a: parmsets of any window widths, each reading its
width's feature group) and ``nrzi_track_scan_tracks`` (B5b: every parmset
shares one width) run exact peak admission with AGC over precomputed
window features and a masked jump table, for every (segment, parmset,
track) lane, into [B, P, T, K] transition buffers. On a CUDA tensor each
launches its entry of csrc/nrzi_scan.cu; on a CPU tensor it runs its
plain version, trackscan.nrzi_track_scan_pre over every lane. There is no
fallback between the two.

Arguments: feat [G, B, T, S, 10] f32 (``window_features``: one group per
distinct width, sorted), nxt [B, T, S+1] int32 (the masked union jump
table), pa the P parmsets' ParmArrays, Ws their widths, K the buffer
entries per lane, max_steps the step budget per lane (None: none, as the
TPU kernels; density detection passes the JAX XLA scan's).

Outputs, like the TPU kernels': tr_s int32, tr_t/tr_agc f32, tr_top bool
[B, P, T, K] (compact_outputs' order, fill and overflow rule: the last
admission overwrites slot K-1); n_admitted int32, max_agc_gain,
min_agc_gain f32 and incomplete bool [B, P, T]. incomplete: the cursor
stopped before S (the budget) or admissions overflowed K -- the XLA scan
flags only the first, the TPU kernels only the second (ROADMAP.md §C).

Frozen here for the benchmark's reference: the plain PyTorch parts only
(the kernel wrappers and their checks are taken out), which B1's plain
version reads.
"""

from __future__ import annotations

import torch

from . import common as cm
from . import trackscan
from .common import F32, I32


def window_features(volts, Ws):
    """trackscan.precompute_window_features for each distinct width of
    Ws (sorted): [B, T, S] -> [G, B, T, S, 10] f32."""
    return torch.stack([trackscan.precompute_window_features(volts, W)
                        .transpose(-1, -2) for W in sorted(set(Ws))])


def scan_lanes(feat, nxt, pa: cm.ParmArrays, Ws, K: int, max_steps: int):
    """trackscan.nrzi_track_scan_pre over every (b, p, t) lane, parmset p
    reading its width's feature group. Returns the module's outputs, with
    incomplete set only where the cursor stopped before S."""
    G, B, T, S, _ = feat.shape
    P = len(Ws)
    dev = feat.device
    wset = sorted(set(Ws))
    b_i = torch.arange(B, device=dev).view(B, 1, 1).expand(B, P, T)
    p_i = torch.arange(P, device=dev).view(1, P, 1).expand(B, P, T)
    t_i = torch.arange(T, device=dev).view(1, 1, T).expand(B, P, T)
    grp = torch.as_tensor([wset.index(w) for w in Ws], device=dev)
    src = ((grp[p_i] * B + b_i) * T + t_i).reshape(-1)
    nsrc = (b_i * T + t_i).reshape(-1)
    pl = p_i.reshape(-1)
    W_l = torch.as_tensor(Ws, dtype=I32, device=dev)[pl]
    fin = trackscan.nrzi_track_scan_pre(
        feat.reshape(G * B * T, S, trackscan.N_FEAT), src,
        nxt.reshape(B * T, S + 1), nsrc, W_l, S, K, max_steps,
        pa.pkww_rise[pl], pa.min_peak[pl], pa.agc_alpha[pl],
        pa.agc_window[pl], agc_ring=max(int(pa.agc_window.max()), 1))
    return {k: fin[k].reshape((B, P, T) + fin[k].shape[1:]) for k in (
        "tr_s", "tr_t", "tr_agc", "tr_top", "n_admitted", "max_agc_gain",
        "min_agc_gain", "incomplete")}
