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
"""

from __future__ import annotations

import torch

from .. import kernels, telemetry
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


def _check(feat, nxt, pa, Ws, K, max_steps, one_width):
    if feat.dim() != 5 or feat.dtype != F32 or \
            feat.shape[-1] != trackscan.N_FEAT:
        raise ValueError("feat must be float32 [G, B, T, S, 10]")
    G, B, T, S, _ = feat.shape
    if tuple(nxt.shape) != (B, T, S + 1) or nxt.dtype != I32:
        raise ValueError("nxt must be int32 [B, T, S+1]")
    if not Ws or min(Ws) < 1 or max(Ws) > S or G != len(set(Ws)):
        raise ValueError(f"window widths {Ws} do not match {G} groups")
    if one_width and G != 1:
        raise ValueError("nrzi_track_scan_tracks needs one shared width")
    if not 1 <= T <= kernels.NRZI_MAX_TRACKS or \
            len(pa.agc_window) != len(Ws):
        raise ValueError(f"{T} tracks or {len(pa.agc_window)} parmsets")
    if K < 1 or max_steps < 1:
        raise ValueError("K and max_steps must be positive")


def _steps(feat, max_steps):
    # every step moves a cursor forward: S + 1 steps never bind
    return feat.shape[3] + 1 if max_steps is None else int(max_steps)


def _scan(fn, plain, launch, one_width, feat, nxt, pa, Ws, K, max_steps):
    """A wrapper's body: the plain version on a CPU tensor, the kernel on a
    CUDA tensor (or raise); counts the kernel's launches on fn."""
    Ws, K, steps = tuple(int(w) for w in Ws), int(K), _steps(feat, max_steps)
    if feat.device.type == "cpu":
        return plain(feat, nxt, pa, Ws=Ws, K=K, max_steps=steps)
    if feat.device.type != "cuda":
        raise ValueError(f"{fn.__name__}: no kernel for {feat.device}")
    with telemetry.span("launch." + fn.__name__):
        telemetry.count("launches." + fn.__name__)
        _check(feat, nxt, pa, Ws, K, steps, one_width)
        with telemetry.wait("ring_check"):
            ring = int(pa.agc_window.max())
        if ring > kernels.NRZI_MAX_AGC_RING:
            raise ValueError("agc_window beyond the kernel's ring")
        out = launch(feat, nxt, pa, Ws=Ws, K=K, max_steps=steps)
    fn.launches += 1
    return out


def _plain(feat, nxt, pa, Ws, K, max_steps, one_width):
    steps = _steps(feat, max_steps)
    _check(feat, nxt, pa, Ws, K, steps, one_width)
    out = scan_lanes(feat, nxt, pa, Ws, K, steps)
    out["incomplete"] = out["incomplete"] | (out["n_admitted"] > K)
    return out


@torch.inference_mode()
def nrzi_track_scan_plain(feat, nxt, pa: cm.ParmArrays, *, Ws, K: int,
                          max_steps: int = None):
    """The plain PyTorch version of B5a (same arguments and outputs as
    nrzi_track_scan)."""
    nrzi_track_scan_plain.calls += 1
    return _plain(feat, nxt, pa, Ws, K, max_steps, one_width=False)


@torch.inference_mode()
def nrzi_track_scan_tracks_plain(feat, nxt, pa: cm.ParmArrays, *, Ws,
                                 K: int, max_steps: int = None):
    """The plain PyTorch version of B5b (same arguments and outputs as
    nrzi_track_scan_tracks)."""
    nrzi_track_scan_tracks_plain.calls += 1
    return _plain(feat, nxt, pa, Ws, K, max_steps, one_width=True)


nrzi_track_scan_plain.calls = 0
nrzi_track_scan_tracks_plain.calls = 0


def nrzi_track_scan(feat, nxt, pa: cm.ParmArrays, *, Ws, K: int,
                    max_steps: int = None):
    """B5a: admission for parmsets of any window widths (see the module
    docstring for arguments and outputs)."""
    return _scan(nrzi_track_scan, nrzi_track_scan_plain, kernels.nrzi_scan,
                 False, feat, nxt, pa, Ws, K, max_steps)


def nrzi_track_scan_tracks(feat, nxt, pa: cm.ParmArrays, *, Ws, K: int,
                           max_steps: int = None):
    """B5b: admission when every parmset shares one window width (feat has
    one group)."""
    return _scan(nrzi_track_scan_tracks, nrzi_track_scan_tracks_plain,
                 kernels.nrzi_scan_tracks, True, feat, nxt, pa, Ws, K,
                 max_steps)


nrzi_track_scan.launches = 0
nrzi_track_scan_tracks.launches = 0
