"""The -zeros front end on the card: kernels Z1 and Z2 of csrc/zeros.cu.

The JAX package computes -zeros with XLA, outside any Pallas kernel
(readtape_tpu/decode/gcr.py zerocross_transitions and
gcr_zeros_track_scan): no TPU kernel corresponds to these two. Each holds
a serial scan, which written as plain PyTorch is a Python loop of
thousands of steps, so each has a kernel of its own.

``zerocross_transitions`` (Z1): volts [B, T, S] f32 of B segments, the
eligible window [leads, seg_lens) of each, the list length cap, and the
variant (differentiated or plain) -> each track's transition list [B, T,
cap]: t, ok, dt, det, is_top, valid, and overflow [B] (a track found more
than cap).

``gcr_zeros_scan`` (Z2): Z1's lists, the P parmsets, samples per bit and
the bit buffer length -> the [B, P, T] state gcr.gcr_finish reads: bits
[B, P, T, maxb], datacount, peakcount, t_firstbit, t_lastbit, and the
fields -zeros leaves at their initial values (no AGC, no peak statistics).

On a CUDA tensor each launches its kernel and counts the launch
(``.launches``); on a CPU tensor it runs its plain version in
decode/gcr.py (``*_plain``, counted in ``.calls``). There is no fallback
between the two.
"""

from __future__ import annotations

import torch

from .. import kernels, telemetry
from . import common as cm
from . import gcr as gcr_mod
from .common import F32


def _check_volts(volts, seg_lens, leads, cap):
    if volts.dim() != 3 or volts.dtype != F32:
        raise ValueError("volts must be float32 [B, T, S]")
    B = volts.shape[0]
    if seg_lens.shape != (B,) or leads.shape != (B,):
        raise ValueError("seg_lens and leads must be [B]")
    if cap < 1:
        raise ValueError(f"cap {cap}")


@torch.inference_mode()
def zerocross_transitions_plain(volts, seg_lens, leads, *, cap: int,
                                differentiated: bool):
    """The plain PyTorch version of Z1 (same arguments and outputs)."""
    zerocross_transitions_plain.calls += 1
    _check_volts(volts, seg_lens, leads, cap)
    return gcr_mod.zerocross_transitions(volts, cap, differentiated,
                                         seg_lens, leads)


zerocross_transitions_plain.calls = 0


def zerocross_transitions(volts, seg_lens, leads, *, cap: int,
                          differentiated: bool):
    """Z1: the zero-crossing transition lists of B segments."""
    kw = dict(cap=int(cap), differentiated=bool(differentiated))
    dev = volts.device
    if dev.type == "cpu":
        return zerocross_transitions_plain(volts, seg_lens, leads, **kw)
    if dev.type != "cuda":
        raise ValueError(f"zerocross_transitions: no kernel for {dev}")
    _check_volts(volts, seg_lens, leads, kw["cap"])
    with telemetry.span("launch.zerocross_transitions"):
        telemetry.count("launches.zerocross_transitions")
        out = kernels.zerocross(volts, seg_lens, leads, **kw)
    zerocross_transitions.launches += 1
    out["overflow"] = (out.pop("n_found") > kw["cap"]).any(dim=-1)
    return out


zerocross_transitions.launches = 0


def _check_trans(trans, pa, maxb):
    shape = trans["t"].shape
    if len(shape) != 3:
        raise ValueError("transition lists must be [B, T, cap]")
    for k, dt in (("t", F32), ("dt", F32), ("ok", torch.bool),
                  ("valid", torch.bool)):
        if trans[k].shape != shape or trans[k].dtype != dt:
            raise ValueError(f"{k} must be {dt} {tuple(shape)}")
    if len(pa.z1pt) < 1 or maxb < 1:
        raise ValueError("no parmsets or maxb < 1")


@torch.inference_mode()
def gcr_zeros_scan_plain(trans, pa: cm.ParmArrays, *, spb: float,
                         maxb: int):
    """The plain PyTorch version of Z2 (same arguments and outputs)."""
    gcr_zeros_scan_plain.calls += 1
    _check_trans(trans, pa, maxb)
    return gcr_mod.gcr_zeros_track_scan(trans, pa, spb, maxb)


gcr_zeros_scan_plain.calls = 0


def gcr_zeros_scan(trans, pa: cm.ParmArrays, *, spb: float, maxb: int):
    """Z2: the GCR bit machine over Z1's lists, for every parmset."""
    kw = dict(spb=float(spb), maxb=int(maxb))
    dev = trans["t"].device
    if dev.type == "cpu":
        return gcr_zeros_scan_plain(trans, pa, **kw)
    if dev.type != "cuda":
        raise ValueError(f"gcr_zeros_scan: no kernel for {dev}")
    _check_trans(trans, pa, kw["maxb"])
    with telemetry.span("launch.gcr_zeros_scan"):
        telemetry.count("launches.gcr_zeros_scan")
        out = kernels.gcr_zeros(trans, pa, **kw)
    gcr_zeros_scan.launches += 1
    out.update(gcr_mod.zeros_fixed_fields(out["datacount"].shape, dev))
    return out


gcr_zeros_scan.launches = 0
