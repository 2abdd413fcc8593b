"""Block segmentation: find interblock gaps over the whole sample tensor
(readtape_tpu/decode/segment.py: the host scan of int16 tapes, the device
scan of float tapes, and the gap search).

A sample is "active" if any track exceeds a noise-floor threshold; quiet
runs longer than a mode-dependent gap threshold split the tape, and each
segment extends by margins so no samples are lost. Segments then decode
independently. The JAX package's 12-bit granule packing exists only for
its relay-attached TPU link; this port uploads the int16 tape once.
"""

from __future__ import annotations

import numpy as np
import torch

from .common import fma

CHUNK = 16          # gap-resolution granularity in samples: fine enough
                    # to resolve PE's 2.5-bit idle horizon (~50 samples at
                    # 20 samples/bit), which is where the reference ends a
                    # PE block (decoder.c:868-877)


def host_activity(samples_i16: np.ndarray, maxvolts: float):
    """Height estimate (twice the 0.999-quantile of |v| on a subsample --
    thresholds/floors only, never decode values) and the per-CHUNK
    activity mask at the segmentation threshold derived from it. The
    compare is exact: |int16| -> f32 * scale is lossless and monotone, so
    comparing the per-chunk int max is the same as comparing every sample.
    Frozen here with the NumPy sweep only (the port runs its native
    scanner, whose output is the same)."""
    n, t = samples_i16.shape
    scale = np.float32(maxvolts / 32767.0)
    step = max(1, (n * t) // 2_000_000)
    scanned = None
    if scanned is not None:
        chunk_max, sub_abs = scanned
        sub = sub_abs.astype(np.float32) * scale
    else:
        # int32 abs: np.abs wraps at int16 -32768
        sub = np.abs(samples_i16[::step].astype(np.float32)) * scale
        nc = n // CHUNK
        chunk_max = (np.abs(samples_i16[: nc * CHUNK].astype(np.int32))
                     .max(axis=1).reshape(nc, CHUNK).max(axis=1))
    amp = np.quantile(sub, 0.999)
    h_est = float(max(2.0 * amp, 0.05))
    thresh = np.float32(max(0.04, 0.15 * h_est / 2))
    act = (chunk_max.astype(np.float32) * scale) > thresh
    return h_est, act


def device_activity(tape, maxvolts: float, step: int):
    """host_activity for a float tape resident on the device as [T, N]
    float32 (the JAX package's segment._activity_from_tape, as its
    TapeDecoder runs it on CSV volts): the height estimate and the
    per-CHUNK activity mask, in f32 as XLA computes them. The scale is
    f32 maxvolts times the f32 reciprocal of 32767 (XLA's form of
    maxvolts / 32767); the 0.999-quantile is jnp.quantile's: the sorted
    subsample read at floor and ceil of f32(0.999) * (n - 1), blended
    as fma(low, 1 - w, high * w) (XLA's CPU contraction). Returns (h_est,
    host bool mask)."""
    scale = float(np.float32(maxvolts) * (np.float32(1) / np.float32(32767)))
    sub = (tape[:, ::step].abs() * scale).reshape(-1)
    srt = torch.sort(sub).values
    q = np.float32(0.999) * np.float32(srt.numel() - 1)
    lo, hi = srt[int(np.floor(q))], srt[int(np.ceil(q))]
    w_hi = np.float32(q - np.floor(q))
    amp = np.float32(fma(lo, float(np.float32(1) - w_hi),
                         hi * float(w_hi)).cpu())
    h_est = np.maximum(np.float32(2) * amp, np.float32(0.05))
    thresh = max(np.float32(0.04), np.float32(np.float32(0.15) * h_est)
                 / np.float32(2))
    n = tape.shape[1] // CHUNK
    vmax = tape[:, :n * CHUNK].abs().amax(dim=0) * scale
    act = (vmax.view(n, CHUNK) > float(thresh)).any(dim=1)
    return float(h_est), act.cpu().numpy()


def find_segments(active: np.ndarray, min_gap_chunks: int, total_samples: int,
                  pre_margin: int = 0, post_margin: int = 0,
                  blank: int = 0):
    """active: host bool array per CHUNK. Returns a list of (start, end)
    sample ranges covering each active region plus margins. The post
    margin reproduces the reference's end-of-block point (its per-mode
    idle detection fires a few bit-times after the last transition,
    decoder.c:868-894). `blank` reproduces the reference's interblock
    blanking: a following segment never starts earlier than the previous
    active region's end plus `blank` (decoder.c:841,901)."""
    n = len(active)
    if n == 0 or not active.any():
        return []
    idx = np.nonzero(active)[0]
    gaps = np.nonzero(np.diff(idx) - 1 >= min_gap_chunks)[0]
    run_starts = np.concatenate([[idx[0]], idx[gaps + 1]])
    run_ends = np.concatenate([idx[gaps], [idx[-1]]])       # inclusive chunks
    segs = []
    prev_end = 0          # the reference starts scanning at sample 0
    prev_active_end = None
    for s, e in zip(run_starts, run_ends):
        a = max(0, s * CHUNK - pre_margin)
        a = max(a, prev_end if segs else 0)
        if blank and prev_active_end is not None:
            a = max(a, prev_active_end + blank)
        b = min(total_samples, (e + 1) * CHUNK + post_margin)
        if b - a > 4:
            segs.append((int(a), int(b)))
            prev_end = int(b)
        prev_active_end = (e + 1) * CHUNK
    return segs


def bucket_length(n: int, minimum: int = 4096) -> int:
    """Round a length up to a power of two (bounded recompiles)."""
    b = minimum
    while b < n:
        b *= 2
    return b
