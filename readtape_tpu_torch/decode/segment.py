"""Block segmentation: find interblock gaps over the whole sample tensor
(readtape_tpu/decode/segment.py: the scan of int16 tapes, the device scan
of float tapes, and the gap search).

A sample is "active" if any track exceeds a noise-floor threshold; quiet
runs longer than a mode-dependent gap threshold split the tape, and each
segment extends by margins so no samples are lost. Segments then decode
independently. The JAX package's 12-bit granule packing exists only for
its relay-attached TPU link; this port uploads the int16 tape once.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels, telemetry
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
    The heavy sweep runs in the native scanner when available."""
    from .. import native

    n, t = samples_i16.shape
    scale = np.float32(maxvolts / 32767.0)
    step = max(1, (n * t) // 2_000_000)
    scanned = native.tape_scan(samples_i16, step)
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


def _check_tape(tape, step):
    if tape.dim() != 2 or tape.dtype != torch.int16:
        raise ValueError("tape must be int16 [N, T]")
    if not tape.is_contiguous():
        raise ValueError("tape must be contiguous")
    if step < 1:
        raise ValueError(f"step {step}")


@torch.inference_mode()
def activity_scan_plain(tape, step: int):
    """The plain PyTorch version of activity_scan (same arguments and
    output)."""
    activity_scan_plain.calls += 1
    _check_tape(tape, step)
    n, t = tape.shape
    nc = n // CHUNK
    rows = tape[:nc * CHUNK].reshape(nc, CHUNK * t)
    # max |x| = max(max x, -min x), negated in int32: |-32768| = 32768
    chunk_max = torch.maximum(rows.amax(dim=1).to(torch.int32),
                              rows.amin(dim=1).to(torch.int32).neg())
    sub = tape[::step].to(torch.int32).abs().reshape(-1)
    hist = torch.bincount(sub, minlength=kernels.ACT_BINS)
    return torch.cat([chunk_max, hist.to(torch.int32)])


activity_scan_plain.calls = 0


def activity_scan(tape, step: int):
    """The int16 tape [N, T] (row order, as uploaded) -> int32 [N // CHUNK
    + 32769]: the max |x| of each CHUNK rows over every track, then the
    histogram of |x| over the rows r % step == 0 (the last, partial
    chunk's rows included): what native tape_scan computes, with its
    subsample kept as counts. On a CUDA tensor it launches csrc/
    activity.cu and counts the launch (``.launches``); on a CPU tensor it
    runs activity_scan_plain. There is no fallback between the two."""
    dev = tape.device
    if dev.type == "cpu":
        return activity_scan_plain(tape, step)
    if dev.type != "cuda":
        raise ValueError(f"activity_scan: no kernel for {dev}")
    _check_tape(tape, step)
    with telemetry.span("launch.activity_scan"):
        telemetry.count("launches.activity_scan")
        out = kernels.activity_scan(tape, step=int(step))
    activity_scan.launches += 1
    return out


activity_scan.launches = 0


def np_quantile(n: int, q: float, at):
    """np.quantile(a, q) (method "linear") of a float32 array a of n
    values, from at(k), the k-th smallest value of a as np.float32: the
    arithmetic of numpy/lib/_function_base_impl.py (quantile, _quantile,
    _get_indexes, _get_gamma, _lerp) on the two values it reads, with the
    same types in each operation, so that the result is numpy's bit for
    bit (tests/test_torch_activity.py holds it to np.quantile)."""
    # quantile(): a Python float q takes a float array's dtype
    virtual = np.asanyarray((n - 1) * np.asanyarray(q, dtype=np.float32))
    prev = np.asanyarray(np.floor(virtual))
    nxt = np.asanyarray(prev + 1)
    if virtual >= n - 1:                 # the largest value (index -1)
        prev[()] = nxt[()] = -1
    prev, nxt = prev.astype(np.intp), nxt.astype(np.intp)
    gamma = np.asanyarray(np.asanyarray(virtual - prev), dtype=virtual.dtype)
    a, b = at(int(prev) % n), at(int(nxt) % n)
    diff_b_a = np.subtract(b, a)
    lerp = np.asanyarray(np.add(a, diff_b_a * gamma))
    np.subtract(b, diff_b_a * (1 - gamma), out=lerp, where=gamma >= 0.5,
                casting="unsafe", dtype=type(lerp.dtype))
    return lerp[()]


def tape_activity(tape, maxvolts: float, step: int):
    """host_activity for the int16 tape [N, T] as a tensor (on the card:
    one activity_scan launch, then one copy to the host): the height
    estimate and the per-CHUNK activity mask, equal to host_activity's bit
    for bit when step is its subsample step. The 0.999-quantile's two
    order statistics come from the histogram's cumulative counts, and
    np_quantile repeats numpy's arithmetic on them; the rest is
    host_activity's own expressions."""
    n = tape.shape[0]
    out = activity_scan(tape, step)
    telemetry.count("activity.card" if tape.device.type == "cuda"
                    else "activity.plain")
    with telemetry.wait("activity", 1):
        out = out.cpu().numpy()
    chunk_max, cum = out[:n // CHUNK], np.cumsum(out[n // CHUNK:])
    scale = np.float32(maxvolts / 32767.0)
    amp = np_quantile(int(cum[-1]), 0.999, lambda k: np.float32(
        np.searchsorted(cum, k, side="right")) * scale)
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
