"""Peaks of one NVIDIA H100 and the work of each kernel, counted from
its launch's logical shapes, never from the tensors an implementation
allocates: the count stays the same whatever implements the kernel.

Bytes: each window sample read once at its width (float32 volts [B, T,
S]), the segment lengths and leads, and each output the finish reads
written once at its width. Operations: the window features, 10 float32
operations per (segment, track, sample) and distinct window width (G),
a lower count of what a scan must do. The share is the least time the
card could take, the larger of bytes over the bandwidth and operations
over the float32 rate, over the kernel's device time by name.
"""

from __future__ import annotations

# NVIDIA's data sheet, H100 SXM, at the 700 W power limit
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12


def _nrzi_fused(c):
    B, T, S = c["shape"]
    P, G = len(c["Ws"]), len(set(c["Ws"]))
    maxb = c["maxb"]
    out = B * P * T * (maxb + 4 * (50 + 5 + 4)) + B * P * 6 * 4
    return B * T * S * 4 + B * 8 + out, 10.0 * B * T * S * G


def _pe_fused(c):
    B, T, S = c["shape"]
    P, G = len(c["Ws"]), len(set(c["Ws"]))
    maxb = c["maxb"]
    out = B * P * T * (2 * maxb + 4 * (50 + 6 + 4)) + B * P * 4 * 4
    return B * T * S * 4 + B * 8 + out, 10.0 * B * T * S * G


# kernel: (the name its device code carries in the trace, work of a call)
KERNELS = {
    "nrzi_fused_scan": ("nrzi_fused_kernel", _nrzi_fused),
    "pe_fused_scan": ("pe_fused_kernel", _pe_fused),
}


def bound_seconds(kernel: str, calls) -> float:
    work = KERNELS[kernel][1]
    total = 0.0
    for c in calls:
        nbytes, flops = work(c)
        total += max(nbytes / PEAK_BYTES_S, flops / PEAK_F32_FLOPS)
    return total


def share_pct(trace, kernel: str):
    """The kernel's share of its roofline in %, or None where the traced
    stretch ran none of it."""
    calls = trace.launches.get(kernel, [])
    seconds = trace.kernel_seconds(KERNELS[kernel][0])
    if not calls or seconds <= 0:
        return None
    return 100.0 * bound_seconds(kernel, calls) / seconds
