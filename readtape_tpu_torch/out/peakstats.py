"""Peak-timing statistics CSV (<base>.peakstats.csv).

Same layout as output_peakstats (decoder.c:175-214): first three columns are
the total count and the two extreme buckets, then per-bucket percentages,
plus (NRZI) the average position column for graphing in a spreadsheet.

The port's own copy of readtape_tpu/out/peakstats.py: the port
imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np


def write_peakstats(path: str, hist: np.ndarray, trksums: np.ndarray,
                    leftbin_s: float, binwidth_s: float,
                    is_nrzi: bool) -> int:
    """hist: [T, 50] bucket counts. Returns total interior count."""
    T, nb = hist.shape
    lb = leftbin_s * 1e6
    bw = binwidth_s * 1e6
    total = 0
    with open(path, "w") as f:
        f.write(f"total cnt, <={lb:.1f} uS, >={bw * (nb - 1) + lb:.1f} uS,"
                " track")
        for bkt in range(1, nb - 1):
            f.write(f",{bw * bkt + lb:.1f} uS")
        if is_nrzi:
            f.write(",avg uS")
        f.write("\n")
        # exact C arithmetic (output_peakstats, decoder.c:198-210):
        # percentages and the average divide by peak_trksums (in-range
        # buckets 0..49) in float32; each avgsum term truncates to int64;
        # bin centers form from the FLOAT32 binwidth/leftbin
        lb32 = np.float64(np.float32(leftbin_s)) * 1e6
        bw32 = np.float64(np.float32(binwidth_s)) * 1e6
        for trk in range(T):
            n = int(trksums[trk])
            f.write(f"{n + int(hist[trk, 0]) + int(hist[trk, -1])}, "
                    f"{int(hist[trk, 0])}, {int(hist[trk, -1])},trk{trk}")
            avgsum = 0
            for bkt in range(1, nb - 1):
                pct = (float(np.float32(100 * int(hist[trk, bkt]))
                             / np.float32(n)) if n else 0.0)
                f.write(f", {pct:.2f}%")
                avgsum += int(int(hist[trk, bkt]) * (bw32 * bkt + lb32))
            if is_nrzi:
                f.write(f", {float(np.float32(avgsum) / np.float32(n)) if n else 0:.2f}")
            f.write("\n")
            total += n
    return total
