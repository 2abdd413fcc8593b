"""Debug trace spreadsheet (<base>.trace.csv) -- the port's own copy of
readtape_tpu/out/trace.py.

The reference's trace.c (DEBUG builds only) writes a time-series CSV of
all track voltages plus 11 event lanes for plotting in a spreadsheet
(trace.c:46-92, decoder.h:63-65), using a ring buffer so events
discovered late land at their true timestamps. Here the decode pipeline
already produces every event with its true (refined) time, so the trace
is a join of the waveform against the event streams -- and it's a
*runtime* option (-trace start[,end]), not a compile-time one.

Lane set (the reference's tracevals table, filtered by mode):

  peak    all modes, per track   tick at each admitted flux transition
  data    all modes, per track   persistent level of the last decoded bit
  avgpos  NRZI, one lane         tick at each adjusted clock position
  zerpos  GCR, per track         tick at each inferred zero bit
  adjpos  GCR, per track         tick at pulse-adjusted positions
  zerchk  NRZI, one lane         tick at each zerocheck boundary
  parerr  NRZI, one lane         tick at columns with vertical parity error
  clkedg  PE, per track          tick at clock edges
  datedg  PE, per track          tick at data edges
  clkwin  PE, per track          persistent: clock window open
  clkdet  PE, per track          persistent: track active (not idle)

Events are (time_seconds, value) pairs; "tick" lanes draw UPTICK for
value > 0 else DNTICK at the event row only, "persistent" lanes hold the
last value. Like the reference, the output is capped at 10,000 lines.
"""

from __future__ import annotations

import numpy as np

UPTICK = 0.75
DNTICK = -0.75
MAX_LINES = 10000    # the reference's cap on sample lines

# (name, modes, per_track, persistent) -- the reference's tracevals order
LANES = [
    ("peak",   ("nrzi", "pe", "gcr", "ww"), True,  False),
    ("data",   ("nrzi", "pe", "gcr", "ww"), True,  True),
    ("avgpos", ("nrzi",),                   False, False),
    ("zerpos", ("gcr",),                    True,  False),
    ("adjpos", ("gcr",),                    True,  False),
    ("zerchk", ("nrzi",),                   False, False),
    ("parerr", ("nrzi",),                   False, False),
    ("clkedg", ("pe",),                     True,  False),
    ("datedg", ("pe",),                     True,  False),
    ("clkwin", ("pe",),                     True,  True),
    ("clkdet", ("pe",),                     True,  True),
]


def write_trace(path: str, t0: float, deltat: float, volts: np.ndarray,
                mode: str, lanes: dict) -> int:
    """volts: [N, T], sample 0 at time t0. lanes: {name: events} where
    events is a list of (time_s, value) for single lanes or a list per
    track for per-track lanes. Writes the first MAX_LINES samples and
    returns the number of sample lines written."""
    n, T = volts.shape
    nl = min(n, MAX_LINES)

    active = [(nm, per_trk, persist) for nm, modes, per_trk, persist
              in LANES if mode in modes]

    def bucketize(events):
        out = {}
        for (t, val) in events:
            idx = int(round((t - t0) / deltat))
            if 0 <= idx < nl:
                out[idx] = val
        return out

    cols = []           # (header, events-dict, persistent)
    for nm, per_trk, persist in active:
        ev = lanes.get(nm, [()] * T if per_trk else ())
        if per_trk:
            for trk in range(T):
                cols.append((f"{nm}{trk}", bucketize(ev[trk]), persist))
        else:
            cols.append((nm, bucketize(ev), persist))

    with open(path, "w") as f:
        f.write("time")
        for trk in range(T):
            f.write(f",v{trk}")
        for hdr, _, _ in cols:
            f.write(f",{hdr}")
        f.write("\n")
        level = [0.0] * len(cols)
        for i in range(nl):
            f.write(f"{t0 + i * deltat:.8f}")
            for trk in range(T):
                f.write(f",{volts[i, trk]:.4f}")
            for c, (hdr, ev, persist) in enumerate(cols):
                val = ev.get(i)
                if persist:
                    if val is not None:
                        level[c] = UPTICK if val else DNTICK
                    f.write(",%0.2f" % level[c])
                else:
                    f.write(",%0.2f" % ((UPTICK if val else DNTICK)
                                        if val is not None else 0.0))
            f.write("\n")
    return nl
