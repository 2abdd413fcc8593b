"""CSV waveform tapes (Saleae logic-analyzer export) -- the port's copy of
readtape_tpu/formats/csvfmt.py.

Layout (readtape.c:1608-1632): two title lines, then rows of
"time, v_track0, v_track1, ...". The track count is the comma count of the
second title line; the sample interval is the mean spacing of the first
10,000 timestamps (Saleae rounds timestamps to 0.1 us).

``read_csv`` parses with the native scanner (native/readtape_io.cpp
``csv_scan``, built by ``readtape_tpu_torch.native``) where it is built,
as the JAX ``read_csv`` does. Without it, a numpy reader reads every
field the scanner's way -- integer digits folded as n = n * 10 + d,
fraction digits added as d / div with div growing by * 10, an exponent
as a power of ten built by repeated * 10, all in float64 -- and the
voltages are then rounded to float32, so both give the same values. That
reading can differ from a correctly rounded decimal parse in the last
bit of a float64, so the numpy reader does not use numpy's own parser.
"""

from __future__ import annotations

import numpy as np

from .. import native


def _scan_fields(tok: np.ndarray) -> np.ndarray:
    """float64 value of each token of tok [N, L] uint8 (0-padded), read as
    the native scanner's parse_double reads it: a sign, integer digits,
    a fraction, an exponent; the first other byte ends the number."""
    n_tok, L = tok.shape
    val = np.zeros(n_tok)
    div = np.full(n_tok, 10.0)
    ex = np.zeros(n_tok, np.int64)
    neg = np.zeros(n_tok, bool)
    eneg = np.zeros(n_tok, bool)
    # 0 sign, 1 integer digits, 2 fraction digits, 3 exponent sign,
    # 4 exponent digits, 5 done
    state = np.zeros(n_tok, np.int8)
    for j in range(L):
        c = tok[:, j]
        minus, plus = c == ord("-"), c == ord("+")
        digit = (c >= ord("0")) & (c <= ord("9"))
        d = c.astype(np.int64) - ord("0")
        sign0 = (state == 0) & (minus | plus)
        neg |= (state == 0) & minus
        st = np.where((state == 0) & ~sign0, 1, state)
        intd = (st == 1) & digit
        val = np.where(intd, val * 10 + d, val)
        dot = (st == 1) & (c == ord("."))
        frd = (st == 2) & digit
        val = np.where(frd, val + d / div, val)
        div = np.where(frd, div * 10, div)
        e = ((st == 1) | (st == 2)) & ((c == ord("e")) | (c == ord("E")))
        esign = (st == 3) & (minus | plus)
        eneg |= (st == 3) & minus
        expd = ((st == 3) | (st == 4)) & digit
        ex = np.where(expd, ex * 10 + d, ex)
        state = np.select([sign0 | intd, dot | frd, e, esign | expd],
                          [1, 2, 3, 4], 5).astype(np.int8)
    f = np.ones(n_tok)
    for _ in range(int(ex.max()) if n_tok else 0):
        f = np.where(ex > 0, f * 10, f)
        ex = ex - 1
    val = np.where(eneg, val / f, val * f)
    return np.where(neg, -val, val)


def read_csv(path: str):
    """Returns (first_time_seconds, sample_deltat_seconds, volts [N,
    ntrks] float32): the native scanner's, else read_csv_numpy's."""
    try:
        return native.csv_scan_native(path)
    except RuntimeError:
        return read_csv_numpy(path)


def read_csv_numpy(path: str):
    """read_csv in numpy alone, with the native scanner's digits."""
    with open(path, "rb") as f:
        f.readline()                       # title line 1
        ntrks = f.readline().count(b",")   # title line 2: commas => tracks
        body = f.read()
    if not 0 < ntrks <= 19:
        raise ValueError(f"{path}: {ntrks} voltage columns")
    lines = body.split(b"\n")
    if lines and lines[-1] == b"":
        lines.pop()
    ncol = ntrks + 1
    tokens = []
    for ln in lines:
        fields = ln.replace(b",", b" ").split()
        if len(fields) < ncol:
            raise ValueError(f"{path}: a row with {len(fields)} fields, "
                             f"{ncol} expected")
        tokens += fields[:ncol]
    width = max(len(t) for t in tokens) if tokens else 1
    tok = np.frombuffer(b"".join(t.ljust(width, b"\0") for t in tokens),
                        np.uint8).reshape(-1, width)
    rows = _scan_fields(tok).reshape(-1, ncol)
    times = rows[:, 0]
    n = min(10000, len(times))
    first_time = float(times[0]) if len(times) else 0.0
    deltat = float((times[n - 1] - times[0]) / (n - 1)) if n > 1 else 0.0
    return first_time, deltat, rows[:, 1:].astype(np.float32)


def write_csv(path: str, first_time: float, deltat: float,
              volts: np.ndarray) -> None:
    """Write the two-title-line CSV format the reference reads."""
    n, ntrks = volts.shape
    times = first_time + deltat * np.arange(n, dtype=np.float64)
    with open(path, "w") as f:
        f.write("generated by readtape_tpu\n")
        f.write("Time [s]" + "".join(f", Channel {i}" for i in range(ntrks))
                + "\n")
        out = np.empty((n, ntrks + 1), dtype=np.float64)
        out[:, 0] = times
        out[:, 1:] = volts
        np.savetxt(f, out, fmt="%.7f", delimiter=", ")
