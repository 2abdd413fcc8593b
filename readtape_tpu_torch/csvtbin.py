"""csvtbin: convert between CSV logic-analyzer captures and .tbin files.

Mirrors the reference utility (csvtbin.c) feature-for-feature: CSV -> TBIN
with track reorder to canonical (msb..lsb,P), skip/subsample/stopaft/
start-end time trim, -scale= voltage scaling, invert, -graph= excursion
extraction, automatic maxvolts estimation (csv_preread, csvtbin.c:618-658)
with the -redo out-of-range rescale pass (csvtbin.c:726-744); and
-read / -showheader TBIN -> CSV regeneration (csvtbin.c:523-596) with
float -stagger= offsets for graphing.

  csvtbin <options> infile [outfile]
    -ntrks=n -order=s -mode={pe|nrzi|gcr|ww} -bpi=n -ips=n
    -invert -reverse -maxvolts=v -scale=f -descr=s
    -skip=n -subsample=n -stopaft=n -start=secs -end=secs
    -graph=n -redo -read -showheader -stagger[=volts]
"""

# The port's copy of readtape_tpu/csvtbin.py (its usage text is this
# docstring, kept the same), on the port's formats and native scanner:
# host code in numpy, no work on the card, no import of torch or of the
# JAX package.

from __future__ import annotations

import os
import sys

import numpy as np

from . import native
from .formats import tbin as tb
from .formats.csvfmt import read_csv

MODES = {"pe": tb.MODE_PE, "nrzi": tb.MODE_NRZI, "gcr": tb.MODE_GCR,
         "ww": tb.MODE_WW, "whirlwind": tb.MODE_WW}
MODE_NAME = {tb.MODE_PE: "PE", tb.MODE_NRZI: "NRZI", tb.MODE_GCR: "GCR",
             tb.MODE_WW: "WW", tb.MODE_UNKNOWN: "not specified"}

USAGE = __doc__


def parse_order(order: str, nheads: int):
    if any(c in "CLMclmx" for c in order) and not order.isdigit():
        return None          # Whirlwind orders are kept in the header
    head_to_trk = []
    for ch in order:
        head_to_trk.append(len(order) - 1 if ch.upper() == "P" else int(ch))
    if sorted(head_to_trk) != list(range(len(order))):
        raise SystemExit(f"bad -order: {order}")
    return head_to_trk


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    opts = dict(ntrks=0, order=None, mode=tb.MODE_UNKNOWN, bpi=0.0, ips=0.0,
                invert=False, reverse=False, maxvolts=0.0, descr="",
                skip=0, subsample=1, stopaft=0, start=0.0, end=0.0,
                stagger=0.0, scale=1.0, graph=0, redo=False,
                read=False, showheader=False)
    files = []
    for arg in argv:
        if arg.startswith("-"):
            a = arg[1:]
            low = a.lower()
            if low.startswith("ntrks="):
                opts["ntrks"] = int(a[6:])
            elif low.startswith("order="):
                opts["order"] = a[6:]
            elif low.startswith("mode="):
                opts["mode"] = MODES[a[5:].lower()]
            elif low in MODES:
                opts["mode"] = MODES[low]
            elif low.startswith("bpi="):
                opts["bpi"] = float(a[4:])
            elif low.startswith("ips="):
                opts["ips"] = float(a[4:])
            elif low == "invert":
                opts["invert"] = True
            elif low == "reverse":
                opts["reverse"] = True
            elif low.startswith("maxvolts="):
                opts["maxvolts"] = float(a[9:])
            elif low.startswith("scale="):
                opts["scale"] = float(a[6:])
            elif low.startswith("descr="):
                opts["descr"] = a[6:]
            elif low.startswith("skip="):
                opts["skip"] = int(a[5:])
            elif low.startswith("subsample="):
                opts["subsample"] = int(a[10:])
            elif low.startswith("stopaft="):
                opts["stopaft"] = int(a[8:])
            elif low.startswith("start="):
                opts["start"] = float(a[6:])
            elif low.startswith("starttime="):
                opts["start"] = float(a[10:])
            elif low.startswith("end="):
                opts["end"] = float(a[4:])
            elif low.startswith("endtime="):
                opts["end"] = float(a[8:])
            elif low.startswith("graph="):
                opts["graph"] = int(a[6:])
            elif low == "redo":
                opts["redo"] = True
            elif low == "read":
                opts["read"] = True
            elif low == "showheader":
                opts["read"] = opts["showheader"] = True
            elif low.startswith("stagger="):
                opts["stagger"] = float(a[8:])
            elif low == "stagger":
                opts["stagger"] = -1.0          # maxvolts/2 at output time
            else:
                raise SystemExit(f"bad option: {arg}\n{USAGE}")
        else:
            files.append(arg)
    if len(files) == 1:
        # the reference's interface: one <basefilename> (csvtbin.c V1.7);
        # -read converts base.tbin -> base.csv, else base.csv -> base.tbin
        base = files[0]
        for ext in (".csv", ".tbin"):
            if base.lower().endswith(ext):
                base = base[:-len(ext)]
        if opts["showheader"]:
            return show_header(base + ".tbin")
        if opts["read"]:
            return tbin_to_csv(base + ".tbin", base + ".csv", opts)
        return csv_to_tbin(base + ".csv", base + ".tbin", opts)
    if len(files) != 2:
        print(USAGE, file=sys.stderr)
        return 4
    src, dst = files
    if opts["read"] or src.lower().endswith(".tbin"):
        if opts["showheader"]:
            return show_header(src)
        return tbin_to_csv(src, dst, opts)
    return csv_to_tbin(src, dst, opts)


def show_header(src) -> int:
    """-showheader: display the TBIN header like read_tbin's log
    (csvtbin.c:524-551) without regenerating any CSV."""
    hdr, samples = tb.read_tbin(src)
    print(f"file format 1, ntrks {hdr.ntrks}, encoding "
          f"{MODE_NAME.get(hdr.mode, '?')}, max {hdr.maxvolts:.2f}V, "
          f"bpi {hdr.bpi:.2f}, ips {hdr.ips:.2f}, sample delta "
          f"{hdr.tdelta_ns/1e3:.2f} usec")
    print("the track ordering was%s given when the .tbin file was created"
          % ("" if not (hdr.flags & tb.TBIN_NO_REORDER) else " not"))
    print(f"description: {hdr.descr}")
    if hdr.flags & tb.TBIN_INVERTED:
        print("the data was inverted")
    if hdr.flags & tb.TBIN_REVERSED:
        print("the tape might have been read or written backwards")
    if hdr.trkorder:
        print(f"the Whirlwind tracks were specified as -order={hdr.trkorder}")
    print(f"16 bits/sample, data start time is {hdr.tstart_ns/1e9:.6f} "
          f"seconds")
    print(f"{samples.shape[0]:,} samples")
    return 0


def _estimate_maxvolts(volts: np.ndarray) -> float:
    """csv_preread's estimate (csvtbin.c:644): observed max |v| over the
    first 1M samples, + 0.55 V, truncated to 0.1 V — in the C's exact
    float32 arithmetic."""
    pre = volts[:1_000_000]
    m = np.float32(np.abs(pre.astype(np.float32)).max()) if pre.size \
        else np.float32(0.0)
    return float(np.float32(np.trunc((m + np.float32(0.55)) *
                                     np.float32(10.0))) / np.float32(10.0))


def _read_csv_scanfast(path):
    """CSV parse that replicates the reference's scanfast_float float32
    digit accumulation bit-exactly (csvtbin.c:403-417): native scanner if
    available, else a (slow) pure-python replica. The two differ where the
    JAX tool's do: the native parser takes a leading "-" only (a field
    that starts with "+" reads as 0, and so do the row's later fields),
    the replica strips a "+" too."""
    try:
        return native.csv_scan_native(path, scanfast=True)
    except RuntimeError:
        pass

    def parse_tok(tok):
        tok = tok.strip()
        neg = tok.startswith("-")
        if neg or tok.startswith("+"):
            tok = tok[1:]
        ip, _, fp = tok.partition(".")
        n = np.float32(0.0)
        ten = np.float32(10.0)
        for ch in ip:
            n = n * ten + np.float32(ord(ch) - 48)
        div = ten
        for ch in fp:
            n = n + np.float32(ord(ch) - 48) / div
            div = div * ten
        return -n if neg else n

    with open(path) as f:
        f.readline()
        second = f.readline()
        ntrks = second.count(",")
        rows, times = [], []
        for line in f:
            parts = line.split(",")
            if len(parts) < ntrks + 1:
                continue
            times.append(float(parts[0]))
            rows.append([parse_tok(x) for x in parts[1:ntrks + 1]])
    volts = np.asarray(rows, np.float32)
    n = min(10000, len(times))
    deltat = (times[n - 1] - times[0]) / (n - 1) if n > 1 else 0.0
    return times[0] if times else 0.0, deltat, volts


def csv_to_tbin(src, dst, o) -> int:
    t0, deltat, volts = _read_csv_scanfast(src)
    volts = (volts.astype(np.float32) * np.float32(o["scale"]))
    # maxvolts estimate from the raw (pre-trim) capture, like csv_preread
    est = _estimate_maxvolts(volts)
    if o["subsample"] > 1:
        # first emitted sample is line subsample-1; tstart moves with it
        # (csvtbin.c:647-651)
        volts = volts[o["subsample"] - 1::o["subsample"]]
        t0 += (o["subsample"] - 1) * deltat
        deltat *= o["subsample"]
    if o["skip"]:
        # the reference's header tstart does NOT advance for -skip or
        # -start (write_tbin_hdr runs before the skip loop,
        # csvtbin.c:661-682)
        volts = volts[o["skip"]:]
    if o["start"] or o["end"]:
        n = volts.shape[0]
        i0 = int(np.ceil(max(0.0, o["start"] - t0) / deltat)) \
            if o["start"] else 0
        i1 = int((o["end"] - t0) / deltat) + 1 if o["end"] else n
        volts = volts[i0:min(max(i1, i0), n)]
    if o["stopaft"]:
        volts = volts[:o["stopaft"]]
    if o["invert"]:
        volts = -volts

    order = parse_order(o["order"], volts.shape[1]) if o["order"] else None
    flags = tb.TBIN_NO_REORDER
    trkorder = ""
    if order is not None:
        cols = np.zeros(len(order), np.int64)
        for head, trkn in enumerate(order):
            cols[trkn] = head
        volts = volts[:, cols]
        flags = 0                       # tracks were reordered to canonical
    elif o["order"]:
        trkorder = o["order"]           # complex (WW) order kept in header

    maxvolts = o["maxvolts"] or est
    if o["maxvolts"] and est > o["maxvolts"]:
        print(f"maxvolts was increased from {o['maxvolts']:.1f} to {est:.1f}")
        maxvolts = est

    if o["graph"]:
        # -graph=n: max |excursion| of every n-sample bin (csvtbin.c:376,
        # 707-723), written as "samplenum, volts" CSV rows
        n = volts.shape[0]
        nb = n // o["graph"]
        if nb:
            bins = np.abs(volts[:nb * o["graph"]]).reshape(
                nb, o["graph"], volts.shape[1]).max(axis=(1, 2))
            gname = dst + ".graph.csv"
            with open(gname, "w") as gf:
                for k in range(nb):
                    gf.write(f"{(k + 1) * o['graph']}, {bins[k]:f}\n")
            print(f"wrote {gname}: {nb} excursion bins")

    # the conversion arithmetic is the C's exact float32 sequence
    # (csvtbin.c:695-713): fsample / maxvolts * 32767 + (+-0.5), truncated
    vf = volts.astype(np.float32)
    for tries in range(2):
        scaled = (vf / np.float32(maxvolts)) * np.float32(32767.0)
        rounded = scaled + np.where(vf < 0, np.float32(-0.5),
                                    np.float32(0.5))
        samples = np.trunc(rounded).astype(np.int32)
        toosmall = int((samples <= -32767).sum())
        toobig = int((samples >= 32767).sum())
        samples = np.clip(samples, -32767, 32767).astype(np.int16)
        if toobig or toosmall:
            print(f"*** WARNING *** {toobig} samples were too big, "
                  f"{toosmall} too small")
            newmax = float(max(np.float32(vf.max()), -np.float32(vf.min())))
            if not o["redo"]:
                print(f"you should specify -maxvolts={newmax + 0.1:.1f}")
                break
            maxvolts = float(np.float32(int((newmax + 0.15) * np.float32(10.0)))
                             / np.float32(10.0))
            print(f"redoing the conversion with -maxvolts={maxvolts:.1f}")
            continue
        break

    hdr = tb.TbinHeader(
        descr=o["descr"], flags=flags | (o["invert"] and tb.TBIN_INVERTED or 0)
        | (o["reverse"] and tb.TBIN_REVERSED or 0),
        ntrks=volts.shape[1], tdelta_ns=int(round(deltat * 1e9)),
        maxvolts=maxvolts, mode=o["mode"], bpi=o["bpi"], ips=o["ips"],
        trkorder=trkorder, tstart_ns=int(round(t0 * 1e9)))
    tb.write_tbin(dst, hdr, samples)
    print(f"wrote {dst}: {samples.shape[0]:,} samples x {samples.shape[1]} "
          f"tracks, maxvolts {maxvolts:.1f}, {hdr.tdelta_ns} ns/sample")
    return 0


def tbin_to_csv(src, dst, o) -> int:
    """-read: regenerate the CSV in the reference's exact format
    (csvtbin.c:552-596): description line, "Time, Track 0, ..." header,
    %12.8f timestamps and %9.5f voltages, optional -order permutation,
    header-flag-driven un-inversion, and per-track -stagger offsets."""
    hdr, samples = tb.read_tbin(src)
    samples = np.asarray(samples)
    if o["skip"] or o["start"]:
        tdelta = hdr.tdelta_ns
        i0 = o["skip"]
        if o["start"]:
            i0 = max(i0, int(np.ceil(
                (o["start"] * 1e9 - hdr.tstart_ns) / tdelta)))
        samples = samples[i0:]
        hdr.tstart_ns += i0 * tdelta
    if o["stopaft"]:
        samples = samples[:o["stopaft"]]
    if o["end"]:
        n_keep = int((o["end"] * 1e9 - hdr.tstart_ns) / hdr.tdelta_ns) + 1
        samples = samples[:max(n_keep, 0)]

    volts = samples.astype(np.float64) / 32767.0 * hdr.maxvolts
    if hdr.flags & tb.TBIN_INVERTED:
        volts = -volts                  # undo the stored inversion
    order = parse_order(o["order"], volts.shape[1]) if o["order"] else None
    if order is not None:
        volts = volts[:, order]
    stagger = o["stagger"]
    if stagger < 0:
        stagger = hdr.maxvolts / 2
    if stagger:
        volts = volts + np.arange(volts.shape[1])[None, :] * stagger

    n, ntrks = volts.shape
    times = (hdr.tstart_ns + hdr.tdelta_ns *
             np.arange(n, dtype=np.int64)) / 1e9
    with open(dst, "w") as f:
        f.write(f"'{hdr.descr}\n")
        f.write("Time, " + ", ".join(f"Track {i}" for i in range(ntrks)) +
                "\n")
        out = np.empty((n, ntrks + 1))
        out[:, 0] = times
        out[:, 1:] = volts
        fmt = "%12.8f, " + ", ".join(["%9.5f"] * ntrks) + ", "
        np.savetxt(f, out, fmt=fmt)
    print(f"wrote {dst}: {n:,} samples x {ntrks} tracks")
    return 0


if __name__ == "__main__":
    sys.exit(main())
