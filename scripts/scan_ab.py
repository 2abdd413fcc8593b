#!/usr/bin/env python3
"""Time the NRZI admission kernels (B5a nrzi_track_scan, B5b
nrzi_track_scan_tracks) and the -correctdbg decode wall of one checkout
of the PyTorch port on the card, so that two trees can be compared in one
call on one card.

    python3 scripts/scan_ab.py [--root DIR] [--reps N]

--root is the checkout whose readtape_tpu_torch is imported (default:
this repository); its kernels build into DIR/build. The inputs are this
repository's chip_smoke.py tapes, synthesized from their seeds, and each
kernel's arguments are those of its launch inside the root's own
decode_tape, so both trees time the same shapes:

  b5a correctdbg  B5a, -correctdbg's first launch on the NRZI bench tape
                  (B=16, P=8, G=3, T=9, S=32768), made 11 times a decode
  b5a noisy       B5a, the noisy NRZI tape's 8-parmset retry (B=3, P=8)
  b5b main        B5b, the tiered NRZI bench decode's first launch (B=128)
  b5b adjskew     B5b, -adjskew's first launch (B=1), made 162 times

Each: the mean ms of N launches between two CUDA events after one warm-up
launch, and the longest chain (the most admissions of a lane). Wall: a
warm decode_tape of the NRZI bench tape under -correctdbg, host clock
around a synchronized decode (mean of 3). Prints the card's name and
power limit, then one JSON line. Needs a CUDA card; imports nothing of
JAX.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        sys.exit("scan_ab: needs a CUDA card")
    from readtape_tpu_torch import kernels
    from readtape_tpu_torch.decode import pipeline as tpl
    from readtape_tpu_torch.decode import scan
    from readtape_tpu_torch.formats import tbin as tb
    if not kernels.__file__.startswith(root + os.sep):
        sys.exit(f"scan_ab: imported {kernels.__file__}, not {root}'s")
    card = cs.card_line()
    out = {"root": root}

    def timed(tag, launcher, samples, opts, kernel_path="fused"):
        (feat, nxt, pa), kw = cs.first_call(kernels, launcher, samples,
                                            opts, kernel_path)
        fn = (scan.nrzi_track_scan if launcher == "nrzi_scan"
              else scan.nrzi_track_scan_tracks)
        got = fn(feat, nxt, pa, **kw)
        out[tag] = cs.time_launches(lambda: fn(feat, nxt, pa, **kw),
                                    args.reps)
        out[tag + " chain"] = int(got["n_admitted"].max())
        out[tag + " shape"] = [len(kw["Ws"])] + list(feat.shape[:4])

    _, hdr, samples = cs.bench_tape()
    base = cs.tape_options(hdr, tb.MODE_NRZI, 800)
    dbg = cs.tape_options(hdr, tb.MODE_NRZI, 800, **cs.DEBUG_CORRECT)
    timed("b5a correctdbg", "nrzi_scan", samples, dbg)
    timed("b5b main", "nrzi_scan_tracks", samples, base, "tiered")
    timed("b5b adjskew", "nrzi_scan_tracks", samples,
          cs.tape_options(hdr, tb.MODE_NRZI, 800, adjskew=True))
    tpl.decode_tape(samples, dbg, device="cuda")             # warm-up
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tpl.decode_tape(samples, dbg, device="cuda")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    out["correctdbg wall s"] = sum(walls) / len(walls)
    out["correctdbg walls s"] = walls
    hdr, samples = cs.nrzi_noisy_tape()
    timed("b5a noisy", "nrzi_scan", samples,
          cs.tape_options(hdr, tb.MODE_NRZI, 800), "tiered")
    print(card, flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
