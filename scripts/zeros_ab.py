#!/usr/bin/env python3
"""Time the -zeros kernels (Z1 zerocross_transitions, Z2 gcr_zeros_scan)
and the -zeros decode walls of one checkout of the PyTorch port on the
card, so that two trees can be compared in one call on one card.

    python3 scripts/zeros_ab.py [--root DIR] [--reps N]

--root is the checkout whose readtape_tpu_torch is imported (default:
this repository); its kernels build into DIR/build. The inputs are this
repository's chip_smoke.py tapes, synthesized from their seeds, and each
kernel's arguments are those of its launch inside the root's own
decode_tape, so both trees time the same shapes:

  z1 b40    Z1, the GCR -zeros bench's first launch (B=40, T=9, S=32768)
  z1 b1     Z1, the NRZI -zeros chain's first window (B=1), the launch the
            bench's chain makes 1,096 times
  z1 diff   Z1 differentiated, the example3-recipe bench's first launch
  z2        Z2, the GCR -zeros bench's first retry (B=16, P=5)

Each: the mean ms of N launches between two CUDA events after one warm-up
launch. Walls: a warm decode_tape of the GCR bench with -zeros and of the
NRZI bench with -zeros (the sequential chain), host clock around a
synchronized decode. Prints the card's name and power limit, then one JSON
line. Needs a CUDA card; imports nothing of JAX.
"""

import argparse
import dataclasses
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
        sys.exit("zeros_ab: needs a CUDA card")
    from readtape_tpu_torch import kernels
    from readtape_tpu_torch.decode import pipeline as tpl
    from readtape_tpu_torch.decode import zeros
    from readtape_tpu_torch.formats import tbin as tb
    if not kernels.__file__.startswith(root + os.sep):
        sys.exit(f"zeros_ab: imported {kernels.__file__}, not {root}'s")
    card = cs.card_line()
    out = {"root": root}

    def z1(tag, samples, opts):
        (v, lens, leads), kw = cs.first_call(kernels, "zerocross", samples,
                                             opts)
        out[tag] = cs.time_launches(lambda: zeros.zerocross_transitions(
            v, lens, leads, **kw), args.reps)
        out[tag + " shape"] = list(v.shape)

    def wall(tag, samples, opts):
        tpl.decode_tape(samples, opts, device="cuda")        # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tpl.decode_tape(samples, opts, device="cuda")
        torch.cuda.synchronize()
        out[tag] = time.perf_counter() - t0

    _, hdr, samples = cs.gcr_bench_tape()
    gopts = cs.tape_options(hdr, tb.MODE_GCR, 9042, 25, find_zeros=True)
    z1("z1 b40", samples, gopts)
    (trans, pa), kw = cs.first_call(kernels, "gcr_zeros", samples, gopts,
                                    index=1)
    out["z2"] = cs.time_launches(
        lambda: zeros.gcr_zeros_scan(trans, pa, **kw), args.reps)
    out["z2 shape"] = list(trans["t"].shape) + [len(pa.z1pt)]
    del trans
    wall("gcr zeros wall s", samples, gopts)
    _, hdr, volts = cs.gcr_diff_bench_tape()
    z1("z1 diff", volts, cs.tape_options(
        hdr, tb.MODE_GCR, 9042, 25, maxvolts=32767.0, differentiate=True,
        find_zeros=True))
    _, hdr, samples = cs.bench_tape(nblocks=2)
    z1("z1 b1", samples, dataclasses.replace(
        cs.tape_options(hdr, tb.MODE_NRZI, 800), find_zeros=True))
    _, hdr, samples = cs.bench_tape()
    wall("nrzi zeros wall s", samples, dataclasses.replace(
        cs.tape_options(hdr, tb.MODE_NRZI, 800), find_zeros=True))
    print(card, flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
