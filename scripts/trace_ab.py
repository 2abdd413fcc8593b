#!/usr/bin/env python3
"""Time the kernels that -trace gave a record mode (B2 pe_fused_scan, B3
gcr_fused_scan, B4 ww_fused_scan, B6 nrzi_slot_scan) with the mode off,
at their main-path launches, for one checkout of the PyTorch port on the
card, so that two trees can be compared in one call on one card.

    python3 scripts/trace_ab.py [--root DIR] [--reps N]

--root is the checkout whose readtape_tpu_torch is imported (default:
this repository); its kernels build into DIR/build. The inputs are this
repository's chip_smoke.py bench tapes, synthesized from their seeds,
and each kernel's arguments are those of its launch inside the root's
own decode_tape:

  b2 main   the PE bench decode's first launch (B=60, P=1, S=32768)
  b3 main   the GCR bench decode's launch (B=40, P=1, S=32768)
  b4 main   the Whirlwind bench decode's call (T=6, S=2,621,440; N // 5
            launches, at least 3)
  b6 main   the tiered NRZI bench decode's first slot launch (B=128)

Each: the mean ms of N launches between two CUDA events after one
warm-up launch. Prints the card's name and power limit, then one JSON
line. Needs a CUDA card; imports nothing of JAX.
"""

import argparse
import json
import os
import sys

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
        sys.exit("trace_ab: needs a CUDA card")
    from readtape_tpu_torch import kernels
    from readtape_tpu_torch.decode import fused, slot
    from readtape_tpu_torch.formats import tbin as tb
    if not kernels.__file__.startswith(root + os.sep):
        sys.exit(f"trace_ab: imported {kernels.__file__}, not {root}'s")
    card = cs.card_line()
    out = {"root": root}

    def timed(tag, launcher, fn, samples, opts, kernel_path="fused",
              reps=args.reps):
        a, kw = cs.first_call(kernels, launcher, samples, opts, kernel_path)
        out[tag] = cs.time_launches(lambda: fn(*a, **kw), reps)

    _, hdr, samples = cs.pe_bench_tape()
    timed("b2 main", "pe_fused", fused.pe_fused_scan, samples,
          cs.tape_options(hdr, tb.MODE_PE, 1600))
    _, hdr, samples = cs.gcr_bench_tape()
    timed("b3 main", "gcr_fused", fused.gcr_fused_scan, samples,
          cs.tape_options(hdr, tb.MODE_GCR, 9042, 25))
    _, hdr, samples = cs.bench_tape()
    timed("b6 main", "nrzi_slot", slot.nrzi_slot_scan, samples,
          cs.tape_options(hdr, tb.MODE_NRZI, 800), "tiered")
    _, hdr, samples = cs.ww_bench_tape()
    timed("b4 main", "ww_fused", fused.ww_fused_scan, samples,
          cs.ww_options(hdr), reps=max(3, args.reps // 5))
    print(card, flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
