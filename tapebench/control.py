"""The check's control: the plain reference put in the program's place,
with the volts its scans read held in bfloat16 (the nearest precision
below the float32 the decode states), read against the float32
reference on the segments a run of the cell checks.

    python3 tapebench/control.py --workload <cell> --seeds <n> [<n> ...]

Prints, per seed, the numbers the check compares and their limits; the
control has to fail at least one of them. It runs on the host, at the
cell's own capture sizes; the captures are made on the card where
there is one, as a run makes them.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(cell, seed: int, device: str) -> dict:
    import torch
    from tapebench import check, harness
    from tapebench.pool import make_pool
    from tapebench.reference import decode as ref
    captures = make_pool(cell.config, cell.traffic, seed, device)
    ropts = harness.reference_options(cell.config)
    cap = harness.checked_capture(len(captures), seed)
    picks = harness.checked_segments(
        ref.Decoder(captures[cap].samples, ropts).segments(), seed)
    segs, want, skew = ref.decode_sample(captures[cap].samples, ropts,
                                         picks)
    _, got, got_skew = ref.decode_sample(captures[cap].samples, ropts,
                                         picks, volts_dtype=torch.bfloat16)
    blocks = [b for i in sorted(got) for b in got[i]]
    differ, gap = check.compare(blocks, want, segs, ropts.deltat)
    if got_skew != skew:
        differ = len(want)
    numbers = {"blocks_differ": differ, "float_gap": gap}
    return {"seed": seed, "capture": cap, "segments": len(picks),
            "numbers": numbers, "fails": not check.verdict(numbers)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path[:] = [ROOT] + [p for p in sys.path
                            if os.path.abspath(p or ".") !=
                            os.path.dirname(os.path.abspath(__file__))]
    import torch
    from tapebench import manifest
    # the pool is made where the cell's runs make it, so that one seed
    # gives the captures a run of that seed checks
    device = "cuda" if torch.cuda.is_available() else "cpu"
    cell = manifest.Cell(manifest.load_bench(
        os.path.join(ROOT, "BENCHMARK.json")), args.workload)
    for seed in args.seeds:
        t = time.perf_counter()
        r = readings(cell, seed, device)
        r["seconds"] = time.perf_counter() - t
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
