"""What the program's telemetry costs a capture when it records.

    python3 tapebench/telemetry_cost.py --workload <cell> --seed <n> [--captures 24]

run from the root of a checkout, on a card. Sets up the cell as a run
does (kernels, the pool from the seed, warm decodes), then decodes the
pool round-robin, each capture twice in a row, once with
``telemetry.recording()`` on and once off (no profiler), `--captures`
times each; which of the two goes first alternates from one round of
the pool to the next, so that every capture is decoded in both orders.
Prints one JSON object: the median capture wall off and on, their
difference, and the median and mean of the paired differences, in ms.
"""

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--captures", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:] = [ROOT] + [p for p in sys.path
                            if os.path.abspath(p or ".") !=
                            os.path.dirname(os.path.abspath(__file__))]
    from readtape_tpu_torch import telemetry
    from tapebench import harness, manifest
    from tapebench.pool import make_pool

    cell = manifest.Cell(manifest.load_bench(os.path.join(
        ROOT, "BENCHMARK.json")), args.workload)
    program = harness.Program(cell.config, args.device)
    try:
        program.load_kernels()
        captures = make_pool(cell.config, cell.traffic, args.seed,
                             program.device)
        t_warm = time.perf_counter()
        k = 0
        while k < len(captures) or \
                time.perf_counter() - t_warm < harness.WARM_SECONDS:
            program.decode(captures[k % len(captures)])
            k += 1
        program.sync()

        def wall(cap, on):
            t0 = time.perf_counter()
            if on:
                with telemetry.recording():
                    program.decode(cap)
            else:
                program.decode(cap)
            return time.perf_counter() - t0

        off, on = [], []
        for k in range(args.captures):
            cap = captures[k % len(captures)]
            first_on = (k // len(captures)) % 2 == 1
            a = wall(cap, first_on)
            b = wall(cap, not first_on)
            (on if first_on else off).append(a)
            (off if first_on else on).append(b)
    finally:
        program.close()
    ms = 1e3
    result = {
        "workload": args.workload, "seed": args.seed,
        "captures_each": args.captures,
        "off_median_ms": statistics.median(off) * ms,
        "on_median_ms": statistics.median(on) * ms,
        "on_less_off_ms": (statistics.median(on)
                           - statistics.median(off)) * ms,
        "paired_median_ms": statistics.median(
            b - a for a, b in zip(off, on)) * ms,
        "paired_mean_ms": statistics.mean(
            b - a for a, b in zip(off, on)) * ms,
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
