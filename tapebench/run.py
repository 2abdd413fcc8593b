"""The benchmark of readtape_tpu_torch on NVIDIA GPUs.

    python3 tapebench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout. Prints one JSON object as the last line
of its standard output (correct, attempted, failed, metrics, device,
with --trace 1 a breakdown, and last the numbers compared with their
limits), and those numbers as the last lines of standard error. Exits
with another code than 0, printing no result, where no card is found, a
cell needs more cards than are visible, or a forbidden module (jax,
jaxlib, flax, readtape_tpu) is loaded once the window has closed.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # the checkout's root, not this folder, is where packages come from
    sys.path[:] = [ROOT] + [p for p in sys.path
                            if os.path.abspath(p or ".") !=
                            os.path.dirname(os.path.abspath(__file__))]
    os.environ.setdefault("USE_FLAX", "0")
    import torch
    from tapebench import harness, manifest

    bench = manifest.load_bench(os.path.join(ROOT, "BENCHMARK.json"))
    cell = manifest.Cell(bench, args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    try:
        result = harness.execute(args.workload, args.seed, args.seconds,
                                 bool(args.trace), device="cuda",
                                 bench=bench, t_process=T_PROCESS)
    except (RuntimeError, ValueError) as e:
        print(f"run failed: {e}", file=sys.stderr)
        return 1
    # again at the very end, in the process that prints the result
    mods = harness.forbidden_modules()
    if mods:
        print(f"run failed: forbidden modules loaded: {mods}",
              file=sys.stderr)
        return 1
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
