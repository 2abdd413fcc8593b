#!/usr/bin/env python3
"""Time each plain PyTorch version that chip_smoke.py's phase 3 holds a
kernel to, on the card's inputs and on host copies of them, and check
that the two give the same outputs: where the plain versions run fastest
with the same results.

    python3 scripts/plain_ab.py

Runs chip_smoke.phase_kernel() with every plain version of the fused,
scan, slot and zeros wrappers wrapped so that each call runs twice, on
its own arguments (moved to the card) and on host copies, and prints one
line per call: the plain version, the shape of its first tensor
argument, the seconds on the card and on the host (the card's with a
synchronize after), and EQUAL or the outputs that differ. Ends with the
phase's seconds. Needs a CUDA card; imports nothing of JAX.
"""

import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    sys.path.insert(0, REPO)
    import torch

    import chip_smoke as cs
    from readtape_tpu_torch import kernels
    from readtape_tpu_torch.decode import fused, scan, slot, zeros
    from readtape_tpu_torch.parallel.mesh import tree_map
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")

    def both(fn, name):
        def run(*a, **k):
            a, k = tree_map(lambda t: t.cuda(), (a, k))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = fn(*a, **k)
            torch.cuda.synchronize()
            t_card = time.perf_counter() - t0
            t0 = time.perf_counter()
            host = fn(*tree_map(lambda t: t.cpu(), a),
                      **tree_map(lambda t: t.cpu(), k))
            t_host = time.perf_counter() - t0
            bad = [key for key in want
                   if not torch.equal(want[key].cpu(), host[key])]
            shape = next((tuple(t.shape) for t in a if torch.is_tensor(t)),
                         ())
            print(f"PLAIN {name} {shape}: card {t_card:.2f} s, host "
                  f"{t_host:.2f} s, {'EQUAL' if not bad else bad}",
                  flush=True)
            return want
        run.calls = 0
        return run

    for mod, name in ((fused, "nrzi_fused_scan_plain"),
                      (fused, "pe_fused_scan_plain"),
                      (fused, "gcr_fused_scan_plain"),
                      (fused, "ww_fused_scan_plain"),
                      (scan, "nrzi_track_scan_plain"),
                      (scan, "nrzi_track_scan_tracks_plain"),
                      (slot, "nrzi_slot_scan_plain"),
                      (zeros, "zerocross_transitions_plain"),
                      (zeros, "gcr_zeros_scan_plain")):
        setattr(mod, name, both(getattr(mod, name), name))
    print(cs.card_line(), flush=True)
    kernels.build()
    t0 = time.perf_counter()
    cs.phase_kernel()
    print(f"phase 3 with every plain version run twice: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
