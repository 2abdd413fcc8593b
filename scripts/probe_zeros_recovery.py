"""Does plain -zeros recover the bench tapes' blocks, in the JAX package?

chip_smoke.py decodes the GCR and NRZI bench tapes with -zeros on the
card; on these synthesized pulse tapes the port recovers none of their
blocks. This probe decodes the first blocks of the same recipes (4 of
the GCR bench tape's, 2 of the NRZI bench tape's; the whole tapes take
the JAX package's CPU path too long) with -zeros in the JAX package and
in the port's plain versions, both on the CPU, and prints for each the
kinds of the blocks decoded and how many equal the synthesizer's ground
truth; it exits non-zero if the two packages decode differently.

    JAX_PLATFORMS=cpu python scripts/probe_zeros_recovery.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402
from readtape_tpu.decode import pipeline as jpl  # noqa: E402
from readtape_tpu.formats import tbin as tb  # noqa: E402
from readtape_tpu_torch.decode import pipeline as tpl  # noqa: E402


def main():
    same = True
    for name, tape, mode, bpi, ips, n in (
            ("GCR bench", chip_smoke.gcr_bench_tape, tb.MODE_GCR, 9042, 25, 4),
            ("NRZI bench", chip_smoke.bench_tape, tb.MODE_NRZI, 800, 50, 2)):
        blocks, hdr, samples = tape(nblocks=n)
        kw = dict(mode=mode, ntrks=9, bpi=bpi, ips=ips,
                  deltat=hdr.tdelta_ns * 1e-9, maxvolts=hdr.maxvolts,
                  find_zeros=True)
        jout, _ = jpl.decode_tape(samples, jpl.DecodeOptions(**kw))
        tout, _ = tpl.decode_tape(samples, tpl.DecodeOptions(**kw),
                                  device="cpu")
        for pkg, out in (("JAX package", jout), ("port", tout)):
            good = sum(b.data in blocks for b in out if b.kind == "data")
            print(f"{name}, first {n} blocks, -zeros, {pkg}: "
                  f"{[(b.kind, len(b.data)) for b in out]}, {good} of "
                  f"{len(blocks)} equal to the ground truth", flush=True)
        same &= [(b.kind, b.data) for b in jout] == [(b.kind, b.data)
                                                     for b in tout]
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
