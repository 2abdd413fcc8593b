"""Which fused multiply-add does the JAX package's XLA CPU build form for
the exponential clock, a * delta + (1 - a) * avg, in the programs that
NRZI -adjskew and -correctdbg run?

XLA contracts that expression into fma(a, delta, (1 - a) * avg) in some
programs and into fma(1 - a, avg, a * delta) in others (decode/slot.py's
clk_avg_fma). -adjskew decodes one parmset per program, with the
deviation accumulators; -correctdbg all parmsets, streaming write
records. This probe decodes tapes with the JAX package and with the
port (the plain versions on the CPU) under each choice, and prints, per
tape and choice, whether every block (kind, data, parmset, tries,
errors, warnings, times, detail, the -adjskew report) and the final skew
agree; for -correctdbg, whose winners rarely show the clock's rounding,
also whether every parmset's results on every segment agree (the JAX
package's _nrzi_correctdbg_segment against the port's batch). A tape
decides the choice only where the two choices disagree.

    JAX_PLATFORMS=cpu python scripts/probe_adjskew_contraction.py [option]

(option: -adjskew or -correctdbg, to probe one of them.)
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from readtape_tpu.decode import pipeline as jpl  # noqa: E402
from readtape_tpu.formats import tbin as tb  # noqa: E402
from readtape_tpu.synth import default_spec, synthesize_tape  # noqa: E402
from readtape_tpu_torch.decode import pipeline as tpl  # noqa: E402


def oracle_adjskew(seed=42):
    """tests/test_cli_oracle.py's -adjskew recipe (its seed 42)."""
    rng = np.random.default_rng(seed)
    spec = default_spec(tb.MODE_NRZI,
                        skew_samples=(0, 3, 1, 5, 2, 0, 4, 1, 2))
    items = [("block", bytes(rng.integers(0, 256, n, dtype=np.uint8)))
             for n in (200, 80, 512, 120, 300)]
    items.insert(2, ("tapemark",))
    return synthesize_tape(spec, items)


def oracle_correctdbg(seed=67):
    """tests/test_cli_oracle.py's -correctdbg recipe (its seed 67)."""
    rng = np.random.default_rng(seed)
    blocks = [bytes(rng.integers(0, 256, 150, dtype=np.uint8))
              for _ in range(3)]
    spec = default_spec(tb.MODE_NRZI, noise_rms=0.04, amp_jitter=0.08)
    return synthesize_tape(spec, [("block", b) for b in blocks])


def noisy(seed, skew=()):
    """Three 420-byte blocks, 0.03 V noise, 30% amplitude and 0.1-bit
    timing jitter: parmset 0 fails, so the retries run."""
    rng = np.random.default_rng(seed)
    blocks = [bytes(rng.integers(0, 256, 420, dtype=np.uint8))
              for _ in range(3)]
    spec = default_spec(tb.MODE_NRZI, noise_rms=0.03, amp_jitter=0.3,
                        time_jitter_bits=0.1, ibg_secs=0.004,
                        start_gap_secs=0.004, seed=seed, skew_samples=skew)
    return synthesize_tape(spec, [("block", b) for b in blocks])


def summary(blocks, stats):
    return ([(b.kind, b.data, b.parmset, b.tries, b.errcount, b.warncount,
              b.t_start, b.t_end, b.detail) for b in blocks], stats["skew"])


def forcing(fma):
    """A context in which the port's -adjskew and -correctdbg batches run
    B6 with clk_avg_fma = fma."""
    import contextlib
    orig = tpl._nrzi_group_tiered

    def forced(*a, **kw):
        if kw.get("adj_init") is not None or kw.get("correct_debug"):
            kw["clk_avg_fma"] = fma
        return orig(*a, **kw)

    @contextlib.contextmanager
    def ctx():
        tpl._nrzi_group_tiered = forced
        try:
            yield
        finally:
            tpl._nrzi_group_tiered = orig
    return ctx()


def port_decode(samples, opts, fma):
    with forcing(fma):
        return summary(*tpl.decode_tape(samples, tpl.DecodeOptions(**opts),
                                        device="cpu"))


FIELDS = ("blktype", "minbits", "maxbits", "errcount", "warncount",
          "corrected_bits", "faked_tracks", "avg_bit_spacing", "hist",
          "end_s", "unconsumed")


def segment_lanes(samples, opts):
    """-correctdbg per segment, every parmset: {fma: equal lanes} out of
    the lanes of all segments, and that count."""
    jdec = jpl.TapeDecoder(samples, jpl.DecodeOptions(**opts))
    tdec = tpl.TapeDecoder(samples, tpl.DecodeOptions(**opts), device="cpu")
    segs = tdec.segments()
    S = max(jpl.seg.bucket_length(b - max(a - jpl.SEG_WARMUP, 0))
            for a, b in segs)
    eq, n = {False: 0, True: 0}, 0
    for a, b in segs:
        want = jpl._nrzi_correctdbg_segment(jdec, a, b, S)
        for fma in (False, True):
            with forcing(fma):
                got = tdec.decode_segment_batch([(a, b)], bucket=S,
                                                correctdbg=True)
            for p in range(tdec.P):
                eq[fma] += all(np.array_equal(np.asarray(want[k][p]),
                                              got[k][0, p]) for k in FIELDS)
        n += tdec.P
    return eq, n


def main():
    cases = [("-adjskew", "oracle recipe, seed 42", oracle_adjskew(42),
              dict(adjskew=True)),
             ("-adjskew", "oracle recipe, seed 43", oracle_adjskew(43),
              dict(adjskew=True)),
             ("-adjskew", "noisy, seed 1", noisy(1, (0, 2, 1, 3, 0, 1, 2,
                                                     0, 1)),
              dict(adjskew=True)),
             ("-correctdbg", "oracle recipe, seed 67", oracle_correctdbg(),
              dict(do_correct=True, do_correct_debug=True)),
             ("-correctdbg", "noisy, seed 1", noisy(1),
              dict(do_correct=True, do_correct_debug=True)),
             ("-correctdbg", "noisy, seed 2", noisy(2),
              dict(do_correct=True, do_correct_debug=True))]
    only = sys.argv[1:]
    for option, name, (hdr, samples), kw in cases:
        if only and option not in only:
            continue
        opts = dict(mode=tb.MODE_NRZI, ntrks=hdr.ntrks, bpi=800, ips=50,
                    deltat=hdr.tdelta_ns * 1e-9, maxvolts=hdr.maxvolts, **kw)
        if option == "-correctdbg":
            eq, n = segment_lanes(samples, opts)
            print(f"{option} {name}, every parmset of every segment: "
                  f"fma(a, delta, (1 - a) * avg) {eq[False]} of {n} equal, "
                  f"fma(1 - a, avg, a * delta) {eq[True]} of {n}",
                  flush=True)
        want = summary(*jpl.decode_tape(samples, jpl.DecodeOptions(**opts)))
        got = {fma: port_decode(samples, opts, fma) for fma in (False, True)}
        verdict = {fma: "equal" if got[fma] == want else "differs"
                   for fma in got}
        note = (" (the choices agree: undecided)"
                if got[False] == got[True] else "")
        print(f"{option} {name}: fma(a, delta, (1 - a) * avg) "
              f"{verdict[False]}, fma(1 - a, avg, a * delta) "
              f"{verdict[True]}{note}", flush=True)


if __name__ == "__main__":
    main()
