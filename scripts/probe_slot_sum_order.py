"""In which order does the JAX package's XLA slot scan (CPU) sum avg_pos?

nrzi.nrzi_slot_scan sums the window positions of the tracks with a 1-bit
(`avg_pos`) with jnp.sum over the tracks. The C program, and the port's
plain slot machine and its CUDA kernels, add them in track order. This
probe runs the XLA scan on made-up buffers -- nine tracks with a
transition at every bit, jittered by up to 1.5 samples, so that all nine
are in every window -- for 2 and 3 slots, and checks which summation
order reproduces slot 3's t_lastclock from slot 2's state:
adjusted = fma(pulse_adj, avg_pos / 9 - expected, expected).

    JAX_PLATFORMS=cpu python scripts/probe_slot_sum_order.py [parmset] [trials]

Prints, per candidate order, on how many of the trials it matches.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from readtape_tpu.decode import nrzi as jnrzi  # noqa: E402
from readtape_tpu.formats import tbin as tb  # noqa: E402
from readtape_tpu.formats.parms import builtin_parmsets  # noqa: E402

f = np.float32
T, NBITS, SPB, S = 9, 150, 19.53125, 4096


def buffers(seed):
    """Transition buffers: every track a transition at every bit."""
    rng = np.random.default_rng(seed)
    K = NBITS + 8
    t = (64.0 + SPB * np.arange(NBITS))[None] + rng.uniform(-1.5, 1.5,
                                                           (T, NBITS))
    tr_s = np.full((T, K), 2 ** 30, np.int32)
    tr_t = np.zeros((T, K), np.float32)
    tr_s[:, :NBITS] = np.ceil(t).astype(np.int32) + 3
    tr_t[:, :NBITS] = t
    return tr_s, tr_t, np.ones((T, K), np.float32), np.full(T, NBITS, np.int32)


def xla_state(p, bufs, nslots):
    """(t_lastclock, t_bitspaceavg) after nslots slots of the XLA scan."""
    st = jnrzi.nrzi_slot_scan(
        *(jnp.asarray(x) for x in bufs), S, jnp.float32(SPB),
        jnp.int32(p.clk_window), jnp.float32(p.clk_alpha),
        jnp.float32(p.pulse_adj), jnp.float32(p.midbit), jnp.int32(1), False,
        int(S / SPB * 1.3) + 64, nslots, jnp.float32(0.0), jnp.float32(1.0))
    return f(st["t_lastclock"]), f(st["clkavg"]["t_bitspaceavg"])


def in_order(v):
    acc = f(0)
    for x in v:
        acc = f(acc + x)
    return acc


def lanes(v, k):
    """k strided partial sums: element i goes to partial i % k."""
    acc = [f(0)] * k
    for i, x in enumerate(v):
        acc[i % k] = f(acc[i % k] + x)
    return acc


def halves(v):
    """Fold the upper half onto the lower half until one value is left."""
    v = list(v)
    while len(v) > 1:
        if len(v) % 2:
            v.append(f(0))
        h = len(v) // 2
        v = [f(v[i] + v[i + h]) for i in range(h)]
    return v[0]


ORDERS = {"track order": in_order,
          "reversed": lambda v: in_order(v[::-1]),
          "halves": halves}
for k in (2, 4, 8):
    ORDERS[f"{k} partials, in order"] = (
        lambda k: lambda v: in_order(lanes(v, k)))(k)
    ORDERS[f"{k} partials, halves"] = (
        lambda k: lambda v: halves(lanes(v, k)))(k)


def main():
    parmset = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    trials = int(sys.argv[2]) if len(sys.argv) > 2 else 60
    p = builtin_parmsets(tb.MODE_NRZI).sets[parmset]
    padj = np.float64(f(p.pulse_adj))
    hits = dict.fromkeys(ORDERS, 0)
    for seed in range(trials):
        bufs = buffers(seed)
        t2, b2 = xla_state(p, bufs, 2)
        t3, _ = xla_state(p, bufs, 3)
        x = list(bufs[1][:, 2])        # slot 3's last peak of each track
        expected = f(t2 + b2)
        for name, order in ORDERS.items():
            avgp = f(order(x) / f(T))
            adjusted = f(padj * np.float64(f(avgp - expected))
                         + np.float64(expected))
            hits[name] += int(adjusted == t3)
    for name, n in sorted(hits.items(), key=lambda kv: -kv[1]):
        print(f"{name}: {n} of {trials}")


if __name__ == "__main__":
    main()
