"""NRZI -adjskew in the port (readtape_tpu_torch, plain versions on the
CPU) against the JAX package, bit for bit:

- the slot machine with the skew-deviation accumulators seeded non-zero
  (nrzi.nrzi_slot_scan's adj_init): B6's plain version against the JAX
  XLA scan on tests/test_torch_slot.py's one-block and -correct buffers,
  every state field plus the accumulators and the final clock; the
  single-lane XLA scan contracts the exponential clock as fma(1 - a,
  avg, a * delta), as the JAX package's -adjskew programs of one parmset
  do (scripts/probe_adjskew_contraction.py), so the port runs B6 with
  clk_avg_fma there;
- decode_tape on tests/test_cli_oracle.py's -adjskew recipe (skews
  0,3,1,5,2,0,4,1,2 samples, five blocks and a tapemark, seed 42):
  every block, its per-track report (deviation, bit spacing, action,
  new skew), the final skew and the run statistics;
- both command lines on that tape: every output file, the "deviation is"
  and "wrote block" lines of the .log included;
- the precedence: under -zeros, and on GCR tapes, -adjskew changes
  nothing.

The JAX reference decode runs once per module (a fixture). Tolerance:
none.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from readtape_tpu.decode import nrzi as jnrzi
from readtape_tpu.decode import pipeline as jpl
from readtape_tpu.formats import tbin as tb
from readtape_tpu.synth import default_spec, synthesize_tape
from readtape_tpu_torch.decode import fused as tfu
from readtape_tpu_torch.decode import pipeline as tpl
from readtape_tpu_torch.decode import slot as tsl

from test_torch_cli import _run_both, _same_outputs
from test_torch_pipeline import COUNTERS, opts_for
from test_torch_slot import STATE, slot_case

torch.set_num_threads(2)


def seeds(B, P, T, seed=11):
    """Non-zero (count, mean) seeds, as a tapemark or noise segment
    leaves them for the next data block."""
    rng = np.random.default_rng(seed)
    shape = (B, P, T)
    return (torch.from_numpy(rng.integers(1, 60, shape).astype(np.float32)),
            torch.from_numpy(rng.uniform(-3, 3, shape).astype(np.float32)))


@functools.lru_cache(maxsize=None)
def _jax_slot(S, do_correct, maxb, max_slots):
    """nrzi.nrzi_slot_scan with the accumulators, jitted once for every
    parmset of a case (the knobs are traced)."""
    def run(ts, tt, ta, cnt, spb, cw, ca, padj, mb, n0, m0):
        return jnrzi.nrzi_slot_scan(
            ts, tt, ta, cnt, S, spb, cw, ca, padj, mb, jnp.int32(1),
            do_correct, maxb, max_slots, jnp.float32(0.0), jnp.float32(1.0),
            adj_init=(n0, m0))
    return jax.jit(run)


@pytest.mark.parametrize("name", ["1blk", "correct"])
def test_slot_accumulators_match_jax(name):
    fin, pa, kw, trans, sets = slot_case(name)
    B, P, T, _ = fin["tr_s"].shape
    n0, m0 = seeds(B, P, T)
    out = tsl.nrzi_slot_scan(fin, pa, **dict(kw, clk_avg_fma=True,
                                             adj_init=(n0, m0)))
    st = {k: x.numpy() for k, x in tfu.fused_state(out).items()}
    scan = _jax_slot(kw["S"], kw["do_correct"], kw["maxb"], kw["max_slots"])
    moved = 0
    for pi, (p, tr) in enumerate(zip(sets, trans)):
        r = scan(*(jnp.asarray(tr[k]) for k in ("tr_s", "tr_t", "tr_agc",
                                                "counts")),
                 jnp.float32(kw["spb"]), jnp.int32(p.clk_window),
                 jnp.float32(p.clk_alpha), jnp.float32(p.pulse_adj),
                 jnp.float32(p.midbit), jnp.asarray(n0[0, pi].numpy()),
                 jnp.asarray(m0[0, pi].numpy()))
        r = jax.tree.map(np.asarray, r)
        msg = f"{name} parmset {pi}"
        for k in STATE:
            np.testing.assert_array_equal(st[k][0, pi], r[k],
                                          err_msg=f"{msg} {k}")
        adj = out["adj"][0, pi].numpy()
        np.testing.assert_array_equal(adj[:, tsl.ADJ_N], r["adj_n"],
                                      err_msg=msg)
        np.testing.assert_array_equal(adj[:, tsl.ADJ_MEAN], r["adj_mean"],
                                      err_msg=msg)
        assert out["bitspace"][0, pi].item() == float(
            r["clkavg"]["t_bitspaceavg"]), msg
        moved += int((adj[:, tsl.ADJ_N] > n0[0, pi].numpy()).sum())
    assert moved > 0, "no accumulator moved"


def adjskew_tape():
    """tests/test_cli_oracle.py's -adjskew recipe: (ground truth, hdr,
    samples)."""
    rng = np.random.default_rng(42)
    spec = default_spec(tb.MODE_NRZI,
                        skew_samples=(0, 3, 1, 5, 2, 0, 4, 1, 2))
    items = [("block", bytes(rng.integers(0, 256, n, dtype=np.uint8)))
             for n in (200, 80, 512, 120, 300)]
    truth = [it[1] for it in items]
    items.insert(2, ("tapemark",))
    hdr, samples = synthesize_tape(spec, items)
    return truth, hdr, samples


@pytest.fixture(scope="module")
def jax_adjskew():
    truth, hdr, samples = adjskew_tape()
    kw = opts_for(hdr, adjskew=True)
    return truth, hdr, samples, kw, jpl.decode_tape(
        samples, jpl.DecodeOptions(**kw))


def test_decode_tape_adjskew(jax_adjskew):
    truth, hdr, samples, kw, (jout, jst) = jax_adjskew
    calls = tsl.nrzi_slot_scan_plain.calls
    tout, tst = tpl.decode_tape(samples, tpl.DecodeOptions(**kw),
                                device="cpu")
    # one B=1, P=1 slot machine per try (no fused kernel on this path)
    assert tsl.nrzi_slot_scan_plain.calls - calls >= 6
    assert [(b.kind, b.data, b.parmset, b.tries, b.errcount, b.warncount,
             b.t_start, b.t_end) for b in tout] == \
        [(b.kind, b.data, b.parmset, b.tries, b.errcount, b.warncount,
          b.t_start, b.t_end) for b in jout]
    for i, (t, j) in enumerate(zip(tout, jout)):
        assert t.detail == j.detail, f"block {i}"
    for k in ("peak_hist", "peak_trksums", "tried", "chosen"):
        np.testing.assert_array_equal(tst[k], jst[k], err_msg=k)
    for k in COUNTERS + ("skew", "deskew_percent", "peak_bins"):
        assert tst[k] == jst[k], k
    assert [b.data for b in tout if b.kind == "data"] == truth
    reports = [b.detail["adjskew"] for b in tout if b.kind == "data"]
    assert len(reports) == 5 and all(len(r) == 9 for r in reports)
    # the skew moved, so later blocks decoded with other delay lines
    assert any(act for r in reports for _, _, act, _ in r)
    assert tst["skew"] != [0] * 9


def test_cli_adjskew(jax_adjskew, tmp_path, monkeypatch, capsys):
    _, hdr, samples, _, _ = jax_adjskew
    rcs = _run_both(tmp_path, monkeypatch, (hdr, samples),
                    [["-v", "-m", "-nrzi", "-adjskew", "-tap", "t"]])
    assert rcs == [[0], [0]]
    names = _same_outputs(tmp_path, inputs=["t.tbin"])
    assert {"t.tap", "t.log"} <= set(names)
    log = (tmp_path / "t" / "t.log").read_text()
    dev = [ln for ln in log.splitlines() if "deviation is" in ln]
    assert len(dev) == 5 * 9 and any("skew increased to" in ln
                                     for ln in dev)
    assert sum("wrote block" in ln for ln in log.splitlines()) == 5


def _zeros_tape():
    """Two 48-byte blocks, -zeros' territory: a short NRZI tape."""
    rng = np.random.default_rng(5)
    spec = default_spec(tb.MODE_NRZI, ibg_secs=0.002, start_gap_secs=0.002,
                        skew_samples=(0, 2, 0, 1, 0, 0, 3, 0, 0))
    return synthesize_tape(
        spec, [("block", bytes(rng.integers(0, 256, 48, dtype=np.uint8)))
               for _ in range(2)])


def _gcr_tape():
    rng = np.random.default_rng(4)
    spec = default_spec(tb.MODE_GCR, ibg_secs=0.002, start_gap_secs=0.002)
    return synthesize_tape(
        spec, [("block", bytes(rng.integers(0, 256, 48, dtype=np.uint8))),
               ("tapemark",)])


@pytest.mark.parametrize("case", ["nrzi -zeros", "gcr"])
def test_adjskew_ignored(case, monkeypatch):
    """The JAX package's precedence (pipeline.py:2621-2622): -adjskew is
    NRZI's and not -zeros'; elsewhere the decode is the one without it,
    and no batch is seeded."""
    if case == "gcr":
        hdr, samples = _gcr_tape()
        kw = dict(mode=tb.MODE_GCR, ntrks=9, bpi=9042, ips=25,
                  deltat=hdr.tdelta_ns * 1e-9, maxvolts=hdr.maxvolts)
    else:
        hdr, samples = _zeros_tape()
        kw = opts_for(hdr, find_zeros=True)
    seeded = []
    orig = tpl.TapeDecoder.dispatch_segment_batch

    def spy(self, *a, **k):
        seeded.append(k.get("adj_init") is not None)
        return orig(self, *a, **k)
    monkeypatch.setattr(tpl.TapeDecoder, "dispatch_segment_batch", spy)
    want, wst = tpl.decode_tape(samples, tpl.DecodeOptions(**kw),
                                device="cpu")
    got, gst = tpl.decode_tape(samples, tpl.DecodeOptions(**kw, adjskew=True),
                               device="cpu")
    assert seeded and not any(seeded)
    assert got == want and gst["skew"] == wst["skew"]
