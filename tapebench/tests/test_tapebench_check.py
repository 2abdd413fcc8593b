"""The reference, the comparison that decides `correct`, and the noisy
traffic's effect, at small sizes on the CPU."""

import json
import os

import numpy as np
import pytest
import torch

from tapebench import check, harness, synth
from tapebench.reference import decode as ref

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load(kind, name):
    with open(os.path.join(HERE, kind, name + ".json")) as f:
        return json.load(f)


def small(config, nblocks, size=None):
    """The configuration cut to `nblocks` blocks of `size` bytes, with
    8 ms gaps."""
    c = load("configs", config)
    c["block_sizes"] = [[size or c["block_sizes"][0][0], nblocks]]
    c["samples"] = synth.samples_for(c, 0.008)
    return c


def port_decode(config, samples):
    from readtape_tpu_torch.decode import pipeline as pl
    opts = pl.DecodeOptions(**harness.option_kwargs(config))
    return pl.decode_tape(samples, opts, device="cpu")


@pytest.mark.parametrize("config,traffic,nblocks,size", [
    ("nrzi9_800", "noisy_retry", 3, 300),
    ("pe9_1600", "clean", 3, 200),
])
def test_reference_equals_the_port_and_control_fails(config, traffic,
                                                     nblocks, size):
    cfg = small(config, nblocks, size)
    samples, items, spans = synth.synthesize(cfg, load("traffic", traffic),
                                             2 ** 33 + 5, 0)
    blocks, stats = port_decode(cfg, samples)
    ropts = harness.reference_options(cfg)
    picks = range(len(ref.Decoder(samples, ropts).segments()))
    segs, want, skew = ref.decode_sample(samples, ropts, picks)
    assert check.skew_of(stats) == skew
    # the NRZI configuration's synthesized head skew is calibrated out
    assert any(skew) == cfg["decode"].get("deskew", False)
    numbers = dict(zip(("blocks_differ", "float_gap"),
                       check.compare(blocks, want, segs, ropts.deltat)))
    assert numbers == {"blocks_differ": 0, "float_gap": 0.0}
    assert check.verdict(numbers)
    _, low, _ = ref.decode_sample(samples, ropts, picks,
                                  volts_dtype=torch.bfloat16)
    ctl = [b for i in sorted(low) for b in low[i]]
    assert not check.verdict(dict(zip(
        ("blocks_differ", "float_gap"),
        check.compare(ctl, want, segs, ropts.deltat))))


def test_noisy_retry_runs_the_retry_and_recovers_some_blocks():
    """Parmset 0 fails every block, the 8-parmset retry recovers some."""
    cfg = small("nrzi9_800", 4)
    samples, items, spans = synth.synthesize(
        cfg, load("traffic", "noisy_retry"), 3, 0)
    blocks, stats = port_decode(cfg, samples)
    assert stats["tried"][0] == len(items)
    assert stats["tried"][7] >= 1
    assert stats["chosen"][0] <= 1          # the tapemark at most
    kinds = check.failure_kinds(blocks, items, spans,
                                1.0 / cfg["sample_rate_hz"])
    # the blocks the retry cannot mend come back reporting their errors
    assert 0 < kinds["flagged"] < 4
    assert kinds["split"] == kinds["kind"] == kinds["silent"] == 0


def test_failures_count_missing_wrong_and_erroneous():
    class B:
        def __init__(self, kind, data, t0, t1, err=0):
            self.kind, self.data, self.t_start, self.t_end = kind, data, t0, t1
            self.errcount = err
    items = [("block", b"ab"), ("block", b"cd"), ("block", b"ef"),
             ("tapemark",)]
    spans = [(0, 1), (2, 3), (4, 5), (6, 7)]
    got = [B("data", b"ab", 0.1, 0.9), B("data", b"cx", 2.1, 2.9),
           B("data", b"ef", 4.1, 4.9, err=2), B("tapemark", b"", 6.1, 6.5)]
    assert check.failure_kinds(got, items, spans, 1e-6) == {
        "missing": 0, "split": 0, "kind": 0, "flagged": 1, "silent": 1}
    assert check.failure_kinds(got[:1], items, spans, 1e-6) == {
        "missing": 3, "split": 0, "kind": 0, "flagged": 0, "silent": 0}
    two = got + [B("data", b"ab", 0.5, 0.95), B("tapemark", b"", 4.2, 4.8)]
    assert check.failure_kinds(two, items, spans, 1e-6) == {
        "missing": 0, "split": 2, "kind": 0, "flagged": 0, "silent": 1}
    wrong = [B("tapemark", b"", 0.1, 0.9)] + got[1:3] + [
        B("data", b"", 6.1, 6.5)]
    assert check.failure_kinds(wrong, items, spans, 1e-6) == {
        "missing": 0, "split": 0, "kind": 2, "flagged": 1, "silent": 1}


def test_wrong_items_count_the_answers_that_are_not_the_references():
    """failed: per sampled segment, the items on which the decode's
    answer is not the reference's, whatever the payloads were."""
    class B:
        def __init__(self, kind, data, t0, err=0):
            self.kind, self.data, self.t_start = kind, data, t0
            self.t_end, self.parmset, self.tries = t0 + 0.5, 4, 8
            self.errcount, self.warncount, self.detail = err, 0, {}
    segs = [(0, 2_000_000), (2_000_000, 4_000_000), (4_000_000, 6_000_000)]
    ref = {0: [B("data", b"ab", 0.1, err=2), B("data", b"cd", 1.0)],
           2: []}                   # a tapemark the noise took, on both
    same = [B("data", b"ab", 0.1, err=2), B("data", b"cd", 1.0),
            B("data", b"zz", 3.0)]  # segment 1 is not sampled
    assert check.wrong_items(same, ref, segs, 1e-6) == 0
    assert check.wrong_items(same, ref, segs, 1e-6, whole=True) == 2
    assert check.wrong_items(same[1:], ref, segs, 1e-6) == 1
    altered = [B("data", b"ab", 0.1, err=1), B("data", b"cx", 1.0)]
    assert check.wrong_items(altered, ref, segs, 1e-6) == 2
    extra = same + [B("tapemark", b"", 4.5)]
    assert check.wrong_items(extra, ref, segs, 1e-6) == 1


def test_synthesizer_is_a_function_of_the_seed():
    cfg = small("pe9_1600", 2, 100)
    tr = load("traffic", "noisy_retry")
    a = synth.synthesize(cfg, tr, 2 ** 31 + 7, 1)
    b = synth.synthesize(cfg, tr, 2 ** 31 + 7, 1)
    c = synth.synthesize(cfg, tr, 2 ** 31 + 8, 1)
    assert np.array_equal(a[0], b[0]) and a[1] == b[1]
    assert a[1] != c[1]
    assert a[0].shape == c[0].shape      # the same work on every seed
