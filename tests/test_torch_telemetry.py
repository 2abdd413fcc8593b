"""readtape_tpu_torch.telemetry: spans and counters inside the decode.

Off (the default) a decode records nothing and reads no clock; on, it
returns what it returns off, and its spans nest under one ``capture``
root per decode, every span closed, the self times adding up to the
root's duration. Two threads recording at once keep their own parent
stacks. CPU decodes of short NRZI (with -deskew) and PE tapes.
"""

import sys
import threading

import numpy as np
import pytest
import torch

from readtape_tpu_torch import telemetry
from readtape_tpu_torch.decode import pipeline as pl
from readtape_tpu_torch.formats import tbin as tb
from readtape_tpu_torch.synth import default_spec, synthesize_tape

torch.set_num_threads(2)

# (mode, bpi, options, noise, closing tapemark): a noisy NRZI tape with a
# tapemark, and a clean PE one without (the plain PE walk over a tapemark
# takes seconds on the CPU)
MODES = {"nrzi": (tb.MODE_NRZI, 800, dict(deskew=True), 0.02, True),
         "pe": (tb.MODE_PE, 1600, {}, 0.01, False)}


def _tape(name):
    mode, bpi, extra, noise, tapemark = MODES[name]
    rng = np.random.default_rng(20 + mode)
    blocks = [bytes(rng.integers(0, 256, 72, dtype=np.uint8))
              for _ in range(2)]
    hdr, samples = synthesize_tape(
        default_spec(mode, noise_rms=noise),
        [("block", b) for b in blocks] + [("tapemark",)] * tapemark)
    opts = pl.DecodeOptions(mode=mode, ntrks=9, bpi=bpi, ips=50,
                            deltat=hdr.tdelta_ns * 1e-9,
                            maxvolts=hdr.maxvolts, **extra)
    return samples, opts


def _same(a, b):
    (ba, sa), (bb, sb) = a, b
    assert [vars(x) for x in ba] == [vars(x) for x in bb]
    assert sa.keys() == sb.keys()
    for k in sa:
        np.testing.assert_array_equal(np.asarray(sa[k], dtype=object),
                                      np.asarray(sb[k], dtype=object))


class _Refuse:
    def __getattr__(self, name):
        raise AssertionError(f"read {name} while telemetry is off")


@pytest.mark.parametrize("name", sorted(MODES))
def test_off_records_nothing_and_reads_no_clock(name, monkeypatch):
    samples, opts = _tape(name)

    def refuse(*a, **k):
        raise AssertionError("a span was made while telemetry is off")
    monkeypatch.setattr(telemetry, "time", _Refuse())
    monkeypatch.setattr(telemetry, "_Live", refuse)
    monkeypatch.setattr(telemetry, "Span", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    blocks, stats = pl.decode_tape(samples, opts, device="cpu")
    assert blocks and stats["nblocks"] >= 1
    assert telemetry._rec is None or not telemetry._on


@pytest.mark.parametrize("name", sorted(MODES))
def test_on_returns_the_same_and_spans_nest(name):
    samples, opts = _tape(name)
    off = pl.decode_tape(samples, opts, device="cpu")
    with telemetry.recording() as rec:
        on = pl.decode_tape(samples, opts, device="cpu")
        again = pl.decode_tape(samples, opts, device="cpu")
    _same(off, on)
    _same(off, again)
    assert telemetry._stack() == []
    caps = rec.by_capture()
    assert len(caps) == 2 and len(rec.spans) == sum(map(len, caps.values()))
    own = rec.self_ns()
    for cid, spans in caps.items():
        roots = [s for s in spans if s.name == "capture"]
        assert len(roots) == 1 and roots[0].id == cid
        root = roots[0]
        assert root.parent is None
        assert root.attrs == dict(samples=samples.shape[0], mode=opts.mode)
        ids = {s.id for s in spans}
        for s in spans:
            assert 0 < s.t0 <= s.t1, s
            assert s is root or s.parent in ids, s
            assert own[s.id] >= 0, s
        assert sum(own[s.id] for s in spans) == root.ns
        names = {s.name for s in spans}
        assert {"resident.scan", "resident.upload", "driver.segments",
                "driver.stage", "driver.emit", "dispatch", "dispatch.prep",
                "finish", "fetch", "wait.fetch",
                "wait.batch_args"} <= names
        assert ("driver.calibrate" in names) == (name == "nrzi")
        assert ("driver.pe_walk" in names) == (name == "pe")
        # the CPU runs the plain versions: no kernel launch, no ring check
        assert not any(n.startswith(("launch.", "wait.ring_check"))
                       for n in names)
    waits = sum(c for k, c in rec.counters.items()
                if k.startswith("host_waits."))
    assert waits == rec.counters["host_waits"] > 0
    assert rec.counters["h2d_bytes"] == 2 * samples.nbytes
    assert rec.counters["d2h_bytes"] > 0
    # one TapeDecoder a decode: the activity scan's plain version once,
    # its one copy to the host a wait
    assert rec.counters["activity.plain"] == 2
    assert rec.counters["host_waits.activity"] == 2
    assert "activity.card" not in rec.counters


@pytest.mark.parametrize("name", sorted(MODES))
def test_activity_scan_counted_once_per_decoder(name):
    """A TapeDecoder scans its int16 tape once: activity.plain on the
    CPU, and one wait.activity inside resident.scan."""
    samples, opts = _tape(name)
    with telemetry.recording() as rec:
        dec = pl.TapeDecoder(samples, opts, device="cpu")
    assert rec.counters["activity.plain"] == 1
    assert rec.counters["host_waits.activity"] == 1
    assert "activity.card" not in rec.counters
    scans = [s for s in rec.spans if s.name == "resident.scan"]
    waits = [s for s in rec.spans if s.name == "wait.activity"]
    assert len(scans) == len(waits) == 1
    assert waits[0].parent == scans[0].id
    assert scans[0].counters == {"activity.plain": 1, "host_waits": 1,
                                 "host_waits.activity": 1}
    h_est, act = pl.seg.host_activity(samples, opts.maxvolts)
    assert dec.h_est == h_est
    np.testing.assert_array_equal(dec._act, act)


def test_threads_keep_their_own_parent_stacks():
    barrier = threading.Barrier(2)
    seen = {}

    def work(tag):
        with telemetry.span("capture") as outer:
            barrier.wait()
            with telemetry.span("inner", tag=tag) as inner:
                barrier.wait()
                telemetry.count("hits")
            seen[tag] = (outer.id, inner)
            barrier.wait()

    with telemetry.recording() as rec:
        threads = [threading.Thread(target=work, args=(t,))
                   for t in ("a", "b")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(rec.spans) == 4 and rec.counters == {"hits": 2}
    for tag, (outer_id, inner) in seen.items():
        assert inner.parent == outer_id and inner.capture == outer_id
        assert inner.attrs == {"tag": tag} and inner.counters == {"hits": 1}
    assert seen["a"][0] != seen["b"][0]


def test_no_count_or_span_is_lost_across_threads():
    """More threads than cores, switching often: every span and count of
    every thread is kept."""
    nthreads, n = 32, 300

    def work():
        with telemetry.span("capture"):
            for _ in range(n):
                with telemetry.span("inner"):
                    telemetry.count("hits")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with telemetry.recording() as rec:
            threads = [threading.Thread(target=work)
                       for _ in range(nthreads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert rec.counters == {"hits": nthreads * n}
    assert len(rec.spans) == nthreads * (n + 1)
    caps = rec.by_capture()
    assert len(caps) == nthreads
    assert all(len(v) == n + 1 and sum(s.counters.get("hits", 0)
                                       for s in v) == n
               for v in caps.values())


def test_counters_waits_and_self_time():
    with telemetry.recording() as rec:
        telemetry.count("loose", 3)
        with telemetry.span("capture") as root:
            with telemetry.span("fetch") as fetch:
                with telemetry.wait("fetch", 2) as w:
                    pass
                telemetry.count("d2h_bytes", 64)
            telemetry.count("d2h_bytes", 8)
    assert rec.counters == {"loose": 3, "host_waits": 2,
                            "host_waits.fetch": 2, "d2h_bytes": 72}
    assert w.name == "wait.fetch" and w.parent == fetch.id
    assert fetch.counters == {"host_waits": 2, "host_waits.fetch": 2,
                              "d2h_bytes": 64}
    assert root.counters == {"d2h_bytes": 8}
    own = rec.self_ns()
    assert own[fetch.id] == fetch.ns - w.ns
    assert own[root.id] == root.ns - fetch.ns
    assert own[w.id] == w.ns
    with pytest.raises(RuntimeError, match="already"):
        with telemetry.recording():
            with telemetry.recording():
                pass
    assert not telemetry._on


def test_spans_lie_on_the_profilers_clock():
    """Under torch.profiler each span is a record_function of the same
    name, prefixed: nested as the spans are."""
    with telemetry.recording() as rec:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with telemetry.span("capture"):
                with telemetry.span("finish"):
                    torch.ones(4).sum()
    names = [e.name for e in prof.events()
             if e.name.startswith(telemetry.PREFIX)]
    assert sorted(names) == ["readtape.capture", "readtape.finish"]
    fin = next(e for e in prof.events() if e.name == "readtape.finish")
    assert fin.cpu_parent is not None
    assert fin.cpu_parent.name == "readtape.capture"
    assert [s.name for s in rec.spans] == ["finish", "capture"]
