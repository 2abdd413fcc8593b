"""decode_tape under a decode mesh of four shards, with and without the
port's telemetry recording, on the CPU.

A short noisy 9-track NRZI capture with a head skew, made by the port's
synthesizer with the benchmark's noisy_retry recipe (0.02 V noise, 0.2
amplitude and 0.05 bit timing jitter) and decoded with -deskew and the
staged retry, as the benchmark's nrzi9_800_mesh4 cell decodes its
captures: under make_decode_mesh([cpu] * 4, parm_axis=1) it equals the
JAX package's decode and the one-device decode, blocks, statistics and
skew delays. Recording changes no block or stat; it counts the lanes
each dispatch pads to a multiple of the data axis (dispatch.pad_lanes),
names each shard's fetch and the waits inside a shard with their
device, and records the tape's copies to the mesh's other devices
(resident.replicate, d2d_bytes) only where the mesh has more than one
distinct device.

Tolerance: none. The mesh and the recording change no output.
"""

import numpy as np
import pytest
import torch

from readtape_tpu.decode import pipeline as jpl
from readtape_tpu_torch import telemetry
from readtape_tpu_torch.decode import pipeline as pl
from readtape_tpu_torch.formats import tbin as tb
from readtape_tpu_torch.parallel import mesh as pmesh
from readtape_tpu_torch.synth.synthesize import default_spec, \
    synthesize_tape

torch.set_num_threads(2)

CPU4 = [torch.device("cpu")] * 4
SEED = 5


@pytest.fixture(scope="module")
def capture():
    """(samples, options keywords, payloads): blocks of 64 and 96 bytes
    and a tapemark, the head skewed 0-4 samples across the tracks. The
    noise fails parmset 0 on both blocks; its dispatches pad 3 (the
    calibration's, one segment each), 1 and 2 lanes to four."""
    rng = np.random.default_rng(SEED)
    spec = default_spec(tb.MODE_NRZI, noise_rms=0.02, amp_jitter=0.2,
                        time_jitter_bits=0.05, ibg_secs=0.004, seed=SEED,
                        skew_samples=(0, 2, 3, 1, 2, 4, 1, 2, 3))
    blocks = [bytes(rng.integers(0, 256, n, dtype=np.uint8))
              for n in (64, 96)]
    hdr, samples = synthesize_tape(
        spec, [("block", b) for b in blocks] + [("tapemark",)])
    kw = dict(mode=tb.MODE_NRZI, ntrks=9, bpi=800, ips=50,
              deltat=hdr.tdelta_ns * 1e-9, maxvolts=hdr.maxvolts,
              multiple_tries=True, deskew=True, expected_parity=1)
    return samples, kw, blocks


@pytest.fixture(scope="module")
def decodes(capture):
    """The one-device decode (recorded), and under the four-shard mesh one
    decode with recording off and one on, with the batch size each
    dispatch was handed while recording."""
    samples, kw, _ = capture
    opts = pl.DecodeOptions(**kw)
    with telemetry.recording() as rec_one:
        one = pl.decode_tape(samples, opts, device="cpu")
    lanes, real = [], pl.TapeDecoder.dispatch_segment_batch

    def spy(self, spans, *a, **k):
        if telemetry._on:
            lanes.append(len(spans))
        return real(self, spans, *a, **k)
    pl.TapeDecoder.dispatch_segment_batch = spy
    pmesh.set_decode_mesh(pmesh.make_decode_mesh(CPU4, parm_axis=1))
    try:
        off = pl.decode_tape(samples, opts, device="cpu")
        with telemetry.recording() as rec:
            on = pl.decode_tape(samples, opts, device="cpu")
    finally:
        pmesh.set_decode_mesh(None)
        pl.TapeDecoder.dispatch_segment_batch = real
    return dict(one=one, rec_one=rec_one, off=off, on=on, rec=rec,
                lanes=lanes)


def _sig(out):
    return [(b.kind, b.data, b.parmset, b.tries, b.errcount, b.warncount)
            for b in out]


def _same(a, b):
    (ba, sa), (bb, sb) = a, b
    assert [vars(x) for x in ba] == [vars(x) for x in bb]
    assert sa.keys() == sb.keys()
    for k in sa:
        np.testing.assert_array_equal(np.asarray(sa[k], dtype=object),
                                      np.asarray(sb[k], dtype=object))


def test_mesh_decode_equals_jax_and_one_device(capture, decodes):
    samples, kw, blocks = capture
    jout, jst = jpl.decode_tape(samples, jpl.DecodeOptions(**kw))
    got, st = decodes["off"]
    assert _sig(got) == _sig(jout)
    for k in ("tried", "chosen", "peak_hist", "skew"):
        np.testing.assert_array_equal(st[k], jst[k], err_msg=k)
    assert any(st["skew"])
    # the noise fails parmset 0 on both blocks: the retry ran, and won
    assert st["tried"][1] > 0 and st["nblocks"] == 2
    assert [b.data for b in got if b.kind == "data"] == blocks
    _same(decodes["one"], decodes["off"])


def test_recording_changes_nothing_under_the_mesh(decodes):
    _same(decodes["off"], decodes["on"])


def test_pad_lanes_count_the_padding(decodes):
    rec, lanes = decodes["rec"], decodes["lanes"]
    pads = [-n % 4 for n in lanes]
    # -deskew's calibration dispatches one segment at a time: 1 -> 4
    assert pads.count(3) >= 2 and {1, 2} <= set(pads)
    assert rec.counters["dispatch.pad_lanes"] == sum(pads)
    got = [s.counters.get("dispatch.pad_lanes") for s in rec.spans
           if s.name == "dispatch"]
    assert sorted(got) == sorted(pads)
    assert "dispatch.pad_lanes" not in decodes["rec_one"].counters


def test_shard_spans_and_waits_carry_their_device(decodes):
    rec = decodes["rec"]
    byid = {s.id: s for s in rec.spans}
    fetches = [s for s in rec.spans if s.name == "fetch"]
    shards = [s for s in rec.spans if s.name == "fetch.shard"]
    assert fetches and len(shards) == 4 * len(fetches)
    assert all(byid[s.parent].name == "fetch"
               and s.attrs == {"device": "cpu"} for s in shards)

    def under(s, name):
        while s.parent in byid:
            s = byid[s.parent]
            if s.name == name:
                return True
        return False
    waits = [s for s in rec.spans if s.name.startswith("wait.")]
    inside = [s for s in waits if under(s, "dispatch.shard")
              or under(s, "fetch.shard")]
    assert {s.name for s in inside} >= {"wait.batch_args",
                                        "wait.const_upload", "wait.fetch"}
    assert all(s.attrs == {"device": "cpu"} for s in inside)
    assert all("device" not in s.attrs for s in waits if s not in inside)
    # one distinct device: nothing to replicate
    assert not any(s.name == "resident.replicate" for s in rec.spans)
    assert "d2d_bytes" not in rec.counters
    one = {s.name for s in decodes["rec_one"].spans}
    assert not one & {"fetch.shard", "dispatch.shard", "resident.replicate"}


def test_replicate_counts_a_copy_per_other_device(capture):
    """cpu and cpu:0 are two distinct devices to the mesh: one copy of
    the tape, inside resident.upload."""
    samples, kw, _ = capture
    pmesh.set_decode_mesh(pmesh.make_decode_mesh(
        [torch.device("cpu"), torch.device("cpu", 0)] * 2, parm_axis=1))
    try:
        with telemetry.recording() as rec:
            dec = pl.TapeDecoder(samples, pl.DecodeOptions(**kw),
                                 device="cpu")
    finally:
        pmesh.set_decode_mesh(None)
    (rep,) = [s for s in rec.spans if s.name == "resident.replicate"]
    parent = next(s for s in rec.spans if s.id == rep.parent)
    assert parent.name == "resident.upload"
    assert rep.counters == {"d2d_bytes": dec.tape.nbytes}
    assert rec.counters["d2d_bytes"] == dec.tape.nbytes
    assert list(dec._tapes) == [torch.device("cpu", 0)]


def test_a_wait_takes_the_device_of_its_shard():
    with telemetry.recording() as rec:
        with telemetry.wait("outside"):
            pass
        with telemetry.span("dispatch.shard", device="cuda:2"):
            with telemetry.span("finish"):
                with telemetry.wait("const_upload"):
                    pass
            with telemetry.wait("fetch", 2):
                pass
    got = {s.name: s.attrs for s in rec.spans}
    assert got["wait.outside"] == {}
    assert got["wait.const_upload"] == {"device": "cuda:2"}
    assert got["wait.fetch"] == {"device": "cuda:2"}
    assert rec.counters["host_waits"] == 4
