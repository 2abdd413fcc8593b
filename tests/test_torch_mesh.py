"""The port's decode mesh (readtape_tpu_torch/parallel/mesh.py) against the
JAX package's (readtape_tpu/parallel/mesh.py) on the CPU: the JAX package
shards over its 8 virtual CPU devices (tests/conftest.py), the port over
torch.device("cpu") named eight times, each entry a shard of its own that
runs after the others on the one device.

  - make_decode_mesh's (data, parm) shapes, and sharded_decode_step on a
    batch of NRZI segments;
  - decode_tape under a (4, 2) mesh, block for block with tried, chosen
    and peak_hist, equal to the JAX package's under its (4, 2) mesh and
    to the port's single-device decode: tests/test_multichip.py's NRZI
    (seed 99) and GCR (seed 7) tapes; and a PE tape with a dead track
    whose retry tries all 8 parmsets of one window width, so that the
    parm axis engages (a spy sees shards of P=4 and every batch padded
    to a multiple of the data axis). There the JAX package's mesh decode
    cannot be the reference: its PE batch program keeps the whole P
    inside each parm shard, returns 16 lanes for 8 and fails in the
    retry's bookkeeping (IndexError), so the port's mesh decode is held
    to the JAX package's single-device decode, which test_multichip.py
    holds its mesh decode equal to;
  - both command lines with -mesh=4x2 on eight devices: the same .tap and
    .log, the sharding line included;
  - a mesh of devices of another type than the decode's raises ValueError
    before any file is read or written; a kernel's argument block refuses
    a tensor on another device than the launch's.

Tolerance: none. The mesh changes no output.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from readtape_tpu import cli as jcli
from readtape_tpu.decode import pipeline as jpl
from readtape_tpu.formats import tbin as tb
from readtape_tpu.parallel import mesh as jmesh
from readtape_tpu.synth import default_spec, synthesize_tape
from readtape_tpu_torch import cli as tcli
from readtape_tpu_torch import kernels
from readtape_tpu_torch.decode import fused as tfu
from readtape_tpu_torch.decode import pipeline as tpl
from readtape_tpu_torch.decode.common import ParmArrays
from readtape_tpu_torch.formats.parms import builtin_parmsets
from readtape_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(2)

CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(autouse=True)
def no_mesh_left():
    """Neither package keeps a mesh past a test (both are process-wide)."""
    yield
    jmesh.set_decode_mesh(None)
    tmesh.set_decode_mesh(None)


@pytest.mark.parametrize("n,parm", [(8, 1), (8, 2), (8, 3), (6, 4), (4, 2),
                                    (1, 1)])
def test_make_decode_mesh_shape(n, parm):
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} JAX devices")
    jm = jmesh.make_decode_mesh(jax.devices()[:n], parm_axis=parm)
    tm = tmesh.make_decode_mesh(CPU8[:n], parm_axis=parm)
    assert dict(tm.shape) == dict(jm.shape)
    assert tm.axis_names == tuple(jm.axis_names)
    assert [len(r) for r in tm.devices] == [len(r) for r in jm.devices]


def _nrzi_tape():
    """tests/test_multichip.py's production NRZI tape: 12 blocks of 180
    bytes and a tapemark, seed 99."""
    rng = np.random.default_rng(99)
    spec = default_spec(tb.MODE_NRZI, ibg_secs=0.004, start_gap_secs=0.004)
    blocks = [bytes(rng.integers(0, 256, 180, dtype=np.uint8))
              for _ in range(12)]
    items = [("block", b) for b in blocks]
    items.insert(5, ("tapemark",))
    hdr, samples = synthesize_tape(dataclasses.replace(spec, seed=99), items)
    return hdr, samples, dict(mode=tb.MODE_NRZI, bpi=800, ips=50), blocks


def _gcr_tape():
    """tests/test_multichip.py's production GCR tape: 6 blocks of 64
    bytes, seed 7."""
    rng = np.random.default_rng(7)
    spec = default_spec(tb.MODE_GCR, start_gap_secs=0.0008, ibg_secs=0.002)
    blocks = [bytes(rng.integers(0, 256, 64, dtype=np.uint8))
              for _ in range(6)]
    hdr, samples = synthesize_tape(spec, [("block", b) for b in blocks])
    return hdr, samples, dict(mode=tb.MODE_GCR, bpi=9042, ips=25), blocks


def _pe_tape():
    """One PE block of 120 bytes with track 4 dead for ~20 bits
    (tests/test_torch_pe_pipeline.py's dropout recipe): no parmset decodes
    it cleanly, so the retry tries all 8."""
    rng = np.random.default_rng(22)
    block = bytes(rng.integers(0, 256, 120, dtype=np.uint8))
    spec = default_spec(tb.MODE_PE)
    hdr, samples = synthesize_tape(spec, [("block", block)])
    samples = np.array(samples)
    st = int(spec.start_gap_secs / spec.deltat)
    samples[st + 3000:st + 3800, 4] = 0
    return hdr, samples, dict(mode=tb.MODE_PE, bpi=1600, ips=50), None


TAPES = {"nrzi": _nrzi_tape, "gcr": _gcr_tape, "pe": _pe_tape}


def _sig(out):
    return [(b.kind, b.data, b.parmset, b.tries, b.errcount, b.warncount)
            for b in out]


def _spy_shards(monkeypatch):
    """Per dispatch_segment_batch call, the (B, P) of each shard the
    port's group functions ran."""
    batches = []
    orig = tpl.TapeDecoder.dispatch_segment_batch

    def dispatch(self, *a, **k):
        batches.append([])
        return orig(self, *a, **k)
    monkeypatch.setattr(tpl.TapeDecoder, "dispatch_segment_batch", dispatch)
    for name in ("_nrzi_group_fused", "_pe_group_fused", "_gcr_group_fused"):
        def group(*a, _f=getattr(tpl, name), **k):
            batches[-1].append((len(a[1]), len(a[7].clk_window)))
            return _f(*a, **k)
        monkeypatch.setattr(tpl, name, group)
    return batches


@pytest.mark.parametrize("name", sorted(TAPES))
def test_decode_tape_mesh_equals_jax_mesh_and_one_device(name, monkeypatch):
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 JAX devices")
    hdr, samples, kw, blocks = TAPES[name]()
    kw.update(ntrks=9, deltat=hdr.tdelta_ns * 1e-9, maxvolts=hdr.maxvolts)
    one, one_st = tpl.decode_tape(samples, tpl.DecodeOptions(**kw),
                                  device="cpu")
    if name != "pe":
        jmesh.set_decode_mesh(jmesh.make_decode_mesh(jax.devices()[:8],
                                                     parm_axis=2))
    jout, jst = jpl.decode_tape(samples, jpl.DecodeOptions(**kw))
    batches = _spy_shards(monkeypatch)
    tmesh.set_decode_mesh(tmesh.make_decode_mesh(CPU8, parm_axis=2))
    calls = tfu.pe_fused_scan_plain.calls
    got, st = tpl.decode_tape(samples, tpl.DecodeOptions(**kw),
                              device="cpu")
    assert _sig(got) == _sig(jout) == _sig(one)
    for k in ("tried", "chosen", "peak_hist"):
        np.testing.assert_array_equal(st[k], jst[k], err_msg=k)
        np.testing.assert_array_equal(st[k], one_st[k], err_msg=k)
    if blocks is not None:
        assert [b.data for b in got if b.kind == "data"] == blocks
    # every batch split into 4 data slices of one size (padded to a
    # multiple of 4), each whole or in two parm slices
    assert batches and all(len(b) in (4, 8) and len(set(b)) == 1
                           for b in batches), batches
    if name == "pe":
        assert tfu.pe_fused_scan_plain.calls > calls
        assert st["tried"][7] > 0, "the retry did not try all 8 parmsets"
        assert any(len(b) == 8 and b[0][1] == 4 for b in batches), batches


def test_cli_mesh_4x2(tmp_path, monkeypatch, capsys):
    """Both command lines with -mesh=4x2, the JAX one on its 8 virtual
    devices, the port's handed eight CPU devices: .tap and .log equal
    (the time masked), the sharding line in both."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 JAX devices")
    monkeypatch.setattr(tmesh, "visible_devices", lambda device: CPU8)
    hdr, samples, _, blocks = _gcr_tape()
    argv = ["-v", "-m", "-gcr", "-ips=25", "-tap", "-mesh=4x2", "t"]
    logs = {}
    for d, cli, kw in (("j", jcli, {}), ("t", tcli, dict(device="cpu"))):
        (tmp_path / d).mkdir()
        tb.write_tbin(str(tmp_path / d / "t.tbin"), hdr, samples)
        monkeypatch.chdir(tmp_path / d)
        assert cli.main(argv, **kw) == 0
        logs[d] = [ln for ln in (tmp_path / d / "t.log").read_text()
                   .split("\n") if not ln.startswith(("readtape_tpu",
                                                      "version "))
                   and " samples were processed in " not in ln]
    assert tmesh.get_decode_mesh()[0].shape == {"data": 4, "parm": 2}
    assert logs["t"] == logs["j"]
    assert "  sharding segment batches over 8 devices (parm axis 2)" \
        in logs["t"]
    tap = (tmp_path / "t" / "t.tap").read_bytes()
    assert tap == (tmp_path / "j" / "t.tap").read_bytes()
    assert tap.count(blocks[0]) == 1


def test_mesh_of_another_device_type_raises(tmp_path, monkeypatch):
    """A mesh whose devices are not of the decode's type raises ValueError
    before anything is read or written: through decode_tape, TapeDecoder,
    the Whirlwind path, and the command line (whose device list is made
    of meta devices here)."""
    hdr, samples, kw, _ = _nrzi_tape()
    opts = tpl.DecodeOptions(**kw, deltat=hdr.tdelta_ns * 1e-9,
                             maxvolts=hdr.maxvolts)
    tmesh.set_decode_mesh(tmesh.make_decode_mesh(
        [torch.device("meta")] * 4, parm_axis=2))
    with pytest.raises(ValueError, match="meta"):
        tpl.decode_tape(samples, opts, device="cpu")
    with pytest.raises(ValueError, match="meta"):
        tpl.TapeDecoder(samples, opts, device="cpu")
    with pytest.raises(ValueError, match="meta"):
        tpl.decode_tape(samples[:, :6], dataclasses.replace(
            opts, mode=tb.MODE_WW, ntrks=6, bpi=100, ips=30), device="cpu")
    tmesh.set_decode_mesh(None)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tmesh, "visible_devices",
                        lambda device: [torch.device("meta")] * 8)
    with pytest.raises(ValueError, match="meta"):
        tcli.main(["-nrzi", "-mesh=4x2", "missing"], device="cpu")
    assert os.listdir(tmp_path) == []


def test_sharded_decode_step_equals_one_device(monkeypatch):
    """sharded_decode_step over a (2, 2) mesh: B1's plain version on the
    first 4 segments of the NRZI tape (volts as the decode cuts them, the
    whole window read) under parmsets 0 and 2, which share a window
    width, split 2 x 2, equals the one call on the whole batch."""
    hdr, samples, kw, _ = _nrzi_tape()
    dec = tpl.TapeDecoder(samples, tpl.DecodeOptions(
        **kw, ntrks=9, deltat=hdr.tdelta_ns * 1e-9, maxvolts=hdr.maxvolts),
        device="cpu")
    seen = []
    monkeypatch.setattr(tfu, "nrzi_fused_scan", lambda *a, **k: (
        seen.append((a, k)), tfu.nrzi_fused_scan_plain(*a, **k))[1])
    dec.decode_segment_batch(dec.segments()[:4], parm_sel=(0, 2))
    (volts, _, _, pa), k = seen[0]
    assert len(set(k["Ws"])) == 1

    def step(v, spb, parity, w, pa_):
        B, P = v.shape[0], len(pa_.clk_window)
        full = torch.full((B,), v.shape[2], dtype=torch.int32)
        out = tfu.nrzi_fused_scan_plain(
            v, full, torch.zeros_like(full), pa_,
            **dict(k, Ws=(w,) * P, spb=spb, expected_parity=parity))
        return out["bits"], out["lane_i"]

    args = (volts, k["spb"], k["expected_parity"], k["Ws"][0], pa)
    want = step(*args)
    mesh = tmesh.make_decode_mesh(CPU8[:4], parm_axis=2)
    assert mesh.shape == {"data": 2, "parm": 2}
    got = tmesh.sharded_decode_step(mesh, step, len(args))(*args)
    assert int(want[1][..., tfu.LI_NSLOT].min()) > 0
    for w, g in zip(want, got):
        assert torch.equal(w, g)


def test_prepare_refuses_a_tensor_on_another_device():
    """kernels._prepare (B1's argument block) and nrzi_slot_prepare (B6's)
    raise ValueError naming an input that is not on the launch's device,
    rather than pass its pointer on."""
    B, T, S, P = 2, 9, 1024, 2
    pa = ParmArrays.from_parmsets(builtin_parmsets(tb.MODE_NRZI), "cpu")
    pa = pa.select(range(P))
    kw = dict(Ws=(8, 8), rise_floor=torch.zeros(T), min_floor=torch.zeros(T),
              stat_lb=0.0, stat_bw=1.0, expected_parity=1, spb=15.0,
              do_correct=False, maxb=128, max_slots=128, K=64, max_steps=64)
    volts = torch.zeros((B, T, S))
    lens = torch.full((B,), S, dtype=torch.int32)
    kernels.nrzi_prepare(volts, lens, lens, pa, **kw)        # all on cpu
    with pytest.raises(ValueError, match="seg_len"):
        kernels.nrzi_prepare(volts, lens.to("meta"), lens, pa, **kw)
    with pytest.raises(ValueError, match="p_agc_window"):
        kernels.nrzi_prepare(volts, lens, lens, pa.to("meta"), **kw)
    K = 64
    fin = dict(tr_s=torch.zeros((B, P, T, K), dtype=torch.int32),
               tr_t=torch.zeros((B, P, T, K)),
               tr_agc=torch.ones((B, P, T, K)),
               n_admitted=torch.zeros((B, P, T), dtype=torch.int32),
               max_agc_gain=torch.ones((B, P, T)),
               min_agc_gain=torch.ones((B, P, T)),
               incomplete=torch.zeros((B, P, T), dtype=torch.bool))
    skw = dict(S=S, spb=15.0, expected_parity=1, do_correct=False, maxb=128,
               max_slots=128, stat_lb=0.0, stat_bw=1.0)
    kernels.nrzi_slot_prepare(fin["tr_s"], fin, pa, **skw)
    with pytest.raises(ValueError, match="n_admitted"):
        kernels.nrzi_slot_prepare(fin["tr_s"], dict(
            fin, n_admitted=fin["n_admitted"].to("meta")), pa, **skw)
    with pytest.raises(ValueError, match="adj0"):
        kernels.nrzi_slot_prepare(fin["tr_s"], fin, pa, adj_init=(
            torch.zeros(B, P, T), torch.zeros(B, P, T, device="meta")),
            **skw)
