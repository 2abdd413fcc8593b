"""-trace in the port (readtape_tpu_torch, plain versions on the CPU)
against the JAX package, event for event. The JAX package has no test of
its own -trace; these pin it too.

- TapeDecoder.trace_lanes (NRZI 9 and 7 track, PE, GCR) and
  ww_trace_lanes: the volts and every lane equal the JAX functions' on
  one-block default_spec tapes, over the default -trace window (the first
  10,000 samples) and, for PE and GCR, a window of seconds past the
  lead-in; NRZI also on tests/test_torch_correctdbg.py's flipped-bit tape,
  whose flipped bit gives a parity error inside a block. Every lane the
  modes write carries events in some case;
- each plain debug stream against its JAX counterpart on the same
  inputs: pe_track_scan's and gcr_track_scan's debug_peaks records,
  nrzi_slot_scan's debug records and ww_global_scan's character times;
  PE's records are the same whatever its idle fields (t_lp_virtual,
  s_first_check);
- B6's and B4's plain versions give the decode's outputs with their
  records on or off.

The JAX side runs as its own code runs on the CPU (XLA scans). The port
follows B4 and the C program in running WW's admission to the window's
end; the JAX ww_trace_lanes stops each track after int(S / spb * 3.2) +
64 steps, which these windows never reach (asserted). Tolerance: none.
The command lines' .trace.csv files: tests/test_torch_trace_cli.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from readtape_tpu.decode import common as jcm
from readtape_tpu.decode import gcr as jgcr
from readtape_tpu.decode import nrzi as jnrzi
from readtape_tpu.decode import pe as jpe
from readtape_tpu.decode import pipeline as jpl
from readtape_tpu.decode import trackscan as jts
from readtape_tpu.decode import ww as jww
from readtape_tpu.formats import tbin as tb
from readtape_tpu.out.trace import LANES
from readtape_tpu.synth import default_spec, synthesize_tape
from readtape_tpu_torch.decode import fused as tfu
from readtape_tpu_torch.decode import gcr as tgcr
from readtape_tpu_torch.decode import pe as tpe
from readtape_tpu_torch.decode import pipeline as tpl
from readtape_tpu_torch.decode import slot as tsl
from readtape_tpu_torch.decode import ww as tww

torch.set_num_threads(2)

BPI = {tb.MODE_NRZI: 800, tb.MODE_PE: 1600, tb.MODE_GCR: 9042,
       tb.MODE_WW: 100}


def _opts(pl, hdr, mode):
    return pl.DecodeOptions(mode=mode, ntrks=hdr.ntrks, bpi=BPI[mode],
                            ips=hdr.ips, deltat=hdr.tdelta_ns * 1e-9,
                            maxvolts=hdr.maxvolts)


def _one_block(mode, **kw):
    rng = np.random.default_rng(15)
    if mode == tb.MODE_WW:
        words = [int(w) for w in rng.integers(0, 65536, 24)]
        data = b"".join(bytes([w >> 8, w & 0xFF]) for w in words)
    else:
        top = 64 if kw.get("ntrks") == 7 else 256     # 6 data bits at 7
        data = rng.integers(0, top, 60, dtype=np.uint8).tobytes()
    return synthesize_tape(default_spec(mode, **kw), [("block", data)])


def _window(hdr, n, secs):
    """-trace's sample window: [0, min(N, 10000)), or the seconds a, b."""
    if secs is None:
        return 0, min(n, 10000)
    dt = hdr.tdelta_ns * 1e-9
    return int(secs[0] / dt), min(n, int(secs[1] / dt))


# name: (mode, tape, -trace seconds or None for the default window)
CASES = {
    "nrzi9": (tb.MODE_NRZI, lambda: _one_block(tb.MODE_NRZI), None),
    "nrzi7": (tb.MODE_NRZI, lambda: _one_block(tb.MODE_NRZI, ntrks=7), None),
    "nrzi9_flipped": (tb.MODE_NRZI,
                      lambda: chip_smoke.flipped_bit_tape()[1:], None),
    "pe": (tb.MODE_PE, lambda: _one_block(tb.MODE_PE), (0.0035, 0.0095)),
    "gcr": (tb.MODE_GCR, lambda: _one_block(tb.MODE_GCR), (0.004, 0.0095)),
    "ww": (tb.MODE_WW, lambda: _one_block(tb.MODE_WW), None),
}


_WW_CALL = []       # the WW trace's ww_fused_scan_plain call (volts, kw)


@functools.lru_cache(maxsize=None)
def _traces(case):
    """((port volts, lanes), (JAX volts, lanes), port WW admission steps
    or None, the JAX WW step cap)."""
    mode, make, secs = CASES[case]
    hdr, samples = make()
    a, b = _window(hdr, len(samples), secs)
    topt, jopt = _opts(tpl, hdr, mode), _opts(jpl, hdr, mode)
    if mode != tb.MODE_WW:
        port = tpl.TapeDecoder(samples, topt, device="cpu").trace_lanes(a, b)
        return port, jpl.TapeDecoder(samples, jopt).trace_lanes(a, b), None, 0
    seen = []
    plain = tfu.ww_fused_scan_plain

    def spy(volts, **kw):
        out = plain(volts, **kw)
        seen.append(out["trk_i"][:, tfu.WT_STEPS].numpy())
        _WW_CALL.append((volts, kw))
        return out
    spy.calls = plain.calls
    tfu.ww_fused_scan_plain = spy
    try:
        port = tpl.ww_trace_lanes(samples, topt, a, b, device="cpu")
    finally:
        plain.calls = spy.calls
        tfu.ww_fused_scan_plain = plain
    S = tpl.seg.bucket_length(b - a)
    cap = int(S / topt.spb * 3.2) + 64
    return port, jpl.ww_trace_lanes(samples, jopt, a, b), seen[0], cap


@pytest.mark.parametrize("case", list(CASES))
def test_trace_lanes_equal_jax(case):
    (pv, pl), (jv, jl), steps, cap = _traces(case)
    assert pv.dtype == jv.dtype and pv.shape == jv.shape
    np.testing.assert_array_equal(pv, jv)
    assert sorted(pl) == sorted(jl)
    for name in jl:
        assert pl[name] == jl[name], name
    if steps is not None:
        # where the JAX ww_trace_lanes' admission cap would bind, the two
        # differ by design
        assert steps.max() < cap


def test_every_lane_has_events():
    mode_name = {tb.MODE_NRZI: "nrzi", tb.MODE_PE: "pe",
                 tb.MODE_GCR: "gcr", tb.MODE_WW: "ww"}
    counts = {}
    for case, (mode, _, _) in CASES.items():
        lanes = _traces(case)[0][1]
        for name, modes, per_trk, _ in LANES:
            if mode_name[mode] not in modes:
                continue
            ev = lanes[name]
            n = sum(len(x) for x in ev) if per_trk else len(ev)
            counts[name] = counts.get(name, 0) + n
    assert sorted(counts) == sorted(name for name, *_ in LANES)
    assert all(counts.values()), counts
    assert len(_traces("nrzi9_flipped")[0][1]["parerr"]) > len(
        _traces("nrzi9")[0][1]["parerr"])


# ---------------------------------------------------------------------------
# the plain debug streams against the JAX package's
# ---------------------------------------------------------------------------

def _window_inputs(case):
    """The trace window of a case as both trace_lanes prepare it: the
    port's decoder, the volts [T, S] (torch), the loose floors [T] and
    the JAX jump table [T, S+1]."""
    mode, make, secs = CASES[case]
    hdr, samples = make()
    a, b = _window(hdr, len(samples), secs)
    opts = _opts(tpl, hdr, mode)
    dec = tpl.TapeDecoder(samples, opts, device="cpu")
    S = tpl.seg.bucket_length(b - a)
    v = torch.nn.functional.pad(dec.tape[:, a:b], (0, S - (b - a)))
    vf = tpl._prep_volts(v, opts.maxvolts, 1.0,
                         torch.zeros(opts.ntrks, dtype=torch.int32),
                         differentiate=False, spb_int=int(opts.spb))
    p0 = opts.parmsets[0]
    scale = min(1.0, dec.h_est / tpl.cm.PKWW_PEAKHEIGHT)
    floors = [torch.full((opts.ntrks,), x * scale / 2 * 0.8)
              for x in (p0.pkww_rise, p0.min_peak)]
    W = tpl.cm.pkww_width_for(p0.pkww_bitfrac, opts.bpi, opts.ips,
                              opts.deltat)
    nxt = jts.loose_jump_table(jnp.asarray(vf.numpy()), W,
                               *(jnp.asarray(f.numpy()) for f in floors))
    return dec, vf.contiguous(), floors, nxt, W, S


def _idle_scan_inputs(case):
    dec, vf, floors, nxt, W, S = _window_inputs(case)
    opts = dec.opts
    lb, bw = tpl._peakstat_bins(opts.mode, 1.0 / (opts.bpi * opts.ips))
    return dict(dec=dec, vf=vf, floors=floors, nxt=nxt, W=W, S=S,
                p0=opts.parmsets[0], spb=opts.spb,
                maxb=int(S / opts.spb * 1.3) + 64,
                nsteps=max(512, S // 4), lb=lb / opts.deltat,
                bw=bw / opts.deltat)


def _port_records(scan, x, trace_scan=True, **over):
    """The port's per-track -trace scan (fused.pe_scan_lanes or
    gcr_scan_lanes) over the window; returns its streams [T, steps]."""
    T = x["vf"].shape[0]
    kw = dict(Ws=(x["W"],), rise_floor=x["floors"][0],
              min_floor=x["floors"][1],
              stat_lb=float(np.float32(x["lb"])),
              stat_bw=float(np.float32(x["bw"])), spb=x["spb"],
              maxb=x["maxb"], max_steps=tfu.scan_step_budget(x["nsteps"]),
              trace_scan=trace_scan)
    kw.update(over)
    fin, _ = scan(x["vf"][None], torch.tensor([x["S"]], dtype=torch.int32),
                  torch.zeros(1, dtype=torch.int32), x["dec"].pa.select([0]),
                  **kw)
    return {k: v.reshape((T,) + v.shape[2:]) for k, v in fin.items()
            if k.startswith("_st_")}


def _assert_records_equal(got, want, names):
    for k in names:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)


def test_pe_debug_peaks_equal_jax():
    x = _idle_scan_inputs("pe")
    p0 = x["p0"]
    lane = jax.vmap(lambda vt, nx: jpe.pe_track_scan(
        vt, nx, x["W"], x["S"], x["nsteps"], jnp.float32(p0.pkww_rise),
        jnp.float32(p0.min_peak), jnp.float32(p0.agc_alpha),
        jnp.int32(p0.agc_window), jnp.int32(p0.clk_window),
        jnp.float32(p0.clk_alpha), jnp.float32(p0.clk_factor),
        jnp.float32(p0.pulse_adj), jnp.float32(x["spb"]), x["maxb"],
        debug_peaks=True))
    want = jax.tree.map(np.asarray, lane(jnp.asarray(x["vf"].numpy()),
                                         x["nxt"]))
    got = tpe.debug_peaks(_port_records(tfu.pe_scan_lanes, x), x["maxb"])
    _assert_records_equal(got, want, ("n_admitted", "tr_s", "tr_t", "tr_top",
                                      "tr_isdata", "tr_clkw", "tr_bitval"))
    assert int(want["n_admitted"].sum()) > 1000
    assert want["tr_isdata"].any() and not want["tr_isdata"].all()


def test_pe_debug_peaks_ignore_idle_fields():
    """The records do not read t_lp_virtual or s_first_check: the JAX
    trace's (0.0 and none) and the decode's (each track's staggered
    start lead + t and one later) give the same."""
    x = _idle_scan_inputs("pe")
    T = x["vf"].shape[0]
    feat, nxt, src, pl, lead_l, _ = tfu._track_lanes(
        x["vf"][None], torch.tensor([x["S"]], dtype=torch.int32),
        torch.zeros(1, dtype=torch.int32), (x["W"],), *x["floors"],
        stagger=False)
    pa = x["dec"].pa.select([0])
    knobs = [getattr(pa, k)[pl] for k in (
        "pkww_rise", "min_peak", "agc_alpha", "agc_window", "clk_window",
        "clk_alpha", "clk_factor", "pulse_adj")]
    got = []
    for t_lp, first in ((torch.zeros(T), torch.zeros(T, dtype=torch.long)),
                        (lead_l.float() + 3, lead_l + 4)):
        fin = tpe.pe_track_scan(
            feat, src, nxt, src, torch.full((T,), x["W"], dtype=torch.int32),
            x["S"], tfu.scan_step_budget(x["nsteps"]), *knobs, x["spb"],
            x["maxb"], 0.0, 1.0, t_lp_virtual=t_lp, s_first_check=first,
            clk_ring=1, agc_ring=max(int(pa.agc_window.max()), 1),
            debug=True)
        got.append(tpe.debug_peaks(fin, x["maxb"]))
    _assert_records_equal(got[0], got[1], list(got[1]))


def test_gcr_debug_peaks_equal_jax():
    x = _idle_scan_inputs("gcr")
    p0 = x["p0"]
    lane = jax.vmap(lambda vt, nx: jgcr.gcr_track_scan(
        vt, nx, x["W"], x["S"], x["nsteps"], jnp.float32(p0.pkww_rise),
        jnp.float32(p0.min_peak), jnp.float32(p0.agc_alpha),
        jnp.int32(p0.agc_window), jnp.int32(p0.clk_window),
        jnp.float32(p0.clk_alpha), jnp.float32(p0.z1pt),
        jnp.float32(p0.z2pt), jnp.float32(p0.pulse_adj),
        jnp.float32(x["spb"]), x["maxb"], jnp.float32(x["lb"]),
        jnp.float32(x["bw"]), debug_peaks=True))
    want = jax.tree.map(np.asarray, lane(jnp.asarray(x["vf"].numpy()),
                                         x["nxt"]))
    got = tgcr.debug_peaks(_port_records(tfu.gcr_scan_lanes, x), x["maxb"])
    _assert_records_equal(got, want, ("n_admitted", "tr_s", "tr_t", "tr_top",
                                      "tr_nzeros", "tr_padj"))
    assert (want["tr_nzeros"] > 0).any() and (want["tr_padj"] != 0).any()


def _nrzi_admitted(case):
    """The JAX trace's NRZI admission over the window: (port decoder,
    its finals as numpy, S, spb, parmset 0)."""
    dec, vf, floors, nxt, W, S = _window_inputs(case)
    p0 = dec.opts.parmsets[0]
    lane = jax.vmap(lambda vt, nx: jts.nrzi_track_scan(
        vt, nx, W, S, max(512, S // 4), max(512, S // 6), p0.pkww_rise,
        p0.min_peak, p0.agc_alpha, p0.agc_window))
    fin = jax.tree.map(np.asarray, lane(jnp.asarray(vf.numpy()), nxt))
    return dec, fin, S


@pytest.mark.parametrize("case", ["nrzi9", "nrzi9_flipped"])
def test_nrzi_slot_debug_equals_jax(case):
    dec, fin, S = _nrzi_admitted(case)
    opts = dec.opts
    p0 = opts.parmsets[0]
    spb = opts.spb
    K = fin["tr_s"].shape[-1]
    keep = np.arange(K) < fin["n_admitted"][:, None]
    maxb = int(S / spb * 1.3) + 64
    max_slots = int(S / spb * 1.25) + 48
    lb, bw = tpl._peakstat_bins(opts.mode, 1.0 / (opts.bpi * opts.ips))
    tr = dict(tr_s=np.where(keep, fin["tr_s"], jnrzi.BIG_S),
              tr_t=np.where(keep, fin["tr_t"], 0.0).astype(np.float32),
              tr_agc=np.where(keep, fin["tr_agc"], 1.0).astype(np.float32))
    want = jax.tree.map(np.asarray, jnrzi.nrzi_slot_scan(
        *(jnp.asarray(tr[k]) for k in ("tr_s", "tr_t", "tr_agc")),
        jnp.asarray(fin["n_admitted"]), S, jnp.float32(spb),
        jnp.int32(p0.clk_window), jnp.float32(p0.clk_alpha),
        jnp.float32(p0.pulse_adj), jnp.float32(p0.midbit),
        jnp.int32(opts.expected_parity), False, maxb, max_slots,
        jnp.float32(lb / opts.deltat), jnp.float32(bw / opts.deltat),
        debug=True))
    T = opts.ntrks
    got = tsl.nrzi_slot_scan(
        dict(tr_s=torch.from_numpy(tr["tr_s"].astype(np.int32))[None, None],
             tr_t=torch.from_numpy(tr["tr_t"])[None, None],
             tr_agc=torch.from_numpy(tr["tr_agc"])[None, None],
             n_admitted=torch.from_numpy(fin["n_admitted"])[None, None],
             max_agc_gain=torch.ones(1, 1, T), min_agc_gain=torch.ones(1, 1, T),
             incomplete=torch.zeros(1, 1, T, dtype=torch.bool)),
        dec.pa.select([0]), S=S, spb=spb,
        expected_parity=opts.expected_parity, do_correct=False, maxb=maxb,
        max_slots=max_slots, stat_lb=float(np.float32(lb / opts.deltat)),
        stat_bw=float(np.float32(bw / opts.deltat)), clk_avg_fma=True,
        records=True)
    live = want["dbg_live"]
    n = int(live.sum())
    assert live[:n].all() and int(got["lane_i"][0, 0, tsl.LI_NSLOT]) == n
    slot_f = got["slot_f"][0, 0].numpy()
    np.testing.assert_array_equal(slot_f[:n, tsl.SL_ZC], want["dbg_zc"][:n])
    np.testing.assert_array_equal(slot_f[:n, tsl.SL_AVGPOS],
                                  want["dbg_avgpos"][:n])
    assert not slot_f[n:].any()
    np.testing.assert_array_equal(got["col_slot"][0, 0].numpy(),
                                  want["dbg_col_slot"])
    np.testing.assert_array_equal(got["bits"][0, 0].numpy(), want["bits"])


def test_ww_global_scan_char_times_equal_jax():
    mode, make, _ = CASES["ww"]
    hdr, samples = make()
    opts = _opts(jpl, hdr, mode)
    # the machine alone, on events the JAX admission and merge give
    type_to_trk, _, T = jww.parse_ww_order(opts.ww_order)
    v = jnp.asarray(samples.T.astype(np.float32) * (hdr.maxvolts / 32767))
    W = jcm.pkww_width_for(opts.parmsets[0].pkww_bitfrac, opts.bpi,
                           opts.ips, opts.deltat)
    S = v.shape[1]
    floor = jnp.full(T, 0.02, jnp.float32)
    nxt = jts.loose_jump_table(v, W, floor, floor)
    feat = jts.precompute_window_features(v, W, nxt)
    p0 = opts.parmsets[0]
    K = int(S / opts.spb * 2.5) + 64
    fin = jax.tree.map(np.asarray, jax.vmap(lambda ft, nx: jww.ww_track_scan(
        ft, nx, W, S, S + 1, K, p0.pkww_rise, p0.min_peak, p0.agc_alpha,
        p0.agc_window, jnp.float32(jcm.PKWW_PEAKHEIGHT), pre=True))(
            feat, nxt))
    keep = np.arange(K) < fin["n_admitted"][:, None]
    merged = jww.merge_transitions(
        dict(s_det=jnp.where(keep, fin["tr_s"], jnrzi.BIG_S),
             t_peak=jnp.where(keep, fin["tr_t"], 0.0),
             t_frac=jnp.where(keep, fin["tr_frac"], 0.0),
             is_top=jnp.where(keep, fin["tr_top"], False)), T,
        int(fin["n_admitted"].sum()) + 16)
    lb, bw = tpl._peakstat_bins(mode, 1.0 / (opts.bpi * opts.ips))
    roles = dict(zip(tww.ROLES, (type_to_trk[k]
                                 for k in range(len(tww.ROLES)))))
    maxchars = int(S / opts.spb) + 256
    want = jax.tree.map(np.asarray, jww.ww_global_scan(
        merged["trk"], merged["t_peak"], merged["s_det"], merged["is_top"],
        merged["valid"], jnp.int32(p0.clk_window), jnp.float32(p0.clk_alpha),
        jnp.float32(opts.spb), jnp.float32(lb / opts.deltat),
        jnp.float32(bw / opts.deltat), T=T, maxchars=maxchars,
        maxblocks=64, fluxdir_req=jww.FLUX_NEG, debug_times=True,
        m_frac=merged["t_frac"], **roles))
    m = {k: torch.from_numpy(np.asarray(merged[k])) for k in merged}
    got = tww.ww_global_scan(
        m["trk"], m["t_peak"], m["s_det"], m["is_top"], m["valid"],
        p0.clk_window, p0.clk_alpha, opts.spb, lb / opts.deltat,
        bw / opts.deltat, T=T, maxchars=maxchars, maxblocks=64,
        fluxdir_req=tww.FLUX_NEG, m_frac=m["t_frac"], debug_times=True,
        **roles)
    nchars = int(want["datacount"])
    assert nchars > 50 and int(got["datacount"]) == nchars
    np.testing.assert_array_equal(got["chars"].numpy()[:nchars],
                                  want["chars"][:nchars])
    np.testing.assert_array_equal(got["char_t"].numpy()[:nchars],
                                  want["char_t"][:nchars])


@pytest.mark.parametrize("which", ["slot", "ww"])
def test_records_leave_outputs_unchanged(which):
    """B6's and B4's plain versions: the decode's outputs are the same
    with the records on as off (PE's and GCR's record mode is another
    scan, the JAX trace's)."""
    if which == "slot":
        dec, fin, S = _nrzi_admitted("nrzi9")
        T = dec.opts.ntrks
        args = (dict(
            tr_s=torch.from_numpy(fin["tr_s"].astype(np.int32))[None, None],
            tr_t=torch.from_numpy(fin["tr_t"])[None, None],
            tr_agc=torch.from_numpy(fin["tr_agc"])[None, None],
            n_admitted=torch.from_numpy(fin["n_admitted"])[None, None],
            max_agc_gain=torch.ones(1, 1, T),
            min_agc_gain=torch.ones(1, 1, T),
            incomplete=torch.zeros(1, 1, T, dtype=torch.bool)),
            dec.pa.select([0]))
        spb = dec.opts.spb
        kw = dict(S=S, spb=spb, expected_parity=1, do_correct=False,
                  maxb=int(S / spb * 1.3) + 64,
                  max_slots=int(S / spb * 1.25) + 48, stat_lb=0.0,
                  stat_bw=1.0)
        off = tsl.nrzi_slot_scan(*args, **kw)
        on = tsl.nrzi_slot_scan(*args, records=True, **kw)
    else:
        _traces("ww")
        volts, kw = _WW_CALL[0]
        kw = dict(kw, records=False)
        off = tfu.ww_fused_scan(volts, **kw)
        on = tfu.ww_fused_scan(volts, **dict(kw, records=True))
    assert set(on) - set(off)
    for k in off:
        np.testing.assert_array_equal(on[k].numpy(), off[k].numpy(),
                                      err_msg=k)
