"""The port's Whirlwind module (readtape_tpu_torch.decode.ww, plain
versions on the CPU) against the JAX package's readtape_tpu.decode.ww on
the CPU (its XLA scans), function by function, on the same numpy inputs.

Tolerance: none. Integers, characters and every f32 field are exact.

Cases: parse_ww_order with ignored heads and its errors; ww_track_scan
(``pre=True``) on a noisy 6-track tape with one weak track, under the
exponential AGC of the builtin parmsets, another alpha, and a
min-of-window AGC; merge_transitions with equal detection samples on two
tracks; ww_global_scan with -fluxdir=pos, neg and auto (on a tape whose
second half is inverted, so the direction flips mid-tape), a moving-window
clock, and full character and block records (the clamp to the last
index); the rolling rebase at a small span, which the JAX function reads
from its module's REBASE_SPAN (patched here, the un-jitted function
called); assemble_ww_blocks with and without -reverse.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from readtape_tpu.decode import trackscan as jts
from readtape_tpu.decode import ww as jww
from readtape_tpu.formats import tbin as tb
from readtape_tpu.synth import default_spec, synthesize_tape
from readtape_tpu_torch.decode import common as cm
from readtape_tpu_torch.decode import fused as tfu
from readtape_tpu_torch.decode import pipeline as tpl
from readtape_tpu_torch.decode import trackscan as tts
from readtape_tpu_torch.decode import ww as tww

torch.set_num_threads(2)

ROLES = dict(pri_clk=0, pri_msb=1, pri_lsb=2, alt_clk=3, alt_msb=4,
             alt_lsb=5)                                        # "CMLcml"
GLOBAL_KEYS = ("chars", "datacount", "nblocks", "b_start", "b_end",
               "b_type", "b_t_end", "b_t_base", "b_bitspace", "b_missing1",
               "b_missingclk", "hist", "trksums", "flux", "num_flux_changes",
               "base")


def _noise(rng, hdr, samples, weak):
    x = samples.astype(np.float64)
    x[:, weak] *= 0.4
    x += rng.normal(0.0, 0.05 / hdr.maxvolts * 32767, x.shape)
    return np.clip(np.rint(x), -32767, 32767).astype(np.int16)


@functools.lru_cache(maxsize=None)
def _tape(case):
    """(int16 samples [N, 6], maxvolts, deltat) of a short WW tape."""
    rng = np.random.default_rng(50)
    spec = default_spec(tb.MODE_WW, seed=50)
    w = [int(x) for x in rng.integers(0, 65536, 40)]
    if case == "noisy":
        hdr, samples = synthesize_tape(spec, [("block", w[:24]),
                                              ("tapemark",),
                                              ("block", w[24:])])
        samples = _noise(rng, hdr, samples, weak=2)
    else:
        # "flip": the second half inverted, so the flux direction that
        # -fluxdir=auto finds changes mid-tape
        hdr, a = synthesize_tape(spec, [("block", w[:16]), ("tapemark",)])
        _, b = synthesize_tape(spec, [("block", w[16:32])])
        samples = np.concatenate(
            [a, np.clip(-b.astype(np.int32), -32767, 32767).astype(np.int16)])
    return samples, hdr.maxvolts, hdr.tdelta_ns * 1e-9


@functools.lru_cache(maxsize=None)
def _scan_inputs(case):
    """Prepared volts [6, S] (numpy) and the scan sizes run_pass_single
    derives for them."""
    samples, maxvolts, deltat = _tape(case)
    N, T = samples.shape
    S = -(-N // 2048) * 2048
    raw = np.zeros((T, S), np.int16)
    raw[:, :N] = samples.T
    spb = 1.0 / (100 * 30 * deltat)
    v = tpl._prep_volts(torch.from_numpy(raw), maxvolts, 1.0,
                        torch.zeros(T, dtype=torch.int32),
                        differentiate=False, spb_int=int(spb))
    W = cm.pkww_width_for(0.4, 100, 30, deltat)
    floors = (np.full(T, np.float32(0.2 * 0.9 / 2 * 0.8)),
              np.full(T, np.float32(1.0 * 0.9 / 2 * 0.8)))
    return dict(volts=v.numpy(), W=W, S=S, T=T, N=N, spb=spb,
                nsteps=int(S / spb * 3.2) + 64, K=int(S / spb * 2.5) + 64,
                floors=floors)


VAH = np.array([4.0, 3.5, 2.9, 4.2, 3.9, 4.1], np.float32)


def _jax_track(case, agc_alpha, agc_window):
    import jax
    d = _scan_inputs(case)
    v = jnp.asarray(d["volts"])
    nxt = jts.loose_jump_table(v, d["W"], jnp.asarray(d["floors"][0]),
                               jnp.asarray(d["floors"][1]))
    feat = jts.precompute_window_features(v, d["W"], nxt)
    lane = jax.vmap(lambda ft, nx, vh: jww.ww_track_scan(
        ft, nx, d["W"], d["S"], d["nsteps"], d["K"], 0.2, 1.0, agc_alpha,
        agc_window, vh, pre=True))
    return {k: np.asarray(x)
            for k, x in lane(feat, nxt, jnp.asarray(VAH)).items()}


@functools.lru_cache(maxsize=None)
def _port_track(case, agc_alpha=0.5, agc_window=0):
    d = _scan_inputs(case)
    v = torch.from_numpy(d["volts"])
    T = d["T"]
    nxt = tts.loose_jump_table(v, d["W"], torch.from_numpy(d["floors"][0]),
                               torch.from_numpy(d["floors"][1]))
    feat = tts.precompute_window_features(v, d["W"]).transpose(
        -1, -2).contiguous()

    def knob(x, dt=torch.float32):
        return torch.full((T,), x, dtype=dt)
    return tww.ww_track_scan(
        feat, nxt, d["W"], d["S"], tfu.scan_step_budget(d["nsteps"]),
        d["K"], knob(0.2), knob(1.0), knob(agc_alpha),
        knob(agc_window, torch.int32), torch.from_numpy(VAH))


@pytest.mark.parametrize("order,want", [
    ("CMLcml", None), ("xCxMxLxx", None), ("LmMxcC", None),
    ("Mcml", "primary track 'C'"), ("CMx", "primary track 'L'"),
    ("CMLq", "bad Whirlwind track order symbol")])
def test_parse_ww_order(order, want):
    if want is None:
        assert tww.parse_ww_order(order) == jww.parse_ww_order(order)
        return
    with pytest.raises(ValueError, match=want):
        jww.parse_ww_order(order)
    with pytest.raises(ValueError, match=want):
        tww.parse_ww_order(order)


@pytest.mark.parametrize("agc_alpha,agc_window", [(0.5, 0), (0.3, 0),
                                                  (0.0, 4)])
def test_ww_track_scan_matches_jax(agc_alpha, agc_window):
    want = _jax_track("noisy", agc_alpha, agc_window)
    got = _port_track("noisy", agc_alpha, agc_window)
    for k in ("tr_s", "tr_t", "tr_frac", "tr_top", "n_admitted", "h_sum",
              "h_cnt", "agc_gain", "max_agc_gain", "min_agc_gain",
              "v_lasttop", "v_lastbot", "peakcount", "incomplete"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    assert (got["n_admitted"] > 100).all()


def test_merge_transitions_matches_jax():
    rng = np.random.default_rng(3)
    T, K = 6, 40
    s = np.sort(rng.integers(0, 300, (T, K)), axis=1).astype(np.int32)
    s[:, 30:] = tts.BIG_S                 # unused slots
    s[1, :5] = s[4, :5] = s[0, :5]        # equal s_det on three tracks
    trans = dict(s_det=s, t_peak=rng.normal(size=(T, K)).astype(np.float32),
                 t_frac=rng.normal(size=(T, K)).astype(np.float32),
                 is_top=rng.integers(0, 2, (T, K)).astype(bool))
    cap = T * 30 + 16
    want = jww.merge_transitions({k: jnp.asarray(v)
                                  for k, v in trans.items()}, T, cap)
    got = tww.merge_transitions({k: torch.from_numpy(v)
                                 for k, v in trans.items()}, T, cap)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


def _merged(case):
    """The merged event stream of the port's track scan (numpy)."""
    fin = _port_track(case)
    d = _scan_inputs(case)
    K, T = d["K"], d["T"]
    counts = fin["n_admitted"]
    keep = torch.arange(K) < counts.unsqueeze(-1)
    trans = dict(s_det=torch.where(keep, fin["tr_s"], tts.BIG_S),
                 t_peak=torch.where(keep, fin["tr_t"], 0.0),
                 t_frac=torch.where(keep, fin["tr_frac"], 0.0),
                 is_top=keep & fin["tr_top"])
    mg = tww.merge_transitions(trans, T, min(T * K, int(counts.sum()) + 16))
    return {k: v.numpy() for k, v in mg.items()}


def _global_pair(case, fluxdir, clk_window=0, clk_alpha=0.05, maxchars=None,
                 maxblocks=4096, jax_fn=None, span=tww.REBASE_SPAN):
    d = _scan_inputs(case)
    mg = _merged(case)
    deltat = _tape(case)[2]
    lb, bw = tpl._peakstat_bins(tb.MODE_WW, 1.0 / 3000)
    lb, bw = np.float32(lb / deltat), np.float32(bw / deltat)
    maxchars = maxchars or int(d["N"] / d["spb"]) + 256
    kw = dict(T=d["T"], maxchars=maxchars, maxblocks=maxblocks,
              fluxdir_req=fluxdir, **ROLES)
    want = (jax_fn or jww.ww_global_scan)(
        jnp.asarray(mg["trk"]), jnp.asarray(mg["t_peak"]),
        jnp.asarray(mg["s_det"]), jnp.asarray(mg["is_top"]),
        jnp.asarray(mg["valid"]), jnp.int32(clk_window),
        jnp.float32(clk_alpha), jnp.float32(d["spb"]), jnp.float32(lb),
        jnp.float32(bw), m_frac=jnp.asarray(mg["t_frac"]), **kw)
    got = tww.ww_global_scan(
        *(torch.from_numpy(mg[k]) for k in ("trk", "t_peak", "s_det",
                                            "is_top", "valid")),
        clk_window, clk_alpha, d["spb"], float(lb), float(bw),
        m_frac=torch.from_numpy(mg["t_frac"]), span=span, **kw)
    for k in GLOBAL_KEYS:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    return got


@pytest.mark.parametrize("case,fluxdir", [
    ("noisy", tww.FLUX_NEG), ("noisy", tww.FLUX_POS),
    ("flip", tww.FLUX_AUTO)])
def test_ww_global_scan_matches_jax(case, fluxdir):
    got = _global_pair(case, fluxdir)
    assert int(got["nblocks"]) >= 2 and int(got["datacount"]) > 100
    if case == "flip":
        assert int(got["num_flux_changes"]) >= 1


def test_ww_global_scan_window_clock_and_clamps():
    """A moving-window clock of 7, and records too small for the tape:
    the character and block writes clamp to their last index."""
    got = _global_pair("noisy", tww.FLUX_NEG, clk_window=7, clk_alpha=0.0,
                       maxchars=64, maxblocks=2)
    assert int(got["nblocks"]) > 2 and int(got["datacount"]) == 64


def test_ww_rebase_small_span(monkeypatch):
    """The rolling base at a span of 2^12 samples: it moves several times
    on this tape, on both sides."""
    span = 1 << 12
    monkeypatch.setattr(jww, "REBASE_SPAN", span)
    got = _global_pair("noisy", tww.FLUX_NEG,
                       jax_fn=jww.ww_global_scan.__wrapped__, span=span)
    s = _merged("noisy")["s_det"]
    s = s[s < tts.BIG_S]
    moves, base = 0, 0
    for x in s:
        if x - base > span:
            base, moves = x, moves + 1
    assert moves >= 2 and int(got["base"]) == base > 0


@pytest.mark.parametrize("reverse", [False, True])
def test_assemble_ww_blocks_matches_jax(reverse):
    d = _scan_inputs("noisy")
    res = {k: v.numpy() for k, v in _global_pair("noisy",
                                                 tww.FLUX_NEG).items()}
    want = jww.assemble_ww_blocks(res, d["spb"], reverse)
    got = tww.assemble_ww_blocks(res, d["spb"], reverse)
    assert got == want
    assert any(b["kind"] == "tapemark" for b in got)
    assert sum(len(b["data"]) for b in got) > 50
