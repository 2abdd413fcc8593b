"""The port's NRZI slot machine alone (readtape_tpu_torch.decode.slot:
B6 nrzi_slot_scan, plain version on the CPU) against the JAX package's
XLA scan nrzi.nrzi_slot_scan, on tests/test_pallas_slot.py's three cases
(one block; three blocks behind short gaps, so the machine ends the first
block at its postamble; 7 tracks) and on one -correct case (the one-block
buffers with one track's first-frame transition removed and its AGC gain
raised, so that -correct flips the bit back). Both scans read the same
transition buffers, made by the JAX package's XLA admission scans.
The port's result is B1's FusedOut, read out by fused.fused_state.

The 3-block and 7-track cases run in test_torch_slot_more.py, so that
xdist runs them beside these.

Then csrc/nrzi_core.h's B6 lane (nrzi_slot_lane: the per-track steps and
per-lane combines that csrc/nrzi_slot.cu runs one track per thread of a
warp, here track by track), compiled for the host with g++, against the
plain version on the same inputs, also on one -correct case whose two
highest AGC gains tie (made-up buffers: nine tracks with a transition at
every bit, checked for even parity), which pins -correct's choice of the
track to flip: the first of the highest. That case is not held to the
JAX package: with all nine tracks in every window, its XLA scan's sum of
the window positions (8 strided partial sums on the CPU, not the track
order of the C program and the port) rounds differently
(scripts/probe_slot_sum_order.py).

Tolerance: none; bits, counts, histograms and f32 times are exact.
"""

import ctypes
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from readtape_tpu.formats import tbin as tb
from readtape_tpu.formats.parms import builtin_parmsets
from readtape_tpu_torch import kernels
from readtape_tpu_torch.decode import fused as tfu
from readtape_tpu_torch.decode import slot as tsl

from test_pallas_slot import _segment_transitions
from test_torch_scan import port_parms, tiered_host_lib  # noqa: F401

torch.set_num_threads(2)

STATE = ("dc", "kvis", "bits", "hist", "trksums", "missed_midbits",
         "corrected_bits", "faked_tracks", "consume_overflow", "end_s",
         "t_firstbit", "t_lastbit")
CASES = {"1blk": (1, 0.002, 9), "3blk": (3, 0.0008, 9), "7trk": (1, 0.002, 7)}


@functools.lru_cache(maxsize=None)
def slot_case(name):
    """(admission outputs fin [1, P, T, ...], pa, slot kwargs, the JAX
    admission's per-parmset transitions, their parmsets)."""
    if name == "tie":
        S, P = 4096, 3
        trans, spb, T = tie_transitions(S, P)
        sets = builtin_parmsets(tb.MODE_NRZI).sets[:P]
    else:
        nblocks, ibg, ntrks = CASES["1blk" if name == "correct" else name]
        S, P = 8192 if nblocks == 1 else 16384, 3
        trans, sets, spb, T, K = _segment_transitions(
            S, P, nblocks=nblocks, ibg=ibg, ntrks=ntrks)
        trans = [{k: np.asarray(x) for k, x in tr.items()} for tr in trans]
    if name == "correct":
        trans = [drop_first_bit(tr, spb) for tr in trans]
    rng = np.random.default_rng(3)

    def stack(k, dt):
        return torch.from_numpy(np.stack([tr[k] for tr in trans])[None]
                                .astype(dt))
    fin = dict(tr_s=stack("tr_s", np.int32), tr_t=stack("tr_t", np.float32),
               tr_agc=stack("tr_agc", np.float32),
               n_admitted=stack("counts", np.int32),
               # copied through to FusedOut's columns
               max_agc_gain=torch.from_numpy(
                   rng.random((1, P, T), np.float32)),
               min_agc_gain=torch.from_numpy(
                   rng.random((1, P, T), np.float32)),
               incomplete=torch.from_numpy(rng.random((1, P, T)) < 0.5))
    kw = dict(S=S, spb=spb, expected_parity=0 if name == "tie" else 1,
              do_correct=name in ("correct", "tie"),
              maxb=int(S / spb * 1.3) + 64,
              max_slots=int(S / spb * 1.25) + 48, stat_lb=0.0, stat_bw=1.0)
    return fin, port_parms(P), kw, trans, sets


TIE = (2, 5)          # the tracks that tie for the highest gain


def tie_transitions(S, P, T=9, nbits=150, spb=19.53125):
    """Transition buffers (the same for each of P parmsets) of nine
    tracks with a transition at every bit, jittered by up to 1.5 samples:
    every frame has odd parity. Every gain is -1.0 but those of the TIE
    tracks, 0.0: checked for even parity, the first slot flips the first
    of the two, the reference's first maximum (a tie can flip only at
    gains <= 0, since the flip needs the highest gain to be at least twice
    the next). Returns (transitions, spb, T)."""
    K = nbits + 8
    rng = np.random.default_rng(7)
    t = (64.0 + spb * np.arange(nbits))[None] + rng.uniform(
        -1.5, 1.5, (T, nbits))
    tr_s = np.full((T, K), 2 ** 30, np.int32)
    tr_t = np.zeros((T, K), np.float32)
    tr_agc = np.ones((T, K), np.float32)
    tr_t[:, :nbits] = t
    tr_s[:, :nbits] = np.ceil(t).astype(np.int32) + 3
    tr_agc[:, :nbits] = -1.0
    tr_agc[list(TIE), :nbits] = 0.0
    tr = dict(tr_s=tr_s, tr_t=tr_t, tr_agc=tr_agc,
              counts=np.full(T, nbits, np.int32))
    assert S > tr_s[:, nbits - 1].max() + 40 * spb
    return [tr] * P, spb, T


def drop_first_bit(tr, spb):
    """The -correct case: one track loses its transition in the block's
    first frame (column 0, which the release binary's parity check reads)
    and an AGC gain of 5.0, more than twice the AGC's cap of 2 that bounds
    the others', so the machine flips that bit back."""
    s, t, agc, n = (tr[k].copy() for k in ("tr_s", "tr_t", "tr_agc",
                                           "counts"))
    first = int(np.argmin(s[:, 0]))
    k = next(k for k in range(len(n)) if k != first and n[k] > 0
             and t[k, 0] < t[first, 0] + spb / 2)
    for buf, fill in ((s, 2 ** 30), (t, 0.0), (agc, 1.0)):
        buf[k, :-1] = buf[k, 1:]
        buf[k, -1] = fill
    n[k] -= 1
    agc[k, :n[k]] = 5.0
    return dict(tr_s=s, tr_t=t, tr_agc=agc, counts=n)


def jax_slot_refs(trans, sets, kw):
    """nrzi.nrzi_slot_scan per parmset, as test_pallas_slot.py calls it."""
    import jax
    from readtape_tpu.decode import nrzi as jnrzi
    refs = []
    for p, tr in zip(sets, trans):
        st = jnrzi.nrzi_slot_scan(
            *(jnp.asarray(tr[k]) for k in ("tr_s", "tr_t", "tr_agc",
                                           "counts")), kw["S"],
            jnp.float32(kw["spb"]), jnp.int32(p.clk_window),
            jnp.float32(p.clk_alpha), jnp.float32(p.pulse_adj),
            jnp.float32(p.midbit), jnp.int32(1), kw["do_correct"],
            kw["maxb"], kw["max_slots"], jnp.float32(0.0), jnp.float32(1.0))
        refs.append(jax.tree.map(np.asarray, st))
    return refs


def check_slot(name):
    fin, pa, kw, trans, sets = slot_case(name)
    refs = jax_slot_refs(trans, sets, kw)
    calls = tsl.nrzi_slot_scan_plain.calls
    out = tsl.nrzi_slot_scan(fin, pa, **kw)
    assert tsl.nrzi_slot_scan_plain.calls == calls + 1
    assert tsl.nrzi_slot_scan.launches == 0
    st = {k: x.numpy() for k, x in tfu.fused_state(out).items()}
    for pi, r in enumerate(refs):
        msg = f"{name} parmset {pi}"
        for k in STATE:
            np.testing.assert_array_equal(st[k][0, pi], r[k],
                                          err_msg=f"{msg} {k}")
        assert r["dc"].max() > 100, "segment decoded too little"
    for k in ("n_admitted", "max_agc_gain", "min_agc_gain", "incomplete"):
        np.testing.assert_array_equal(st[k], fin[k].numpy(), err_msg=k)
    if name == "3blk":        # the machine ended the first block early
        assert (st["end_s"] < kw["S"]).all()
    if name == "correct":
        assert st["corrected_bits"].sum() > 0


@pytest.mark.parametrize("name", ["1blk", "correct"])
def test_slot_matches_jax_xla(name):
    check_slot(name)


@pytest.mark.parametrize("name", ["1blk", "correct", "tie"])
def test_host_slot_lane_matches_plain(tiered_host_lib, name):  # noqa: F811
    fin, pa, kw, _, _ = slot_case(name)
    want = tsl.nrzi_slot_scan_plain(fin, pa, **kw)
    args, got, keep = kernels.nrzi_slot_prepare(fin["tr_s"], fin, pa, **kw)
    tiered_host_lib.slot_host_run(ctypes.byref(args))
    del keep
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(),
                                      err_msg=k)
    if name == "tie":         # one flip, of the first tied track
        lane = want["lane_i"][0]
        assert (lane[:, tfu.LI_CORR] == 1).all()
        assert (lane[:, tfu.LI_FAKED] == 1 << (8 - TIE[0])).all()
