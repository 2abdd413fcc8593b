"""The Whirlwind kernel's logic (readtape_tpu_torch/csrc/ww_core.h: the
candidacy words, each track's admission walk, the rank pass that merges
the records, and the machine with its flush), compiled for the host with
g++ and run in the kernel's phase order, must equal the plain PyTorch
version (fused.ww_fused_scan_plain) exactly: every character, block
record, histogram entry, count and float. This is the kernel's logic
checked without a GPU; the CUDA build itself runs only on the card
(chip_smoke.py). Nothing at run time uses this host build.

The host driver walks each track chunk by chunk, as the kernel does, over
window features it computes for each chunk with a plain loop (the rows it
did not compute hold NaN), with the kernel's chunk of 2048 samples and
with one of 64, so that blind jumps and candidate searches cross
thousands of chunk boundaries.

Cases: the calls decode_tape makes on a noisy tape (chip_smoke.ww_tape
with shorter blocks, -fluxdir=auto); the same inputs with a rolling-base
span of 2^12 samples; with a moving-window clock, a min-of-window AGC
and character and block records too small for the tape; and both passes
of a -deskew decode. The rank pass alone is held to the T-way merge by
(s, track) on records with equal samples across tracks, empty tracks,
one track holding every record, and overflowing record buffers."""

import ctypes
import dataclasses
import shutil
import subprocess

import numpy as np
import pytest
import torch

import chip_smoke
from readtape_tpu_torch import kernels
from readtape_tpu_torch.decode import fused as tfu
from readtape_tpu_torch.decode import pipeline as tpl

torch.set_num_threads(2)

_HOST_SRC = r"""
#include <math.h>
#include <vector>
#include "ww_core.h"

extern "C" void ww_host_rank(const WwArgs* a) {
  for (int t = 0; t < a->T; ++t)
    for (int k = 0; k < ww_nrec(*a, t); ++k) ww_scatter_one(*a, t, k);
}

// track t's walk chunk by chunk, over feature rows computed per chunk
template <bool REC>
static void walk_track(const WwArgs* a, int t, int C, std::vector<NrziFeat>& rows,
                       const NrziFeat& poison, float* heights) {
  const int nw = ww_nwords(*a), S = a->S;
  const float* v = a->volts + (int64_t)t * S;
  const uint32_t* cw = a->cand + (int64_t)t * nw;
  WwWalkT<REC> w;
  ww_walk_init(w, *a, t, heights);
  for (int c0 = 0; c0 < S; c0 += C) {
    const int c1 = c0 + C < S ? c0 + C : S;
    for (int i = 0; i < C; ++i) rows[i] = poison;
    nrzi_feature_rows(v, 0, S, a->W, cw + (c0 >> 5), c0, c1, rows.data(), 0, 1);
    ww_walk_chunk(w, cw + (c0 >> 5), rows.data(), c0, c1, S);
  }
  ww_walk_finish(w, *a, t);
}

// the kernel's phase order, the admission in chunks of C samples
extern "C" void ww_host_run(const WwArgs* a, int C) {
  const int nw = ww_nwords(*a), S = a->S;
  for (int i = 0; i < a->T * nw; ++i)
    a->cand[i] = ww_cand_word(*a, i / nw, i % nw);
  std::vector<NrziFeat> rows(C);
  NrziFeat poison;
  poison.wmax = poison.wmin = poison.vleft = poison.vright = NAN;
  poison.prevmax = poison.nextmax = poison.prevmin = poison.nextmin = NAN;
  poison.ltop = poison.lbot = -1000000;
  float heights[WW_AGC_RING];
  // the record mode's walk and machine, or the decode's (the kernels'
  // instantiations)
  for (int t = 0; t < a->T; ++t) {
    if (a->tr_t)
      walk_track<true>(a, t, C, rows, poison, heights);
    else
      walk_track<false>(a, t, C, rows, poison, heights);
  }
  ww_host_rank(a);
  WwMachineMem mem;
  WwMachine m;
  ww_machine_init(m, *a, &mem);
  const int n = ww_nevents(*a);
  for (int j = 0; j < n; ++j) {
    if (a->tr_t)
      ww_event<true>(m, *a, a->ev_s[j], a->ev_frac[j], a->ev_tt[j]);
    else
      ww_event<false>(m, *a, a->ev_s[j], a->ev_frac[j], a->ev_tt[j]);
  }
  ww_machine_finish(m, *a);
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not available")
    d = tmp_path_factory.mktemp("ww_host")
    src = d / "host_run.cpp"
    src.write_text(_HOST_SRC)
    so = d / "libww_host.so"
    subprocess.run([gxx, "-O2", "-ffp-contract=off", "-std=c++17", "-shared",
                    "-fPIC", "-I", kernels.CSRC, "-o", str(so), str(src)],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    lib.ww_host_run.argtypes = [ctypes.POINTER(kernels.WwArgs), ctypes.c_int]
    lib.ww_host_run.restype = None
    lib.ww_host_rank.argtypes = [ctypes.POINTER(kernels.WwArgs)]
    lib.ww_host_rank.restype = None
    return lib


def _calls(case, monkeypatch):
    """[(args, kwargs, plain outputs)] of ww_fused_scan_plain calls."""
    if case == "deskew":
        hdr, samples = chip_smoke.ww_deskew_tape()
        opts = chip_smoke.ww_options(hdr, deskew=True)
    else:
        _, hdr, samples = chip_smoke.ww_tape(sizes=(24, 40, 16))
        opts = chip_smoke.ww_options(hdr, "auto")
    seen = []
    plain = tfu.ww_fused_scan_plain

    def record(*a, **k):
        out = plain(*a, **k)
        seen.append((a, k, out))
        return out
    record.calls = plain.calls
    monkeypatch.setattr(tfu, "ww_fused_scan_plain", record)
    tpl.decode_tape(samples, opts, device="cpu")
    if case == "rebase":
        return [(a, dict(k, span=1 << 12), plain(*a, **dict(k, span=1 << 12)))
                for a, k, _ in seen]
    if case == "windows":
        out = []
        for a, k, _ in seen:
            p = dataclasses.replace(k["parms"], clk_window=7, clk_alpha=0.0,
                                    agc_window=4, agc_alpha=0.0)
            k = dict(k, parms=p, maxchars=100, maxblocks=2)
            out.append((a, k, plain(*a, **k)))
        return out
    return seen


_PLAIN = {}


def _plain_calls(case, monkeypatch):
    """_calls, once per case for the module (the plain decode is slow)."""
    if case not in _PLAIN:
        _PLAIN[case] = _calls(case, monkeypatch)
    return _PLAIN[case]


@pytest.mark.parametrize("chunk", [2048, 64])
@pytest.mark.parametrize("case", ["noisy_auto", "rebase", "windows",
                                  "deskew"])
def test_host_machine_matches_plain(host_lib, case, chunk, monkeypatch):
    calls = _plain_calls(case, monkeypatch)
    assert len(calls) == (2 if case == "deskew" else 1)
    for a, kw, want in calls:
        args, got, keep = kernels.ww_prepare(*a, **kw)
        host_lib.ww_host_run(ctypes.byref(args), chunk)
        del keep
        for k in want:
            # floats are bit-equal: same operations in the same order
            np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(),
                                          err_msg=k)
        sc = want["scal"]
        assert int(sc[tfu.WS_NBLOCKS]) >= 2 and int(sc[tfu.WS_NEVENTS]) > 1000
        if chunk == 64:                    # chunk boundaries, all tracks
            T, S = a[0].shape
            assert T * (S // chunk) > 2000
    if case == "rebase":
        assert int(sc[tfu.WS_BASE]) > 0
    if case == "windows":
        assert int(sc[tfu.WS_NBLOCKS]) > 2 and int(sc[tfu.WS_DATACOUNT]) == 100


def _tway_merge(tr_s, counts, K):
    """The records in (s, track) order by the T-way merge the machine's
    loop used to run: [(track, k)]."""
    lim = [min(int(c), K) for c in counts]
    k = [0] * len(lim)
    order = []
    while True:
        best, bs = -1, None
        for t in range(len(lim)):          # lower track first on equal s
            if k[t] < lim[t] and (bs is None or tr_s[t, k[t]] < bs):
                best, bs = t, tr_s[t, k[t]]
        if best < 0:
            return order
        order.append((best, k[best]))
        k[best] += 1


def _rank_case(name, rng):
    """(tr_s [T, K], admission counts [T], K) of a rank-pass case: each
    track's records ascending, the last admission in slot K-1 once a
    track overflows."""
    T, K = 6, 40
    counts = np.zeros(T, np.int64)
    tr_s = np.full((T, K), 2 ** 30, np.int64)

    def fill(t, s):
        s = np.sort(np.asarray(s))
        counts[t] = len(s)
        if len(s) > K:                     # compact_outputs' overflow
            s = np.concatenate([s[:K - 1], s[-1:]])
        tr_s[t, :len(s)] = s
    if name == "equal_s":
        base = rng.choice(np.arange(0, 400, 2), size=30, replace=False)
        for t in range(T):
            extra = rng.choice(np.arange(1, 400, 2), size=5, replace=False)
            fill(t, np.concatenate([base[:20 + t], extra + 1000 * t]))
    elif name == "empty_tracks":
        for t in (1, 4):
            fill(t, rng.choice(1000, size=25, replace=False))
    elif name == "one_track":
        fill(3, rng.choice(1000, size=K, replace=False))
    elif name == "overflow":
        for t in range(T):
            fill(t, rng.choice(5000, size=[K + 17, 3, K, 0, 2 * K, 9][t],
                               replace=False))
    return tr_s, counts, K


@pytest.mark.parametrize("name", ["equal_s", "empty_tracks", "one_track",
                                  "overflow"])
def test_host_rank_pass_matches_tway_merge(host_lib, name):
    rng = np.random.default_rng(7)
    tr_s, counts, K = _rank_case(name, rng)
    T = tr_s.shape[0]
    frac = rng.uniform(-10, 0, size=(T, K)).astype(np.float32)
    top = rng.integers(0, 2, size=(T, K)).astype(np.int8)
    trk_i = np.zeros((T, 4), np.int32)
    trk_i[:, tfu.WT_NADM] = counts
    bufs = dict(tr_s=np.ascontiguousarray(tr_s, np.int32), tr_frac=frac,
                tr_top=top, trk_i=trk_i,
                ev_s=np.full(T * K, -1, np.int32),
                ev_frac=np.full(T * K, np.nan, np.float32),
                ev_tt=np.full(T * K + 4, 255, np.uint8))
    args = kernels.WwArgs(**{k: v.ctypes.data for k, v in bufs.items()},
                          T=T, K=K)
    host_lib.ww_host_rank(ctypes.byref(args))
    order = _tway_merge(tr_s, counts, K)
    n = len(order)
    assert n == int(np.minimum(counts, K).sum())
    want_t = np.array([t for t, _ in order])
    want_k = np.array([k for _, k in order])
    np.testing.assert_array_equal(bufs["ev_s"][:n], tr_s[want_t, want_k])
    np.testing.assert_array_equal(bufs["ev_frac"][:n], frac[want_t, want_k])
    np.testing.assert_array_equal(bufs["ev_tt"][:n],
                                  want_t | (top[want_t, want_k] << 4))
    assert (bufs["ev_s"][n:] == -1).all()
    if name == "equal_s":
        assert np.sum(np.diff(bufs["ev_s"][:n]) == 0) > 50


@pytest.mark.parametrize("case", ["noisy_auto", "rebase"])
def test_host_record_mode_matches_plain(host_lib, case, monkeypatch):
    """B4's record mode: each record's peak time and each character's
    clock-end time (in the rolling base's time, which moves on "rebase")
    equal the plain version's, and so does every other output."""
    calls = list(_plain_calls(case, monkeypatch))
    monkeypatch.undo()          # the plain version itself, not the recorder
    for a, kw, _ in calls:
        kw = dict(kw, records=True)
        want = tfu.ww_fused_scan_plain(*a, **kw)
        args, got, keep = kernels.ww_prepare(*a, **kw)
        host_lib.ww_host_run(ctypes.byref(args), 2048)
        del keep
        assert set(got) >= set(want) and {"tr_t", "char_t"} <= set(want)
        n = np.minimum(want["trk_i"][:, tfu.WT_NADM].numpy(), kw["K"])
        keep_k = np.arange(kw["K"]) < n[:, None]
        for k in want:
            g, w = got[k].numpy(), want[k].numpy()
            if k in ("tr_t", "tr_top"):      # the host leaves the rest 0
                g = np.where(keep_k, g, 0)
            np.testing.assert_array_equal(g, w, err_msg=k)
        nchars = int(want["scal"][tfu.WS_DATACOUNT])
        # past a rebase a time may fall just below its new base
        assert nchars > 100 and (want["char_t"][:nchars] != 0).all()
