"""readtape_tpu_torch's int16 activity scan: segment.activity_scan's plain
version, np_quantile and tape_activity, on the CPU.

tape_activity (the chunk maxima and the subsample's histogram, then
numpy's quantile arithmetic repeated on two order statistics) must give
host_activity's height estimate and mask bit for bit; np_quantile must
give np.quantile's result bit for bit, which is what catches a numpy that
changes its arithmetic; the plain version must give native tape_scan's
chunk maxima and the histogram of its subsample. The kernel itself
(csrc/activity.cu) is held to the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 3).
"""

import numpy as np
import pytest
import torch

from readtape_tpu_torch import kernels, native
from readtape_tpu_torch.decode import segment as seg

# the benchmark's subsample counts: 4,481,584 rows x 9 tracks at step 20
# (nrzi9_800) and 2,331,780 x 9 at step 10 (pe9_1600)
CELL_N = {"nrzi": 2_016_720, "pe": 2_098_602}


def _noise(n, t, seed, sigma=3000.0):
    rng = np.random.default_rng(seed)
    return np.clip(np.rint(rng.normal(0.0, sigma, (n, t))), -32768,
                   32767).astype(np.int16)


def _extremes(n, t, seed):
    x = _noise(n, t, seed)
    rng = np.random.default_rng(seed + 1)
    hit = rng.random((n, t))
    x[hit < 0.01] = -32768
    x[hit > 0.99] = 32767
    return x


def _ties(n, t, seed):
    """Three values only: both order statistics the quantile reads fall on
    one of them."""
    rng = np.random.default_rng(seed)
    return rng.choice(np.array([0, -700, 700, 9000], np.int16), (n, t),
                      p=[0.7, 0.15, 0.1499, 0.0001])


def _zeros(n, t, seed):
    return np.zeros((n, t), np.int16)


# (rows, tracks, tape): every T the port decodes (Whirlwind 6, NRZI 7,
# 9), rows a multiple of 16, not, and fewer than 16, host_activity's
# subsample step 1 and above (N * T >= 4,000,000), and each cell's
# subsample count at step 1 (224,080 and 233,178 rows of 9 tracks)
CASES = {
    "t6-mult16": (16 * 811, 6, _noise),
    "t6-odd": (16 * 811 + 5, 6, _noise),
    "t6-short": (11, 6, _noise),
    "t6-step3": (1_000_003, 6, _noise),
    "t7-mult16": (16 * 977, 7, _noise),
    "t7-odd": (16 * 977 + 15, 7, _noise),
    "t7-short": (15, 7, _noise),
    "t7-step2": (571_433, 7, _noise),
    "t9-mult16": (16 * 1024, 9, _noise),
    "t9-odd": (16 * 1024 + 1, 9, _noise),
    "t9-short": (1, 9, _noise),
    "t9-step2-mult16": (444_448, 9, _noise),
    "t9-extremes": (16 * 300 + 7, 9, _extremes),
    "t9-zeros": (16 * 300, 9, _zeros),
    "t9-ties": (16 * 4000 + 3, 9, _ties),
    "t9-nrzi-count": (CELL_N["nrzi"] // 9, 9, _noise),
    "t9-pe-count": (CELL_N["pe"] // 9, 9, _noise),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_tape_activity_equals_host_activity(case):
    n, t, make = CASES[case]
    x = make(n, t, seed=sum(map(ord, case)))
    step = max(1, (n * t) // 2_000_000)
    if case.startswith(("t6-step", "t7-step", "t9-step")):
        assert step > 1
    h_want, act_want = seg.host_activity(x, 1.7)
    h_got, act_got = seg.tape_activity(torch.from_numpy(x), 1.7, step)
    assert type(h_got) is float and h_got == h_want
    assert act_got.dtype == act_want.dtype == np.bool_
    np.testing.assert_array_equal(act_got, act_want)
    if case == "t9-zeros":
        assert h_got == 0.05 and not act_got.any()
    if case == "t9-extremes":
        assert h_got == float(2 * np.float32(32768) *
                              np.float32(1.7 / 32767.0))


def _sweep_arrays(n, rng):
    """float32 arrays of n values: continuous (no ties), and the
    |int16| * scale subsample host_activity quantiles (ties)."""
    scale = np.float32(1.3 / 32767.0)
    return (rng.standard_normal(n).astype(np.float32),
            rng.integers(0, 40, n).astype(np.float32) * scale)


def _same_float32(got, want):
    assert type(got) is np.float32 and type(want) is np.float32
    assert got.tobytes() == want.tobytes(), (got, want)


@pytest.mark.parametrize("q", [0.999, 0.0, 0.25, 0.5, 0.9999, 1.0])
def test_np_quantile_equals_numpy_over_a_sweep_of_n(q):
    rng = np.random.default_rng(int(q * 10_000))
    ns = list(range(1, 1200)) + list(range(1200, 4000, 37)) + [4096, 4097]
    for n in ns:
        for a in _sweep_arrays(n, rng):
            srt = np.sort(a)
            _same_float32(seg.np_quantile(n, q, lambda k: srt[k]),
                          np.quantile(a, q))


@pytest.mark.parametrize("cell", sorted(CELL_N))
def test_np_quantile_equals_numpy_at_the_cells_counts(cell):
    n = CELL_N[cell]
    rng = np.random.default_rng(n)
    for a in _sweep_arrays(n, rng):
        srt = np.sort(a)
        _same_float32(seg.np_quantile(n, 0.999, lambda k: srt[k]),
                      np.quantile(a, 0.999))


@pytest.mark.parametrize("n,t,step", [(16 * 500, 9, 1), (16 * 500 + 9, 9, 3),
                                      (7, 7, 1), (7, 7, 4),
                                      (16 * 333 + 15, 6, 20),
                                      (16 * 2000, 9, 10)])
def test_plain_equals_native_tape_scan(n, t, step):
    x = _extremes(n, t, seed=n + t + step)
    chunk_max, sub = native.tape_scan(x, step)
    out = seg.activity_scan(torch.from_numpy(x), step)
    assert out.dtype == torch.int32
    assert out.shape == (n // seg.CHUNK + kernels.ACT_BINS,)
    out = out.numpy()
    np.testing.assert_array_equal(out[:n // seg.CHUNK], chunk_max)
    np.testing.assert_array_equal(
        out[n // seg.CHUNK:], np.bincount(sub, minlength=kernels.ACT_BINS))


def test_wrapper_routes_by_device_and_checks_its_input():
    assert kernels.ACT_CHUNK == seg.CHUNK
    x = torch.from_numpy(_noise(64, 9, 3))
    calls, launches = seg.activity_scan_plain.calls, seg.activity_scan.launches
    seg.activity_scan(x, 2)
    assert seg.activity_scan_plain.calls == calls + 1
    assert seg.activity_scan.launches == launches
    with pytest.raises(ValueError, match="no kernel"):
        seg.activity_scan(torch.empty((64, 9), dtype=torch.int16,
                                      device="meta"), 1)
    for bad, step in ((x.to(torch.int32), 1), (x.T, 1), (x[:, :4], 1),
                      (x, 0), (x.reshape(-1), 1)):
        with pytest.raises(ValueError):
            seg.activity_scan(bad, step)
