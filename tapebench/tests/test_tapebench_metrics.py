"""The metric arithmetic on made-up spans and intervals."""

import pytest

from tapebench import devtrace, harness, roofline
from tapebench.pool import Capture


def caps(rows):
    import numpy as np
    return [Capture(i, np.zeros((n, 9), np.int16), [], [])
            for i, n in enumerate(rows)]


def test_rate_is_all_the_work_over_all_the_time():
    pool = caps([1_000_000, 3_000_000])
    # three captures back to back from t=10: 0.1 s, 0.3 s, 0.1 s
    done = [(0, 10.0, 10.1, None), (1, 10.1, 10.4, None),
            (0, 10.4, 10.5, None)]
    assert harness.rate_msps(done, pool, 10.0) == pytest.approx(5e6 / 0.5
                                                                / 1e6)


def test_p90_over_all_captures_and_a_stall_moves_both():
    walls = [0.1] * 95 + [0.2] * 5
    assert harness.p90(walls) == pytest.approx(0.1)
    stalled = [0.1] * 85 + [0.5] * 15
    assert harness.p90(stalled) == pytest.approx(0.5)
    pool = caps([1_000_000])
    t, done = 0.0, []
    for w in walls:
        done.append((0, t, t + w, None))
        t += w
    t2, done2 = 0.0, []
    for w in stalled:
        done2.append((0, t2, t2 + w, None))
        t2 += w
    assert harness.rate_msps(done2, pool, 0.0) < harness.rate_msps(
        done, pool, 0.0)


def test_idle_is_the_complement_of_the_union():
    # a kernel over [0, 4), a copy overlapping it [2, 5), another [7, 8)
    iv = [(0.0, 4.0), (2.0, 5.0), (7.0, 8.0)]
    assert devtrace.union_seconds(iv) == pytest.approx(6.0)
    assert sum(e - s for s, e in iv) == pytest.approx(8.0)   # not a sum
    assert devtrace.gaps(iv, 0.0, 10.0) == [(5.0, 7.0), (8.0, 10.0)]
    tr = devtrace.DeviceTrace(10.0, [("k", s, e) for s, e in iv],
                              [("fetch", 4.5, 7.5), ("driver", 0.0, 10.0)])
    assert tr.busy_s == pytest.approx(6.0)
    bd = tr.breakdown()
    assert bd["device_ops"] == [["k", pytest.approx(8.0)]]
    assert dict(bd["idle_gaps"]) == {"fetch": pytest.approx(2.0),
                                     "driver": pytest.approx(2.0)}


def test_roofline_counts_from_shapes():
    call = dict(shape=(32, 9, 16384), Ws=(9,) * 8, maxb=1100)
    nbytes, flops = roofline.KERNELS["nrzi_fused_scan"][1](call)
    assert nbytes == 32 * 9 * 16384 * 4 + 32 * 8 + 32 * 8 * 9 * (
        1100 + 4 * 59) + 32 * 8 * 6 * 4
    assert flops == 10.0 * 32 * 9 * 16384
    tr = devtrace.DeviceTrace(
        1.0, [("nrzi_fused_kernel(NrziArgs, int)", 0.0, 0.001)], [],
        {"nrzi_fused_scan": [call]})
    want = 100 * max(nbytes / roofline.PEAK_BYTES_S,
                     flops / roofline.PEAK_F32_FLOPS) / 0.001
    assert roofline.share_pct(tr, "nrzi_fused_scan") == pytest.approx(want)
    assert roofline.share_pct(tr, "pe_fused_scan") is None


def test_span_readers(tmp_path):
    from tapebench import manifest
    cell = manifest.Cell(manifest.load_bench(), "nrzi9_800.noisy_retry")
    spans = [dict(wall=0.2, resident=0.05, dispatch=0.1, finish=0.04,
                  fetch=0.01),
             dict(wall=0.3, resident=0.05, dispatch=0.2, finish=0.05,
                  fetch=0.01)]
    ctx = harness.Context([0.2, 0.3], spans, 12.0, [], None)
    assert cell.reader("driver.self_ms")(ctx) == pytest.approx(40.0)
    assert cell.reader("dispatch.ms")(ctx) == pytest.approx(150.0)
    assert cell.reader("finish.ms")(ctx) == pytest.approx(45.0)
    assert cell.reader("kernel.launches")(ctx) == 12.0
    # nothing to read: no value, never 0
    assert cell.reader("device.idle_pct")(ctx) is None
    assert cell.reader("nrzi_fused_scan_roofline")(ctx) is None
