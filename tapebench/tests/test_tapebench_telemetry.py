"""The traced run's telemetry phase, driven on the CPU at a tiny size:
its decodes are compared with the reference like every other decode, the
six metrics that read it give a number (finish.torch_launches none,
without a card), and it runs after every earlier metric has been read,
whose readers are called as before. Then its arithmetic on made-up
spans and intervals."""

import pytest

from tapebench import harness, manifest, telemetry_phase

NEW = ("resident_scan.ms", "resident_upload.ms", "host_wait.ms",
       "host_wait.count", "driver_host.ms", "finish.torch_launches")


def test_traced_run_checks_the_phase_and_reads_it_last(tiny, monkeypatch):
    root = tiny()
    order, phase, checked = [], {}, {}
    real_reader, real_run = manifest.Cell.reader, telemetry_phase.run
    real_check = harness.reference_check

    def reader(self, name):
        order.append(name)
        return real_reader(self, name)

    def run(program, captures, decodes):
        order.append("phase")
        n0 = len(decodes)
        tel = real_run(program, captures, decodes)
        phase["decodes"] = decodes[n0:]
        return tel

    def check(config, captures, decodes, seed):
        out = real_check(config, captures, decodes, seed)
        checked.update(decodes=list(decodes), cap=out[2], n=out[1])
        return out
    monkeypatch.setattr(manifest.Cell, "reader", reader)
    monkeypatch.setattr(telemetry_phase, "run", run)
    monkeypatch.setattr(harness, "reference_check", check)
    r = harness.execute("pe9_1600.clean", 2 ** 32 + 5, 4.0, True,
                        device="cpu", bench=manifest.load_bench(), root=root)
    assert r["correct"] is True and r["failed"] == 0
    # the phase's decodes are among those the reference check compared
    mine = phase["decodes"]
    assert len(mine) == telemetry_phase.CAPTURES
    assert all(any(d is m for d in checked["decodes"]) for m in mine)
    ncap = sum(i == checked["cap"] for i, _ in mine)
    assert ncap >= 1 and r["check"]["decodes_compared"]["value"] == \
        checked["n"] >= ncap + 1
    # every earlier metric is read once, in the manifest's order, before
    # the phase, which the first of the new readers runs once
    cell = manifest.Cell(manifest.load_bench(), "pe9_1600.clean", root)
    names = [m["name"] for m in cell.per_layer]
    old = [n for n in names if n not in NEW]
    new = [n for n in names if n in NEW]
    assert len(new) == len(NEW) and names == old + new
    assert order == old + new[:1] + ["phase"] + new[1:]
    m = r["metrics"]
    for k in NEW[:-1]:
        assert m[k]["value"] >= 0, k
    for k in ("resident_scan.ms", "resident_upload.ms", "host_wait.count",
              "driver_host.ms"):
        assert m[k]["value"] > 0, k
    assert "finish.torch_launches" not in m      # no card: nothing read
    for k in ("driver.self_ms", "dispatch.ms", "finish.ms", "resident.ms",
              "fetch.ms", "retry.tries_per_block"):
        assert m[k]["value"] > 0, k


def test_a_program_without_telemetry_reads_nothing(monkeypatch):
    """The parent of the change that adds it: the phase is skipped and
    its metrics read nothing, without raising."""
    import builtins
    real = builtins.__import__

    def no_telemetry(name, globals=None, locals=None, fromlist=(), level=0):
        if name == "readtape_tpu_torch" and "telemetry" in (fromlist or ()):
            raise ImportError("no telemetry")
        return real(name, globals, locals, fromlist, level)
    monkeypatch.setattr(builtins, "__import__", no_telemetry)
    decodes = []
    assert telemetry_phase.run(None, [None], decodes) is None
    assert decodes == []
    ctx = harness.Context([], [], None, [], None)
    ctx.telemetry = None
    cell = manifest.Cell(manifest.load_bench(), "nrzi9_800.noisy_retry")
    assert all(cell.reader(n)(ctx) is None for n in NEW)


def test_phase_arithmetic_on_made_up_records():
    from readtape_tpu_torch import telemetry
    S = telemetry.Span
    rec = telemetry.Recording()
    # one capture of 100 ns: scan 30, upload 10, a dispatch of 40 holding
    # a wait of 15, the driver's stage of 10 around the dispatch is 50
    rec.spans = [S("resident.scan", 2, 1, 1, 0, 30),
                 S("resident.upload", 3, 1, 1, 30, 40),
                 S("wait.fetch", 6, 5, 1, 55, 70,
                   counters={"host_waits": 2}),
                 S("dispatch", 5, 4, 1, 50, 90),
                 S("driver.stage", 4, 1, 1, 45, 95),
                 S("capture", 1, None, 1, 0, 100)]
    (c,) = telemetry_phase.per_capture(rec)
    assert c == dict(scan_ns=30, upload_ns=10, wait_ns=15, waits=2,
                     driver_ns=(100 - 30 - 10 - 50) + (50 - 40))
    tel = telemetry_phase.Telemetry([c, dict(c, scan_ns=50)])
    assert telemetry_phase.median_ms(tel, "scan_ns") == pytest.approx(4e-5)
    spans = [("capture", 0, 100), ("dispatch", 50, 90), ("wait.fetch", 55, 70)]
    assert telemetry_phase.innermost([10, 60, 80, 95, 120], spans) == [
        "capture", "wait.fetch", "dispatch", "capture", None]
