"""Whole runs: run.py without a card, the import guard, a run driven on
the CPU at a tiny size (the card check skipped), with two clients, and
with the timed path broken underneath; on a card, a short cell."""

import json
import os
import subprocess
import sys
import types

import pytest
import torch

from tapebench import harness, manifest

ROOT = manifest.REPO
RUN = os.path.join(ROOT, "tapebench", "run.py")


def run_cli(*args, timeout=600):
    return subprocess.run([sys.executable, RUN, *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout)


def test_run_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = run_cli("--workload", "nrzi9_800.noisy_retry", "--seed", "1",
                "--seconds", "1", "--trace", "0")
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "cuda" in r.stderr.lower()


def test_import_guard_compares_whole_top_level_names(monkeypatch):
    assert "readtape_tpu_torch" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "readtape_tpu_torchx",
                        types.ModuleType("readtape_tpu_torchx"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy",
                        types.ModuleType("jax.numpy"))
    monkeypatch.setitem(sys.modules, "readtape_tpu.decode",
                        types.ModuleType("readtape_tpu.decode"))
    assert harness.forbidden_modules() == ["jax", "readtape_tpu"]


def test_a_forbidden_module_the_check_loads_stops_the_run(tiny,
                                                        monkeypatch):
    """The guard runs after the reference check, so a forbidden module
    that the check or the reference loads stops the run too."""
    real = harness.reference_check

    def loads_jax(*a, **k):
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return real(*a, **k)
    monkeypatch.setattr(harness, "reference_check", loads_jax)
    with pytest.raises(RuntimeError, match="jax"):
        cpu_run(tiny(pool=1), seconds=1.0)


def cpu_run(root, workload="nrzi9_800.noisy_retry", seed=2 ** 32 + 3,
            seconds=3.0, trace=False):
    return harness.execute(workload, seed, seconds, trace, device="cpu",
                           bench=manifest.load_bench(), root=root)


def test_cpu_run_with_two_clients(tiny):
    r = cpu_run(tiny(clients=2), seconds=30.0)
    assert r["correct"] is True
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["metrics"]) == {"decode_msps", "setup_s"}
    assert r["check"]["decodes_compared"]["value"] >= 1
    assert list(r)[-1] == "check"


def test_traced_cpu_run_reads_the_layers(tiny):
    r = cpu_run(tiny(), "pe9_1600.clean", seconds=12.0, trace=True)
    assert r["correct"] is True
    m = r["metrics"]
    for k in ("capture_p90_ms.host_paced", "driver.self_ms", "dispatch.ms",
              "finish.ms", "resident.ms", "fetch.ms",
              "retry.tries_per_block"):
        assert m[k]["value"] > 0, k
    assert "pe_fused_scan_roofline" not in m      # no card: nothing read
    assert "breakdown" in r and r["device"]["window_s"] > 0


def test_decode_options_come_from_the_configuration(tiny, monkeypatch):
    """The configuration's decode group reaches decode_tape as it stands
    (the NRZI cell's -deskew among it), and the reference decodes with
    the same options."""
    from readtape_tpu_torch.decode import pipeline
    real = pipeline.decode_tape
    seen = []

    def spy(samples, opts, **k):
        seen.append(opts)
        out = real(samples, opts, **k)
        seen.append(out[1]["skew"])
        return out
    monkeypatch.setattr(pipeline, "decode_tape", spy)
    r = cpu_run(tiny(pool=1), seconds=10.0)
    assert r["correct"] is True
    opts = seen[0::2]
    assert opts and all(o.deskew and o.expected_parity == 1
                        and o.multiple_tries for o in opts)
    assert all(any(skew) for skew in seen[1::2])


@pytest.mark.parametrize("key,value", [("adjskew", True), ("ntrks", 7),
                                       ("no_such_option", 1)])
def test_an_option_either_side_lacks_is_refused(tiny, key, value):
    """An option the reference does not implement, or one that the
    tape's description sets, stops the run before its set-up."""
    root = tiny()
    path = os.path.join(root, "configs", "nrzi9_800.json")
    with open(path) as f:
        c = json.load(f)
    c["decode"][key] = value
    with open(path, "w") as f:
        json.dump(c, f)
    with pytest.raises(ValueError, match=key):
        cpu_run(root)


def _alter_a_byte(blocks):
    out = list(blocks)
    for i, b in enumerate(out):
        if b.kind == "data" and b.data:
            out[i] = type(b)(**dict(vars(b), data=bytes([b.data[0] ^ 1])
                                    + b.data[1:]))
            break
    return out


FAULTS = {
    "an answer altered where it is produced": _alter_a_byte,
    "half of the batch left out": lambda blocks: blocks[::2],
    "a step that returns its state unchanged": lambda blocks: [],
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(tiny, monkeypatch, fault):
    from readtape_tpu_torch.decode import pipeline
    real = pipeline.decode_tape

    def broken(*a, **k):
        blocks, stats = real(*a, **k)
        return FAULTS[fault](blocks), stats
    monkeypatch.setattr(pipeline, "decode_tape", broken)
    r = cpu_run(tiny(pool=1), seconds=10.0)
    # judged by the comparison, not for want of a decode to compare
    assert r["check"]["decodes_compared"]["value"] >= 1
    assert r["correct"] is False and r["failed"] > 0


@pytest.mark.cuda
def test_short_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    r = run_cli("--workload", "nrzi9_800.noisy_retry", "--seed",
                "4000000001", "--seconds", "3", "--trace", "0", timeout=1200)
    assert r.returncode == 0, r.stderr[-2000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
