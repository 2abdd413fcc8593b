"""BENCHMARK.json against the contract's rules, and adding a
configuration, a traffic mix and a metric by files alone."""

import json
import os
import re

import pytest

from tapebench import manifest

ROOT = manifest.REPO


def bench():
    return manifest.load_bench()


def test_manifest_is_valid():
    assert manifest.validate(bench()) == []


def test_names_units_and_lengths():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["tapebench"] and 1 <= b["run_seconds"] <= 51
    for m in b["end_to_end"] + b["per_layer"]:
        assert manifest.UNIT.match(m["unit"])
        assert manifest.NAME.match(m["name"])
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    assert {m["name"] for m in b["end_to_end"]} <= {
        "decode_msps", "capture_p90_ms", "setup_s"}
    for w in b["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    for c in b["configs"]:
        assert len(c["source"]) <= 200
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]
        assert sum(n * k for n, k in cfg["block_sizes"]) == cfg["bytes"]
        assert sum(k for _, k in cfg["block_sizes"]) == cfg["blocks"]


def test_each_cell_reports_what_its_metrics_move():
    b = bench()
    for w in b["workloads"]:
        cell = manifest.Cell(b, w["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e
            assert callable(cell.reader(m["name"]))


def test_config_traffic_and_metric_by_files_alone(tmp_path):
    """A throwaway configuration, traffic mix and metric in another root,
    with entries added to a copy of the manifest: no code changes."""
    b = bench()
    root = tmp_path / "bench"
    for d in ("configs", "traffic", "metrics"):
        (root / d).mkdir(parents=True)
    with open(os.path.join(manifest.HERE, "configs", "nrzi9_800.json")) as f:
        cfg = json.load(f)
    cfg.update(name="nrzi9_800_short", block_sizes=[[64, 2]], blocks=2,
               bytes=128, samples=60000)
    (root / "configs" / "nrzi9_800_short.json").write_text(json.dumps(cfg))
    (root / "traffic" / "burst.json").write_text(json.dumps(
        {"name": "burst", "clients": 1, "pool": 1, "synth": {}}))
    (root / "metrics" / "made.up_ms.py").write_text(
        "def read(ctx):\n    return 2.5 * len(ctx.walls)\n")
    b["configs"].append({"name": "nrzi9_800_short", "source": "x",
                         "file": "tapebench/configs/nrzi9_800_short.json",
                         "reduced": ["block_sizes"], "why": "x"})
    b["workloads"].append({"name": "nrzi9_800_short.burst",
                           "config": "nrzi9_800_short", "traffic": "burst",
                           "chips": 1, "why": "x"})
    b["per_layer"].append({"name": "made.up_ms", "unit": "ms",
                           "better": "lower", "source": "host_clock",
                           "layer": "x", "moves": "decode_msps",
                           "workloads": ["nrzi9_800_short.burst"]})
    assert not [p for p in manifest.validate(b, str(root))
                if "_short" in p or "burst" in p or "made.up" in p]
    cell = manifest.Cell(b, "nrzi9_800_short.burst", str(root))
    assert cell.config["block_sizes"] == [[64, 2]]
    assert cell.traffic["name"] == "burst"
    assert [m["name"] for m in cell.per_layer] == ["made.up_ms"]

    class Ctx:
        walls = [0.1, 0.2]
    assert cell.reader("made.up_ms")(Ctx) == 5.0


def test_harness_imports_nothing_forbidden_by_source():
    """No file of the benchmark imports jax, jaxlib, flax or the JAX
    package (the top-level name compared whole)."""
    pat = re.compile(r"^\s*(?:from|import)\s+([A-Za-z_][\w]*)", re.M)
    for dirpath, _, files in os.walk(manifest.HERE):
        for fn in files:
            if fn.endswith(".py"):
                with open(os.path.join(dirpath, fn)) as f:
                    names = set(pat.findall(f.read()))
                assert not names & {"jax", "jaxlib", "flax",
                                    "readtape_tpu"}, fn


@pytest.mark.parametrize("where,key", [
    ("config", "bpi_given"), ("config", "options"),
    ("config_synth", "ibg_secs"), ("traffic", "loop"),
])
def test_a_key_that_nothing_reads_is_refused(tmp_path, where, key):
    """A configuration or traffic key that the harness does not read
    would seem to set something the run never applies."""
    root = tmp_path / "bench"
    for d in ("configs", "traffic"):
        (root / d).mkdir(parents=True)
    with open(os.path.join(manifest.HERE, "configs", "nrzi9_800.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(manifest.HERE, "traffic", "clean.json")) as f:
        tr = json.load(f)
    {"config": cfg, "config_synth": cfg["synth"],
     "traffic": tr}[where][key] = 1
    (root / "configs" / "nrzi9_800.json").write_text(json.dumps(cfg))
    (root / "traffic" / "clean.json").write_text(json.dumps(tr))
    b = bench()
    b["workloads"].append({"name": "nrzi9_800.clean", "config": "nrzi9_800",
                           "traffic": "clean", "chips": 1, "why": "x"})
    with pytest.raises(ValueError, match=key):
        manifest.Cell(b, "nrzi9_800.clean", str(root))


def test_block_sizes_make_the_documented_blocks_and_bytes(tmp_path):
    b = bench()
    root = tmp_path / "bench"
    for d in ("configs", "traffic", "metrics"):
        (root / d).mkdir(parents=True)
    for c in b["configs"]:
        with open(os.path.join(manifest.HERE, "configs",
                               c["name"] + ".json")) as f:
            cfg = json.load(f)
        if c["name"] == "pe9_1600":
            cfg["bytes"] += 1
        (root / "configs" / (c["name"] + ".json")).write_text(
            json.dumps(cfg))
    assert any("pe9_1600: block_sizes" in p
               for p in manifest.validate(b, str(root)))
