"""BENCHMARK.json and the files it names.

Everything that belongs to one configuration, traffic mix or per-layer
metric lives in a file of its own, found by name: ``configs/<config>.json``,
``traffic/<traffic>.json`` and ``metrics/<metric>.py`` under this folder
(or under another root, for a test). A later change adds a configuration,
a traffic mix or a metric by adding files and entries, never by editing
this code.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)

# the keys a configuration or traffic file may hold: each is read by the
# harness (the decode options, the synthesizer, the pool), or describes
# the file for its reader (name, source, deployment, assumed, reduced,
# why, notes). Any other key is refused, so that no key seems to set
# something that the run never applies.
CONFIG_KEYS = frozenset((
    "name", "source", "deployment", "assumed", "reduced",
    "encoding", "tracks", "bpi", "ips", "sample_rate_hz", "maxvolts",
    "samples", "blocks", "bytes", "block_sizes", "tapemarks_at_end",
    "decode", "kernel_path", "mesh", "synth"))
TRAFFIC_KEYS = frozenset(("name", "why", "notes", "clients", "pool",
                          "synth"))
SYNTH_KEYS = frozenset(("start_gap_secs", "amplitude", "noise_rms",
                        "pulse_width_bits", "amp_jitter", "time_jitter_bits",
                        "skew_bits"))

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def load_bench(path: str = None) -> dict:
    with open(path or os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(root: str, kind: str, name: str) -> dict:
    if not NAME.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    with open(os.path.join(root, kind, name + ".json")) as f:
        return json.load(f)


def unknown_keys(config: dict, traffic: dict) -> list:
    """Keys of a configuration and a traffic mix that nothing reads."""
    return sorted(
        [f"config {k}" for k in set(config) - CONFIG_KEYS]
        + [f"config synth.{k}" for k in set(config.get("synth", {}))
           - SYNTH_KEYS]
        + [f"traffic {k}" for k in set(traffic) - TRAFFIC_KEYS]
        + [f"traffic synth.{k}" for k in set(traffic.get("synth", {}))
           - SYNTH_KEYS])


class Cell:
    """One entry of `workloads`, with its configuration, traffic mix and
    the metrics it reports."""

    def __init__(self, bench: dict, workload: str, root: str = HERE):
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise ValueError(f"unknown workload {workload!r}: one of "
                             f"{sorted(cells)}")
        self.root = root
        self.entry = cells[workload]
        self.name = workload
        self.config = _json(root, "configs", self.entry["config"])
        self.traffic = _json(root, "traffic", self.entry["traffic"])
        unknown = unknown_keys(self.config, self.traffic)
        if unknown:
            raise ValueError(f"{workload}: keys that nothing reads: "
                             f"{unknown}")
        self.chips = int(self.entry["chips"])
        self.end_to_end = [m for m in bench["end_to_end"] if self._has(m)]
        self.per_layer = [m for m in bench["per_layer"] if self._has(m)]

    def _has(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]

    def reader(self, metric: str):
        """metrics/<metric>.py's read(ctx) -> number or None."""
        if not NAME.match(metric):
            raise ValueError(f"bad metric name {metric!r}")
        path = os.path.join(self.root, "metrics", metric + ".py")
        spec = importlib.util.spec_from_file_location(
            "tapebench_metric_" + metric.replace(".", "_").replace("-", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def validate(bench: dict, root: str = HERE) -> list:
    """Problems with the manifest and the files it names (empty: none)."""
    bad = []
    e2e = {m["name"] for m in bench["end_to_end"]}
    cells = {w["name"]: w for w in bench["workloads"]}
    configs = {c["name"] for c in bench["configs"]}
    names = ([c["name"] for c in bench["configs"]] + list(cells)
             + [m["name"] for m in bench["end_to_end"] + bench["per_layer"]])
    if len(names) != len(set(names)):
        bad.append("a name is used twice")
    for n in names:
        if not NAME.match(n):
            bad.append(f"bad name {n!r}")
    for c in bench["configs"]:
        if not os.path.exists(os.path.join(REPO, c["file"])) and \
                not os.path.exists(os.path.join(root, "configs",
                                                c["name"] + ".json")):
            bad.append(f"no file for configuration {c['name']}")
    for c in bench["configs"]:
        path = os.path.join(root, "configs", c["name"] + ".json")
        if os.path.exists(path):
            with open(path) as f:
                cfg = json.load(f)
            sizes = cfg.get("block_sizes", [])
            if (sum(k for _, k in sizes) != cfg.get("blocks")
                    or sum(n * k for n, k in sizes) != cfg.get("bytes")):
                bad.append(f"{c['name']}: block_sizes do not make its "
                           f"blocks and bytes")
    for w in cells.values():
        if w["config"] not in configs:
            bad.append(f"{w['name']}: unknown configuration")
        for kind, key in (("configs", "config"), ("traffic", "traffic")):
            if not os.path.exists(os.path.join(root, kind,
                                               w[key] + ".json")):
                bad.append(f"{w['name']}: no {kind}/{w[key]}.json")
    for m in bench["end_to_end"] + bench["per_layer"]:
        if not UNIT.match(m["unit"]) or m["better"] not in ("lower",
                                                             "higher"):
            bad.append(f"{m['name']}: bad unit or direction")
        for w in m.get("workloads", []):
            if w not in cells:
                bad.append(f"{m['name']}: unknown workload {w}")
    for m in bench["per_layer"]:
        if m["moves"] not in e2e:
            bad.append(f"{m['name']}: moves no end-to-end metric")
        if not os.path.exists(os.path.join(root, "metrics",
                                           m["name"] + ".py")):
            bad.append(f"{m['name']}: no metrics/{m['name']}.py")
        moved = next(x for x in bench["end_to_end"] if x["name"] == m["moves"]) \
            if m["moves"] in e2e else {}
        for w in m.get("workloads", list(cells)):
            if "workloads" in moved and w not in moved["workloads"]:
                bad.append(f"{m['name']}: {w} does not report {m['moves']}")
    for w in cells:
        reports = [m for m in bench["end_to_end"]
                   if "workloads" not in m or w in m["workloads"]]
        if "setup_s" not in {m["name"] for m in reports} or len(reports) < 2:
            bad.append(f"{w}: needs setup_s and another end-to-end metric")
        if not any("workloads" not in m or w in m["workloads"]
                   for m in bench["per_layer"]):
            bad.append(f"{w}: no per-layer metric")
    return bad
