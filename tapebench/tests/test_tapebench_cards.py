"""The per-card phase and its four metrics: card.idle_pct, mesh.overlap,
resident_replicate.ms and mesh.pad_lanes. Their arithmetic on made-up
intervals and records; nothing read (and nothing raised) for a program
without the spans and counters they read; the manifest valid with them;
the four-shard mesh's decode of a short noisy capture equal to the plain
reference; and a traced run of the mesh cell on the CPU at a tiny size,
in which the phase runs after the telemetry phase and its decodes are
checked like every other."""

import json
import os

import pytest
import torch

from tapebench import cards_phase, check, devtrace, harness, manifest, \
    synth, telemetry_phase
from tapebench.reference import decode as ref

NEW = ("card.idle_pct", "mesh.overlap", "resident_replicate.ms",
       "mesh.pad_lanes")


def _read(name, cards, trace=None):
    ctx = harness.Context([], [], None, [], trace)
    ctx.cards = cards
    cell = manifest.Cell(manifest.load_bench(), "nrzi9_800_mesh4.noisy_retry")
    return cell.reader(name)(ctx)


def test_overlap_of_cards_at_once_and_in_turn():
    both = cards_phase.Cards({0: [(0.0, 1.0)], 1: [(0.0, 1.0)]}, 2.0)
    turns = cards_phase.Cards({0: [(0.0, 1.0)], 1: [(1.0, 2.0)]}, 2.0)
    assert _read("mesh.overlap", both) == pytest.approx(2.0)
    assert _read("mesh.overlap", turns) == pytest.approx(1.0)
    # four cards, two of them idle: half the union's time each pair works
    half = cards_phase.Cards({0: [(0.0, 1.0)], 1: [(0.5, 1.5)], 2: [],
                              3: []}, 2.0)
    assert _read("mesh.overlap", half) == pytest.approx(2.0 / 1.5)
    # an idle card counts in the mean: one busy card does not hide it
    assert _read("card.idle_pct", half) == pytest.approx(
        (50.0 + 50.0 + 100.0 + 100.0) / 4)
    assert _read("card.idle_pct", turns) == pytest.approx(50.0)


def test_one_card_idle_is_device_idle_pct():
    iv = [(0.1, 0.3), (0.2, 0.5), (0.9, 1.2)]
    tr = devtrace.DeviceTrace(1.5, [("k", s, e) for s, e in iv])
    cards = cards_phase.Cards({0: iv}, 1.5)
    ctx = harness.Context([], [], None, [], tr)
    old = manifest.Cell(manifest.load_bench(), "nrzi9_800.noisy_retry")
    assert _read("card.idle_pct", cards) == pytest.approx(
        old.reader("device.idle_pct")(ctx)) == pytest.approx(
        100.0 * (1 - 0.7 / 1.5))
    assert _read("mesh.overlap", cards) == pytest.approx(1.0)


def test_program_counts_per_capture():
    from readtape_tpu_torch import telemetry
    S = telemetry.Span
    rec = telemetry.Recording()
    # two captures: the first pads 3 + 2 lanes, the second 1
    rec.spans = [S("dispatch", 3, 1, 1, 50, 60,
                   counters={"dispatch.pad_lanes": 3}),
                 S("dispatch", 4, 1, 1, 60, 70,
                   counters={"dispatch.pad_lanes": 2}),
                 S("capture", 1, None, 1, 0, 100),
                 S("dispatch", 6, 5, 5, 110, 120,
                   counters={"dispatch.pad_lanes": 1}),
                 S("capture", 5, None, 5, 100, 200)]
    pads = cards_phase.pad_lanes(rec)
    assert pads == [5, 1]
    cards = cards_phase.Cards(pad_lanes=pads)
    assert _read("mesh.pad_lanes", cards) == pytest.approx(3.0)
    # one card, no mesh: no counter
    rec.spans = [S("dispatch", 3, 1, 1, 50, 60),
                 S("capture", 1, None, 1, 0, 100)]
    assert cards_phase.pad_lanes(rec) is None


def test_replicate_reads_the_card_to_card_copies():
    """The union of the window's Memcpy PtoP intervals, whichever card
    ran them, over its captures: two captures, the first's three copies
    1 ms each and two of them at once, the second's parmsets 0.1 ms."""
    cards = cards_phase.Cards({0: [(0.0, 0.002)], 1: [(0.0, 0.001)]},
                              0.5, captures=2,
                              peer_s=devtrace.union_seconds(
                                  [(0.0, 0.001), (0.001, 0.002),
                                   (0.001, 0.002), (0.3, 0.3001)]))
    assert _read("resident_replicate.ms", cards) == pytest.approx(1.05)
    # one card, or the parent's program on one: no copy, nothing read
    assert _read("resident_replicate.ms", cards_phase.Cards(
        {0: [(0.0, 0.1)]}, 0.5, captures=2)) is None


def test_nothing_to_read_reads_nothing():
    """The parent of the change that adds the spans and counters, a CPU
    run, or no run found: every reader returns None, raising nothing."""
    for cards in (None, cards_phase.Cards(),
                  cards_phase.Cards({0: [], 1: []}, 1.0)):
        assert all(_read(n, cards) is None for n in NEW)


def test_manifest_is_valid_with_the_new_entries():
    bench = manifest.load_bench()
    assert manifest.validate(bench) == []
    cells = {w["name"]: w for w in bench["workloads"]}
    assert cells["nrzi9_800_mesh4.noisy_retry"]["chips"] == 4
    assert cells["nrzi9_800.clean"]["chips"] == 1
    assert sum(w["chips"] == 4 for w in cells.values()) <= max(
        1, len(cells) // 4)
    # a configuration is a deployment of its own: no two share a source
    # and the keys they cut
    assert len({(c["source"], tuple(c["reduced"]))
                for c in bench["configs"]}) == len(bench["configs"])
    mesh = manifest.Cell(bench, "nrzi9_800_mesh4.noisy_retry")
    old = manifest.Cell(bench, "nrzi9_800.noisy_retry")
    names = [m["name"] for m in old.per_layer]
    # both new cells report every accepted metric of the NRZI cell; the
    # per-card ones only where there is more than one card
    assert [m["name"] for m in mesh.per_layer] == names + list(NEW)
    assert mesh.config["mesh"] == {"data": 4, "parm": 1}
    clean = manifest.Cell(bench, "nrzi9_800.clean")
    assert [m["name"] for m in clean.per_layer] == names


def _json(kind, name):
    with open(os.path.join(manifest.HERE, kind, name + ".json")) as f:
        return json.load(f)


def test_mesh_decode_equals_the_plain_reference():
    """nrzi9_800 cut to blocks of 64 and 96 bytes, noisy_retry's noise:
    decoded under make_decode_mesh([cpu] * 4, parm_axis=1), every segment
    the reference's, in the same -deskew delays."""
    from readtape_tpu_torch.decode import pipeline as pl
    from readtape_tpu_torch.parallel import mesh as pmesh
    config = _json("configs", "nrzi9_800")
    config.update(block_sizes=[[64, 1], [96, 1]], blocks=2, bytes=160)
    config["samples"] = synth.samples_for(config, 0.008)
    samples, _, _ = synth.synthesize(config, _json("traffic", "noisy_retry"),
                                     2 ** 33 + 7, 0)
    kw = harness.option_kwargs(config)
    pmesh.set_decode_mesh(pmesh.make_decode_mesh([torch.device("cpu")] * 4,
                                                 parm_axis=1))
    try:
        blocks, stats = pl.decode_tape(samples, pl.DecodeOptions(**kw),
                                       device="cpu")
    finally:
        pmesh.set_decode_mesh(None)
    ropts = ref.Options(**kw)
    nseg = len(ref.Decoder(samples, ropts).segments())
    segs, want, skew = ref.decode_sample(samples, ropts, range(nseg))
    assert check.compare(blocks, want, segs, ropts.deltat) == (0, 0.0)
    assert check.skew_of(stats) == skew and any(skew)
    assert stats["tried"][1] > 0 and stats["nblocks"] == 2


def test_traced_run_runs_the_phase_after_the_telemetry_phase(
        tiny, monkeypatch):
    """The four-card cell on four CPU shards, with the clean traffic (the
    reference's staged retry on noisy captures takes minutes here): the
    per-card phase after the telemetry phase, its decodes checked;
    without a card nothing for the device's readers, and the program's
    counter read."""
    from readtape_tpu_torch.parallel import mesh as pmesh
    root = tiny(blocks=1, pool=1)
    bench = manifest.load_bench()
    (cell,) = [w for w in bench["workloads"]
               if w["name"] == "nrzi9_800_mesh4.noisy_retry"]
    config = _json("configs", cell["config"])
    with open(os.path.join(root, "configs", "nrzi9_800.json")) as f:
        config.update({k: v for k, v in json.load(f).items()
                       if k in ("block_sizes", "blocks", "bytes",
                                "samples")})
    with open(os.path.join(root, "configs", cell["config"] + ".json"),
              "w") as f:
        json.dump(config, f)
    monkeypatch.setattr(pmesh, "visible_devices",
                        lambda device="cuda": [torch.device("cpu")] * 4)
    monkeypatch.setattr(telemetry_phase, "CAPTURES", 1)
    monkeypatch.setattr(cards_phase, "CAPTURES", 1)
    order, phase, checked = [], {}, {}
    real_tel, real_run = telemetry_phase.run, cards_phase.run
    real_check = harness.reference_check

    def tel(program, captures, decodes):
        order.append("telemetry")
        return real_tel(program, captures, decodes)

    def run(program, captures, decodes):
        order.append("cards")
        n0 = len(decodes)
        out = real_run(program, captures, decodes)
        phase["decodes"] = decodes[n0:]
        return out

    def check_(config, captures, decodes, seed):
        out = real_check(config, captures, decodes, seed)
        checked.update(decodes=list(decodes))
        return out
    monkeypatch.setattr(telemetry_phase, "run", tel)
    monkeypatch.setattr(cards_phase, "run", run)
    monkeypatch.setattr(harness, "reference_check", check_)
    cell["traffic"] = "clean"
    try:
        r = harness.execute("nrzi9_800_mesh4.noisy_retry", 2 ** 33 + 11,
                            2.0, True, device="cpu", bench=bench, root=root)
    finally:
        pmesh.set_decode_mesh(None)
    assert r["correct"] is True and r["failed"] == 0
    assert order == ["telemetry", "cards"]
    mine = phase["decodes"]
    assert len(mine) == 1
    assert all(any(d is m for d in checked["decodes"]) for m in mine)
    # no card on the CPU: nothing for the device's readers
    assert not {"card.idle_pct", "mesh.overlap",
                "resident_replicate.ms"} & set(r["metrics"])
    assert r["metrics"]["mesh.pad_lanes"]["value"] > 0
