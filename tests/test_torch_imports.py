"""The port stands alone: no module of readtape_tpu_torch (decode/zeros.py,
formats/csvfmt.py, out/trace.py, native.py and the host tools csvtbin.py
and dumptap.py included), and not chip_smoke.py or the card's A/B
timing scripts (scripts/*_ab.py), imports jax or anything of the JAX
package (readtape_tpu).
The port's own copies of the JAX-free modules (formats, synth) agree with
the JAX package's: the built-in parmsets, the .tbin format, and the
example tapes chip_smoke.py builds from its recipe table, sample for
sample, with the recipes equal to examples/make_examples.py's."""

import ast
import dataclasses
import glob
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke
from readtape_tpu.formats import parms as jparms
from readtape_tpu.formats import simh as jsimh
from readtape_tpu.formats import tbin as jtb
from readtape_tpu_torch.formats import parms as tparms
from readtape_tpu_torch.formats import simh as tsimh
from readtape_tpu_torch.formats import tbin as ttb
from readtape_tpu_torch.synth import default_spec, synthesize_tape

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_sources():
    files = glob.glob(os.path.join(REPO, "readtape_tpu_torch", "**", "*.py"),
                      recursive=True)
    return sorted(files) + [os.path.join(REPO, "chip_smoke.py")]


def _forbidden(name):
    return (name == "jax" or name.startswith("jax.")
            or name == "readtape_tpu" or name.startswith("readtape_tpu."))


def test_no_import_of_jax_or_the_jax_package():
    bad = []
    ab = sorted(glob.glob(os.path.join(REPO, "scripts", "*_ab.py")))
    assert len(ab) >= 2
    for path in _port_sources() + ab:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{os.path.relpath(path, REPO)}:{node.lineno} {n}"
                    for n in names if _forbidden(n)]
    assert len(_port_sources()) > 15
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    mods = sorted(
        "readtape_tpu_torch." + os.path.relpath(p, os.path.join(
            REPO, "readtape_tpu_torch"))[:-3].replace(os.sep, ".")
        for p in _port_sources()[:-1])
    mods = [m[:-len(".__init__")] if m.endswith(".__init__") else m
            for m in mods]
    assert {"readtape_tpu_torch.decode.zeros",
            "readtape_tpu_torch.formats.csvfmt",
            "readtape_tpu_torch.out.trace", "readtape_tpu_torch.native",
            "readtape_tpu_torch.csvtbin",
            "readtape_tpu_torch.dumptap"} <= set(mods)
    code = ("import importlib, sys\n"
            f"for m in {mods!r} + ['chip_smoke']:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'readtape_tpu' or "
            "m.startswith('readtape_tpu.')]\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


@pytest.mark.parametrize("mode", [jtb.MODE_NRZI, jtb.MODE_PE, jtb.MODE_GCR,
                                  jtb.MODE_WW])
def test_builtin_parmsets_match(mode):
    mine = tparms.builtin_parmsets(mode)
    theirs = jparms.builtin_parmsets(mode)
    assert mine.mode == theirs.mode
    assert ([dataclasses.asdict(p) for p in mine.sets] ==
            [dataclasses.asdict(p) for p in theirs.sets])


def test_tbin_and_tap_written_by_the_port_read_back(tmp_path):
    rng = np.random.default_rng(3)
    spec = default_spec(ttb.MODE_PE, ibg_secs=0.001, start_gap_secs=0.001)
    data = bytes(rng.integers(0, 256, 40, dtype=np.uint8))
    hdr, samples = synthesize_tape(spec, [("block", data), ("tapemark",)])
    path = str(tmp_path / "t.tbin")
    ttb.write_tbin(path, hdr, samples)
    jhdr, jsamples = jtb.read_tbin(path)
    thdr, tsamples = ttb.read_tbin(path)
    np.testing.assert_array_equal(np.asarray(jsamples), samples)
    np.testing.assert_array_equal(np.asarray(tsamples), samples)
    assert dataclasses.asdict(jhdr) == dataclasses.asdict(thdr)
    # the writer stamps the conversion time; every other field round-trips
    assert ({k: v for k, v in dataclasses.asdict(jhdr).items()
             if k != "time_converted"} ==
            {k: v for k, v in dataclasses.asdict(hdr).items()
             if k != "time_converted"})
    blobs = []
    for mod in (tsimh, jsimh):
        tap = str(tmp_path / f"{mod.__name__}.tap")
        w = mod.TapWriter(tap)
        w.write_block(data)
        w.write_tapemark()
        w.write_block(data[:7], error=True)
        w.write_eom()
        w.close()
        with open(tap, "rb") as f:
            blobs.append(f.read())
    assert blobs[0] == blobs[1]


def _make_examples():
    spec = importlib.util.spec_from_file_location(
        "make_examples", os.path.join(REPO, "examples", "make_examples.py"))
    mk = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mk)
    return mk


@pytest.mark.parametrize("name", chip_smoke.GOLDEN_CASES)
def test_example_recipe_matches(name):
    mk = _make_examples()
    mine, theirs = chip_smoke.EXAMPLES[name], mk.CASES[name]
    for k in ("seed", "mode", "sizes", "args", "fmt"):
        assert mine.get(k) == theirs.get(k), k
    assert set(theirs) - {"spec"} == set(mine) - {"spec"}
    mode, kw = mine["spec"]
    assert (dataclasses.asdict(default_spec(getattr(ttb, "MODE_" + mode),
                                            **kw))
            == dataclasses.asdict(theirs["spec"]()))
    hdr, samples = chip_smoke.build_example(name)
    jhdr, jsamples = mk.build_case(name, theirs)
    np.testing.assert_array_equal(samples, jsamples)
    assert dataclasses.asdict(hdr) == dataclasses.asdict(jhdr)
