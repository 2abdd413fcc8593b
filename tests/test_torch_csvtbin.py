"""The port's csvtbin (readtape_tpu_torch.csvtbin) and CSV scanners against
the JAX package's, on the CPU.

- csvtbin: every option set below runs the JAX tool's main and the port's
  main in process on the same input files, each in a directory of its own.
  Their stdout is equal, and so is every file they write: the .tbin byte
  for byte apart from the conversion stamp (write_tbin fills
  time_converted from the wall clock), the .graph.csv and the -read CSV
  byte for byte. The inputs are made from a numpy seed: a 9-track capture
  with a start time, a 6-track Whirlwind one, a capture whose voltages sit
  next to the int16 rounding boundaries of -maxvolts=1.5 (the float32
  scanfast digits then pick other samples than a correctly rounded parse
  would: asserted), one with "+" signs (where the native scanner and the
  Python replica differ, in both packages), and one of 1,000,200 rows of
  one track whose last rows exceed the maxvolts estimated from the first
  million (the capture -redo rescales). Each CSV-reading case runs once
  with the native scanners and once with both packages' Python replicas
  (each package's native csv_scan_native patched to raise).
- The scanners: the port's native and numpy read_csv against the JAX
  read_csv (native), and the port's native scanfast parser and Python
  replica against the JAX package's, bit for bit.

Tolerance: none.
"""

import os

import numpy as np
import pytest

import readtape_tpu.native as jnative
from readtape_tpu import csvtbin as jcsvtbin
from readtape_tpu.formats import csvfmt as jcsv
import readtape_tpu_torch.native as tnative
from readtape_tpu_torch import csvtbin as tcsvtbin
from readtape_tpu_torch.formats import csvfmt as tcsv
from readtape_tpu_torch.formats import tbin as ttb

# time_converted: after the tag, the description, hdrsize, format and two
# struct tm's (formats/tbin.py _HDR_NUMERIC)
STAMP = slice(8 + 80 + 8 + 2 * 36, 8 + 80 + 8 + 3 * 36)
TOOLS = (("j", jcsvtbin), ("t", tcsvtbin))
MAXV = 1.5


def _rows(times, volts):
    return "".join(f"{t:.7f}, " + ", ".join(v) + "\n"
                   for t, v in zip(times, volts))


def capture(ntrks=9, n=3000, t0=0.001, seed=0):
    """A Saleae-style capture: damped sines of random phase and noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)[:, None]
    v = (0.8 * np.sin(t * rng.uniform(0.05, 0.3, ntrks) + rng.uniform(
        0, 6, ntrks)) + rng.normal(0, 0.03, (n, ntrks)))
    text = (f"capture seed {seed}\nTime [s]"
            + "".join(f", Channel {i}" for i in range(ntrks)) + "\n")
    return text + _rows(t0 + 1e-6 * np.arange(n),
                        [[f"{x:.7f}" for x in r] for r in v])


def boundary_tokens(n, seed=1):
    """n "%.7f" voltages next to a rounding boundary of -maxvolts=1.5:
    (k + 0.5) * 1.5 / 32767 within 1e-8."""
    rng = np.random.default_rng(seed)
    k = rng.integers(-20000, 20000, n)
    return [f"{x:.7f}" for x in (k + 0.5) * MAXV / 32767
            + rng.normal(0, 1e-8, n)]


def edge_capture(n=600, ntrks=4):
    toks = np.asarray(boundary_tokens(n * ntrks)).reshape(n, ntrks)
    return ("edge\nTime [s]" + ", a" * ntrks + "\n"
            + _rows(2e-6 * np.arange(n), toks))


def plus_capture():
    rng = np.random.default_rng(2)
    rows = []
    for i in range(40):
        v = [f"{x:+.5f}" if (i + j) % 3 == 0 else f"{x:.5f}"
             for j, x in enumerate(rng.uniform(-1, 1, 3))]
        rows.append((1e-5 * i, v))
    return "plus\nTime, a, b, c\n" + _rows(*zip(*rows))


def clipped_capture(n=1_000_000, tail=200):
    """One track: the first million rows within 0.5 V, then `tail` rows at
    up to 3.2 V; past the first 10,000 rows (csv_deltat's) every time is
    the same, which csvtbin never reads."""
    rng = np.random.default_rng(3)
    head = "clipped\nTime [s], Channel 0\n" + _rows(
        1e-6 * np.arange(10_000),
        [[f"{x:.7f}"] for x in rng.uniform(-0.5, 0.5, 10_000)])
    block = "".join(f"0.0100000, {x:.7f}\n"
                    for x in rng.uniform(-0.5, 0.5, 1000))
    big = "".join(f"0.0100000, {x:.7f}\n"
                  for x in rng.uniform(-3.2, 3.2, tail))
    return head + block * ((n - 10_000) // 1000) + big


INPUTS = {"cap": capture, "ww": lambda: capture(ntrks=6, seed=4),
          "edge": edge_capture, "plus": plus_capture,
          "clipped": clipped_capture}

NRZI = ["-ntrks=9", "-nrzi", "-bpi=800", "-ips=50"]
# name: (input, argv); "X.tbin" inputs are made from X.csv by the JAX tool
# with the options of MADE
CASES = {
    "plain": ("cap", NRZI + ["cap.csv", "out.tbin"]),
    "one file": ("cap", ["-nrzi", "-descr=first reel", "cap"]),
    "mode gcr": ("cap", ["-mode=gcr", "-bpi=9042", "-ips=25",
                         "cap.csv", "out.tbin"]),
    "subsample": ("cap", NRZI + ["-subsample=3", "cap.csv", "out.tbin"]),
    "skip": ("cap", ["-pe", "-skip=100", "cap.csv", "out.tbin"]),
    "start end": ("cap", ["-start=0.0015", "-end=0.0032",
                          "cap.csv", "out.tbin"]),
    "starttime subsample": ("cap", ["-starttime=0.0012", "-endtime=0.003",
                                    "-subsample=2", "cap.csv", "out.tbin"]),
    "stopaft": ("cap", ["-stopaft=777", "-skip=5", "cap.csv", "out.tbin"]),
    "invert reverse": ("cap", ["-invert", "-reverse", "cap.csv",
                               "out.tbin"]),
    "digit order": ("cap", ["-order=7654321P0", "cap.csv", "out.tbin"]),
    "ww order": ("ww", ["-ww", "-order=ClMcLm", "ww.csv", "out.tbin"]),
    "scale": ("cap", ["-scale=2.5", "cap.csv", "out.tbin"]),
    "maxvolts above": ("cap", ["-maxvolts=3", "cap.csv", "out.tbin"]),
    "maxvolts below": ("cap", ["-maxvolts=0.5", "cap.csv", "out.tbin"]),
    "graph": ("cap", ["-graph=64", "cap.csv", "out.tbin"]),
    "scanfast edges": ("edge", [f"-maxvolts={MAXV}", "edge.csv",
                                "out.tbin"]),
    "plus signs": ("plus", ["plus.csv", "out.tbin"]),
    "clipped": ("clipped", ["-maxvolts=0.5", "clipped.csv", "out.tbin"]),
    "clipped redo": ("clipped", ["-redo", "clipped.csv", "out.tbin"]),
    "read": ("cap.tbin", ["-read", "cap.tbin", "out.csv"]),
    "read one file": ("cap.tbin", ["-read", "cap"]),
    "read by extension": ("cap.tbin", ["cap.tbin", "out.csv"]),
    "read trims": ("cap.tbin", ["-read", "-skip=10", "-start=0.00105",
                                "-stopaft=2000", "-end=0.0025", "cap.tbin",
                                "out.csv"]),
    "read end": ("cap.tbin", ["-read", "-end=0.002", "cap.tbin",
                              "out.csv"]),
    "read order": ("cap.tbin", ["-read", "-order=7654321P0", "cap.tbin",
                                "out.csv"]),
    "read stagger": ("cap.tbin", ["-read", "-stagger", "cap.tbin",
                                  "out.csv"]),
    "read stagger 2.0": ("cap.tbin", ["-read", "-stagger=2.0", "cap.tbin",
                                      "out.csv"]),
    "showheader": ("ww.tbin", ["-showheader", "ww.tbin"]),
    "showheader one file": ("cap.tbin", ["-showheader", "cap"]),
}
MADE = {"cap": ["-nrzi", "-bpi=800", "-ips=50", "-invert", "-descr=reel 1"],
        "ww": ["-ww", "-order=ClMcLm", "-invert", "-reverse", "-descr=ww"]}
REPLICA = ("plain", "subsample", "start end", "digit order", "ww order",
           "scanfast edges", "plus signs", "graph")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("csvtbin_inputs")
    for name, make in INPUTS.items():
        (d / f"{name}.csv").write_text(make())
    for name, argv in MADE.items():
        cwd = os.getcwd()
        os.chdir(d)
        try:
            assert jcsvtbin.main(argv + [f"{name}.csv", f"{name}.tbin"]) == 0
        finally:
            os.chdir(cwd)
    return d


def _no_native(monkeypatch):
    def raise_(*a, **k):
        raise RuntimeError("native IO library unavailable")
    monkeypatch.setattr(jnative, "csv_scan_native", raise_)
    monkeypatch.setattr(tnative, "csv_scan_native", raise_)


def _run_tools(tmp_path, monkeypatch, capsys, inputs, src, argv):
    """Both tools' main(argv) on a copy of `src` in a directory each:
    returns ({"j": (rc, stdout), "t": ...}, the two directories)."""
    runs = {}
    for d, tool in TOOLS:
        (tmp_path / d).mkdir()
        (tmp_path / d / src).write_bytes((inputs / src).read_bytes())
        monkeypatch.chdir(tmp_path / d)
        capsys.readouterr()
        rc = tool.main(list(argv))
        runs[d] = (rc, capsys.readouterr().out)
    return runs


def _same_files(tmp_path, src):
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "t"))
    for n in names:
        a = bytearray((tmp_path / "j" / n).read_bytes())
        b = bytearray((tmp_path / "t" / n).read_bytes())
        if n.endswith(".tbin") and n != src:
            assert a[:7] == b"TBINHDR"
            a[STAMP] = b[STAMP] = bytes(STAMP.stop - STAMP.start)
        assert a == b, n
    return names


@pytest.mark.parametrize("name,scanner", [(n, "native") for n in CASES]
                         + [(n, "replica") for n in REPLICA])
def test_csvtbin_matches_jax(name, scanner, inputs, tmp_path, monkeypatch,
                             capsys):
    src, argv = CASES[name]
    src = src if src.endswith(".tbin") else src + ".csv"
    if scanner == "replica":
        _no_native(monkeypatch)
    else:
        assert tnative.available() and jnative.available()
    runs = _run_tools(tmp_path, monkeypatch, capsys, inputs, src, argv)
    assert runs["t"] == runs["j"]
    assert runs["t"][0] == 0
    names = _same_files(tmp_path, src)
    out = runs["t"][1]
    if name == "graph":
        assert "out.tbin.graph.csv" in names
    if name == "maxvolts below":
        assert "maxvolts was increased from 0.5" in out
    if name.startswith("clipped"):
        assert "*** WARNING ***" in out
        assert ("redoing the conversion" in out) == (name == "clipped redo")
    if name.startswith("read"):
        assert "out.csv" in names or "cap.csv" in names
    if name == "showheader":
        assert "-order=ClMcLm" in out and "inverted" in out


def test_scanfast_picks_other_samples(inputs, tmp_path, monkeypatch,
                                      capsys):
    """The scanfast edge capture is not vacuous: its float32 digits differ
    from a correctly rounded parse on many tokens, and the .tbin holds
    other int16 samples there than a correctly rounded parse would give."""
    runs = _run_tools(tmp_path, monkeypatch, capsys, inputs, "edge.csv",
                      CASES["scanfast edges"][1])
    assert runs["t"][0] == 0
    _, samples = ttb.read_tbin(str(tmp_path / "t" / "out.tbin"))
    _, _, fold = tnative.csv_scan_native(str(inputs / "edge.csv"),
                                         scanfast=True)
    lines = (inputs / "edge.csv").read_text().splitlines()[2:]
    exact = np.asarray([[np.float32(float(x)) for x in ln.split(",")[1:]]
                        for ln in lines], np.float32)
    assert (fold != exact).sum() > 100
    conv = (exact / np.float32(MAXV)) * np.float32(32767.0)
    conv = np.trunc(conv + np.where(exact < 0, np.float32(-0.5),
                                    np.float32(0.5))).astype(np.int16)
    assert (samples != conv).sum() > 50


# ---------------------------------------------------------------------------
# the scanners
# ---------------------------------------------------------------------------

HAND = ("title\nTime [s], a, b, c\n"
        "1.5e-3, -2.25E+1, +3, 0.1234567\n"
        "0.0015004,.5, -0.0, 12.75e-2\r\n"
        "0.0015008, 7, 1e2, -3.3333333, 99\n")


def _bits(v):
    return np.asarray(v, np.float32).view(np.int32)


@pytest.mark.parametrize("name", ["cap", "edge", "plus", "hand"])
def test_read_csv_matches_jax(name, inputs, tmp_path):
    path = str(inputs / f"{name}.csv")
    if name == "hand":
        path = str(tmp_path / "hand.csv")
        with open(path, "w") as f:
            f.write(HAND)
    assert jnative.available() and tnative.available()
    j0, jdt, jv = jcsv.read_csv(path)
    for t0, dt, v in (tcsv.read_csv(path), tcsv.read_csv_numpy(path)):
        assert (t0, dt) == (j0, jdt)
        assert v.dtype == np.float32 and v.shape == jv.shape
        np.testing.assert_array_equal(_bits(v), _bits(jv))


@pytest.mark.parametrize("name", ["cap", "edge", "plus"])
def test_scanfast_matches_jax(name, inputs, monkeypatch):
    path = str(inputs / f"{name}.csv")
    native = tcsvtbin._read_csv_scanfast(path)
    want = jnative.csv_scan_native(path, scanfast=True)
    assert native[:2] == want[:2]
    np.testing.assert_array_equal(_bits(native[2]), _bits(want[2]))
    _no_native(monkeypatch)
    replica = tcsvtbin._read_csv_scanfast(path)
    want = jcsvtbin._read_csv_scanfast(path)
    assert replica[:2] == want[:2]
    np.testing.assert_array_equal(_bits(replica[2]), _bits(want[2]))
    if name == "plus":        # the two branches differ on "+" fields
        assert (native[2] != replica[2]).any()
        assert (native[2] == 0).sum() > (replica[2] == 0).sum()
    else:
        np.testing.assert_array_equal(_bits(native[2]), _bits(replica[2]))


def test_csv_scan_native_raises_without_the_library(monkeypatch, tmp_path):
    monkeypatch.setattr(tnative, "_load", lambda: None)
    assert not tnative.available()
    with pytest.raises(RuntimeError):
        tnative.csv_scan_native(str(tmp_path / "x.csv"))
    path = tmp_path / "hand.csv"
    path.write_text(HAND)
    t0, dt, v = tcsv.read_csv(str(path))       # the numpy reader
    j0, jdt, jv = jcsv.read_csv(str(path))
    assert (t0, dt) == (j0, jdt)
    np.testing.assert_array_equal(_bits(v), _bits(jv))


def test_csv_scan_native_raises_on_a_bad_file(tmp_path):
    path = tmp_path / "bad.csv"
    path.write_text("title\nno commas here\n1 2 3\n")
    for mod in (tnative, jnative):
        with pytest.raises(RuntimeError, match=r"csv_scan failed \(-4\)"):
            mod.csv_scan_native(str(path))
