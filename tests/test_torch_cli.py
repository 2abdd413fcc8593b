"""The port's command line (readtape_tpu_torch/cli.py) against the JAX
package's (readtape_tpu/cli.py), on the CPU:

(a) write_outputs alone, no decode: one list of BlockResults holding every
    kind of block (data, tapemarks, a bad block, a zero-length block,
    VOL1/HDR1/HDR2/EOF1 labels, each error and warning kind, gaps) and a
    stats dict for NRZI, PE, GCR and Whirlwind, under option sets that
    reach each output: .tap, .bin files split at tapemarks and named from
    HDR1, .txt dumps, the .log, .peakstats.csv, -sumt and -sumc;
(b) parse_option over every option of the usage text, alone and in
    sequences, to the same Options fields;
(c) both command lines end to end on a short 9-track NRZI tape with HDR1
    and EOF1 labels, data blocks and tapemarks (the JAX package on the
    CPU, the port with device="cpu"), then -tapread of its .tap and a
    two-line -f file list;
(d) -parmscan: the GCR grid (cut by READTAPE_PARMSCAN_LIMIT, in chunks of
    READTAPE_PARMSCAN_CHUNK) logs the same lines; on an NRZI tape both log
    the same "ignored" line and write the same .tap;
(e) on a host without a card, python -m readtape_tpu_torch exits non-zero
    naming cuda and writes nothing.

Tolerance: none. Every file written is byte-equal, apart from three lines
of a .log (the banner, "version ... running on <time>" and "... processed
in N seconds") and line 2 of a .txt (the program's name and the time).
Each run happens in a directory of its own on the same relative base
name, since the outputs name their paths.
"""

import os
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

from readtape_tpu import cli as jcli
from readtape_tpu.decode import pipeline as jpl
from readtape_tpu.formats import tbin as tb
from readtape_tpu.out.charsets import EBCDIC
from readtape_tpu.synth import default_spec, synthesize_tape
from readtape_tpu_torch import cli as tcli
from readtape_tpu_torch.decode import fused as tfu
from readtape_tpu_torch.decode import pipeline as tpl

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = (("j", jcli, jpl, {}), ("t", tcli, tpl, dict(device="cpu")))


def _label(text):
    """An 80-byte EBCDIC label block from its text."""
    rev = {}
    for i in range(256):
        rev.setdefault(chr(EBCDIC[i]), i)
    return bytes(rev[c] for c in text.ljust(80))


def _ibm(kind, dsid="PAYROLL.DATA", blkcnt="000002"):
    return _label(kind + dsid.ljust(17) + "MYTAPE" + "0001" + "0002"
                  + " " * 6 + " 77123" + " 77200" + " " + blkcnt
                  + "IBM OS/VS 370")


VOL1 = _label("VOL1MYTAPE" + " " * 31 + "OWNERNAME")
HDR2 = _label("HDR2F0800000080" + "1" + " " + "JOBNAME/STEPNAME")


def _masked(path):
    """The lines of an output file, with the lines that may differ between
    the two packages masked."""
    lines = open(path, encoding="latin-1").read().split("\n")
    if path.endswith(".txt"):
        assert lines[1].startswith("created by readtape_tpu")
        return lines[:1] + lines[2:]
    if path.endswith(".log"):
        return ["<masked>" if (ln.startswith(("readtape_tpu: ",
                                              "readtape_tpu_torch: "))
                               or (ln.startswith("version ")
                                   and " running on " in ln)
                               or " samples were processed in " in ln)
                else ln for ln in lines]
    return None


def _same_outputs(tmp_path, inputs=()):
    """Every file the two runs wrote, equal under the mask; returns their
    names."""
    dj, dt = tmp_path / "j", tmp_path / "t"
    names = sorted(set(os.listdir(dj)) - set(inputs))
    assert names == sorted(set(os.listdir(dt)) - set(inputs))
    for n in names:
        a, b = str(dj / n), str(dt / n)
        m = _masked(a)
        if m is None:
            assert open(a, "rb").read() == open(b, "rb").read(), n
        else:
            assert m == _masked(b), n
    return names


# ---------------------------------------------------------------------------
# (a) write_outputs, no decode
# ---------------------------------------------------------------------------

MODES = {"nrzi": (tb.MODE_NRZI, 9, 800.0, 50.0, 8),
         "pe": (tb.MODE_PE, 9, 1600.0, 50.0, 8),
         "gcr": (tb.MODE_GCR, 9, 9042.0, 25.0, 5),
         "ww": (tb.MODE_WW, 6, 100.0, 30.0, 1)}

OPTION_SETS = {
    "tap": ["-tap"],
    "bin": [],
    "nolabels": ["-nolabels"],
    "textfile": ["-textfile", "-hex", "-ebcdic"],
    "octal2": ["-octal2", "-bcd", "-linesize=40"],
    "quiet": ["-q", "-nm"],
    "verbose": ["-v", "-showibg=0"],
    "deskew": ["-deskew", "-v", "-tap"],
    "summaries": ["-sumt=summary.log", "-sumc=summary.csv", "-order=CMLcml"],
}


def _f32(x):
    return np.float32(x).item()


def _detail(rng, **kw):
    d = dict(minbits=0, maxbits=0, track_mismatch=0, vparity_errs=0,
             crc_errs=0, lrc_errs=0, missed_midbits=0, corrected_bits=0,
             faked_tracks=0, avg_bit_spacing=_f32(rng.uniform(18, 21)),
             alltrk_max_agc=_f32(rng.uniform(1.0, 1.5)),
             alltrk_min_agc=_f32(rng.uniform(0.5, 1.0)))
    d.update(kw)
    return d


def _blocks(BlockResult, seed):
    """Every kind of block write_outputs meets, in tape order."""
    rng = np.random.default_rng(seed)
    t = [0.002]
    out = []

    def add(kind, data=b"", gap=0.004, **kw):
        t0 = t[0] + gap
        t1 = t0 if kind == "tapemark" else t0 + 0.003 + 1e-6 * len(data)
        t[0] = t1
        out.append(BlockResult(kind, data, t_start=t0, t_end=t1, **kw))

    def data(n):
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    add("data", VOL1, detail=_detail(rng))
    add("data", _ibm("HDR1"), detail=_detail(rng))
    add("data", HDR2, errcount=1, detail=_detail(rng, vparity_errs=1))
    add("tapemark")
    add("data", data(200), detail=_detail(rng))
    add("data", data(77), parmset=3, tries=4, errcount=5,
        detail=_detail(rng, track_mismatch=3, vparity_errs=2, crc_errs=1,
                       lrc_errs=1))
    add("data", data(150), parmset=2, tries=3, warncount=2,
        detail=_detail(rng, corrected_bits=4, gcr_bad_dgroups=1))
    add("data", data(64), parmset=1, tries=2, errcount=1, warncount=1,
        detail=_detail(rng, ecc_errs=1, corrected_bits=1))
    add("data", b"", detail=_detail(rng))
    add("badblock", parmset=4, tries=5, errcount=2, warncount=0,
        detail=_detail(rng, minbits=97, maxbits=120))
    add("data", data(33), detail=_detail(rng, alltrk_min_agc=_f32(3.4e38),
                                          avg_bit_spacing=0.0))
    add("data", data(90), gap=6.25, detail=_detail(rng))
    add("tapemark")
    add("data", _ibm("EOF1"), detail=_detail(rng))
    add("tapemark")
    add("data", data(41), gap=0.7, detail=_detail(rng))
    add("tapemark")
    add("tapemark")
    return out


def _stats(mode, seed):
    m, T, bpi, ips, P = MODES[mode]
    rng = np.random.default_rng(seed)
    hist = rng.integers(0, 400, (T, 50)).astype(np.int64)
    if mode == "gcr":
        # peaks at a different place on each track: significant skew
        hist[:] = 0
        for trk in range(T):
            hist[trk, 5 + 3 * trk:9 + 3 * trk] = rng.integers(50, 300, 4)
    if mode == "pe":
        hist[3] = 0                 # a silent track: no skew report
    if mode == "ww":
        hist[:] = 0                 # no peak statistics at all
    tried = rng.integers(0, 30, P)
    tried[1:2] = 0
    st = dict(nblocks=9, ntapemarks=5, nerrblocks=3, nwarnblocks=2,
              nunusable=1, nmismatched=1, nmidbiterr=2, ncorrected=1,
              ngoodmultiple=4, tried=tried,
              chosen=np.minimum(tried, rng.integers(0, 20, P)),
              deskew_percent=12.75, skew=[0] * T, peak_hist=hist,
              peak_trksums=hist[:, 1:49].sum(axis=1),
              peak_bins=tpl._peakstat_bins(m, 1.0 / (bpi * ips)))
    if mode == "ww":
        st.update(num_flux_changes=2, flux_dir_final="pos")
    return st


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("optset", list(OPTION_SETS))
def test_write_outputs(mode, optset, tmp_path, monkeypatch, capsys):
    m, T, bpi, ips, _ = MODES[mode]
    args = OPTION_SETS[optset] + [f"-ntrks={T}"]
    hdr = types.SimpleNamespace(flags=tb.TBIN_INVERTED)
    for d, cli, pl, _ in PACKAGES:
        (tmp_path / d).mkdir()
        monkeypatch.chdir(tmp_path / d)
        o = cli.Options()
        for a in args:
            assert cli.parse_option(o, a)
        dopts = pl.DecodeOptions(mode=m, ntrks=T, bpi=bpi, ips=ips,
                                 deltat=1.28e-6, maxvolts=6.0)
        log = cli.Logger("w.log", o.quiet, o.sumt)
        cli.write_outputs(o, "w", _blocks(pl.BlockResult, 7), _stats(mode, 8),
                          dopts, log, time.time(), 1_234_567, t0=0.001,
                          deltat=1.28e-6,
                          hdr=hdr if optset == "summaries" else None)
        log.close()
    names = _same_outputs(tmp_path)
    assert ("w.peakstats.csv" in names) == (mode != "ww")
    if optset == "tap":
        assert "w.tap" in names and not any(n.endswith(".bin")
                                            for n in names)
    if optset == "bin":
        assert "w-001-PAYROLL.DATA.bin" in names and "w.002.bin" in names
    if optset == "summaries":
        assert {"summary.log", "summary.csv"} <= set(names)
    if optset == "verbose":
        assert "sec interblock gap!" in (tmp_path / "t" / "w.log").read_text()


# ---------------------------------------------------------------------------
# (b) option parsing
# ---------------------------------------------------------------------------

OPTIONS = [
    ["-ntrks=7"], ["-order=01234567P"], ["-order=CMLcml"], ["-pe"],
    ["-nrzi"], ["-gcr"], ["-whirlwind"], ["-ips=37.5"], ["-bpi=1600"],
    ["-zeros"], ["-differentiate"], ["-even"], ["-revparity=3"],
    ["-invert"], ["-fluxdir=pos"], ["-fluxdir=auto"], ["-reverse"],
    ["-skip=100"], ["-blklimit=5"], ["-subsample=2"], ["-showibg=0"],
    ["-tap"], ["-deskew"], ["-skew=1,2,3"], ["-correct"], ["-correct2"],
    ["-parmscan"], ["-addparity"], ["-tbin"], ["-nolog"], ["-nolabels"],
    ["-textfile"], ["-hex"], ["-octal"], ["-octal2"]] + [
    ["-" + c] for c in tcli.CHARTYPES] + [
    ["-linesize=40"], ["-dataspace=4"], ["-linefeed"], ["-tapread"],
    ["-outf=out/x"], ["-outp=Dir/"], ["-sumt=S.txt"], ["-sumc=S.csv"],
    ["-m"], ["-nm"], ["-v"], ["-v3"], ["-q"], ["-f"], ["-l"],
    ["-adjskew"], ["-mesh"], ["-mesh=4x2"], ["-correctdbg"],
    ["-nocorrect"], ["-trace"], ["-trace=0.5"], ["-trace=0.5,0.75"],
    ["-NRZI", "-Tap"], ["-ips=10", "-gcr"], ["-gcr", "-ips=10"],
    ["-m", "-whirlwind"], ["-whirlwind", "-nm"], ["-whirlwind", "-bpi=50"],
    ["-correct2", "-nocorrect"], ["-v", "-q"], ["-q", "-v2"],
    ["-skew=0,1", "-hex", "-ebcdic", "-octal2"], ["file.tbin"]]


def test_chartypes_and_usage():
    assert tcli.CHARTYPES == jcli.CHARTYPES
    assert tcli.MODE_NAME == jcli.MODE_NAME
    words = {w.split("=")[0].split("[")[0] for w in jcli.USAGE.split()
             if w.startswith("-")}
    tested = {a[0].split("=")[0].lower() for a in OPTIONS}
    assert words <= tested, words - tested


@pytest.mark.parametrize("args", OPTIONS, ids=" ".join)
def test_parse_option(args):
    oj, ot = jcli.Options(), tcli.Options()
    assert oj.__dict__ == ot.__dict__
    for a in args:
        assert jcli.parse_option(oj, a) == tcli.parse_option(ot, a)
    assert oj.__dict__ == ot.__dict__


@pytest.mark.parametrize("bad", ["-bogus", "-fluxdir=up", "-ntrks=x"])
def test_bad_option(bad):
    excs = []
    for cli in (jcli, tcli):
        with pytest.raises((SystemExit, AssertionError, ValueError)) as e:
            cli.parse_option(cli.Options(), bad)
        excs.append(e.type)
    assert excs[0] == excs[1]


# ---------------------------------------------------------------------------
# (c) end to end, (d) -parmscan
# ---------------------------------------------------------------------------

def _nrzi_tape():
    """9-track NRZI: HDR1, a data block, tapemark, a data block, EOF1,
    tapemark."""
    rng = np.random.default_rng(31)
    spec = default_spec(tb.MODE_NRZI, ibg_secs=0.003, start_gap_secs=0.003)
    return synthesize_tape(spec, [
        ("block", _ibm("HDR1")),
        ("block", rng.integers(0, 256, 120, dtype=np.uint8).tobytes()),
        ("tapemark",),
        ("block", rng.integers(0, 256, 64, dtype=np.uint8).tobytes()),
        ("block", _ibm("EOF1")), ("tapemark",)])


def _gcr_tape():
    """tests/test_parmscan.py's tape: one GCR block with 0.025-bit time
    jitter, then a tapemark."""
    rng = np.random.default_rng(77)
    block = bytes(rng.integers(0, 256, 154, dtype=np.uint8))
    spec = default_spec(tb.MODE_GCR, time_jitter_bits=0.025, seed=77)
    return synthesize_tape(spec, [("block", block), ("tapemark",)])


def _run_both(tmp_path, monkeypatch, tape, runs):
    """Each package's command line on the same .tbin in a directory of
    its own: runs = [argv, ...]; returns the exit codes."""
    hdr, samples = tape
    rcs = []
    for d, cli, _, kw in PACKAGES:
        (tmp_path / d).mkdir(exist_ok=True)
        tb.write_tbin(str(tmp_path / d / "t.tbin"), hdr, samples)
        monkeypatch.chdir(tmp_path / d)
        rcs.append([cli.main(argv, **kw) for argv in runs])
    return rcs


def test_end_to_end_labels_and_bins(tmp_path, monkeypatch, capsys):
    calls = tfu.nrzi_fused_scan_plain.calls
    rcs = _run_both(tmp_path, monkeypatch, _nrzi_tape(), [
        ["-v", "-m", "-nrzi", "-textfile", "-hex", "-ebcdic",
         "-sumc=sum.csv", "t"]])
    assert rcs == [[0], [0]]
    assert tfu.nrzi_fused_scan_plain.calls > calls
    names = _same_outputs(tmp_path, inputs=["t.tbin"])
    assert {"t-001-PAYROLL.DATA.bin", "t.log",
            "t.peakstats.csv", "t.hex.ebcdic.txt", "sum.csv"} <= set(names)
    log = (tmp_path / "t" / "t.log").read_text()
    assert "tape label HDR1" in log and "tape label EOF1" in log


def test_end_to_end_tap_tapread_filelist(tmp_path, monkeypatch, capsys):
    rcs = _run_both(tmp_path, monkeypatch, _nrzi_tape(), [
        ["-q", "-nrzi", "-tap", "-outp=a_", "t"],
        ["-tapread", "-hex", "-ascii", "-outp=a_", "a_t.tap"]])
    assert rcs == [[0, 0], [0, 0]]
    for d in "jt":
        (tmp_path / d / "list.txt").write_text(
            "-nrzi -m -tap -outp=b_ t\n-nrzi -nm -textfile -outp=c_ t.tbin\n")
    rcs = _run_both(tmp_path, monkeypatch, _nrzi_tape(), [["-f", "list"]])
    assert rcs == [[0], [0]]
    names = _same_outputs(tmp_path, inputs=["t.tbin", "list.txt"])
    assert {"a_t.tap", "a_a_t.hex.ascii.txt", "b_t.tap", "b_t.log",
            "c_t.txt", "c_t.log"} <= set(names)
    assert "t.log" not in names             # each run logs to its -outp
    tap = (tmp_path / "t" / "a_t.tap").read_bytes()
    assert tap == (tmp_path / "t" / "b_t.tap").read_bytes()


def test_parmscan_gcr(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("READTAPE_PARMSCAN_LIMIT", "8")
    monkeypatch.setenv("READTAPE_PARMSCAN_CHUNK", "4")
    rcs = _run_both(tmp_path, monkeypatch, _gcr_tape(), [
        ["-v", "-m", "-gcr", "-ips=25", "-tap", "-parmscan", "t"]])
    assert rcs == [[0], [0]]
    _same_outputs(tmp_path, inputs=["t.tbin"])
    lines = [ln for ln in (tmp_path / "t" / "t.log").read_text().split("\n")
             if ln.startswith("clk_alpha ")]
    assert len(lines) == 8 and lines[0].startswith(
        "clk_alpha 0.010 pulseadj 0.200 z1pt 1.400 z2pt 2.200 firsterr")


def test_parmscan_nrzi_ignored(tmp_path, monkeypatch, capsys):
    rcs = _run_both(tmp_path, monkeypatch, _nrzi_tape(), [
        ["-v", "-m", "-nrzi", "-tap", "-parmscan", "t"]])
    assert rcs == [[0], [0]]
    _same_outputs(tmp_path, inputs=["t.tbin"])
    assert ("-parmscan is only implemented for GCR"
            in (tmp_path / "t" / "t.log").read_text())


def test_parmscan_grid():
    assert tpl.parmscan_grid() == jpl.parmscan_grid()
    assert len(tpl.parmscan_grid()) == 5280


# ---------------------------------------------------------------------------
# (e) no card
# ---------------------------------------------------------------------------

def test_no_card_no_output(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    hdr, samples = _nrzi_tape()
    tb.write_tbin(str(tmp_path / "t.tbin"), hdr, samples)
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-m", "readtape_tpu_torch", "-nrzi",
                        "-tap", "-textfile", "t"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "cuda" in r.stderr
    assert os.listdir(tmp_path) == ["t.tbin"]


@pytest.mark.parametrize("opt,name", [("-adjskew", "-adjskew"),
                                      ("-correctdbg", "-correctdbg"),
                                      ("-trace", "-trace")])
def test_unported_options_raise_before_reading(opt, name, tmp_path,
                                               monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotImplementedError, match=name):
        tcli.main(["-nrzi", opt, "missing"], device="cpu")
    assert os.listdir(tmp_path) == []
