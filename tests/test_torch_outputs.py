"""The port's output writers (readtape_tpu_torch/out/) against the JAX
package's (readtape_tpu/out/), on inputs made from a seed with numpy:
every character set's translate over all 256 bytes, the interpreted text
dump over every number type and several character sets and layouts, the
IBM labels, and the peak-statistics CSV in its NRZI and its other form.

Tolerance: none. Files are byte-equal, apart from line 2 of a .txt, which
names the program and the time it ran.
"""

import numpy as np
import pytest

from readtape_tpu.out import charsets as jcs
from readtape_tpu.out import labels as jlb
from readtape_tpu.out import peakstats as jps
from readtape_tpu.out import textfile as jtf
from readtape_tpu_torch.out import charsets as tcs
from readtape_tpu_torch.out import labels as tlb
from readtape_tpu_torch.out import peakstats as tps
from readtape_tpu_torch.out import textfile as ttf

CHARTYPES = ["ascii", "ebcdic", "bcd", "b5500", "sixbit", "sds", "sdsm",
             "flexo", "adage", "adagetape", "cdc", "univac", "none"]


@pytest.mark.parametrize("chartype", CHARTYPES)
def test_translate(chartype):
    for odd in (False, True):
        mine = [tcs.translate(c, chartype, odd) for c in range(256)]
        theirs = [jcs.translate(c, chartype, odd) for c in range(256)]
        assert mine == theirs


def _records(seed, n=6):
    """Records of random bytes (some with line feeds, one of odd length,
    one empty) and their error/warning counts."""
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n):
        data = bytearray(rng.integers(0, 256, int(rng.integers(1, 150)),
                                      dtype=np.uint8).tobytes())
        if i % 2:
            data[len(data) // 2] = 0x0A
        recs.append((bytes(data), int(i % 3 == 1), int(i % 4 == 2)))
    recs.append((b"\x41\x0a\x42", 1, 1))
    return recs


def _write_txt(mod, path, opts, tapread, ntrks, seed):
    txt = mod.TextFile(path, mod.TxtOptions(**opts), "0.1.0", ntrks=ntrks,
                       tapread=tapread)
    for i, (data, err, warn) in enumerate(_records(seed)):
        if i == 2:
            txt.tapemark(None if tapread else 0.0123)
        if i == 4:
            txt.message("0.750 sec interblock gap!\n")
        if tapread:
            txt.output_record(data, err, 0)
        else:
            txt.output_record(data, err, warn, blocknum=i + 1,
                              timenow=0.001 * (i + 1),
                              errinfo=f"{err} errs" if err else "ok")
    txt.close()


def _same_txt(a, b):
    la = open(a).read().splitlines()
    lb = open(b).read().splitlines()
    assert la[1].startswith("created by readtape_tpu ")
    assert lb[1].startswith("created by readtape_tpu_torch ")
    assert la[:1] + la[2:] == lb[:1] + lb[2:]


LAYOUTS = [dict(), dict(linesize=40), dict(dataspace=4),
           dict(linefeed=True, linesize=20), dict(linesize=16, dataspace=2)]


@pytest.mark.parametrize("numtype", ["none", "hex", "octal", "octal2"])
@pytest.mark.parametrize("chartype,layout", [
    ("none", 0), ("ascii", 1), ("ebcdic", 2), ("flexo", 3), ("bcd", 4)])
def test_textfile(numtype, chartype, layout, tmp_path, monkeypatch):
    seed = 10 * len(numtype) + layout
    for tapread in (False, True):
        for ntrks in (9, 7):
            opts = dict(numtype=numtype, chartype=chartype,
                        verbose=not tapread, **LAYOUTS[layout])
            if tapread and not opts.get("linesize"):
                opts["linesize"] = 64       # as run_tapread gives it
            for mod, d in ((jtf, "j"), (ttf, "t")):
                (tmp_path / d).mkdir(exist_ok=True)
                monkeypatch.chdir(tmp_path / d)
                _write_txt(mod, "x.txt", opts, tapread, ntrks, seed)
            _same_txt(tmp_path / "j" / "x.txt", tmp_path / "t" / "x.txt")
    assert (ttf.TxtOptions(numtype, chartype).suffix ==
            jtf.TxtOptions(numtype, chartype).suffix)


def _label(text):
    """An 80-byte EBCDIC label block from its text."""
    rev = {}
    for i in range(256):
        rev.setdefault(chr(jcs.EBCDIC[i]), i)
    return bytes(rev[c] for c in text.ljust(80))


LABELS = {
    "VOL1": "VOL1MYTAPE" + " " * 31 + "OWNERNAME",
    "HDR1": ("HDR1" + "PAYROLL.DATA".ljust(17) + "MYTAPE" + "0001"
             + "0002" + " " * 6 + " 77123" + " 77200" + " " + "000000"
             + "IBM OS/VS 370"),
    "EOF1": ("EOF1" + "PAYROLL.DATA".ljust(17) + "MYTAPE" + "0001"
             + "0002" + " " * 6 + " 77123" + " 77200" + " " + "000042"
             + "IBM OS/VS 370"),
    "EOV1": "EOV1" + "X".ljust(17) + "VOLSER" + "0002",
    "HDR2": "HDR2F0800000080" + "1" + " " + "JOBNAME/STEPNAME" + " " * 4
            + "B",
    "EOF2": "EOF2V0400000200" + "3" + " " + "J/S",
    "data": "HELLO, WORLD",
}


@pytest.mark.parametrize("kind", list(LABELS))
def test_labels(kind):
    data = _label(LABELS[kind])
    mine, theirs = tlb.parse_label(data), jlb.parse_label(data)
    if kind == "data":
        assert mine is None and theirs is None
        assert tlb.parse_label(data[:79]) is None
        return
    assert (mine.kind, mine.fields, mine.dataset_filename) == (
        theirs.kind, theirs.fields, theirs.dataset_filename)
    for errs in (0, 3):
        assert (tlb.describe_label(mine, errs) ==
                jlb.describe_label(theirs, errs))


@pytest.mark.parametrize("is_nrzi,ntrks,seed", [(True, 9, 1), (False, 9, 2),
                                                (True, 7, 3), (False, 6, 4)])
def test_peakstats(is_nrzi, ntrks, seed, tmp_path):
    rng = np.random.default_rng(seed)
    hist = rng.integers(0, 5000, (ntrks, 50)).astype(np.int64)
    hist[:, 1:20] = 0
    hist[-1] = 0                       # a track without transitions
    trksums = hist[:, 1:49].sum(axis=1)
    lb, bw = 1.25e-6 * seed, 0.5e-6 + 1e-7 * seed
    n_t = tps.write_peakstats(str(tmp_path / "t.csv"), hist, trksums, lb,
                              bw, is_nrzi)
    n_j = jps.write_peakstats(str(tmp_path / "j.csv"), hist, trksums, lb,
                              bw, is_nrzi)
    assert n_t == n_j
    assert (tmp_path / "t.csv").read_bytes() == \
        (tmp_path / "j.csv").read_bytes()
