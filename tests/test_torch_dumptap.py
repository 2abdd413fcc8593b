"""The port's .tap dumper (readtape_tpu_torch.dumptap) against the JAX
package's (readtape_tpu.dumptap), on the CPU: both tools' main, in process,
in a directory each, on the same .tap -- records shorter and longer than
the line size (an odd length among them, so the .tap pads it), one as
long as a line, an error-flagged record, tapemarks, an erase gap and the
end-of-medium marker, made from a numpy seed. Every character set alone,
with -hex and with -octal, and each number format alone, each at the
default and at three other line sizes: the same output file name, byte
for byte the same file, the same stdout. Then the errors: no argument,
a bad option, no file name, a .tap without its end-of-medium marker, and
a record whose two length markers differ give the same exit code and
message.

Tolerance: none.
"""

import struct

import numpy as np
import pytest

from readtape_tpu import dumptap as jdump
from readtape_tpu_torch import dumptap as tdump

TOOLS = (("j", jdump), ("t", tdump))
CHARS = [None, "bcd", "ebcdic", "ascii", "B5500", "sixbit", "SDS"]
NUMS = [None, "hex", "octal"]


def _record(data, error=False):
    m = struct.pack("<I", len(data) | (0x80000000 if error else 0))
    return m + data + b"\0" * (len(data) & 1) + m


def tap_bytes(seed=5):
    rng = np.random.default_rng(seed)
    blk = [bytes(rng.integers(0, 256, n, dtype=np.uint8))
           for n in (5, 131, 80, 40, 1, 97)]
    mark = struct.pack("<I", 0)
    return (_record(blk[0]) + _record(blk[1]) + mark + _record(blk[2])
            + _record(blk[3], error=True) + struct.pack("<I", 0xFFFFFFFE)
            + _record(blk[4]) + mark + _record(blk[5], error=True) + mark
            + struct.pack("<I", 0xFFFFFFFF))


def _run(tmp_path, monkeypatch, capsys, argv, tap=None):
    """Both tools on t.tap: {"j": (exit code or SystemExit message, stdout,
    stderr, {file: bytes}), "t": ...}."""
    out = {}
    for d, tool in TOOLS:
        (tmp_path / d).mkdir()
        (tmp_path / d / "t.tap").write_bytes(tap or tap_bytes())
        monkeypatch.chdir(tmp_path / d)
        capsys.readouterr()
        try:
            rc = tool.main(list(argv))
        except SystemExit as e:
            rc = ("exit", e.code)
        o, err = capsys.readouterr()
        files = {p.name: p.read_bytes() for p in (tmp_path / d).iterdir()
                 if p.name != "t.tap"}
        out[d] = (rc, o, err, files)
    return out


@pytest.mark.parametrize("num", NUMS)
@pytest.mark.parametrize("char", CHARS)
def test_dumptap_matches_jax(char, num, tmp_path, monkeypatch, capsys):
    opts = [f"-{x}" for x in (char, num) if x]
    for size in (0, 7, 16, 40):
        sub = tmp_path / f"size{size}"
        sub.mkdir()
        argv = opts + ([f"-linesize={size}"] if size else []) + ["t.tap"]
        runs = _run(sub, monkeypatch, capsys, argv)
        assert runs["t"] == runs["j"], argv
        rc, stdout, _, files = runs["t"]
        assert rc == 0 and len(files) == 1
        (name, text), = files.items()
        assert stdout == f"created t.{name[2:]}\n"
        lines = text.decode().splitlines()
        assert lines[0] == "dumptap file:t"
        assert lines[-1] == ".tap end of medium"
        assert sum(ln == ".tap tape mark" for ln in lines) == 3
        assert sum(ln.startswith("!") for ln in lines) == 2


@pytest.mark.parametrize("argv,tap", [
    ([], None),
    (["-bogus", "t"], None),
    (["-hex"], None),
    (["-hex", "t"], tap_bytes()[:-4]),
    (["-octal", "t"], _record(b"abc")[:-4] + struct.pack("<I", 4)),
], ids=["no argument", "bad option", "no file", "no eom", "bad marker"])
def test_dumptap_errors_match_jax(argv, tap, tmp_path, monkeypatch, capsys):
    runs = _run(tmp_path, monkeypatch, capsys, argv, tap)
    assert runs["t"] == runs["j"]
    rc = runs["t"][0]
    assert rc == 4 if not argv else isinstance(rc, tuple)
