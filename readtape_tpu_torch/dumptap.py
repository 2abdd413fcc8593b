"""dumptap: standalone SIMH .tap file dumper (dumptap.c).

Deprecated in the reference in favor of `readtape -tapread` (dumptap.c:49-51)
but kept for compatibility. Output layout mirrors dumptap.c:255-301: a
two-line header, then one line per record prefixed with '!' when the record
was flagged in error, bytes as hex / 6-bit octal / characters in one of six
code sets, wrapped at -linesize with the character column appended when both
a numeric and a character mode are chosen.

Usage: python -m readtape_tpu_torch.dumptap [options] <basefilename>

The port's copy of readtape_tpu/dumptap.py, on the port's character sets:
host code, no work on the card.
"""

from __future__ import annotations

import struct
import sys

from .out.charsets import BCD1401, BURROUGHS, EBCDIC, SDS_INTERNAL

USAGE = """dumptap: display contents of a SIMH .tap file
use: dumptap <options> <filename>
  the input is <filename>.tap, a SIMH tape image
  the output is <filename>.<options>.txt
options:
  -bcd      show BCD characters
  -ebcdic   show EBCDIC characters
  -ascii    show ASCII characters
  -B5500    show Burroughs B5500 internal code characters
  -sixbit   show DEC sixbit characters
  -SDS      show SDS (940, etc.) internal code characters
  -octal    show octal numeric data
  -hex      show hex numeric data
  -linesize=nn   each line displays nn bytes
the default is -ascii -linesize=80"""

CHAR_OPTS = {"bcd": "-BCD", "ebcdic": "-EBCDIC", "ascii": "-ASCII",
             "b5500": "-B5500", "sixbit": "-SIXBIT", "sds": "-SDS"}
NUM_OPTS = {"hex": "-hex", "octal": "-octal"}


def _render(ch: int, chartype: str) -> str:
    if chartype == "ascii":
        c = chr(ch & 0x7F)
        return c if c.isprintable() and ch < 0x7F and ch >= 0x20 else " "
    if chartype == "sixbit":
        return chr((ch & 0x3F) + 32)
    if chartype == "ebcdic":
        return chr(EBCDIC[ch])
    if chartype == "bcd":
        return chr(BCD1401[ch & 0x3F])
    if chartype == "b5500":
        return chr(BURROUGHS[ch & 0x3F])
    if chartype == "sds":
        return chr(SDS_INTERNAL[ch & 0x3F])
    return "?"


def dump(basename: str, chartype: str | None, numtype: str | None,
         linesize: int = 0) -> str:
    """Dump <basename>.tap; returns the output filename."""
    if chartype is None and numtype is None:
        chartype = "ascii"
    doboth = chartype is not None and numtype is not None
    if linesize == 0:
        linesize = 40 if doboth else 80

    numpart = NUM_OPTS[numtype][1:] if numtype else ""
    charpart = CHAR_OPTS[chartype][1:] if chartype else ""
    outname = f"{basename}.{numpart}{'.' if doboth else ''}{charpart}.txt"

    with open(basename + ".tap", "rb") as inf, \
            open(outname, "w") as txtf:
        txtf.write(f"dumptap file:{basename}\n")
        txtf.write("options: %s %s -LINESIZE=%d\n" %
                   (NUM_OPTS[numtype] if numtype else " ",
                    CHAR_OPTS[chartype] if chartype else " ", linesize))

        def marker():
            b = inf.read(4)
            if len(b) < 4:
                raise SystemExit("endfile with no end-of-medium marker")
            return struct.unpack("<I", b)[0]

        while True:
            m = marker()
            if m == 0xFFFFFFFF:
                txtf.write(".tap end of medium\n")
                break
            if m == 0xFFFFFFFE:
                txtf.write(".tap erase gap\n")
                continue
            if m == 0x00000000:
                txtf.write(".tap tape mark\n")
                continue
            if m & 0x7F000000:
                raise SystemExit(f".tap bad marker: {m:08X}")
            length = m & 0xFFFFFF
            txtf.write("%c%4d: " % ("!" if m & 0x80000000 else " ", length))
            data = inf.read(length + (length & 1))
            line = []
            for i in range(length):
                ch = data[i]
                if len(line) >= linesize:
                    if doboth:
                        txtf.write("  " + "".join(
                            _render(c, chartype) for c in line))
                    txtf.write("\n       ")
                    line = []
                line.append(ch)
                if numtype == "hex":
                    txtf.write("%02X" % ch)
                elif numtype == "octal":
                    txtf.write("%02o" % (ch & 0x3F))
                else:
                    txtf.write(_render(ch, chartype))
            if doboth:
                txtf.write("  " * (linesize - len(line)) + "  " +
                           "".join(_render(c, chartype) for c in line))
            txtf.write("\n")
            m2 = marker()
            if (m2 & 0xFFFFFF) != length:
                raise SystemExit(f"bad ending marker: {m2:08X}")
    return outname


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(USAGE, file=sys.stderr)
        return 4
    chartype = numtype = None
    linesize = 0
    base = None
    for a in argv:
        if a.startswith("-"):
            key = a[1:].lower()
            if key in CHAR_OPTS:
                chartype = key
            elif key in NUM_OPTS:
                numtype = key
            elif key.startswith("linesize="):
                linesize = int(key.split("=", 1)[1])
            else:
                print(USAGE, file=sys.stderr)
                raise SystemExit(f"bad option: {a}")
        else:
            base = a[:-4] if a.endswith(".tap") else a
    if base is None:
        raise SystemExit("no filename given")
    out = dump(base, chartype, numtype, linesize)
    print(f"created {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
