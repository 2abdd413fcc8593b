"""Interpreted text-dump writer (the -textfile family of options).

Replicates the output format of textfile.c:180-305: per-block header lines
(verbose) or flag+length prefixes, hex/octal/octal2 numeric columns, 12
character interpretations, -linesize/-dataspace/-linefeed layout, and the
end-of-file summary.

The port's own copy of readtape_tpu/out/textfile.py: the port
imports nothing of the JAX package.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

from .charsets import translate


@dataclass
class TxtOptions:
    numtype: str = "none"        # none | hex | octal | octal2
    chartype: str = "none"       # none | ascii | ebcdic | bcd | ...
    linesize: int = 0
    dataspace: int = 0
    linefeed: bool = False
    verbose: bool = True         # False for -tapread (no error detail)

    def __post_init__(self):
        self.doboth = self.numtype != "none" and self.chartype != "none"
        if self.linesize == 0:
            self.linesize = 32 if self.doboth else 64

    @property
    def suffix(self) -> str:
        parts = []
        if self.numtype != "none":
            parts.append(self.numtype)
        if self.chartype != "none":
            parts.append(self.chartype)
        return ".".join(parts + [""])    # trailing dot like the reference


class TextFile:
    def __init__(self, path: str, opts: TxtOptions, version: str,
                 ntrks: int = 9, tapread: bool = False):
        self.o = opts
        self.ntrks = ntrks
        self.path = path
        self.f = open(path, "w")
        self.numrecords = 0
        self.numbytes = 0
        self.numtapemarks = 0
        self.numerrors = 0
        self.numwarnings = 0
        self.numerrandwarn = 0
        self.numchars = 0
        f = self.f
        f.write(f"file {path}\n")
        f.write(f"created by readtape_tpu_torch"
                f"{' -tapread' if tapread else ''} "
                f"version {version} on {time.ctime()}\n")
        f.write(f"using text options -{opts.numtype} -{opts.chartype}"
                f"{' -newline' if opts.linefeed else ''} "
                f"-linesize={opts.linesize}")
        if opts.dataspace:
            f.write(f" -dataspace={opts.dataspace}")
        if opts.numtype == "none" and opts.chartype == "none":
            f.write("\nno numeric or character options were given, "
                    "so we will display only block sizes")
        f.write("\n\n")

    def message(self, msg: str):
        if self.numchars > 0:
            self.f.write("\n")
            self.numchars = 0
        self.f.write(msg)

    def tapemark(self, timenow: float = None):
        self.numtapemarks += 1
        if timenow is None:
            self.message("tape mark\n")
        else:
            self.message(f"tape mark at time {timenow:.8f}\n")

    def _emit_chars(self, buf, bufstart):
        o = self.o
        nmissing = o.linesize - len(buf)
        nspaces = (nmissing // o.dataspace) if o.dataspace else 0
        if o.numtype == "hex" or self.ntrks <= 7:
            nspaces += nmissing * 2
        else:
            nspaces += nmissing * 3
        self.f.write(" " * nspaces)
        if o.dataspace == 0:
            self.f.write("  ")
        for i, ch in enumerate(buf):
            self.f.write(translate(ch, o.chartype, (bufstart + i) & 1))

    def output_record(self, data: bytes, errs: int, warnings: int,
                      blocknum: int = None, timenow: float = None,
                      errinfo: str = ""):
        o = self.o
        self.numrecords += 1
        self.numbytes += len(data)
        if errs * warnings > 0:
            self.numerrandwarn += 1
        else:
            if errs > 0:
                self.numerrors += 1
            if warnings > 0:
                self.numwarnings += 1
        flag = ("X" if errs * warnings > 0 else
                "!" if errs > 0 else "?" if warnings > 0 else " ")
        f = self.f
        if o.numtype == "none" and o.chartype == "none":
            if self.numchars > 0:
                self.numchars += f.write(", ")
            self.numchars += f.write(f"{flag}{len(data)}")
            if self.numchars >= o.linesize:
                f.write("\n")
                self.numchars = 0
            return
        if o.verbose:
            f.write(f"block {blocknum}: {len(data)} bytes at time "
                    f"{timenow:.8f}, {errinfo}\n ")
        else:
            f.write(f"{flag}{len(data):4d}: ")
        buf, bufstart = [], 0
        i = 0
        n = len(data)
        while i < n:
            ch = data[i]
            if (len(buf) >= o.linesize or
                    (o.linefeed and ch == 0x0A)):
                if o.doboth:
                    self._emit_chars(buf, bufstart)
                f.write("\n " if o.verbose else "\n       ")
                buf, bufstart = [], i
            buf.append(ch)
            if o.numtype == "hex":
                f.write(f"{ch:02X}")
            elif (o.numtype == "octal" or
                  (o.numtype == "octal2" and i == n - 1)):
                f.write(f"{ch:02o}" if self.ntrks <= 7 else f"{ch:03o}")
            elif o.numtype == "octal2":
                ch2 = data[i + 1]
                f.write(f"{(ch << 8) | ch2:06o}")
                buf.append(ch2)
                i += 1
            if o.numtype != "none":
                if o.dataspace > 0 and len(buf) % o.dataspace == 0:
                    f.write(" ")
            else:
                f.write(translate(ch, o.chartype, i & 1))
            i += 1
        if o.doboth:
            self._emit_chars(buf, bufstart)
        f.write("\n")

    def close(self):
        if not self.f:
            return
        f = self.f
        if self.numchars > 0:
            f.write("\n")
        f.write("end of file\n\n")
        f.write(f"there were {self.numrecords} data blocks with "
                f"{self.numbytes:,} bytes, and {self.numtapemarks} tapemarks\n")

        def plural(n):
            return "s" if n != 1 else ""
        if self.o.verbose:
            if self.numerrandwarn:
                f.write(f"{self.numerrandwarn} block"
                        f"{plural(self.numerrandwarn)} had both errors and "
                        f"warnings\n")
            if self.numerrors:
                f.write(f"{self.numerrors} block{plural(self.numerrors)} "
                        f"had errors\n")
            elif self.numerrandwarn == 0:
                f.write("no blocks had errors\n")
            if self.numwarnings:
                f.write(f"{self.numwarnings} block{plural(self.numwarnings)} "
                        f"had warnings\n")
            elif self.numerrandwarn == 0:
                f.write("no blocks had warnings\n")
        else:
            if self.numerrors:
                f.write(f"{self.numerrors} block{plural(self.numerrors)} with "
                        f"errors were marked with a ! before the length\n")
            elif self.numerrandwarn == 0:
                f.write("no blocks had errors\n")
            if self.numwarnings == 0 and self.numerrandwarn == 0:
                f.write("no blocks had warnings\n")
        f.close()
        self.f = None
