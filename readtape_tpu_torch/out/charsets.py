"""Character-set tables for the interpreted text dump.

Covers the same 12 historical character sets the reference supports
(textfile.c:90-155): EBCDIC, IBM 1401 BCD, Burroughs B5500 internal, DEC
SixBit, SDS internal + magtape, Friden Flexowriter, Adage AGT (terminal and
magtape), CDC display, and UNIVAC fieldata. Tables are transcriptions of the
public historical encodings.

The port's own copy of readtape_tpu/out/charsets.py: the port
imports nothing of the JAX package.
"""

EBCDIC = bytearray(b" " * 256)
for i, ch in enumerate("abcdefghi"):
    EBCDIC[0x81 + i] = ord(ch)
for i, ch in enumerate("jklmnopqr"):
    EBCDIC[0x91 + i] = ord(ch)
for i, ch in enumerate("stuvwxyz"):
    EBCDIC[0xA2 + i] = ord(ch)
for i, ch in enumerate("ABCDEFGHI"):
    EBCDIC[0xC1 + i] = ord(ch)
for i, ch in enumerate("JKLMNOPQR"):
    EBCDIC[0xD1 + i] = ord(ch)
for i, ch in enumerate("STUVWXYZ"):
    EBCDIC[0xE2 + i] = ord(ch)
for i, ch in enumerate("0123456789"):
    EBCDIC[0xF0 + i] = ord(ch)
for pos, ch in [(0x4A, "["), (0x4B, "."), (0x4C, "<"), (0x4D, "("),
                (0x4E, "+"), (0x4F, "|"), (0x50, "&"), (0x5A, "!"),
                (0x5B, "$"), (0x5C, "*"), (0x5D, ")"), (0x5E, ";"),
                (0x5F, "^"), (0x60, "-"), (0x61, "/"), (0x6A, "|"),
                (0x6B, ","), (0x6C, "%"), (0x6D, "_"), (0x6E, ">"),
                (0x6F, "?"), (0x79, "`"), (0x7A, ":"), (0x7B, "#"),
                (0x7C, "|"), (0x7D, "'"), (0x7E, "="), (0x7F, '"'),
                (0xA1, "~"), (0xC0, "{"), (0xD0, "}"), (0xE0, "\\")]:
    EBCDIC[pos] = ord(ch)
EBCDIC = bytes(EBCDIC)

BCD1401 = (b" 1234567890#@:>t"
           b" /STUVWXYZr,%='\""
           b"-JKLMNOPQR!$*);d"
           b"&ABCDEFGHI?.?(<g")

BURROUGHS = (b"0123456789#@?:>}"
             b"+ABCDEFGHI.[&(<~"
             b"|JKLMNOPQR$*-);{"
             b" /STUVWXYZ,%!]=\"")

SDS_INTERNAL = (b"01234567890=':>s"
                b"+ABCDEFGHI?.)[<g"
                b"-JKLMNOPQR!$*];d"
                b" /STUVWXYZr,(~\\#")

SDS_MAGTAPE = (b"01234567890#@:>s"
               b" /STUVWXYZt,%~\\g"
               b"-JKLMNOPQRc$*];d"
               b"&ABCDEFGHIb.l[<r")

FLEXOWRITER = (b"  e8 |a3 =s4i+u2"
               b"..d5rlj7n,f6c-k "
               b"t z.l.w h.y p q "
               b"o.b g 9 m.x v.0 ")

ADAGE = (b" %c!&*:_+t?\"'r()"
         b"0123456789;=,-./"
         b" ABCDEFGHIJKLMNO"
         b"PQRSTUVWXYZ$#@+b")

ADAGETAPE = (b" 0123456789\"    "
             b"ABCDEFGHOPQRSTUV"
             b"WXYZu@%]IJKLMN  "
             b"+-*/.(),=&: $# r")

CDC = b" ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789+-*/()$= ,.#[]:\"_!&'?<>@\\^;"
UNIVAC = b"@[]#^ ABCDEFGHIJKLMNOPQRSTUVWXYZ)-+<=>&$*(%:?!,\\0123456789';/.o~"

assert len(CDC) == 64 and len(UNIVAC) == 64
assert len(BCD1401) == 64 and len(BURROUGHS) == 64
assert len(SDS_INTERNAL) == 64 and len(SDS_MAGTAPE) == 64
assert len(FLEXOWRITER) == 64
assert len(ADAGE) == 64 and len(ADAGETAPE) == 64


def translate(ch: int, chartype: str, oddbyte: bool = False) -> str:
    """One byte -> one display character (textfile.c:162-176)."""
    if chartype == "bcd":
        return chr(BCD1401[ch & 0x3F])
    if chartype == "ebcdic":
        return chr(EBCDIC[ch & 0xFF])
    if chartype == "ascii":
        c = ch & 0x7F
        return chr(c) if 32 <= c < 127 else " "
    if chartype == "b5500":
        return chr(BURROUGHS[ch & 0x3F])
    if chartype == "sixbit":
        return chr((ch & 0x3F) + 32)
    if chartype == "sds":
        return chr(SDS_INTERNAL[ch & 0x3F])
    if chartype == "sdsm":
        return chr(SDS_MAGTAPE[ch & 0x3F])
    if chartype == "flexo":
        return chr(FLEXOWRITER[(ch if oddbyte else ch >> 2) & 0x3F])
    if chartype == "adage":
        return chr(ADAGE[ch & 0x3F])
    if chartype == "adagetape":
        return chr(ADAGETAPE[ch & 0x3F])
    if chartype == "cdc":
        return chr(CDC[ch & 0x3F])
    if chartype == "univac":
        return chr(UNIVAC[ch & 0x3F])
    return "?"
