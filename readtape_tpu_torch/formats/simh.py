"""SIMH .tap magnetic-tape image format.

Record framing (readtape.c:1076-1082, 1232-1245; tapread.c:42-91):
  data record : <u32 length|errflag> <bytes, padded to even> <u32 length|errflag>
  tape mark   : u32 0x00000000
  erased gap  : u32 0xfffffffe
  end of medium: u32 0xffffffff
  error flag  : bit 0x80000000 set on the length words

The port's own copy of readtape_tpu/formats/simh.py: the port imports nothing of the
JAX package.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

TAP_TAPEMARK = 0x00000000
TAP_ERASED_GAP = 0xFFFFFFFE
TAP_EOM = 0xFFFFFFFF
TAP_ERROR_FLAG = 0x80000000


class TapWriter:
    """Streams decoded blocks into a SIMH .tap file. The file is created
    lazily on the first block or tapemark, like the reference
    (create_datafile runs from got_datablock/got_tapemark,
    readtape.c:1084-1111): a tape with nothing decodable leaves no .tap."""

    def __init__(self, path: str):
        self.path = path
        self._f = None
        self.numoutbytes = 0

    def _marker(self, num: int) -> None:
        if self._f is None:
            self._f = open(self.path, "wb")
        self._f.write(struct.pack("<I", num & 0xFFFFFFFF))
        self.numoutbytes += 4

    def write_block(self, data: bytes, error: bool = False) -> None:
        length = len(data)
        flag = TAP_ERROR_FLAG if error else 0
        self._marker(length | flag)
        self._f.write(data)
        self.numoutbytes += length
        if length & 1:                       # pad to even length
            self._f.write(b"\0")
            self.numoutbytes += 1
        self._marker(length | flag)

    def write_tapemark(self) -> None:
        self._marker(TAP_TAPEMARK)

    def write_eom(self) -> None:
        if self._f is not None:      # only an already-created file gets the
            self._marker(TAP_EOM)    # EOM marker (readtape.c:1885 checks outf)

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None


@dataclass
class TapRecord:
    kind: str            # "data" | "tapemark" | "gap" | "eom"
    data: bytes = b""
    error: bool = False


def read_tap(path: str, tolerant: bool = True):
    """Parse a SIMH .tap file into a list of TapRecord.

    Mirrors the reference's tolerant trailing-length search, which
    accommodates writers that padded 0..3 bytes (tapread.c:82-89), and treats
    EOF as an implicit end-of-medium (tapread.c:45-47).
    """
    records = []
    with open(path, "rb") as f:
        buf = f.read()
    pos = 0
    n = len(buf)

    def get_u32(p):
        if p + 4 > n:
            return None
        return struct.unpack_from("<I", buf, p)[0]

    while True:
        marker = get_u32(pos)
        if marker is None:
            records.append(TapRecord("eom"))   # implicit EOM at EOF
            break
        pos += 4
        if marker == TAP_EOM:
            records.append(TapRecord("eom"))
            break
        if marker == TAP_ERASED_GAP:
            records.append(TapRecord("gap"))
            continue
        if marker == TAP_TAPEMARK:
            records.append(TapRecord("tapemark"))
            continue
        if marker & 0x7F000000:
            raise ValueError(f"{path}: bad .tap marker 0x{marker:08X} at {pos-4}")
        length = marker & 0xFFFFFF
        if length == 0:
            raise ValueError(f"{path}: bad zero record length at {pos-4}")
        if pos + length > n:
            raise ValueError(f"{path}: truncated data record at {pos-4}")
        data = buf[pos:pos + length]
        pos += length
        # search for the matching trailing length across 0..3 pad bytes
        tries = 0
        while True:
            trailer = get_u32(pos)
            if trailer is not None and (trailer & 0xFFFFFF) == length:
                pos += 4
                break
            tries += 1
            if not tolerant or tries > 4 or pos >= n:
                raise ValueError(f"{path}: missing trailing record length at {pos}")
            pos += 1
        records.append(TapRecord("data", data, bool(marker & TAP_ERROR_FLAG)))
    return records
