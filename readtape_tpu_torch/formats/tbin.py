"""TBIN file format: compact binary container for digitized tape waveforms.

Implements the on-disk format defined by the reference's csvtbin.h:
  - fixed header (tag "TBINHDR", description, 3 timestamps, flags, ntrks,
    tdelta ns, maxvolts, mode, bpi, ips)                [csvtbin.h:50-76]
  - optional track-order extension (tag "TBINORD")      [csvtbin.h:78-85]
  - data header (tag "DAT", sample_bits, tstart ns)     [csvtbin.h:88-96]
  - packed little-endian int16 samples, head-major per time step, scaled so
    +/-32767 == +/-maxvolts; the single value -32768 marks end of data
                                                        [csvtbin.h:98-105]

Reading returns a zero-copy numpy memmap view of the sample payload so that
multi-GB tapes stream straight into device transfers without a host copy.

The port's own copy of readtape_tpu/formats/tbin.py: the port imports nothing of the
JAX package.
"""

from __future__ import annotations

import struct
import time as _time
from dataclasses import dataclass

import numpy as np

TBIN_FILE_FORMAT = 1
MAXTRKS = 19

# header flags (csvtbin.h:62-65)
TBIN_NO_REORDER = 0x01
TBIN_TRKORDER_INCLUDED = 0x02
TBIN_INVERTED = 0x04
TBIN_REVERSED = 0x08

# encoding modes (csvtbin.h:46-48)
MODE_UNKNOWN, MODE_PE, MODE_NRZI, MODE_GCR, MODE_WW = 0, 0x01, 0x02, 0x04, 0x08
MODE_NAMES = {MODE_UNKNOWN: "UNKNOWN", MODE_PE: "PE", MODE_NRZI: "NRZI",
              MODE_GCR: "GCR", MODE_WW: "Whirlwind"}

# hdrsize, format, 3 x struct tm (9 ints each), flags, ntrks, tdelta,
# maxvolts, rsvd1, rsvd2, mode, bpi, ips   -- all little-endian 4-byte
_HDR_NUMERIC = "<2I27iIIIfIIIff"
_HDR_SIZE = 8 + 80 + struct.calcsize(_HDR_NUMERIC)   # tag + descr + numerics
assert _HDR_SIZE == 8 + 80 + 152

_ZERO_TM = (0,) * 9


def _tm_from_unix(t: float) -> tuple:
    lt = _time.localtime(t)
    return (lt.tm_sec, lt.tm_min, lt.tm_hour, lt.tm_mday, lt.tm_mon,
            lt.tm_year - 1900, lt.tm_wday, lt.tm_yday, lt.tm_isdst)


@dataclass
class TbinHeader:
    descr: str = ""
    flags: int = TBIN_NO_REORDER
    ntrks: int = 0
    tdelta_ns: int = 0            # time between samples in nanoseconds
    maxvolts: float = 0.0
    mode: int = MODE_UNKNOWN
    bpi: float = 0.0
    ips: float = 0.0
    time_written: tuple = _ZERO_TM
    time_read: tuple = _ZERO_TM
    time_converted: tuple = _ZERO_TM
    trkorder: str = ""            # optional trkorder extension payload
    tstart_ns: int = 0            # from the DAT header
    sample_bits: int = 16

    @property
    def mode_name(self) -> str:
        return MODE_NAMES.get(self.mode, "???")

    @property
    def sample_deltat(self) -> float:
        return self.tdelta_ns * 1e-9


def read_tbin(path: str, with_memmap: bool = True):
    """Parse a .tbin file. Returns (TbinHeader, samples) where samples is an
    int16 array of shape [nsamples, ntrks] (head order as stored in the file,
    end-sentinel stripped)."""
    with open(path, "rb") as f:
        raw = f.read(_HDR_SIZE)
        if len(raw) < _HDR_SIZE or raw[:7] != b"TBINHDR":
            raise ValueError(f"{path}: missing TBINHDR tag")
        descr = raw[8:88].split(b"\0", 1)[0].decode("ascii", "replace")
        vals = struct.unpack(_HDR_NUMERIC, raw[88:])
        (hdrsize, fmt) = vals[0:2]
        if fmt != TBIN_FILE_FORMAT:
            raise ValueError(f"{path}: unsupported tbin format {fmt}")
        if hdrsize != _HDR_SIZE:
            raise ValueError(f"{path}: bad tbin header size {hdrsize}")
        t_written = vals[2:11]
        t_read = vals[11:20]
        t_conv = vals[20:29]
        flags, ntrks, tdelta = vals[29], vals[30], vals[31]
        maxvolts = vals[32]
        mode = vals[35]
        bpi, ips = vals[36], vals[37]
        hdr = TbinHeader(descr=descr, flags=flags, ntrks=ntrks,
                         tdelta_ns=tdelta, maxvolts=maxvolts, mode=mode,
                         bpi=bpi, ips=ips, time_written=t_written,
                         time_read=t_read, time_converted=t_conv)
        offset = _HDR_SIZE
        if flags & TBIN_TRKORDER_INCLUDED:
            ext = f.read(8 + MAXTRKS + 1)
            if ext[:7] != b"TBINORD":
                raise ValueError(f"{path}: missing TBINORD tag")
            hdr.trkorder = ext[8:].split(b"\0", 1)[0].decode("ascii")
            offset += 8 + MAXTRKS + 1
        dat = f.read(16)
        if dat[:3] != b"DAT":
            raise ValueError(f"{path}: missing DAT tag")
        hdr.sample_bits = dat[5]
        if hdr.sample_bits != 16:
            raise ValueError(f"{path}: only 16-bit samples supported, "
                             f"got {hdr.sample_bits}")
        hdr.tstart_ns = struct.unpack("<Q", dat[8:16])[0]
        offset += 16

    if with_memmap:
        flat = np.memmap(path, dtype="<i2", mode="r", offset=offset)
    else:
        with open(path, "rb") as f:
            f.seek(offset)
            flat = np.frombuffer(f.read(), dtype="<i2")

    # The payload ends with a single -32768 sentinel in the head-0 slot.
    # Sample rows are complete; find the sentinel scanning the head-0 column.
    n_complete = flat.shape[0] // hdr.ntrks
    arr = flat[: n_complete * hdr.ntrks].reshape(n_complete, hdr.ntrks)
    sent = np.nonzero(arr[:, 0] == -32768)[0]
    nsamples = int(sent[0]) if sent.size else n_complete
    return hdr, arr[:nsamples]


def write_tbin(path: str, hdr: TbinHeader, samples: np.ndarray) -> None:
    """Write a .tbin file from int16 samples of shape [nsamples, ntrks]."""
    samples = np.asarray(samples, dtype="<i2")
    if samples.ndim != 2 or samples.shape[1] != hdr.ntrks:
        raise ValueError("samples must be [nsamples, ntrks]")
    now = _tm_from_unix(_time.time())
    tc = hdr.time_converted if any(hdr.time_converted) else now
    flags = hdr.flags
    if hdr.trkorder:
        flags |= TBIN_TRKORDER_INCLUDED
    with open(path, "wb") as f:
        f.write(b"TBINHDR\0")
        f.write(hdr.descr.encode("ascii", "replace")[:79].ljust(80, b"\0"))
        f.write(struct.pack(
            _HDR_NUMERIC, _HDR_SIZE, TBIN_FILE_FORMAT,
            *hdr.time_written, *hdr.time_read, *tc,
            flags, hdr.ntrks, hdr.tdelta_ns, hdr.maxvolts, 0, 0,
            hdr.mode, hdr.bpi, hdr.ips))
        if hdr.trkorder:
            f.write(b"TBINORD\0")
            f.write(hdr.trkorder.encode("ascii")[:MAXTRKS].ljust(MAXTRKS + 1, b"\0"))
        f.write(b"DAT\0")
        f.write(struct.pack("<BBBB", 0, 16, 0, 0))
        f.write(struct.pack("<Q", hdr.tstart_ns))
        f.write(samples.tobytes())
        f.write(struct.pack("<h", -32768))   # end sentinel


def samples_to_volts(samples: np.ndarray, maxvolts: float) -> np.ndarray:
    """int16 -> float32 volts, mirroring readtape.c:1420."""
    return samples.astype(np.float32) * np.float32(maxvolts / 32767.0)


def volts_to_samples(volts: np.ndarray, maxvolts: float) -> np.ndarray:
    """float volts -> int16, rounding to nearest like csvtbin.c write path."""
    scaled = np.clip(np.round(volts / maxvolts * 32767.0), -32767, 32767)
    return scaled.astype(np.int16)
