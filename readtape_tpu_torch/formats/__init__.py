"""Tape file formats: the port's own copies of the JAX package's TBIN,
CSV, SIMH .tap and parmset modules."""

from .tbin import TbinHeader, read_tbin, write_tbin
from .csvfmt import read_csv, write_csv
from .simh import TapWriter, read_tap
from .parms import Parms, ParmSets, builtin_parmsets

__all__ = [
    "TbinHeader", "read_tbin", "write_tbin", "read_csv", "write_csv",
    "TapWriter", "read_tap",
    "Parms", "ParmSets", "builtin_parmsets",
]
