"""Tape file formats: the port's own copies of the JAX package's TBIN,
SIMH .tap and parmset modules (CSV float tapes are not ported)."""

from .tbin import TbinHeader, read_tbin, write_tbin
from .simh import TapWriter, read_tap
from .parms import Parms, ParmSets, builtin_parmsets

__all__ = [
    "TbinHeader", "read_tbin", "write_tbin",
    "TapWriter", "read_tap",
    "Parms", "ParmSets", "builtin_parmsets",
]
