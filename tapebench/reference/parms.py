"""Decode parameter sets ("parmsets").

A parmset is one point in the space of decoding knobs; a tape block is retried
with successive parmsets until a perfect decode is found (in this framework
all active parmsets are decoded *concurrently* on a batch axis and the best is
selected -- see readtape_tpu_torch.decode.pipeline).

Mirrors the behavior of the reference's parmsets.c:
  - named-column .parms file format with schema evolution: unknown parm names
    are ignored with a warning; parms the engine expects but the file omits
    take the value from the first built-in set     [parmsets.c:236-327]
  - a "readtape <options>" line injects extra CLI options  [parmsets.c:253-258]
  - built-in defaults per mode                     [parmsets.c:77-118]
  - search order: <base>.parms, then <mode>.parms next to the input file,
    then <mode>.parms in the cwd                   [parmsets.c:337-377]

Parameter semantics (decoder.h:290-310):
  clk_window   bit times to average for clock rate (0 -> maybe exponential)
  clk_alpha    exponential-average weight for clock rate (0 -> constant)
  agc_window   peaks to look back for min-peak AGC (0 -> maybe exponential)
  agc_alpha    exponential-average weight for AGC (0 -> no AGC)
  min_peak     minimum peak height in volts (absolute, scaled by AGC/height)
  clk_factor   PE: fraction of half-bit period to wait for clock transition
  pulse_adj    PE/GCR: fraction of pulse deviation to adjust next pulse by;
               NRZI: fraction of avg transition position used to adjust clock
  pkww_bitfrac peak-window width as a fraction of bit spacing
  pkww_rise    required voltage rise across the window for a peak
  midbit       NRZI: fraction of bit time where the zero check happens
  z1pt, z2pt   GCR: peak-delta thresholds (in bit times) implying 1 / 2 zeros

The port's own copy of readtape_tpu/formats/parms.py: the port imports nothing of the
JAX package.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field

MAXPARMSETS = 15

MODE_PE, MODE_NRZI, MODE_GCR, MODE_WW = 0x01, 0x02, 0x04, 0x08
ALLMODES = MODE_PE | MODE_NRZI | MODE_GCR | MODE_WW


@dataclass(frozen=True)
class Parms:
    active: int = 1
    clk_window: int = 0
    clk_alpha: float = 0.0
    agc_window: int = 0
    agc_alpha: float = 0.0
    min_peak: float = 0.0
    clk_factor: float = 0.0
    pulse_adj: float = 0.0
    pkww_bitfrac: float = 0.7
    pkww_rise: float = 0.1
    midbit: float = 0.5
    z1pt: float = 1.5
    z2pt: float = 2.5
    comment: str = ""


# which parms apply to which mode, and legal ranges (parmsets.c:59-75)
PARM_SPECS = {
    "active":       (int,   ALLMODES, 0.0, 1.0),
    "clk_window":   (int,   ALLMODES, 0.0, 50.0),
    "clk_alpha":    (float, ALLMODES, 0.0, 1.0),
    "agc_window":   (int,   ALLMODES, 0.0, 10.0),
    "agc_alpha":    (float, ALLMODES, 0.0, 1.0),
    "min_peak":     (float, ALLMODES, 0.0, 5.0),
    "clk_factor":   (float, MODE_PE,  0.0, 2.0),
    "pulse_adj":    (float, ALLMODES - MODE_WW, 0.0, 1.0),
    "pkww_bitfrac": (float, ALLMODES, 0.0, 2.0),
    "pkww_rise":    (float, ALLMODES, 0.0, 5.0),
    "midbit":       (float, MODE_NRZI, 0.0, 1.0),
    "z1pt":         (float, MODE_GCR, 1.0, 2.0),
    "z2pt":         (float, MODE_GCR, 2.0, 3.0),
}

# Built-in default parmsets per mode. These are the same *values* as the
# reference's built-ins (parmsets.c:77-118), which encode years of tuning on
# real tapes; the ordering matters (set 0 is tried first).
_PE_DEFAULTS = [
    # clk_window, clk_alpha, agc_window, agc_alpha, min_peak, clk_factor, pulse_adj, bitfrac, rise
    (0, 0.2, 5, 0.0, 0.0, 1.50, 0.4, 0.7, 0.10),
    (0, 0.2, 5, 0.0, 0.1, 1.50, 0.4, 0.7, 0.10),
    (3, 0.0, 5, 0.0, 0.0, 1.40, 0.0, 0.7, 0.10),
    (3, 0.0, 5, 0.0, 0.0, 1.40, 0.2, 0.7, 0.10),
    (5, 0.0, 5, 0.0, 0.0, 1.40, 0.0, 0.7, 0.10),
    (5, 0.0, 5, 0.0, 0.0, 1.50, 0.2, 0.7, 0.10),
    (5, 0.0, 5, 0.0, 0.0, 1.40, 0.4, 0.7, 0.10),
    (3, 0.0, 5, 0.0, 0.0, 1.40, 0.2, 0.7, 0.10),
]
_NRZI_DEFAULTS = [
    # clk_window, clk_alpha, agc_window, agc_alpha, min_peak, pulse_adj, bitfrac, rise, midbit
    (0, 0.200, 0, 0.300, 1.000, 0.300, 0.700, 0.200, 0.500),
    (0, 0.300, 0, 0.300, 1.000, 0.400, 0.600, 0.200, 0.500),
    (2, 0.000, 0, 0.300, 1.000, 0.400, 0.700, 0.200, 0.500),
    (0, 0.600, 0, 0.300, 1.000, 0.400, 0.600, 0.200, 0.500),
    (2, 0.000, 1, 0.000, 0.500, 0.500, 0.900, 0.050, 0.500),
    (0, 0.200, 1, 0.000, 1.000, 0.500, 0.700, 0.050, 0.500),
    (2, 0.000, 1, 0.000, 0.500, 0.500, 0.700, 0.050, 0.500),
    (0, 0.600, 1, 0.000, 0.500, 0.500, 0.600, 0.050, 0.500),
]
_GCR_DEFAULTS = [
    # clk_window, clk_alpha, agc_window, agc_alpha, min_peak, pulse_adj, bitfrac, rise, z1pt, z2pt
    (0, 0.015, 0, 0.500, 0.200, 0.300, 1.500, 0.200, 1.450, 2.350),
    (0, 0.020, 0, 0.500, 0.200, 0.300, 1.500, 0.200, 1.450, 2.350),
    (0, 0.010, 0, 0.500, 0.200, 0.300, 1.500, 0.200, 1.450, 2.350),
    (10, 0.000, 0, 0.500, 0.000, 0.600, 1.500, 0.140, 1.400, 2.300),
    (0, 0.020, 0, 0.500, 0.200, 0.300, 1.500, 0.200, 1.480, 2.350),
]
_WW_DEFAULTS = [
    # clk_window, clk_alpha, agc_window, agc_alpha, min_peak, bitfrac, rise
    (0, 0.050, 0, 0.500, 1.000, 0.400, 0.200),
    (0, 0.020, 0, 0.500, 0.050, 0.200, 0.200),
]


def builtin_parmsets(mode: int) -> "ParmSets":
    sets = []
    if mode == MODE_PE:
        for (cw, ca, aw, aa, mp, cf, pa, bf, rise) in _PE_DEFAULTS:
            sets.append(Parms(1, cw, ca, aw, aa, mp, cf, pa, bf, rise))
    elif mode == MODE_NRZI:
        for (cw, ca, aw, aa, mp, pa, bf, rise, mb) in _NRZI_DEFAULTS:
            sets.append(Parms(1, cw, ca, aw, aa, mp, 0.0, pa, bf, rise, mb))
    elif mode == MODE_GCR:
        for (cw, ca, aw, aa, mp, pa, bf, rise, z1, z2) in _GCR_DEFAULTS:
            sets.append(Parms(1, cw, ca, aw, aa, mp, 0.0, pa, bf, rise, 0.5, z1, z2))
    elif mode == MODE_WW:
        for (cw, ca, aw, aa, mp, bf, rise) in _WW_DEFAULTS:
            sets.append(Parms(1, cw, ca, aw, aa, mp, 0.0, 0.0, bf, rise))
    else:
        raise ValueError(f"bad mode {mode}")
    return ParmSets(sets=sets, mode=mode)


@dataclass
class ParmSets:
    sets: list            # list[Parms], all active
    mode: int
    extra_options: list = field(default_factory=list)   # from "readtape ..." lines
    warnings: list = field(default_factory=list)
    source: str = "builtin"
    # usage statistics (tried/chosen per set), filled by the pipeline
    tried: list = field(default_factory=list)
    chosen: list = field(default_factory=list)

    def __post_init__(self):
        if not self.tried:
            self.tried = [0] * len(self.sets)
        if not self.chosen:
            self.chosen = [0] * len(self.sets)

    def __len__(self):
        return len(self.sets)

    def __getitem__(self, i) -> Parms:
        return self.sets[i]

    def describe(self) -> str:
        names = [n for n, (_, m, _, _) in PARM_SPECS.items() if m & self.mode]
        lines = ["  parms " + ", ".join(f"{n:>11s}" for n in names) + ",   id"]
        for p in self.sets:
            vals = []
            for n in names:
                v = getattr(p, n)
                vals.append(f"{v:11d}" if isinstance(v, int) else f"{v:11.3f}")
            lines.append("  {   " + ", ".join(vals) + ",  PRM }" +
                         (f" //{p.comment}" if p.comment else ""))
        return "\n".join(lines)


_NUM_RE = re.compile(r"[-+]?\d*\.?\d+")


def parse_parms_text(text: str, mode: int) -> ParmSets:
    """Parse the .parms file format (see module docstring)."""
    defaults = builtin_parmsets(mode)
    col_names = None
    sets, warnings, extra_options = [], [], []
    for rawline in text.splitlines():
        line = rawline.strip()
        if not line or line.startswith("//"):
            continue
        low = line.lower()
        if low.startswith("readtape"):
            extra_options.extend(line.split()[1:])
            continue
        if low.startswith("parms"):
            body = line[5:].lstrip(" :")
            col_names = [w.strip() for w in body.split(",") if w.strip()]
            for name in col_names:
                if name == "id":
                    continue
                if name not in PARM_SPECS:
                    warnings.append(f"obsolete parm ignored: {name}")
                elif not (PARM_SPECS[name][1] & mode):
                    warnings.append(f"parm {name} ignored: not used for this mode")
            continue
        if line.startswith("{"):
            if col_names is None:
                raise ValueError("parms file: value line before names line")
            body = line[1:]
            comment = ""
            if "//" in body:
                body, comment = body.split("//", 1)
            body = body.rstrip().rstrip("}").strip()
            tokens = [t.strip().strip('"') for t in body.split(",") if t.strip()]
            if len(tokens) != len(col_names):
                raise ValueError(f"parms file: {len(tokens)} values for "
                                 f"{len(col_names)} names in: {line}")
            kv = dict(defaults.sets[0].__dict__)   # missing parms -> first builtin
            for name, tok in zip(col_names, tokens):
                if name == "id":
                    if tok.upper() != "PRM":
                        raise ValueError(f"parms file: missing PRM id in: {line}")
                    continue
                if name not in PARM_SPECS:
                    continue                       # obsolete: skip the value
                typ, _, lo, hi = PARM_SPECS[name]
                val = float(tok)
                if not (lo <= val <= hi):
                    raise ValueError(f"parm {name}={val} out of range [{lo},{hi}]")
                kv[name] = typ(val)
            kv["comment"] = comment.strip()
            sets.append(Parms(**kv))
            if len(sets) > MAXPARMSETS:
                raise ValueError("too many parmsets")
            continue
        raise ValueError(f"bad parms file line: {line}")
    if not sets:
        raise ValueError("no parameter sets given")
    # note which expected parms were missing entirely from the file
    if col_names is not None:
        given = set(col_names)
        for name, (_, m, _, _) in PARM_SPECS.items():
            if name not in given and (m & mode) and name != "active":
                warnings.append(
                    f"missing parm {name}; using default "
                    f"{getattr(defaults.sets[0], name)} for all parmsets")
    sets = [p for p in sets if p.active]
    return ParmSets(sets=sets, mode=mode, extra_options=extra_options,
                    warnings=warnings, source="file")


def _mode_basename(mode: int) -> str:
    return {MODE_PE: "PE", MODE_NRZI: "NRZI", MODE_GCR: "GCR",
            MODE_WW: "Whirlwind"}[mode]


def load_parms(base_in_filename: str, mode: int) -> ParmSets:
    """Find and load parmsets: <base>.parms, then <mode>.parms in the input
    directory, then <mode>.parms in the cwd, else built-ins
    (parmsets.c:337-377). GCR example dirs ship a lowercase gcr.parms, so the
    mode-file lookup is case-tolerant."""
    candidates = [base_in_filename + ".parms"]
    dirname = os.path.dirname(base_in_filename)
    modename = _mode_basename(mode)
    for d in ([dirname] if dirname else []) + ["."]:
        candidates.append(os.path.join(d, modename + ".parms"))
        candidates.append(os.path.join(d, modename.lower() + ".parms"))
    for path in candidates:
        if os.path.isfile(path):
            with open(path) as f:
                ps = parse_parms_text(f.read(), mode)
            ps.source = path
            return ps
    return builtin_parmsets(mode)
