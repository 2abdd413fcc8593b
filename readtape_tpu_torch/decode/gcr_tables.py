"""GCR 6250 (9042 frpi) tables -- the port's own copy of
readtape_tpu/decode/gcr_tables.py's constants.

The 5-bit group code, the special subgroups, the ECC generator rows and
the correction matrices follow ANSI X3.54 as implemented in
decode_gcr.c:111-341 (ECC analysis by Tom Howell).
"""

from __future__ import annotations

import numpy as np

# map from 5-bit storage code to 4-bit data; +16 = invalid (nearest value)
GCR_DATAMAP = np.asarray([
    16 + 10, 16 + 9, 16 + 2, 16 + 3, 16 + 5, 16 + 5, 16 + 6,
    16 + 7, 16 + 10, 9, 10, 11, 16 + 13, 13, 14,
    15, 16 + 2, 16 + 5, 2, 3, 16 + 5, 5,
    6, 7, 16 + 0, 0, 8, 1, 16 + 12, 4, 12, 16 + 15], np.int32)

GCR_MARK1 = 0b00111
GCR_MARK2 = 0b11100
GCR_SYNC = 0b11111

# ECC generator rows (56-bit each), split into two 28-bit halves for int32
_ECC_ROWS = [0x0F6A71994C5230, 0x70110840108004, 0x5A701108401080,
             0x372BE95D5A7011, 0xE95D5A70110840, 0x4C523001884412,
             0x2BE95D5A701108, 0x5D5A7011084010]
ECC_LO = np.asarray([r & 0xFFFFFFF for r in _ECC_ROWS], np.int32)
ECC_HI = np.asarray([(r >> 28) & 0xFFFFFFF for r in _ECC_ROWS], np.int32)

# correction matrices M1..M7 (decode_gcr.c:236-244)
CORR_MS = np.asarray([
    [0x00] * 8,
    [0xFE, 0xFC, 0xF8, 0x0F, 0xE0, 0x3F, 0x7F, 0xFF],
    [0x54, 0xA8, 0x50, 0xF5, 0xBF, 0x2A, 0x55, 0xAA],
    [0x93, 0x26, 0x4D, 0x09, 0x80, 0x92, 0x24, 0x49],
    [0xBA, 0x75, 0xEA, 0x6E, 0x66, 0x77, 0xEE, 0xDD],
    [0x11, 0x23, 0x46, 0x9C, 0x29, 0x42, 0x84, 0x08],
    [0x7C, 0xF9, 0xF3, 0x9A, 0x49, 0xEF, 0xDF, 0xBE],
    [0x39, 0x72, 0xE5, 0xF3, 0xDF, 0x87, 0x0E, 0x1C]], np.int32)

BIT_ORDER = np.asarray([4, 2, 1, 5, 7, 3, 6, 0, 8], np.int32)
UNDO_ORDER = np.asarray([7, 2, 1, 5, 0, 3, 6, 4, 8], np.int32)
