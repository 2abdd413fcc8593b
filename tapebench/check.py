"""What decides `correct`, and what counts as `failed`.

Two numbers are compared, each with its limit (BENCHMARK's cells share
them; PERF.md gives the readings they were set from):

- ``blocks_differ``: of the sampled segments of the checked capture, in
  every timed decode of it, the segments whose blocks differ from the
  plain reference's in anything but their float read-outs: kind, bytes,
  parmset, tries, error and warning counts, start and end sample, and the
  integer read-outs (bit counts, track mismatch, parity, CRC and LRC
  errors, missed mid-bits, corrected bits, faked tracks). A block missing
  on either side differs. Exact: limit 0.
  A decode whose per-track skew delays (``-deskew``'s calibration)
  differ from the reference's counts every sampled segment as differing.
- ``float_gap``: the widest relative gap, over the same blocks, of the
  float read-outs (average bit spacing, the largest and smallest AGC
  gain) from the reference's.

``attempted`` counts the items (blocks and tapemarks) written into every
capture decoded in the window; ``failed`` the items of the sampled
segments, over every compared decode, on which the decode's answer is not
the reference's (``wrong_items``). The payloads the synthesizer wrote
judge the tape, not the decode: a noisy capture loses blocks and
tapemarks that the reference loses alike, so ``failure_kinds`` only
reports how the items came back against them.
"""

from __future__ import annotations

import bisect
import math
from collections import Counter

INT_DETAIL = ("minbits", "maxbits", "track_mismatch", "vparity_errs",
              "crc_errs", "lrc_errs", "missed_midbits", "corrected_bits",
              "faked_tracks")
FLOAT_DETAIL = ("avg_bit_spacing", "alltrk_max_agc", "alltrk_min_agc")

# The limits, from PERF.md's readings: sound runs read 0 and 0.0 on every
# seed (the card's blocks and read-outs are the reference's bit for bit);
# the bfloat16 control reads 0-3 and 1.57e-3 to 2.75e-3. float_gap's
# limit sits 3x below the control's least reading and some 4,000 float32
# roundings above any sound one.
LIMITS = {"blocks_differ": 0, "float_gap": 5e-4}


def sample_of(t: float, deltat: float) -> int:
    return int(round(t / deltat))


def block_key(b, deltat: float) -> tuple:
    """Everything of a block but its float read-outs."""
    return (b.kind, bytes(b.data), int(b.parmset), int(b.tries),
            int(b.errcount), int(b.warncount), sample_of(b.t_start, deltat),
            sample_of(b.t_end, deltat),
            tuple(int(b.detail.get(k, 0)) for k in INT_DETAIL))


def by_segment(blocks, starts, deltat: float):
    """Blocks grouped by the segment whose range [start, next start)
    holds their first sample; `starts` sorted segment starts."""
    groups = {}
    for b in blocks:
        i = bisect.bisect_right(starts, sample_of(b.t_start, deltat)) - 1
        groups.setdefault(i, []).append(b)
    return groups


def compare(decoded, reference: dict, segments, deltat: float):
    """decoded: one decode's blocks (the program's, or the control's);
    reference: {segment index: [blocks]} for the sampled segments.
    Returns (segments that differ, widest float gap)."""
    starts = [a for a, _ in segments]
    groups = by_segment(decoded, starts, deltat)
    differ, gap = 0, 0.0
    for i, ref in reference.items():
        got = groups.get(i, [])
        if [block_key(b, deltat) for b in got] != \
                [block_key(b, deltat) for b in ref]:
            differ += 1
        for g, r in zip(got, ref):
            for k in FLOAT_DETAIL:
                if k in r.detail:
                    x, y = float(g.detail.get(k, math.nan)), float(r.detail[k])
                    d = abs(x - y) / max(abs(y), 1e-30)
                    gap = max(gap, d if not math.isnan(d) else math.inf)
    return differ, gap


def wrong_items(decoded, reference: dict, segments, deltat: float,
                whole: bool = False) -> int:
    """The items (blocks and tapemarks) of the sampled segments on which
    one decode's answer is not the reference's: per segment, the larger
    of the two block counts less the blocks that equal one of the other
    side's in everything compare() holds exact. With `whole` (a decode
    whose skew delays are not the reference's) every item counts."""
    groups = by_segment(decoded, [a for a, _ in segments], deltat)
    wrong = 0
    for i, ref in reference.items():
        got = Counter(block_key(b, deltat) for b in groups.get(i, []))
        want = Counter(block_key(b, deltat) for b in ref)
        same = 0 if whole else sum((got & want).values())
        wrong += max(sum(got.values()), sum(want.values())) - same
    return wrong


def skew_of(stats: dict) -> list:
    """The per-track skew delays a decode_tape call decoded with."""
    skew = stats.get("skew")
    return [int(x) for x in skew] if skew is not None else None


def verdict(numbers: dict) -> bool:
    return all(numbers[k] <= LIMITS[k] for k in LIMITS)


FAILURE_KINDS = ("missing", "split", "kind", "flagged", "silent")


def failure_kinds(decoded, items, spans, deltat: float) -> dict:
    """How each written item of one capture came back, against its
    payload: ("block", payload) or ("tapemark",) items with their time
    spans in seconds; each decoded block goes to the item it overlaps
    most. Counts per FAILURE_KINDS: no block lands on the item
    (missing), more than one (split), its block is of another kind
    (kind), it reports errors (flagged), or it reports none and holds
    other bytes (silent). An item in none of them came back right."""
    got = [[] for _ in items]
    starts = [t0 for t0, _ in spans]
    for b in decoded:
        best, over = None, 0.0
        # the items that can overlap [t_start, t_end): spans are in order
        j = max(bisect.bisect_right(starts, b.t_start) - 1, 0)
        while j < len(spans) and spans[j][0] < b.t_end:
            t0, t1 = spans[j]
            o = min(t1, b.t_end) - max(t0, b.t_start)
            if o > over:
                best, over = j, o
            j += 1
        if best is not None:
            got[best].append(b)
    kinds = dict.fromkeys(FAILURE_KINDS, 0)
    for item, bs in zip(items, got):
        if len(bs) != 1:
            kinds["missing" if not bs else "split"] += 1
            continue
        b = bs[0]
        want = "tapemark" if item[0] == "tapemark" else "data"
        if b.kind != want:
            kinds["kind"] += 1
        elif want == "data" and b.errcount != 0:
            kinds["flagged"] += 1
        elif want == "data" and bytes(b.data) != item[1]:
            kinds["silent"] += 1
    return kinds
