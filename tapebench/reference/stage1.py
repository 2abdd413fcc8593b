"""Stage 1: data-parallel candidate-peak extraction
(counterpart of readtape_tpu/decode/stage1.py).

Trailing-window max/min for every sample at once, then a *loose*
candidate predicate (the loosest threshold any AGC state could produce);
exact admission runs in trackscan.py. All functions take [..., S] tensors.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

NEG = float(np.float32(-3.0e38))
POS = float(np.float32(3.0e38))


def window_minmax(v: torch.Tensor, W: int):
    """Trailing-window max/min over the last axis: out[..., i] covers
    v[..., max(0, i-W+1) : i+1] (partial windows at the start, like the
    reference's filling window)."""
    shape = v.shape
    x = v.reshape(-1, 1, shape[-1])
    wmax = F.max_pool1d(F.pad(x, (W - 1, 0), value=NEG), W, stride=1)
    wmin = -F.max_pool1d(F.pad(-x, (W - 1, 0), value=-POS), W, stride=1)
    return wmax.reshape(shape), wmin.reshape(shape)


def left_edge_values(v: torch.Tensor, W: int):
    """v_left[..., i] = v[..., max(0, i-W+1)]: the voltage at the window's
    left edge."""
    n = v.shape[-1]
    idx = torch.clamp_min(torch.arange(n, device=v.device) - (W - 1), 0)
    return v[..., idx]


def candidate_mask(v, wmax, wmin, v_left, rise_floor, min_floor):
    """Loose candidate predicate: superset of every threshold the exact
    AGC-dependent test could use. v_right is v itself (the newest sample).
    rise_floor/min_floor: [T] per-track floors (broadcast over samples)."""
    rf = rise_floor[..., None]
    mf = min_floor[..., None]
    top = (wmax > v_left + rf) & (wmax > v + rf) & ((mf <= 0) | (wmax > mf))
    bot = (wmin < v_left - rf) & (wmin < v - rf) & ((mf <= 0) | (wmin < -mf))
    return top | bot
