"""A cell's pool of captures, made from the seed on the device the cell
runs on (tapebench.synth), one after another."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import synth


@dataclass
class Capture:
    index: int
    samples: np.ndarray          # host int16 [N, T]
    items: list                  # ("block", payload) / ("tapemark",)
    spans: list                  # [(t0, t1)] seconds, one per item


def make_pool(config: dict, traffic: dict, seed: int, device="cpu"):
    return [Capture(i, *synth.synthesize(config, traffic, seed, i, device))
            for i in range(int(traffic["pool"]))]
