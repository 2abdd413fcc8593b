"""The benchmark's own tests (run them from the repository root:
``python -m pytest tapebench/tests``). Tests marked ``cuda`` need a card
and skip without one."""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA card")
    # the CPU runs' decodes are many small operations: one thread each
    # keeps several test workers from starving each other's windows
    import torch
    torch.set_num_threads(1)


def tiny_root(tmp_path, blocks=3, pool=2, clients=1):
    """A benchmark root with the cells' configurations cut to `blocks`
    short blocks, pools of `pool` captures and the real metrics."""
    from tapebench import synth
    here = os.path.join(ROOT, "tapebench")
    root = tmp_path / "bench"
    shutil.copytree(os.path.join(here, "metrics"), root / "metrics")
    (root / "configs").mkdir()
    (root / "traffic").mkdir()
    for name in ("nrzi9_800", "pe9_1600"):
        with open(os.path.join(here, "configs", name + ".json")) as f:
            c = json.load(f)
        c["block_sizes"] = [[c["block_sizes"][0][0] // 8, blocks]]
        c["blocks"] = blocks
        c["bytes"] = c["block_sizes"][0][0] * blocks
        c["samples"] = synth.samples_for(c, 0.008)
        (root / "configs" / (name + ".json")).write_text(json.dumps(c))
    for name in ("noisy_retry", "clean"):
        with open(os.path.join(here, "traffic", name + ".json")) as f:
            t = json.load(f)
        t.update(pool=pool, clients=clients)
        (root / "traffic" / (name + ".json")).write_text(json.dumps(t))
    return str(root)


@pytest.fixture
def tiny(tmp_path):
    return lambda **kw: tiny_root(tmp_path, **kw)
