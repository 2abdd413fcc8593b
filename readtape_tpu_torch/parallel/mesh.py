"""Multi-device scale-out: the port of readtape_tpu/parallel/mesh.py.

Tape decoding has no cross-device data dependencies until the results
return to the host, so the scale-out is a (data, parm) grid of devices:

  - axis "data": a batch's segments split into contiguous slices, one per
    row of the grid -- each device decodes its own blocks,
  - axis "parm": when every active parmset shares one window width, the
    parmsets split into contiguous slices, one per column -- the same
    waveform decoded under different parmsets on different devices,

with tracks and lanes vectorized inside each device's kernels. Each shard
runs the same kernels on its own device; the only communication is each
shard's results coming back to the host.

A device may appear more than once in the grid: each entry is a shard,
and shards on one device run one after another on its current stream.
That is how the CPU tests (``torch.device("cpu")`` eight times) and a
machine with one card run the sharded code paths.
"""

from __future__ import annotations

import dataclasses
import os

import torch

# decode_tape shards its segment batches over this mesh when one is set
# (TapeDecoder reads it when it is built). The version counts the changes,
# as the JAX package's keys its executable cache.
_DECODE_MESH = None
_DECODE_MESH_VERSION = 0


class DecodeMesh:
    """A (data, parm) grid of torch.devices. ``devices`` is the grid as a
    list of rows; ``shape`` is {"data": d, "parm": p}, as JAX's
    Mesh.shape."""

    axis_names = ("data", "parm")

    def __init__(self, grid):
        self.devices = [[torch.device(x) for x in row] for row in grid]
        if not self.devices or not self.devices[0] or any(
                len(r) != len(self.devices[0]) for r in self.devices):
            raise ValueError("a decode mesh is a non-empty rectangular grid")

    @property
    def shape(self) -> dict:
        return {"data": len(self.devices), "parm": len(self.devices[0])}

    @property
    def first(self) -> torch.device:
        """Where the work that is not sharded runs."""
        return self.devices[0][0]

    def distinct(self) -> list:
        """Each device of the grid once, in grid order."""
        out = []
        for row in self.devices:
            out += [d for d in row if d not in out]
        return out

    def check_type(self, device) -> None:
        """Raise ValueError unless every device of the grid is of
        `device`'s type: no shard runs anywhere the decode was not asked
        to run."""
        kind = torch.device(device).type
        other = sorted({str(d) for d in self.distinct() if d.type != kind})
        if other:
            raise ValueError(f"the decode mesh holds {', '.join(other)}, "
                             f"not {kind} devices")

    def cells(self, B: int, P: int, shard_parm: bool):
        """The shards of a [B, P] batch: rows of (device, segment slice,
        parmset slice), one row per data slice, one entry per parm slice
        (one entry, on the row's first device, unless shard_parm). B must
        divide by the data axis, and P by the parm axis if shard_parm."""
        d, p = len(self.devices), len(self.devices[0]) if shard_parm else 1
        if B % d or P % p:
            raise ValueError(f"a [{B}, {P}] batch does not split over a "
                             f"({d}, {p}) grid")
        bd, pp = B // d, P // p
        return [[(self.devices[i][j], slice(i * bd, (i + 1) * bd),
                  slice(j * pp, (j + 1) * pp)) for j in range(p)]
                for i in range(d)]


def visible_devices(device="cuda") -> list:
    """The devices of `device`'s type this process can use: every CUDA
    card, or the one CPU. The command line builds -mesh over these."""
    kind = torch.device(device).type
    if kind == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(kind)]


def set_decode_mesh(mesh: "DecodeMesh | None") -> None:
    """Install (or clear) the mesh the decode pipeline shards over. The
    command line's -mesh option and READTAPE_MESH=1 call this."""
    global _DECODE_MESH, _DECODE_MESH_VERSION
    _DECODE_MESH = mesh
    _DECODE_MESH_VERSION += 1


def get_decode_mesh():
    """(mesh, version) -- mesh is None when decoding on one device. With
    READTAPE_MESH=1 and more than one card visible, a mesh over every card
    (READTAPE_MESH_PARM: its parm axis) is installed first."""
    global _DECODE_MESH, _DECODE_MESH_VERSION
    if _DECODE_MESH is None and os.environ.get("READTAPE_MESH") == "1":
        if len(visible_devices("cuda")) > 1:
            _DECODE_MESH = make_decode_mesh(
                parm_axis=int(os.environ.get("READTAPE_MESH_PARM", "1")))
            _DECODE_MESH_VERSION += 1
    return _DECODE_MESH, _DECODE_MESH_VERSION


def make_decode_mesh(devices=None, parm_axis: int = 1) -> DecodeMesh:
    """Build a (data, parm) mesh over the given devices (default: every
    visible CUDA card); the parm axis shrinks until it divides their
    number."""
    devices = visible_devices("cuda") if devices is None else list(devices)
    n = len(devices)
    pp = parm_axis
    while n % pp:
        pp -= 1
    return DecodeMesh([devices[i * pp:(i + 1) * pp] for i in range(n // pp)])


def tree_map(fn, x):
    """fn over every tensor of x: tensors, tuples, lists, dicts and
    dataclass instances (ParmArrays) of them; anything else as it is."""
    if torch.is_tensor(x):
        return fn(x)
    if isinstance(x, (tuple, list)):
        return type(x)(tree_map(fn, v) for v in x)
    if isinstance(x, dict):
        return {k: tree_map(fn, v) for k, v in x.items()}
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: tree_map(fn, getattr(x, f.name))
            for f in dataclasses.fields(x)})
    return x


def gather(grid, cat):
    """Join a grid of per-shard results (rows of dicts, tuples or
    tensors with leading [b, p] axes): cat(parts, axis) along P within a
    row, then along B."""
    def join(parts, axis):
        first = parts[0]
        if isinstance(first, dict):
            return {k: join([p[k] for p in parts], axis) for k in first}
        if isinstance(first, (tuple, list)):
            return type(first)(join([p[i] for p in parts], axis)
                               for i in range(len(first)))
        return first if len(parts) == 1 else cat(parts, axis)
    return join([join(row, 1) for row in grid], 0)


def sharded_decode_step(mesh: DecodeMesh, decode_fn, n_args: int):
    """Wrap a batched segment-decode function (v [B, T, S] + broadcast
    args) so that the segment batch splits over "data" and the ParmArrays
    (argument 4) over "parm": each shard runs decode_fn on its own device,
    with every other tensor argument copied there, and the results
    (leading [B, P] axes) are concatenated on the mesh's first device,
    along P, then along B."""
    def step(*args):
        if len(args) != n_args:
            raise TypeError(f"{len(args)} arguments, {n_args} expected")
        leaves = []
        tree_map(leaves.append, args[4])
        grid = []
        for row in mesh.cells(args[0].shape[0], len(leaves[0]),
                              shard_parm=True):
            out = []
            for dev, bs, ps in row:
                a = [tree_map(lambda t: t.to(dev), x) for x in args]
                a[0] = a[0][bs]
                a[4] = tree_map(lambda t: t[ps], a[4])
                out.append(tree_map(lambda t: t.to(mesh.first),
                                    decode_fn(*a)))
            grid.append(out)
        return gather(grid, lambda parts, axis: torch.cat(parts, dim=axis))
    return step
