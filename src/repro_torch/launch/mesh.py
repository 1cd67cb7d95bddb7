"""Device grids of the port (the twin of ``repro/launch/mesh.py``).

A ``Mesh`` names its axes, gives their sizes and holds the grid of
``torch.device``s, one per shard, in row-major order over
(``data``, ``model``). ``make_local_mesh`` and ``make_serving_mesh``
build one over ``cuda:0..n-1`` by default and refuse, before anything is
placed, a grid that needs more cards than the host has. An explicit
``devices`` list is the only way to put two shards on one device (the
tests' ``["cpu"] * 4``, or ``["cuda:0"] * 2`` on a host with one card):
the port's counterpart of the reference's
``--xla_force_host_platform_device_count``.

The reference's ``make_production_mesh`` (256 or 512 TPU chips as
(data 16, model 16), or (pod 2, data 16, model 16)) has no counterpart:
the port serves one replica on the cards of one host.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.device import resolve_device


@dataclass(frozen=True, eq=False)
class Mesh:
    """``axis_names`` (("data", "model")) and ``devices``, a numpy object
    array of ``torch.device`` shaped by the axis sizes."""

    axis_names: Tuple[str, ...]
    devices: np.ndarray

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def flat(self) -> list:
        """The shards' devices in row-major order: shard j runs on
        ``flat[j]``."""
        return list(self.devices.reshape(-1))

    def coords(self, j: int) -> dict:
        """Shard j's index along every axis."""
        idx = np.unravel_index(j, self.devices.shape)
        return {a: int(i) for a, i in zip(self.axis_names, idx)}

    @property
    def distinct(self) -> int:
        """How many distinct devices hold the shards."""
        return len({str(d) for d in self.flat})


def _grid(need: int, devices, what: str) -> list:
    if devices is None:
        have = torch.cuda.device_count()
        if need > have:
            raise ValueError(
                f"{what} needs {need} devices but this host has {have} "
                f"CUDA device(s); pass devices= with {need} entries (the "
                f"same device may repeat, e.g. devices=['cuda:0'] * "
                f"{need}, or ['cpu'] * {need} on the CPU), or shrink the "
                f"requested topology")
        devices = [f"cuda:{i}" for i in range(need)]
    devices = [resolve_device(d) for d in devices]
    # "cuda" names the current card: give it its index, so that two
    # shards on one card compare equal
    devices = [torch.device("cuda", torch.cuda.current_device())
               if d.type == "cuda" and d.index is None else d
               for d in devices]
    if len(devices) != need:
        raise ValueError(f"{what} needs {need} devices, got "
                         f"{len(devices)}: {[str(d) for d in devices]}")
    return devices


def make_local_mesh(*, data: int = 1, model: int = 1,
                    devices: Sequence = None) -> Mesh:
    """(data x model) mesh over ``devices`` (row-major), by default the
    host's first data * model CUDA devices. Asking for more cards than the
    host has, with no ``devices``, fails here with the fix in the
    message."""
    devs = _grid(data * model,
                 devices, f"local mesh (data={data} x model={model})")
    grid = np.empty((data, model), dtype=object)
    for j, d in enumerate(devs):
        grid[np.unravel_index(j, grid.shape)] = d
    return Mesh(("data", "model"), grid)


def make_serving_mesh(topology, devices: Sequence = None) -> Mesh:
    """Mesh of one sharded ``ServingEngine`` replica
    (``repro_torch.serving.config.DeviceTopology``)."""
    return make_local_mesh(data=topology.dp, model=topology.tp,
                           devices=devices)
