"""Device meshes for ``repro_torch.index.DistributedIndex``.

A mesh names its axes and gives every position a torch device. The port
runs a sharded index as single-controller SPMD in one process (what
``shard_map`` is): each position's slice lives on that position's device,
and the collectives are sums and concatenations across positions. So a
mesh of any shape fits on one card, each position a slice of the arena on
it (the default), or spreads over several cards when given one device a
position.

Production topology of the JAX package (TPU v5e): one pod is a 16x16
slice, meshed as (data=16, model=16); multi-pod adds a leading "pod" axis,
(pod=2, data=16, model=16). COBS shards documents over ("pod", "data") and
Bloom rows over "model".
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device


@dataclass(frozen=True)
class Mesh:
    """Named axes over an object array of torch devices, one a position
    (row-major in ``axis_names``)."""
    axis_names: tuple[str, ...]
    devices: np.ndarray

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
              device=None) -> Mesh:
    """A mesh of ``shape`` named ``axes``. ``device`` is one device for
    every position (None = the CUDA card) or a sequence of one device a
    position, row-major."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes) or len(set(axes)) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} do not match")
    if min(shape, default=1) < 1:
        raise ValueError(f"mesh axes need a size of at least 1, got {shape}")
    n = math.prod(shape)
    if device is None or isinstance(device, (str, torch.device)):
        devs = [resolve_device(device)] * n
    else:
        devs = [resolve_device(d) for d in device]
        if len(devs) != n:
            raise ValueError(f"{len(devs)} devices for a mesh of {n} "
                             "positions")
    grid = np.empty(n, dtype=object)
    grid[:] = devs
    return Mesh(axes, grid.reshape(shape))


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """The dry-run target: 16x16 single pod, or 2x16x16 across two pods."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def data_axes(mesh: Mesh) -> tuple[str, ...]:
    """Axes carrying the batch/document dimension on this mesh."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def model_axis(mesh: Mesh) -> str | None:
    return "model" if "model" in mesh.axis_names else None
