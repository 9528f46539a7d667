"""Device meshes for sharded survey processing.

Counterpart of ``echopype_tpu/parallel/mesh.py``.  The survey's parallel
axes: ping_time is the long axis (the data-parallel analog), channel the
small one, and range the optional third (sequence-parallel analog).  A
(ping, channel[, range]) mesh splits each [C, P, R] block so that only
binned partial sums travel between devices.

The JAX package drives its mesh from one process (``shard_map``); so does
the port.  A :class:`Mesh` is a grid of ``torch.device``; the
``sharded_*`` steps of ``pipeline.py`` cut every operand into the grid's
blocks, run each block on its device (every block launched before any
result is read) and add the partial sums in a fixed order (the port's
``psum``).  An explicit ``devices=`` list may name one device more than
once: ``["cpu"] * 8`` is the port's counterpart of the JAX tests' virtual
8-device CPU mesh, and ``["cuda:0"] * 4`` runs four shards on one card.
Without ``devices=`` a mesh takes distinct CUDA devices and raises when
there are too few; it never falls back to the CPU or repeats a device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["Mesh", "check_mesh", "make_mesh"]


class Mesh:
    """A grid of ``torch.device`` with named axes.

    ``devices`` is an object ndarray of shape (ping, channel[, range]);
    ``axis_names`` the names of its axes; ``shape`` maps each name to its
    size and ``size`` counts the grid's entries (repeated devices included),
    the attributes the survey streamers read from a JAX mesh.
    """

    def __init__(self, devices, axis_names):
        devices = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names) or len(set(axis_names)) != len(axis_names):
            raise ValueError(f"{devices.ndim}-axis device grid needs as many distinct "
                             f"axis names, got {axis_names}")
        if not all(isinstance(d, torch.device) for d in devices.flat):
            raise TypeError("a Mesh holds torch.device entries; build it with make_mesh")
        self.devices = devices
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, devices.shape))
        self.size = int(devices.size)

    def __repr__(self):
        grid = ", ".join(f"{k}={v}" for k, v in self.shape.items())
        return f"Mesh({grid}; {sorted({str(d) for d in self.devices.flat})})"


def _indexed(device) -> torch.device:
    """``device`` resolved (no silent fall-back), a CUDA device with its index."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        index = torch.cuda.current_device() if dev.index is None else dev.index
        if index >= torch.cuda.device_count():
            raise RuntimeError(f"{device!r}: only {torch.cuda.device_count()} CUDA devices here")
        dev = torch.device("cuda", index)
    return dev


def make_mesh(n_devices=None, channel_axis: int = 1, range_axis: int = 1, devices=None) -> Mesh:
    """Build a (ping, channel[, range]) mesh, the JAX package's signature.

    ``channel_axis`` devices shard the channel dimension and ``range_axis``
    devices the range samples; the rest shard ping_time.  ``range_axis > 1``
    returns a 3-axis mesh.  ``devices=None`` takes ``cuda:0`` ..
    ``cuda:{n-1}`` (``n_devices``, or every CUDA device) and raises
    ``RuntimeError`` when fewer exist; ``devices`` (anything
    ``torch.device`` takes, repeats allowed) names the grid's entries in
    order, of which the first ``n_devices`` are used.
    """
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        n = count if n_devices is None else int(n_devices)
        if n < 1 or n > count:
            raise RuntimeError(
                f"make_mesh needs {max(n, 1)} CUDA devices, found {count}; pass devices= "
                "to name them (a device may repeat, e.g. devices=['cpu'] * 8)"
            )
        devices = [torch.device("cuda", i) for i in range(n)]
    else:
        devices = [_indexed(d) for d in devices]
        if n_devices is not None:
            devices = devices[:n_devices]
    n = len(devices)
    if n == 0 or n % (channel_axis * range_axis) != 0:
        raise ValueError(
            f"n_devices={n} not divisible by channel_axis*range_axis="
            f"{channel_axis * range_axis}"
        )
    ping_axis = n // (channel_axis * range_axis)
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    if range_axis > 1:
        return Mesh(grid.reshape(ping_axis, channel_axis, range_axis), ("ping", "channel", "range"))
    return Mesh(grid.reshape(ping_axis, channel_axis), ("ping", "channel"))


def check_mesh(mesh) -> Mesh:
    """Return ``mesh`` if it is the port's :class:`Mesh`; raise ``TypeError``
    otherwise (a ``jax.sharding.Mesh`` included)."""
    if not isinstance(mesh, Mesh):
        raise TypeError(
            f"mesh must be an echopype_torch Mesh built by echopype_torch.parallel.make_mesh, "
            f"not {type(mesh).__module__}.{type(mesh).__qualname__}"
        )
    return mesh
