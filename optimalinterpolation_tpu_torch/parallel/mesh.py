"""Devices and cell sharding (replaces the reference's MPI task farm).

PyTorch counterpart of ``optimalinterpolation_tpu/parallel/mesh.py``. The
reference's only distributed mechanism is an mpi4py scatter / gather of
grid cells over ranks (``GPR_CS2S3.py:250-262``). The JAX package shards the
leading (cells) axis of every bucket over a device mesh; cells are
independent, so no collective runs. Here a mesh is a tuple of
``torch.device``s, and :class:`CellSharding` runs one host thread a shard:
each thread computes its contiguous rows of a bucket on its own device,
under ``torch.cuda.device`` and a stream of its own, and the caller gathers
the shards' results in row order (the pattern of
``torch.nn.parallel.parallel_apply``). One process builds the kernels'
library once, keeps the launch counters in one place and never pickles a
bucket; the C entries and torch's operators release the interpreter lock,
so the shards' host work overlaps.

A device may repeat (``make_mesh(devices=["cuda:0", "cuda:0"])`` or
``["cpu"] * 4``): two shards on one card run on two streams, and CPU shards
run the kernels' plain twins, as every CPU test does.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor, wait
from typing import Callable, Optional, Sequence, Union

import torch

__all__ = ["CellSharding", "make_mesh", "day_cell_mesh", "cell_sharding"]

Device = Union[str, torch.device]


def _checked(devices: Sequence[Device]) -> tuple:
    """``devices`` as ``torch.device``s; raise on a CUDA device that this
    process cannot see."""
    out = tuple(torch.device(d) for d in devices)
    if not out:
        raise ValueError("a mesh needs at least one device")
    for d in out:
        if d.type != "cuda":
            continue
        if not torch.cuda.is_available():
            raise RuntimeError(f"{d}: CUDA is not available")
        index = 0 if d.index is None else d.index
        if index >= torch.cuda.device_count():
            raise RuntimeError(f"{d}: only {torch.cuda.device_count()} CUDA devices visible")
    return tuple(torch.device("cuda", d.index or 0) if d.type == "cuda" else d for d in out)


def make_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence[Device]] = None,
              kind: str = "cuda") -> tuple:
    """A flat mesh: the first ``n_devices`` of ``devices`` or, without
    ``devices``, of every visible device of ``kind`` (``"cuda"``: every
    card; ``"cpu"``: the CPU, repeated ``n_devices`` times). Raises when
    more CUDA devices are asked for than exist, or CUDA is absent."""
    if devices is None:
        if kind == "cpu":
            devices = ["cpu"] * (n_devices or 1)
        elif kind == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("make_mesh: CUDA is not available")
            count = torch.cuda.device_count()
            if n_devices is not None and n_devices > count:
                raise RuntimeError(f"make_mesh: {n_devices} CUDA devices asked for, "
                                   f"{count} visible")
            devices = [f"cuda:{i}" for i in range(count)]
        else:
            raise ValueError(f"make_mesh: unknown device kind {kind!r}")
    if n_devices is not None:
        if n_devices > len(devices):
            raise RuntimeError(f"make_mesh: {n_devices} devices asked for, {len(devices)} given")
        devices = list(devices)[:n_devices]
    return _checked(devices)


def day_cell_mesh(shape: Sequence[int], devices: Optional[Sequence[Device]] = None) -> tuple:
    """The JAX package's (days, cells) mesh, flattened: its bucket axis is
    sharded over both mesh axes (``P(("days", "cells"))``), so here it is
    one mesh of ``shape[0] * shape[1]`` devices."""
    return make_mesh(shape[0] * shape[1], devices=devices)


class CellSharding:
    """Runs a function on contiguous row ranges of a bucket, one host
    thread a device of the mesh (see the module docstring)."""

    def __init__(self, devices: Sequence[Device]):
        self.devices = _checked(devices)
        self._streams: dict = {}
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self.devices)

    def stream(self, shard: int) -> torch.cuda.Stream:
        """The CUDA stream of shard ``shard``, made at first use."""
        with self._lock:
            if shard not in self._streams:
                self._streams[shard] = torch.cuda.Stream(device=self.devices[shard])
            return self._streams[shard]

    def split(self, n_rows: int, batch_multiple: int = 1) -> list:
        """``[(shard, slice)]``: ``n_rows`` cut into one contiguous range a
        device, in shard order, each a multiple of ``batch_multiple`` rows
        (the last may hold the remainder) and as even as that allows; empty
        ranges are left out."""
        units = -(-n_rows // batch_multiple)
        base, extra = divmod(units, len(self.devices))
        out, start = [], 0
        for shard in range(len(self.devices)):
            stop = min(n_rows, start + (base + (shard < extra)) * batch_multiple)
            if stop > start:
                out.append((shard, slice(start, stop)))
            start = stop
        return out

    def map(self, n_rows: int, fn: Callable[[slice, torch.device], object],
            batch_multiple: int = 1) -> list:
        """``fn(rows, device)`` for each non-empty range of :meth:`split`,
        each in a thread of its own, on its shard's device and stream.
        Returns the results in shard order. If a shard raises, the others
        are waited for and the first failure in shard order is raised
        here; nothing is retried elsewhere."""
        ranges = self.split(n_rows, batch_multiple)
        if any(self.devices[s].type == "cuda" for s, _ in ranges):
            from optimalinterpolation_tpu_torch.ops import _cuda

            _cuda.load()  # built here, not by the first thread that launches

        def run(shard: int, rows: slice):
            dev = self.devices[shard]
            if dev.type != "cuda":
                return fn(rows, dev)
            with torch.cuda.device(dev), torch.cuda.stream(self.stream(shard)):
                return fn(rows, dev)

        with ThreadPoolExecutor(max_workers=max(1, len(ranges)),
                                thread_name_prefix="oi-shard") as pool:
            futures = [pool.submit(run, s, rows) for s, rows in ranges]
            wait(futures)
        return [f.result() for f in futures]


def cell_sharding(mesh: Sequence[Device]) -> CellSharding:
    """Shard the leading (cells) axis of every bucket over ``mesh``."""
    return CellSharding(mesh)
