"""The chip coordinates the device plugin advertises.

Own copy of the part of ``elastic_gpu_scheduler_tpu/core/topology.py``
that device discovery reads: ``parse_topology`` ("2x2" → (2, 2)),
``parse_coord`` ("0.2" → (0, 2)) and the canonical chip order, row-major
over the host's box (``coords``).  The scheduler places pods by those
coordinates, so a card's coordinate on a node must be the one the
scheduler's node labels give it.

The rest of ``core/topology.py`` (torus wraparound, sub-box enumeration,
shape factorization) models a TPU slice's ICI mesh for the scheduler.
One H100 node has no torus, and the scheduler that reads it runs beside
either workload package, so none of it is copied here.
"""

from __future__ import annotations

import itertools
from typing import Iterator

Coord = tuple[int, ...]


def parse_topology(spec: str) -> tuple[int, ...]:
    """Parse "4x4x8" → (4, 4, 8). Accepts 1-4 axes."""
    try:
        dims = tuple(int(p) for p in spec.lower().split("x"))
    except ValueError as e:
        raise ValueError(f"bad topology spec {spec!r}") from e
    if not (1 <= len(dims) <= 4) or any(d <= 0 for d in dims):
        raise ValueError(f"bad topology spec {spec!r}")
    return dims


def parse_coord(s: str) -> Coord:
    return tuple(int(p) for p in s.split("."))


def coords(dims: tuple[int, ...]) -> Iterator[Coord]:
    """All coordinates of a box of ``dims`` in row-major order (the
    canonical chip order)."""
    return itertools.product(*(range(d) for d in dims))
