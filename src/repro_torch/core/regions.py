"""Region algebra for fine-grained dependency analysis (paper §4.1, C3).

MPK introduces an event for a task pair ``(t1, t2)`` iff the output region
produced by ``t1`` overlaps the input region consumed by ``t2``.  Regions are
axis-aligned hyper-rectangles over tensor index space.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence, Tuple

import numpy as np

__all__ = ["TensorSpec", "Region", "full_region", "tile_regions"]


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """A named tensor in the kernel-level computation graph."""

    name: str
    shape: Tuple[int, ...]
    dtype: str = "bfloat16"

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def size(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    @property
    def nbytes(self) -> int:
        return self.size * np.dtype(
            {"bfloat16": np.float32}.get(self.dtype, self.dtype)
        ).itemsize // (2 if self.dtype == "bfloat16" else 1)

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"TensorSpec({self.name}:{self.dtype}{list(self.shape)})"


@dataclasses.dataclass(frozen=True)
class Region:
    """Axis-aligned hyper-rectangle ``[start_i, stop_i)`` per dimension."""

    starts: Tuple[int, ...]
    stops: Tuple[int, ...]

    def __post_init__(self) -> None:
        if len(self.starts) != len(self.stops):
            raise ValueError("starts/stops rank mismatch")
        for a, b in zip(self.starts, self.stops):
            if a < 0 or b < a:
                raise ValueError(f"malformed region {self}")

    @property
    def ndim(self) -> int:
        return len(self.starts)

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(b - a for a, b in zip(self.starts, self.stops))

    @property
    def size(self) -> int:
        return int(np.prod(self.shape)) if self.starts else 1

    def overlaps(self, other: "Region") -> bool:
        """True iff the two hyper-rectangles intersect (non-empty volume)."""
        if self.ndim != other.ndim:
            raise ValueError(
                f"rank mismatch in overlap test: {self.ndim} vs {other.ndim}"
            )
        for a0, a1, b0, b1 in zip(self.starts, self.stops, other.starts, other.stops):
            if a1 <= b0 or b1 <= a0:
                return False
        return True

    def contains(self, other: "Region") -> bool:
        return all(
            a0 <= b0 and b1 <= a1
            for a0, a1, b0, b1 in zip(self.starts, self.stops, other.starts, other.stops)
        )

    def intersect(self, other: "Region") -> "Region | None":
        starts = tuple(max(a, b) for a, b in zip(self.starts, other.starts))
        stops = tuple(min(a, b) for a, b in zip(self.stops, other.stops))
        if any(b <= a for a, b in zip(starts, stops)):
            return None
        return Region(starts, stops)

    def slices(self) -> Tuple[slice, ...]:
        return tuple(slice(a, b) for a, b in zip(self.starts, self.stops))

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        parts = ",".join(f"{a}:{b}" for a, b in zip(self.starts, self.stops))
        return f"R[{parts}]"


def full_region(spec: TensorSpec) -> Region:
    return Region(tuple(0 for _ in spec.shape), tuple(spec.shape))


def tile_regions(
    shape: Sequence[int], tile: Sequence[int]
) -> Iterator[Region]:
    """Iterate tile regions covering ``shape`` with tile sizes ``tile``.

    Edge tiles are clipped.  Iteration is row-major so that tasks of the same
    operator get deterministic, cache-friendly ordering.
    """
    if len(shape) != len(tile):
        raise ValueError("tile rank mismatch")
    counts = [max(1, -(-s // t)) for s, t in zip(shape, tile)]
    total = int(np.prod(counts))
    for flat in range(total):
        idx = []
        rem = flat
        for c in reversed(counts):
            idx.append(rem % c)
            rem //= c
        idx.reverse()
        starts = tuple(i * t for i, t in zip(idx, tile))
        stops = tuple(min(s + t, dim) for s, t, dim in zip(starts, tile, shape))
        yield Region(starts, stops)
