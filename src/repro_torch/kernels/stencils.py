"""Stencil definitions for the paper's Table 3 benchmark suite.

Star and box stencil generators for 2-D/3-D grids plus the ``poisson``
operator. Each benchmark is a named :class:`StencilDef` holding the tap
offsets, deterministic coefficients (diffusion-like: positive, summing to
1 so iterates stay bounded) and the paper's FPP metadata used to convert
GCells/s → GFLOP/s in the benchmark tables.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class StencilDef:
    name: str
    ndim: int
    offsets: tuple[tuple[int, ...], ...]
    coeffs: tuple[float, ...]
    order: int          # k in Table 3
    fpp: int            # FLOPs-per-point metadata from Table 3

    @property
    def radius(self) -> int:
        return max(max(abs(c) for c in off) for off in self.offsets)


def _norm_coeffs(n: int) -> tuple[float, ...]:
    """Deterministic positive coefficients summing to 1 (diffusion-like)."""
    raw = np.arange(1, n + 1, dtype=np.float64)
    raw = 1.0 + 0.1 * np.sin(raw)          # break symmetry, stay positive
    return tuple((raw / raw.sum()).tolist())


def star2d(k: int) -> tuple[tuple[int, int], ...]:
    offs = [(0, 0)]
    for r in range(1, k + 1):
        offs += [(-r, 0), (r, 0), (0, -r), (0, r)]
    return tuple(offs)


def box2d(r: int) -> tuple[tuple[int, int], ...]:
    return tuple((dy, dx) for dy in range(-r, r + 1) for dx in range(-r, r + 1))


def rect2d(h: int, w: int) -> tuple[tuple[int, int], ...]:
    """h×w dense rectangle anchored top-left (for even-size stencils)."""
    return tuple((dy, dx) for dy in range(h) for dx in range(w))


def star3d(k: int) -> tuple[tuple[int, int, int], ...]:
    offs = [(0, 0, 0)]
    for r in range(1, k + 1):
        offs += [(-r, 0, 0), (r, 0, 0), (0, -r, 0), (0, r, 0), (0, 0, -r), (0, 0, r)]
    return tuple(offs)


def box3d(r: int) -> tuple[tuple[int, int, int], ...]:
    return tuple(
        (dz, dy, dx)
        for dz in range(-r, r + 1)
        for dy in range(-r, r + 1)
        for dx in range(-r, r + 1)
    )


def _mk(name: str, ndim: int, offsets, order: int, fpp: int) -> StencilDef:
    return StencilDef(name, ndim, tuple(offsets), _norm_coeffs(len(offsets)), order, fpp)


# Table 3 of the paper. 2dXpt with X=5,9,13,17,21 and 2ds25pt are star
# stencils of order k; 2d25/64/81/121pt are dense boxes; poisson is the
# classic 3-D 19-point Poisson operator (FPP metadata from the paper).
BENCHMARKS: dict[str, StencilDef] = {
    d.name: d
    for d in [
        _mk("2d5pt", 2, star2d(1), 1, 9),
        _mk("2d9pt", 2, star2d(2), 2, 17),
        _mk("2d13pt", 2, star2d(3), 3, 25),
        _mk("2d17pt", 2, star2d(4), 4, 33),
        _mk("2d21pt", 2, star2d(5), 5, 41),
        _mk("2ds25pt", 2, star2d(6), 6, 49),
        _mk("2d25pt", 2, box2d(2), 2, 33),
        _mk("2d64pt", 2, rect2d(8, 8), 4, 73),
        _mk("2d81pt", 2, box2d(4), 4, 95),
        _mk("2d121pt", 2, box2d(5), 5, 241),
        _mk("3d7pt", 3, star3d(1), 1, 13),
        _mk("3d13pt", 3, star3d(2), 2, 25),
        _mk("3d27pt", 3, box3d(1), 1, 30),
        _mk("3d125pt", 3, box3d(2), 2, 130),
        _mk(
            "poisson", 3,
            # 19-point 3-D Poisson operator: star-1 + face-diagonal taps.
            tuple(
                off for off in box3d(1)
                if sum(1 for c in off if c != 0) <= 2
            ),
            1, 21,
        ),
    ]
}
