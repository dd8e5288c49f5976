"""The grid stage's yardstick (B8, ``csrc/grid.cu`` ``grid_stage_kernel``):
one pass over the grid that reads each node's momentum and mass and writes
its velocity, 28 B a node in float32, whatever the BCs; its arithmetic is
a few operations a node, so the bytes bound it.  Against ``counts``'
peaks."""

from __future__ import annotations

from benchmark import counts

# a node: momentum and mass read (16 B), velocity written (12 B)
GRID_NODE_BYTES = 16 + 12


def grid_least_time(n_grid: int) -> float:
    """Seconds one grid stage over an n_grid^3 grid takes at least."""
    return GRID_NODE_BYTES * n_grid ** 3 / counts.PEAK_BYTES_S
