"""3DGS checkpoint lookup (port of pixie_tpu/recon/train_gaussians.py:437-445).

Only ``search_for_max_iteration`` is here: the 3DGS trainer is the
training slice (ROADMAP.md 'Next slices' (c)).
"""

from __future__ import annotations

from pathlib import Path


def search_for_max_iteration(point_cloud_dir: str | Path) -> int:
    """searchForMaxIteration (gs_simulation.py:215-227); -1 when none."""
    best = -1
    for p in Path(point_cloud_dir).glob("iteration_*"):
        try:
            best = max(best, int(p.name.split("_")[1]))
        except (IndexError, ValueError):
            continue
    return best
