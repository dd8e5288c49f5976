"""Normalization-range computation over the dataset.

Port of Wavelet-Generation/data_utils/inspect_ranges.py:23-120: scan every
render_outputs/*/sample_k/material_grid.npy, reservoir-sample foreground
voxels, compute p1/p99 percentiles of log10(density), log10(E) and raw nu,
flag problematic objects (non-finite values, empty foreground), and write
normalization_ranges.yaml + material_statistics.json +
problematic_objects.json into normalization_stats/.

Host numpy, copied from pixie_tpu/train/inspect_ranges.py: the same three
files with the same keys and values.  One change: the worker pool starts
its processes with ``spawn`` (a process that already runs torch's threads
must not fork).

Run: ``python -m pixie_tpu_torch.train.inspect_ranges --render-outputs <dir>
--output <dir> [--sample-id K]``
"""

from __future__ import annotations

import json
import logging
import multiprocessing
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np


def process_file(mat_path: str, background_id: int = 7, cap: int = 50000,
                 seed: int = 0):
    """One material grid -> sampled fg (log10 rho, log10 E, nu) + flags."""
    try:
        mat = np.load(mat_path)
    except Exception as e:  # noqa: BLE001
        return {"path": mat_path, "error": str(e)}
    fg = mat[..., 3] != background_id
    n_fg = int(fg.sum())
    if n_fg == 0:
        return {"path": mat_path, "error": "no foreground voxels"}
    density = mat[..., 0][fg]
    E = mat[..., 1][fg]
    nu = mat[..., 2][fg]
    if (density <= 0).any() or (E <= 0).any():
        return {"path": mat_path, "error": "non-positive density/E in foreground"}
    vals = np.stack([np.log10(density), np.log10(E), nu], axis=1)
    if not np.isfinite(vals).all():
        return {"path": mat_path, "error": "non-finite values"}
    if len(vals) > cap:
        rng = np.random.default_rng(seed)
        vals = vals[rng.choice(len(vals), cap, replace=False)]
    return {"path": mat_path, "samples": vals, "n_fg": n_fg}


def compute_normalization_ranges(
    render_outputs_dir: str | Path,
    output_dir: str | Path,
    sample_id: int = 0,
    background_id: int = 7,
    reservoir_cap: int = 2_000_000,
    workers: int = 4,
):
    render_outputs_dir = Path(render_outputs_dir)
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)

    paths = sorted(render_outputs_dir.glob(f"*/sample_{sample_id}/material_grid.npy"))
    logging.info("scanning %d material grids", len(paths))

    per_file_cap = max(reservoir_cap // max(len(paths), 1), 1000)
    results = []
    if workers > 1 and len(paths) > 8:
        with ProcessPoolExecutor(
                workers, mp_context=multiprocessing.get_context("spawn")) as ex:
            results = list(
                ex.map(process_file, [str(p) for p in paths],
                       [background_id] * len(paths), [per_file_cap] * len(paths))
            )
    else:
        results = [process_file(str(p), background_id, per_file_cap) for p in paths]

    problematic = []
    samples = []
    stats_per_obj = {}
    for r in results:
        obj_id = Path(r["path"]).parent.parent.name
        if "error" in r:
            problematic.append(obj_id)
            logging.warning("problematic object %s: %s", obj_id, r["error"])
            continue
        samples.append(r["samples"])
        s = r["samples"]
        stats_per_obj[obj_id] = {
            "n_fg": r["n_fg"],
            "log10_density": [float(s[:, 0].min()), float(s[:, 0].max())],
            "log10_E": [float(s[:, 1].min()), float(s[:, 1].max())],
            "nu": [float(s[:, 2].min()), float(s[:, 2].max())],
        }

    if not samples:
        raise RuntimeError("no valid material grids found")
    all_s = np.concatenate(samples)
    if len(all_s) > reservoir_cap:
        rng = np.random.default_rng(0)
        all_s = all_s[rng.choice(len(all_s), reservoir_cap, replace=False)]

    p1 = np.percentile(all_s, 1, axis=0)
    p99 = np.percentile(all_s, 99, axis=0)
    ranges = {
        "density_min": float(p1[0]), "density_max": float(p99[0]),
        "E_min": float(p1[1]), "E_max": float(p99[1]),
        "nu_min": float(p1[2]), "nu_max": float(p99[2]),
        "density_p1": float(p1[0]), "density_p99": float(p99[0]),
        "E_p1": float(p1[1]), "E_p99": float(p99[1]),
        "nu_p1": float(p1[2]), "nu_p99": float(p99[2]),
    }
    # reference writes the yaml as a JSON-compatible dict
    (output_dir / "normalization_ranges.yaml").write_text(json.dumps(ranges))
    (output_dir / "material_statistics.json").write_text(
        json.dumps({"per_object": stats_per_obj, "n_samples": len(all_s)}, indent=2)
    )
    (output_dir / "problematic_objects.json").write_text(json.dumps(problematic))
    logging.info(
        "ranges: log10 rho [%.3f, %.3f], log10 E [%.3f, %.3f], nu [%.3f, %.3f]; "
        "%d problematic objects",
        p1[0], p99[0], p1[1], p99[1], p1[2], p99[2], len(problematic),
    )
    return ranges, problematic


if __name__ == "__main__":
    import argparse

    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser()
    ap.add_argument("--render-outputs", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument("--sample-id", type=int, default=0)
    args = ap.parse_args()
    compute_normalization_ranges(args.render_outputs, args.output, args.sample_id)
