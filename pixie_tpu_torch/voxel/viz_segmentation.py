"""CLIP-similarity heatmap renders for the VLM segmentation critic (port of
pixie_tpu/voxel/viz_segmentation.py: host numpy and PIL, copied; the
similarities come from ``segmentation.run_clip_similarity`` on ``device``).

Port of pixie/voxel/viz_segmentation.py:7-237 (visualize_part_segmentation):
for each part query, project the per-voxel similarity onto axis-aligned
views as a colored heatmap image; the critic agent scores candidate query
sets from these renders (vlm_seg_critic.py:62-104).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from pixie_tpu_torch.voxel.segmentation import encode_queries, grid_coords, run_clip_similarity


def _colormap(v: np.ndarray) -> np.ndarray:
    """Simple blue->red heatmap for values in [0,1]."""
    v = np.clip(v, 0.0, 1.0)
    return np.stack([v, 0.2 * np.ones_like(v), 1.0 - v], axis=-1)


def render_similarity_heatmaps(
    coords: np.ndarray,
    similarities: np.ndarray,
    queries: list[str],
    output_dir: str | Path,
    res: int = 256,
    axis: int = 1,
):
    """Per-query orthographic similarity projections -> PNG paths."""
    from PIL import Image  # noqa: PLC0415

    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    keep_axes = [a for a in range(3) if a != axis]
    uv = coords[:, keep_axes]
    depth = coords[:, axis]
    lo, hi = uv.min(axis=0), uv.max(axis=0)
    span = np.maximum((hi - lo).max(), 1e-6)
    px = ((uv - lo) / span * (res - 1)).astype(np.int64)
    order = np.argsort(depth)

    paths = []
    for qi, query in enumerate(queries):
        s = similarities[:, qi]
        s = (s - s.min()) / np.maximum(s.max() - s.min(), 1e-8)
        img = np.ones((res, res, 3), np.float32)
        img[res - 1 - px[order, 1], px[order, 0]] = _colormap(s[order])
        p = output_dir / f"similarity_{qi}_{query.replace(' ', '_')}.png"
        Image.fromarray((img * 255).astype(np.uint8)).save(p)
        paths.append(str(p))
    return paths


def visualize_part_segmentation(
    grid_feature_path: str | Path,
    queries: list[str],
    output_dir: str | Path,
    text_encoder=None,
    query_embs=None,
    res: int = 256,
    device="cuda",
):
    """Load masked voxel features, compute similarities, render heatmaps."""
    grid_feature_path = str(grid_feature_path)
    features = np.load(grid_feature_path.replace(".npz", "_features.npy"))
    mask = np.load(grid_feature_path.replace(".npz", "_mask.npy")).astype(bool)
    coords = grid_coords(np.load(grid_feature_path)).reshape(-1, 3)[mask.ravel()]
    feats = features.reshape(-1, features.shape[-1])[mask.ravel()]

    embs = encode_queries(queries, text_encoder, query_embs)
    _, sims = run_clip_similarity(feats, embs, device=device)
    return render_similarity_heatmaps(coords, sims, queries, output_dir, res)
