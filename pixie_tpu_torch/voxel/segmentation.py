"""CLIP text-query part segmentation of the voxel grid (VLM labeling path;
port of pixie_tpu/voxel/segmentation.py).

Masked voxel CLIP features dotted with normalized text embeddings of the
part queries -> softmax(T=0.1) -> argmax part label (reference
segmentation.py run_clip:98-122, clip_part_segmentation:125-183); per-part
material properties assigned from the sampled material_dict; writes
segmented_semantics.ply and the dense material_grid.npy labels
(save_segmented_point_cloud:231-472: background voxels get density=E=nu=0
and material_id=background_id, foreground filled via the occupancy mask's
flat indices in C order).

The similarity product and the k-NN vote run on ``device`` (the card unless
the caller asks for the CPU) in float32, as plain products: the JAX package
computes them outside any Pallas kernel.  The connected-component cleanup
and the writers are host code, copied.

Text encoding is pluggable: pass precomputed embeddings or an encoder
callable (``recon.clip_features.CLIPTextEncoder``).
"""

from __future__ import annotations

import logging
import os
from pathlib import Path

import numpy as np
import torch

from pixie_tpu_torch.sim.types import get_material_id
from pixie_tpu_torch.utils.io import MATERIAL_PLY_DTYPE, write_ply

SIM_CHUNK = 1 << 20     # feature rows normalized in float32 at a time


def run_clip_similarity(features, query_embs, softmax_temperature: float = 0.1,
                        device: str | torch.device = "cuda"):
    """(N,C) voxel features x (Q,C) text embeddings -> (probabilities,
    similarities), each (N,Q) float32 numpy.

    Both sides L2-normalized (norms floored at 1e-8); softmax over queries
    at T=0.1 (segmentation.py:98-122).  ``features`` may be a tensor (its
    device is used; float16 rows are widened a chunk at a time) or an
    array, moved to ``device``."""
    if isinstance(features, torch.Tensor):
        device = features.device
    else:
        features = torch.as_tensor(np.asarray(features))
    device = torch.device(device)
    q = torch.as_tensor(np.asarray(query_embs, np.float32), device=device)
    q = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=1e-8)
    sims = torch.empty((len(features), len(q)), dtype=torch.float32, device=device)
    for s in range(0, len(features), SIM_CHUNK):
        f = features[s:s + SIM_CHUNK].to(device=device, dtype=torch.float32)
        f = f / torch.clamp(torch.linalg.vector_norm(f, dim=-1, keepdim=True), min=1e-8)
        sims[s:s + SIM_CHUNK] = f @ q.T
    probs = torch.softmax(sims / softmax_temperature, dim=1)
    return probs.cpu().numpy(), sims.cpu().numpy()


def encode_queries(queries, text_encoder=None, query_embs=None) -> np.ndarray:
    """Resolve text embeddings: precomputed array, a callable encoder, or a
    cached-embedding lookup."""
    if query_embs is not None:
        return np.asarray(query_embs, np.float32)
    if text_encoder is not None:
        return np.asarray(text_encoder(list(queries)), np.float32)
    raise ValueError(
        "No CLIP text encoder available: pass query_embs (precomputed) or "
        "text_encoder (callable)."
    )


def grid_coords(meta) -> np.ndarray:
    """The (D,D,D,3) voxel positions of a clip_features npz: the reference
    grid uses arange(min, max, voxel_size) == linspace(..., endpoint=False)."""
    grid_shape = tuple(int(v) for v in meta["grid_shape"])
    axes = [np.linspace(meta["min_bounds"][i], meta["max_bounds"][i], grid_shape[i],
                        endpoint=False) for i in range(3)]
    return np.stack(np.meshgrid(*axes, indexing="ij"), -1)


def clip_part_segmentation(
    grid_feature_path: str | Path,
    part_queries: list[str],
    text_encoder=None,
    query_embs=None,
    softmax_temperature: float = 0.1,
    device: str | torch.device = "cuda",
):
    """Masked voxels -> (coords, part_labels, part_scores, metrics)."""
    grid_feature_path = str(grid_feature_path)
    features = np.load(grid_feature_path.replace(".npz", "_features.npy"))
    mask = np.load(grid_feature_path.replace(".npz", "_mask.npy")).astype(bool)
    coords = grid_coords(np.load(grid_feature_path))

    feats_flat = features.reshape(-1, features.shape[-1])[mask.ravel()]
    coords_flat = coords.reshape(-1, 3)[mask.ravel()]

    embs = encode_queries(part_queries, text_encoder, query_embs)
    probs, _ = run_clip_similarity(feats_flat, embs, softmax_temperature, device)
    part_labels = probs.argmax(1)
    part_scores = probs[np.arange(len(probs)), part_labels]

    metrics = {"num_parts": len(part_queries), "num_voxels": len(coords_flat)}
    for i, query in enumerate(part_queries):
        metrics[f"part_{i}_{query}"] = int((part_labels == i).sum())
        logging.info("Part %d (%s): %d voxels", i, query, metrics[f"part_{i}_{query}"])
    return coords_flat, part_labels, part_scores, metrics


def local_post_process_segmentation(
    coords: np.ndarray, part_labels: np.ndarray, k: int = 200, chunk: int = 4096,
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """k-NN majority-vote label smoothing (segmentation.py:190-229).

    Per chunk of query points on ``device``: the squared distances
    |q|^2 + |p|^2 - 2 q.p in float32 in the JAX package's order of
    operations, the k-th smallest distance of each row, the neighbours at or
    under it (all of them where several tie at the k-th distance, as in
    JAX), and their one-hot labels summed by a product; the class with the
    most votes wins, ties to the smallest label (``torch.argmax`` takes the
    first maximum, as ``jnp.argmax`` does).  On a lattice many neighbours tie
    at the k-th distance, so the rounding of the product decides which pass;
    a chunk is (chunk, N) float32 twice over on the device.
    """
    device = torch.device(device)
    n = len(coords)
    k = min(k, n)
    labels = np.asarray(part_labels)
    num_classes = int(labels.max()) + 1
    pts = torch.as_tensor(np.asarray(coords, np.float32), device=device)
    onehot = torch.nn.functional.one_hot(torch.as_tensor(labels, device=device).long(),
                                         num_classes).to(torch.float32)
    p_sq = (pts * pts).sum(-1)
    out = np.empty(n, labels.dtype)
    for s in range(0, n, chunk):
        q = pts[s:s + chunk]
        d = (q * q).sum(-1, keepdim=True) + p_sq[None, :] - 2.0 * q @ pts.T
        kth = torch.topk(d, k, dim=1, largest=False).values[:, -1:]
        counts = (d <= kth).to(torch.float32) @ onehot
        out[s:s + len(q)] = counts.argmax(dim=1).cpu().numpy()
    return out


def connected_component_cleanup(
    coords: np.ndarray, part_labels: np.ndarray, radius: float = 0.05
) -> np.ndarray:
    """Keep only the largest connected component per label; relabel smaller
    islands to -1 (segmentation.py:592-630 connected_component_cleanup +
    reassign_small_components).

    Adjacency = point pairs within ``radius`` sharing a label; components via
    scipy's sparse graph machinery instead of the reference's per-point BFS.
    Host-side: runs once per object on <=64^3 occupied voxels.
    """
    from scipy import sparse  # noqa: PLC0415
    from scipy.spatial import cKDTree  # noqa: PLC0415

    labels = np.asarray(part_labels).copy()
    n = len(labels)
    if n == 0:
        return labels
    pairs = cKDTree(coords).query_pairs(radius, output_type="ndarray")
    if len(pairs):
        same = labels[pairs[:, 0]] == labels[pairs[:, 1]]
        pairs = pairs[same]
    row = np.concatenate([pairs[:, 0], pairs[:, 1]])
    col = np.concatenate([pairs[:, 1], pairs[:, 0]])
    adj = sparse.coo_matrix(
        (np.ones(len(row), np.int8), (row, col)), shape=(n, n)
    ).tocsr()
    n_comp, comp = sparse.csgraph.connected_components(adj, directed=False)
    for lbl in np.unique(labels):
        comp_ids, counts = np.unique(comp[labels == lbl], return_counts=True)
        if len(comp_ids) <= 1:
            continue
        keep = comp_ids[np.argmax(counts)]
        islands = (labels == lbl) & (comp != keep)
        labels[islands] = -1
    return labels


def save_segmented_point_cloud(
    coords: np.ndarray,
    part_labels: np.ndarray,
    part_scores: np.ndarray,
    material_dict: dict,
    part_queries: list[str],
    output_dir: str | Path,
    grid_feature_path: str | Path | None = None,
    background_id: int = 7,
):
    """Write segmented_semantics.ply + material_grid.npy
    (segmentation.py:231-472 semantics)."""
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    n = len(coords)

    density = np.zeros(n, np.float32)
    E = np.zeros(n, np.float32)
    nu = np.zeros(n, np.float32)
    material_id = np.zeros(n, np.int64)
    for i, query in enumerate(part_queries):
        props = material_dict[query]
        sel = part_labels == i
        density[sel] = props["density"]
        E[sel] = props["E"]
        nu[sel] = props["nu"]
        mid = props["material_id"]
        material_id[sel] = get_material_id(mid) if isinstance(mid, str) else int(mid)

    vertex = np.zeros(n, dtype=MATERIAL_PLY_DTYPE)
    vertex["x"], vertex["y"], vertex["z"] = coords.T
    vertex["red"] = vertex["green"] = vertex["blue"] = vertex["alpha"] = 255
    vertex["part_label"] = part_labels
    vertex["density"], vertex["E"], vertex["nu"] = density, E, nu
    vertex["material_id"] = material_id
    vertex["conf"] = part_scores
    ply_path = output_dir / "segmented_semantics.ply"
    write_ply(ply_path, vertex)

    material_grid_path = None
    if grid_feature_path is not None:
        meta = np.load(grid_feature_path)
        grid_shape = tuple(int(v) for v in meta["grid_shape"])
        material_grid = np.zeros((*grid_shape, 4), np.float32)
        material_grid[..., 3] = background_id

        mask_path = str(grid_feature_path).replace(".npz", "_mask.npy")
        assert os.path.exists(mask_path), f"Mask not found: {mask_path}"
        mask = np.load(mask_path).astype(bool)
        flat_idx = np.flatnonzero(mask.ravel(order="C"))
        assert len(flat_idx) == n, (
            f"Mask/coords length mismatch: mask has {len(flat_idx)} true "
            f"voxels, coords has {n} points."
        )
        mg = material_grid.reshape(-1, 4)
        mg[flat_idx, 0] = density
        mg[flat_idx, 1] = E
        mg[flat_idx, 2] = nu
        mg[flat_idx, 3] = material_id
        material_grid_path = output_dir / "material_grid.npy"
        np.save(material_grid_path, material_grid)
        for name, ch in (("density_grid", 0), ("E_grid", 1), ("nu_grid", 2),
                         ("material_id_grid", 3)):
            np.save(output_dir / f"{name}.npy", material_grid[..., ch])

    return str(ply_path), (str(material_grid_path) if material_grid_path else None)


def generate_material_segmentation(
    grid_feature_path: str | Path,
    vlm_results: dict,
    output_dir: str | Path,
    text_encoder=None,
    query_embs=None,
    softmax_temperature: float = 0.1,
    background_id: int = 7,
    use_spatial_smoothing: bool = False,
    device: str | torch.device = "cuda",
):
    """VLM results (material_dict keyed by query terms) -> labeled artifacts
    (the generate_material_segmentation flow, pixie/utils.py:629-723)."""
    part_queries = list(vlm_results["material_dict"].keys())
    coords, labels, scores, metrics = clip_part_segmentation(
        grid_feature_path, part_queries, text_encoder, query_embs,
        softmax_temperature, device,
    )
    if use_spatial_smoothing:
        # reference segmentation.py:662-664 (--use_spatial_smoothing)
        labels = local_post_process_segmentation(coords, labels, device=device)
    ply, grid = save_segmented_point_cloud(
        coords, labels, scores, vlm_results["material_dict"], part_queries,
        output_dir, grid_feature_path, background_id,
    )
    return {"ply": ply, "material_grid": grid, "metrics": metrics}
