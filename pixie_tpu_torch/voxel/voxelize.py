"""Voxelizer: sample a feature field into a dense voxel grid and an
occupancy mask (port of pixie_tpu/voxel/voxelize.py; reference
pixie/voxel/voxelize.py extract_clip_voxel_grid:17-141 and
_create_occupancy_mask:188-263), with the same artifact contract:

  clip_features.npz (metadata), clip_features_features.npy (D,D,D,C fp16),
  clip_features_alphas.npy, clip_features_rgb.npy (fp16),
  clip_features_mask.npy, clip_features_pc.ply.

  * the field is queried on ``device`` in fixed-size chunks, through the
    field's ``query_packed_chunks`` where it has one (``FieldAdapter``),
    else ``query`` / ``get_rgb`` batch by batch (any duck-typed field);
  * alpha = 1 - exp(-density * delta); features alpha-weighted in float32,
    then cast to float16 (``pack_rows``);
  * only rows with alpha > the mask's threshold are fetched: the others are
    exact zeros, in ``*_features.npy`` and in the grid left on the device
    for the U-Nets (``features_dev``);
  * the feature npy is written on a background thread, atomically (tmp +
    ``os.replace``); ``wait()`` joins it and re-raises its failure;
  * occupancy: alpha and gray cuts, then open3d's statistical outlier
    removal and DBSCAN's non-noise points, both exact on the voxel lattice
    through 3D convolutions of the occupancy grid on ``device``.

Not ported: the JAX package's jit/scan packing and its tunnel helpers (they
pay a TPU runtime's dispatch costs), and the scikit-learn DBSCAN branch
(``PIXIE_LATTICE_DBSCAN=0``).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from pixie_tpu_torch.sim.material_field import knn_mean_dist
from pixie_tpu_torch.utils.io import write_ply


def pack_rows(density, feature, rgb, delta, alpha_weighted: bool):
    """(feature, alpha (B,1), rgb) as float16: alpha = 1 - exp(-density
    delta) and, with ``alpha_weighted``, feature x alpha, in float32
    (get_qp_feats, optimize.py:224-228)."""
    density = density.to(torch.float32).reshape(-1, 1)
    alpha = 1.0 - torch.exp(-density * float(delta))
    feature = feature.to(torch.float32)
    if alpha_weighted:
        feature = alpha * feature
    return feature.half(), alpha.half(), rgb.to(torch.float32).half()


def dense_voxel_grid(min_bounds, max_bounds, voxel_size: float) -> np.ndarray:
    """(nx,ny,nz,3) grid of voxel-corner coordinates
    (f3rm_robot/initial_proposals.py:18-27: arange per axis, ij indexing)."""
    axes = [np.arange(lo, hi, voxel_size, dtype=np.float32)
            for lo, hi in zip(min_bounds, max_bounds)]
    return np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)


def get_alpha(density: np.ndarray, delta: float) -> np.ndarray:
    """alpha compositing (field_adapter.py:14-18)."""
    return 1.0 - np.exp(-np.asarray(density) * delta)


def statistical_outlier_mask(points: np.ndarray, nb_neighbors: int = 50,
                             std_ratio: float = 4.0, device="cpu") -> np.ndarray:
    """open3d remove_statistical_outlier: mean distance to the nb_neighbors
    nearest neighbours; keep if < global mean + std_ratio * std."""
    n = len(points)
    if n <= nb_neighbors:
        return np.ones(n, bool)
    mean_d = knn_mean_dist(points, points, k=nb_neighbors, skip_self=True, device=device)
    mu, sigma = mean_d.mean(), mean_d.std()
    return mean_d < mu + std_ratio * sigma


def _occupancy(ijk: np.ndarray, shape, device) -> torch.Tensor:
    occ = np.zeros(shape, bool)
    occ[tuple(ijk.T)] = True
    return torch.as_tensor(occ, device=device)


def _ball_kernel(r_lattice: float) -> np.ndarray:
    rr = int(np.floor(r_lattice + 1e-6))
    g = np.arange(-rr, rr + 1)
    return ((g[:, None, None] ** 2 + g[None, :, None] ** 2 + g[None, None, :] ** 2)
            <= r_lattice * r_lattice + 1e-6).astype(np.float32)


def _conv(x: torch.Tensor, kernels: np.ndarray) -> torch.Tensor:
    """(D,H,W) float 0/1 grid convolved with (S,w,w,w) 0/1 kernels, same
    size: (S,D,H,W) counts.  Sums of 0/1 products are exact integers in
    float32 (and in TF32, which keeps 0 and 1 exact); rounded all the same,
    as JAX's convolutions are."""
    k = torch.as_tensor(kernels, device=x.device)[:, None]
    return torch.round(F.conv3d(x[None, None], k, padding=kernels.shape[-1] // 2)[0])


def lattice_nonnoise_mask_device(ijk: np.ndarray, shape, r_lattice: float,
                                 min_points: int = 10, device="cpu") -> np.ndarray:
    """DBSCAN's non-noise points (``labels != -1``) for points on a regular
    lattice, exactly: with eps = r_lattice cells, a point is kept iff it
    lies within eps of a core point (>= min_points neighbours within eps,
    itself included), so

        counts = occupancy (x) ball(r);  core = occ & counts >= min_points;
        keep = occ & (core (x) ball(r) > 0)

    two convolutions on ``device`` (pixie_tpu/voxel/voxelize.py:144-229)."""
    if len(ijk) == 0:
        return np.zeros(0, bool)
    occ = _occupancy(ijk, shape, device)
    ball = _ball_kernel(r_lattice)[None]
    counts = _conv(occ.float(), ball)[0]
    core = occ & (counts >= min_points)
    keep = occ & (_conv(core.float(), ball)[0] > 0.5)
    return keep.cpu().numpy()[tuple(ijk.T)]


def lattice_knn_mean_dist(ijk: np.ndarray, shape, voxel_size: float, k: int,
                          r_max: int = 6, device="cpu") -> np.ndarray:
    """Exact mean distance to the k nearest neighbours for points on a
    regular lattice (pixie_tpu/voxel/voxelize.py:232-295): distances are
    h sqrt(s) for integer s, so one convolution counts each voxel's
    occupied neighbours in every shell s <= r_max^2, and a walk over the
    shells in increasing order takes the k nearest.  Points with fewer than
    k neighbours within r_max cells take the brute kNN (``knn_mean_dist``).

    The shells' distances are summed one shell at a time in float32 (a
    multiply, then an add), so the result is the same on every device, and
    divided by k as JAX's compiled division is, a product with float32(1/k);
    the JAX package's fused dot sums the shells in another order, which
    moves the last bit of some means."""
    n = len(ijk)
    if n == 0:
        return np.zeros(0, np.float32)
    g = np.arange(-r_max, r_max + 1)
    s2 = g[:, None, None] ** 2 + g[None, :, None] ** 2 + g[None, None, :] ** 2
    shells = np.unique(s2)
    shells = shells[(shells > 0) & (shells <= r_max * r_max)]
    kernels = np.stack([(s2 == s).astype(np.float32) for s in shells])
    shell_d = (np.sqrt(shells.astype(np.float64)) * voxel_size).astype(np.float32)

    occ = _occupancy(ijk, shape, device)
    counts = _conv(occ.float(), kernels)                   # (S, D, H, W)
    csum = torch.cumsum(counts, 0)
    taken = torch.minimum(torch.clamp(k - (csum - counts), min=0.0), counts)
    acc = torch.zeros_like(counts[0])
    for s in range(len(shells)):
        acc = acc + float(shell_d[s]) * taken[s]
    sel = tuple(torch.as_tensor(ijk.T, device=device))
    mean_d = (acc * float(np.float32(1.0 / k)))[sel].cpu().numpy()
    complete = (csum[-1] >= k)[sel].cpu().numpy()
    if not complete.all():
        pts = ijk.astype(np.float32) * voxel_size
        sub = np.nonzero(~complete)[0]
        mean_d[sub] = knn_mean_dist(pts[sub], pts, k=k, skip_self=True, device=device)
    return mean_d.astype(np.float32)


def create_occupancy_mask(
    voxel_grid: np.ndarray,
    alphas: np.ndarray,
    rgb: np.ndarray,
    alpha_threshold: float = 0.01,
    gray_threshold: float = 0.05,
    run_outlier_filter: bool = True,
    nb_neighbors: int = 50,
    std_ratio: float = 4.0,
    min_cluster_pts: int = 10,
    eps_multiplier: float = 5.0,
    voxel_size: float = 1.0 / 64,
    timings: dict | None = None,
    device="cuda",
) -> np.ndarray:
    """Occupancy = alpha > thr AND rgb mean > gray AND statistical inlier AND
    DBSCAN non-noise (_create_occupancy_mask, voxelize.py:188-263); the
    convolutions run on ``device``, the statistical cut on the host in
    float32 numpy, as the JAX package computes it."""
    shape = voxel_grid.shape[:-1]
    coords = voxel_grid.reshape(-1, 3)
    alphas_flat = np.asarray(alphas, np.float32).reshape(-1)
    rgb_flat = np.asarray(rgb, np.float32).reshape(-1, 3)

    idx = np.where(alphas_flat > alpha_threshold)[0]
    # gray-background filter (optimize.py:264-300): mean RGB intensity
    non_bg = rgb_flat[idx].mean(axis=-1) > gray_threshold
    logging.info("Removed %d black background voxels out of %d", int((~non_bg).sum()), len(idx))
    idx = idx[non_bg]

    if run_outlier_filter and len(idx):
        t0 = time.perf_counter()
        if len(idx) > nb_neighbors:
            ijk0 = np.stack(np.unravel_index(idx, shape), axis=1)
            mean_d = lattice_knn_mean_dist(ijk0, shape, voxel_size, k=nb_neighbors,
                                           device=device)
            stat_keep = mean_d < mean_d.mean() + std_ratio * mean_d.std()
        else:
            stat_keep = statistical_outlier_mask(coords[idx], nb_neighbors, std_ratio, device)
        idx = idx[stat_keep]
        if timings is not None:
            timings["outlier_knn_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ijk = np.stack(np.unravel_index(idx, shape), axis=1)
        idx = idx[lattice_nonnoise_mask_device(ijk, shape, r_lattice=eps_multiplier,
                                               min_points=min_cluster_pts, device=device)]
        if timings is not None:
            timings["dbscan_s"] = time.perf_counter() - t0

    mask = np.zeros(coords.shape[0], bool)
    mask[idx] = True
    return mask.reshape(shape)


def _query_batches(field, flat: np.ndarray, batch_size: int, delta, alpha_weighted: bool,
                   device) -> tuple[torch.Tensor, torch.Tensor]:
    """A duck-typed field (``query(points) -> {"density", "feature"}``,
    ``get_rgb(points)``; numpy or tensors) batch by batch: (features (T,C)
    fp16, alphas_rgb (T,4) fp16) on ``device``."""
    feats, ar = [], []
    for i in range(0, flat.shape[0], batch_size):
        batch = flat[i:i + batch_size]
        out = field.query(batch)
        f16, a16, r16 = pack_rows(
            torch.as_tensor(np.asarray(out["density"]), device=device),
            torch.as_tensor(np.asarray(out["feature"]), device=device),
            torch.as_tensor(np.asarray(field.get_rgb(batch)), device=device),
            delta, alpha_weighted)
        feats.append(f16)
        ar.append(torch.cat([a16, r16], dim=-1))
    return torch.cat(feats), torch.cat(ar)


def extract_feature_voxel_grid(
    field,
    output_path: str | Path,
    bounds=((-0.5, 0.5), (-0.5, 0.5), (-0.5, 0.5)),
    voxel_size: float = 1.0 / 64,
    batch_size: int = 65536,
    alpha_weighted: bool = True,
    alpha_threshold_for_mask: float = 0.01,
    gray_threshold_for_mask: float = 0.05,
    run_outlier_filter: bool = True,
    nb_neighbors: int = 50,
    std_ratio: float = 4.0,
    min_cluster_pts: int = 10,
    eps_multiplier: float = 5.0,
    expected_grid: int | None = 64,
    device="cuda",
) -> dict:
    """Sample ``field`` on the dense grid and write the artifact set; returns
    the artifact path dict with ``timings``.

    ``field`` is a ``FieldAdapter`` / ``TcnnFieldAdapter`` (its
    ``query_packed_chunks`` runs the grid on its device) or any object with
    ``query`` and ``get_rgb``.  The returned dict also carries
    ``features_dev``, the (D,D,D,C) fp16 grid on ``device`` with the
    rows at or under the alpha threshold zeroed as in the npy, and ``wait``,
    which joins the background write of ``*_features.npy``, merges its
    timings and re-raises its failure: call it before reading the npy.
    """
    device = torch.device(device)
    output_path = str(output_path)
    Path(output_path).parent.mkdir(parents=True, exist_ok=True)
    min_bounds = tuple(b[0] for b in bounds)
    max_bounds = tuple(b[1] for b in bounds)
    grid = dense_voxel_grid(min_bounds, max_bounds, voxel_size)
    shape = grid.shape[:-1]
    if expected_grid is not None and shape != (expected_grid,) * 3:
        # the learning path requires 64^3 (voxelize.py:301)
        raise ValueError(f"voxel grid shape {shape} != {(expected_grid,) * 3}; "
                         f"adjust bounds/voxel_size")
    flat = grid.reshape(-1, 3)
    total = flat.shape[0]
    timings: dict[str, float] = {}

    t0 = time.perf_counter()
    packed = getattr(field, "query_packed_chunks", None)
    if packed is not None:
        fd, ar = packed(flat, batch_size, np.float32(voxel_size), alpha_weighted)
    else:
        fd, ar = _query_batches(field, flat, batch_size, np.float32(voxel_size), alpha_weighted,
                                device)
    timings["query_s"] = time.perf_counter() - t0    # enqueue: the fetch below waits
    t0 = time.perf_counter()
    ar_host = ar.cpu().numpy()
    alphas = ar_host[:, :1].reshape(*shape, 1)
    rgb = ar_host[:, 1:].reshape(*shape, 3)
    timings["alphas_rgb_fetch_s"] = time.perf_counter() - t0

    # only rows over the mask's alpha threshold leave the device; the rest
    # are exact zeros in the npy and in the device grid alike
    t0 = time.perf_counter()
    keep = np.flatnonzero(alphas.reshape(-1).astype(np.float32) > alpha_threshold_for_mask)
    feat_dim = int(fd.shape[-1])
    keep_dev = torch.as_tensor(keep, device=fd.device)
    rows_dev = fd[keep_dev]
    rows_host = torch.empty(rows_dev.shape, dtype=rows_dev.dtype,
                            pin_memory=rows_dev.is_cuda)
    rows_host.copy_(rows_dev, non_blocking=True)
    copied = torch.cuda.Event() if rows_dev.is_cuda else None
    if copied is not None:
        copied.record()
    features_dev = torch.zeros_like(fd).index_copy_(0, keep_dev, rows_dev).reshape(
        *shape, feat_dim)
    feat_npy_path = output_path.replace(".npz", "_features.npy")
    drain_timings: dict[str, float] = {}
    drain_err: list[BaseException] = []

    def _drain_and_save():
        # atomic write: a reader never sees a partial npy, and a failure is
        # re-raised by wait()
        try:
            td = time.perf_counter()
            if copied is not None:
                copied.synchronize()
            feats = np.zeros((total, feat_dim), np.float16)
            feats[keep] = rows_host.numpy()
            drain_timings["fetch_bg_s"] = time.perf_counter() - td
            td = time.perf_counter()
            tmp = feat_npy_path + ".tmp"
            with open(tmp, "wb") as f:
                np.save(f, feats.reshape(*shape, feat_dim))
            os.replace(tmp, feat_npy_path)
            drain_timings["save_feat_s"] = time.perf_counter() - td
        except BaseException as e:  # noqa: BLE001 (re-raised by wait())
            drain_err.append(e)
            raise

    drain_thread = threading.Thread(target=_drain_and_save, name="vox-feat-drain")
    drain_thread.start()
    timings["gather_dispatch_s"] = time.perf_counter() - t0
    timings["sparse_rows"] = float(len(keep))

    t0 = time.perf_counter()
    paths = save_voxel_data(output_path, None, alphas, rgb, min_bounds, max_bounds, voxel_size,
                            alpha_weighted, alpha_threshold_for_mask,
                            feat_shape=(*shape, feat_dim))
    timings["save_s"] = time.perf_counter() - t0

    mask = create_occupancy_mask(
        grid, alphas, rgb, alpha_threshold_for_mask, gray_threshold_for_mask,
        run_outlier_filter, nb_neighbors, std_ratio, min_cluster_pts,
        eps_multiplier, voxel_size, timings=timings, device=device)
    mask_path = output_path.replace(".npz", "_mask.npy")
    np.save(mask_path, mask.astype(np.float32))
    paths["mask"] = mask_path
    paths["timings"] = timings

    # occupancy point cloud for inspection (voxelize.py:266-406)
    pc_path = output_path.replace(".npz", "_pc.ply")
    coords = grid.reshape(-1, 3)[mask.reshape(-1)]
    colors = (np.clip(rgb.reshape(-1, 3)[mask.reshape(-1)].astype(np.float32), 0, 1)
              * 255).astype(np.uint8)
    vertex = np.zeros(len(coords), dtype=[("x", "f4"), ("y", "f4"), ("z", "f4"),
                                          ("red", "u1"), ("green", "u1"), ("blue", "u1")])
    vertex["x"], vertex["y"], vertex["z"] = coords.T
    vertex["red"], vertex["green"], vertex["blue"] = colors.T
    write_ply(pc_path, vertex)
    paths["pc_ply"] = pc_path

    paths["features_dev"] = features_dev

    def _wait() -> dict:
        drain_thread.join()
        if drain_err:
            raise RuntimeError(f"voxel feature drain failed; {feat_npy_path} was NOT "
                               f"written") from drain_err[0]
        timings.update(drain_timings)
        return timings

    paths["wait"] = _wait
    logging.info("Voxelization done: %d/%d occupied voxels", int(mask.sum()), mask.size)
    return paths


def save_voxel_data(output_path, features, alphas, rgb, min_bounds, max_bounds, voxel_size,
                    alpha_weighted, alpha_threshold, feat_shape=None) -> dict:
    """Write the npz metadata and the sidecar npy arrays (voxelize.py:144-185).

    ``features=None``: ``*_features.npy`` is written by the fetch drain,
    possibly still in flight on its thread, and ``feat_shape`` gives the
    npz metadata."""
    base = output_path.replace(".npz", "")
    paths = {"npz": output_path, "features": f"{base}_features.npy",
             "alphas": f"{base}_alphas.npy", "rgb": f"{base}_rgb.npy"}
    Path(output_path).parent.mkdir(parents=True, exist_ok=True)
    if features is not None:
        np.save(paths["features"], features)
        feat_shape = features.shape
    np.save(paths["alphas"], alphas)
    np.save(paths["rgb"], rgb)
    np.savez(output_path,
             min_bounds=np.asarray(min_bounds, np.float32),
             max_bounds=np.asarray(max_bounds, np.float32),
             voxel_size=np.float32(voxel_size),
             grid_shape=np.asarray(feat_shape[:-1]),
             feature_dim=feat_shape[-1],
             alpha_weighted=alpha_weighted,
             alpha_threshold=alpha_threshold)
    return paths
