"""Material field -> particle assignment (port of
pixie_tpu/sim/material_field.py; reference material_field.py).

  * kNN smoothing of the material PLY onto MPM particles: brute-force
    ``torch.cdist`` + ``topk`` on the device, in query blocks;
  * ground cuboid BC (fix_to_ground);
  * DBSCAN of stationary particles -> pinned cuboids
    (handle_stationary_clusters), on the host over ``scipy.spatial.cKDTree``
    with scikit-learn's labelling order (scikit-learn is not a dependency);
  * per-particle parameter assignment and mu/lam finalization.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from pixie_tpu_torch.sim.types import get_material_id

DEFAULT_VALUES = {"density": 1000.0, "E": 5000.0, "nu": 0.3, "part_label": 0}
# bound on the (query block, reference) distance matrix of one knn step
_KNN_BLOCK_ELEMS = 1 << 27


def knn(query: np.ndarray, ref: np.ndarray, k: int = 10, device="cpu"):
    """k nearest reference points of each query point: (dists (Q,k), idx (Q,k)),
    ascending, computed on ``device`` in query blocks."""
    query = np.asarray(query, np.float32)
    ref = np.asarray(ref, np.float32)
    if k > ref.shape[0]:
        raise ValueError(f"k={k} exceeds reference count {ref.shape[0]}")
    ref_t = torch.as_tensor(ref, device=device)
    block = max(1, _KNN_BLOCK_ELEMS // max(ref.shape[0], 1))
    dists, idxs = [], []
    for start in range(0, query.shape[0], block):
        q = torch.as_tensor(query[start:start + block], device=device)
        d, i = torch.topk(torch.cdist(q, ref_t), k, dim=1, largest=False, sorted=True)
        dists.append(d)
        idxs.append(i)
    if not dists:
        return np.zeros((0, k), np.float32), np.zeros((0, k), np.int64)
    return torch.cat(dists).cpu().numpy(), torch.cat(idxs).cpu().numpy()


def knn_mean_dist(query: np.ndarray, ref: np.ndarray, k: int = 10, skip_self: bool = False,
                  device="cpu") -> np.ndarray:
    """(Q,) float32 mean distance of each query point to its k nearest
    reference points (pixie_tpu/sim/material_field.py:111), on ``device`` in
    query blocks.  ``skip_self`` drops the nearest one, the point itself
    when query is ref (open3d's remove_statistical_outlier).

    The distances are ``torch.cdist``'s direct differences, not its matrix
    product form, and the mean is summed in float64: on lattice points, the
    voxelizer's only caller, every distance is then exact and the mean the
    same on every device."""
    query = np.asarray(query, np.float32)
    ref = np.asarray(ref, np.float32)
    need = k + 1 if skip_self else k
    if need > ref.shape[0]:
        raise ValueError(f"k={k} (+self) exceeds reference count {ref.shape[0]}")
    ref_t = torch.as_tensor(ref, device=device)
    block = max(1, _KNN_BLOCK_ELEMS // max(ref.shape[0], 1))
    means = []
    for start in range(0, query.shape[0], block):
        q = torch.as_tensor(query[start:start + block], device=device)
        d = torch.cdist(q, ref_t, compute_mode="donot_use_mm_for_euclid_dist")
        d = torch.topk(d, need, dim=1, largest=False, sorted=True).values
        means.append((d[:, 1:] if skip_self else d).double().mean(1).float())
    if not means:
        return np.zeros(0, np.float32)
    return torch.cat(means).cpu().numpy()


def assign_from_neighbors(values: dict[str, np.ndarray], neighbor_idx: np.ndarray,
                          distances: np.ndarray, weighted: bool = False,
                          num_classes: int = 8):
    """(Weighted) mean for continuous properties, (weighted) mode for
    categorical ones (material_field.py:52-78)."""
    q, k = neighbor_idx.shape
    if weighted:
        w = 1.0 / (distances + 1e-8)
        w = w / w.sum(axis=1, keepdims=True)
    else:
        w = np.full((q, k), 1.0 / k, np.float32)
    out = {}
    for name, vals in values.items():
        nb = vals[neighbor_idx]
        if name in ("material_id", "part_labels"):
            nb_i = nb.astype(np.int64)
            n_cls = max(num_classes, int(nb_i.max()) + 1 if nb_i.size else 1)
            votes = np.zeros((q, n_cls), np.float64)
            np.add.at(votes, (np.arange(q)[:, None], nb_i), w)
            out[name] = np.argmax(votes, axis=1).astype(vals.dtype)
        else:
            out[name] = (w * nb).sum(axis=1).astype(np.float32)
    return out


def perform_knn_smoothing(n_particles: int, mpm_positions_world: np.ndarray,
                          params: dict, k_smoothing_neighbors: int = 10,
                          nn_distance_threshold: float = 0.1,
                          weighted_assignment: bool = False, device="cpu"):
    """Map the material PLY's per-vertex properties onto the MPM particles
    (material_field.py:228-293).  Identity when the PLY vertices are the
    particles (point-cloud mode)."""
    values = {
        "part_labels": np.asarray(params["part_labels"]),
        "density": np.asarray(params["density"], np.float32),
        "E": np.asarray(params["E"], np.float32),
        "nu": np.asarray(params["nu"], np.float32),
        "material_id": np.asarray(params["material_id"]),
        "conf": np.asarray(params["conf"], np.float32),
    }
    if len(values["part_labels"]) == n_particles:
        logging.info("Material field data matches MPM solver (%d particles); "
                     "no K-NN smoothing.", n_particles)
        return values

    dists, idx = knn(mpm_positions_world, np.asarray(params["pos"], np.float32),
                     k_smoothing_neighbors, device=device)
    too_far = dists[:, 0] > nn_distance_threshold
    n_too_far = int(too_far.sum())
    logging.info("Particles too far from nearest neighbor: %d, assigned: %d",
                 n_too_far, n_particles - n_too_far)
    if n_too_far > 0.1 * n_particles:
        raise ValueError(
            f"[CRITICAL] More than 10% of particles are too far from nearest "
            f"neighbor. Distance threshold: {nn_distance_threshold}.")

    assigned = assign_from_neighbors(values, idx, dists, weighted_assignment)
    out = {}
    for name, vals in assigned.items():
        if name == "material_id":
            default = get_material_id("stationary")
        elif name == "part_labels":
            default = DEFAULT_VALUES["part_label"]
        else:
            src = values[name]
            default = float(src.mean()) if len(src) else DEFAULT_VALUES.get(name, 0.0)
        out[name] = np.where(too_far, np.asarray(default, vals.dtype), vals)
    return out


def fix_to_ground(positions: np.ndarray, delta_z: float = 0.02,
                  buffer_xy: float = 0.5, min_z_percentile: float = 1,
                  start_time: float = 0.0, end_time: float = 1e6):
    """Thin pinned cuboid at the base (material_field.py:485-545)."""
    min_xy = positions[:, :2].min(axis=0)
    max_xy = positions[:, :2].max(axis=0)
    size_xy = max_xy - min_xy
    if min_z_percentile > 1:
        min_z = np.percentile(positions[:, 2], min_z_percentile)
    else:
        min_z = positions[:, 2].min()
    return {
        "type": "ground",
        "point": [float((min_xy[0] + max_xy[0]) / 2), float((min_xy[1] + max_xy[1]) / 2),
                  float(min_z + delta_z / 2)],
        "size": [float(size_xy[0] / 2 + buffer_xy), float(size_xy[1] / 2 + buffer_xy),
                 float(delta_z / 2)],
        "velocity": [0.0, 0.0, 0.0],
        "start_time": start_time,
        "end_time": end_time,
        "reset": 1,
    }


def dbscan(points: np.ndarray, eps: float, min_samples: int) -> np.ndarray:
    """DBSCAN labels with scikit-learn's semantics and labelling order.

    Neighbourhoods include the point itself and every point at distance
    <= eps; core points have >= min_samples of them.  Clusters are grown by
    the same depth-first expansion as sklearn's ``dbscan_inner``, visiting
    seed points in index order, so cluster ids match; noise is -1.
    """
    from scipy.spatial import cKDTree  # noqa: PLC0415

    n = len(points)
    labels = np.full(n, -1, np.int64)
    if n == 0:
        return labels
    neighborhoods = cKDTree(points).query_ball_point(points, r=eps)
    is_core = np.array([len(nb) >= min_samples for nb in neighborhoods])
    label = 0
    for i in range(n):
        if labels[i] != -1 or not is_core[i]:
            continue
        stack = [i]
        while stack:
            j = stack.pop()
            if labels[j] != -1:
                continue
            labels[j] = label
            if is_core[j]:
                stack.extend(v for v in neighborhoods[j] if labels[v] == -1)
        label += 1
    return labels


def handle_stationary_clusters(positions: np.ndarray, material_ids: np.ndarray,
                               eps: float = 0.03, min_samples: int = 8,
                               start_time: float = 0.0, end_time: float = 1e9,
                               buffer: float = 0.1,
                               only_handle_largest_cluster: bool = True):
    """DBSCAN stationary particles -> one pinned cuboid BC dict per cluster
    (material_field.py:365-480)."""
    stationary = positions[material_ids == get_material_id("stationary")]
    if len(stationary) == 0:
        logging.info("No stationary particles; skipping cluster BCs.")
        return []
    labels = dbscan(stationary, eps, min_samples)
    valid_labels = np.unique(labels)
    valid_labels = valid_labels[valid_labels != -1]
    if len(valid_labels) == 0:
        logging.info("All stationary points are DBSCAN noise; no cuboid BCs.")
        return []
    sizes = {int(l): int((labels == l).sum()) for l in valid_labels}
    if only_handle_largest_cluster and len(valid_labels) > 1:
        valid_labels = np.array([max(sizes, key=sizes.get)])
    bcs = []
    for cluster_id in valid_labels:
        pts = stationary[labels == cluster_id]
        min_xyz, max_xyz = pts.min(axis=0), pts.max(axis=0)
        bcs.append({
            "type": "stationary_cluster",
            "cluster_id": int(cluster_id),
            "point": (0.5 * (min_xyz + max_xyz)).tolist(),
            "size": (0.5 * (max_xyz - min_xyz) + buffer).tolist(),
            "velocity": [0.0, 0.0, 0.0],
            "start_time": start_time,
            "end_time": end_time,
            "reset": 1,
            "cluster_size": sizes[int(cluster_id)],
        })
    return bcs


def apply_material_field_to_simulation(solver, params: dict,
                                       mpm_positions_world: np.ndarray | None = None,
                                       only_handle_largest_cluster: bool = True,
                                       fix_ground: bool = True,
                                       ground_delta_z: float = 0.05,
                                       ground_buffer_xy: float = 0.5,
                                       k_smoothing_neighbors: int = 10,
                                       nn_distance_threshold: float = 0.1,
                                       weighted_assignment: bool = False):
    """kNN smoothing, ground + stationary-cluster BCs, per-particle
    parameters, mu/lam (material_field.py:296-340).  Returns (conf, bc dicts)."""
    missing = [k for k in ("part_labels", "density", "E", "nu", "material_id", "conf")
               if k not in params]
    if missing:
        raise KeyError(f"Missing required keys: {missing}")
    n = solver.state.n_particles
    positions = solver.export_particle_x()
    if mpm_positions_world is None:
        mpm_positions_world = positions
    props = perform_knn_smoothing(n, mpm_positions_world, params, k_smoothing_neighbors,
                                  nn_distance_threshold, weighted_assignment,
                                  device=solver.device)
    bc_conditions = []
    if fix_ground:
        bc = fix_to_ground(positions, ground_delta_z, ground_buffer_xy)
        solver.set_velocity_on_cuboid(point=bc["point"], size=bc["size"],
                                      velocity=bc["velocity"], start_time=bc["start_time"],
                                      end_time=bc["end_time"], reset=bc["reset"])
        bc_conditions.append(bc)
    for bc in handle_stationary_clusters(positions, props["material_id"],
                                         only_handle_largest_cluster=only_handle_largest_cluster):
        solver.set_velocity_on_cuboid(point=bc["point"], size=bc["size"],
                                      velocity=bc["velocity"], start_time=bc["start_time"],
                                      end_time=bc["end_time"], reset=bc["reset"])
        bc_conditions.append(bc)
    solver.set_per_particle_materials(props["density"], props["E"], props["nu"],
                                      props["material_id"].astype(np.int32))
    solver.finalize_mu_lam()
    return props["conf"], bc_conditions
