"""Per-scene simulation JSON decoding.

Faithful port of decode_param_json (PhysGaussian utils/decode_param.py:7-274):
same keys, same defaults, same grouping into material / bc / time /
preprocessing / camera parameter dicts, so the reference's per-class JSON
configs (config/{objaverse,real_scene}/*.json) load unchanged.

Carried over unchanged from pixie_tpu/sim/params.py (host only).
"""

from __future__ import annotations

import json
from pathlib import Path


def decode_param_json(json_file: str | Path):
    with open(json_file) as f:
        sim_params = json.load(f)
    return decode_params(sim_params)


def decode_params(sim_params: dict):
    material_params = {
        "material": sim_params.get("material", "jelly"),
        "grid_lim": sim_params.get("grid_lim", 2.0),
        "n_grid": sim_params.get("n_grid", 50),
        "nu": sim_params.get("nu", 0.4),
        "E": sim_params.get("E", 1e5),
        "g": sim_params.get("g", 9.8),
        "density": sim_params.get("density", 200.0),
    }
    if not (0.0 <= material_params["nu"] <= 0.5):
        raise ValueError("Poisson's ratio should be less than 0.5")
    for key in (
        "yield_stress", "hardening", "xi", "friction_angle", "plastic_viscosity",
        "rpic_damping", "pic_damping", "softening", "opacity_threshold",
        "grid_v_damping_scale",
    ):
        if key in sim_params:
            material_params[key] = sim_params[key]

    if "additional_material_params" in sim_params:
        additional = sim_params["additional_material_params"]
        for p in additional:
            for required in ("point", "size", "E", "nu"):
                if required not in p:
                    raise TypeError(f"{required} is not defined")
            p.setdefault("density", material_params["density"])
        material_params["additional_material_params"] = additional

    bc_params = sim_params.get("boundary_conditions", {})

    time_params = {
        "substep_dt": sim_params.get("substep_dt", 1e-4),
        "frame_dt": sim_params.get("frame_dt", 1e-2),
        "frame_num": sim_params.get("frame_num", 100),
    }

    preprocessing_params = {
        "nn_distance_threshold": sim_params.get("nn_distance_threshold", 0.1),
        "to_original_coord": sim_params.get("to_original_coord", True),
        "z_shift_value": sim_params.get("z_shift_value", 0.0),
        "only_handle_largest_cluster": sim_params.get("only_handle_largest_cluster", True),
        "k_smoothing_neighbors": sim_params.get("k_smoothing_neighbors", 10),
        "out_of_bound_check_freq": sim_params.get("out_of_bound_check_freq", 10),
        "fix_ground": sim_params.get("fix_ground", True),
        "opacity_threshold": sim_params.get("opacity_threshold", 0.02),
        "rotation_degree": sim_params.get("rotation_degree", []),
        "rotation_axis": sim_params.get("rotation_axis", []),
        "sim_area": sim_params.get("sim_area", None),
    }
    if "particle_filling" in sim_params:
        filling = dict(sim_params["particle_filling"])
        filling.setdefault("n_grid", material_params["n_grid"] * 4)
        filling.setdefault("density_threshold", 5.0)
        filling.setdefault("search_threshold", 3.0)
        filling.setdefault("max_particles_num", 2000000)
        filling.setdefault("max_partciels_per_cell", 1)
        filling.setdefault("search_exclude_direction", 5)
        filling.setdefault("ray_cast_direction", 4)
        filling.setdefault("boundary", None)
        filling.setdefault("smooth", False)
        filling.setdefault("visualize", False)
        preprocessing_params["particle_filling"] = filling
    else:
        preprocessing_params["particle_filling"] = None

    camera_params = {
        "mpm_space_viewpoint_center": sim_params.get("mpm_space_viewpoint_center", [1.0, 1.0, 1.0]),
        "mpm_space_vertical_upward_axis": sim_params.get("mpm_space_vertical_upward_axis", [0, 0, 1]),
        "default_camera_index": sim_params.get("default_camera_index", 0),
        "show_hint": sim_params.get("show_hint", False),
        "init_azimuthm": sim_params.get("init_azimuthm", None),
        "init_elevation": sim_params.get("init_elevation", None),
        "init_radius": sim_params.get("init_radius", None),
        "delta_a": sim_params.get("delta_a", None),
        "delta_e": sim_params.get("delta_e", None),
        "delta_r": sim_params.get("delta_r", None),
        "move_camera": sim_params.get("move_camera", False),
        "init_roll": sim_params.get("init_roll", 0.0),
        "delta_roll": sim_params.get("delta_roll", 0.0),
    }

    return material_params, bc_params, time_params, preprocessing_params, camera_params
